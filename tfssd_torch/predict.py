"""Serving entry point: weights -> (folded) SSD -> batched predict -> VOC mAP.

Port of the repository's predictor.py, flag for flag, run as

    python -m tfssd_torch.predict [--device cpu]
    python -m tfssd_torch.predict --dataset voc --data-root VOC2007 \
        --split test [--data-root VOC2012:val] [--workers 8]
    python -m tfssd_torch.predict --image-dir photos/ --draw 10 \
        --output-dir outputs --score-threshold 0.5
    python -m tfssd_torch.predict --backbone vgg16 --limit 32 --batch-size 8
    python -m tfssd_torch.predict --random-weights --seed 0 ...
    python -m tfssd_torch.predict --weights ssd_mobilenet_v2_7680.npz ...
    python -m tfssd_torch.predict --export ssd.pt2 [--export-batch 8]
    python -m tfssd_torch.predict --port-h5 mobilenet_v2.keras ...
    torchrun --nproc_per_node=N -m tfssd_torch.predict ...

--backbone is a config name of get_hyper_params: mobilenet_v2 and vgg16
(SSD300), vgg16_512 (SSD512).

Weights. With no weight flag, the best step (lowest val_loss), else the
latest, of the JAX package's checkpoint directory
<--model-dir>/ssd_<backbone> (default trained/ssd_mobilenet_v2, the
committed trained/ssd_mobilenet_v2/7680) is read without orbax
(utils/checkpoint.py:OrbaxCheckpoints); where there is none the run stops
before the model is built. --random-weights serves seeded random weights;
--weights takes an .npz of the Flax variable tree with '/'-joined keys
(utils/convert.py:flatten_tree). --port-h5 PATH then writes the conv trunk
of a Keras model file (.h5 or .keras, as Keras's model.save writes them:
keras.applications.MobileNetV2 for mobilenet_v2, VGG16 for the VGG16
configs) into the backbone, read without Keras (utils/port_weights.py);
with --port-h5 a missing checkpoint is not fatal, and the heads keep the
seeded weights of --seed. BatchNorm is folded into the convolutions
afterwards, unless --no-fold-bn.

Data. --dataset synthetic (the default here; the JAX predictor's default
is voc) serves SyntheticDataset(128, seed=10_000), the JAX predictor's
evaluation split. --dataset voc reads each --data-root's --split (default
test) with difficult objects kept. --image-dir serves a folder of images
(no ground truth, no mAP). --limit serves the first N images.

Feed. --device-cache on stages the uint8 split on the device once and
serves each batch from rows there, copying nothing back until the end;
off streams batches decoded by --workers threads through a prefetch
thread; auto (the default) stages where len x S^2 x 3 <= 6e9 bytes, as the
JAX predictor does. Both score exactly the same rows.

Output. The mAP (unless --no-eval), img/s (first batch excluded), and
with --draw N the first N images with their detections scoring at least
--score-threshold drawn into --output-dir.

The CLI serves in float32, as the JAX predictor does; load_model(...,
compute_dtype="bfloat16") + serve is the bfloat16 serving configuration of
the JAX benchmark (BN folded, backbone and heads in bfloat16, decode and
NMS in float32). It runs on the card unless --device cpu is given, and
raises when there is no card.

Export. --export PATH writes the whole predict path (forward, decode and
NMS, the loaded weights inside, BatchNorm left unfolded as the JAX
predictor leaves it) for float32 images in [-1, 1] at --export-batch
(default --batch-size) as one torch.export artifact
(utils/export.py:export_predict), prints its size and exits; a process
with tfssd_torch.ops.kernels and utils/export.py serves it on the card or
the CPU (load_exported), the NMS through tfssd::nms_keep.

Data parallelism (tfssd_torch/parallel.py), as the JAX predictor shards
each batch over every visible device: under torchrun each rank serves its
rows of every batch (--batch-size must divide into the ranks; otherwise
rank 0 serves alone, with the JAX predictor's warning), and the NMSResults
and ground truth are gathered on every rank; rank 0 computes the mAP and
draws.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tfssd_torch import get_hyper_params, parallel, resolve_device
from tfssd_torch.config import SSDConfig
from tfssd_torch.data.loader import (DEVICE_CACHE_BYTES, ConcatDataset,
                                     TakeDataset, batch_examples, prefetch,
                                     stage_arrays)
from tfssd_torch.data.synthetic import SyntheticDataset
from tfssd_torch.data.voc import (LABELS, VOCDataset, custom_image_generator,
                                  get_custom_imgs)
from tfssd_torch.evaluate import (detections_from_nms_result,
                                  evaluate_predictions)
from tfssd_torch.models.decoder import decode_predictions, preprocess_images
from tfssd_torch.models.ssd import SSD, get_model, init_random_weights
from tfssd_torch.ops.boxes import generate_anchors
from tfssd_torch.ops.nms import NMSResult
from tfssd_torch.utils.checkpoint import OrbaxCheckpoints
from tfssd_torch.utils.convert import is_folded, load_variables
from tfssd_torch.utils.fold_bn import fold_for_serving
from tfssd_torch.utils.io import (get_jax_model_path, handle_args,
                                  parse_data_root)
from tfssd_torch.utils.metrics import StepTimer
from tfssd_torch.utils.port_weights import port_h5_into_variables

# The evaluation split the JAX predictor serves for --dataset synthetic.
SYNTHETIC_EVAL_SIZE = 128
SYNTHETIC_EVAL_SEED = 10_000
# ServingRun.outputs keeps the (deltas, logits) of this many first batches
# (128 images at batch 8: the whole synthetic split).
OUTPUT_BATCHES_KEPT = 16

Weights = Union[None, str, Mapping[str, Any]]


def read_weights(weights: Union[str, Mapping[str, Any]],
                 backbone: str = "mobilenet_v2") -> Mapping[str, Any]:
    """A Flax variable tree: `weights` itself, the arrays of an .npz, or the
    serving step (best, else latest) of an orbax checkpoint directory (the
    JAX package's CheckpointManager's, e.g. trained/ssd_mobilenet_v2).
    A directory without a checkpoint raises SystemExit, as the JAX
    predictor does."""
    if isinstance(weights, Mapping):
        tree = weights
    elif str(weights).endswith(".npz"):
        with np.load(weights) as npz:
            tree = {k: npz[k] for k in npz.files}
    else:
        ckpt = OrbaxCheckpoints(weights)
        step = ckpt.serving_step()
        if step is None:
            raise SystemExit(
                f"no checkpoint for {backbone} under "
                f"{os.path.dirname(os.path.normpath(weights))}; train first "
                f"or pass --random-weights")
        tree = ckpt.restore_weights(step)
        print(f"loaded checkpoint step {step}")
    return {k: v for k, v in tree.items() if k != "step"}


def load_model(backbone: str = "mobilenet_v2", weights: Weights = None,
               seed: int = 0, device="cuda", compute_dtype: str = "float32",
               fold_bn: bool = True, port_h5: Optional[str] = None
               ) -> Tuple[SSDConfig, SSD]:
    """(config, model) ready to serve: weights as read_weights reads them
    (folded or not), or seeded random weights where None; the trunk of the
    Keras model file `port_h5` written over them where given; BatchNorm
    folded where `fold_bn` (VGG16 has none); eval mode, on `device`,
    computing in `compute_dtype` (the config's field; the weights stay
    float32)."""
    dev = resolve_device(device)
    cfg = get_hyper_params(backbone, compute_dtype=compute_dtype)
    if weights is not None:
        tree = read_weights(weights, backbone)
        cfg = dataclasses.replace(cfg, fold_bn=is_folded(tree))
        model = load_variables(get_model(cfg), tree)
    else:
        model = init_random_weights(get_model(cfg), seed)
    if port_h5:
        port_h5_into_variables(model, cfg.backbone, port_h5)
        print(f"ported trunk weights from {port_h5}")
    model = model.to(dev).eval()
    return fold_for_serving(cfg, model) if fold_bn else (cfg, model)


@dataclasses.dataclass
class ServingRun:
    """What one serving run produced, per batch: the uint8 images that went
    in (padded to the batch size), the served rows' ids, the NMSResult (on the
    serving device) and the count of real rows, each of the whole batch
    (gathered from every rank under data parallelism); the model's
    (deltas, logits) of the first OUTPUT_BATCHES_KEPT batches (this rank's
    rows); the mAP (None where not evaluated, and on ranks other than 0)
    and the throughput."""

    config: SSDConfig
    model: SSD
    anchors: np.ndarray
    device_cached: bool
    images: List[np.ndarray] = dataclasses.field(default_factory=list)
    ids: List[List[str]] = dataclasses.field(default_factory=list)
    outputs: List[Tuple[torch.Tensor, torch.Tensor]] = dataclasses.field(
        default_factory=list)
    results: List[NMSResult] = dataclasses.field(default_factory=list)
    num_valid: List[int] = dataclasses.field(default_factory=list)
    mean_ap: Optional[float] = None
    img_per_s: Optional[float] = None
    shard: parallel.Shard = parallel.SINGLE


def _accumulate_batch(res: NMSResult, nv: int, rows: Dict, gts: list,
                      dets: list) -> None:
    """The first `nv` rows of one batch's host NMSResult into `dets` and
    their ground truth into `gts`: one implementation for the
    device-cached and streamed paths, so both score the same rows."""
    dets.extend(detections_from_nms_result(res, num_valid=nv))
    for i in range(nv):
        gts.append({"boxes": rows["boxes"][i], "labels": rows["labels"][i],
                    "difficult": rows["difficult"][i]})


def serve(model: SSD, config: SSDConfig, dataset, batch_size: int,
          limit: Optional[int] = None, *, device_cache: bool = True,
          workers: int = 1, evaluate: bool = True,
          shard: parallel.Shard = parallel.SINGLE) -> ServingRun:
    """Predict `dataset` (its first `limit` examples) in batches on the
    model's device and, where `evaluate`, score the detections (VOC07
    mAP@0.5). `device_cache` stages the split's uint8 images on the device
    once (a random-access dataset: __len__ and example(i)); otherwise
    batches are decoded by `workers` threads and streamed. Prints the
    throughput line, first batch excluded. Under data parallelism
    (`shard`) each rank predicts its rows of every batch (the device cache
    stages the whole split on every rank; the streamed feed decodes only
    the rank's rows), the results are gathered, and rank 0 scores them."""
    device = next(model.parameters()).device
    anchors = generate_anchors(config)
    anchors_t = torch.from_numpy(anchors).to(device)
    run = ServingRun(config, model, anchors, device_cache, shard=shard)
    lead = shard.rank == 0

    def predict(x: torch.Tensor) -> NMSResult:
        with torch.no_grad():
            deltas, logits = model(preprocess_images(x))
            res = decode_predictions(anchors_t, deltas, logits, config)
        if len(run.outputs) < OUTPUT_BATCHES_KEPT:
            run.outputs.append((deltas, logits))
        return res

    gts: list = []
    dets: list = []
    if (limit is not None and hasattr(dataset, "example")
            and limit < len(dataset)):
        # decode and stage only the rows served
        dataset = TakeDataset(dataset, limit)
    if device_cache:
        host, n = stage_arrays(dataset, config.max_gt_boxes,
                               workers=workers, pad_to_multiple=batch_size)
        staged = torch.from_numpy(host["image"]).to(device)
        n_batches = -(-n // batch_size)
        mine = shard.rows(batch_size)
        seconds, local = 0.0, []
        for b in range(n_batches):
            # the first batch pays one-time set-up (cuDNN plans) and stays
            # out of the timed window, as in the JAX predictor
            if b == 1:
                _sync(device)
                t0 = time.perf_counter()
            rows = staged[b * batch_size:(b + 1) * batch_size]
            local.append(predict(rows[mine]))
        if n_batches > 1:
            _sync(device)
            seconds = time.perf_counter() - t0
        run.results = [parallel.gather_results(r, shard) for r in local]
        for b, res in enumerate(run.results):
            rows = {k: host[k][b * batch_size:(b + 1) * batch_size]
                    for k in ("image", "boxes", "labels", "difficult",
                              "ids")}
            nv = min(batch_size, n - b * batch_size)
            _record(run, rows, nv)
            _accumulate_batch(_host(res), nv, rows, gts, dets)
        timed = n - min(n, batch_size)
        run.img_per_s = timed / seconds if seconds > 0 and timed else None
        feed = "device-cached"
    else:
        timer, reals, seen = StepTimer(skip=1), [], 0
        timer.start()
        for batch in prefetch(batch_examples(
                dataset, batch_size, config.max_gt_boxes,
                drop_remainder=False, workers=workers,
                shard=(shard.rank, shard.world))):
            res = parallel.gather_results(
                predict(torch.from_numpy(batch["image"]).to(device)), shard)
            run.results.append(res)
            res = _host(res)
            batch = _gather_rows(batch, shard)
            timer.tick()
            nv = batch["num_valid"]
            if limit is not None:
                nv = min(nv, limit - seen)
            reals.append(nv)
            _record(run, batch, nv)
            _accumulate_batch(res, nv, batch, gts, dets)
            seen += nv
            if limit is not None and seen >= limit:
                break
        total = sum(timer.measured)
        timed = sum(reals[timer.skip:])
        run.img_per_s = timed / total if total > 0 and timed else None
        p50 = timer.summary().get("p50_s")
        feed = "streamed" + (f", p50 batch {p50 * 1e3:.2f} ms"
                             if p50 is not None else "")
    if run.img_per_s is not None and lead:
        name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
        ranks = f", {shard.world} ranks" if shard.world > 1 else ""
        print(f"inference: {run.img_per_s:.1f} img/s ({feed}, batch="
              f"{batch_size}, {sum(run.num_valid)} images, first batch "
              f"excluded, padded rows not counted, device={name}{ranks})")
    if evaluate and lead:
        run.mean_ap = evaluate_predictions(
            gts, dets, num_classes=config.total_labels - 1,
            class_names=LABELS)["map"]
    return run


def _gather_rows(batch: Dict, shard: parallel.Shard) -> Dict:
    """A streamed batch's host rows of every rank, concatenated in rank
    order (the global batch, its padded rows where they lie)."""
    if not shard.distributed:
        return batch
    keys = ("image", "boxes", "labels", "difficult")
    parts = parallel.gather_objects(
        {k: batch[k] for k in keys + ("ids", "num_valid")}, shard)
    out = {k: np.concatenate([p[k] for p in parts]) for k in keys}
    out["ids"] = [i for p in parts for i in p["ids"][:p["num_valid"]]]
    out["num_valid"] = sum(p["num_valid"] for p in parts)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host(res: NMSResult) -> NMSResult:
    return NMSResult(*(t.cpu().numpy() for t in res))


def _record(run: ServingRun, rows: Dict, nv: int) -> None:
    run.images.append(rows["image"])
    run.ids.append(list(rows["ids"][:nv]))
    run.num_valid.append(nv)


def draw_run(run: ServingRun, count: int, output_dir: str,
             score_threshold: float) -> int:
    """The first `count` served images with their detections drawn, as
    <output_dir>/<id>.png; returns how many were written."""
    from tfssd_torch.utils.drawing import draw_predictions

    os.makedirs(output_dir, exist_ok=True)
    drawn = 0
    for images, ids, res, nv in zip(run.images, run.ids, run.results,
                                    run.num_valid):
        host = _host(res)
        for i in range(min(nv, count - drawn)):
            draw_predictions(
                images[i], host.boxes[i], host.scores[i], host.classes[i],
                LABELS, score_threshold=score_threshold,
                path=os.path.join(output_dir,
                                  os.path.splitext(ids[i])[0] + ".png"))
            drawn += 1
    return drawn


def build_parser() -> argparse.ArgumentParser:
    p = handle_args("tfssd_torch predictor (PyTorch/CUDA serving path)",
                    datasets=("synthetic", "voc"))
    p.prog = "python -m tfssd_torch.predict"
    p.add_argument("--split", default="test")
    p.add_argument("--image-dir", default=None,
                   help="folder of arbitrary images instead of a split")
    p.add_argument("--output-dir", default="outputs")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--no-eval", action="store_true")
    p.add_argument("--draw", type=int, default=0,
                   help="save the first N images with drawn boxes")
    p.add_argument("--score-threshold", type=float, default=0.5,
                   help="the lowest score --draw draws")
    p.add_argument("--workers", type=int, default=8,
                   help="host decode threads")
    p.add_argument("--device-cache", choices=("auto", "on", "off"),
                   default="auto",
                   help="stage the split on the device once and serve "
                        "batches from there (auto: where its uint8 images "
                        "take at most 6e9 bytes)")
    p.add_argument("--fold-bn", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="fold inference-mode BatchNorm into the conv "
                        "weights at load time (default on)")
    w = p.add_mutually_exclusive_group()
    w.add_argument("--weights", metavar="PATH.npz",
                   help="Flax variable tree, '/'-joined keys, instead of "
                        "the checkpoint under --model-dir")
    w.add_argument("--random-weights", action="store_true",
                   help="seeded random weights (smoke testing)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of --random-weights")
    p.add_argument("--export", default=None, metavar="PATH",
                   help="write the whole predict path (forward + decode + "
                        "NMS, the loaded weights inside) as one "
                        "torch.export artifact, then exit; it serves on "
                        "the card or the CPU without model code "
                        "(utils/export.py:load_exported)")
    p.add_argument("--export-batch", type=int, default=None,
                   help="batch size baked into --export (default: "
                        "--batch-size)")
    p.add_argument("--port-h5", default=None, metavar="PATH",
                   help="Keras .h5 / .keras model whose trunk weights are "
                        "ported into the backbone (the reference's "
                        "migration path); the heads keep their seeded "
                        "weights unless a checkpoint is also loaded")
    return p


def _dataset(args, image_size: int):
    """The examples to serve, as predictor.py picks them."""
    if args.image_dir:
        return list(custom_image_generator(get_custom_imgs(args.image_dir),
                                           image_size))
    if args.dataset == "voc":
        parts = [VOCDataset(root, split, image_size=image_size,
                            skip_difficult=False)
                 for root, split in (parse_data_root(s, args.split)
                                     for s in args.data_root)]
        return parts[0] if len(parts) == 1 else ConcatDataset(parts)
    return SyntheticDataset(SYNTHETIC_EVAL_SIZE, image_size=image_size,
                            seed=SYNTHETIC_EVAL_SEED)


def main(argv: Optional[Sequence[str]] = None) -> Optional[ServingRun]:
    """The CLI; returns the ServingRun, or None after --export (and on a
    rank that a batch not divisible by the ranks leaves idle)."""
    args = build_parser().parse_args(argv)
    if args.dataset == "voc" and not args.data_root and not args.image_dir:
        raise SystemExit(
            "--dataset voc needs a --data-root VOCdevkit/VOC2007-style "
            "directory; pass --dataset synthetic or --image-dir to run "
            "without VOC")
    shard, dev, owned = parallel.setup(args.device)
    try:
        return _predict(args, shard, dev)
    finally:
        parallel.teardown(owned)


def _predict(args, shard: parallel.Shard,
             dev: torch.device) -> Optional[ServingRun]:
    if shard.world > 1 and (args.batch_size % shard.world or args.image_dir
                            or args.export):
        if args.batch_size % shard.world:
            print(f"WARNING: --batch-size {args.batch_size} does not divide "
                  f"the {shard.world} ranks; falling back to a single rank "
                  f"({shard.world - 1} idle) — use a multiple of "
                  f"{shard.world} for data-parallel inference")
        elif args.image_dir:
            print(f"WARNING: --image-dir is served by one rank "
                  f"({shard.world - 1} idle): a folder has no random "
                  f"access to split")
        if shard.rank:
            return None
        shard = parallel.SINGLE
    # load_model reads the weights, and stops on a missing checkpoint,
    # before it builds the model.
    weights: Weights = None
    if args.weights:
        weights = args.weights
    elif not args.random_weights:
        weights = get_jax_model_path(args.backbone, args.model_dir)
        if (args.port_h5
                and OrbaxCheckpoints(weights).serving_step() is None):
            weights = None  # the trunk-only weights serve without one
    # --export keeps the BatchNorm graph unfolded, as the JAX predictor's
    cfg, model = load_model(args.backbone, weights, args.seed, dev,
                            fold_bn=args.fold_bn and not args.export,
                            port_h5=args.port_h5)
    if args.export:
        from tfssd_torch.utils.export import export_predict

        batch = args.export_batch or args.batch_size
        blob = export_predict(model, generate_anchors(cfg), cfg, batch)
        with open(args.export, "wb") as f:
            f.write(blob)
        print(f"exported predict (batch {batch}, weights inside) to "
              f"{args.export}: {len(blob) / 1e6:.1f} MB")
        return None
    dataset = _dataset(args, cfg.img_size)
    rows = min(len(dataset), args.limit or len(dataset))
    use_cache = (not args.image_dir and args.device_cache != "off" and
                 (args.device_cache == "on" or
                  rows * cfg.img_size ** 2 * 3 <= DEVICE_CACHE_BYTES))
    run = serve(model, cfg, dataset, args.batch_size, args.limit,
                device_cache=use_cache,
                workers=1 if args.image_dir else args.workers,
                evaluate=not (args.no_eval or args.image_dir), shard=shard)
    if args.draw and shard.rank == 0:
        drawn = draw_run(run, args.draw, args.output_dir,
                         args.score_threshold)
        print(f"drew {drawn} images into {args.output_dir}")
    return run


if __name__ == "__main__":
    main()
