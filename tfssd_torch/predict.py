"""Serving entry point: weights -> folded SSD -> batched predict -> VOC mAP.

Port of the repository's predictor.py (restore -> fold -> predict ->
synthetic eval), run as

    python -m tfssd_torch.predict --backbone mobilenet_v2 --dataset synthetic \
        --limit 32 --batch-size 8 --random-weights --seed 0 [--device cpu]
    python -m tfssd_torch.predict --weights ssd_mobilenet_v2_7680.npz ...
    python -m tfssd_torch.predict --backbone vgg16 --weights ssd_vgg16_4720.npz
    python -m tfssd_torch.predict --backbone vgg16_512 --random-weights ...

--backbone is a config name of get_hyper_params: mobilenet_v2 and vgg16
(SSD300), vgg16_512 (SSD512). The CLI serves in float32, as the JAX
predictor does; load_model(..., compute_dtype="bfloat16") + serve is the
bfloat16 serving configuration of the JAX benchmark (BN folded, backbone
and heads in bfloat16, decode and NMS in float32).

--weights takes an .npz of the Flax variable tree with '/'-joined keys
(utils/convert.py:flatten_tree; README.md shows how to write one from the
JAX package's checkpoint). It runs on the card unless --device cpu is
given, and raises when there is no card. Not ported yet: reading the orbax
checkpoint directly, --image-dir, drawing, VOC directories (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tfssd_torch import get_hyper_params, resolve_device
from tfssd_torch.config import SSDConfig
from tfssd_torch.data.loader import batch_examples
from tfssd_torch.data.synthetic import SyntheticDataset
from tfssd_torch.evaluate import detections_from_nms_result, evaluate_predictions
from tfssd_torch.models.decoder import decode_predictions, preprocess_images
from tfssd_torch.models.ssd import SSD, get_model, init_random_weights
from tfssd_torch.ops.boxes import generate_anchors
from tfssd_torch.ops.nms import NMSResult
from tfssd_torch.utils.convert import is_folded, load_variables
from tfssd_torch.utils.fold_bn import fold_for_serving
from tfssd_torch.utils.io import VALID_BACKBONES

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)
LABELS = ("bg",) + VOC_CLASSES

# The evaluation split the JAX predictor serves for --dataset synthetic.
SYNTHETIC_EVAL_SIZE = 128
SYNTHETIC_EVAL_SEED = 10_000


def load_model(backbone: str = "mobilenet_v2", weights: Optional[str] = None,
               seed: int = 0, device="cuda", compute_dtype: str = "float32"):
    """(config, model) ready to serve: weights from an .npz of the Flax tree
    (folded or not) or seeded random weights, BatchNorm folded (VGG16 has
    none), eval mode, on `device`, computing in `compute_dtype` (the
    config's field; the weights stay float32)."""
    dev = resolve_device(device)
    cfg = get_hyper_params(backbone, compute_dtype=compute_dtype)
    if weights is not None:
        with np.load(weights) as npz:
            tree = {k: npz[k] for k in npz.files}
        cfg = dataclasses.replace(cfg, fold_bn=is_folded(tree))
        model = load_variables(get_model(cfg), tree)
    else:
        model = init_random_weights(get_model(cfg), seed)
    model = model.to(dev).eval()
    return fold_for_serving(cfg, model)


@dataclasses.dataclass
class ServingRun:
    """What one serving run produced: per batch the uint8 images that went
    in, the model's (deltas, logits) and the NMSResult that came out (both
    on the serving device), plus the mAP and the throughput."""

    config: SSDConfig
    model: SSD
    anchors: np.ndarray
    images: List[np.ndarray]
    outputs: List[Tuple[torch.Tensor, torch.Tensor]]
    results: List[NMSResult]
    num_valid: List[int]
    mean_ap: float
    img_per_s: Optional[float]


def serve(model: SSD, config: SSDConfig, dataset, batch_size: int,
          limit: Optional[int] = None) -> ServingRun:
    """Predict `dataset` (its first `limit` examples) in batches on the
    model's device and score the detections (VOC07 mAP@0.5)."""
    device = next(model.parameters()).device
    anchors = generate_anchors(config)
    anchors_t = torch.from_numpy(anchors).to(device)
    n = len(dataset) if limit is None else min(limit, len(dataset))
    examples = (dataset.example(i) for i in range(n))
    images, outputs, results, num_valid, gts, dets = [], [], [], [], [], []
    seconds, timed = 0.0, 0
    for b, batch in enumerate(batch_examples(
            examples, batch_size, config.max_gt_boxes,
            drop_remainder=False)):
        t0 = time.perf_counter()
        with torch.no_grad():
            x = torch.from_numpy(batch["image"]).to(device)
            deltas, logits = model(preprocess_images(x))
            res = decode_predictions(anchors_t, deltas, logits, config)
        host = NMSResult(*(t.cpu().numpy() for t in res))
        dt = time.perf_counter() - t0
        nv = batch["num_valid"]
        if b > 0:  # the first batch pays one-time set-up (cuDNN plans)
            seconds += dt
            timed += nv
        images.append(batch["image"])
        outputs.append((deltas, logits))
        results.append(res)
        num_valid.append(nv)
        dets.extend(detections_from_nms_result(host, num_valid=nv))
        for i in range(nv):
            gts.append({"boxes": batch["boxes"][i],
                        "labels": batch["labels"][i],
                        "difficult": batch["difficult"][i]})
    img_per_s = timed / seconds if seconds > 0 else None
    mean_ap = evaluate_predictions(gts, dets,
                                   num_classes=config.total_labels - 1,
                                   class_names=LABELS)["map"]
    return ServingRun(config, model, anchors, images, outputs, results,
                      num_valid, mean_ap, img_per_s)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tfssd_torch.predict",
        description="tfssd_torch predictor (PyTorch/CUDA serving path)")
    p.add_argument("--backbone", default="mobilenet_v2",
                   choices=VALID_BACKBONES,
                   help="SSD300-MobileNetV2, SSD300-VGG16 or SSD512-VGG16")
    p.add_argument("--dataset", default="synthetic", choices=("synthetic",))
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    w = p.add_mutually_exclusive_group(required=True)
    w.add_argument("--weights", metavar="PATH.npz",
                   help="Flax variable tree, '/'-joined keys")
    w.add_argument("--random-weights", action="store_true",
                   help="seeded random weights (smoke testing)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of --random-weights")
    return p


def main(argv: Optional[Sequence[str]] = None) -> ServingRun:
    args = build_parser().parse_args(argv)
    cfg, model = load_model(args.backbone, args.weights, args.seed,
                            args.device)
    dataset = SyntheticDataset(SYNTHETIC_EVAL_SIZE, image_size=cfg.img_size,
                               seed=SYNTHETIC_EVAL_SEED)
    run = serve(model, cfg, dataset, args.batch_size, args.limit)
    dev = next(model.parameters()).device
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    if run.img_per_s is not None:
        print(f"inference: {run.img_per_s:.1f} img/s (batch="
              f"{args.batch_size}, {sum(run.num_valid)} images, first batch "
              f"excluded, host clock incl. transfers, device={name})")
    return run


if __name__ == "__main__":
    main()
