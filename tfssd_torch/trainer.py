"""Training entry point (port of the repository's trainer.py).

    python -m tfssd_torch.trainer [--backbone vgg16] --dataset voc \\
        --data-root VOCdevkit/VOC2007 [--data-root VOCdevkit/VOC2012] \\
        [--val-split val] [--device-cache {auto,on,off}] \\
        [--steps-per-call K] [--workers 8] [--prefetch-depth 4] \\
        [--profile] [--debug-nans] [--bf16] [--remat] [--resume] \\
        [--port-h5 mobilenet_v2.keras] [--device cpu]
    torchrun --nproc_per_node=N -m tfssd_torch.trainer ...

Each of the JAX package's configurations at full width, 21 labels and 64
gt rows per image: SSD300-MobileNetV2 (--backbone mobilenet_v2, the
default: 300x300 images, 2,268 anchors), SSD300-VGG16 (vgg16: 300x300,
8,732 anchors) and SSD512-VGG16 (vgg16_512: 512x512, 24,564 anchors).
Every step augments its batch on the device, matches it with the
match/encode kernel (CUDA) and takes one Adam step; validation runs every
--val-every epochs and checkpoints keep the 3 best by validation loss
under <model-dir>/ssd_<backbone>_torch. It runs on the card unless
--device cpu is given, and raises when there is no card. It writes only
under --model-dir and --log-dir. --bf16 runs the backbone and heads in
bfloat16 (parameters, BatchNorm statistics, matching, the loss and Adam
stay float32) and --remat recomputes the backbone's activations in the
backward, as the JAX trainer's flags do; neither changes the directories,
the sidecar or the checkpoint's keys, so --resume works across them.

Data. --dataset voc reads VOCdevkit-style roots (--data-root
ROOT[:SPLIT], repeatable: the roots' --train-split sets one after
another, as VOC07+12 is trained) and validates on the first root's
--val-split. --dataset synthetic (the port's default, as for
tfssd_torch.predict; the JAX trainer's is voc) trains on the synthetic
scenes. Two feeds, chosen by --device-cache (auto: the device cache when
the uint8 images of both sets take at most 6e9 bytes, as in the JAX
trainer):
  * the device cache stages both sets on the device once and gathers each
    step's rows there;
  * the streamed feed decodes each epoch's batches in --workers threads
    and copies them to the device in a prefetch thread, --prefetch-depth
    batches ahead. The copy is a plain .to(device) of pageable memory,
    which returns once the batch is on the device, so the step never
    reads a batch before its copy lands (no pinned memory, no side
    stream). An epoch is one pass: a larger --steps-per-epoch is clamped.
Both feeds visit epoch e in the order
np.random.default_rng(seed * 10_000 + e).permutation(len(train)), so with
the same flags they train on the same batches in the same order.

--steps-per-call K runs K steps per call (train.make_multi_train_step,
make_cached_multi_train_step; steps per epoch floored to a multiple of
K), the same computation as K calls of one step; the metrics of the last
step of the call that crosses the --log-every cadence are logged.
--profile writes a torch.profiler trace of the first epoch into the log
directory (also when the epoch raises), each step in a "train_step#<step>"
range. --debug-nans reads each step's loss metrics and gradient norm and
raises FloatingPointError at the first non-finite one (utils/
profiling.py). --pallas and --handle-gpu are accepted so that the JAX
trainer's command lines parse: on the card the match/encode kernel always
runs.

--port-h5 PATH writes the conv trunk of a Keras model file (.h5 or .keras,
as Keras's model.save writes them: keras.applications.MobileNetV2 for
mobilenet_v2, VGG16 for the VGG16 configs; read without Keras,
utils/port_weights.py) into the fresh model's parameters in place, before
--resume and before the weights are broadcast to the ranks, so a checkpoint
that --resume finds overrides it, as in the JAX trainer.

--resume reads, in this order: the latest of the port's own checkpoints
under <model-dir>/ssd_<backbone>_torch; where there is none, the latest
step of the JAX trainer's orbax checkpoint under <model-dir>/ssd_<backbone>
(e.g. the committed trained/ssd_mobilenet_v2/7680), restored whole as
trainer.py --resume restores it: the step, params, batch_stats and
optax Adam's moments and counts (utils/checkpoint.py:OrbaxCheckpoints).
So `python -m tfssd_torch.trainer --model-dir trained --resume` continues
in the port what `python trainer.py --model-dir trained --resume` would
continue, and a second --resume continues the port's own run. The schedule
geometry is compared with the sidecar of the checkpoint read
(<dir>_meta.json) and a change warned about; the JAX trainer's directory
and sidecar are only read, and only the port's sidecar is written.

Data parallelism (tfssd_torch/parallel.py), as the JAX trainer shards its
batch over every visible device: under torchrun each rank trains on its
rows of every global batch of --batch-size (which must divide into the
ranks), in both feeds (the device cache stages the whole split on every
rank and gathers the rank's rows; the streamed feed decodes only the
rank's rows), with the global batch's augmentation draws, BatchNorm
statistics, loss and metrics, and gradients averaged over the ranks
before Adam. The weights and Adam's state start from rank 0's. Only rank
0 writes checkpoints, the sidecar, the metrics log (metrics.jsonl and a
TensorBoard event file, utils/metrics.py) and the --profile trace; every
rank reads the checkpoint on --resume.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import time
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from tfssd_torch import get_hyper_params, parallel
from tfssd_torch.data.loader import (DEVICE_CACHE_BYTES, ConcatDataset,
                                     PrefetchStats, batch_examples, prefetch,
                                     stack_batches, stage_arrays)
from tfssd_torch.data.synthetic import SyntheticDataset
from tfssd_torch.data.voc import VOCDataset
from tfssd_torch.ops.boxes import generate_anchors
from tfssd_torch.train import (TrainState, create_train_state,
                               make_cached_multi_eval_step,
                               make_cached_multi_train_step,
                               make_cached_train_step, make_eval_step,
                               make_lr_schedule, make_multi_train_step,
                               make_train_step)
from tfssd_torch.utils import profiling
from tfssd_torch.utils.checkpoint import CheckpointManager, OrbaxCheckpoints
from tfssd_torch.utils.io import (get_jax_model_path, get_log_path,
                                  get_model_path, handle_args,
                                  parse_data_root)
from tfssd_torch.utils.metrics import MetricsLogger
from tfssd_torch.utils.port_weights import port_h5_into_variables

# The JAX trainer's short names in its e2e metric.
_SHORT = {"mobilenet_v2": "mbv2", "vgg16": "vgg16", "vgg16_512": "ssd512"}
_KEYS = ("image", "boxes", "labels")


def make_datasets(args, img_size: int):
    """The training and validation sets, as the JAX trainer picks them."""
    if args.dataset == "voc" and not args.data_root:
        raise SystemExit(
            "--dataset voc needs at least one --data-root "
            "VOCdevkit/VOC2007-style directory (tfds is unavailable "
            "offline); pass --dataset synthetic to train without data")
    if args.dataset == "voc":
        parts = [VOCDataset(root, split, image_size=img_size)
                 for root, split in (parse_data_root(s, args.train_split)
                                     for s in args.data_root)]
        train = parts[0] if len(parts) == 1 else ConcatDataset(parts)
        # validation reads the first root only (VOC07's, in VOC07+12)
        val_root, _ = parse_data_root(args.data_root[0], args.train_split)
        val = VOCDataset(val_root, args.val_split, image_size=img_size)
        return train, val
    train = SyntheticDataset(args.synthetic_size, image_size=img_size,
                             seed=0)
    val = SyntheticDataset(max(args.synthetic_size // 8, 8),
                           image_size=img_size, seed=10_000)
    return train, val


def epoch_indices(seed: int, epoch: int, train_n: int, steps: int,
                  batch_size: int) -> np.ndarray:
    """(steps, batch_size) rows of epoch `epoch`: fresh permutations of
    [0, train_n) concatenated until the epoch's budget is covered."""
    need = steps * batch_size
    rng = np.random.default_rng(seed * 10_000 + epoch)
    idx = np.concatenate([rng.permutation(train_n)
                          for _ in range(-(-need // train_n))])[:need]
    return idx.reshape(steps, batch_size)


@dataclasses.dataclass
class TrainRun:
    """What one trainer run did: the final state, the steps it ran (this
    run only), the logged train metrics, every step's metrics in order,
    the validation losses per epoch, the validation batches evaluated,
    the checkpoint and log directories, the feed (device_cache,
    steps_per_call, steps_per_epoch), each epoch's seconds (train,
    validation and checkpoint), the streamed feed's prefetch waits, the
    end-to-end img/s (None when fewer than two epochs ran) and this
    process's rank in the data-parallel world. The metrics are the global
    batch's on every rank."""

    state: TrainState
    steps_run: int
    train_metrics: List[Dict[str, float]]
    val_losses: Dict[int, float]
    val_batches: int
    model_path: str
    e2e_img_per_s: Optional[float]
    step_metrics: List[Dict[str, float]] = dataclasses.field(
        default_factory=list)
    log_path: str = ""
    device_cache: bool = True
    steps_per_call: int = 1
    steps_per_epoch: int = 0
    epoch_seconds: List[float] = dataclasses.field(default_factory=list)
    prefetch: PrefetchStats = dataclasses.field(
        default_factory=PrefetchStats)
    shard: parallel.Shard = parallel.SINGLE


def build_parser():
    p = handle_args("tfssd_torch trainer (PyTorch/CUDA training path)",
                    datasets=("synthetic", "voc"))
    p.prog = "python -m tfssd_torch.trainer"
    p.add_argument("--epochs", type=int, default=120)
    p.add_argument("--steps-per-epoch", type=int, default=None,
                   help="override; default = floor(len(train)/batch)")
    p.add_argument("--train-split", default="trainval")
    p.add_argument("--val-split", default="val")
    p.add_argument("--synthetic-size", type=int, default=512)
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="continue the latest checkpoint: the port's own "
                        "under <model-dir>/ssd_<backbone>_torch, else the "
                        "JAX trainer's orbax checkpoint under "
                        "<model-dir>/ssd_<backbone> (read only)")
    p.add_argument("--port-h5", default=None, metavar="PATH",
                   help="initialise the conv trunk from a Keras .h5 / "
                        ".keras model (the reference's weights, a "
                        "keras.applications ImageNet trunk) and fine-tune "
                        "from it; ignored when --resume finds a checkpoint")
    p.add_argument("--init-lr", type=float, default=1e-3)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 conv trunk and heads (float32 parameters)")
    p.add_argument("--pallas", action="store_true",
                   help="accepted for the JAX trainer's command lines; on "
                        "the card the match/encode kernel always runs")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize backbone activations "
                        "(larger batches, ~30%% more fwd FLOPs)")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace of the first epoch "
                        "into the log dir")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise FloatingPointError at the first non-finite "
                        "loss or gradient (reads every step's metrics)")
    p.add_argument("--ckpt-every", type=int, default=1,
                   help="epochs between checkpoint saves (the final epoch "
                        "always saves)")
    p.add_argument("--val-every", type=int, default=1,
                   help="epochs between validation passes (the final epoch "
                        "always validates; an epoch without one also skips "
                        "its checkpoint)")
    p.add_argument("--val-limit", type=int, default=None,
                   help="cap validation at N batches per pass")
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="optimizer steps per call, the same computation "
                        "as one step per call; steps_per_epoch is floored "
                        "to a multiple")
    p.add_argument("--device-cache", choices=("auto", "on", "off"),
                   default="auto",
                   help="stage the decoded data on the device once and "
                        "gather batches there (auto: on when the uint8 "
                        "images take at most 6e9 bytes); off streams "
                        "batches decoded on the host")
    p.add_argument("--prefetch-depth", type=int, default=4,
                   help="host batches buffered ahead of the device")
    p.add_argument("--workers", type=int, default=8,
                   help="parallel host decode threads")
    p.add_argument("--log-every", type=int, default=50,
                   help="steps between metric reads (each waits for the "
                        "device)")
    p.add_argument("--seed", type=int, default=0)
    return p


def _epoch_geometry(args, train_n: int, device_cache: bool):
    """(steps_per_epoch, steps_per_call) as the JAX trainer derives them,
    with its messages: one pass per streamed epoch, floored to a multiple
    of the steps per call."""
    one_pass_steps = max(train_n // args.batch_size, 1)
    steps_per_epoch = args.steps_per_epoch or one_pass_steps
    if not device_cache and steps_per_epoch > one_pass_steps:
        print(f"steps_per_epoch clamped to {one_pass_steps} (one dataset "
              f"pass; the streamed path cannot wrap — use --device-cache "
              f"on for longer epochs)")
        steps_per_epoch = one_pass_steps
    spc = max(1, min(args.steps_per_call, steps_per_epoch))
    if steps_per_epoch % spc:
        steps_per_epoch -= steps_per_epoch % spc
        print(f"steps_per_epoch floored to {steps_per_epoch} "
              f"(multiple of --steps-per-call {spc})")
    return steps_per_epoch, spc


def _real_rows(n: int, batch_size: int, n_batches: int) -> int:
    """Real (unpadded) rows in the first n_batches batches of a set of n
    rows, the last one padded."""
    return sum(max(0, min(n - vb * batch_size, batch_size))
               for vb in range(n_batches))


def _host_rows(calls: List[Dict[str, torch.Tensor]]) -> List[Dict]:
    """Per-step metrics of one epoch's calls (scalars or stacked (K,)),
    read from the device in one transfer."""
    if not calls:
        return []
    keys = list(calls[0])
    cols = torch.stack([torch.cat([c[k].float().reshape(-1) for c in calls])
                        for k in keys]).tolist()
    return [dict(zip(keys, row)) for row in zip(*cols)]


class _CachedFeed:
    """Both sets staged on the device once (uint8 pixels: augmentation
    runs per step on the device); each call gathers its rows there. Under
    data parallelism every rank stages both sets whole and the steps
    gather the rank's rows of the global batch's indices."""

    def __init__(self, args, train_ds, val_ds, max_gt: int, dev):
        self.args, self.dev = args, dev
        t0 = time.perf_counter()
        host, self.train_n = stage_arrays(train_ds, max_gt,
                                          workers=args.workers)
        self.train = {k: torch.from_numpy(host[k]).to(dev) for k in _KEYS}
        del host
        host, self.val_n = stage_arrays(val_ds, max_gt, workers=args.workers,
                                        pad_to_multiple=args.batch_size)
        self.val = {k: torch.from_numpy(host[k]).to(dev) for k in _KEYS}
        del host
        img_size = self.train["image"].shape[1]
        gb = (self.train_n + self.val_n) * img_size ** 2 * 3 / 1e9
        print(f"device cache: staged {self.train_n}+{self.val_n} images "
              f"(~{gb:.2f} GB) in {time.perf_counter() - t0:.1f}s")

    def epoch(self, epoch: int, steps: int, spc: int) -> Iterator[tuple]:
        """The train step's arguments after the state, call by call."""
        rows = torch.from_numpy(epoch_indices(
            self.args.seed, epoch, self.train_n, steps,
            self.args.batch_size)).to(self.dev)
        for first in range(0, steps, spc):
            idx = rows[first:first + spc]
            yield self.train, (idx if spc > 1 else idx[0])

    def validate(self, eval_step, state: TrainState):
        """(mean loss of each validation batch, real rows): the whole pass
        dispatched before one read."""
        b = self.args.batch_size
        n_batches = self.val["image"].shape[0] // b
        if self.args.val_limit is not None:
            n_batches = min(n_batches, self.args.val_limit)
        idx = torch.arange(n_batches * b, device=self.dev).reshape(
            n_batches, b)
        losses = eval_step(state, self.val, idx)["loss"].tolist()
        return losses, _real_rows(self.val_n, b, n_batches)


class _StreamedFeed:
    """Batches decoded on the host in --workers threads and copied to the
    device in a prefetch thread, --prefetch-depth ahead. The copy is a
    plain .to(device) of pageable memory, which returns once the batch is
    on the device: the step never reads a batch before its copy lands.
    Under data parallelism each rank decodes and copies only its rows of
    every global batch."""

    def __init__(self, args, train_ds, val_ds, max_gt: int, dev,
                 stats: PrefetchStats, shard: parallel.Shard):
        self.args, self.dev, self.stats = args, dev, stats
        self.shard = (shard.rank, shard.world)
        self.train_ds, self.val_ds, self.max_gt = train_ds, val_ds, max_gt

    def _to_device(self, batches):
        for b in batches:
            yield ({k: torch.from_numpy(b[k]).to(self.dev) for k in _KEYS},
                   b["num_valid"])

    def epoch(self, epoch: int, steps: int, spc: int) -> Iterator[tuple]:
        """One pass in the order of np.random.default_rng(seed * 10_000 +
        epoch), as the device cache's, k batches stacked per call."""
        args = self.args
        batches = batch_examples(self.train_ds, args.batch_size,
                                 self.max_gt,
                                 shuffle_seed=args.seed * 10_000 + epoch,
                                 workers=args.workers, shard=self.shard)
        if spc > 1:
            batches = stack_batches(batches, spc)
        with contextlib.closing(prefetch(self._to_device(batches),
                                         depth=args.prefetch_depth,
                                         stats=self.stats)) as it:
            for batch, _ in itertools.islice(it, steps // spc):
                yield (batch,)

    def validate(self, eval_step, state: TrainState):
        """(mean loss of each validation batch, real rows), the short last
        batch padded."""
        args = self.args
        losses = []
        batches = prefetch(self._to_device(batch_examples(
            self.val_ds, args.batch_size, self.max_gt, drop_remainder=False,
            workers=args.workers, shard=self.shard)),
            depth=args.prefetch_depth)
        with contextlib.closing(batches):
            for batch, _ in itertools.islice(batches, args.val_limit):
                losses.append(eval_step(state, batch)["loss"])
        return ((torch.stack(losses).tolist() if losses else []),
                _real_rows(len(self.val_ds), args.batch_size, len(losses)))


def main(argv: Optional[Sequence[str]] = None) -> TrainRun:
    args = build_parser().parse_args(argv)
    shard, dev, owned = parallel.setup(args.device)
    try:
        return _train(args, shard, dev)
    finally:
        parallel.teardown(owned)


def _train(args, shard: parallel.Shard, dev: torch.device) -> TrainRun:
    lead = shard.rank == 0
    cfg = get_hyper_params(
        args.backbone, compute_dtype="bfloat16" if args.bf16 else "float32",
        remat=args.remat)
    print(f"backbone={cfg.backbone} img={cfg.img_size} "
          f"anchors={cfg.total_anchors} device={dev} "
          f"compute_dtype={cfg.compute_dtype} remat={cfg.remat} "
          f"rank={shard.rank}/{shard.world}")
    train_ds, val_ds = make_datasets(args, cfg.img_size)
    if len(train_ds) < args.batch_size:
        raise SystemExit(
            f"training dataset ({len(train_ds)} examples) is smaller than "
            f"--batch-size {args.batch_size}; full batches are required")
    if args.batch_size % shard.world:
        raise SystemExit(
            f"--batch-size {args.batch_size} must be a multiple of the "
            f"{shard.world} data-parallel ranks (the batch axis is split "
            f"over the ranks)")
    est_bytes = (len(train_ds) + len(val_ds)) * cfg.img_size ** 2 * 3
    device_cache = (args.device_cache == "on" or
                    (args.device_cache == "auto"
                     and est_bytes <= DEVICE_CACHE_BYTES))
    if args.device_cache == "auto" and not device_cache:
        print(f"device cache off: dataset ~{est_bytes/1e9:.1f} GB "
              f"exceeds the 6 GB auto threshold (--device-cache on to "
              f"force)")
    steps_per_epoch, spc = _epoch_geometry(args, len(train_ds), device_cache)

    anchors = torch.from_numpy(generate_anchors(cfg)).to(dev)
    schedule = make_lr_schedule(steps_per_epoch, args.init_lr)
    state = create_train_state(cfg, args.seed, dev, schedule)
    if args.port_h5:
        port_h5_into_variables(state.model, cfg.backbone, args.port_h5)
        print(f"ported trunk weights from {args.port_h5}; fine-tuning")
    step_kw = dict(augment=not args.no_augment, seed=args.seed + 1,
                   shard=shard)
    if device_cache:
        factory = (make_cached_multi_train_step if spc > 1
                   else make_cached_train_step)
        eval_step = make_cached_multi_eval_step(anchors, cfg, shard)
    else:
        factory = make_multi_train_step if spc > 1 else make_train_step
        eval_step = make_eval_step(anchors, cfg, shard)
    train_step = factory(anchors, cfg, **step_kw)

    model_path = get_model_path(args.backbone, args.model_dir)
    ckpt = CheckpointManager(model_path)
    # Schedule-geometry sidecar: the resume epoch and the LR boundaries
    # follow the current flags, so warn when they changed.
    meta = {"steps_per_epoch": steps_per_epoch,
            "batch_size": args.batch_size, "steps_per_call": spc}
    meta_path = os.path.normpath(model_path) + "_meta.json"
    if args.resume:
        # the port's own checkpoint first, else the JAX trainer's (read
        # only: its directory and sidecar are never written)
        jax_path = get_jax_model_path(args.backbone, args.model_dir)
        source, source_meta = ckpt, meta_path
        if ckpt.latest_step() is None:
            source = OrbaxCheckpoints(jax_path)
            source_meta = os.path.normpath(jax_path) + "_meta.json"
        if source.latest_step() is not None:
            if os.path.exists(source_meta):
                with open(source_meta) as f:
                    old_meta = json.load(f)
                if old_meta != meta:
                    print(f"WARNING: resuming with changed schedule "
                          f"geometry (checkpoint: {old_meta}, this run: "
                          f"{meta}) - the resume epoch and LR decay "
                          f"boundaries will NOT line up with the original "
                          f"run")
            source.restore(state)
            if source is ckpt:
                print(f"resumed from step {state.step}")
            else:
                print(f"resumed from step {state.step} of the JAX "
                      f"package's checkpoint {jax_path} (params, "
                      f"batch_stats and Adam's state)")
    parallel.broadcast_state(state.model, state.optimizer, shard)
    # every rank has read the sidecar before rank 0 rewrites it
    parallel.barrier(shard)
    if lead:
        with open(meta_path, "w") as f:
            json.dump(meta, f)

    waits = PrefetchStats()
    feed = (_CachedFeed(args, train_ds, val_ds, cfg.max_gt_boxes, dev)
            if device_cache else
            _StreamedFeed(args, train_ds, val_ds, cfg.max_gt_boxes, dev,
                          waits, shard))
    log_path = get_log_path(args.backbone, args.log_dir)
    run = TrainRun(state, 0, [], {}, 0, model_path, None,
                   log_path=log_path, device_cache=device_cache,
                   steps_per_call=spc, steps_per_epoch=steps_per_epoch,
                   prefetch=waits, shard=shard)
    total_images = 0
    train_start = None
    debug_nans_before = profiling.enable_debug_nans(args.debug_nans)
    try:
        # only rank 0 logs
        with (MetricsLogger(log_path) if lead
              else contextlib.nullcontext()) as log:
            start_epoch = state.step // steps_per_epoch
            for epoch in range(start_epoch, args.epochs):
                t_epoch = time.perf_counter()
                epoch_steps, epoch_metrics = 0, []
                calls = []
                with contextlib.ExitStack() as stack:
                    if args.profile and epoch == start_epoch and lead:
                        # written also when the epoch raises (a NaN halt,
                        # an interrupt): the failing run is when the trace
                        # matters
                        stack.callback(print, f"profiler trace written to "
                                              f"{log_path}")
                        stack.enter_context(profiling.trace(log_path))
                    for step_args in feed.epoch(epoch, steps_per_epoch, spc):
                        step_in_epoch = epoch_steps
                        metrics = train_step(state, *step_args)
                        calls.append(metrics)
                        epoch_steps += spc
                        # Metrics stay on the device but at the logging
                        # cadence; a call of K steps logs its last step.
                        if step_in_epoch % args.log_every < spc:
                            m = {k: float(v[-1] if spc > 1 else v)
                                 for k, v in metrics.items()}
                            epoch_metrics.append(m)
                            print(f"epoch {epoch} step {step_in_epoch}/"
                                  f"{steps_per_epoch} loss={m['loss']:.4f} "
                                  f"loc={m['loc_loss']:.4f} "
                                  f"conf={m['conf_loss']:.4f}")
                            if log is not None:
                                log.log(state.step, m, prefix="train/")
                    run.step_metrics.extend(_host_rows(calls))
                run.steps_run += epoch_steps
                run.train_metrics.extend(epoch_metrics)
                if train_start is not None:
                    total_images += epoch_steps * args.batch_size

                last_epoch = epoch == args.epochs - 1
                if (epoch + 1) % args.val_every == 0 or last_epoch:
                    losses, val_count = feed.validate(eval_step, state)
                    run.val_batches += len(losses)
                    # padded rows add zero loss: weight by the real rows
                    val_loss = (sum(x * args.batch_size for x in losses)
                                / val_count if val_count else float("inf"))
                    run.val_losses[epoch] = val_loss
                    tr = (float(np.mean([m["loss"] for m in epoch_metrics]))
                          if epoch_metrics else float("nan"))
                    print(f"epoch {epoch}: train_loss={tr:.4f} "
                          f"val_loss={val_loss:.4f} "
                          f"lr={schedule(state.step):.2e}")
                    if log is not None:
                        log.log(state.step, {"val_loss": val_loss,
                                             "epoch": epoch})
                    if lead and ((epoch + 1) % args.ckpt_every == 0
                                 or last_epoch):
                        ckpt.save(state.step, state, val_loss=val_loss)
                # The end-to-end clock starts after the first epoch (train,
                # validation and checkpoint), so one-time set-up (cuDNN
                # plans, the kernel build) stays out of it.
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                run.epoch_seconds.append(time.perf_counter() - t_epoch)
                if train_start is None:
                    train_start = time.perf_counter()
    finally:
        profiling.enable_debug_nans(debug_nans_before)

    if train_start is not None and total_images:
        run.e2e_img_per_s = total_images / (time.perf_counter()
                                            - train_start)
    if run.e2e_img_per_s is not None and lead:
        short = _SHORT.get(args.backbone, args.backbone)
        print(json.dumps({
            "metric": f"train_{short}_e2e_images_per_sec",
            "value": round(run.e2e_img_per_s, 2), "unit": "images/sec",
            "config": f"tfssd_torch.trainer end-to-end, batch "
                      f"{args.batch_size}, val-every {args.val_every}, "
                      f"{'device-cached data' if device_cache else 'streamed data'}"
                      + (f", steps-per-call {spc}" if spc > 1 else "")
                      + f", incl. validation + checkpointing (after the "
                      f"first epoch), {cfg.compute_dtype}"
                      + (", remat" if cfg.remat else "")
                      + f", device={dev.type}"}))
    return run


if __name__ == "__main__":
    main()
