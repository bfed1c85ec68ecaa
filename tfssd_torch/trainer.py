"""Training entry point (port of the repository's trainer.py, its default
path: the synthetic dataset, staged on the device once).

    python -m tfssd_torch.trainer [--backbone vgg16] --dataset synthetic \\
        --epochs 2 --steps-per-epoch 3 --batch-size 32 [--device cpu] \\
        [--bf16] [--remat] [--resume]

Each of the JAX package's configurations at full width, 21 labels and 64
gt rows per image: SSD300-MobileNetV2 (--backbone mobilenet_v2, the
default: 300x300 images, 2,268 anchors), SSD300-VGG16 (vgg16: 300x300,
8,732 anchors) and SSD512-VGG16 (vgg16_512: 512x512, 24,564 anchors).
Each step gathers its batch on the device, augments it there, matches it
with the match/encode kernel (CUDA) and takes one Adam step; validation
runs every --val-every epochs and
checkpoints keep the 3 best by validation loss under
<model-dir>/ssd_<backbone>_torch. It runs on the card unless --device cpu
is given, and raises when there is no card. It writes only under
--model-dir and --log-dir. --bf16 runs the backbone and heads in bfloat16
(parameters, BatchNorm statistics, matching, the loss and Adam stay
float32) and --remat recomputes the backbone's activations in the
backward, as the JAX trainer's flags do; neither changes the directories,
the sidecar or the checkpoint's keys, so --resume works across them.

The index stream is the JAX trainer's: epoch e visits
np.random.default_rng(seed * 10_000 + e) permutations of the training
set. Not ported yet (ROADMAP.md): streamed feeding and VOC directories,
--port-h5, --steps-per-call, --profile and --debug-nans.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tfssd_torch import get_hyper_params, resolve_device
from tfssd_torch.data.loader import stage_arrays
from tfssd_torch.data.synthetic import SyntheticDataset
from tfssd_torch.ops.boxes import generate_anchors
from tfssd_torch.train import (TrainState, create_train_state,
                               make_cached_multi_eval_step,
                               make_cached_train_step, make_lr_schedule)
from tfssd_torch.utils.checkpoint import CheckpointManager
from tfssd_torch.utils.io import get_log_path, get_model_path, handle_args
from tfssd_torch.utils.metrics import MetricsLogger

# The JAX trainer's short names in its e2e metric.
_SHORT = {"mobilenet_v2": "mbv2", "vgg16": "vgg16", "vgg16_512": "ssd512"}


def make_datasets(synthetic_size: int, img_size: int):
    """The JAX trainer's synthetic train and validation sets."""
    train = SyntheticDataset(synthetic_size, image_size=img_size, seed=0)
    val = SyntheticDataset(max(synthetic_size // 8, 8), image_size=img_size,
                           seed=10_000)
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
    run only), the logged train metrics, the validation losses per epoch,
    the validation batches evaluated, the checkpoint directory and the
    end-to-end img/s (None when fewer than two epochs ran)."""

    state: TrainState
    steps_run: int
    train_metrics: List[Dict[str, float]]
    val_losses: Dict[int, float]
    val_batches: int
    model_path: str
    e2e_img_per_s: Optional[float]


def build_parser():
    p = handle_args("tfssd_torch trainer (PyTorch/CUDA training path)")
    p.add_argument("--epochs", type=int, default=120)
    p.add_argument("--steps-per-epoch", type=int, default=None,
                   help="override; default = floor(len(train)/batch)")
    p.add_argument("--synthetic-size", type=int, default=512)
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--init-lr", type=float, default=1e-3)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 conv trunk and heads (float32 parameters)")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize backbone activations "
                        "(larger batches, ~30%% more fwd FLOPs)")
    p.add_argument("--ckpt-every", type=int, default=1,
                   help="epochs between checkpoint saves (the final epoch "
                        "always saves)")
    p.add_argument("--val-every", type=int, default=1,
                   help="epochs between validation passes (the final epoch "
                        "always validates; an epoch without one also skips "
                        "its checkpoint)")
    p.add_argument("--val-limit", type=int, default=None,
                   help="cap validation at N batches per pass")
    p.add_argument("--log-every", type=int, default=50,
                   help="steps between metric reads (each waits for the "
                        "device)")
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv: Optional[Sequence[str]] = None) -> TrainRun:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_hyper_params(
        args.backbone, compute_dtype="bfloat16" if args.bf16 else "float32",
        remat=args.remat)
    print(f"backbone={cfg.backbone} img={cfg.img_size} "
          f"anchors={cfg.total_anchors} device={dev} "
          f"compute_dtype={cfg.compute_dtype} remat={cfg.remat}")
    train_ds, val_ds = make_datasets(args.synthetic_size, cfg.img_size)
    if len(train_ds) < args.batch_size:
        raise SystemExit(
            f"training dataset ({len(train_ds)} examples) is smaller than "
            f"--batch-size {args.batch_size}; full batches are required")
    steps_per_epoch = (args.steps_per_epoch
                       or max(len(train_ds) // args.batch_size, 1))

    anchors = torch.from_numpy(generate_anchors(cfg)).to(dev)
    schedule = make_lr_schedule(steps_per_epoch, args.init_lr)
    state = create_train_state(cfg, args.seed, dev, schedule)
    train_step = make_cached_train_step(anchors, cfg,
                                        augment=not args.no_augment,
                                        seed=args.seed + 1)
    eval_step = make_cached_multi_eval_step(anchors, cfg)

    model_path = get_model_path(args.backbone, args.model_dir)
    ckpt = CheckpointManager(model_path)
    # Schedule-geometry sidecar: the resume epoch and the LR boundaries
    # follow the current flags, so warn when they changed.
    meta = {"steps_per_epoch": steps_per_epoch,
            "batch_size": args.batch_size, "steps_per_call": 1}
    meta_path = os.path.normpath(model_path) + "_meta.json"
    if args.resume and ckpt.latest_step() is not None:
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                old_meta = json.load(f)
            if old_meta != meta:
                print(f"WARNING: resuming with changed schedule geometry "
                      f"(checkpoint: {old_meta}, this run: {meta}) - the "
                      f"resume epoch and LR decay boundaries will NOT line "
                      f"up with the original run")
        ckpt.restore(state)
        print(f"resumed from step {state.step}")
    with open(meta_path, "w") as f:
        json.dump(meta, f)

    # Stage both datasets on the device once (uint8 pixels; augmentation
    # runs per step on the device).
    t0 = time.perf_counter()
    host_train, train_n = stage_arrays(train_ds, cfg.max_gt_boxes)
    host_val, val_n = stage_arrays(val_ds, cfg.max_gt_boxes,
                                   pad_to_multiple=args.batch_size)
    keys = ("image", "boxes", "labels")
    train_data = {k: torch.from_numpy(host_train[k]).to(dev) for k in keys}
    val_data = {k: torch.from_numpy(host_val[k]).to(dev) for k in keys}
    del host_train, host_val
    gb = (train_n + val_n) * cfg.img_size ** 2 * 3 / 1e9
    print(f"device cache: staged {train_n}+{val_n} images (~{gb:.2f} GB) "
          f"in {time.perf_counter() - t0:.1f}s")

    log_path = get_log_path(args.backbone, args.log_dir)
    run = TrainRun(state, 0, [], {}, 0, model_path, None)
    total_images = 0
    train_start = None
    with MetricsLogger(log_path) as log:
        start_epoch = state.step // steps_per_epoch
        for epoch in range(start_epoch, args.epochs):
            rows = torch.from_numpy(epoch_indices(
                args.seed, epoch, train_n, steps_per_epoch,
                args.batch_size)).to(dev)
            epoch_metrics = []
            for step_in_epoch in range(steps_per_epoch):
                metrics = train_step(state, train_data, rows[step_in_epoch])
                run.steps_run += 1
                if step_in_epoch % args.log_every == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    epoch_metrics.append(m)
                    print(f"epoch {epoch} step {step_in_epoch}/"
                          f"{steps_per_epoch} loss={m['loss']:.4f} "
                          f"loc={m['loc_loss']:.4f} "
                          f"conf={m['conf_loss']:.4f}")
                    log.log(state.step, m, prefix="train/")
            run.train_metrics.extend(epoch_metrics)
            if train_start is not None:
                total_images += steps_per_epoch * args.batch_size

            last_epoch = epoch == args.epochs - 1
            if (epoch + 1) % args.val_every == 0 or last_epoch:
                n_batches = val_data["image"].shape[0] // args.batch_size
                if args.val_limit is not None:
                    n_batches = min(n_batches, args.val_limit)
                idx = torch.arange(n_batches * args.batch_size,
                                   device=dev).reshape(n_batches,
                                                       args.batch_size)
                losses = eval_step(state, val_data, idx)["loss"].tolist()
                run.val_batches += n_batches
                # padded rows add zero loss: weight by the real rows
                val_count = sum(
                    max(0, min(val_n - vb * args.batch_size,
                               args.batch_size))
                    for vb in range(n_batches))
                val_loss = (sum(x * args.batch_size for x in losses)
                            / val_count if val_count else float("inf"))
                run.val_losses[epoch] = val_loss
                tr = (float(np.mean([m["loss"] for m in epoch_metrics]))
                      if epoch_metrics else float("nan"))
                print(f"epoch {epoch}: train_loss={tr:.4f} "
                      f"val_loss={val_loss:.4f} "
                      f"lr={schedule(state.step):.2e}")
                log.log(state.step, {"val_loss": val_loss, "epoch": epoch})
                if (epoch + 1) % args.ckpt_every == 0 or last_epoch:
                    ckpt.save(state.step, state, val_loss=val_loss)
            # The end-to-end clock starts after the first epoch (train,
            # validation and checkpoint), so one-time set-up (cuDNN plans,
            # the kernel build) stays out of it.
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            if train_start is None:
                train_start = time.perf_counter()

    if train_start is not None and total_images:
        run.e2e_img_per_s = total_images / (time.perf_counter()
                                            - train_start)
        short = _SHORT.get(args.backbone, args.backbone)
        print(json.dumps({
            "metric": f"train_{short}_e2e_images_per_sec",
            "value": round(run.e2e_img_per_s, 2), "unit": "images/sec",
            "config": f"tfssd_torch.trainer end-to-end, batch "
                      f"{args.batch_size}, val-every {args.val_every}, "
                      f"device-cached data, incl. validation + "
                      f"checkpointing (after the first epoch), "
                      f"{cfg.compute_dtype}"
                      + (", remat" if cfg.remat else "")
                      + f", device={dev.type}"}))
    return run


if __name__ == "__main__":
    main()
