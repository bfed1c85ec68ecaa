"""Where the training time goes on the card: one torch.profiler window.

    python -m tfssd_torch.profile_train [--batch-size 32] [--iters 5]

Runs the trainer's step (device-resident uint8 SyntheticDataset(seed=0)
rows -> augment -> match/encode kernel -> forward -> loss -> backward ->
Adam) on SSD300-MobileNetV2 at full width with seeded weights, and prints
per step: the wall time (host clock around synchronised work), the device
busy time (the sum of the CUDA kernels' device time in the window) and the
idle share, the device time by kind of kernel, the heaviest kernels, and
the match/encode kernel's device time per launch. Needs a card: where the
profiler records no device time it says "not measured".
"""

from __future__ import annotations

import argparse
import time
from collections import defaultdict
from typing import Optional, Sequence

import torch
from torch.profiler import ProfilerActivity, profile

from tfssd_torch import get_hyper_params, resolve_device
from tfssd_torch.data.loader import stage_arrays
from tfssd_torch.data.synthetic import SyntheticDataset
from tfssd_torch.ops.boxes import generate_anchors
from tfssd_torch.profile_serving import kind_of
from tfssd_torch.train import (create_train_state, make_cached_train_step,
                               make_lr_schedule)
from tfssd_torch.trainer import epoch_indices

# Kernel-name fragments of the training step -> kind, before the serving
# kinds (profile_serving.kind_of).
_TRAIN_KINDS = (
    ("match_encode", "match_encode (hand-written CUDA)"),
    ("batch_norm", "batch norm (fwd, bwd, running stats)"),
    ("bn_", "batch norm (fwd, bwd, running stats)"),
    ("welford", "batch norm (fwd, bwd, running stats)"),
    ("adam", "Adam (foreach)"),
    ("Adam", "Adam (foreach)"),
    ("multi_tensor", "Adam (foreach)"),
    # cuDNN's convolutions are implicit GEMMs ("..._implicit_gemm_...");
    # a plain GEMM in the step is the augmentation's resample
    ("xmma_gemm", "augment resample (matmul)"),
    ("gemv", "augment resample (matmul)"),
    ("reduce", "reductions (losses, norms, stats)"),
)


def train_kind(name: str) -> str:
    for frag, kind in _TRAIN_KINDS:
        if frag in name:
            return kind
    return kind_of(name)


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(prog="python -m tfssd_torch.profile_train")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_hyper_params("mobilenet_v2")
    host, n = stage_arrays(
        SyntheticDataset(4 * args.batch_size, image_size=cfg.img_size,
                         seed=0), cfg.max_gt_boxes)
    data = {k: torch.from_numpy(host[k]).to(device)
            for k in ("image", "boxes", "labels")}
    state = create_train_state(cfg, args.seed, device, make_lr_schedule(100))
    anchors = torch.from_numpy(generate_anchors(cfg)).to(device)
    step = make_cached_train_step(anchors, cfg, augment=True,
                                  seed=args.seed)
    steps = 3 + args.iters
    rows = torch.from_numpy(epoch_indices(
        args.seed, 0, n, steps, args.batch_size)).to(device)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    for i in range(3):
        step(state, data, rows[i])
    sync()

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i in range(3, steps):
            step(state, data, rows[i])
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.iters

    by_kind = defaultdict(float)
    kernels = []
    for evt in prof.key_averages():
        # a user annotation (Optimizer.step#..., record_function) spans
        # kernels that are counted on their own
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue
        us = evt.self_device_time_total / args.iters
        if us <= 0:
            continue
        kernels.append((us, evt.count / args.iters, evt.key))
        by_kind[train_kind(evt.key)] += us
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"profile: train step, batch {args.batch_size}, {args.iters} "
          f"steps, device={name}")
    print(f"profile: wall {wall_ms:.3f} ms per step "
          f"({args.batch_size * 1e3 / wall_ms:.1f} img/s, profiler on)")
    busy_ms = sum(by_kind.values()) / 1e3
    if busy_ms == 0:
        print("profile: device time not measured (the profiler recorded no "
              "CUDA kernel)")
        return
    print(f"profile: device busy {busy_ms:.3f} ms per step, idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f}, "
          f"{sum(c for _, c, _ in kernels):.0f} kernel launches per step")
    for kind, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"profile: kind {kind}: {us / 1e3:.3f} ms per step "
              f"({us / 1e3 / busy_ms:.3f} of busy)")
    for us, calls, key in sorted(kernels, reverse=True)[:15]:
        print(f"profile: kernel {us:9.1f} us/step {calls:6.1f} calls/step "
              f"{key[:110]}")
    match = [(us, calls) for us, calls, key in kernels
             if "match_encode" in key]
    if match:
        us, calls = match[0]
        print(f"profile: match_encode device time {us / calls:.2f} us per "
              f"launch at B={args.batch_size}, N={cfg.total_anchors}, "
              f"G={cfg.max_gt_boxes}")


if __name__ == "__main__":
    main()
