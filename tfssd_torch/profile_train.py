"""Where the training time goes on the card: two torch.profiler windows.

    python -m tfssd_torch.profile_train [--backbone vgg16] \
        [--batch-size 32] [--iters 5] [--bf16] [--remat]

Runs the trainer's step (device-resident uint8 SyntheticDataset(seed=0)
rows -> augment -> match/encode kernel -> forward -> loss -> backward ->
Adam) on a configuration at full width with seeded weights
(SSD300-MobileNetV2 unless --backbone says otherwise: vgg16 is
SSD300-VGG16, vgg16_512 SSD512-VGG16), in float32 unless --bf16 (and
--remat) say otherwise, and prints per step: the wall time
(host clock around synchronised work), the device busy time (the sum of
the CUDA kernels' device time in the window) and the idle share, the
device time by kind of kernel, the heaviest kernels, the match/encode
kernel's device time per launch and the peak device memory; then, from a
second, shorter window that records shapes (so that its overhead stays
out of the first), the convolutions' forward and backward passes by input
and weight shape with the kernels cuDNN ran for each. Needs a card: where
the profiler records no device time it says "not measured".
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
from tfssd_torch.profile_serving import conv_shapes, kind_of
from tfssd_torch.train import (create_train_state, make_cached_train_step,
                               make_lr_schedule)
from tfssd_torch.trainer import epoch_indices
from tfssd_torch.utils.io import VALID_BACKBONES

# Steps in the shape-recording window.
_SHAPE_ITERS = 2

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
    ("reduce", "reductions (losses, norms, stats)"),
)


# Ops whose kernels take the op's kind, whatever their names: cuDNN runs
# some convolutions as FFTs and GEMMs, which would read as a matmul by
# name, and the augmentation's resample is the step's only matmul.
_OP_KINDS = {
    "aten::convolution": "convolution (cuDNN)",
    "aten::convolution_backward": "convolution (cuDNN)",
    "aten::matmul": "augment resample (matmul)",
    "aten::mm": "augment resample (matmul)",
    "aten::bmm": "augment resample (matmul)",
}


def train_kind(name: str) -> str:
    for frag, kind in _TRAIN_KINDS:
        if frag in name:
            return kind
    return kind_of(name)


def device_us_by_kind(prof, iters: int, kernels) -> dict:
    """Device us per step by kind: a kernel launched under an op of
    _OP_KINDS takes the nearest such op's kind; every other kernel, and
    the time of `kernels` ((us per step, calls, name) of the window) that
    no op launched (the hand-written kernels, launched through ctypes),
    goes by its name (train_kind)."""
    by_kind, linked = defaultdict(float), defaultdict(float)
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CPU:
            continue
        op = evt
        while op is not None and op.name not in _OP_KINDS:
            op = op.cpu_parent
        for k in evt.kernels:
            kind = _OP_KINDS[op.name] if op is not None else train_kind(
                k.name)
            by_kind[kind] += k.duration / iters
            linked[k.name] += k.duration / iters
    for us, _, name in kernels:
        if us > linked[name]:
            by_kind[train_kind(name)] += us - linked[name]
    return by_kind


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(prog="python -m tfssd_torch.profile_train")
    p.add_argument("--backbone", default="mobilenet_v2",
                   choices=VALID_BACKBONES)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 backbone and heads (SSDConfig."
                        "compute_dtype), float32 parameters")
    p.add_argument("--remat", action="store_true",
                   help="recompute the backbone's activations in the "
                        "backward")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_hyper_params(
        args.backbone, compute_dtype="bfloat16" if args.bf16 else "float32",
        remat=args.remat)
    host, n = stage_arrays(
        SyntheticDataset(4 * args.batch_size, image_size=cfg.img_size,
                         seed=0), cfg.max_gt_boxes)
    data = {k: torch.from_numpy(host[k]).to(device)
            for k in ("image", "boxes", "labels")}
    state = create_train_state(cfg, args.seed, device, make_lr_schedule(100))
    anchors = torch.from_numpy(generate_anchors(cfg)).to(device)
    step = make_cached_train_step(anchors, cfg, augment=True,
                                  seed=args.seed)
    steps = 3 + args.iters + _SHAPE_ITERS
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
        for i in range(3, 3 + args.iters):
            step(state, data, rows[i])
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.iters

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
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"profile: {args.backbone} train step, batch {args.batch_size}, "
          f"{args.iters} steps, {cfg.compute_dtype}"
          f"{', remat' if cfg.remat else ''}, cudnn.benchmark="
          f"{torch.backends.cudnn.benchmark}, device={name}")
    print(f"profile: wall {wall_ms:.3f} ms per step "
          f"({args.batch_size * 1e3 / wall_ms:.1f} img/s, profiler on)")
    busy_ms = sum(us for us, _, _ in kernels) / 1e3
    by_kind = device_us_by_kind(prof, args.iters, kernels)
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
    print(f"profile: peak device memory "
          f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB "
          f"(max_memory_allocated: staged data, model, Adam and a step)")

    with profile(activities=activities, record_shapes=True) as prof:
        for i in range(3 + args.iters, steps):
            step(state, data, rows[i])
        sync()
    for line in conv_shapes(prof, _SHAPE_ITERS, "step", top=12):
        print(f"profile: {line}")


if __name__ == "__main__":
    main()
