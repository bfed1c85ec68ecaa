"""Where the serving time goes on the card: two torch.profiler windows.

    python -m tfssd_torch.profile_serving [--backbone vgg16] \
        [--batch-size 64] [--iters 10] [--bf16]

Serves a configuration (SSD300-MobileNetV2 unless --backbone says
otherwise: vgg16 is SSD300-VGG16, vgg16_512 SSD512-VGG16) at full width
with seeded weights, BatchNorm folded, in float32 or (--bf16) in
bfloat16, on device-resident uint8 synthetic images (uint8 -> NMSResult, as
chip_smoke.py times it) and prints, per batch: the wall time (host clock
around synchronised work), the device busy time (the sum of the CUDA
kernels' device time in the window) and the idle share, the device time by
kind of kernel, the heaviest kernels, the NMS keep kernel's device time
per launch, and from a second, shorter window that records shapes (so
that its overhead stays out of the first) the convolutions by input and
weight shape with their device time and the kernels cuDNN ran for each.
Needs a card: where the profiler records no device time it says "not
measured".
"""

from __future__ import annotations

import argparse
import time
from collections import defaultdict
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from tfssd_torch import predict
from tfssd_torch.data.synthetic import SyntheticDataset
from tfssd_torch.models.decoder import make_predict_fn
from tfssd_torch.utils.io import VALID_BACKBONES

# Batches in the shape-recording window.
_SHAPE_ITERS = 2

# Kernel-name fragments -> kind, first match wins.
_KINDS = (
    ("nms_keep", "nms_keep (hand-written CUDA)"),
    # cuDNN's FFT convolution engine (DSE::*fft*, the complex products)
    ("fft", "convolution (cuDNN)"),
    ("complex", "convolution (cuDNN)"),
    ("sort", "sort (prefilter, per-class top-K, merge)"),
    ("Sort", "sort (prefilter, per-class top-K, merge)"),
    ("conv", "convolution (cuDNN)"),
    ("xmma", "convolution (cuDNN)"),
    ("gemm", "convolution (cuDNN)"),
    ("cudnn", "convolution (cuDNN)"),
    ("winograd", "convolution (cuDNN)"),
    ("gather", "gather / index"),
    ("index", "gather / index"),
    ("softmax", "softmax"),
)


def kind_of(name: str) -> str:
    for frag, kind in _KINDS:
        if frag in name:
            return kind
    return "elementwise / other"


def conv_shapes(prof, iters: int, per: str, top: int = 8) -> List[str]:
    """The `top` convolutions of a window that recorded shapes, by device
    time: one line per pass (forward, or the backward's data and weight
    gradients) and input x weight shape, with the kernels cuDNN ran for it
    (the algorithm it picked) and each kernel's share."""
    rows = defaultdict(lambda: defaultdict(float))
    for evt in prof.events():
        if evt.name == "aten::convolution":
            key = ("forward", str(evt.input_shapes[:2]))
        elif evt.name == "aten::convolution_backward":
            key = ("backward", str(evt.input_shapes[1:3]))
        else:
            continue
        stack = [evt]
        while stack:
            e = stack.pop()
            for k in e.kernels:
                rows[key][k.name] += k.duration / iters
            stack.extend(e.cpu_children)
    ranked = sorted(rows.items(), key=lambda kv: -sum(kv[1].values()))
    lines = []
    for (kind, shapes), kernels in ranked[:top]:
        us = sum(kernels.values())
        names = "; ".join(
            f"{name[:90]} {t / us:.2f}" for name, t in
            sorted(kernels.items(), key=lambda kv: -kv[1])[:3])
        lines.append(f"conv {kind} {us:9.1f} us/{per} input x weight "
                     f"{shapes}: {names}")
    return lines


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(prog="python -m tfssd_torch.profile_serving")
    p.add_argument("--backbone", default="mobilenet_v2",
                   choices=VALID_BACKBONES)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 backbone and heads (SSDConfig."
                        "compute_dtype), float32 parameters")
    args = p.parse_args(argv)

    cfg, model = predict.load_model(
        args.backbone, None, args.seed, args.device,
        compute_dtype="bfloat16" if args.bf16 else "float32")
    device = next(model.parameters()).device
    dataset = SyntheticDataset(predict.SYNTHETIC_EVAL_SIZE,
                               image_size=cfg.img_size,
                               seed=predict.SYNTHETIC_EVAL_SEED)
    images = np.stack([dataset.example(i % len(dataset))["image"]
                       for i in range(args.batch_size)])
    x = torch.from_numpy(images).to(device)
    predict_fn = make_predict_fn(model, predict.generate_anchors(cfg), cfg)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    for _ in range(3):
        predict_fn(x)
    sync()

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            predict_fn(x)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.iters

    by_kind = defaultdict(float)
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.self_device_time_total / args.iters
        if us <= 0:
            continue
        kernels.append((us, evt.count / args.iters, evt.key))
        by_kind[kind_of(evt.key)] += us
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"profile: {args.backbone}, batch {args.batch_size}, {args.iters} "
          f"iterations, {cfg.compute_dtype}, "
          f"cudnn.benchmark={torch.backends.cudnn.benchmark}, "
          f"device={name}")
    print(f"profile: wall {wall_ms:.3f} ms per batch "
          f"({args.batch_size * 1e3 / wall_ms:.1f} img/s, profiler on)")
    busy_ms = sum(by_kind.values()) / 1e3
    if busy_ms == 0:
        print("profile: device time not measured (the profiler recorded no "
              "CUDA kernel)")
        return
    print(f"profile: device busy {busy_ms:.3f} ms per batch, idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f}")
    for kind, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"profile: kind {kind}: {us / 1e3:.3f} ms per batch "
              f"({us / 1e3 / busy_ms:.3f} of busy)")
    for us, calls, key in sorted(kernels, reverse=True)[:12]:
        print(f"profile: kernel {us:9.1f} us/batch {calls:6.1f} calls/batch "
              f"{key[:110]}")
    keep = [(us, calls) for us, calls, key in kernels if "nms_keep" in key]
    if keep:
        us, calls = keep[0]
        print(f"profile: nms_keep device time {us / calls:.2f} us per launch "
              f"at R={args.batch_size * (cfg.total_labels - 1)}, "
              f"K={cfg.max_detections_per_class}")

    with profile(activities=activities, record_shapes=True) as prof:
        for _ in range(_SHAPE_ITERS):
            predict_fn(x)
        sync()
    for line in conv_shapes(prof, _SHAPE_ITERS, "batch"):
        print(f"profile: {line}")


if __name__ == "__main__":
    main()
