"""Multi-level RoIAlign: the CUDA kernel, its plain version, dispatch.

Mask R-CNN's RoI pooling (models/maskrcnn.py): each image's K boxes, each
read from its own level of the feature pyramid, pooled to P x P bins of
S x S samples (torchvision's roi_align forward with aligned=False, as its
MultiScaleRoIAlign calls it). For box r of image b, at level l with map
(C, H, W) and scale s, bin (ph, pw):

  start = box * s; extent = max(end - start, 1) a side; bin = extent / P
  sample (iy, ix) at y = start_y + ph * bin_h + (iy + 0.5) * bin_h / S
  (x likewise), read by bilinear interpolation: a sample with y < -1,
  y > H, x < -1 or x > W reads 0; y <= 0 is taken as 0; a sample in the
  last row or column reads that row or column;
  out[b, r, c, ph, pw] = (sum of the S x S samples, in row order) / S^2.

The JAX package has no Mask R-CNN, so no TPU kernel stands behind this
one, and PyTorch has no op that computes it (torchvision's is not part of
PyTorch); written out in plain torch, a request's 8,000 boxes x 256
channels x 49 bins x 4 samples x 4 corners is a 6.4 GB intermediate.

The kernel (csrc/roi_align.cu) is one launch for all of a call's boxes:
a block per box computes its samples' four corners and weights once, in
shared memory, then walks the box's C x P x P outputs. The plain version
computes the same operations in the same order a chunk of boxes at a time
(CHUNK_OUTPUTS), so that its intermediate stays small. Every sample
position and weight is one IEEE operation after another in torchvision's
order (no multiply-add contraction: the build passes -fmad=false), so the
two agree bit for bit (chip_smoke.py holds them on the card).

`roi_align` is the custom operator `tfssd::roi_align`, made as
ops/kernels/nms_keep.py makes `tfssd::nms_keep`: its CPU implementation
is the plain version, its CUDA implementation the kernel, which raises if
it cannot run and never falls back, and a fake implementation gives the
output's shape for tracing. A level outside [0, L) is clamped into it.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

# Levels the kernel takes (csrc/roi_align.cu: kMaxLevels).
MAX_LEVELS = 8
# Samples of a box the kernel keeps in shared memory: P * P * S * S
# (csrc/roi_align.cu: kMaxSamples), 14 x 14 bins of 2 x 2.
MAX_SAMPLES = 784
# Elements of one corner's gather the plain version makes at once.
CHUNK_OUTPUTS = 1 << 24

# Launches of the CUDA kernel in this process; incremented only where the
# kernel is launched.
LAUNCHES = 0

_FN = None


def _launch_fn():
    global _FN
    if _FN is None:
        from tfssd_torch.ops.kernels.build import load_library

        fn = load_library("roi_align").roi_align_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(features: Sequence[torch.Tensor], boxes: torch.Tensor,
           levels: torch.Tensor, scales: Sequence[float], output_size: int,
           sampling_ratio: int) -> None:
    if not 0 < len(features) <= MAX_LEVELS:
        raise ValueError(f"1 to {MAX_LEVELS} levels, got {len(features)}")
    if len(scales) != len(features):
        raise ValueError(f"{len(scales)} scales for {len(features)} levels")
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, K, 4), got {tuple(boxes.shape)}")
    if levels.shape != boxes.shape[:2]:
        raise ValueError(f"levels {tuple(levels.shape)} do not match boxes "
                         f"{tuple(boxes.shape)}")
    if levels.dtype != torch.int64:
        raise TypeError("levels must be int64")
    b = boxes.shape[0]
    for f in features:
        if f.dim() != 4 or f.shape[0] != b or f.shape[1] != features[0].shape[
                1]:
            raise ValueError(f"each level must be (B, C, H, W) with B = {b} "
                             f"and one C, got {tuple(f.shape)}")
        if f.dtype != boxes.dtype:
            raise TypeError("the levels and the boxes must share a dtype")
    if output_size < 1 or sampling_ratio < 1:
        raise ValueError("output_size and sampling_ratio must be positive")
    if len({t.device for t in (*features, boxes, levels)}) != 1:
        raise ValueError("the levels, boxes and levels' indices are on "
                         "different devices")


def roi_align_cuda(features: List[torch.Tensor], boxes: torch.Tensor,
                   levels: torch.Tensor, scales: List[float],
                   output_size: int, sampling_ratio: int) -> torch.Tensor:
    """L levels (B, C, H_l, W_l) f32, (B, K, 4) f32 pixel boxes [x0, y0,
    x1, y1] and their (B, K) int64 levels on a CUDA device -> (B, K, C, P,
    P) f32, by the hand-written kernel, one launch."""
    global LAUNCHES
    _check(features, boxes, levels, scales, output_size, sampling_ratio)
    device = boxes.device
    if device.type != "cuda":
        raise ValueError("roi_align_cuda needs CUDA tensors")
    if boxes.dtype != torch.float32:
        raise TypeError("roi_align_cuda takes float32")
    p, s = output_size, sampling_ratio
    if p * p * s * s > MAX_SAMPLES:
        raise ValueError(f"roi_align_cuda takes P * P * S * S <= "
                         f"{MAX_SAMPLES}, got {p * p * s * s}")
    if not all(t.is_contiguous() for t in (*features, boxes, levels)):
        raise ValueError("the levels, boxes and levels' indices must be "
                         "contiguous")
    b, k, _ = boxes.shape
    c = features[0].shape[1]
    out = torch.empty((b, k, c, p, p), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    n = len(features)
    ptrs = (ctypes.c_void_p * n)(*[f.data_ptr() for f in features])
    heights = (ctypes.c_int * n)(*[f.shape[2] for f in features])
    widths = (ctypes.c_int * n)(*[f.shape[3] for f in features])
    scale = (ctypes.c_float * n)(*[float(x) for x in scales])
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    err = _launch_fn()(ptrs, heights, widths, scale, n, boxes.data_ptr(),
                       levels.data_ptr(), out.data_ptr(), b, k, c, p, s,
                       device.index, stream)
    if err != 0:
        raise RuntimeError(f"roi_align kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def _axis(start: torch.Tensor, end: torch.Tensor, p: int, s: int,
          size: int):
    """One axis of a chunk's samples: (R, P, S) low and high indices and
    their weights (1 - l, l), zero where the sample lies outside; start and
    end (R,) in the level's pixels."""
    # divisors as tensors on the device: CUDA divides by a Python number
    # through its reciprocal, which rounds differently from the kernel's
    # (and the CPU's) division
    bins, grid = (start.new_full((), float(n)) for n in (p, s))
    extent = torch.clamp_min(end - start, 1.0)
    bin_ = extent / bins
    cell = torch.arange(p, dtype=start.dtype, device=start.device)
    half = torch.arange(s, dtype=start.dtype, device=start.device) + 0.5
    at = (start[:, None, None] + cell[None, :, None] * bin_[:, None, None]
          ) + (half[None, None, :] * bin_[:, None, None]) / grid
    outside = (at < -1.0) | (at > size)
    at = torch.clamp_min(at, 0.0)
    low = at.to(torch.int64)
    last = low >= size - 1
    low = torch.where(last, size - 1, low)
    high = torch.where(last, size - 1, low + 1)
    at = torch.where(last, low.to(at.dtype), at)
    frac = at - low.to(at.dtype)
    zero = torch.zeros((), dtype=at.dtype, device=at.device)
    return (torch.where(outside, 0, low), torch.where(outside, 0, high),
            torch.where(outside, zero, 1.0 - frac),
            torch.where(outside, zero, frac), outside)


def _pool(feature: torch.Tensor, boxes: torch.Tensor, scale: float, p: int,
          s: int) -> torch.Tensor:
    """One level's (C, H, W) map and (R, 4) boxes of one image -> (R, C, P,
    P), torchvision's order of operations."""
    c, h, w = feature.shape
    sc = torch.tensor(scale, dtype=boxes.dtype)
    y_lo, y_hi, hy, ly, y_out = _axis(boxes[:, 1] * sc, boxes[:, 3] * sc, p,
                                      s, h)
    x_lo, x_hi, hx, lx, x_out = _axis(boxes[:, 0] * sc, boxes[:, 2] * sc, p,
                                      s, w)
    r = boxes.shape[0]
    # (R, P, S, P, S): y-part of (r, ph, iy), x-part of (r, pw, ix); a
    # sample outside on either axis has all four weights and indices 0
    out_ = y_out[:, :, :, None, None] | x_out[:, None, None, :, :]
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)

    def grid(a, b_):
        return a[:, :, :, None, None], b_[:, None, None, :, :]

    flat = feature.reshape(c, h * w)
    acc_terms = None
    for (ya, wy), (xa, wx) in (((y_lo, hy), (x_lo, hx)),
                               ((y_lo, hy), (x_hi, lx)),
                               ((y_hi, ly), (x_lo, hx)),
                               ((y_hi, ly), (x_hi, lx))):
        yi, xi = grid(ya, xa)
        wyy, wxx = grid(wy, wx)
        pos = torch.where(out_, 0, yi * w + xi)
        weight = torch.where(out_, zero, wyy * wxx)
        v = flat[:, pos.reshape(-1)].reshape(c, r, p, s, p, s)
        term = weight[None] * v
        acc_terms = term if acc_terms is None else acc_terms + term
    # (C, R, P, S, P, S): the samples summed in row order, then / S^2
    acc = torch.zeros_like(acc_terms[:, :, :, 0, :, 0])
    for iy in range(s):
        for ix in range(s):
            acc = acc + acc_terms[:, :, :, iy, :, ix]
    return (acc / acc.new_full((), float(s * s))).transpose(0, 1)


def roi_align_reference(features: List[torch.Tensor], boxes: torch.Tensor,
                        levels: torch.Tensor, scales: List[float],
                        output_size: int,
                        sampling_ratio: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device and in the
    inputs' dtype: per image and level, chunks of its boxes gathered at
    their samples' four corners."""
    _check(features, boxes, levels, scales, output_size, sampling_ratio)
    b, k, _ = boxes.shape
    c = features[0].shape[1]
    p, s = output_size, sampling_ratio
    out = torch.zeros((b, k, c, p, p), dtype=boxes.dtype,
                      device=boxes.device)
    lv = levels.clamp(0, len(features) - 1)
    chunk = max(1, CHUNK_OUTPUTS // (c * p * p * s * s))
    for i in range(b):
        for level, (f, scale) in enumerate(zip(features, scales)):
            idx = torch.nonzero(lv[i] == level).reshape(-1)
            for at in range(0, len(idx), chunk):
                part = idx[at:at + chunk]
                out[i, part] = _pool(f[i], boxes[i, part], scale, p, s)
    return out


_LIB = torch.library.Library("tfssd", "FRAGMENT")
_LIB.define("roi_align(Tensor[] features, Tensor boxes, Tensor levels, "
            "float[] scales, int output_size, int sampling_ratio) -> Tensor")
_LIB.impl("roi_align", roi_align_reference, "CPU")
_LIB.impl("roi_align", roi_align_cuda, "CUDA")


@torch.library.register_fake("tfssd::roi_align")
def _roi_align_fake(features, boxes, levels, scales, output_size,
                    sampling_ratio):
    _check(features, boxes, levels, scales, output_size, sampling_ratio)
    b, k, _ = boxes.shape
    return boxes.new_empty((b, k, features[0].shape[1], output_size,
                            output_size))


# (features, boxes, levels, scales, output_size, sampling_ratio) -> pooled,
# by device: the plain version for CPU tensors, the CUDA kernel for CUDA
# tensors.
roi_align = torch.ops.tfssd.roi_align.default
