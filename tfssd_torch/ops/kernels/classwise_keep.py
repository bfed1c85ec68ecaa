"""Class-wise exact greedy NMS keep: the CUDA kernel, its plain version,
dispatch.

RetinaNet's keep (ops/nms.py:classwise_nms): each image's T candidates,
ordered class by class and by score within a class, and for each (image,
class) the count and the start of its segment; per class, greedy NMS at
IoU > iou_threshold among the candidates scoring above score_threshold,
however the T candidates fall over the classes. The JAX package has no
RetinaNet, so no TPU kernel stands behind this one.

The kernel (csrc/classwise_keep.cu) is one launch of a block per (image,
class) that walks its class's candidates in rows of up to ROW, each row
judged after the boxes its class kept in earlier rows. Its source says
what bounds it: a class that holds most of the candidates is one SM's
walk. The plain version is classwise_nms's first design: ceil(T / K)
static passes of K = min(ROW, T) candidates a class, each marking invalid
the candidates that an earlier row's kept one overlaps and running
nms_keep's plain version on the rows. Both give exact greedy NMS, so they
agree bit for bit (chip_smoke.py holds them on the card).

`max_count` is a static bound on any class's count (0: T), which the
caller knows from how it made the candidates: Mask R-CNN's box stage has
T = 90,000 pairs an image but at most one a proposal in a class, 1,000.
The kernel's kept list is then sized by it and not by T, and the plain
version walks ceil(max_count / K) passes; a class holding more is judged
on its first max_count candidates in both.

`classwise_keep` is the custom operator `tfssd::classwise_keep`, made as
ops/kernels/nms_keep.py makes `tfssd::nms_keep`: its CPU implementation
is the plain version, its CUDA implementation the kernel, which raises if
it cannot run and never falls back, and a fake implementation gives the
output's shape for tracing. The thresholds are `float` arguments; the
wrapper reads nothing back from the device.
"""

from __future__ import annotations

import ctypes

import torch

from tfssd_torch.ops.boxes import iou_matrix
from tfssd_torch.ops.kernels.nms_keep import nms_keep_reference

# Candidates of a row of the kernel's walk.
ROW = 256
# Candidates of a class the kernel takes (T, or max_count where given):
# its list of kept boxes lives in shared memory (csrc/classwise_keep.cu:
# kMaxT).
MAX_T = 12288

# Launches of the CUDA kernel in this process; incremented only where the
# kernel is launched.
LAUNCHES = 0

_FN = None


def _launch_fn():
    global _FN
    if _FN is None:
        from tfssd_torch.ops.kernels.build import load_library

        fn = load_library("classwise_keep").classwise_keep_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_float, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(boxes: torch.Tensor, scores: torch.Tensor, counts: torch.Tensor,
           starts: torch.Tensor) -> None:
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, T, 4), got {tuple(boxes.shape)}")
    if scores.shape != boxes.shape[:2]:
        raise ValueError(f"scores {tuple(scores.shape)} do not match boxes "
                         f"{tuple(boxes.shape)}")
    if counts.dim() != 2 or counts.shape[0] != boxes.shape[0] or \
            starts.shape != counts.shape:
        raise ValueError(f"counts {tuple(counts.shape)} and starts "
                         f"{tuple(starts.shape)} must be (B, C) with B = "
                         f"{boxes.shape[0]}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError("boxes and scores must be float32")
    if counts.dtype != torch.int64 or starts.dtype != torch.int64:
        raise TypeError("counts and starts must be int64")
    if len({t.device for t in (boxes, scores, counts, starts)}) != 1:
        raise ValueError("boxes, scores, counts and starts are on different "
                         "devices")


def _bound(t: int, max_count: int) -> int:
    """The largest class the walk takes: max_count where given, else T."""
    if max_count < 0:
        raise ValueError(f"max_count must be >= 0, got {max_count}")
    return min(t, max_count) if max_count else t


def classwise_keep_cuda(boxes: torch.Tensor, scores: torch.Tensor,
                        counts: torch.Tensor, starts: torch.Tensor,
                        iou_threshold: float, score_threshold: float,
                        max_count: int = 0) -> torch.Tensor:
    """(B, T, 4) f32 boxes and (B, T) f32 scores ordered class by class,
    (B, C) int64 counts and starts of the classes' segments, on a CUDA
    device -> (B, T) bool keep, by the hand-written kernel; the largest
    class (max_count, else T) <= MAX_T. The thresholds are Python numbers:
    a tensor would have to be read back from the device."""
    global LAUNCHES
    _check(boxes, scores, counts, starts)
    if isinstance(iou_threshold, torch.Tensor) or isinstance(
            score_threshold, torch.Tensor):
        raise TypeError("thresholds must be Python numbers, not tensors")
    device = boxes.device
    if device.type != "cuda":
        raise ValueError("classwise_keep_cuda needs CUDA tensors")
    b, t, _ = boxes.shape
    c = counts.shape[1]
    bound = _bound(t, max_count)
    if bound > MAX_T:
        raise ValueError(f"classwise_keep_cuda takes classes of at most "
                         f"{MAX_T} candidates, got a bound of {bound}")
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("boxes and scores must be contiguous")
    # counts and starts may be column slices of wider tables (the sink
    # column of classwise_nms's ordering left out): one row stride, unit
    # column stride.
    stride = counts.stride(0) if b > 1 else c
    if c > 1 and (counts.stride(1) != 1 or starts.stride(1) != 1):
        raise ValueError("counts and starts need unit column stride")
    if b > 1 and (starts.stride(0) != stride or stride < c):
        raise ValueError("counts and starts need one row stride of at "
                         "least C")
    keep = torch.zeros_like(scores, dtype=torch.bool)
    if b == 0 or t == 0 or c == 0:
        return keep
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    err = _launch_fn()(boxes.data_ptr(), scores.data_ptr(), counts.data_ptr(),
                       starts.data_ptr(), stride, keep.data_ptr(), b, t, c,
                       iou_threshold, score_threshold, bound, device.index,
                       stream)
    if err != 0:
        raise RuntimeError(f"classwise_keep kernel launch failed: cudaError "
                           f"{err}")
    LAUNCHES += 1
    return keep


def classwise_keep_reference(boxes: torch.Tensor, scores: torch.Tensor,
                             counts: torch.Tensor, starts: torch.Tensor,
                             iou_threshold: float, score_threshold: float,
                             max_count: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: the candidates
    cut into rows of K = min(ROW, T) a class, row q of a class holding its
    candidates q*K .. q*K + K - 1. Pass 0 runs every class's first row
    through the plain nms_keep; pass q > 0 runs the q-th rows of the
    T // (q*K) fullest classes (no more can have one), after marking
    invalid each candidate that a kept one of its class's earlier rows
    overlaps beyond the threshold. So each row's keep is the greedy keep
    given every earlier decision of its class, in ceil(M / K) passes, M
    the largest class (max_count, else T)."""
    _check(boxes, scores, counts, starts)
    b, t = scores.shape
    c, dev = counts.shape[1], scores.device
    if t == 0:
        return torch.zeros_like(scores, dtype=torch.bool)
    bound = _bound(t, max_count)
    counts = torch.clamp_max(counts, bound)
    neg = torch.tensor(float("-inf"), dtype=scores.dtype, device=dev)
    k = min(ROW, t)
    # column t is a sink for the rows' empty slots
    sb = torch.nn.functional.pad(boxes, (0, 0, 0, 1))
    ss = torch.nn.functional.pad(scores, (0, 1), value=float("-inf"))
    keep = torch.zeros(b, t + 1, dtype=torch.bool, device=dev)
    slots = torch.arange(k, device=dev)
    for q in range(-(-bound // k)):
        if q == 0:
            rows = torch.arange(c, device=dev).expand(b, c)
        else:
            rows = torch.topk(counts, min(c, t // (k * q)), dim=1).indices
        m = rows.shape[1]
        n = torch.gather(counts, 1, rows)[..., None]
        first = torch.gather(starts, 1, rows)[..., None]
        pos = torch.where(q * k + slots < n, first + q * k + slots, t)
        pos = pos.reshape(b, m * k)
        row_boxes = torch.gather(
            sb, 1, pos[..., None].expand(-1, -1, 4)).reshape(b, m, k, 4)
        row_scores = torch.gather(ss, 1, pos).reshape(b, m, k)
        if q:
            # a row of a class with fewer candidates is all sink, and its
            # earlier positions (another class's) change nothing
            prior = torch.clamp_max(
                first + torch.arange(q * k, device=dev), t).reshape(
                    b, m * q * k)
            prior_boxes = torch.gather(
                sb, 1, prior[..., None].expand(-1, -1, 4)).reshape(
                    b, m, q * k, 4)
            hit = (iou_matrix(row_boxes, prior_boxes) > iou_threshold) & \
                torch.gather(keep, 1, prior).reshape(b, m, 1, q * k)
            row_scores = torch.where(hit.any(dim=-1), neg, row_scores)
        kept = nms_keep_reference(row_boxes.reshape(b * m, k, 4).contiguous(),
                                  row_scores.reshape(b * m, k).contiguous(),
                                  iou_threshold, score_threshold)
        keep.scatter_(1, pos, kept.reshape(b, m * k))
    return keep[:, :t].contiguous()


_LIB = torch.library.Library("tfssd", "FRAGMENT")
_LIB.define("classwise_keep(Tensor boxes, Tensor scores, Tensor counts, "
            "Tensor starts, float iou_threshold, float score_threshold, "
            "int max_count=0) -> Tensor")
_LIB.impl("classwise_keep", classwise_keep_reference, "CPU")
_LIB.impl("classwise_keep", classwise_keep_cuda, "CUDA")


@torch.library.register_fake("tfssd::classwise_keep")
def _classwise_keep_fake(boxes, scores, counts, starts, iou_threshold,
                         score_threshold, max_count=0):
    _check(boxes, scores, counts, starts)
    _bound(scores.shape[1], max_count)
    return torch.empty_like(scores, dtype=torch.bool)


# (boxes, scores, counts, starts, iou_threshold, score_threshold[,
# max_count]) -> keep,
# by device: the plain version for CPU tensors, the CUDA kernel for CUDA
# tensors.
classwise_keep = torch.ops.tfssd.classwise_keep.default
