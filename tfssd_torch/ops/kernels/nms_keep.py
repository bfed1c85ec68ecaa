"""Exact greedy NMS keep mask: the CUDA kernel, its plain version, dispatch.

Replaces the JAX package's Pallas TPU kernel ops/kernels/nms_keep.py
(nms_keep_pallas, body _kernel), the suppression step of combined NMS.
Per (image, class) instance: K x K float32 IoU of the score-sorted
candidates (union clamped at 1e-8), strict upper-triangular suppression
iou > iou_threshold, valid = score > score_threshold, exact greedy keep.

What bounds it on the H100: R*K*(16+4+1) bytes are well under a
microsecond at 3.35 TB/s, and the ~R*K^2/2 IoUs of 15 float32 operations
0.7 us at R = 160 and 5.7 us at R = 1280 (K = 200) at 67 TFLOP/s. But a
compiled pair takes about 32 instructions against its 15 float operations
(the IEEE divide alone is a reciprocal, five FMAs, a range check and a
branch), so the SMs' instruction issue is the floor (csrc/nms_keep.cu
gives the count, from python -m tfssd_torch.profile_nms_keep). The kernel
gives every instance its own block: 32 x 32 tiles of the upper triangle
dealt to the block's warps, each lane building its column's suppression
word in a register; then one warp solves the greedy recurrence in 32-wide
blocks with each diagonal block's words in registers.

The launch path is lean, because once the device part takes ~10 us the
wrapper's own host time sets the time of a call: it checks its inputs,
allocates the output, and calls the library with the raw handle of the
current stream of the tensors' device; the C side switches the current
device only if it differs. It reads nothing back from the device: no
sync, no .item(), and a tensor threshold is refused rather than read.

`nms_keep` is the custom operator `tfssd::nms_keep`, defined and
implemented through torch.library.Library: its CPU implementation is the
plain version, its CUDA implementation the kernel, which raises if it
cannot run, and a fake implementation gives the output's shape for
tracing. The dispatcher picks by device, so there is no fallback from one
to the other and no Python device switch on the path; `torch.export`
records one `tfssd::nms_keep` node (the plain version's K-step loop is
never unrolled into a graph), and an exported program launches the kernel
wherever it runs on the card. The thresholds are `float` arguments of the
op's schema. The dispatcher calls the implementations directly:
torch.library.custom_op would wrap each call in its own Python layer,
which took more host time a call than the ctypes launch itself (PERF.md
§6).
"""

from __future__ import annotations

import ctypes

import torch

from tfssd_torch.ops.boxes import iou_matrix

MAX_K = 256

# Launches of the CUDA kernel in this process; incremented only where the
# kernel is launched.
LAUNCHES = 0

_FN = None


def _launch_fn():
    global _FN
    if _FN is None:
        from tfssd_torch.ops.kernels.build import load_library

        fn = load_library("nms_keep").nms_keep_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(boxes: torch.Tensor, scores: torch.Tensor) -> None:
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (R, K, 4), got {tuple(boxes.shape)}")
    if scores.shape != boxes.shape[:2]:
        raise ValueError(f"scores {tuple(scores.shape)} do not match boxes "
                         f"{tuple(boxes.shape)}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError("boxes and scores must be float32")
    if boxes.device != scores.device:
        raise ValueError("boxes and scores are on different devices")


def nms_keep_cuda(boxes: torch.Tensor, scores: torch.Tensor,
                  iou_threshold: float,
                  score_threshold: float) -> torch.Tensor:
    """(R, K, 4) f32 boxes, (R, K) f32 scores on a CUDA device ->
    (R, K) bool keep, by the hand-written kernel; K <= 256. The thresholds
    are Python numbers: a tensor would have to be read back from the
    device."""
    global LAUNCHES
    _check(boxes, scores)
    if isinstance(iou_threshold, torch.Tensor) or isinstance(
            score_threshold, torch.Tensor):
        raise TypeError("thresholds must be Python numbers, not tensors")
    device = boxes.device
    if device.type != "cuda":
        raise ValueError("nms_keep_cuda needs CUDA tensors")
    r, k, _ = boxes.shape
    if k > MAX_K:
        raise ValueError(f"nms_keep_cuda takes K <= {MAX_K}, got {k}")
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("boxes and scores must be contiguous")
    # empty_like parses fewer arguments than empty; scores is a contiguous
    # (R, K).
    keep = torch.empty_like(scores, dtype=torch.bool)
    if r == 0 or k == 0:
        return keep
    # The raw handle of the device's current stream: what
    # torch.cuda.current_stream(device).cuda_stream returns, without
    # building a Stream object on every call (PERF.md: host time).
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    err = _launch_fn()(boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(),
                       r, k, iou_threshold, score_threshold, device.index,
                       stream)
    if err != 0:
        raise RuntimeError(f"nms_keep kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return keep


def nms_keep_reference(boxes: torch.Tensor, scores: torch.Tensor,
                       iou_threshold: float,
                       score_threshold: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: vectorised IoU,
    then the textbook K-step greedy sweep."""
    _check(boxes, scores)
    r, k, _ = boxes.shape
    # Thresholds as float32 tensors: every comparison happens in float32,
    # as in the kernel and the JAX reference.
    iou_t = torch.tensor(iou_threshold, dtype=torch.float32,
                         device=boxes.device)
    score_t = torch.tensor(score_threshold, dtype=torch.float32,
                           device=boxes.device)
    idx = torch.arange(k, device=boxes.device)
    later = idx[:, None] < idx[None, :]
    # iou_matrix computes in the Pallas kernel's operation order, one
    # elementwise op at a time (no multiply-add contraction).
    suppress = (iou_matrix(boxes, boxes) > iou_t) & later
    keep = scores > score_t
    for i in range(k):
        keep = keep & ~(keep[:, i:i + 1] & suppress[:, i, :])
    return keep


_LIB = torch.library.Library("tfssd", "FRAGMENT")
_LIB.define("nms_keep(Tensor boxes, Tensor scores, float iou_threshold, "
            "float score_threshold) -> Tensor")
_LIB.impl("nms_keep", nms_keep_reference, "CPU")
_LIB.impl("nms_keep", nms_keep_cuda, "CUDA")


@torch.library.register_fake("tfssd::nms_keep")
def _nms_keep_fake(boxes, scores, iou_threshold, score_threshold):
    _check(boxes, scores)
    return torch.empty_like(scores, dtype=torch.bool)


# (boxes, scores, iou_threshold, score_threshold) -> keep, by device: the
# plain version for CPU tensors, the CUDA kernel for CUDA tensors.
nms_keep = torch.ops.tfssd.nms_keep.default
