"""Anchor matching + target encoding: the CUDA kernel, its plain version,
dispatch.

Replaces the JAX package's Pallas TPU kernel ops/kernels/match_encode.py
(match_encode_pallas, body _kernel, force-match post-pass
_force_match_single, wrapper match_batch_pallas), the matcher of every
train and eval step. Per (image, anchor): IoU against the image's G gts
(padded gts masked), max and first-index argmax, positive = best >
iou_threshold, the matched box encoded as centre-form deltas / variances,
the matched label; negatives zeroed.

What bounds it on the H100: the bytes. An image has a few real gts
among its G padded rows, so the pairs the function needs take well under a
microsecond of float operations, while its outputs alone are B*N*20 bytes
(15.7 MB at B = 32, N = 24,564: 4.7 us at 3.35 TB/s). The kernel
(csrc/match_encode.cu) runs one thread per (image, anchor); each block
compacts its image's real gts into shared memory in their original order
and scans only those, so neither the (B, N, G) IoU nor the padded rows
cost anything.

The launch path is lean, as nms_keep's: it checks its inputs, allocates
the outputs, and calls the library with the raw handle of the current
stream of the tensors' device; the C side switches the current device only
if it differs. It reads nothing back from the device.

The custom operator `tfssd::match_encode` (defined and implemented
through torch.library.Library, as nms_keep.py says why) dispatches by
device: its CPU implementation is the plain version (ops/matching.py), its
CUDA implementation the kernel, which raises if it cannot run, and a fake
implementation gives the outputs' shapes for tracing. There is no fallback
from one to the other and no Python device switch on the path. The
force-match step (config.force_match_for_gt, a `bool` of the op's schema)
is a plain PyTorch post-pass after the kernel, as in the JAX package; the
plain version folds it into its own matching.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from tfssd_torch.config import SSDConfig
from tfssd_torch.ops import matching

MAX_G = 256

# Launches of the CUDA kernel in this process; incremented only where the
# kernel is launched.
LAUNCHES = 0

_FN = None


def _launch_fn():
    global _FN
    if _FN is None:
        from tfssd_torch.ops.kernels.build import load_library

        fn = load_library("match_encode").match_encode_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_float] * 5 + [ctypes.c_int,
                                                 ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(anchors: torch.Tensor, gt_boxes: torch.Tensor,
           gt_labels: torch.Tensor) -> torch.device:
    """Raise unless the inputs are (N, 4) f32, (B, G, 4) f32 and (B, G)
    int32 on one device; return that device (each attribute is read once:
    the kernel's wrapper pays for every read in its host time)."""
    sa, sb, sl = anchors.shape, gt_boxes.shape, gt_labels.shape
    if len(sa) != 2 or sa[1] != 4:
        raise ValueError(f"anchors must be (N, 4), got {tuple(sa)}")
    if len(sb) != 3 or sb[2] != 4:
        raise ValueError(f"gt_boxes must be (B, G, 4), got {tuple(sb)}")
    if len(sl) != 2 or sl[0] != sb[0] or sl[1] != sb[1]:
        raise ValueError(f"gt_labels {tuple(sl)} do not match gt_boxes "
                         f"{tuple(sb)}")
    if anchors.dtype != torch.float32 or gt_boxes.dtype != torch.float32:
        raise TypeError("anchors and gt_boxes must be float32")
    if gt_labels.dtype != torch.int32:
        raise TypeError("gt_labels must be int32")
    device = anchors.device
    if gt_boxes.device != device or gt_labels.device != device:
        raise ValueError("anchors, gt_boxes and gt_labels are on different "
                         "devices")
    return device


def match_encode_cuda(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                      gt_labels: torch.Tensor, iou_threshold: float,
                      variances: Tuple[float, float, float, float]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 4) anchors, (B, G, 4) gts, (B, G) int32 labels on a CUDA device
    -> (deltas (B, N, 4) float32, labels (B, N) int32), threshold matching
    only, by the hand-written kernel; G <= 256."""
    global LAUNCHES
    device = _check(anchors, gt_boxes, gt_labels)
    if device.type != "cuda":
        raise ValueError("match_encode_cuda needs CUDA tensors")
    n = anchors.shape[0]
    b, g = gt_labels.shape
    if g > MAX_G:
        raise ValueError(f"match_encode_cuda takes G <= {MAX_G}, got {g}")
    if not (anchors.is_contiguous() and gt_boxes.is_contiguous()
            and gt_labels.is_contiguous()):
        raise ValueError("anchors, gt_boxes and gt_labels must be contiguous")
    a_ptr, box_ptr = anchors.data_ptr(), gt_boxes.data_ptr()
    if a_ptr % 16 or box_ptr % 16:
        raise ValueError("anchors and gt_boxes must be 16-byte aligned (the "
                         "kernel reads boxes as float4)")
    deltas = anchors.new_empty((b, n, 4))
    labels = gt_labels.new_empty((b, n))
    if b == 0 or n == 0:
        return deltas, labels
    index = device.index
    # The raw handle of the device's current stream, as nms_keep_cuda
    # takes it: no device context and no Stream object per call.
    stream = torch._C._cuda_getCurrentRawStream(index)
    err = _launch_fn()(a_ptr, box_ptr, gt_labels.data_ptr(),
                       deltas.data_ptr(), labels.data_ptr(), b, n, g,
                       float(iou_threshold), *map(float, variances), index,
                       stream)
    if err != 0:
        raise RuntimeError(
            f"match_encode kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return deltas, labels


def _match_encode_cpu(anchors, gt_boxes, gt_labels, iou_threshold,
                      variances, force_match_for_gt):
    _check(anchors, gt_boxes, gt_labels)
    return matching.match_targets(anchors, gt_boxes, gt_labels,
                                  iou_threshold, tuple(variances),
                                  force_match_for_gt)


def _match_encode_op_cuda(anchors, gt_boxes, gt_labels, iou_threshold,
                          variances, force_match_for_gt):
    deltas, labels = match_encode_cuda(anchors, gt_boxes, gt_labels,
                                       iou_threshold, variances)
    if force_match_for_gt:
        deltas, labels = matching.force_match(
            deltas, labels, anchors, gt_boxes, gt_labels, tuple(variances))
    return deltas, labels


_LIB = torch.library.Library("tfssd", "FRAGMENT")
_LIB.define("match_encode(Tensor anchors, Tensor gt_boxes, "
            "Tensor gt_labels, float iou_threshold, float[] variances, "
            "bool force_match_for_gt) -> (Tensor, Tensor)")
_LIB.impl("match_encode", _match_encode_cpu, "CPU")
_LIB.impl("match_encode", _match_encode_op_cuda, "CUDA")


@torch.library.register_fake("tfssd::match_encode")
def _match_encode_op_fake(anchors, gt_boxes, gt_labels, iou_threshold,
                          variances, force_match_for_gt):
    _check(anchors, gt_boxes, gt_labels)
    b, n = gt_labels.shape[0], anchors.shape[0]
    return anchors.new_empty((b, n, 4)), gt_labels.new_empty((b, n))


# (anchors, gt_boxes, gt_labels, iou_threshold, variances,
# force_match_for_gt) -> (deltas (B, N, 4), labels (B, N) int32), by
# device: the plain matcher for CPU tensors, the CUDA kernel (+ the
# force-match post-pass) for CUDA tensors.
match_encode_op = torch.ops.tfssd.match_encode.default


def match_encode(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                 gt_labels: torch.Tensor, config: SSDConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Targets (deltas (B, N, 4), labels (B, N) int32) of `config`'s
    matcher, by tfssd::match_encode."""
    return match_encode_op(anchors, gt_boxes, gt_labels,
                           config.iou_threshold, list(config.variances),
                           config.force_match_for_gt)


def match_batch(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                gt_labels: torch.Tensor, config: SSDConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The matcher of the train and eval steps (the JAX package's
    match_batch_pallas): (deltas (B, N, 4), one-hot labels (B, N, L))."""
    deltas, labels = match_encode(anchors, gt_boxes, gt_labels, config)
    return deltas, matching.one_hot(labels, config)
