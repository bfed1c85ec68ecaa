"""Anchor matching + target encoding: the CUDA kernel, its plain version,
dispatch.

Replaces the JAX package's Pallas TPU kernel ops/kernels/match_encode.py
(match_encode_pallas, body _kernel, force-match post-pass
_force_match_single, wrapper match_batch_pallas), the matcher of every
train and eval step. Per (image, anchor): IoU against the image's G gts
(padded gts masked), max and first-index argmax, positive = best >
iou_threshold, the matched box encoded as centre-form deltas / variances,
the matched label; negatives zeroed.

Bound on the H100 at B = 32, N = 2,268, G = 64: 4.6 M IoUs of ~16 float32
operations (1.1 us at 67 TFLOP/s) against 1.5 MB moved (0.46 us at
3.35 TB/s), so the operations bound it and a launch costs more than
either. The kernel (csrc/match_encode.cu) runs one thread per (image,
anchor); each block holds its image's gts in shared memory, so the (B, N, G)
IoU never reaches device memory.

`match_encode` dispatches by device: a CPU tensor goes to the plain
version (ops/matching.py), a CUDA tensor to the kernel, which raises if it
cannot run. There is no fallback from one to the other. The force-match
step (config.force_match_for_gt) is a plain PyTorch post-pass on either
device, as in the JAX package.
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
                       + [ctypes.c_float] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(anchors: torch.Tensor, gt_boxes: torch.Tensor,
           gt_labels: torch.Tensor) -> None:
    if anchors.dim() != 2 or anchors.shape[-1] != 4:
        raise ValueError(f"anchors must be (N, 4), got {tuple(anchors.shape)}")
    if gt_boxes.dim() != 3 or gt_boxes.shape[-1] != 4:
        raise ValueError(
            f"gt_boxes must be (B, G, 4), got {tuple(gt_boxes.shape)}")
    if gt_labels.shape != gt_boxes.shape[:2]:
        raise ValueError(f"gt_labels {tuple(gt_labels.shape)} do not match "
                         f"gt_boxes {tuple(gt_boxes.shape)}")
    if anchors.dtype != torch.float32 or gt_boxes.dtype != torch.float32:
        raise TypeError("anchors and gt_boxes must be float32")
    if gt_labels.dtype != torch.int32:
        raise TypeError("gt_labels must be int32")
    if not (anchors.device == gt_boxes.device == gt_labels.device):
        raise ValueError("anchors, gt_boxes and gt_labels are on different "
                         "devices")


def match_encode_cuda(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                      gt_labels: torch.Tensor, iou_threshold: float,
                      variances: Tuple[float, float, float, float]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 4) anchors, (B, G, 4) gts, (B, G) int32 labels on a CUDA device
    -> (deltas (B, N, 4) float32, labels (B, N) int32), threshold matching
    only, by the hand-written kernel; G <= 256."""
    global LAUNCHES
    _check(anchors, gt_boxes, gt_labels)
    if anchors.device.type != "cuda":
        raise ValueError("match_encode_cuda needs CUDA tensors")
    n = anchors.shape[0]
    b, g = gt_labels.shape
    if g > MAX_G:
        raise ValueError(f"match_encode_cuda takes G <= {MAX_G}, got {g}")
    if not (anchors.is_contiguous() and gt_boxes.is_contiguous()
            and gt_labels.is_contiguous()):
        raise ValueError("anchors, gt_boxes and gt_labels must be contiguous")
    if anchors.data_ptr() % 16 or gt_boxes.data_ptr() % 16:
        raise ValueError("anchors and gt_boxes must be 16-byte aligned (the "
                         "kernel reads boxes as float4)")
    deltas = torch.empty((b, n, 4), dtype=torch.float32,
                         device=anchors.device)
    labels = torch.empty((b, n), dtype=torch.int32, device=anchors.device)
    if b == 0 or n == 0:
        return deltas, labels
    fn = _launch_fn()
    with torch.cuda.device(anchors.device):
        stream = torch.cuda.current_stream(anchors.device).cuda_stream
        err = fn(anchors.data_ptr(), gt_boxes.data_ptr(),
                 gt_labels.data_ptr(), deltas.data_ptr(), labels.data_ptr(),
                 b, n, g, float(iou_threshold), *map(float, variances),
                 stream)
    if err != 0:
        raise RuntimeError(
            f"match_encode kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return deltas, labels


def match_encode(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                 gt_labels: torch.Tensor, config: SSDConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Targets (deltas (B, N, 4), labels (B, N) int32) by device: the CUDA
    kernel (+ the force-match post-pass) for CUDA tensors, the plain
    matcher for CPU tensors."""
    if anchors.device.type == "cuda":
        deltas, labels = match_encode_cuda(anchors, gt_boxes, gt_labels,
                                           config.iou_threshold,
                                           config.variances)
        if config.force_match_for_gt:
            deltas, labels = matching.force_match(
                deltas, labels, anchors, gt_boxes, gt_labels,
                config.variances)
        return deltas, labels
    if anchors.device.type == "cpu":
        _check(anchors, gt_boxes, gt_labels)
        return matching.match_targets(
            anchors, gt_boxes, gt_labels, config.iou_threshold,
            config.variances, config.force_match_for_gt)
    raise ValueError(f"no match_encode for device {anchors.device}")


def match_batch(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                gt_labels: torch.Tensor, config: SSDConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The matcher of the train and eval steps (the JAX package's
    match_batch_pallas): (deltas (B, N, 4), one-hot labels (B, N, L))."""
    deltas, labels = match_encode(anchors, gt_boxes, gt_labels, config)
    return deltas, matching.one_hot(labels, config)
