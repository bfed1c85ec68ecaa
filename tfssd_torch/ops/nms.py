"""Fixed-shape combined per-class NMS (port of the JAX package's ops/nms.py).

Semantics of `tf.image.combined_non_max_suppression` as the JAX package
defines them (reference: utils/bbox_utils.py:non_max_suppression):

  0. optional class-agnostic prefilter: keep the top-M anchors per image
     by max class score,
  1. per class: top-K candidates by score (K = max_detections_per_class),
  2. exact greedy suppression at IoU > iou_threshold among them
     (ops/kernels/nms_keep.py: the CUDA kernel on the card),
  3. survivors of all classes merged by score into the top
     max_total_detections rows.

Class ids are 0-based foreground indices, -1 on padding; the +1 shift to
the label space lives in models/decoder.py.

Tie order: the JAX package's top_k breaks ties toward the lower index and
its merge relies on that. torch.topk promises no tie order, so every top-k
here is a stable descending sort, sliced. The gathers are torch.gather,
which is exact; the one-hot matmuls and +-inf mask columns of the JAX
package exist only for the TPU's gather unit and are not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.utils import _pytree

from tfssd_torch.ops.kernels.nms_keep import nms_keep


class NMSResult(NamedTuple):
    boxes: torch.Tensor    # (B, max_total, 4) corners, zeros on padding
    scores: torch.Tensor   # (B, max_total), 0 on padding
    classes: torch.Tensor  # (B, max_total) int32, 0-based, -1 on padding
    valid: torch.Tensor    # (B,) int32 number of valid rows


# An exported predict (utils/export.py) returns an NMSResult: its output
# spec names the type by this stable name, so a process that loads the
# artifact rebuilds the same type (the JAX package registers its NMSResult
# under a stable name for its own export, for the same reason).
_pytree._register_namedtuple(
    NMSResult, serialized_type_name="tfssd_torch.ops.nms.NMSResult")


def top_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis, ties toward
    the lower index (the order of the JAX package's top_k)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[
        ..., :k]


def _gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, F) table, (B, S) indices -> (B, S, F)."""
    return torch.gather(
        table, 1, idx[..., None].expand(-1, -1, table.shape[-1]))


def select_candidates(
    boxes: torch.Tensor, scores: torch.Tensor,
    max_detections_per_class: int, prefilter_anchors: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stages 0-1: (B, N, 4) boxes and (B, N, C) scores -> score-sorted
    per-class candidates, boxes (B, C, K, 4) and scores (B, C, K)."""
    b, n, num_classes = scores.shape
    if 0 < prefilter_anchors < n:
        sel = top_indices(scores.amax(dim=-1), prefilter_anchors)  # (B, M)
        scores = _gather_rows(scores, sel)
        boxes = _gather_rows(boxes, sel)
        n = prefilter_anchors
    k = min(max_detections_per_class, n)
    scores_t = scores.transpose(1, 2)                              # (B, C, N)
    top_idx = top_indices(scores_t, k)                             # (B, C, K)
    top_scores = torch.gather(scores_t, 2, top_idx)
    top_boxes = _gather_rows(boxes, top_idx.reshape(b, -1)).reshape(
        b, num_classes, k, 4)
    return top_boxes, top_scores


def merge_detections(top_scores: torch.Tensor, keep: torch.Tensor,
                     top_boxes: torch.Tensor,
                     max_total_detections: int) -> NMSResult:
    """Stage 3: (B, C, K) scores, keep mask and (B, C, K, 4) boxes -> the
    top max_total_detections survivors across classes.

    Suppressed rows sort last behind a -inf key, and validity is the
    gathered keep mask, not a score sign test: scores may be negative or
    -inf. The sort key clamps kept scores to >= finfo.min so a kept row
    whose score is exactly -inf still outranks every suppressed row; the
    reported score is the raw one."""
    b, num_classes, k = top_scores.shape
    ck = num_classes * k
    flat_keep = keep.reshape(b, ck)
    flat_raw = top_scores.reshape(b, ck)
    neg = torch.tensor(float("-inf"), dtype=flat_raw.dtype,
                       device=flat_raw.device)
    lo = torch.finfo(flat_raw.dtype).min
    flat_key = torch.where(flat_keep, torch.clamp_min(flat_raw, lo), neg)

    total = min(max_total_detections, ck)
    sel = top_indices(flat_key, total)                             # (B, T)
    ok = torch.gather(flat_keep, 1, sel)
    zero = torch.zeros((), dtype=flat_raw.dtype, device=flat_raw.device)
    final_scores = torch.where(ok, torch.gather(flat_raw, 1, sel), zero)
    final_classes = torch.where(
        ok, torch.div(sel, k, rounding_mode="floor"),
        torch.full_like(sel, -1)).to(torch.int32)
    final_boxes = torch.where(
        ok[..., None], _gather_rows(top_boxes.reshape(b, ck, 4), sel), zero)
    pad = max_total_detections - total
    if pad:
        final_scores = torch.nn.functional.pad(final_scores, (0, pad))
        final_classes = torch.nn.functional.pad(final_classes, (0, pad),
                                                value=-1)
        final_boxes = torch.nn.functional.pad(final_boxes, (0, 0, 0, pad))
    return NMSResult(boxes=final_boxes, scores=final_scores,
                     classes=final_classes,
                     valid=ok.sum(dim=-1, dtype=torch.int32))


def combined_nms(
    boxes: torch.Tensor,     # (B, N, 4) decoded normalized corners
    scores: torch.Tensor,    # (B, N, C) per-class scores (no bg column)
    max_detections_per_class: int = 200,
    max_total_detections: int = 200,
    iou_threshold: float = 0.45,
    score_threshold: float = 0.0,
    prefilter_anchors: int = 0,
) -> NMSResult:
    """Batched combined per-class NMS; see the module docstring.

    prefilter_anchors = M > 0 keeps only the M anchors with the highest
    max-over-class score before the per-class stages (the serving default
    is 512); 0 is exact."""
    top_boxes, top_scores = select_candidates(
        boxes, scores, max_detections_per_class, prefilter_anchors)
    b, c, k = top_scores.shape
    keep = nms_keep(top_boxes.reshape(b * c, k, 4).contiguous(),
                    top_scores.reshape(b * c, k).contiguous(),
                    iou_threshold, score_threshold).reshape(b, c, k)
    return merge_detections(top_scores, keep, top_boxes,
                            max_total_detections)
