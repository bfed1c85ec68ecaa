"""Ground-truth matching and target encoding: the plain PyTorch version
(port of the JAX package's ops/matching.py).

This module is the oracle of the match/encode CUDA kernel
(ops/kernels/match_encode.py, csrc/match_encode.cu) and the path a CPU
tensor takes. Semantics, per image:

  1. iou = IoU(anchors (N, 4), gt (G, 4)) -> (N, G), padded gts (label 0)
     masked to 0
  2. best_iou / best_gt = max / first-index argmax over G
  3. positive = best_iou > iou_threshold
  4. deltas = encode(anchors, gt[best_gt]) / variances, zero on negatives
  5. labels = gt_label[best_gt] on positives, background (0) elsewhere

With config.force_match_for_gt (off by default) each valid gt whose IoU
column is not all zero also claims its single best anchor; an anchor
claimed by several gts goes to the smallest gt index (a commutative
min, as the JAX package's scatter-min).

Everything is batched over B; the IoU follows ops/boxes.py:iou_matrix, the
operation order the kernel reproduces.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tfssd_torch.config import SSDConfig
from tfssd_torch.ops import boxes as box_ops


def masked_iou(anchors: torch.Tensor, gt_boxes: torch.Tensor,
               gt_labels: torch.Tensor) -> torch.Tensor:
    """(N, 4) anchors x (B, G, 4) gts -> (B, N, G) IoU, 0 on padded gts."""
    iou = box_ops.iou_matrix(anchors, gt_boxes)
    return torch.where((gt_labels > 0)[:, None, :], iou,
                       torch.zeros((), dtype=iou.dtype, device=iou.device))


def best_anchor_claims(iou: torch.Tensor, gt_labels: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The force-match claims of (B, N, G) masked IoU: per gt its best
    anchor (B, G) and, per anchor, the smallest gt index that claims it,
    G where none does (B, N)."""
    b, n, g = iou.shape
    can_force = (gt_labels > 0) & (iou.amax(dim=1) > 0.0)       # (B, G)
    best_anchor = iou.argmax(dim=1)                             # (B, G)
    idx = torch.arange(g, device=iou.device).expand(b, g)
    claiming = torch.where(can_force, idx, torch.full_like(idx, g))
    claimed = torch.full((b, n), g, dtype=idx.dtype, device=iou.device)
    claimed.scatter_reduce_(1, best_anchor, claiming, "amin")
    return best_anchor, claimed


def match_targets(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_labels: torch.Tensor, iou_threshold: float,
                  variances: Tuple[float, float, float, float],
                  force_match_for_gt: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched targets: (deltas (B, N, 4) float32, labels (B, N) int32)."""
    iou = masked_iou(anchors, gt_boxes, gt_labels)              # (B, N, G)
    best_iou = iou.amax(dim=-1)
    best_gt = iou.argmax(dim=-1)  # first index of the maximum, as jnp
    # compared in float32, as the kernel and the JAX package compare
    thr = torch.tensor(iou_threshold, dtype=best_iou.dtype,
                       device=best_iou.device)
    positive = best_iou > thr
    if force_match_for_gt:
        g = gt_labels.shape[1]
        _, claimed = best_anchor_claims(iou, gt_labels)
        positive = positive | (claimed < g)
        best_gt = torch.where(claimed < g, claimed, best_gt)
    matched_boxes = torch.gather(
        gt_boxes, 1, best_gt[..., None].expand(-1, -1, 4))
    deltas = box_ops.encode(anchors, matched_boxes, variances)
    deltas = torch.where(positive[..., None], deltas,
                         torch.zeros((), dtype=deltas.dtype,
                                     device=deltas.device))
    matched = torch.gather(gt_labels, 1, best_gt)
    labels = torch.where(positive, matched, torch.zeros_like(matched))
    return deltas, labels.to(torch.int32)


def force_match(deltas: torch.Tensor, labels: torch.Tensor,
                anchors: torch.Tensor, gt_boxes: torch.Tensor,
                gt_labels: torch.Tensor,
                variances: Tuple[float, float, float, float]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The force-match post-pass over threshold-only targets (the JAX
    package's _force_match_single, batched): claimed anchors become
    positive with the claiming gt's label and its deltas. Each gt's best
    anchor comes from the same masked_iou expression match_targets
    evaluates, so ties resolve identically."""
    iou = masked_iou(anchors, gt_boxes, gt_labels)
    best_anchor, claimed = best_anchor_claims(iou, gt_labels)
    g = gt_labels.shape[1]
    has_claim = claimed < g
    cg = claimed.clamp_max(g - 1)
    # each gt encoded once against its best anchor, then gathered: a
    # claimed anchor i with claimed[i] = k has best_anchor[k] = i
    enc = box_ops.encode(anchors[best_anchor], gt_boxes, variances)
    enc = torch.gather(enc, 1, cg[..., None].expand(-1, -1, 4))
    deltas = torch.where(has_claim[..., None], enc, deltas)
    labels = torch.where(has_claim, torch.gather(gt_labels, 1, cg).to(
        labels.dtype), labels)
    return deltas, labels


def one_hot(labels: torch.Tensor, config: SSDConfig) -> torch.Tensor:
    """(B, N) int labels in [0, L) -> (B, N, L) float32 one-hot (a scatter:
    F.one_hot would read the labels' range back from the device)."""
    out = torch.zeros(*labels.shape, config.total_labels,
                      dtype=torch.float32, device=labels.device)
    return out.scatter_(-1, labels[..., None].long(), 1.0)
