"""Box geometry: anchors (prior boxes), IoU, delta encode/decode, clip.

Port of the JAX package's ops/boxes.py (reference: utils/bbox_utils.py).
Anchors are numpy, generated on the host exactly as the JAX package does,
so both packages get bit-equal anchors. The tensor functions keep the same
operation order as their JAX counterparts, so they agree to the last few
ulps in float32. All boxes are normalized corners [ymin, xmin, ymax, xmax];
center form is [cy, cx, h, w].
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from tfssd_torch.config import SSDConfig

EPS = 1e-8


def generate_base_anchors(
    scale: float, next_scale: float, aspect_ratios: Sequence[float]
) -> np.ndarray:
    """Per-cell (h, w) pairs for one feature map: one box per aspect ratio
    at `scale` plus the extra ar=1 box at sqrt(scale * next_scale)."""
    hw = []
    for ar in aspect_ratios:
        r = math.sqrt(ar)
        hw.append((scale / r, scale * r))
    s_prime = math.sqrt(scale * next_scale)
    hw.append((s_prime, s_prime))
    return np.asarray(hw, dtype=np.float32)


def generate_anchors(config: SSDConfig) -> np.ndarray:
    """All prior boxes for a config, (total_anchors, 4) float32 corners,
    centers at (i + 0.5) / f_k, clipped to [0, 1]."""
    scales = config.map_scales
    out = []
    for k, fm in enumerate(config.feature_map_shapes):
        hw = generate_base_anchors(scales[k], scales[k + 1],
                                   config.aspect_ratios[k])
        centers = (np.arange(fm, dtype=np.float32) + 0.5) / fm
        cy, cx = np.meshgrid(centers, centers, indexing="ij")
        cy = cy[:, :, None]
        cx = cx[:, :, None]
        h = hw[None, None, :, 0]
        w = hw[None, None, :, 1]
        boxes = np.stack(
            [cy - h / 2.0, cx - w / 2.0, cy + h / 2.0, cx + w / 2.0],
            axis=-1,
        )
        out.append(boxes.reshape(-1, 4))
    anchors = np.concatenate(out, axis=0)
    if anchors.shape[0] != config.total_anchors:
        raise ValueError(f"{anchors.shape[0]} anchors, config expects "
                         f"{config.total_anchors}")
    return np.clip(anchors, 0.0, 1.0).astype(np.float32)


def to_centers(boxes: torch.Tensor) -> torch.Tensor:
    """[..., (ymin,xmin,ymax,xmax)] -> [..., (cy,cx,h,w)]."""
    ymin, xmin, ymax, xmax = boxes.unbind(-1)
    h = ymax - ymin
    w = xmax - xmin
    return torch.stack([ymin + h / 2.0, xmin + w / 2.0, h, w], dim=-1)


def to_corners(boxes: torch.Tensor) -> torch.Tensor:
    """[..., (cy,cx,h,w)] -> [..., (ymin,xmin,ymax,xmax)]."""
    cy, cx, h, w = boxes.unbind(-1)
    return torch.stack(
        [cy - h / 2.0, cx - w / 2.0, cy + h / 2.0, cx + w / 2.0], dim=-1)


def area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of [..., 4] corner boxes -> [...]."""
    h = torch.clamp_min(boxes[..., 2] - boxes[..., 0], 0.0)
    w = torch.clamp_min(boxes[..., 3] - boxes[..., 1], 0.0)
    return h * w


def iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Broadcast pairwise IoU: [..., A, 4] x [..., B, 4] -> [..., A, B].
    Zero-area (padded) boxes give IoU 0."""
    a = boxes_a[..., :, None, :]
    b = boxes_b[..., None, :, :]
    inter_min = torch.maximum(a[..., :2], b[..., :2])
    inter_max = torch.minimum(a[..., 2:], b[..., 2:])
    inter_hw = torch.clamp_min(inter_max - inter_min, 0.0)
    inter = inter_hw[..., 0] * inter_hw[..., 1]
    union = area(boxes_a)[..., :, None] + area(boxes_b)[..., None, :] - inter
    return inter / torch.clamp_min(union, EPS)


def encode(anchors: torch.Tensor, boxes: torch.Tensor,
           variances: Tuple[float, float, float, float]) -> torch.Tensor:
    """Corner boxes -> deltas [dcy, dcx, dh, dw] / variances relative to the
    anchors; zero-size boxes encode to zero deltas."""
    anc = to_centers(anchors)
    gt = to_centers(boxes)
    acy, acx, ah, aw = anc.unbind(-1)
    gcy, gcx, gh, gw = gt.unbind(-1)
    valid = (gh > EPS) & (gw > EPS)
    one = torch.ones((), dtype=gh.dtype, device=gh.device)
    gh_safe = torch.where(valid, gh, one)
    gw_safe = torch.where(valid, gw, one)
    ah_safe = torch.clamp_min(ah, EPS)
    aw_safe = torch.clamp_min(aw, EPS)
    dcy = (gcy - acy) / ah_safe
    dcx = (gcx - acx) / aw_safe
    dh = torch.log(gh_safe / ah_safe)
    dw = torch.log(gw_safe / aw_safe)
    deltas = torch.stack([dcy, dcx, dh, dw], dim=-1)
    deltas = torch.where(valid[..., None], deltas, torch.zeros_like(deltas))
    v = torch.as_tensor(variances, dtype=deltas.dtype, device=deltas.device)
    return deltas / v


def decode(anchors: torch.Tensor, deltas: torch.Tensor,
           variances: Tuple[float, float, float, float]) -> torch.Tensor:
    """Deltas -> corner boxes (inverse of `encode`)."""
    v = torch.as_tensor(variances, dtype=deltas.dtype, device=deltas.device)
    d = deltas * v
    acy, acx, ah, aw = to_centers(anchors).unbind(-1)
    cy = d[..., 0] * ah + acy
    cx = d[..., 1] * aw + acx
    h = torch.exp(d[..., 2]) * ah
    w = torch.exp(d[..., 3]) * aw
    return to_corners(torch.stack([cy, cx, h, w], dim=-1))


def clip_boxes(boxes: torch.Tensor, low: float = 0.0,
               high: float = 1.0) -> torch.Tensor:
    return torch.clamp(boxes, low, high)


def normalize_bboxes(boxes: torch.Tensor, height: float,
                     width: float) -> torch.Tensor:
    """Pixel corner boxes -> normalized (divided by the image's size)."""
    scale = torch.tensor([height, width, height, width], dtype=boxes.dtype,
                         device=boxes.device)
    return boxes / scale


def denormalize_bboxes(boxes: torch.Tensor, height: float,
                       width: float) -> torch.Tensor:
    """Normalized corner boxes -> pixels (multiplied by the image's size)."""
    scale = torch.tensor([height, width, height, width], dtype=boxes.dtype,
                         device=boxes.device)
    return boxes * scale
