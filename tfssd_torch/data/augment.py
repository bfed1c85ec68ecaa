"""SSD data augmentation, batched over B on the tensors' device (port of
the JAX package's data/augment.py; reference: utils/augmentation.py).

Random photometric ops (brightness, contrast, saturation, hue, each with
probability 1/2), a zoom-out expand into a mean-filled canvas (probability
1/2, ratio in [1, 4]), the SSD random-patch crop (a min-IoU constraint from
{-1, 0.1, 0.3, 0.5, 0.7, 0.9} or none with probability 1/7, NUM_TRIALS
candidates, the first that passes the aspect, IoU and gt-centre tests), a
horizontal flip (probability 1/2), and the boxes remapped, centre-filtered
and clipped.

It comes in two parts, so that the deterministic part can be held against
the JAX package with JAX's own random numbers:

  sample_draws(gen, B, T) -> AugmentDraws   every random number, drawn from
                                            a torch.Generator on its device
  apply_draws(images, boxes, labels, draws) the whole chain, given the draws

Expand and crop compose into one region per image, resampled once as JAX's
scale_and_translate(method="linear") does it: a per-axis (S, S) triangle
weight matrix, widened by 1/scale when the image shrinks (antialiasing) and
normalised per output sample, applied as two batched matmuls.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

NUM_TRIALS = 50
MIN_IOU_CHOICES = (-1.0, 0.1, 0.3, 0.5, 0.7, 0.9)

_GRAY = (0.299, 0.587, 0.114)
_YIQ = ((0.299, 0.587, 0.114),
        (0.596, -0.274, -0.322),
        (0.211, -0.523, 0.312))
_F32_EPS = float(np.finfo(np.float32).eps)

_YIQ_INV: Dict[str, torch.Tensor] = {}


@dataclasses.dataclass
class AugmentDraws:
    """Every random number of one batch's augmentation, leading dim B.

    Values are as the JAX package's random calls return them: uniforms
    in [0, 1) where it compares with a probability or scales later, and
    already scaled into their range where it draws with minval/maxval."""

    photo_apply: torch.Tensor     # (B, 4) U[0,1): op k applied if < 0.5
    brightness: torch.Tensor      # (B,) U[-0.2, 0.2)
    contrast: torch.Tensor        # (B,) U[0.5, 1.5)
    saturation: torch.Tensor      # (B,) U[0.5, 1.5)
    hue: torch.Tensor             # (B,) U[-0.08, 0.08)
    expand_apply: torch.Tensor    # (B,) U[0,1): expand if < 0.5
    expand_ratio: torch.Tensor    # (B,) U[1, 4)
    expand_pos: torch.Tensor      # (B, 2) U[0,1), times (ratio - 1)
    crop_choice: torch.Tensor     # (B,) int64 in [0, 6): MIN_IOU_CHOICES
    crop_skip: torch.Tensor       # (B,) U[0,1): no crop if < 1/7
    crop_wh: torch.Tensor         # (B, T, 2) U[0.3, 1): (h, w)
    crop_pos: torch.Tensor        # (B, T, 2) U[0,1): (y, x)
    flip: torch.Tensor            # (B,) U[0,1): flip if < 0.5


def _uniform(gen: torch.Generator, shape, low: float = 0.0,
             high: float = 1.0) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float32)
    return u if (low, high) == (0.0, 1.0) else u * (high - low) + low


def sample_draws(gen: torch.Generator, batch: int,
                 trials: int = NUM_TRIALS) -> AugmentDraws:
    """Draw one batch's random numbers on the generator's device."""
    b = batch
    return AugmentDraws(
        photo_apply=_uniform(gen, (b, 4)),
        brightness=_uniform(gen, (b,), -0.2, 0.2),
        contrast=_uniform(gen, (b,), 0.5, 1.5),
        saturation=_uniform(gen, (b,), 0.5, 1.5),
        hue=_uniform(gen, (b,), -0.08, 0.08),
        expand_apply=_uniform(gen, (b,)),
        expand_ratio=_uniform(gen, (b,), 1.0, 4.0),
        expand_pos=_uniform(gen, (b, 2)),
        crop_choice=torch.randint(0, len(MIN_IOU_CHOICES), (b,),
                                  generator=gen, device=gen.device),
        crop_skip=_uniform(gen, (b,)),
        crop_wh=_uniform(gen, (b, trials, 2), 0.3, 1.0),
        crop_pos=_uniform(gen, (b, trials, 2)),
        flip=_uniform(gen, (b,)),
    )


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# Photometric ops on (B, S, S, 3) float32 images in [0, 1]; parameters (B,).
# ---------------------------------------------------------------------------


def _per_image(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None, None]


def adjust_brightness(img: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    return img + _per_image(delta)


def adjust_contrast(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    # per-channel mean pivot, as tf.image.adjust_contrast
    mean = img.mean(dim=(-3, -2), keepdim=True)
    return (img - mean) * _per_image(factor) + mean


def adjust_saturation(img: torch.Tensor, factor: torch.Tensor
                      ) -> torch.Tensor:
    w = torch.tensor(_GRAY, dtype=img.dtype, device=img.device)
    gray = (img * w).sum(dim=-1, keepdim=True)
    return gray + (img - gray) * _per_image(factor)


def _yiq_inverse(device: torch.device) -> torch.Tensor:
    """The float32 inverse of the RGB->YIQ matrix, computed once on the
    CPU (as the JAX package inverts it in float32) and cached per device."""
    key = str(device)
    if key not in _YIQ_INV:
        m = torch.tensor(_YIQ, dtype=torch.float32)
        _YIQ_INV[key] = torch.linalg.inv(m).to(device)
    return _YIQ_INV[key]


def adjust_hue(img: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Hue rotation by `delta` turns, a rotation in YIQ space."""
    t = delta * 2.0 * math.pi
    cos = _per_image(torch.cos(t))[..., 0]
    sin = _per_image(torch.sin(t))[..., 0]
    m = torch.tensor(_YIQ, dtype=img.dtype, device=img.device)
    yiq = img @ m.T
    y, i, q = yiq.unbind(-1)
    rot = torch.stack([y, i * cos - q * sin, i * sin + q * cos], dim=-1)
    return rot @ _yiq_inverse(img.device).T


def photometric(img: torch.Tensor, d: AugmentDraws) -> torch.Tensor:
    apply = d.photo_apply < _f32(0.5, img)
    ops = ((adjust_brightness, d.brightness), (adjust_contrast, d.contrast),
           (adjust_saturation, d.saturation), (adjust_hue, d.hue))
    for k, (op, value) in enumerate(ops):
        img = torch.where(_per_image(apply[:, k]), op(img, value), img)
    return img.clamp(0.0, 1.0)


# ---------------------------------------------------------------------------
# Geometric: a region is (y0, x0, h, w) in normalised input coordinates; the
# output image is that region resampled to the full canvas. (B, 4) each.
# ---------------------------------------------------------------------------


def _identity(b: int, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, 1.0, 1.0], dtype=torch.float32,
                        device=like.device).expand(b, 4)


def expand_region(d: AugmentDraws) -> torch.Tensor:
    """Zoom-out region: ratio in [1, 4], the image placed uniformly in the
    canvas; the identity where the expand is not applied."""
    ratio = d.expand_ratio
    py = d.expand_pos[:, 0] * (ratio - 1.0)
    px = d.expand_pos[:, 1] * (ratio - 1.0)
    region = torch.stack([-py, -px, ratio, ratio], dim=-1)
    do = d.expand_apply < _f32(0.5, ratio)
    return torch.where(do[:, None], region, _identity(len(ratio), ratio))


def region_iou(regions: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """IoU of crop rectangles (B, T, 4) with gt boxes (B, G, 4): (B, T, G)."""
    ry0, rx0, rh, rw = (regions[..., i, None] for i in range(4))
    ry1, rx1 = ry0 + rh, rx0 + rw
    b = boxes[:, None]
    iy0 = torch.maximum(ry0, b[..., 0])
    ix0 = torch.maximum(rx0, b[..., 1])
    iy1 = torch.minimum(ry1, b[..., 2])
    ix1 = torch.minimum(rx1, b[..., 3])
    inter = (iy1 - iy0).clamp_min(0) * (ix1 - ix0).clamp_min(0)
    area_b = (b[..., 2] - b[..., 0]).clamp_min(0) * (
        b[..., 3] - b[..., 1]).clamp_min(0)
    union = rh * rw + area_b - inter
    return inter / union.clamp_min(1e-8)


def crop_region(d: AugmentDraws, boxes: torch.Tensor, valid: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD random-patch crop: of the T candidates, the first that passes
    the aspect test, the sampled min-IoU constraint and contains a gt
    centre; the identity when none passes or the crop is skipped. boxes
    (B, G, 4), valid (B, G) -> (region (B, 4), accepted (B,))."""
    choices = torch.tensor(MIN_IOU_CHOICES, dtype=torch.float32,
                           device=boxes.device)
    min_iou = choices[d.crop_choice]
    skip = d.crop_skip < _f32(1.0 / 7.0, boxes)
    h, w = d.crop_wh[..., 0], d.crop_wh[..., 1]
    ar_ok = (w / h > 0.5) & (w / h < 2.0)
    y0 = d.crop_pos[..., 0] * (1.0 - h)
    x0 = d.crop_pos[..., 1] * (1.0 - w)
    regions = torch.stack([y0, x0, h, w], dim=-1)               # (B, T, 4)
    ious = region_iou(regions, boxes)                           # (B, T, G)
    ious = torch.where(valid[:, None, :], ious, _f32(-1.0, ious))
    iou_ok = ious.amax(dim=-1) >= min_iou[:, None]
    cy = (boxes[..., 0] + boxes[..., 2]) / 2.0
    cx = (boxes[..., 1] + boxes[..., 3]) / 2.0
    cy, cx, vb = cy[:, None, :], cx[:, None, :], valid[:, None, :]
    center_in = ((cy > y0[..., None]) & (cy < (y0 + h)[..., None])
                 & (cx > x0[..., None]) & (cx < (x0 + w)[..., None]) & vb)
    ok = ar_ok & iou_ok & center_in.any(dim=-1)                 # (B, T)
    first = ok.int().argmax(dim=-1)             # first passing, else 0
    accepted = ~skip & ok.any(dim=-1)
    chosen = torch.gather(regions, 1, first[:, None, None].expand(-1, 1, 4))
    region = torch.where(accepted[:, None], chosen[:, 0],
                         _identity(len(first), boxes))
    return region, accepted


def compose(outer: torch.Tensor, inner: torch.Tensor) -> torch.Tensor:
    """Apply `outer` (expand) then `inner` (crop): one input region."""
    oy, ox, oh, ow = outer.unbind(-1)
    iy, ix, ih, iw = inner.unbind(-1)
    return torch.stack([oy + iy * oh, ox + ix * ow, ih * oh, iw * ow], dim=-1)


def transform_boxes(boxes: torch.Tensor, region: torch.Tensor
                    ) -> torch.Tensor:
    y0, x0, h, w = region.unbind(-1)
    shift = torch.stack([y0, x0, y0, x0], dim=-1)[:, None, :]
    scale = torch.stack([h, w, h, w], dim=-1)[:, None, :]
    return (boxes - shift) / scale


def _weight_matrix(size: int, scale: torch.Tensor, translation: torch.Tensor
                   ) -> torch.Tensor:
    """(B, size_in, size_out) weights of JAX's image.scale_and_translate
    linear method (compute_weight_mat with the triangle kernel and
    antialiasing), one matrix per image."""
    inv_scale = (1.0 / scale)[:, None]
    kernel_scale = inv_scale.clamp_min(1.0)
    ar = torch.arange(size, dtype=torch.float32, device=scale.device)
    sample_f = ((ar + 0.5)[None, :] * inv_scale
                - translation[:, None] * inv_scale - 0.5)       # (B, out)
    x = (sample_f[:, None, :] - ar[None, :, None]).abs() / kernel_scale[
        :, None]                                                # (B, in, out)
    weights = (1.0 - x.abs()).clamp_min(0.0)
    total = weights.sum(dim=1, keepdim=True)
    safe = torch.where(total != 0, total, torch.ones_like(total))
    weights = torch.where(total.abs() > 1000.0 * _F32_EPS, weights / safe,
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= size - 0.5)
    return torch.where(inside[:, None, :], weights, torch.zeros_like(weights))


def apply_region(img: torch.Tensor, region: torch.Tensor) -> torch.Tensor:
    """Resample each image's region (B, 4) to the full (B, S, S, 3) canvas,
    with the image's per-channel mean where the sample falls outside it."""
    size = img.shape[1]
    y0, x0, h, w = region.unbind(-1)
    wy = _weight_matrix(size, 1.0 / h, -y0 * size / h)          # (B, in, out)
    wx = _weight_matrix(size, 1.0 / w, -x0 * size / w)
    b = img.shape[0]
    # out[b, o, p, c] = sum_{i, j} img[b, i, j, c] wy[b, i, o] wx[b, j, p]
    rows = torch.bmm(wy.transpose(1, 2), img.reshape(b, size, size * 3))
    rows = rows.reshape(b, size, size, 3).permute(0, 1, 3, 2)   # (B, o, c, j)
    out = torch.matmul(rows, wx[:, None]).permute(0, 1, 3, 2)   # (B, o, p, c)
    coords = (torch.arange(size, dtype=torch.float32, device=img.device)
              + 0.5) / size
    sy = coords[None, :] * h[:, None] + y0[:, None]
    sx = coords[None, :] * w[:, None] + x0[:, None]
    in_y = (sy >= 0.0) & (sy <= 1.0)
    in_x = (sx >= 0.0) & (sx <= 1.0)
    inside = in_y[:, :, None, None] & in_x[:, None, :, None]
    mean = img.mean(dim=(1, 2), keepdim=True)
    return torch.where(inside, out, mean)


def apply_draws(images: torch.Tensor, boxes: torch.Tensor,
                labels: torch.Tensor, d: AugmentDraws
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The whole chain for (B, S, S, 3) float32 images in [0, 1], (B, G, 4)
    normalised corner boxes and (B, G) int labels (0 = padding), given the
    draws. Dropped boxes become zero rows with label 0."""
    images = photometric(images, d)
    valid = labels > 0
    expand = expand_region(d)
    crop, _ = crop_region(d, transform_boxes(boxes, expand), valid)
    region = compose(expand, crop)
    images = apply_region(images, region)
    boxes = transform_boxes(boxes, region)
    # keep boxes whose centre stays inside the patch, then clip
    cy = (boxes[..., 0] + boxes[..., 2]) / 2.0
    cx = (boxes[..., 1] + boxes[..., 3]) / 2.0
    keep = valid & (cy > 0) & (cy < 1) & (cx > 0) & (cx < 1)
    boxes = boxes.clamp(0.0, 1.0)
    do_flip = d.flip < _f32(0.5, d.flip)
    flipped = torch.stack([boxes[..., 0], 1.0 - boxes[..., 3],
                           boxes[..., 2], 1.0 - boxes[..., 1]], dim=-1)
    images = torch.where(_per_image(do_flip), images.flip(2), images)
    boxes = torch.where(do_flip[:, None, None], flipped, boxes)
    boxes = torch.where(keep[..., None], boxes, torch.zeros_like(boxes))
    labels = torch.where(keep, labels, torch.zeros_like(labels))
    return images, boxes, labels


def take_rows(d: AugmentDraws, rows: slice) -> AugmentDraws:
    """The draws of the images in `rows` of the batch."""
    return AugmentDraws(**{f.name: getattr(d, f.name)[rows]
                           for f in dataclasses.fields(d)})


def augment_batch(gen: torch.Generator, images: torch.Tensor,
                  boxes: torch.Tensor, labels: torch.Tensor,
                  rank: int = 0, world: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Draw and apply one batch's augmentation (the generator must live on
    the images' device). With `world` > 1 the B images are rank `rank`'s
    rows of a global batch of world x B: the draws are the global batch's,
    and its rows rank x B .. (rank + 1) x B - 1 are applied, so each image
    is augmented as in the single-process run of the global batch."""
    b = images.shape[0]
    draws = sample_draws(gen, b * world)
    if world > 1:
        draws = take_rows(draws, slice(rank * b, (rank + 1) * b))
    return apply_draws(images, boxes, labels, draws)
