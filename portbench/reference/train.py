"""The plain reference of the SSD train step: augmentation, matching, loss,
backward and Adam, over the forward of ssd.py, for the first steps of a
run or from a state the program reached, and the comparison of the
program's steps with it.

One step t (0-based) of a batch of rows of the staged dataset:
  1. uint8 -> / 255;
  2. the SSD augmentation (SSD paper §2.2, as the system's JAX reference
     defines it): photometric ops with probability 1/2 each, a zoom-out
     into a mean-filled canvas, the min-IoU random crop, a horizontal flip,
     the gt boxes moved with the image and dropped where their centre
     leaves it. Its random numbers are drawn from a torch.Generator on the
     images' device seeded with seed * 1_000_003 + t, in the order and
     shapes the system draws them: this is how the system's augmentation
     stream is defined, so that both sides augment alike;
  3. x 2 - 1;
  4. matching: each anchor takes the gt of highest IoU (the first on
     ties), positive where that IoU > iou_threshold, its box encoded as
     centre offsets over the anchor's size and log size ratios, divided by
     the variances;
  5. forward in training mode (BatchNorm on the batch's statistics);
  6. loss: smooth-L1 over the positives' deltas, plus the cross entropy
     of the positives and of the 3 x #positives hardest negatives (a
     stable descending sort), each per image over max(1, #positives),
     averaged over the batch;
  7. backward, then Adam (lr 1e-3, betas 0.9 / 0.999, eps 1e-8, bias-
     corrected, eps outside the square root).

The decisions of the geometry (the crop that passes, the boxes kept, the
mask of samples inside the image) and the matching's IoU comparisons are
taken in float32, with the system's order of operations, as the system
takes them: a decision taken the other way by a rounding difference would
change a whole image, which is not what the comparison is for. Everything
continuous (pixels, resampling, encoding, the model, the loss, the
gradients, Adam) computes in the reference's dtype.

This file imports torch, numpy, the standard library and ssd.py only.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.reference import ssd

NUM_TRIALS = 50
MIN_IOU_CHOICES = (-1.0, 0.1, 0.3, 0.5, 0.7, 0.9)
_GRAY = (0.299, 0.587, 0.114)
_YIQ = ((0.299, 0.587, 0.114), (0.596, -0.274, -0.322),
        (0.211, -0.523, 0.312))
_F32_EPS = float(np.finfo(np.float32).eps)
ADAM = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)


def augment_seed(seed: int, step: int) -> int:
    return seed * 1_000_003 + step


def draws(gen: torch.Generator, b: int) -> Dict[str, torch.Tensor]:
    """One batch's random numbers, float32, in the system's order."""
    def u(shape, low=0.0, high=1.0):
        x = torch.rand(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)
        return x if (low, high) == (0.0, 1.0) else x * (high - low) + low

    out = {}
    out["photo_apply"] = u((b, 4))
    out["brightness"] = u((b,), -0.2, 0.2)
    out["contrast"] = u((b,), 0.5, 1.5)
    out["saturation"] = u((b,), 0.5, 1.5)
    out["hue"] = u((b,), -0.08, 0.08)
    out["expand_apply"] = u((b,))
    out["expand_ratio"] = u((b,), 1.0, 4.0)
    out["expand_pos"] = u((b, 2))
    out["crop_choice"] = torch.randint(0, len(MIN_IOU_CHOICES), (b,),
                                       generator=gen, device=gen.device)
    out["crop_skip"] = u((b,))
    out["crop_wh"] = u((b, NUM_TRIALS, 2), 0.3, 1.0)
    out["crop_pos"] = u((b, NUM_TRIALS, 2))
    out["flip"] = u((b,))
    return out


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _img(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None, None]


# --- geometry, float32 -----------------------------------------------------

def _identity(b: int, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, 1.0, 1.0], dtype=torch.float32,
                        device=like.device).expand(b, 4)


def expand_region(d) -> torch.Tensor:
    ratio = d["expand_ratio"]
    py = d["expand_pos"][:, 0] * (ratio - 1.0)
    px = d["expand_pos"][:, 1] * (ratio - 1.0)
    region = torch.stack([-py, -px, ratio, ratio], dim=-1)
    do = d["expand_apply"] < _f32(0.5, ratio)
    return torch.where(do[:, None], region, _identity(len(ratio), ratio))


def region_iou(regions: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
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


def crop_region(d, boxes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    choices = torch.tensor(MIN_IOU_CHOICES, dtype=torch.float32,
                           device=boxes.device)
    min_iou = choices[d["crop_choice"]]
    skip = d["crop_skip"] < _f32(1.0 / 7.0, boxes)
    h, w = d["crop_wh"][..., 0], d["crop_wh"][..., 1]
    ar_ok = (w / h > 0.5) & (w / h < 2.0)
    y0 = d["crop_pos"][..., 0] * (1.0 - h)
    x0 = d["crop_pos"][..., 1] * (1.0 - w)
    regions = torch.stack([y0, x0, h, w], dim=-1)
    ious = region_iou(regions, boxes)
    ious = torch.where(valid[:, None, :], ious, _f32(-1.0, ious))
    iou_ok = ious.amax(dim=-1) >= min_iou[:, None]
    cy = (boxes[..., 0] + boxes[..., 2]) / 2.0
    cx = (boxes[..., 1] + boxes[..., 3]) / 2.0
    cy, cx, vb = cy[:, None, :], cx[:, None, :], valid[:, None, :]
    center_in = ((cy > y0[..., None]) & (cy < (y0 + h)[..., None])
                 & (cx > x0[..., None]) & (cx < (x0 + w)[..., None]) & vb)
    ok = ar_ok & iou_ok & center_in.any(dim=-1)
    first = ok.int().argmax(dim=-1)
    accepted = ~skip & ok.any(dim=-1)
    chosen = torch.gather(regions, 1, first[:, None, None].expand(-1, 1, 4))
    return torch.where(accepted[:, None], chosen[:, 0],
                       _identity(len(first), boxes))


def compose(outer: torch.Tensor, inner: torch.Tensor) -> torch.Tensor:
    oy, ox, oh, ow = outer.unbind(-1)
    iy, ix, ih, iw = inner.unbind(-1)
    return torch.stack([oy + iy * oh, ox + ix * ow, ih * oh, iw * ow], dim=-1)


def transform_boxes(boxes: torch.Tensor, region: torch.Tensor
                    ) -> torch.Tensor:
    y0, x0, h, w = region.unbind(-1)
    shift = torch.stack([y0, x0, y0, x0], dim=-1)[:, None, :]
    scale = torch.stack([h, w, h, w], dim=-1)[:, None, :]
    return (boxes - shift) / scale


# --- pixels, in the reference's dtype --------------------------------------

def photometric(img: torch.Tensor, d) -> torch.Tensor:
    dt = img.dtype
    apply = d["photo_apply"] < _f32(0.5, img)

    def brightness(x, v):
        return x + _img(v)

    def contrast(x, v):
        mean = x.mean(dim=(-3, -2), keepdim=True)
        return (x - mean) * _img(v) + mean

    def saturation(x, v):
        gray = (x * torch.tensor(_GRAY, dtype=dt, device=x.device)).sum(
            dim=-1, keepdim=True)
        return gray + (x - gray) * _img(v)

    def hue(x, v):
        t = v * 2.0 * math.pi
        cos, sin = torch.cos(t)[:, None, None], torch.sin(t)[:, None, None]
        m = torch.tensor(_YIQ, dtype=dt, device=x.device)
        y, i, q = (x @ m.T).unbind(-1)
        rot = torch.stack([y, i * cos - q * sin, i * sin + q * cos], dim=-1)
        return rot @ torch.linalg.inv(m).T

    for k, (op, name) in enumerate(((brightness, "brightness"),
                                    (contrast, "contrast"),
                                    (saturation, "saturation"),
                                    (hue, "hue"))):
        img = torch.where(_img(apply[:, k]), op(img, d[name].to(dt)), img)
    return img.clamp(0.0, 1.0)


def weight_matrix(size: int, scale: torch.Tensor, translation: torch.Tensor
                  ) -> torch.Tensor:
    """(B, in, out) weights of linear resampling with antialiasing (the
    triangle kernel widened by 1/scale where the image shrinks),
    normalised per output sample; zero for samples outside the input."""
    inv = (1.0 / scale)[:, None]
    kernel_scale = inv.clamp_min(1.0)
    ar = torch.arange(size, dtype=scale.dtype, device=scale.device)
    sample = (ar + 0.5)[None, :] * inv - translation[:, None] * inv - 0.5
    x = (sample[:, None, :] - ar[None, :, None]).abs() / kernel_scale[:, None]
    w = (1.0 - x).clamp_min(0.0)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _F32_EPS,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= size - 0.5)
    return torch.where(inside[:, None, :], w, torch.zeros_like(w))


def resample(img: torch.Tensor, region32: torch.Tensor) -> torch.Tensor:
    """Each image's region resampled to the full canvas; the image's
    per-channel mean where the sample falls outside it."""
    size, dt = img.shape[1], img.dtype
    y0, x0, h, w = region32.to(dt).unbind(-1)
    wy = weight_matrix(size, 1.0 / h, -y0 * size / h)
    wx = weight_matrix(size, 1.0 / w, -x0 * size / w)
    rows = torch.einsum("bio,bijc->bojc", wy, img)
    out = torch.einsum("bojc,bjp->bopc", rows, wx)
    # which samples fall inside the image: a decision, taken in float32
    ry0, rx0, rh, rw = region32.unbind(-1)
    coords = (torch.arange(size, dtype=torch.float32, device=img.device)
              + 0.5) / size
    sy = coords[None, :] * rh[:, None] + ry0[:, None]
    sx = coords[None, :] * rw[:, None] + rx0[:, None]
    inside = (((sy >= 0.0) & (sy <= 1.0))[:, :, None, None]
              & ((sx >= 0.0) & (sx <= 1.0))[:, None, :, None])
    return torch.where(inside, out, img.mean(dim=(1, 2), keepdim=True))


def augment(gen: torch.Generator, images: torch.Tensor, boxes: torch.Tensor,
            labels: torch.Tensor):
    """(B, S, S, 3) images in [0, 1] in the reference's dtype, float32
    (B, G, 4) boxes, (B, G) labels -> the augmented triple."""
    d = draws(gen, images.shape[0])
    images = photometric(images, d)
    valid = labels > 0
    expand = expand_region(d)
    crop = crop_region(d, transform_boxes(boxes, expand), valid)
    region = compose(expand, crop)
    images = resample(images, region)
    boxes = transform_boxes(boxes, region)
    cy = (boxes[..., 0] + boxes[..., 2]) / 2.0
    cx = (boxes[..., 1] + boxes[..., 3]) / 2.0
    keep = valid & (cy > 0) & (cy < 1) & (cx > 0) & (cx < 1)
    boxes = boxes.clamp(0.0, 1.0)
    flip = d["flip"] < _f32(0.5, d["flip"])
    flipped = torch.stack([boxes[..., 0], 1.0 - boxes[..., 3],
                           boxes[..., 2], 1.0 - boxes[..., 1]], dim=-1)
    images = torch.where(_img(flip), images.flip(2), images)
    boxes = torch.where(flip[:, None, None], flipped, boxes)
    boxes = torch.where(keep[..., None], boxes, torch.zeros_like(boxes))
    labels = torch.where(keep, labels, torch.zeros_like(labels))
    return images, boxes, labels


# --- matching and loss -----------------------------------------------------

def match(cfg: dict, anchors32: torch.Tensor, boxes: torch.Tensor,
          labels: torch.Tensor, dtype: torch.dtype):
    """(deltas (B, N, 4) in `dtype`, labels (B, N) int64): IoU and its
    comparisons in float32, the encoding in `dtype`."""
    a = anchors32[None, :, None, :]
    g = boxes[:, None, :, :]
    lo = torch.maximum(a[..., :2], g[..., :2])
    hi = torch.minimum(a[..., 2:], g[..., 2:])
    hw = torch.clamp_min(hi - lo, 0.0)
    inter = hw[..., 0] * hw[..., 1]

    def area(x):
        return (torch.clamp_min(x[..., 2] - x[..., 0], 0.0)
                * torch.clamp_min(x[..., 3] - x[..., 1], 0.0))

    union = area(anchors32)[None, :, None] + area(boxes)[:, None, :] - inter
    iou = inter / torch.clamp_min(union, 1e-8)
    iou = torch.where((labels > 0)[:, None, :], iou,
                      torch.zeros((), dtype=iou.dtype, device=iou.device))
    best_iou = iou.amax(dim=-1)
    best_gt = iou.argmax(dim=-1)
    positive = best_iou > torch.tensor(cfg["iou_threshold"],
                                       dtype=torch.float32,
                                       device=iou.device)
    gt = torch.gather(boxes, 1, best_gt[..., None].expand(-1, -1, 4)).to(
        dtype)
    an = anchors32.to(dtype)
    ah, aw = an[:, 2] - an[:, 0], an[:, 3] - an[:, 1]
    acy, acx = an[:, 0] + ah / 2, an[:, 1] + aw / 2
    gh, gw = gt[..., 2] - gt[..., 0], gt[..., 3] - gt[..., 1]
    gcy, gcx = gt[..., 0] + gh / 2, gt[..., 1] + gw / 2
    ok = (gh > 1e-8) & (gw > 1e-8)
    gh1 = torch.where(ok, gh, torch.ones_like(gh))
    gw1 = torch.where(ok, gw, torch.ones_like(gw))
    v = cfg["variances"]
    ahc, awc = ah.clamp_min(1e-8), aw.clamp_min(1e-8)
    deltas = torch.stack([(gcy - acy) / ahc / v[0], (gcx - acx) / awc / v[1],
                          torch.log(gh1 / ahc) / v[2],
                          torch.log(gw1 / awc) / v[3]], dim=-1)
    deltas = torch.where((positive & ok)[..., None], deltas,
                         torch.zeros_like(deltas))
    matched = torch.gather(labels, 1, best_gt).long()
    return deltas, torch.where(positive, matched, torch.zeros_like(matched))


def loss(cfg: dict, deltas: torch.Tensor, labels: torch.Tensor,
         pred_deltas: torch.Tensor, pred_logits: torch.Tensor
         ) -> torch.Tensor:
    positive = labels > 0
    pos = positive.sum(dim=-1)
    denom = pos.to(pred_deltas.dtype).clamp_min(1.0)
    r = pred_deltas - deltas
    huber = torch.where(r.abs() <= 1.0, 0.5 * r * r, r.abs() - 0.5).sum(-1)
    loc = (torch.where(positive, huber, torch.zeros_like(huber)).sum(-1)
           / denom).mean() * cfg["loc_loss_alpha"]
    ce = -torch.log_softmax(pred_logits, dim=-1).gather(
        -1, labels[..., None]).squeeze(-1)
    with torch.no_grad():
        neg = torch.where(positive, torch.full_like(ce, float("-inf")), ce)
        order = torch.argsort(-neg, dim=-1, stable=True)
        rank = torch.argsort(order, dim=-1, stable=True)
    hard = ~positive & (rank < (cfg["neg_pos_ratio"] * pos)[:, None])
    conf = (torch.where(positive | hard, ce, torch.zeros_like(ce)).sum(-1)
            / denom).mean()
    return loc + conf


# --- the steps --------------------------------------------------------------

def run_steps(cfg: dict, tree: Dict[str, torch.Tensor],
              data: Dict[str, torch.Tensor], rows: Sequence[torch.Tensor],
              seed: int, dtype: torch.dtype, first_step: int = 0,
              adam=None) -> Dict:
    """len(rows) train steps from `tree` (its leaves are copied), batch t
    the staged rows rows[t], augmented as step first_step + t; Adam starts
    from `adam` = (first moments, second moments, update count), the
    moments keyed as the 'params/' leaves, or from zero. Returns
    {'losses': [...], 'grad_norms': {leaf: norm of the first step's
    gradient}, 'change_norms': {leaf: norm of the parameters' change over
    all the steps}} for the 'params/' leaves."""
    names = sorted(k for k in tree if k.startswith("params/"))
    params = {k: tree[k].detach().to(dtype).clone().requires_grad_(True)
              for k in names}
    start = {k: v.detach().clone() for k, v in params.items()}
    state = {k: tree[k].detach().to(dtype) for k in tree
             if not k.startswith("params/")}
    if adam is None:
        m = {k: torch.zeros_like(v) for k, v in params.items()}
        v2 = {k: torch.zeros_like(v) for k, v in params.items()}
        count = 0
    else:
        m = {k: adam[0][k].to(params[k].device, dtype).clone()
             for k in names}
        v2 = {k: adam[1][k].to(params[k].device, dtype).clone()
              for k in names}
        count = adam[2]
    anchors32 = torch.from_numpy(ssd.anchors(cfg)).to(
        data["image"].device)
    gen = torch.Generator(device=data["image"].device)
    losses, grad_norms = [], {}
    for t, idx in enumerate(rows):
        gen.manual_seed(augment_seed(seed, first_step + t))
        images = data["image"].index_select(0, idx).to(dtype) / 255.0
        images, boxes, labels = augment(
            gen, images, data["boxes"].index_select(0, idx),
            data["labels"].index_select(0, idx))
        images = images * 2.0 - 1.0
        deltas, targets = match(cfg, anchors32, boxes, labels, dtype)
        pd, pl = ssd.forward(cfg, {**params, **state}, images, train=True)
        total = loss(cfg, deltas, targets, pd, pl)
        grads = torch.autograd.grad(total, [params[k] for k in names])
        losses.append(float(total.detach()))
        if t == 0:
            grad_norms = {k: float(g.norm()) for k, g in zip(names, grads)}
        step = count + t + 1
        c1, c2 = 1 - ADAM["b1"] ** step, 1 - ADAM["b2"] ** step
        with torch.no_grad():
            for k, g in zip(names, grads):
                m[k].mul_(ADAM["b1"]).add_(g, alpha=1 - ADAM["b1"])
                v2[k].mul_(ADAM["b2"]).addcmul_(g, g, value=1 - ADAM["b2"])
                params[k] -= ADAM["lr"] * (m[k] / c1) / (
                    torch.sqrt(v2[k] / c2) + ADAM["eps"])
        del grads, pd, pl, total, images
    change = {k: float((params[k].detach() - start[k]).norm()) for k in names}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}


def _median(values: List[float]) -> float:
    return float(np.median(np.asarray(values, dtype=np.float64)))


def judge(ref: Dict, got: Dict) -> Dict[str, float]:
    """The numbers compared for a train cell, each the worst over its
    items: loss_gap, the largest relative gap of a step's loss (loss1_gap,
    of the first step's);
    grad_gap and change_gap, for each leaf the gap between the program's
    norm and the reference's (of the first step's gradient, of the change
    over the steps) over the reference's norm of that leaf or of the
    median leaf, whichever is larger. Leaves whose reference gradient is
    under a thousandth of the median leaf's move by round-off alone and
    are left out of change_gap."""
    out = {"loss_gap": max(
        abs(a - b) / abs(b) if b else math.inf
        for a, b in zip(got["losses"], ref["losses"]))}
    if len(got["losses"]) != len(ref["losses"]) or not all(
            math.isfinite(x) for x in got["losses"]):
        out["loss_gap"] = math.inf
    a, b = got["losses"][0], ref["losses"][0]
    out["loss1_gap"] = abs(a - b) / abs(b) if math.isfinite(a) else math.inf
    med_g = _median(list(ref["grad_norms"].values()))
    counted = [k for k, g in ref["grad_norms"].items() if g >= 1e-3 * med_g]
    med_c = _median([ref["change_norms"][k] for k in counted])
    for name, norms, keys, med in (
            ("grad_gap", "grad_norms", list(ref["grad_norms"]), med_g),
            ("change_gap", "change_norms", counted, med_c)):
        worst = 0.0
        for k in keys:
            a, b = got[norms].get(k), ref[norms][k]
            gap = math.inf if a is None else abs(a - b) / max(b, med)
            if not math.isfinite(gap):  # NaN on either side too
                worst = math.inf
                break
            worst = max(worst, gap)
        out[name] = worst
    return out
