"""The plain reference of combined per-class NMS, and the comparison that
judges a served NMSResult against the reference's decode.

Combined NMS, as TensorFlow's combined_non_max_suppression that the
system follows, with the system's class-agnostic prefilter:
  0. keep the M anchors of each image with the highest score over the
     classes (M = nms_prefilter_anchors; ties toward the lower index);
  1. per class, the K highest-scoring of those (K = max_detections_per_
     class), sorted by score, ties toward the lower index;
  2. greedy suppression: a candidate is kept if its score exceeds the
     score threshold and no kept candidate before it overlaps it with
     IoU > nms_iou_threshold;
  3. the kept candidates of all classes merged by score into the top
     max_total_detections rows; classes in the label space 1..L-1, 0 and
     score 0 on padding rows.

This file imports torch and the standard library only.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def _top(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[
        ..., :k]


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., A, 4] x [..., B, 4] corner boxes -> [..., A, B]."""
    a, b = a[..., :, None, :], b[..., None, :, :]
    ih = (torch.minimum(a[..., 2], b[..., 2])
          - torch.maximum(a[..., 0], b[..., 0])).clamp_min(0)
    iw = (torch.minimum(a[..., 3], b[..., 3])
          - torch.maximum(a[..., 1], b[..., 1])).clamp_min(0)
    inter = ih * iw
    area_a = ((a[..., 2] - a[..., 0]).clamp_min(0)
              * (a[..., 3] - a[..., 1]).clamp_min(0))
    area_b = ((b[..., 2] - b[..., 0]).clamp_min(0)
              * (b[..., 3] - b[..., 1]).clamp_min(0))
    return inter / (area_a + area_b - inter).clamp_min(1e-8)


def combined_nms(cfg: dict, boxes: torch.Tensor, scores: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
    """(B, N, 4) boxes, (B, N, C) foreground scores -> {'boxes' (B, T, 4),
    'scores' (B, T), 'classes' (B, T) in 1..C (0 padding), 'valid' (B,)}."""
    b, n, c = scores.shape
    m = cfg["nms_prefilter_anchors"]
    if 0 < m < n:
        sel = _top(scores.amax(dim=-1), m)
        scores = torch.gather(scores, 1, sel[..., None].expand(-1, -1, c))
        boxes = torch.gather(boxes, 1, sel[..., None].expand(-1, -1, 4))
        n = m
    k = min(cfg["max_detections_per_class"], n)
    st = scores.transpose(1, 2)                                  # (B, C, N)
    idx = _top(st, k)                                            # (B, C, K)
    cand_scores = torch.gather(st, 2, idx)
    cand_boxes = torch.gather(
        boxes[:, None].expand(-1, c, -1, -1), 2,
        idx[..., None].expand(-1, -1, -1, 4))                    # (B,C,K,4)
    over = iou(cand_boxes, cand_boxes) > cfg["nms_iou_threshold"]
    later = torch.ones(k, k, dtype=torch.bool,
                       device=scores.device).triu(1)
    over = over & later
    keep = cand_scores > cfg["nms_score_threshold"]
    for i in range(k):
        keep = keep & ~(keep[..., i:i + 1] & over[..., i, :])
    total = min(cfg["max_total_detections"], c * k)
    flat_keep = keep.reshape(b, c * k)
    flat_scores = cand_scores.reshape(b, c * k)
    key = torch.where(flat_keep, flat_scores,
                      torch.full_like(flat_scores, float("-inf")))
    sel = _top(key, total)
    ok = torch.gather(flat_keep, 1, sel)
    out_scores = torch.where(ok, torch.gather(flat_scores, 1, sel),
                             torch.zeros_like(key[:, :total]))
    out_classes = torch.where(ok, sel // k + 1, torch.zeros_like(sel))
    out_boxes = torch.gather(cand_boxes.reshape(b, c * k, 4), 1,
                             sel[..., None].expand(-1, -1, 4))
    out_boxes = torch.where(ok[..., None], out_boxes,
                            torch.zeros_like(out_boxes))
    pad = cfg["max_total_detections"] - total
    if pad:
        out_scores = torch.nn.functional.pad(out_scores, (0, pad))
        out_classes = torch.nn.functional.pad(out_classes, (0, pad))
        out_boxes = torch.nn.functional.pad(out_boxes, (0, 0, 0, pad))
    return {"boxes": out_boxes, "scores": out_scores,
            "classes": out_classes, "valid": ok.sum(dim=-1)}


# Rounding room of the selection check: an IoU of two float32 boxes, and
# a score, may differ from the reference's by this much, so a candidate
# kept or dropped by the other side of a near-tie is not a fault.
IOU_SLACK = 1e-4
SCORE_SLACK = 1e-4


def _image(cfg: dict, ref_boxes: torch.Tensor, ref_scores: torch.Tensor,
           boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
           v: int) -> Tuple[float, float]:
    """(det_gap, sel_gap) of one image's v served detections."""
    n, c = ref_scores.shape
    if v == 0:
        served_anchor = torch.zeros(0, dtype=torch.long,
                                    device=ref_scores.device)
        cls = served_anchor
        det = 0.0
    else:
        cls = classes[:v].long() - 1
        box = boxes[:v].to(ref_boxes.dtype)
        score = scores[:v].to(ref_scores.dtype)
        d = (ref_scores[:, cls] - score[None, :]).abs()          # (N, V)
        for j in range(4):
            d = torch.maximum(d, (ref_boxes[:, j, None]
                                  - box[None, :, j]).abs())
        best, served_anchor = d.min(dim=0)
        det = float(best.max())
        if not math.isfinite(det):
            return math.inf, math.inf
    # the served detections as (anchor, class) of the reference
    key = served_anchor * c + cls
    if len(torch.unique(key)) != len(key):
        return det, math.inf
    thr = cfg["nms_iou_threshold"]
    sb = ref_boxes[served_anchor]                                # (V, 4)
    ss = ref_scores[served_anchor, cls]                          # (V,)
    # 1. no two served detections of one class overlap beyond the
    #    threshold (the later one would have been suppressed)
    same = (cls[:, None] == cls[None, :]) & ~torch.eye(
        len(cls), dtype=torch.bool, device=cls.device)
    over = torch.where(same, iou(sb, sb), torch.zeros((), dtype=sb.dtype,
                                                      device=sb.device))
    sel = max(0.0, float(over.max()) - thr) if len(cls) > 1 else 0.0
    # 2. every candidate left out is explained: cut by the prefilter, by
    #    its class's top-K, by the merge's cut, or suppressed by a served
    #    detection of its class that scores at least as high
    m = ref_scores.amax(dim=-1)
    prefilter = cfg["nms_prefilter_anchors"]
    m_cut = (torch.topk(m, prefilter).values[-1] if 0 < prefilter < n
             else torch.tensor(float("-inf"), dtype=m.dtype,
                               device=m.device))
    k = cfg["max_detections_per_class"]
    kept = torch.where((m >= m_cut)[:, None], ref_scores,
                       torch.full_like(ref_scores, float("-inf")))
    k_cut = (torch.topk(kept, k, dim=0).values[-1] if k < kept.shape[0]
             else torch.full((c,), float("-inf"), dtype=m.dtype,
                             device=m.device))                   # (C,)
    full = v >= cfg["max_total_detections"]
    cut = float(ss.min()) if full and v else cfg["nms_score_threshold"]
    excess = torch.minimum(torch.minimum(
        (m - m_cut)[:, None].expand(-1, c), ref_scores - k_cut[None, :]),
        ref_scores - cut)                                        # (N, C)
    if v:
        overlap = iou(ref_boxes, sb) > thr - IOU_SLACK           # (N, V)
        for cl in torch.unique(cls).tolist():
            mask = cls == cl
            sup = (overlap[:, mask]
                   & (ss[mask][None, :] >= ref_scores[:, cl, None]
                      - SCORE_SLACK)).any(dim=1)
            excess[:, cl] = torch.where(sup, torch.zeros_like(
                excess[:, cl]), excess[:, cl])
        excess[served_anchor, cls] = 0.0
    sel = max(sel, float(excess.max().clamp_min(0.0)))
    return det, sel


def judge(cfg: dict, ref_boxes: torch.Tensor, ref_scores: torch.Tensor,
          served: Tuple) -> Dict[str, float]:
    """The numbers of one request, each the worst over its images, for
    `served` = (boxes, scores, classes, valid) as the program returned
    them, on the reference's device:

    det_gap: the widest distance from a served detection (box, score,
    class c) to the reference's decode: the least over the anchors a of
    max(|ref box a - box|_inf, |ref score of (a, c) - score|). A detection
    that no anchor of its class produced reads far from 0; one that the
    reference's decode produced reads its rounding.

    sel_gap: how far the served selection is from one that greedy combined
    NMS could make from the reference's values, near-ties aside (each
    served detection is taken as the anchor det_gap found for it): the
    largest IoU beyond the threshold between two served detections of one
    class, and the largest score by which a candidate left out beats
    every cut that could have left it out (the prefilter's, its class's
    top-K, the merge's; or a served detection of its class scoring at
    least as high that overlaps it beyond the threshold). A suppression or
    a cut decided the other way by rounding reads its rounding, and so do
    the changes it sets off; a candidate dropped, or an image whose
    detections are missing, reads its score.

    Non-finite values, classes outside 1..C, more valid rows than rows
    and a detection served twice read infinity."""
    boxes, scores, classes, valid = served
    worst = {"det_gap": 0.0, "sel_gap": 0.0}
    num_classes = ref_scores.shape[-1]
    for i in range(ref_scores.shape[0]):
        v = int(valid[i])
        bad = v > scores.shape[1] or v < 0 or bool(
            ((classes[i, :v] < 1) | (classes[i, :v] > num_classes)).any())
        if bad or not bool(torch.isfinite(scores[i, :v]).all()):
            return {"det_gap": math.inf, "sel_gap": math.inf}
        det, sel = _image(cfg, ref_boxes[i], ref_scores[i], boxes[i],
                          scores[i], classes[i], v)
        worst["det_gap"] = max(worst["det_gap"], det)
        worst["sel_gap"] = max(worst["sel_gap"], sel)
    return worst
