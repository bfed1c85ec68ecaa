"""VOC mAP@0.5 evaluation (a numpy copy of the JAX package's evaluate.py;
reference: utils/eval_utils.py:evaluate_predictions).

Per class, score-ordered TP/FP assignment at IoU >= 0.5 against the gt
(each gt matched at most once), precision/recall curve -> AP; difficult gt
boxes are ignored (neither TP nor FP). VOC2007 11-point interpolation by
default, continuous (VOC2010+) area under the curve on request.
`detection_agreement` (the port's own) compares two serving paths'
detections.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def _iou_1many(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    iy0 = np.maximum(box[0], boxes[:, 0])
    ix0 = np.maximum(box[1], boxes[:, 1])
    iy1 = np.minimum(box[2], boxes[:, 2])
    ix1 = np.minimum(box[3], boxes[:, 3])
    inter = np.maximum(iy1 - iy0, 0) * np.maximum(ix1 - ix0, 0)
    a = max((box[2] - box[0]) * (box[3] - box[1]), 0.0)
    b = np.maximum(boxes[:, 2] - boxes[:, 0], 0) * np.maximum(
        boxes[:, 3] - boxes[:, 1], 0)
    return inter / np.maximum(a + b - inter, 1e-8)


def average_precision(recall: np.ndarray, precision: np.ndarray,
                      use_07_metric: bool = True) -> float:
    """Mirror of reference eval_utils.calculate_ap."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = float(np.max(precision[recall >= t])) if np.any(
                recall >= t) else 0.0
            ap += p / 11.0
        return ap
    # continuous AUC
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def evaluate_predictions(
    gt_by_image: Sequence[Dict],
    det_by_image: Sequence[Dict],
    num_classes: int = 20,
    iou_threshold: float = 0.5,
    use_07_metric: bool = True,
    class_names: Optional[Sequence[str]] = None,
    verbose: bool = True,
) -> Dict:
    """Compute per-class AP and mAP.

    gt_by_image[i]: {'boxes' (G,4) normalized corners, 'labels' (G,) in
    [1, C], 'difficult' (G,) bool}. det_by_image[i]: {'boxes' (D,4),
    'scores' (D,), 'classes' (D,) in [1, C]} — the NMSResult rows for that
    image (padding rows with score 0 are ignored).

    Mirror of reference eval_utils.evaluate_predictions.
    """
    assert len(gt_by_image) == len(det_by_image)
    aps: Dict[int, float] = {}
    for cls in range(1, num_classes + 1):
        # Gather gt of this class.
        gt_map = {}
        npos = 0
        for i, gt in enumerate(gt_by_image):
            labels = np.asarray(gt["labels"])
            mask = labels == cls
            boxes = np.asarray(gt["boxes"], np.float32).reshape(-1, 4)[mask]
            if "difficult" in gt:
                difficult = np.asarray(gt["difficult"])
                if len(difficult) != len(labels):
                    # a length mismatch (e.g. unpadded difficult next to
                    # padded labels) is a caller bug; silently treating
                    # it as all-non-difficult would count difficult
                    # objects as false negatives and deflate AP with no
                    # warning (r5 review)
                    raise ValueError(
                        f"gt['difficult'] length {len(difficult)} != "
                        f"labels length {len(labels)} for image {i}")
            else:
                difficult = np.zeros(len(labels), bool)
            difficult = difficult[mask]
            gt_map[i] = (boxes, difficult, np.zeros(len(boxes), bool))
            npos += int((~difficult).sum())

        # Gather detections of this class across images, sort by score.
        rows = []
        for i, det in enumerate(det_by_image):
            cls_mask = (np.asarray(det["classes"]) == cls) & (
                np.asarray(det["scores"]) > 0)
            for b, s in zip(np.asarray(det["boxes"])[cls_mask],
                            np.asarray(det["scores"])[cls_mask]):
                rows.append((float(s), i, b))
        rows.sort(key=lambda r: -r[0])

        tp = np.zeros(len(rows))
        fp = np.zeros(len(rows))
        for d, (score, img_idx, box) in enumerate(rows):
            boxes, difficult, used = gt_map[img_idx]
            if len(boxes) == 0:
                fp[d] = 1
                continue
            ious = _iou_1many(np.asarray(box, np.float32), boxes)
            j = int(np.argmax(ious))
            if ious[j] >= iou_threshold:
                if difficult[j]:
                    continue  # ignore: neither tp nor fp
                if not used[j]:
                    tp[d] = 1
                    used[j] = True
                else:
                    fp[d] = 1  # duplicate detection of a matched gt
            else:
                fp[d] = 1

        if npos == 0:
            aps[cls] = float("nan")
            continue
        ctp, cfp = np.cumsum(tp), np.cumsum(fp)
        recall = ctp / npos
        precision = ctp / np.maximum(ctp + cfp, 1e-8)
        aps[cls] = average_precision(recall, precision, use_07_metric)

    valid = [v for v in aps.values() if not np.isnan(v)]
    mean_ap = float(np.mean(valid)) if valid else 0.0
    if verbose:
        for cls, ap in aps.items():
            name = (class_names[cls] if class_names and cls < len(class_names)
                    else f"class_{cls}")
            print(f"  AP@{iou_threshold:.2f} {name:>14s}: "
                  f"{'n/a' if np.isnan(ap) else f'{ap:.4f}'}")
        print(f"  mAP@{iou_threshold:.2f}: {mean_ap:.4f}")
    return {"ap": aps, "map": mean_ap}


def detections_from_nms_result(res, num_valid: Optional[int] = None
                               ) -> List[Dict]:
    """Split a batched NMSResult into per-image detection dicts."""
    boxes = np.asarray(res.boxes)
    scores = np.asarray(res.scores)
    classes = np.asarray(res.classes)
    n = num_valid if num_valid is not None else boxes.shape[0]
    return [
        {"boxes": boxes[i], "scores": scores[i], "classes": classes[i]}
        for i in range(n)
    ]


def detection_agreement(got, want) -> float:
    """Share of the detections of two NMSResults (numpy, (B, T, ...)) that
    the other one also reports: a detection scoring at least 0.05 agrees
    when the other result holds one of the same class in the same image at
    IoU >= 0.5 scoring at least 0.025. The smaller of the two directions;
    1.0 when neither has such a detection. Two serving paths that round
    differently (bfloat16 on two devices) are held by it, where their junk
    tails below 0.05 may reorder."""
    min_score, min_iou = 0.05, 0.5
    shares = []
    for a, b in ((got, want), (want, got)):
        hits = total = 0
        for i in range(len(a.valid)):
            bn = int(b.valid[i])
            b_ok = b.scores[i, :bn] >= min_score / 2
            for j in range(int(a.valid[i])):
                if a.scores[i, j] < min_score:
                    continue
                total += 1
                same = b_ok & (b.classes[i, :bn] == a.classes[i, j])
                if same.any() and _iou_1many(
                        a.boxes[i, j], b.boxes[i, :bn][same]).max() \
                        >= min_iou:
                    hits += 1
        shares.append(hits / total if total else 1.0)
    return min(shares)
