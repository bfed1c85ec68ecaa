"""Prediction decoding: deltas + logits -> detections (port of the JAX
package's models/decoder.py; reference: models/decoder.py).

Variance-scaled delta decode, clip to [0, 1], softmax with the background
column dropped, combined per-class NMS, classes shifted +1 into the label
space (1..L-1; padding rows are class 0, score 0).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from tfssd_torch.config import SSDConfig
from tfssd_torch.ops import boxes as box_ops
from tfssd_torch.ops.nms import NMSResult, combined_nms


def preprocess_images(images: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] or float [0, 1] -> float32 [-1, 1] (the JAX package's
    train.preprocess_images)."""
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    return images * 2.0 - 1.0


def decode_boxes_and_scores(
    anchors: torch.Tensor, pred_deltas: torch.Tensor,
    pred_logits: torch.Tensor, config: SSDConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N, 4) deltas, (B, N, L) logits -> clipped corner boxes (B, N, 4)
    and foreground scores (B, N, L-1)."""
    boxes = box_ops.clip_boxes(
        box_ops.decode(anchors, pred_deltas, config.variances))
    scores = torch.softmax(pred_logits, dim=-1)[..., 1:]
    return boxes, scores


def decode_predictions(anchors: torch.Tensor, pred_deltas: torch.Tensor,
                       pred_logits: torch.Tensor,
                       config: SSDConfig) -> NMSResult:
    """Decode + NMS, classes in the 1-based label space."""
    boxes, scores = decode_boxes_and_scores(anchors, pred_deltas,
                                            pred_logits, config)
    res = combined_nms(
        boxes, scores,
        max_detections_per_class=config.max_detections_per_class,
        max_total_detections=config.max_total_detections,
        iou_threshold=config.nms_iou_threshold,
        score_threshold=config.nms_score_threshold,
        prefilter_anchors=config.nms_prefilter_anchors,
    )
    shifted = torch.where(res.classes >= 0, res.classes + 1,
                          torch.zeros_like(res.classes))
    return res._replace(classes=shifted)


def make_predict_fn(model: torch.nn.Module, anchors: np.ndarray,
                    config: SSDConfig
                    ) -> Callable[[torch.Tensor], NMSResult]:
    """predict(images) -> NMSResult, for uint8 (B, H, W, 3) images (or
    float in [0, 1]) on the model's device: preprocess, forward, decode,
    NMS, without autograd."""
    device = next(model.parameters()).device
    anchors_t = torch.as_tensor(anchors, dtype=torch.float32, device=device)

    @torch.no_grad()
    def predict(images: torch.Tensor) -> NMSResult:
        deltas, logits = model(preprocess_images(images))
        return decode_predictions(anchors_t, deltas, logits, config)

    return predict
