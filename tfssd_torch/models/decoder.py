"""Prediction decoding: deltas + logits -> detections (port of the JAX
package's models/decoder.py; reference: models/decoder.py).

Variance-scaled delta decode, clip to [0, 1], softmax with the background
column dropped, combined per-class NMS, classes shifted +1 into the label
space (1..L-1; padding rows are class 0, score 0).

Under a torch profiler, predict records the span `predict` (id: its call
count) and under it `preprocess`, `forward`, `decode` and combined NMS's
`select`, `keep` and `merge` (utils/profiling.py).

A RetinaNetConfig takes RetinaNet's path instead (torchvision's
postprocess_detections): images scaled to [0, 1] and normalised by the
configuration's mean and std; per image and level the (anchor, class)
pairs scoring sigmoid(logit) > score_threshold, their top topk_candidates
(span `select`, counter `select/candidates`: the candidates entering NMS,
summed over the images); those anchors decoded and clipped (`decode`);
class-wise NMS and the top detections (ops/nms.py:classwise_nms, `keep`
and `merge`). Classes come back in the label space, 1..num_classes.
"""

from __future__ import annotations

import functools
import itertools
from typing import Callable, Tuple

import numpy as np
import torch

from tfssd_torch.config import RetinaNetConfig, SSDConfig
from tfssd_torch.ops import boxes as box_ops
from tfssd_torch.ops.nms import NMSResult, classwise_nms, combined_nms
from tfssd_torch.utils import profiling


def preprocess_images(images: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] or float [0, 1] -> float32 [-1, 1] (the JAX package's
    train.preprocess_images)."""
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    return images * 2.0 - 1.0


def normalize_images(images: torch.Tensor, mean: torch.Tensor,
                     std: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] (or float [0, 1]) NHWC -> (x - mean) / std per
    channel, in float32 (torchvision's ToTensor and Normalize)."""
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    return (images - mean) / std


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


def retinanet_candidates(anchors: torch.Tensor, deltas: torch.Tensor,
                         logits: torch.Tensor, config: RetinaNetConfig
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RetinaNet's selection and decode (module docstring): (B, T, 4)
    boxes, (B, T) scores and (B, T) 0-based classes of each image's T
    candidates, T = the levels' top-k counts summed. The top-k of a level
    is taken over its logits, as sigmoid keeps their order, and the
    threshold (in classwise_nms) over the selected scores: the pairs above
    it are a prefix of that order, so this is the top-k of those pairs."""
    b, _, c = logits.shape
    with profiling.span("select"):
        scores, pairs, at = [], [], 0
        for n in config.anchors_per_map:
            level = logits[:, at:at + n].reshape(b, n * c)
            top, idx = torch.topk(level, min(config.topk_candidates, n * c),
                                  dim=1)
            scores.append(torch.sigmoid(top))
            pairs.append(idx + at * c)
            at += n
        scores, pairs = torch.cat(scores, dim=1), torch.cat(pairs, dim=1)
        if profiling.recording():
            profiling.count("select/candidates",
                            (scores > config.score_threshold).sum())
    with profiling.span("decode"):
        anchor = torch.div(pairs, c, rounding_mode="floor")
        boxes = box_ops.decode_retinanet(
            anchors[anchor], torch.gather(
                deltas, 1, anchor[..., None].expand(-1, -1, 4)), config)
    return boxes, scores, pairs - anchor * c


def retinanet_detections(anchors: torch.Tensor, deltas: torch.Tensor,
                         logits: torch.Tensor,
                         config: RetinaNetConfig) -> NMSResult:
    """RetinaNet's selection, decode and class-wise NMS (module
    docstring)."""
    boxes, scores, classes = retinanet_candidates(anchors, deltas, logits,
                                                  config)
    return classwise_nms(boxes, scores, classes, logits.shape[-1],
                         config.nms_iou_threshold, config.score_threshold,
                         config.max_total_detections)


def decode_predictions(anchors: torch.Tensor, pred_deltas: torch.Tensor,
                       pred_logits: torch.Tensor,
                       config: SSDConfig) -> NMSResult:
    """Decode + NMS, classes in the 1-based label space; a RetinaNetConfig
    takes retinanet_detections."""
    if isinstance(config, RetinaNetConfig):
        return retinanet_detections(anchors, pred_deltas, pred_logits,
                                    config)
    with profiling.span("decode"):
        boxes, scores = decode_boxes_and_scores(anchors, pred_deltas,
                                                pred_logits, config)
    return combined_nms(
        boxes, scores,
        max_detections_per_class=config.max_detections_per_class,
        max_total_detections=config.max_total_detections,
        iou_threshold=config.nms_iou_threshold,
        score_threshold=config.nms_score_threshold,
        prefilter_anchors=config.nms_prefilter_anchors,
        label_space=True,
    )


def make_predict_fn(model: torch.nn.Module, anchors: np.ndarray,
                    config: SSDConfig
                    ) -> Callable[[torch.Tensor], NMSResult]:
    """predict(images) -> NMSResult, for uint8 (B, H, W, 3) images (or
    float in [0, 1]) on the model's device: preprocess, forward, decode,
    NMS, without autograd."""
    device = next(model.parameters()).device
    anchors_t = torch.as_tensor(anchors, dtype=torch.float32, device=device)
    calls = itertools.count()
    prep = preprocess_images
    if isinstance(config, RetinaNetConfig):
        mean, std = (torch.tensor(v, dtype=torch.float32, device=device)
                     for v in (config.image_mean, config.image_std))
        prep = functools.partial(normalize_images, mean=mean, std=std)

    @torch.no_grad()
    def predict(images: torch.Tensor) -> NMSResult:
        with profiling.span("predict", next(calls)):
            with profiling.span("preprocess"):
                x = prep(images)
            with profiling.span("forward"):
                deltas, logits = model(x)
            return decode_predictions(anchors_t, deltas, logits, config)

    return predict
