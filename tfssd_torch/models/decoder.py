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

A MaskRCNNConfig's predict is two-stage (models/maskrcnn.py): images
scaled, normalised and padded with zeros to the padded size
(`preprocess`), then the model's forward (`forward`) runs the trunk, the
FPN and the RPN head, rpn_proposals (span `proposals`: each level's top-k
objectness logits, decode, clip, NMS by level through classwise_nms, whose
`keep` and `merge` spans record inside it, the top proposals; counter
`rpn/proposals`), the box head on them, box_detections (torchvision's
postprocess_detections: `decode`, `select` with counter
`select/candidates`, then classwise_nms's `keep` and `merge`) and the
mask head on the detections. It replies a MaskRCNNResult. Nothing is read
back between the stages: the counts stay on the device and every shape is
the static cap's.
"""

from __future__ import annotations

import functools
import itertools
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from tfssd_torch.config import MaskRCNNConfig, RetinaNetConfig, SSDConfig
from tfssd_torch.ops import boxes as box_ops
from tfssd_torch.ops.nms import NMSResult, classwise_nms, combined_nms
from tfssd_torch.utils import profiling


class MaskRCNNResult(NamedTuple):
    """Mask R-CNN's reply: the NMSResult's fields over the top detections
    (pixel boxes [x0, y0, x1, y1] in the frame, classes 1..num_classes - 1
    and 0 on padding), each detection's mask of its class (sigmoid
    probabilities on the mask head's grid, not pasted into the frame), and
    the proposals the box head pooled with their objectness and count."""

    boxes: torch.Tensor            # (B, D, 4), zeros on padding
    scores: torch.Tensor           # (B, D), 0 on padding
    classes: torch.Tensor          # (B, D) int32
    valid: torch.Tensor            # (B,) int32
    masks: torch.Tensor            # (B, D, M, M), zeros on padding
    proposals: torch.Tensor        # (B, K, 4), zeros on padding
    proposal_scores: torch.Tensor  # (B, K) sigmoid objectness
    proposal_count: torch.Tensor   # (B,) int32


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


def rpn_proposals(anchors: torch.Tensor, objectness: torch.Tensor,
                  deltas: torch.Tensor, config: MaskRCNNConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """torchvision's RegionProposalNetwork.filter_proposals (module
    docstring), static: (N, 4) pixel anchors, (B, N) objectness logits and
    (B, N, 4) deltas -> the top rpn_post_nms_top_n proposals (B, K, 4),
    their sigmoid scores (B, K) and count (B,), zeros past the count. The
    top-k of a level is taken over the logits, whose order sigmoid keeps;
    a candidate too small or scoring under rpn_score_threshold takes no
    part in the NMS."""
    h, w = config.image_size
    with profiling.span("proposals"):
        idx, levels, at = [], [], 0
        for level, n in enumerate(config.anchors_per_map):
            top = torch.topk(objectness[:, at:at + n],
                             min(config.rpn_pre_nms_top_n, n), dim=1)[1]
            idx.append(top + at)
            levels.append(torch.full_like(top, level))
            at += n
        idx, levels = torch.cat(idx, dim=1), torch.cat(levels, dim=1)
        scores = torch.sigmoid(torch.gather(objectness, 1, idx))
        boxes = box_ops.clip_to_frame(box_ops.decode_pixels(
            anchors[idx], torch.gather(
                deltas, 1, idx[..., None].expand(-1, -1, 4)),
            config.rpn_box_weights, config.box_clamp), h, w)
        ok = (box_ops.large_enough(boxes, config.rpn_min_size)
              & (scores >= config.rpn_score_threshold))
        res = classwise_nms(
            boxes, torch.where(ok, scores, float("-inf")), levels,
            len(config.anchors_per_map), config.rpn_nms_iou_threshold,
            float("-inf"), config.rpn_post_nms_top_n,
            config.rpn_pre_nms_top_n)
        if profiling.recording():
            profiling.count("rpn/proposals", res.valid.sum())
    return res.boxes, res.scores, res.valid


def box_detections(proposals: torch.Tensor, count: torch.Tensor,
                   class_logits: torch.Tensor, box_deltas: torch.Tensor,
                   config: MaskRCNNConfig) -> NMSResult:
    """torchvision's RoIHeads.postprocess_detections, static: (B, K, 4)
    proposals with their count (B,), (B, K, C) class logits and (B, K, C,
    4) deltas -> the top box_detections_per_img detections, classes
    1..C-1. Every (proposal, foreground class) pair is a candidate (T =
    K (C - 1) an image, at most K in a class); a pair of a padding
    proposal, or whose box has a side under box_min_size, takes no part."""
    b, k, c = class_logits.shape
    h, w = config.image_size
    with profiling.span("decode"):
        boxes = box_ops.clip_to_frame(box_ops.decode_pixels(
            proposals[:, :, None, :], box_deltas, config.box_weights,
            config.box_clamp), h, w)[:, :, 1:]
        scores = torch.softmax(class_logits, dim=-1)[:, :, 1:]
    with profiling.span("select"):
        live = torch.arange(k, device=count.device) < count[:, None]
        ok = live[..., None] & box_ops.large_enough(boxes,
                                                    config.box_min_size)
        scores = torch.where(ok, scores, 0.0).reshape(b, k * (c - 1))
        classes = torch.arange(c - 1, device=scores.device).repeat(k)
        if profiling.recording():
            profiling.count("select/candidates",
                            (scores > config.box_score_threshold).sum())
    return classwise_nms(boxes.reshape(b, k * (c - 1), 4), scores,
                         classes.expand(b, -1), c - 1,
                         config.box_nms_iou_threshold,
                         config.box_score_threshold,
                         config.box_detections_per_img, k)


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


def pad_images(images: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NHWC images padded with zeros on the bottom and the right to
    `size` (torchvision's batch_images, after normalisation)."""
    h, w = images.shape[1:3]
    return torch.nn.functional.pad(images, (0, 0, 0, size[1] - w, 0,
                                            size[0] - h))


def make_predict_fn(model: torch.nn.Module, anchors: np.ndarray,
                    config: SSDConfig
                    ) -> Callable[[torch.Tensor], NMSResult]:
    """predict(images) -> NMSResult, for uint8 (B, H, W, 3) images (or
    float in [0, 1]) on the model's device: preprocess, forward, decode,
    NMS, without autograd; for a MaskRCNNConfig -> MaskRCNNResult (module
    docstring)."""
    device = next(model.parameters()).device
    anchors_t = torch.as_tensor(anchors, dtype=torch.float32, device=device)
    calls = itertools.count()
    prep = preprocess_images
    if isinstance(config, (RetinaNetConfig, MaskRCNNConfig)):
        mean, std = (torch.tensor(v, dtype=torch.float32, device=device)
                     for v in (config.image_mean, config.image_std))
        prep = functools.partial(normalize_images, mean=mean, std=std)
    if isinstance(config, MaskRCNNConfig):
        @torch.no_grad()
        def predict_two_stage(images: torch.Tensor) -> MaskRCNNResult:
            with profiling.span("predict", next(calls)):
                with profiling.span("preprocess"):
                    x = pad_images(prep(images), config.padded_size)
                with profiling.span("forward"):
                    return model(x, anchors_t)

        return predict_two_stage

    @torch.no_grad()
    def predict(images: torch.Tensor) -> NMSResult:
        with profiling.span("predict", next(calls)):
            with profiling.span("preprocess"):
                x = prep(images)
            with profiling.span("forward"):
                deltas, logits = model(x)
            return decode_predictions(anchors_t, deltas, logits, config)

    return predict
