"""Mask R-CNN with a ResNet-50 FPN trunk: torchvision's
maskrcnn_resnet50_fpn (v1), from Mask R-CNN (He et al., arXiv:1703.06870),
Faster R-CNN's region proposals and box head (Ren et al.,
arXiv:1506.01497), the feature pyramid of Lin et al. (arXiv:1612.03144)
and ResNet-50 (He et al., arXiv:1512.03385). It has no counterpart in the
JAX package; its reference is the benchmark's plain
portbench/reference/maskrcnn.py. Boxes are pixels, x-first [x0, y0, x1,
y1], as torchvision's.

  trunk: models/retinanet.py's ResNeXt at groups 1 (ResNet-50 v1.5: the
  stride on the 3x3), frozen BatchNorm folded for serving; C2-C5.
  FPN: models/retinanet.py's FPN over C2-C5 (1x1 laterals, nearest
  top-down path, 3x3 outputs, all with bias), P6 = max_pool2d(P5, 1, 2).
  RPN head, one set of weights over P2-P6: 3x3 conv with bias, ReLU; 1x1
  convs to A objectness logits and A x 4 deltas (dx, dy, dw, dh);
  location-major, anchor next, the levels concatenated P2 first.
  Proposals: models/decoder.py:rpn_proposals.
  Box head: RoIAlign of each proposal on its level of P2-P5 (roi_levels)
  to 7x7, sampling ratio 2 (tfssd::roi_align); flattened (C, H, W); fc6
  and fc7 with ReLU; cls_score to num_classes logits, bbox_pred to
  num_classes x 4 deltas.
  Detections: models/decoder.py:box_detections.
  Mask head: RoIAlign of each detection to 14x14; 4 x (3x3 conv with bias,
  ReLU); a 2x2 stride-2 transposed conv with bias, ReLU; a 1x1 conv to
  num_classes; sigmoid of the detection's class.

Parameter names follow the benchmark's Flax-style tree (backbone.layer1.
block0.conv2.conv, fpn.inner2, rpn.conv, box_head.fc6, mask_head.
mask_fcn1, mask_head.conv5_mask, ...), so utils/convert.py:load_variables
loads it; a Dense kernel is (in, out), and the transposed conv's kernel is
stored (kH, kW, out, in), which convert.py's transpose turns into
ConvTranspose2d's (in, out, kH, kW). `forward` takes NHWC images already
normalised and padded (models/decoder.py) and the anchors, and returns a
MaskRCNNResult; under a torch profiler it records the spans `trunk`,
`fpn`, `rpn`, `proposals`, `box_head`, `decode`, `select`, `keep`,
`merge` and `mask_head`, and the counters `rpn/proposals`,
`select/candidates` and `mask/detections` (utils/profiling.py).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tfssd_torch.config import MaskRCNNConfig
from tfssd_torch.models.decoder import (MaskRCNNResult, box_detections,
                                        rpn_proposals)
from tfssd_torch.models.retinanet import FPN, ResNeXt, _conv
from tfssd_torch.ops.kernels.roi_align import roi_align
from tfssd_torch.utils import profiling


def roi_levels(boxes: torch.Tensor, config: MaskRCNNConfig) -> torch.Tensor:
    """torchvision's LevelMapper: (..., 4) pixel boxes -> the index into
    the pooled levels, floor(canonical level + log2(sqrt(area) / canonical
    scale) + 1e-6) clamped to them, in the boxes' dtype (the 1e-6 too,
    held on the host: a tensor made on the card would make the host wait
    for it)."""
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    eps = torch.tensor(1e-6, dtype=boxes.dtype)
    level = torch.floor(config.roi_canonical_level + torch.log2(
        torch.sqrt(area) / config.roi_canonical_scale) + eps)
    lo, hi = config.roi_levels[0], config.roi_levels[-1]
    return level.clamp(lo, hi).to(torch.int64) - lo


class RPNHead(nn.Module):
    """(P2-P6) -> (objectness (B, N), deltas (B, N, 4))."""

    def __init__(self, channels: int, anchors: int):
        super().__init__()
        self.anchors = anchors
        self.conv = _conv(channels, channels, 3)
        self.cls_logits = _conv(channels, anchors, 1)
        self.bbox_pred = _conv(channels, anchors * 4, 1)

    def forward(self, maps: List[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        logits, deltas = [], []
        for m in maps:
            t = F.relu(self.conv(m))
            o, d = self.cls_logits(t), self.bbox_pred(t)
            b, _, h, w = o.shape
            logits.append(o.permute(0, 2, 3, 1).reshape(b, -1))
            deltas.append(d.view(b, self.anchors, 4, h, w)
                          .permute(0, 3, 4, 1, 2).reshape(b, -1, 4))
        return torch.cat(logits, dim=1), torch.cat(deltas, dim=1)


class BoxHead(nn.Module):
    """(R, C, 7, 7) pooled -> (class logits (R, classes), deltas (R,
    classes, 4)): TwoMLPHead and FastRCNNPredictor."""

    def __init__(self, config: MaskRCNNConfig):
        super().__init__()
        c, r = config.fpn_channels, config.representation_size
        self.fc6 = nn.Linear(c * config.box_roi_size ** 2, r)
        self.fc7 = nn.Linear(r, r)
        self.cls_score = nn.Linear(r, config.num_classes)
        self.bbox_pred = nn.Linear(r, config.num_classes * 4)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = F.relu(self.fc7(F.relu(self.fc6(x.flatten(1)))))
        return self.cls_score(x), self.bbox_pred(x).view(x.shape[0], -1, 4)


class MaskHead(nn.Module):
    """(R, C, 14, 14) pooled -> (R, classes, 28, 28) mask logits:
    MaskRCNNHeads and MaskRCNNPredictor."""

    def __init__(self, config: MaskRCNNConfig):
        super().__init__()
        cin = config.fpn_channels
        for i, cout in enumerate(config.mask_layers, 1):
            self.add_module(f"mask_fcn{i}", _conv(cin, cout, 3))
            cin = cout
        self.conv5_mask = nn.ConvTranspose2d(cin, cin, 2, 2)
        self.mask_fcn_logits = _conv(cin, config.num_classes, 1)
        self.layers = len(config.mask_layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, self.layers + 1):
            x = F.relu(getattr(self, f"mask_fcn{i}")(x))
        return self.mask_fcn_logits(F.relu(self.conv5_mask(x)))


class MaskRCNN(nn.Module):
    """(B, H, W, 3) normalised, padded images and the anchors ->
    MaskRCNNResult."""

    def __init__(self, config: MaskRCNNConfig):
        super().__init__()
        config.validate()
        self.config = config
        self.backbone = ResNeXt(config)
        self.fpn = FPN(config.stage_channels, config.fpn_channels,
                       first_level=2, p6p7=False)
        self.rpn = RPNHead(config.fpn_channels, config.anchors_per_cell)
        self.box_head = BoxHead(config)
        self.mask_head = MaskHead(config)

    def features(self, images: torch.Tensor) -> List[torch.Tensor]:
        """NHWC images -> [P2, ..., P6] (spans `trunk` and `fpn`)."""
        with profiling.span("trunk"):
            feats = self.backbone(images.permute(0, 3, 1, 2).contiguous())
        with profiling.span("fpn"):
            maps = self.fpn(feats)
        for m, shape in zip(maps, self.config.feature_map_shapes):
            if tuple(m.shape[-2:]) != tuple(shape):
                raise ValueError(f"a pyramid level is {tuple(m.shape)}, "
                                 f"expected {tuple(shape)}")
        return maps

    def pool(self, maps: List[torch.Tensor], boxes: torch.Tensor,
             size: int) -> torch.Tensor:
        """(B, K, 4) boxes pooled on their levels of P2-P5 -> (B * K, C,
        size, size)."""
        cfg = self.config
        pooled = roi_align(maps[:len(cfg.roi_levels)], boxes.contiguous(),
                           roi_levels(boxes, cfg), list(cfg.roi_scales), size,
                           cfg.roi_sampling_ratio)
        return pooled.flatten(0, 1)

    def masks(self, maps: List[torch.Tensor], boxes: torch.Tensor,
              classes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """The mask head on (B, D, 4) detections -> (B, D, M, M) sigmoid
        maps of each detection's class, zeros past `valid` (span
        `mask_head`)."""
        b, d = classes.shape
        with profiling.span("mask_head"):
            logits = self.mask_head(self.pool(maps, boxes,
                                              self.config.mask_roi_size))
            m = logits.shape[-1]
            pick = torch.gather(logits.view(b, d, -1, m, m), 2,
                                classes.long().view(b, d, 1, 1, 1).expand(
                                    -1, -1, 1, m, m))[:, :, 0]
            live = torch.arange(d, device=valid.device) < valid[:, None]
            out = torch.where(live[..., None, None], torch.sigmoid(pick),
                              0.0)
            if profiling.recording():
                profiling.count("mask/detections", valid.sum())
        return out

    def forward(self, images: torch.Tensor, anchors: torch.Tensor
                ) -> MaskRCNNResult:
        cfg = self.config
        maps = self.features(images)
        with profiling.span("rpn"):
            objectness, deltas = self.rpn(maps)
        proposals, proposal_scores, count = rpn_proposals(
            anchors, objectness, deltas, cfg)
        b, k = proposal_scores.shape
        with profiling.span("box_head"):
            logits, box_deltas = self.box_head(
                self.pool(maps, proposals, cfg.box_roi_size))
        det = box_detections(proposals, count, logits.view(b, k, -1),
                             box_deltas.view(b, k, -1, 4), cfg)
        masks = self.masks(maps, det.boxes, det.classes, det.valid)
        return MaskRCNNResult(*det, masks, proposals, proposal_scores, count)
