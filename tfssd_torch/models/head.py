"""Multibox prediction heads (port of the JAX package's models/head.py;
reference: models/header.py:get_head_from_outputs).

Per feature map a 3x3 conv to boxes_per_cell * 4 localization channels and
a 3x3 conv to boxes_per_cell * total_labels class channels. The Flax head
reshapes NHWC (B, H, W, bpc*4) to (B, H*W*bpc, 4); here the NCHW output is
permuted to NHWC first, or the anchor order would break. The convs run in
the compute dtype (models/layers.py); the concatenated outputs are cast to
float32, as the JAX head casts them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from tfssd_torch.config import SSDConfig
from tfssd_torch.models.layers import SameConv2d


class MultiboxHead(nn.Module):
    """Per-map loc/cls convs + reshape/concat over the feature maps."""

    def __init__(self, config: SSDConfig, in_channels: Sequence[int],
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if len(in_channels) != len(config.feature_map_shapes):
            raise ValueError("one input width per feature map")
        self.config = config
        dt = dict(compute_dtype=compute_dtype)
        for k, (c, bpc) in enumerate(zip(in_channels,
                                         config.boxes_per_cell)):
            self.add_module(f"loc_{k}", SameConv2d(c, bpc * 4, 3, **dt))
            self.add_module(f"cls_{k}",
                            SameConv2d(c, bpc * config.total_labels, 3,
                                       **dt))

    def forward(self, features: List[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.config
        deltas, logits = [], []
        for k, feat in enumerate(features):
            if feat.shape[-1] != cfg.feature_map_shapes[k]:
                raise ValueError(f"feature map {k} is {tuple(feat.shape)}, "
                                 f"expected side {cfg.feature_map_shapes[k]}")
            b = feat.shape[0]
            loc = getattr(self, f"loc_{k}")(feat).permute(0, 2, 3, 1)
            cls = getattr(self, f"cls_{k}")(feat).permute(0, 2, 3, 1)
            deltas.append(loc.reshape(b, -1, 4))
            logits.append(cls.reshape(b, -1, cfg.total_labels))
        return (torch.cat(deltas, dim=1).float(),
                torch.cat(logits, dim=1).float())
