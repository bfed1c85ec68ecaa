"""The SSD detector: backbone -> multibox heads (port of the JAX package's
models/ssd.py; reference: models/ssd_mobilenet_v2.py:get_model).

`SSD.forward` takes the JAX layout, NHWC float images in [-1, 1], and
returns (deltas (B, N, 4), logits (B, N, L)) in float32. Backbones:
MobileNetV2 (SSD300) and VGG16, SSD300 or SSD512 by the config's
img_size, as the JAX package chooses. Float32 only (bfloat16: ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
from torch import nn

from tfssd_torch.config import SSDConfig
from tfssd_torch.models.head import MultiboxHead
from tfssd_torch.models.layers import L2Norm
from tfssd_torch.models.mobilenet_v2 import MobileNetV2Backbone
from tfssd_torch.models.vgg16 import (TAP_CHANNELS_300, TAP_CHANNELS_512,
                                      VGG16Backbone)

# Channels of the six MobileNetV2 taps (19/10/5/3/2/1 at 300 input).
_MBV2_TAP_CHANNELS = (576, 1280, 512, 256, 256, 128)


class SSD(nn.Module):
    """Full detector: (B, H, W, 3) images -> (deltas, logits)."""

    def __init__(self, config: SSDConfig):
        super().__init__()
        if config.compute_dtype != "float32":
            raise NotImplementedError("the port serves in float32 only")
        if config.backbone == "mobilenet_v2":
            self.backbone = MobileNetV2Backbone(
                fold_bn=config.fold_bn, bn_momentum=config.bn_momentum)
            taps = _MBV2_TAP_CHANNELS
        elif config.backbone == "vgg16":
            ssd512 = config.img_size == 512
            self.backbone = VGG16Backbone(ssd512)
            taps = TAP_CHANNELS_512 if ssd512 else TAP_CHANNELS_300
        else:
            raise ValueError(f"unknown backbone {config.backbone!r}")
        self.config = config
        self.head = MultiboxHead(config, taps)

    def features(self, images: torch.Tensor) -> List[torch.Tensor]:
        """NHWC images -> the NCHW backbone taps (six, or seven for SSD512)."""
        return self.backbone(images.permute(0, 3, 1, 2))

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.head(self.features(images))


def get_model(config: SSDConfig) -> SSD:
    """Mirror of the reference `get_model(hyper_params)`."""
    return SSD(config)


@torch.no_grad()
def init_random_weights(model: nn.Module, seed: int) -> nn.Module:
    """Seeded weights that keep activations bounded: every conv a normal
    scaled by its fan-in (He scale), biases zero, every BatchNorm the
    identity (scale 1, shift 0, mean 0, var 1), every L2Norm scale at its
    initial 20. Drawn on the CPU from a
    torch.Generator, so a seed gives the same weights on every device."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            w = torch.randn(m.weight.shape, generator=gen) * math.sqrt(
                2.0 / fan_in)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, L2Norm)):
            m.reset_parameters()
    return model
