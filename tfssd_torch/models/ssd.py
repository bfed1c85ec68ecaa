"""The SSD detector: backbone -> multibox heads (port of the JAX package's
models/ssd.py; reference: models/ssd_mobilenet_v2.py:get_model).

`SSD.forward` takes the JAX layout, NHWC float images in [-1, 1], and
returns (deltas (B, N, 4), logits (B, N, L)) in float32. Backbones:
MobileNetV2 (SSD300) and VGG16, SSD300 or SSD512 by the config's
img_size, as the JAX package chooses.

The config's compute_dtype "bfloat16" runs the backbone and the heads in
bfloat16 with float32 parameters, by the JAX package's rules
(models/layers.py); any other string computes in the parameters' dtype,
float32 (or float64 for a model cast with .double()). With remat the
backbone's activations are recomputed in the backward, as under nn.remat:
torch.utils.checkpoint around each stage of the backbone (a MobileNetV2
block, a VGG16 conv group), whose recompute leaves the BatchNorm
statistics alone; parameter names do not change. One checkpoint around
the whole backbone recomputes all of its activations at once in the
backward, and its step's peak memory was the plain step's (PERF.md §6).
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from tfssd_torch.config import SSDConfig
from tfssd_torch.models.head import MultiboxHead
from tfssd_torch.models.layers import L2Norm, batch_stats_frozen
from tfssd_torch.models.mobilenet_v2 import MobileNetV2Backbone
from tfssd_torch.models.vgg16 import (TAP_CHANNELS_300, TAP_CHANNELS_512,
                                      VGG16Backbone)

# Channels of the six MobileNetV2 taps (19/10/5/3/2/1 at 300 input).
_MBV2_TAP_CHANNELS = (576, 1280, 512, 256, 256, 128)


class SSD(nn.Module):
    """Full detector: (B, H, W, 3) images -> (deltas, logits)."""

    def __init__(self, config: SSDConfig):
        super().__init__()
        # Any other string computes in the parameters' dtype, as the JAX
        # package reads the field.
        dt = dict(compute_dtype=torch.bfloat16
                  if config.compute_dtype == "bfloat16" else None)
        if config.backbone == "mobilenet_v2":
            self.backbone = MobileNetV2Backbone(
                fold_bn=config.fold_bn, bn_momentum=config.bn_momentum, **dt)
            taps = _MBV2_TAP_CHANNELS
        elif config.backbone == "vgg16":
            ssd512 = config.img_size == 512
            self.backbone = VGG16Backbone(ssd512, **dt)
            taps = TAP_CHANNELS_512 if ssd512 else TAP_CHANNELS_300
        else:
            raise ValueError(f"unknown backbone {config.backbone!r}")
        self.config = config
        self.head = MultiboxHead(config, taps, **dt)

    def features(self, images: torch.Tensor) -> List[torch.Tensor]:
        """NHWC images -> the NCHW backbone taps (six, or seven for SSD512)."""
        x = images.permute(0, 3, 1, 2)
        if self.config.remat and torch.is_grad_enabled():
            return self.backbone(x, self._rematerialised)
        return self.backbone(x)

    def _rematerialised(self, stage, *args) -> torch.Tensor:
        """Run one backbone stage under torch.utils.checkpoint: its
        activations are recomputed in the backward, where the BatchNorm
        statistics must not be updated a second time."""
        return checkpoint(stage, *args, use_reentrant=False,
                          context_fn=self._remat_contexts)

    def _remat_contexts(self):
        """(first forward, recompute) contexts of a checkpointed stage."""
        return contextlib.nullcontext(), batch_stats_frozen(self.backbone)

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
    initial 20; float32 whatever the compute dtype. Drawn on the CPU from a
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
