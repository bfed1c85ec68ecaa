"""VGG16 SSD backbone with atrous fc6/fc7 (port of the JAX package's
models/vgg16.py; reference: models/ssd_vgg16.py:get_model).

VGG16 truncated after conv5_3; every conv is a biased 3x3 SAME conv +
ReLU, no BatchNorm. Pools 1-4 are 2x2 stride-2 SAME max-pools (ceil mode:
75 -> 38 pads (0, 1) with -inf at 300 input), pool5 is 3x3 stride 1 SAME,
fc6 a 3x3 conv at dilation 6 (padding 6 each side), fc7 a 1x1 conv.
conv4_3 is L2-normalised with a learned scale (init 20).

Taps: conv4_3_norm (512 channels), fc7 (1024), then the extras conv8 ..
conv11: 38/19/10/5/3/1 at 300 input, the last two VALID stride 1. SSD512
adds conv12 and halves 32 -> 16 -> 8 -> 4 -> 2 -> 1 with SAME stride-2
extras: seven taps, 64 ... 1. Submodule names are the Flax names
(conv1_1 ... conv5_3, conv4_3_norm, fc6, fc7, conv8 ... conv12). The
images are cast to the compute dtype at the entry; every conv, ReLU and
pool runs in it, conv4_3_norm in float32 (models/layers.py). The stages
of `forward`'s stage runner: each of the first three conv groups with its
pool, conv group 4, conv4_3_norm, pool4 to fc7, and each extra block.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tfssd_torch.models.layers import (ExtraFeatureBlock, L2Norm, SameConv2d,
                                      run_stage, same_max_pool2d)

# (channels, convs) of the five conv groups.
_GROUPS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

# (reduce, out, stride, padding) of the extra blocks conv8, conv9, ...
_EXTRAS_300: Tuple[Tuple[int, int, int, str], ...] = (
    (256, 512, 2, "SAME"), (128, 256, 2, "SAME"),
    (128, 256, 1, "VALID"), (128, 256, 1, "VALID"))
_EXTRAS_512: Tuple[Tuple[int, int, int, str], ...] = (
    (256, 512, 2, "SAME"),) + ((128, 256, 2, "SAME"),) * 4

# Channels of the taps: conv4_3_norm, fc7, then one per extra block.
TAP_CHANNELS_300 = (512, 1024) + tuple(e[1] for e in _EXTRAS_300)
TAP_CHANNELS_512 = (512, 1024) + tuple(e[1] for e in _EXTRAS_512)


class VGG16Backbone(nn.Module):
    """Trunk + SSD extras: NCHW images -> six (SSD300) or seven (SSD512)
    NCHW feature maps."""

    def __init__(self, ssd512: bool = False,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        dt = dict(compute_dtype=compute_dtype)
        inp = 3
        for g, (features, count) in enumerate(_GROUPS, 1):
            for i in range(1, count + 1):
                self.add_module(f"conv{g}_{i}",
                                SameConv2d(inp, features, 3, **dt))
                inp = features
        self.conv4_3_norm = L2Norm(512, 20.0)
        self.fc6 = SameConv2d(512, 1024, 3, dilation=6, **dt)
        self.fc7 = SameConv2d(1024, 1024, 1, **dt)
        self._extras = _EXTRAS_512 if ssd512 else _EXTRAS_300
        inp = 1024
        for j, (r, f, s, p) in enumerate(self._extras):
            self.add_module(f"conv{8 + j}", ExtraFeatureBlock(
                inp, r, f, stride=s, padding=p, use_bn=False, **dt))
            inp = f

    def _group(self, x: torch.Tensor, g: int) -> torch.Tensor:
        for i in range(1, _GROUPS[g - 1][1] + 1):
            x = F.relu(getattr(self, f"conv{g}_{i}")(x))
        return x

    def _pooled_group(self, x: torch.Tensor, g: int) -> torch.Tensor:
        return same_max_pool2d(self._group(x, g), 2, 2)

    def _fc(self, x: torch.Tensor) -> torch.Tensor:
        """pool4, conv group 5, pool5, fc6, fc7."""
        x = self._group(same_max_pool2d(x, 2, 2), 5)
        x = same_max_pool2d(x, 3, 1)
        return F.relu(self.fc7(F.relu(self.fc6(x))))

    def forward(self, x: torch.Tensor, run=run_stage) -> List[torch.Tensor]:
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        for g in (1, 2, 3):
            x = run(self._pooled_group, x, g)
        x = run(self._group, x, 4)
        taps = [run(self.conv4_3_norm, x)]
        x = run(self._fc, x)
        taps.append(x)
        for j in range(len(self._extras)):
            x = run(getattr(self, f"conv{8 + j}"), x)
            taps.append(x)
        return taps
