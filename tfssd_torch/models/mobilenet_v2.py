"""MobileNetV2 SSD backbone (port of the JAX package's
models/mobilenet_v2.py; reference: models/ssd_mobilenet_v2.py:get_model).

alpha = 1.0 with the standard (t, c, n, s) schedule. Tap 1 is the
expansion ReLU6 of block 13 (Keras block_13_expand_relu, 19x19x576 at 300
input), tap 2 the 1280-wide final 1x1 conv (10x10), then four extra blocks
give 5/3/2/1: six taps in all. Submodule names are the Flax names
(stem, block0..block16 with block13 split into block13_expand/_depthwise/
_project, head_conv, extra0..extra3). The images are cast to the compute
dtype at the entry (models/layers.py). Each of the stem, the blocks, the
head conv and the extras is one stage of `forward`'s stage runner (block
13: its expansion, then the rest).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from tfssd_torch.models.layers import (BN_MOMENTUM, ConvBN, ExtraFeatureBlock,
                                      InvertedResidual, run_stage)

# (expand_ratio t, channels c, repeats n, first stride s) — MBv2 Table 2.
_MBV2_SCHEDULE = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),   # block 13 starts this group; its expansion is tap 1
    (6, 320, 1, 1),
)

# (reduce, out) channels of the SSD extra blocks: 10 -> 5 -> 3 -> 2 -> 1.
_EXTRAS: Tuple[Tuple[int, int], ...] = (
    (256, 512), (128, 256), (128, 256), (64, 128))


class MobileNetV2Backbone(nn.Module):
    """Trunk + SSD extras: NCHW images -> six NCHW feature maps."""

    def __init__(self, fold_bn: bool = False,
                 bn_momentum: float = BN_MOMENTUM,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        bn = dict(fold_bn=fold_bn, bn_momentum=bn_momentum,
                  compute_dtype=compute_dtype)
        self.stem = ConvBN(3, 32, 3, 2, **bn)
        # Block names in forward order; block 13 is three modules.
        self._order: List[str] = []
        inp = 32
        block_idx = 0
        for t, c, n, s in _MBV2_SCHEDULE:
            for i in range(n):
                stride = s if i == 0 else 1
                name = f"block{block_idx}"
                if stride == 2 and c == 160:
                    hidden = inp * t
                    self.add_module(f"{name}_expand",
                                    ConvBN(inp, hidden, 1, **bn))
                    self.add_module(f"{name}_depthwise",
                                    ConvBN(hidden, hidden, 3, 2,
                                           groups=hidden, **bn))
                    self.add_module(f"{name}_project",
                                    ConvBN(hidden, c, 1, act=False, **bn))
                    self._tap_block = name
                else:
                    self.add_module(name, InvertedResidual(
                        inp, c, stride, t, **bn))
                self._order.append(name)
                inp = c
                block_idx += 1
        self.head_conv = ConvBN(inp, 1280, 1, **bn)
        inp = 1280
        for j, (r, f) in enumerate(_EXTRAS):
            self.add_module(f"extra{j}",
                            ExtraFeatureBlock(inp, r, f, **bn))
            inp = f

    def _tap_block_rest(self, y: torch.Tensor) -> torch.Tensor:
        """Block 13 after its expansion (the tap): depthwise, project."""
        name = self._tap_block
        return getattr(self, f"{name}_project")(
            getattr(self, f"{name}_depthwise")(y))

    def forward(self, x: torch.Tensor, run=run_stage) -> List[torch.Tensor]:
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        x = run(self.stem, x)
        taps: List[torch.Tensor] = []
        for name in self._order:
            if name == self._tap_block:
                y = run(getattr(self, f"{name}_expand"), x)
                taps.append(y)
                x = run(self._tap_block_rest, y)
            else:
                x = run(getattr(self, name), x)
        x = run(self.head_conv, x)
        taps.append(x)
        for j in range(len(_EXTRAS)):
            x = run(getattr(self, f"extra{j}"), x)
            taps.append(x)
        return taps
