"""RetinaNet with a ResNeXt50-32x4d FPN trunk (MLPerf Inference's detector):
torchvision's retinanet_resnet50_fpn (v1) with ResNeXt50-32x4d (Xie et al.,
arXiv:1611.05431) as its trunk, the feature pyramid of Lin et al.
(arXiv:1612.03144) and the subnets of Lin et al., arXiv:1708.02002. It has
no counterpart in the JAX package; its reference is the benchmark's plain
portbench/reference/retinanet.py.

  trunk: 7x7 stride-2 conv to stem_channels (pad 3), BN, ReLU, 3x3
  stride-2 max pool (pad 1); stages of stage_blocks bottlenecks (1x1 conv,
  BN, ReLU; 3x3 conv with `groups` groups and the stage's stride, 2 in the
  first block of stages 2-4, BN, ReLU; 1x1 conv, BN; a 1x1 strided conv and
  BN on the shortcut where the shape changes; add, ReLU). BatchNorm is
  frozen (eval-mode running statistics, epsilon bn_eps), folded into the
  convs for serving (utils/fold_bn.py). C3-C5: the outputs of stages 2-4.
  FPN: 1x1 lateral convs with bias to fpn_channels; inner5 = lat(C5),
  inner4 = lat(C4) + nearest(inner5), inner3 likewise; P3-P5 a 3x3 conv
  with bias on each inner; P6 a 3x3 stride-2 conv on P5, P7 one on
  ReLU(P6).
  Heads: one set of weights over all levels; head_convs x (3x3 conv, bias,
  ReLU), then a 3x3 conv to A x num_classes (class subnet) or A x 4 (box
  subnet, torchvision's (dx, dy, dw, dh)); outputs location-major, anchor
  next, class last, the levels concatenated P3 first.

With BatchNorm folded, each bottleneck's grouped 3x3 conv and its ReLU run
in one hand-written kernel, tfssd::grouped_conv3x3
(ops/kernels/grouped_conv3x3.py), and every groups-1 1x1 or 3x3 conv after
the stem in another, tfssd::dense_conv (ops/kernels/dense_conv.py), with
its bias, ReLU and, for conv3, the bottleneck's shortcut add in its
epilogue; wherever autograd records nothing and the input is float32 on a
card or lies on the CPU (ConvBN.forward). The profiler counters
"conv/grouped_kernel" and "conv/dense_kernel" count those calls (16 and 36
a RetinaNet predict at the published depths, 0 and 52 a Mask R-CNN one).
Elsewhere, the stem among them, the conv is F.conv2d.

Padding is PyTorch's symmetric k // 2, not the SSD layers' TensorFlow
"SAME". Parameter names follow the benchmark's Flax-style tree
(backbone.layer1.block0.conv2.conv, fpn.inner3, head.cls_out, ...), so
utils/convert.py:load_variables loads it. `forward` takes NHWC images
already normalised (models/decoder.py) and returns (deltas (B, N, 4),
logits (B, N, num_classes)) in float32; under a torch profiler it records
the spans `trunk`, `fpn` and `head` (utils/profiling.py).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tfssd_torch.config import RetinaNetConfig
from tfssd_torch.models.layers import Conv2d
from tfssd_torch.ops.kernels import dense_conv, grouped_conv3x3
from tfssd_torch.utils import profiling


def _conv(cin: int, cout: int, k: int, stride: int = 1, groups: int = 1,
          bias: bool = True) -> Conv2d:
    return Conv2d(cin, cout, k, stride, k // 2, groups=groups, bias=bias)


class ConvBN(nn.Module):
    """Conv (no bias) -> frozen BatchNorm -> the shortcut added, where
    forward is given one -> ReLU (or none); with fold_bn a biased conv that
    already holds the BatchNorm (`conv`, `bn` as utils/fold_bn.py names
    them)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 groups: int = 1, act: bool = True, fold_bn: bool = False,
                 eps: float = 1e-5):
        super().__init__()
        self.conv = _conv(cin, cout, k, stride, groups, bias=fold_bn)
        self.bn = None if fold_bn else nn.BatchNorm2d(cout, eps=eps)
        self.act = act

    def forward(self, x: torch.Tensor,
                shortcut: Optional[torch.Tensor] = None) -> torch.Tensor:
        if shortcut is None and self._takes_grouped_kernel(x):
            profiling.count("conv/grouped_kernel", 1)
            return grouped_conv3x3.grouped_conv3x3(
                x, self.conv.weight, self.conv.bias, self.conv.stride[0],
                self.act)
        if self._takes_dense_kernel(x, shortcut):
            profiling.count("conv/dense_kernel", 1)
            return dense_conv.dense_conv(
                x, self.conv.weight, self.conv.bias, shortcut,
                self.conv.stride[0], self.act)
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if shortcut is not None:
            x = x + shortcut
        return F.relu(x) if self.act else x

    def _kernel_can_run(self, x: torch.Tensor,
                        shortcut: Optional[torch.Tensor]) -> bool:
        """What both kernels ask of a call (BatchNorm folded, the bias and
        the ReLU in the kernel): a conv with a bias, padding k // 2,
        dilation 1 and a square stride, computed in the parameters' dtype,
        on contiguous tensors of x's dtype and device that are float32 on a
        card or lie on the CPU (the plain versions), with nothing for
        autograd to record."""
        conv = self.conv
        ts = (x, conv.weight, conv.bias) + (
            () if shortcut is None else (shortcut,))
        return (conv.bias is not None
                and conv.padding == tuple(k // 2 for k in conv.kernel_size)
                and conv.dilation == (1, 1)
                and conv.stride[0] == conv.stride[1]
                and conv.compute_dtype is None
                and all(t.dtype == x.dtype and t.device == x.device
                        and t.is_contiguous() for t in ts)
                and (x.device.type == "cpu" or (
                    x.is_cuda and x.dtype == torch.float32))
                and not (torch.is_grad_enabled() and any(
                    t.requires_grad for t in ts)))

    def _takes_dense_kernel(self, x: torch.Tensor,
                            shortcut: Optional[torch.Tensor]) -> bool:
        """Whether this call runs tfssd::dense_conv (a bottleneck's
        groups-1 conv; the shortcut too in the kernel): a 1x1 or 3x3 conv
        of stride 1 or 2 that _kernel_can_run."""
        conv = self.conv
        k = conv.kernel_size[0]
        return (conv.groups == 1 and conv.kernel_size == (k, k)
                and k in dense_conv.SIDES
                and conv.stride[0] in dense_conv.STRIDES
                and self._kernel_can_run(x, shortcut))

    def _takes_grouped_kernel(self, x: torch.Tensor) -> bool:
        """Whether this call runs tfssd::grouped_conv3x3 (the bottleneck's
        grouped 3x3): a 3x3 conv of stride 1 or 2 with groups of a width
        the kernel takes and as many outputs as inputs that
        _kernel_can_run."""
        conv = self.conv
        return (conv.groups > 1 and conv.kernel_size == (3, 3)
                and conv.stride[0] in grouped_conv3x3.STRIDES
                and conv.in_channels == conv.out_channels
                and conv.in_channels // conv.groups in grouped_conv3x3.WIDTHS
                and self._kernel_can_run(x, None))


class Bottleneck(nn.Module):
    """ResNeXt bottleneck (torchvision's v1.5: the stride on the 3x3)."""

    def __init__(self, cin: int, width: int, cout: int, stride: int,
                 groups: int, **bn):
        super().__init__()
        self.conv1 = ConvBN(cin, width, 1, **bn)
        self.conv2 = ConvBN(width, width, 3, stride, groups, **bn)
        # conv3's ReLU follows the shortcut's add
        self.conv3 = ConvBN(width, cout, 1, **bn)
        self.downsample = (ConvBN(cin, cout, 1, stride, act=False, **bn)
                           if stride != 1 or cin != cout else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.downsample is None else self.downsample(x)
        return self.conv3(self.conv2(self.conv1(x)), shortcut)


class ResNeXt(nn.Module):
    """NCHW images -> [C2, C3, C4, C5], the outputs of the four stages; at
    groups 1 a ResNet (Mask R-CNN's trunk, models/maskrcnn.py)."""

    def __init__(self, config):
        super().__init__()
        bn = dict(fold_bn=config.fold_bn, eps=config.bn_eps)
        self.stem = ConvBN(3, config.stem_channels, 7, 2, **bn)
        cin = config.stem_channels
        for s, (n, width, cout) in enumerate(zip(
                config.stage_blocks, config.stage_widths,
                config.stage_channels), 1):
            blocks = OrderedDict()
            for j in range(n):
                stride = 2 if (j == 0 and s > 1) else 1
                blocks[f"block{j}"] = Bottleneck(cin, width, cout, stride,
                                                 config.groups, **bn)
                cin = cout
            self.add_module(f"layer{s}", nn.Sequential(blocks))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.max_pool2d(self.stem(x), 3, 2, 1)
        c2 = self.layer1(x)
        c3 = self.layer2(c2)
        c4 = self.layer3(c3)
        return [c2, c3, c4, self.layer4(c4)]


class FPN(nn.Module):
    """Torchvision's FeaturePyramidNetwork over [C_first, ..., C5] ->
    [P_first, ..., P5] and its extra levels: with `p6p7` (RetinaNet,
    first level 3) LastLevelP6P7(256, 256), P6 a 3x3 stride-2 conv on P5
    and P7 one on ReLU(P6); else (Mask R-CNN, first level 2)
    LastLevelMaxPool, P6 = max_pool2d(P5, 1, 2)."""

    def __init__(self, in_channels: Tuple[int, ...], channels: int,
                 first_level: int = 3, p6p7: bool = True):
        super().__init__()
        self.levels = tuple(range(first_level,
                                  first_level + len(in_channels)))
        for level, c in zip(self.levels, in_channels):
            self.add_module(f"inner{level}", _conv(c, channels, 1))
            self.add_module(f"layer{level}", _conv(channels, channels, 3))
        self.p6p7 = p6p7
        if p6p7:
            self.p6 = _conv(channels, channels, 3, 2)
            self.p7 = _conv(channels, channels, 3, 2)

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        top = self.levels[-1]
        inner = getattr(self, f"inner{top}")(feats[-1])
        outs = [getattr(self, f"layer{top}")(inner)]
        for level, c in zip(self.levels[-2::-1], feats[-2::-1]):
            inner = getattr(self, f"inner{level}")(c) + F.interpolate(
                inner, size=c.shape[-2:], mode="nearest")
            outs.insert(0, getattr(self, f"layer{level}")(inner))
        if not self.p6p7:
            return outs + [F.max_pool2d(outs[-1], 1, 2)]
        p6 = self.p6(outs[-1])
        return outs + [p6, self.p7(F.relu(p6))]


class RetinaNetHead(nn.Module):
    """The class and box subnets, one set of weights over every level."""

    def __init__(self, config: RetinaNetConfig):
        super().__init__()
        c, a = config.fpn_channels, config.anchors_per_cell
        self.anchors, self.num_classes = a, config.num_classes
        for sub, out in (("cls", a * config.num_classes), ("box", a * 4)):
            for i in range(config.head_convs):
                self.add_module(f"{sub}_conv{i}", _conv(c, c, 3))
            self.add_module(f"{sub}_out", _conv(c, out, 3))
        self.convs = config.head_convs

    def _subnet(self, sub: str, k: int, maps: List[torch.Tensor]
                ) -> torch.Tensor:
        parts = []
        for y in maps:
            for i in range(self.convs):
                y = F.relu(getattr(self, f"{sub}_conv{i}")(y))
            y = getattr(self, f"{sub}_out")(y)
            b, _, h, w = y.shape
            parts.append(y.view(b, self.anchors, k, h, w)
                         .permute(0, 3, 4, 1, 2).reshape(b, -1, k))
        return torch.cat(parts, dim=1)

    def forward(self, maps: List[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return (self._subnet("box", 4, maps),
                self._subnet("cls", self.num_classes, maps))


class RetinaNet(nn.Module):
    """(B, H, W, 3) normalised images -> (deltas, logits)."""

    def __init__(self, config: RetinaNetConfig):
        super().__init__()
        config.validate()
        self.config = config
        self.backbone = ResNeXt(config)
        self.fpn = FPN(config.stage_channels[1:], config.fpn_channels)
        self.head = RetinaNetHead(config)

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        with profiling.span("trunk"):
            feats = self.backbone(images.permute(0, 3, 1, 2).contiguous(
                ))[1:]
        with profiling.span("fpn"):
            maps = self.fpn(feats)
        for m, side in zip(maps, self.config.feature_map_shapes):
            if m.shape[-1] != side:
                raise ValueError(f"a pyramid level is {tuple(m.shape)}, "
                                 f"expected side {side}")
        with profiling.span("head"):
            return self.head(maps)
