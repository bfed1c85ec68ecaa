"""Shared model building blocks (port of the JAX package's models/layers.py).

NCHW modules whose parameter names follow the Flax tree (ConvBN holds
`conv` and `bn`), so utils/convert.py maps one onto the other by name.

TF "SAME" padding is asymmetric for stride 2: at 300 input it pads (0, 1)
for 300->150, 150->75, 38->19, 10->5 and 2->1, and (1, 1) for 75->38,
19->10, 5->3 and 3->2. `SameConv2d` and `same_max_pool2d` compute it from
the input size; a symmetric `padding=1` would shift every sample. A max
pool pads with -inf, as Flax's nn.max_pool does.

BatchNorm follows Flax's nn.BatchNorm: epsilon 1e-3, momentum taken from
SSDConfig.bn_momentum (Flax's 0.99 is torch's 0.01), and in train mode the
running variance is updated with the BIASED batch variance, where
nn.BatchNorm2d would use the unbiased one (a factor n/(n-1): 32/31 on the
1x1 extra map at batch 32).

Compute dtype (SSDConfig.compute_dtype) follows Flax's per-module
`dtype=` with explicit casts, not autocast, whose op lists and rounding
points are not Flax's: with `compute_dtype=torch.bfloat16` a conv casts
its input and its float32 weight to bfloat16, convolves without the bias
and then adds the bias cast to bfloat16, in bfloat16 (nn.Conv(dtype=
bfloat16)); BatchNorm normalises the conv's output in float32 with
float32 statistics and casts back; activations, pools and the residual
add run in bfloat16. `compute_dtype=None` computes in the parameters'
dtype (float32, or float64 for a float64 model) with no casts.

A dilated convolution (VGG16's fc6) computed in the parameters' dtype
that autograd does not record (serving, export, evaluation) is one GEMM
over its unfolded taps (_atrous_gemm); the profiler counter
"conv/atrous_gemm" counts those calls. Where autograd records (every train
step, remat included) it stays F.conv2d, whose backward cuDNN runs well,
and so it does in bfloat16, where cuDNN's tensor-core kernels ran fc6
1.3-8x faster than the GEMM at batch 8 to 256 (H100).
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Callable, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tfssd_torch.utils import profiling

BN_EPSILON = 1e-3
BN_MOMENTUM = 0.99  # Flax convention; SSDConfig.bn_momentum's default


def run_stage(fn: Callable[..., torch.Tensor], *args) -> torch.Tensor:
    """Run one stage of a backbone: the backbones' default stage runner
    (models/ssd.py passes one that checkpoints each stage under remat)."""
    return fn(*args)


def same_padding(size: int, kernel: int, stride: int,
                 dilation: int = 1) -> Tuple[int, int]:
    """(low, high) TF/Flax SAME padding of one spatial dimension."""
    out = -(-size // stride)
    span = (kernel - 1) * dilation + 1
    total = max((out - 1) * stride + span - size, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Conv2d):
    """nn.Conv2d computed in `compute_dtype` as Flax's nn.Conv(dtype=...)
    computes (module docstring); None computes in the parameters' dtype,
    the bias fused into the convolution. Parameters and state_dict keys
    are nn.Conv2d's."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def _conv(self, x: torch.Tensor, padding: Tuple[int, int]
              ) -> torch.Tensor:
        dtype = self.compute_dtype
        if dtype is None:
            if (self.dilation != (1, 1) and self.groups == 1
                    and not (torch.is_grad_enabled() and (
                        x.requires_grad or self.weight.requires_grad))):
                profiling.count("conv/atrous_gemm", 1)
                return _atrous_gemm(x, self.weight, self.bias, padding,
                                    self.stride, self.dilation)
            return F.conv2d(x, self.weight, self.bias, self.stride, padding,
                            self.dilation, self.groups)
        x = x.to(dtype)
        span = [(k - 1) * d + 1 for k, d in zip(self.kernel_size,
                                                 self.dilation)]
        if (x.device.type == "cpu" and any(padding)
                and (x.shape[-2] < span[0] or x.shape[-1] < span[1])):
            # The CPU's bfloat16 weight gradient (oneDNN, torch 2.13)
            # leaves garbage in the taps that see only the padding, and a
            # tap can do so only where the map is smaller than the
            # kernel's span (a 1x1 map at 3x3); zeros padded in the input
            # give it nothing to skip.
            x = F.pad(x, (padding[1], padding[1], padding[0], padding[0]))
            padding = (0, 0)
        y = F.conv2d(x, self.weight.to(dtype), None, self.stride, padding,
                     self.dilation, self.groups)
        return y if self.bias is None else y + self.bias.to(dtype)[:, None,
                                                                    None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv(x, self.padding)


def _atrous_gemm(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor], padding: Tuple[int, int],
                 stride: Tuple[int, int], dilation: Tuple[int, int]
                 ) -> torch.Tensor:
    """F.conv2d(x, weight, bias, stride, padding, dilation) for groups 1,
    as one batched GEMM over the unfolded taps (im2col), the bias added by
    the GEMM: (O, C*kh*kw) @ (B, C*kh*kw, L) is (B, O, L), already NCHW.
    Conv2d._conv takes it for a dilated kernel in float32 (float64) when
    autograd records nothing. On an H100, cuDNN runs fc6 (3x3 at dilation
    6, 512 -> 1,024) on the trunk's channels-last activations at batch 16
    (32x32) and 64 (19x19) with a direct kernel at under 1 TFLOP/s; this
    form ran every fc6 shape measured at 34-46 TFLOP/s. The sums are the
    convolution's, in another order."""
    b, _, h, w = x.shape
    o, _, kh, kw = weight.shape
    oh = (h + 2 * padding[0] - (kh - 1) * dilation[0] - 1) // stride[0] + 1
    ow = (w + 2 * padding[1] - (kw - 1) * dilation[1] - 1) // stride[1] + 1
    cols = F.unfold(x, (kh, kw), dilation=dilation, padding=padding,
                    stride=stride)
    taps = weight.reshape(o, -1).expand(b, -1, -1)
    if bias is None:
        y = torch.bmm(taps, cols)
    else:
        y = torch.baddbmm(bias[:, None].expand(b, -1, cols.shape[-1]), taps,
                          cols)
    return y.view(b, o, oh, ow)


class SameConv2d(Conv2d):
    """Conv2d with TF/Flax "SAME" padding, computed from the input size
    at call time (construct it with nn.Conv2d's arguments, padding left
    at 0). A dilated kernel pads for its span: fc6's 3x3 at dilation 6
    pads 6 on each side."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        dh, dw = self.dilation
        ph = same_padding(x.shape[-2], kh, sh, dh)
        pw = same_padding(x.shape[-1], kw, sw, dw)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return self._conv(x, (ph[0], pw[0]))
        return self._conv(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), (0, 0))


def same_max_pool2d(x: torch.Tensor, kernel: int,
                    stride: int) -> torch.Tensor:
    """Flax's nn.max_pool(x, (kernel, kernel), (stride, stride), "SAME") on
    NCHW: -inf padding, (0, 1) where TF pads asymmetrically (75 -> 38 at
    2x2 stride 2)."""
    ph = same_padding(x.shape[-2], kernel, stride)
    pw = same_padding(x.shape[-1], kernel, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.max_pool2d(x, kernel, stride, (ph[0], pw[0]))
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, kernel, stride)


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d with Flax's train-mode statistics: it normalises with
    the biased batch variance (as torch does) and also updates
    running_var with it (torch would use the unbiased one):

        running = flax_momentum * running + (1 - flax_momentum) * batch

    Construct it with torch's momentum, 1 - flax_momentum. Eval mode is
    nn.BatchNorm2d's. Parameter and buffer names are nn.BatchNorm2d's.

    While `frozen` (batch_stats_frozen: the recompute of a rematerialised
    forward) train mode normalises as before but leaves the running
    statistics and the count alone: Flax updates them once a step.

    With `world` > 1 (batch_stats_global: the train step of a rank of a
    data-parallel process group, tfssd_torch/parallel.py) train mode takes
    the statistics of the global batch that `world` ranks split, as the
    JAX step's BatchNorm does over a sharded batch under jit:
    _global_batch."""

    frozen = False
    world = 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.world > 1:
            return self._global_batch(x)
        n = x.numel() // x.shape[1]
        if n == 1:
            return self._single_value(x)
        # F.batch_norm adds momentum * n/(n-1) * biased to the running
        # variance it is given; giving it running_var * n/(n-1) and taking
        # the result back times (n-1)/n leaves Flax's update in the same
        # pass. The scaled copy is a new tensor because autograd saves it
        # for the backward. Frozen, the update goes to copies, so the
        # recompute takes the same kernels as the first forward.
        unbias = n / (n - 1)
        with torch.no_grad():
            mean = (self.running_mean.clone() if self.frozen
                    else self.running_mean)
            var = self.running_var * unbias
        y = F.batch_norm(x, mean, var, self.weight, self.bias,
                         True, self.momentum, self.eps)
        if not self.frozen:
            with torch.no_grad():
                torch.div(var, unbias, out=self.running_var)
                self.num_batches_tracked.add_(1)
        return y

    def _global_batch(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over the global batch of every rank's equal shard,
        in two passes as F.batch_norm takes them: the per-channel sum of x
        summed over the ranks gives the mean, then the sum of (x - mean)^2
        the biased variance; both all-reduces are differentiated by
        autograd (their backward sums the ranks' gradients). Then Flax's
        formula, y = (x - mean) * rsqrt(var + eps) * scale + bias, and the
        running statistics updated with that mean and biased variance."""
        c = x.shape[1]
        n = x.numel() // c * self.world
        mean = _all_reduce_autograd(x.sum(dim=(0, 2, 3))) / n
        centred = x - mean.view(1, -1, 1, 1)
        var = _all_reduce_autograd(
            (centred * centred).sum(dim=(0, 2, 3))) / n
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = centred * mul.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)
        if not self.frozen:
            with torch.no_grad():
                keep = 1.0 - self.momentum
                self.running_mean.mul_(keep).add_(mean * self.momentum)
                self.running_var.mul_(keep).add_(var * self.momentum)
                self.num_batches_tracked.add_(1)
        return y

    def _single_value(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over one value per channel (a 1x1 map at batch 1),
        where F.batch_norm raises: Flax's formula in plain ops. The mean
        is the value and the variance 0, so the output is the bias and the
        gradients are Flax's (none reaches x or the weight)."""
        mean = x.mean(dim=(0, 2, 3), keepdim=True)
        var = torch.zeros_like(mean)
        mul = torch.rsqrt(var + self.eps) * self.weight.view(1, -1, 1, 1)
        y = (x - mean) * mul + self.bias.view(1, -1, 1, 1)
        if not self.frozen:
            with torch.no_grad():
                keep = 1.0 - self.momentum
                self.running_mean.mul_(keep).add_(mean.view(-1)
                                                  * self.momentum)
                self.running_var.mul_(keep)
                self.num_batches_tracked.add_(1)
        return y


def _all_reduce_autograd(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks of the process group, as a new tensor
    whose backward sums the ranks' gradients
    (torch.distributed.nn.functional.all_reduce; its deprecation warning,
    which names a private replacement without autograd, is silenced)."""
    from torch.distributed.nn.functional import all_reduce

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return all_reduce(t)


@contextlib.contextmanager
def _batch_norms_set(module: nn.Module, name: str, value) -> Iterator[None]:
    """Within the block attribute `name` of every FlaxBatchNorm2d of
    `module` is `value`; restored after."""
    bns = [m for m in module.modules() if isinstance(m, FlaxBatchNorm2d)]
    before = [getattr(m, name) for m in bns]
    for m in bns:
        setattr(m, name, value)
    try:
        yield
    finally:
        for m, v in zip(bns, before):
            setattr(m, name, v)


def batch_stats_frozen(module: nn.Module):
    """Within the block every FlaxBatchNorm2d of `module` is frozen (its
    running statistics and count are left alone in train mode)."""
    return _batch_norms_set(module, "frozen", True)


def batch_stats_global(module: nn.Module, world: int):
    """Within the block every FlaxBatchNorm2d of `module` takes, in train
    mode, the statistics of the global batch that the `world` ranks of
    the process group split in equal shards (world 1: the local batch's,
    nothing communicated). The block must hold the backward too, where a
    rematerialised forward is recomputed."""
    return _batch_norms_set(module, "world", world)


class ConvBN(nn.Module):
    """Conv -> BatchNorm -> ReLU6 (or no activation). With fold_bn the BN
    affine is already folded into a biased conv (utils/fold_bn.py).
    bn_momentum is Flax's (SSDConfig.bn_momentum). Under a compute dtype
    BatchNorm runs on the conv's output cast to float32, and its output is
    cast back before the activation."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1, act: bool = True,
                 fold_bn: bool = False, bn_momentum: float = BN_MOMENTUM,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = SameConv2d(in_channels, features, kernel, stride,
                               groups=groups, bias=fold_bn,
                               compute_dtype=compute_dtype)
        self.bn: Optional[nn.BatchNorm2d] = (
            None if fold_bn else
            FlaxBatchNorm2d(features, eps=BN_EPSILON,
                            momentum=1.0 - bn_momentum))
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            dtype = self.conv.compute_dtype
            x = self.bn(x) if dtype is None else self.bn(x.float()).to(dtype)
        return F.relu6(x) if self.act else x


class InvertedResidual(nn.Module):
    """MobileNetV2 block: 1x1 expand -> 3x3 depthwise -> 1x1 project, with
    the residual add when stride is 1 and the widths match (in the compute
    dtype)."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 expand_ratio: int = 6, fold_bn: bool = False,
                 bn_momentum: float = BN_MOMENTUM,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        hidden = in_channels * expand_ratio
        bn = dict(fold_bn=fold_bn, bn_momentum=bn_momentum,
                  compute_dtype=compute_dtype)
        self.expand = (ConvBN(in_channels, hidden, 1, **bn)
                       if expand_ratio != 1 else None)
        self.depthwise = ConvBN(hidden, hidden, 3, stride, groups=hidden,
                                **bn)
        self.project = ConvBN(hidden, features, 1, act=False, **bn)
        self.residual = stride == 1 and in_channels == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.expand(x) if self.expand is not None else x
        y = self.project(self.depthwise(y))
        return y + x if self.residual else y


class L2Norm(nn.Module):
    """Channelwise L2 normalisation with a learned per-channel scale
    (conv4_3 of VGG16-SSD): x / sqrt(sum_c x^2 + 1e-10) * gamma, in
    float32, or in float64 for a float64 input (the float64 witness of a
    train step), cast back to the input's dtype. Not F.normalize, which
    divides by max(|x|, eps). gamma starts at `scale_init` (20)."""

    def __init__(self, channels: int, scale_init: float = 20.0):
        super().__init__()
        self.scale_init = scale_init
        self.gamma = nn.Parameter(torch.empty(channels))
        self.reset_parameters()

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.gamma.fill_(self.scale_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        norm = torch.sqrt((xf * xf).sum(dim=1, keepdim=True) + 1e-10)
        return (xf / norm * self.gamma[:, None, None]).to(x.dtype)


class ExtraFeatureBlock(nn.Module):
    """SSD extra block: 1x1 reduce -> 3x3 downsample. With use_bn (the
    MobileNetV2 extras) each conv is a ConvBN + ReLU6 (`reduce.conv`,
    `reduce.bn`, ...) and the downsample is stride 2 SAME; without (the
    VGG16 extras) each is a biased conv + ReLU (`reduce`, `down`) and the
    downsample takes stride 2 or 1 and Flax padding "SAME" or "VALID"."""

    def __init__(self, in_channels: int, reduce_features: int, features: int,
                 stride: int = 2, padding: str = "SAME", use_bn: bool = True,
                 fold_bn: bool = False, bn_momentum: float = BN_MOMENTUM,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"unknown padding {padding!r}")
        if use_bn:
            if (stride, padding) != (2, "SAME"):
                raise ValueError("the BatchNorm form downsamples 3x3 "
                                 "stride 2 SAME only")
            bn = dict(fold_bn=fold_bn, bn_momentum=bn_momentum,
                      compute_dtype=compute_dtype)
            self.reduce = ConvBN(in_channels, reduce_features, 1, **bn)
            self.down = ConvBN(reduce_features, features, 3, 2, **bn)
        else:
            self.reduce = SameConv2d(in_channels, reduce_features, 1,
                                     compute_dtype=compute_dtype)
            conv = SameConv2d if padding == "SAME" else Conv2d
            self.down = conv(reduce_features, features, 3, stride,
                             compute_dtype=compute_dtype)
        self.use_bn = use_bn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_bn:
            return self.down(self.reduce(x))
        return F.relu(self.down(F.relu(self.reduce(x))))
