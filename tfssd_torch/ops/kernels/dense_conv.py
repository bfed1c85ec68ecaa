"""Dense (groups 1) 1x1 or 3x3 convolution with a folded bias, an optional
shortcut add and an optional ReLU: the CUDA kernel, its plain version,
dispatch.

The ResNet and ResNeXt bottlenecks of models/retinanet.py:ConvBN hold them
after the stem: conv1 (1x1, ReLU), the groups-1 conv2 (3x3, stride 1 or 2,
ReLU), conv3 (1x1, the shortcut added, then the ReLU) and the downsample
(1x1, stride 1 or 2), each with BatchNorm folded into a bias. Mask R-CNN's
trunk runs 52 of them a predict, RetinaNet's 36 (its grouped 3x3s are
tfssd::grouped_conv3x3). The JAX package has no ResNet trunk, so no TPU
kernel stands behind this one.

The kernel (csrc/dense_conv.cu) is one launch a conv: an implicit GEMM
(M = output channels, N = output pixels, K = input channels x taps) whose
blocks stream tiles of the weights and of the input's im2col through a
cp.async ring and accumulate 8 x 8 register tiles in float32 fused
multiply-adds over K in ascending (channel, kh, kw) order, then add the
bias, the shortcut, and apply the ReLU. Its source says what bounds it and
why one tile serves every shape. The plain version forms the same
products, (weight as (M, K)) @ (the im2col as (K, pixels)) by
torch.matmul over K in the same (channel, kh, kw) order, then adds the
bias, the shortcut and applies the ReLU, in the kernel's order. In float32
the two round differently (fused multiply-adds, the matmul's own blocking
of K): chip_smoke.py holds them, and F.conv2d, to the float32 round-off
bound of a sum of K + 1 terms (K + 2 with the shortcut) on the card.

`dense_conv` is the custom operator `tfssd::dense_conv`, made as
ops/kernels/grouped_conv3x3.py makes `tfssd::grouped_conv3x3`: its CPU
implementation is the plain version, its CUDA implementation the kernel,
which raises on an input it does not take and never falls back, and a fake
implementation gives the output's shape for tracing. It has no gradient:
the model calls it only where autograd records nothing.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

# Kernel sides and strides the kernel takes (csrc/dense_conv.cu); padding
# is side // 2.
SIDES = (1, 3)
STRIDES = (1, 2)
# Launches of the CUDA kernel in this process; incremented only where the
# kernel is launched.
LAUNCHES = 0

_FN = None


def _launch_fn():
    global _FN
    if _FN is None:
        from tfssd_torch.ops.kernels.build import load_library

        fn = load_library("dense_conv").dense_conv_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def output_side(side: int, stride: int) -> int:
    """A side of the output: 1x1 or 3x3, padding side // 2."""
    return (side - 1) // stride + 1


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           shortcut: Optional[torch.Tensor], stride: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (N, C, H, W), got {tuple(x.shape)}")
    n, c, h, w = x.shape
    if weight.dim() != 4 or weight.shape[1] != c or \
            weight.shape[2] != weight.shape[3] or \
            weight.shape[2] not in SIDES:
        raise ValueError(f"weight must be (M, {c}, k, k) with k in {SIDES},"
                         f" got {tuple(weight.shape)}")
    m = weight.shape[0]
    if bias.shape != (m,):
        raise ValueError(f"bias must be ({m},), got {tuple(bias.shape)}")
    if stride not in STRIDES:
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    want = (n, m, output_side(h, stride), output_side(w, stride))
    if shortcut is not None and tuple(shortcut.shape) != want:
        raise ValueError(f"shortcut must be {want}, got "
                         f"{tuple(shortcut.shape)}")
    ts = (x, weight, bias) + (() if shortcut is None else (shortcut,))
    if len({t.dtype for t in ts}) != 1 or not x.dtype.is_floating_point:
        raise TypeError(f"x, weight, bias and shortcut must share one "
                        f"floating dtype, got {[t.dtype for t in ts]}")
    if len({t.device for t in ts}) != 1:
        raise ValueError("x, weight, bias and shortcut are on different "
                         "devices")


def dense_conv_cuda(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, shortcut: Optional[torch.Tensor],
                    stride: int, relu: bool) -> torch.Tensor:
    """(N, C, H, W) float32 x, (M, C, k, k) weight, (M,) bias and an
    optional (N, M, Ho, Wo) shortcut, all contiguous on a CUDA device, k 1
    or 3 -> (N, M, Ho, Wo) float32, by the hand-written kernel."""
    global LAUNCHES
    _check(x, weight, bias, shortcut, stride)
    ts = (x, weight, bias) + (() if shortcut is None else (shortcut,))
    if x.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32, got {x.dtype}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("x, weight, bias and shortcut must be contiguous "
                         "(NCHW)")
    if x.device.type != "cuda":
        raise ValueError("dense_conv_cuda needs CUDA tensors")
    n, c, h, w = x.shape
    m, k = weight.shape[0], weight.shape[2]
    y = torch.empty((n, m, output_side(h, stride), output_side(w, stride)),
                    dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    device = x.device
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    err = _launch_fn()(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                       None if shortcut is None else shortcut.data_ptr(),
                       y.data_ptr(), n, c, h, w, m, k, stride, int(relu),
                       device.index, stream)
    if err != 0:
        raise RuntimeError(f"dense_conv kernel launch failed: cudaError "
                           f"{err}")
    LAUNCHES += 1
    return y


def dense_conv_reference(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor,
                         shortcut: Optional[torch.Tensor], stride: int,
                         relu: bool) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device and floating
    dtype: the (M, C k k) weight times the (C k k, Ho Wo) im2col of each
    image (zero padding k // 2; rows in (channel, kh, kw) order, the
    weight's), summed over K by torch.matmul; then the bias, then the
    shortcut where one is given, then the ReLU where `relu`."""
    _check(x, weight, bias, shortcut, stride)
    n, c, h, w = x.shape
    m, k = weight.shape[0], weight.shape[2]
    ho, wo = output_side(h, stride), output_side(w, stride)
    if k == 1:
        cols = x[:, :, ::stride, ::stride].reshape(n, c, ho * wo)
    else:
        cols = F.unfold(x, k, padding=k // 2, stride=stride)
    y = torch.matmul(weight.reshape(m, -1), cols).reshape(n, m, ho, wo)
    y = y + bias[:, None, None]
    if shortcut is not None:
        y = y + shortcut
    return F.relu(y) if relu else y


_LIB = torch.library.Library("tfssd", "FRAGMENT")
_LIB.define("dense_conv(Tensor x, Tensor weight, Tensor bias, "
            "Tensor? shortcut, int stride, bool relu) -> Tensor")
_LIB.impl("dense_conv", dense_conv_reference, "CPU")
_LIB.impl("dense_conv", dense_conv_cuda, "CUDA")


@torch.library.register_fake("tfssd::dense_conv")
def _dense_conv_fake(x, weight, bias, shortcut, stride, relu):
    _check(x, weight, bias, shortcut, stride)
    n, _, h, w = x.shape
    return x.new_empty((n, weight.shape[0], output_side(h, stride),
                        output_side(w, stride)))


# (x, weight, bias, shortcut, stride, relu) -> y, by device: the plain
# version for CPU tensors, the CUDA kernel for CUDA tensors.
dense_conv = torch.ops.tfssd.dense_conv.default
