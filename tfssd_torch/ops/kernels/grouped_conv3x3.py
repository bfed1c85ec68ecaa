"""Grouped 3x3 convolution with a folded bias and an optional ReLU: the
CUDA kernel, its plain version, dispatch.

RetinaNet's ResNeXt bottlenecks (models/retinanet.py:ConvBN) hold 16 of
them: 32 groups of 4, 8, 16 or 32 channels, padding 1, stride 1 or 2, the
BatchNorm folded into a bias, then a ReLU. The JAX package has no
RetinaNet, so no TPU kernel stands behind this one.

The kernel (csrc/grouped_conv3x3.cu) is one launch a conv: a block loads a
band of output rows' input and its groups' weights into shared memory and
each thread accumulates a register tile of output channels by pixels in
float32 fused multiply-adds, then adds the bias and applies the ReLU. Its
source says what bounds it, and picks the band and the block from the
shape. The plain version sums the same products in the kernel's order of
the taps: for each tap, the group's product over its input channels
(torch.matmul), added to the sum of the earlier taps; then the bias and
the ReLU. In float32 the two round differently (fused multiply-adds, the
matmul's own order within a tap): chip_smoke.py holds them, and
F.conv2d, to a stated tolerance on the card.

`grouped_conv3x3` is the custom operator `tfssd::grouped_conv3x3`, made as
ops/kernels/nms_keep.py makes `tfssd::nms_keep`: its CPU implementation is
the plain version, its CUDA implementation the kernel, which raises on an
input it does not take and never falls back, and a fake implementation
gives the output's shape for tracing. It has no gradient: the model calls
it only where autograd records nothing.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

# Group widths the kernel takes (csrc/grouped_conv3x3.cu: launch_stride).
WIDTHS = (4, 8, 16, 32)
STRIDES = (1, 2)
# Launches of the CUDA kernel in this process; incremented only where the
# kernel is launched.
LAUNCHES = 0

_FN = None


def _launch_fn():
    global _FN
    if _FN is None:
        from tfssd_torch.ops.kernels.build import load_library

        fn = load_library("grouped_conv3x3").grouped_conv3x3_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def output_side(side: int, stride: int) -> int:
    """A side of the output: 3x3, padding 1."""
    return (side - 1) // stride + 1


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           stride: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (N, C, H, W), got {tuple(x.shape)}")
    c = x.shape[1]
    if weight.dim() != 4 or weight.shape[0] != c or \
            tuple(weight.shape[2:]) != (3, 3):
        raise ValueError(f"weight must be (C, C / groups, 3, 3) with C = "
                         f"{c}, got {tuple(weight.shape)}")
    cg = weight.shape[1]
    if cg < 1 or c % cg:
        raise ValueError(f"a group width of {cg} does not divide {c} "
                         f"channels")
    if bias.shape != (c,):
        raise ValueError(f"bias must be ({c},), got {tuple(bias.shape)}")
    if stride not in STRIDES:
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if not (x.dtype == weight.dtype == bias.dtype) or \
            not x.dtype.is_floating_point:
        raise TypeError(f"x, weight and bias must share one floating "
                        f"dtype, got {x.dtype}, {weight.dtype}, "
                        f"{bias.dtype}")
    if len({t.device for t in (x, weight, bias)}) != 1:
        raise ValueError("x, weight and bias are on different devices")


def grouped_conv3x3_cuda(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, stride: int,
                         relu: bool) -> torch.Tensor:
    """(N, C, H, W) float32 x, (C, cg, 3, 3) weight and (C,) bias, all
    contiguous on a CUDA device, cg in WIDTHS -> (N, C, Ho, Wo) float32,
    by the hand-written kernel."""
    global LAUNCHES
    _check(x, weight, bias, stride)
    if x.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32, got {x.dtype}")
    if not (x.is_contiguous() and weight.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError("x, weight and bias must be contiguous (NCHW)")
    n, c, h, w = x.shape
    cg = weight.shape[1]
    if cg not in WIDTHS:
        raise ValueError(f"the kernel takes group widths {WIDTHS}, got {cg}")
    if x.device.type != "cuda":
        raise ValueError("grouped_conv3x3_cuda needs CUDA tensors")
    ho, wo = output_side(h, stride), output_side(w, stride)
    y = torch.empty((n, c, ho, wo), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    device = x.device
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    err = _launch_fn()(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                       y.data_ptr(), n, c, h, w, cg, stride, int(relu),
                       device.index, stream)
    if err != 0:
        raise RuntimeError(f"grouped_conv3x3 kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES += 1
    return y


def grouped_conv3x3_reference(x: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor, stride: int,
                              relu: bool) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device and floating
    dtype: for each tap (kh, kw) in row-major order, the strided window of
    the zero-padded input times the tap's (cg, cg) weight of each group
    (torch.matmul over the group's input channels), summed over the taps
    in that order; then the bias, then the ReLU where `relu`."""
    _check(x, weight, bias, stride)
    n, c, h, w = x.shape
    cg = weight.shape[1]
    g = c // cg
    ho, wo = output_side(h, stride), output_side(w, stride)
    xp = F.pad(x, (1, 1, 1, 1))
    taps = weight.reshape(g, cg, cg, 9)
    y = None
    for t in range(9):
        kh, kw = divmod(t, 3)
        window = xp[:, :, kh:kh + stride * (ho - 1) + 1:stride,
                    kw:kw + stride * (wo - 1) + 1:stride]
        part = torch.matmul(taps[..., t], window.reshape(n, g, cg, ho * wo))
        y = part if y is None else y + part
    y = y.reshape(n, c, ho, wo) + bias[:, None, None]
    return F.relu(y) if relu else y


_LIB = torch.library.Library("tfssd", "FRAGMENT")
_LIB.define("grouped_conv3x3(Tensor x, Tensor weight, Tensor bias, "
            "int stride, bool relu) -> Tensor")
_LIB.impl("grouped_conv3x3", grouped_conv3x3_reference, "CPU")
_LIB.impl("grouped_conv3x3", grouped_conv3x3_cuda, "CUDA")


@torch.library.register_fake("tfssd::grouped_conv3x3")
def _grouped_conv3x3_fake(x, weight, bias, stride, relu):
    _check(x, weight, bias, stride)
    n, c, h, w = x.shape
    return x.new_empty((n, c, output_side(h, stride),
                        output_side(w, stride)))


# (x, weight, bias, stride, relu) -> y, by device: the plain version for
# CPU tensors, the CUDA kernel for CUDA tensors.
grouped_conv3x3 = torch.ops.tfssd.grouped_conv3x3.default
