"""The plain reference of the SSD detector: architecture, seeded weights,
forward pass, anchors and decode, written from the published descriptions
in plain PyTorch functions over a flat tree of weights.

  MobileNetV2 SSD300 (Sandler et al., arXiv:1801.04381, Table 2; SSD, Liu
  et al., arXiv:1512.02325): alpha 1.0, inverted residual blocks with
  ReLU6, the first tap the expansion of block 13 (19x19x576 at 300), the
  second the 1280-wide 1x1 head conv (10x10), then four extra blocks of
  1x1 reduce and 3x3 stride-2 down, each conv followed by BatchNorm and
  ReLU6: taps 19/10/5/3/2/1.
  VGG16 SSD512 (SSD paper §3): VGG16 to conv5_3, 2x2 stride-2 max pools
  (pool5 3x3 stride 1), fc6 a 3x3 conv at dilation 6, fc7 1x1, conv4_3
  L2-normalised with a learned per-channel scale (init 20); five extra
  blocks of 1x1 reduce and 3x3 stride-2 down with ReLU: taps
  64/32/16/8/4/2/1.
  Heads: per tap a 3x3 conv to 4 x boxes and a 3x3 conv to labels x boxes,
  reshaped cell by cell, box by box.

Convolutions, pools and their TensorFlow "SAME" padding (asymmetric for
stride 2, -inf for pools) follow the TensorFlow / Flax definitions the
system was written against. BatchNorm uses epsilon 1e-3, the biased
batch variance in training, the running statistics in evaluation.

Weights are a flat dict keyed by the Flax names ('params/backbone/
block0/depthwise/conv/kernel', kernels HWIO, 'batch_stats/.../bn/mean'),
the layout of the committed checkpoints: the benchmark reads or makes one
such tree and gives the same tree to the program and to this reference.
Everything computes in the dtype of the tensors it is given (float64 for
the reference, float32 for the lower-precision control).

This file imports torch, numpy and the standard library only.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tree = Dict[str, torch.Tensor]

BN_EPS = 1e-3

# MobileNetV2: (expand ratio, channels, repeats, first stride).
MBV2_SCHEDULE = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
                 (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
                 (6, 320, 1, 1))
MBV2_EXTRAS = ((256, 512), (128, 256), (128, 256), (64, 128))
MBV2_TAPS = (576, 1280, 512, 256, 256, 128)
# VGG16: (channels, convs) of the five conv groups; SSD512 extras.
VGG_GROUPS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
VGG512_EXTRAS = ((256, 512),) + ((128, 256),) * 4
VGG512_TAPS = (512, 1024, 512, 256, 256, 256, 256)


# ---------------------------------------------------------------------------
# Architecture: the leaves of the weight tree.
# ---------------------------------------------------------------------------

def _conv_bn(specs, path: str, k: int, cin: int, cout: int,
             depthwise: bool = False) -> None:
    shape = (k, k, 1, cout) if depthwise else (k, k, cin, cout)
    specs.append((f"params/{path}/conv/kernel", shape, "conv"))
    specs.append((f"params/{path}/bn/scale", (cout,), "one"))
    specs.append((f"params/{path}/bn/bias", (cout,), "zero"))
    specs.append((f"batch_stats/{path}/bn/mean", (cout,), "zero"))
    specs.append((f"batch_stats/{path}/bn/var", (cout,), "one"))


def _conv(specs, path: str, k: int, cin: int, cout: int) -> None:
    specs.append((f"params/{path}/kernel", (k, k, cin, cout), "conv"))
    specs.append((f"params/{path}/bias", (cout,), "zero"))


def mbv2_blocks() -> List[Tuple[str, int, int, int, int]]:
    """(name, expand ratio, in, out, stride) of the 17 blocks."""
    out, inp, idx = [], 32, 0
    for t, c, n, s in MBV2_SCHEDULE:
        for i in range(n):
            out.append((f"block{idx}", t, inp, c, s if i == 0 else 1))
            inp, idx = c, idx + 1
    return out


def weight_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(key, shape, init) of every leaf of the configuration's tree; init
    is 'conv' (He normal), 'zero', 'one' or 'l2norm' (20)."""
    specs: list = []
    if cfg["backbone"] == "mobilenet_v2":
        _conv_bn(specs, "backbone/stem", 3, 3, 32)
        for name, t, cin, cout, _ in mbv2_blocks():
            hidden = cin * t
            if name == "block13":
                _conv_bn(specs, "backbone/block13_expand", 1, cin, hidden)
                _conv_bn(specs, "backbone/block13_depthwise", 3, hidden,
                         hidden, depthwise=True)
                _conv_bn(specs, "backbone/block13_project", 1, hidden, cout)
                continue
            if t != 1:
                _conv_bn(specs, f"backbone/{name}/expand", 1, cin, hidden)
            _conv_bn(specs, f"backbone/{name}/depthwise", 3, hidden, hidden,
                     depthwise=True)
            _conv_bn(specs, f"backbone/{name}/project", 1, hidden, cout)
        _conv_bn(specs, "backbone/head_conv", 1, 320, 1280)
        inp = 1280
        for j, (r, f) in enumerate(MBV2_EXTRAS):
            _conv_bn(specs, f"backbone/extra{j}/reduce", 1, inp, r)
            _conv_bn(specs, f"backbone/extra{j}/down", 3, r, f)
            inp = f
        taps = MBV2_TAPS
    elif cfg["backbone"] == "vgg16" and cfg["img_size"] == 512:
        inp = 3
        for g, (c, n) in enumerate(VGG_GROUPS, 1):
            for i in range(1, n + 1):
                _conv(specs, f"backbone/conv{g}_{i}", 3, inp, c)
                inp = c
        specs.append(("params/backbone/conv4_3_norm/gamma", (512,),
                      "l2norm"))
        _conv(specs, "backbone/fc6", 3, 512, 1024)
        _conv(specs, "backbone/fc7", 1, 1024, 1024)
        inp = 1024
        for j, (r, f) in enumerate(VGG512_EXTRAS):
            _conv(specs, f"backbone/conv{8 + j}/reduce", 1, inp, r)
            _conv(specs, f"backbone/conv{8 + j}/down", 3, r, f)
            inp = f
        taps = VGG512_TAPS
    else:
        raise ValueError(f"no reference for {cfg['backbone']} at "
                         f"{cfg['img_size']}")
    for k, (c, bpc) in enumerate(zip(taps, boxes_per_cell(cfg))):
        _conv(specs, f"head/loc_{k}", 3, c, bpc * 4)
        _conv(specs, f"head/cls_{k}", 3, c, bpc * cfg["total_labels"])
    return specs


def seeded_weights(cfg: dict, seed: int, device) -> Tree:
    """The configuration's tree from `seed`: every conv kernel a normal
    scaled by sqrt(2 / fan_in) (He), biases and BatchNorm shifts zero,
    BatchNorm scales one, running statistics mean 0 and variance 1, the
    L2Norm scale 20; float32, drawn in one call from a torch.Generator on
    `device`."""
    specs = weight_specs(cfg)
    total = sum(math.prod(s) for _, s, init in specs if init == "conv")
    gen = torch.Generator(device=device).manual_seed(seed)
    draws = torch.randn(total, generator=gen, device=device,
                        dtype=torch.float32)
    tree: Tree = {}
    at = 0
    for key, shape, init in specs:
        n = math.prod(shape)
        if init == "conv":
            fan_in = shape[0] * shape[1] * shape[2]
            tree[key] = draws[at:at + n].view(shape) * math.sqrt(2.0 / fan_in)
            at += n
        else:
            fill = {"zero": 0.0, "one": 1.0, "l2norm": 20.0}[init]
            tree[key] = torch.full(shape, fill, dtype=torch.float32,
                                   device=device)
    return tree


def check_tree(cfg: dict, tree) -> None:
    """Raise unless `tree` has exactly the configuration's leaves and
    shapes (an unfolded tree; a VGG16 tree has no batch_stats)."""
    want = {k: tuple(s) for k, s, _ in weight_specs(cfg)}
    got = {k: tuple(v.shape) for k, v in tree.items()}
    if want != got:
        missing = sorted(set(want) - set(got))[:5]
        extra = sorted(set(got) - set(want))[:5]
        shapes = sorted(k for k in set(want) & set(got)
                        if want[k] != got[k])[:5]
        raise ValueError(f"weight tree differs from the reference's "
                         f"architecture: missing {missing}, extra {extra}, "
                         f"other shapes {shapes}")


# ---------------------------------------------------------------------------
# Forward pass.
# ---------------------------------------------------------------------------

def same_pads(size: int, kernel: int, stride: int,
              dilation: int = 1) -> Tuple[int, int]:
    """TensorFlow's SAME padding (low, high) of one spatial dimension."""
    out = -(-size // stride)
    span = (kernel - 1) * dilation + 1
    total = max((out - 1) * stride + span - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, kernel: torch.Tensor, bias=None, stride: int = 1,
         dilation: int = 1, depthwise: bool = False,
         padding: str = "SAME") -> torch.Tensor:
    """NCHW conv with an HWIO (or HW1C depthwise) kernel."""
    w = kernel.permute(3, 2, 0, 1)
    k = w.shape[-1]
    if padding == "SAME":
        ph = same_pads(x.shape[-2], k, stride, dilation)
        pw = same_pads(x.shape[-1], k, stride, dilation)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    groups = x.shape[1] if depthwise else 1
    return F.conv2d(x, w, bias, stride, 0, dilation, groups)


def max_pool(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """SAME max pool, padded with -inf."""
    ph = same_pads(x.shape[-2], kernel, stride)
    pw = same_pads(x.shape[-1], kernel, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, kernel, stride)


def batch_norm(x: torch.Tensor, tree: Tree, path: str,
               train: bool) -> torch.Tensor:
    scale = tree[f"params/{path}/bn/scale"]
    bias = tree[f"params/{path}/bn/bias"]
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = ((x - mean[:, None, None]) ** 2).mean(dim=(0, 2, 3))
    else:
        mean = tree[f"batch_stats/{path}/bn/mean"]
        var = tree[f"batch_stats/{path}/bn/var"]
    inv = torch.rsqrt(var + BN_EPS) * scale
    return (x - mean[:, None, None]) * inv[:, None, None] + bias[:, None,
                                                                 None]


def conv_bn(x, tree, path, stride=1, act=True, depthwise=False,
            train=False):
    x = conv(x, tree[f"params/{path}/conv/kernel"], None, stride,
             depthwise=depthwise)
    x = batch_norm(x, tree, path, train)
    return torch.clamp(x, 0.0, 6.0) if act else x


def mbv2_features(x: torch.Tensor, tree: Tree,
                  train: bool) -> List[torch.Tensor]:
    bb = "backbone"
    x = conv_bn(x, tree, f"{bb}/stem", 2, train=train)
    taps = []
    for name, t, cin, cout, s in mbv2_blocks():
        if name == "block13":
            y = conv_bn(x, tree, f"{bb}/block13_expand", train=train)
            taps.append(y)
            y = conv_bn(y, tree, f"{bb}/block13_depthwise", s,
                        depthwise=True, train=train)
            x = conv_bn(y, tree, f"{bb}/block13_project", act=False,
                        train=train)
            continue
        y = x
        if t != 1:
            y = conv_bn(y, tree, f"{bb}/{name}/expand", train=train)
        y = conv_bn(y, tree, f"{bb}/{name}/depthwise", s, depthwise=True,
                    train=train)
        y = conv_bn(y, tree, f"{bb}/{name}/project", act=False, train=train)
        x = y + x if (s == 1 and cin == cout) else y
    x = conv_bn(x, tree, f"{bb}/head_conv", train=train)
    taps.append(x)
    for j in range(len(MBV2_EXTRAS)):
        x = conv_bn(x, tree, f"{bb}/extra{j}/reduce", train=train)
        x = conv_bn(x, tree, f"{bb}/extra{j}/down", 2, train=train)
        taps.append(x)
    return taps


def _relu_conv(x, tree, path, stride=1, dilation=1):
    return F.relu(conv(x, tree[f"params/{path}/kernel"],
                       tree[f"params/{path}/bias"], stride, dilation))


def vgg512_features(x: torch.Tensor, tree: Tree) -> List[torch.Tensor]:
    bb = "backbone"
    taps = []
    for g, (_, n) in enumerate(VGG_GROUPS, 1):
        if g > 1:
            x = max_pool(x, 2, 2)
        for i in range(1, n + 1):
            x = _relu_conv(x, tree, f"{bb}/conv{g}_{i}")
        if g == 4:
            norm = torch.sqrt((x * x).sum(dim=1, keepdim=True) + 1e-10)
            gamma = tree[f"params/{bb}/conv4_3_norm/gamma"]
            taps.append(x / norm * gamma[:, None, None])
    x = max_pool(x, 3, 1)
    x = _relu_conv(x, tree, f"{bb}/fc6", dilation=6)
    x = _relu_conv(x, tree, f"{bb}/fc7")
    taps.append(x)
    for j in range(len(VGG512_EXTRAS)):
        x = _relu_conv(x, tree, f"{bb}/conv{8 + j}/reduce")
        x = _relu_conv(x, tree, f"{bb}/conv{8 + j}/down", 2)
        taps.append(x)
    return taps


def forward(cfg: dict, tree: Tree, images: torch.Tensor,
            train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """NHWC images in [-1, 1] -> (deltas (B, N, 4), logits (B, N, L)), in
    the images' dtype; `train` takes BatchNorm's batch statistics."""
    x = images.permute(0, 3, 1, 2)
    if cfg["backbone"] == "mobilenet_v2":
        taps = mbv2_features(x, tree, train)
    else:
        taps = vgg512_features(x, tree)
    deltas, logits = [], []
    b, labels = images.shape[0], cfg["total_labels"]
    for k, feat in enumerate(taps):
        if feat.shape[-1] != cfg["feature_map_shapes"][k]:
            raise ValueError(f"tap {k} is {tuple(feat.shape)}")
        loc = conv(feat, tree[f"params/head/loc_{k}/kernel"],
                   tree[f"params/head/loc_{k}/bias"])
        cls = conv(feat, tree[f"params/head/cls_{k}/kernel"],
                   tree[f"params/head/cls_{k}/bias"])
        deltas.append(loc.permute(0, 2, 3, 1).reshape(b, -1, 4))
        logits.append(cls.permute(0, 2, 3, 1).reshape(b, -1, labels))
    return torch.cat(deltas, dim=1), torch.cat(logits, dim=1)


def preprocess(images_u8: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 [0, 255] -> [-1, 1] in `dtype`."""
    return images_u8.to(dtype) / 255.0 * 2.0 - 1.0


# ---------------------------------------------------------------------------
# Anchors and decode.
# ---------------------------------------------------------------------------

def boxes_per_cell(cfg: dict) -> List[int]:
    return [len(a) + 1 for a in cfg["aspect_ratios"]]


def map_scales(cfg: dict) -> List[float]:
    if cfg.get("scales"):
        return list(cfg["scales"])
    m = len(cfg["feature_map_shapes"])
    step = (cfg["scale_max"] - cfg["scale_min"]) / (m - 1)
    return [cfg["scale_min"] + step * k for k in range(m)] + [1.0]


def anchors(cfg: dict) -> np.ndarray:
    """(N, 4) float32 corner prior boxes: per cell of map k, one box per
    aspect ratio ar at scale s_k (h = s/sqrt(ar), w = s*sqrt(ar)) and one
    at sqrt(s_k s_{k+1}); centres (i + 0.5) / f_k; clipped to [0, 1]."""
    scales = map_scales(cfg)
    out = []
    for k, fm in enumerate(cfg["feature_map_shapes"]):
        s, s_next = scales[k], scales[k + 1]
        hw = [(s / math.sqrt(ar), s * math.sqrt(ar))
              for ar in cfg["aspect_ratios"][k]]
        hw.append((math.sqrt(s * s_next),) * 2)
        hw = np.asarray(hw, np.float32)
        c = (np.arange(fm, dtype=np.float32) + 0.5) / fm
        cy, cx = np.meshgrid(c, c, indexing="ij")
        cy, cx = cy[:, :, None], cx[:, :, None]
        h, w = hw[None, None, :, 0], hw[None, None, :, 1]
        out.append(np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2],
                            axis=-1).reshape(-1, 4))
    a = np.clip(np.concatenate(out), 0.0, 1.0).astype(np.float32)
    if len(a) != cfg["anchors"]:
        raise ValueError(f"{len(a)} anchors, the configuration states "
                         f"{cfg['anchors']}")
    return a


def decode(cfg: dict, anchors_t: torch.Tensor, deltas: torch.Tensor,
           logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N, 4) deltas and (B, N, L) logits -> boxes (B, N, 4) clipped
    to [0, 1] and foreground scores (B, N, L - 1), in the deltas' dtype."""
    a = anchors_t.to(deltas.dtype)
    ah, aw = a[:, 2] - a[:, 0], a[:, 3] - a[:, 1]
    acy, acx = a[:, 0] + ah / 2, a[:, 1] + aw / 2
    v = cfg["variances"]
    cy = deltas[..., 0] * v[0] * ah + acy
    cx = deltas[..., 1] * v[1] * aw + acx
    h = torch.exp(deltas[..., 2] * v[2]) * ah
    w = torch.exp(deltas[..., 3] * v[3]) * aw
    boxes = torch.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2],
                        dim=-1).clamp(0.0, 1.0)
    scores = torch.softmax(logits, dim=-1)[..., 1:]
    return boxes, scores


def model_flops(cfg: dict, train: bool) -> float:
    """FLOPs of the model for one image, counted by torch.utils.
    flop_counter over this reference's forward on the meta device (no
    arithmetic runs): the forward's; for training three times the forward
    (each conv's weight and input gradients cost what its forward costs),
    less the input gradient of the first conv, which no step computes.
    The backward is not counted by the flop counter itself, whose weight
    gradient of a grouped conv ignores the groups (MobileNetV2's depthwise
    convs would read 4x the forward)."""
    from torch.utils.flop_counter import FlopCounterMode

    tree = {k: torch.empty(s, device="meta") for k, s, _ in weight_specs(cfg)}
    s = cfg["img_size"]
    images = torch.empty((1, s, s, 3), device="meta")
    with FlopCounterMode(display=False) as counter:
        forward(cfg, tree, images)
    fwd = float(counter.get_total_flops())
    if not train:
        return fwd
    first = next(k for k, _, init in weight_specs(cfg) if init == "conv")
    stride = 2 if cfg["backbone"] == "mobilenet_v2" else 1
    with FlopCounterMode(display=False) as counter:
        conv(images.permute(0, 3, 1, 2), tree[first], None, stride)
    return 3.0 * fwd - float(counter.get_total_flops())
