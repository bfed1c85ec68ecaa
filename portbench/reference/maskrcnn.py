"""The plain reference of Mask R-CNN with a ResNet-50 FPN trunk on COCO-sized
frames: architecture, seeded weights, the forward of each stage, anchors,
decode, RoIAlign, both selections, the FLOP count, and the comparison that
judges a served reply.

Written from torchvision's maskrcnn_resnet50_fpn (v1) code: Mask R-CNN (He
et al., arXiv:1703.06870), Faster R-CNN's region proposals and box head
(Ren et al., arXiv:1506.01497), the feature pyramid of Lin et al.
(arXiv:1612.03144) and ResNet-50 (He et al., arXiv:1512.03385):

  input: an 800x1066 frame (COCO's 640x480 at GeneralizedRCNNTransform's
  min_size 800), scaled to [0, 1], normalised by ImageNet's mean and std,
  padded with zeros on the right to 800x1088 (a multiple of 32).
  trunk: a 7x7 stride-2 conv to 64 (no bias), frozen BatchNorm (epsilon
  1e-5), ReLU, a 3x3 stride-2 max pool; four stages of 3 / 4 / 6 / 3
  bottlenecks of width 64 / 128 / 256 / 512 and output 256 / 512 / 1,024 /
  2,048 (1x1, 3x3 with the stage's stride, 2 in the first block of stages
  2-4, 1x1, each with BN; a 1x1 strided conv and BN on the shortcut where
  the shape changes; add, ReLU). C2-C5 at 200x272 ... 25x34.
  FPN: a 1x1 lateral conv with bias to 256 on each of C2-C5; inner5 =
  lat(C5), inner_l = lat(C_l) + nearest(inner_l+1, C_l's size); P2-P5 a
  3x3 conv with bias on each inner; P6 = max_pool2d(P5, 1, 2), 13x17.
  RPN head, over P2-P6: a 3x3 conv 256 -> 256 with bias, ReLU; 1x1 convs
  to 3 objectness logits and 12 deltas (dx, dy, dw, dh); location-major,
  anchor next, P2 first.
  Anchors: sizes 32 / 64 / 128 / 256 / 512 (one a level), ratios (0.5, 1,
  2); base boxes round([-w, -h, w, h] / 2) with h = size sqrt(r), w =
  size / sqrt(r) in float32, shifted by the per-axis integer strides of
  the padded batch, 800 // rows and 1088 // columns: (4, 4) ... (61, 64).
  Proposals, per image: each level's top 1,000 logits; decode with
  weights (1, 1, 1, 1), dw and dh clamped above at log(1000/16); sigmoid;
  clip to the 800x1066 frame; drop boxes with a side under 1e-3 and
  scores under 0; greedy NMS per level at IoU 0.7; the top 1,000.
  Box head: RoIAlign (aligned=False) of each proposal to 7x7 with 2x2
  samples a bin, on P2-P5 by its level floor(4 + log2(sqrt(area) / 224)
  + 1e-6) clamped to [2, 5], at scale 2^-level; flattened (C, H, W); fc6
  12,544 -> 1,024 and fc7 1,024 -> 1,024, each with ReLU; cls_score to
  91 logits, bbox_pred to 91 x 4 deltas.
  Detections, per image: each class's box decoded from its proposal with
  weights (10, 10, 5, 5) and the same clamp, clipped; softmax, the
  background column dropped; pairs scoring above 0.05 whose box has both
  sides at least 1e-2; greedy NMS per class at IoU 0.5; the top 100.
  Mask head: RoIAlign of each detection to 14x14 the same way; 4 x (3x3
  conv 256 -> 256 with bias, ReLU); a 2x2 stride-2 transposed conv 256 ->
  256 with bias, ReLU; a 1x1 conv to 91; the sigmoid of the detection's
  class's 28x28 map.

Departures from torchvision's code:
  - weights are a flat dict keyed by Flax-style names, conv kernels HWIO,
    Dense kernels (in, out), the transposed conv's kernel (kH, kW, out,
    in); seeded (seeded_weights): He-normal trunk, FPN and box-head MLP;
    the FPN, the RPN's convs, fc6, fc7, bbox_pred and the mask head's
    layers at torchvision's own inits (weight_specs); cls_score of std
    CLS_STD, not torchvision's default init, so that every image of the
    benchmark's pool fills its 100 detections (with torchvision's init
    every softmax sits near 1/91, under 0.05, and no detection would reach
    the mask head); mask_fcn_logits of std MASK_LOGIT_STD, so that the
    masks are not all 0 or 1; zero biases; BatchNorm scale 1 and shift 0
    with running statistics taken from synthetic frames;
  - frames come at the configuration's size, so GeneralizedRCNNTransform's
    resize is the identity and its postprocess's rescale too; the masks
    are not pasted into the frame (the reply's 28x28 maps);
  - score ties in each top-k and each ordering go to the lower index
    (torch.topk promises no order); NMS per level and per class is greedy
    NMS per group (batched_nms's coordinate offsets decide the same, up to
    their rounding).

Everything computes in the dtype of the tensors it is given (float64 for
the reference, float32 for the lower-precision control); the seeded
weights' calibration computes with TF32 off. This file imports torch,
numpy, the standard library and portbench's data, harness, detect and
reference/retinanet modules only.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench import data, harness
from portbench.reference.detect import IOU_SLACK, SCORE_SLACK, iou
from portbench.reference.retinanet import (_conv, _conv_bn, _top,
                                           base_anchors, conv, conv_bn)

Tree = Dict[str, torch.Tensor]

# torchvision's RPNHead draws its convs from a normal of this std.
RPN_STD = 0.01
# bbox_pred's std. At RPN_STD the seeded FPN's maps (rms ~16, where a
# trained FPN's are ~1) make deltas of rms ~1: proposals a fraction of a
# pixel wide and clipped to the frame's height, thousands of near-copies.
# At 0.001 the deltas are ~0.1, as a trained RPN's.
RPN_BOX_STD = 0.001
# cls_score's std: fc7's outputs have a norm of ~110 at the published
# widths (float32, synthetic frames at 400x532), and share a large common
# part, so a few classes lead over most proposals of an image and per-class
# NMS leaves those classes' spread-out boxes. At 0.02 some images kept 0-77
# detections, at 0.04 77 and up; at 0.08 each of 6 frames of 2 seeds
# filled its 100, with top scores of 0.40-1.0.
CLS_STD = 0.08
# mask_fcn_logits' std: torchvision's kaiming_normal (sqrt(2 / 91), 0.148)
# gives mask logits of rms ~18 on these weights, every probability 0 or 1
# to float32; at 0.02 they spread ~2.5 and the masks' probabilities are
# graded.
MASK_LOGIT_STD = 0.02
# Synthetic frames of the seed whose statistics the BatchNorms take.
CALIBRATION_IMAGES = 2
# Rounding room of the two choices RoIAlign makes on a float32 box: its
# level, within LEVEL_SLACK of an edge of floor (in log2 units), and a
# sample within BORDER_SLACK level pixels of a map's border (which reads 0
# beyond it). The comparison takes either side (judge).
LEVEL_SLACK = 1e-5
BORDER_SLACK = 1e-3
# Room in pixels of the smallest side a box may have.
SIZE_SLACK = 1e-3
# Boxes RoIAlign, and served proposals the RPN's comparison, take at once
# (float64 intermediates of ~100-250 MB at the published sizes).
CHUNK = 128


# ---------------------------------------------------------------------------
# Architecture: the leaves of the weight tree.
# ---------------------------------------------------------------------------

def blocks(cfg: dict) -> List[Tuple[str, int, int, int, int]]:
    """(path, in, width, out, stride) of every bottleneck."""
    out, cin = [], cfg["stem_channels"]
    for s, (n, width, cout) in enumerate(zip(
            cfg["stage_blocks"], cfg["stage_widths"],
            cfg["stage_channels"]), 1):
        for j in range(n):
            stride = 2 if (j == 0 and s > 1) else 1
            out.append((f"backbone/layer{s}/block{j}", cin, width, cout,
                        stride))
            cin = cout
    return out


def anchors_per_cell(cfg: dict) -> int:
    return len(cfg["anchor_ratios"]) * len(cfg["anchor_sizes"][0])


def _dense(specs, path: str, cin: int, cout: int, init: str) -> None:
    specs.append((f"params/{path}/kernel", (cin, cout), init))
    specs.append((f"params/{path}/bias", (cout,), "zero"))


def weight_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(key, shape, init) of every leaf; init is 'conv' (He normal over the
    fan-in: the trunk), 'fpn' (std 1 / sqrt(fan-in), the std of
    torchvision's kaiming_uniform(a=1) for the FPN), 'rpn' (std RPN_STD),
    'rpn_box' (std RPN_BOX_STD),
    'linear' (std 1 / sqrt(3 fan-in), the std of nn.Linear's default
    init, which torchvision keeps for fc6, fc7 and bbox_pred), 'cls' (std
    CLS_STD), 'mask' (He normal over the fan-out, out x k x k, or the
    transposed conv's in x k x k: torchvision's kaiming_normal for the mask
    head), 'mask_logits' (std MASK_LOGIT_STD), 'zero' or 'one'."""
    specs: list = []
    _conv_bn(specs, "backbone/stem", 7, 3, cfg["stem_channels"])
    for path, cin, width, cout, stride in blocks(cfg):
        _conv_bn(specs, f"{path}/conv1", 1, cin, width)
        _conv_bn(specs, f"{path}/conv2", 3, width, width)
        _conv_bn(specs, f"{path}/conv3", 1, width, cout)
        if stride != 1 or cin != cout:
            _conv_bn(specs, f"{path}/downsample", 1, cin, cout)
    f = cfg["fpn_channels"]
    for level, c in zip((2, 3, 4, 5), cfg["stage_channels"]):
        _conv(specs, f"fpn/inner{level}", 1, c, f, "fpn")
        _conv(specs, f"fpn/layer{level}", 3, f, f, "fpn")
    a = anchors_per_cell(cfg)
    _conv(specs, "rpn/conv", 3, f, f, "rpn")
    _conv(specs, "rpn/cls_logits", 1, f, a, "rpn")
    _conv(specs, "rpn/bbox_pred", 1, f, 4 * a, "rpn_box")
    r, c = cfg["representation_size"], cfg["num_classes"]
    _dense(specs, "box_head/fc6", f * cfg["box_roi_size"] ** 2, r,
           "linear")
    _dense(specs, "box_head/fc7", r, r, "linear")
    _dense(specs, "box_head/cls_score", r, c, "cls")
    _dense(specs, "box_head/bbox_pred", r, 4 * c, "linear")
    cin = f
    for i, cout in enumerate(cfg["mask_layers"], 1):
        _conv(specs, f"mask_head/mask_fcn{i}", 3, cin, cout, "mask")
        cin = cout
    specs.append(("params/mask_head/conv5_mask/kernel", (2, 2, cin, cin),
                  "mask"))
    specs.append(("params/mask_head/conv5_mask/bias", (cin,), "zero"))
    _conv(specs, "mask_head/mask_fcn_logits", 1, cin, c, "mask_logits")
    return specs


def _std(shape, init: str) -> float:
    fan_in = math.prod(shape[:-1])
    if init == "conv":
        return math.sqrt(2.0 / fan_in)
    if init == "fpn":
        return math.sqrt(1.0 / fan_in)
    if init == "linear":
        return math.sqrt(1.0 / (3 * fan_in))
    if init == "mask":
        return math.sqrt(2.0 / (shape[0] * shape[1] * shape[3]))
    return {"rpn": RPN_STD, "rpn_box": RPN_BOX_STD, "cls": CLS_STD,
            "mask_logits": MASK_LOGIT_STD}[init]


def seeded_weights(cfg: dict, seed: int, device) -> Tree:
    """The configuration's tree from `seed`, float32: the trunk He-normal,
    every other drawn leaf a normal of its init's std (weight_specs), all
    drawn in one call from a
    torch.Generator on `device` in the order of weight_specs; biases and
    BatchNorm shifts zero, BatchNorm scales one, and each BatchNorm's
    running mean and variance those of its input over CALIBRATION_IMAGES
    synthetic frames of the seed (calibrate_batch_norm), as RetinaNet's
    reference does."""
    specs = weight_specs(cfg)
    drawn = [(k, s, i) for k, s, i in specs if i not in ("zero", "one")]
    gen = torch.Generator(device=device).manual_seed(seed)
    draws = torch.randn(sum(math.prod(s) for _, s, _ in drawn),
                        generator=gen, device=device, dtype=torch.float32)
    tree: Tree = {}
    at = 0
    for key, shape, init in specs:
        n = math.prod(shape)
        if init in ("zero", "one"):
            tree[key] = torch.full(shape, 1.0 if init == "one" else 0.0,
                                   dtype=torch.float32, device=device)
        else:
            tree[key] = draws[at:at + n].view(shape) * _std(shape, init)
            at += n
    images = frames(cfg, CALIBRATION_IMAGES, seed).to(device)
    calibrate_batch_norm(cfg, tree, images)
    return tree


def frames(cfg: dict, n: int, seed: int) -> torch.Tensor:
    """n synthetic scenes (portbench/data.py) at the padded width's side,
    cropped to the frame: (n, H, W, 3) uint8 on the host."""
    h, w = cfg["image_size"]
    images = data.synthetic(n, max(cfg["padded_size"]), seed)["image"]
    return torch.from_numpy(np.ascontiguousarray(images[:, :h, :w]))


def calibrate_batch_norm(cfg: dict, tree: Tree,
                         images_u8: torch.Tensor) -> None:
    """Set each BatchNorm's running mean and (biased) variance in `tree` to
    those of its input over `images_u8`, computed in float64 with TF32 off,
    stored in the tree's dtype."""
    with torch.no_grad(), harness.tf32(False):
        t64 = {k: v.to(torch.float64) for k, v in tree.items()}
        x = preprocess(cfg, images_u8, torch.float64).permute(0, 3, 1, 2)
        trunk(cfg, t64, x, calibrate=True)
    for k in tree:
        if k.startswith("batch_stats/"):
            tree[k] = t64[k].to(tree[k].dtype)


def check_tree(cfg: dict, tree) -> None:
    """Raise unless `tree` has exactly the configuration's leaves and
    shapes."""
    want = {k: tuple(s) for k, s, _ in weight_specs(cfg)}
    got = {k: tuple(v.shape) for k, v in tree.items()}
    if want != got:
        raise ValueError(
            f"weight tree differs from the reference's architecture: "
            f"missing {sorted(set(want) - set(got))[:5]}, extra "
            f"{sorted(set(got) - set(want))[:5]}, other shapes "
            f"{sorted(k for k in set(want) & set(got) if want[k] != got[k])[:5]}")


# ---------------------------------------------------------------------------
# The networks.
# ---------------------------------------------------------------------------

def preprocess(cfg: dict, images_u8: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """uint8 NHWC frames -> [0, 1], (x - mean) / std per channel, padded
    with zeros on the bottom and the right to the padded size."""
    mean, std = (torch.tensor(cfg[k], dtype=dtype, device=images_u8.device)
                 for k in ("image_mean", "image_std"))
    x = (images_u8.to(dtype) / 255.0 - mean) / std
    (ph, pw), (h, w) = cfg["padded_size"], x.shape[1:3]
    return F.pad(x, (0, 0, 0, pw - w, 0, ph - h))


def trunk(cfg: dict, tree: Tree, x: torch.Tensor,
          calibrate: bool = False) -> List[torch.Tensor]:
    """NCHW images -> [C2, C3, C4, C5] (`calibrate`: conv_bn's)."""
    eps = cfg["bn_eps"]
    cal = dict(calibrate=calibrate)
    x = conv_bn(x, tree, "backbone/stem", eps, 2, **cal)
    x = F.max_pool2d(x, 3, 2, 1)
    outs = {}
    for path, cin, _, cout, stride in blocks(cfg):
        y = conv_bn(x, tree, f"{path}/conv1", eps, **cal)
        y = conv_bn(y, tree, f"{path}/conv2", eps, stride, **cal)
        y = conv_bn(y, tree, f"{path}/conv3", eps, act=False, **cal)
        if stride != 1 or cin != cout:
            x = conv_bn(x, tree, f"{path}/downsample", eps, stride,
                        act=False, **cal)
        x = F.relu(y + x)
        outs[path.split("/")[1]] = x
    return [outs[f"layer{s}"] for s in (1, 2, 3, 4)]


def fpn(tree: Tree, feats: List[torch.Tensor]) -> List[torch.Tensor]:
    """[C2, ..., C5] -> [P2, ..., P6]."""
    inner = conv(feats[3], tree, "fpn/inner5")
    outs = [conv(inner, tree, "fpn/layer5")]
    for level in (4, 3, 2):
        c = feats[level - 2]
        inner = conv(c, tree, f"fpn/inner{level}") + F.interpolate(
            inner, size=c.shape[-2:], mode="nearest")
        outs.insert(0, conv(inner, tree, f"fpn/layer{level}"))
    return outs + [F.max_pool2d(outs[-1], 1, 2)]


def features(cfg: dict, tree: Tree, images: torch.Tensor
             ) -> List[torch.Tensor]:
    """NHWC normalised, padded images -> [P2, ..., P6]."""
    maps = fpn(tree, trunk(cfg, tree, images.permute(0, 3, 1, 2)))
    for m, shape in zip(maps, cfg["feature_map_shapes"]):
        if list(m.shape[-2:]) != list(shape):
            raise ValueError(f"a pyramid level is {tuple(m.shape)}, the "
                             f"configuration states {tuple(shape)}")
    return maps


def rpn_head(cfg: dict, tree: Tree, maps: List[torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[P2, ..., P6] -> (objectness (B, N), deltas (B, N, 4))."""
    a = anchors_per_cell(cfg)
    logits, deltas = [], []
    for p in maps:
        t = F.relu(conv(p, tree, "rpn/conv"))
        o, d = conv(t, tree, "rpn/cls_logits"), conv(t, tree, "rpn/bbox_pred")
        b, _, h, w = o.shape
        logits.append(o.permute(0, 2, 3, 1).reshape(b, h * w * a))
        deltas.append(d.view(b, a, 4, h, w).permute(0, 3, 4, 1, 2)
                      .reshape(b, h * w * a, 4))
    return torch.cat(logits, dim=1), torch.cat(deltas, dim=1)


def dense(x: torch.Tensor, tree: Tree, path: str) -> torch.Tensor:
    return x @ tree[f"params/{path}/kernel"] + tree[f"params/{path}/bias"]


def box_head(cfg: dict, tree: Tree, pooled: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, C, 7, 7) -> (class logits (R, classes), deltas (R, classes,
    4))."""
    x = F.relu(dense(pooled.flatten(1), tree, "box_head/fc6"))
    x = F.relu(dense(x, tree, "box_head/fc7"))
    return (dense(x, tree, "box_head/cls_score"),
            dense(x, tree, "box_head/bbox_pred").view(len(x), -1, 4))


def mask_head(cfg: dict, tree: Tree, pooled: torch.Tensor) -> torch.Tensor:
    """(R, C, 14, 14) -> (R, classes, 28, 28) logits."""
    x = pooled
    for i in range(1, len(cfg["mask_layers"]) + 1):
        x = F.relu(conv(x, tree, f"mask_head/mask_fcn{i}"))
    k = tree["params/mask_head/conv5_mask/kernel"]
    x = F.relu(F.conv_transpose2d(x, k.permute(3, 2, 0, 1),
                                  tree["params/mask_head/conv5_mask/bias"],
                                  stride=2))
    return conv(x, tree, "mask_head/mask_fcn_logits")


# ---------------------------------------------------------------------------
# Anchors, decode and RoIAlign.
# ---------------------------------------------------------------------------

def strides(cfg: dict) -> List[Tuple[int, int]]:
    ph, pw = cfg["padded_size"]
    return [(ph // h, pw // w) for h, w in cfg["feature_map_shapes"]]


def level_sizes(cfg: dict) -> List[int]:
    a = anchors_per_cell(cfg)
    return [h * w * a for h, w in cfg["feature_map_shapes"]]


def anchors(cfg: dict) -> np.ndarray:
    """(N, 4) float64 pixel anchors [x0, y0, x1, y1] on the padded batch,
    location-major, anchor next, P2 first; not clipped."""
    out = []
    for (h, w), (sy, sx), sizes in zip(cfg["feature_map_shapes"],
                                       strides(cfg), cfg["anchor_sizes"]):
        base = base_anchors(sizes, cfg["anchor_ratios"]).astype(np.float64)
        ys, xs = np.meshgrid(np.arange(h) * float(sy),
                             np.arange(w) * float(sx), indexing="ij")
        shifts = np.stack([xs, ys, xs, ys], axis=-1).reshape(-1, 1, 4)
        out.append((shifts + base[None]).reshape(-1, 4))
    a = np.concatenate(out)
    if len(a) != cfg["anchors"]:
        raise ValueError(f"{len(a)} anchors, the configuration states "
                         f"{cfg['anchors']}")
    return a


def decode(boxes: torch.Tensor, deltas: torch.Tensor, weights,
           clamp: float) -> torch.Tensor:
    """BoxCoder.decode_single: (..., 4) deltas (dx, dy, dw, dh) against
    (..., 4) pixel boxes -> [x0, y0, x1, y1], in the deltas' dtype."""
    b = boxes.to(deltas.dtype)
    w, h = b[..., 2] - b[..., 0], b[..., 3] - b[..., 1]
    cx, cy = b[..., 0] + 0.5 * w, b[..., 1] + 0.5 * h
    wx, wy, ww, wh = weights
    dx, dy = deltas[..., 0] / wx, deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp(max=clamp)
    dh = (deltas[..., 3] / wh).clamp(max=clamp)
    pcx, pcy = dx * w + cx, dy * h + cy
    hw, hh = 0.5 * (torch.exp(dw) * w), 0.5 * (torch.exp(dh) * h)
    return torch.stack([pcx - hw, pcy - hh, pcx + hw, pcy + hh], dim=-1)


def clip(cfg: dict, boxes: torch.Tensor) -> torch.Tensor:
    """Boxes clipped to the frame: x into [0, W], y into [0, H]."""
    h, w = cfg["image_size"]
    return torch.stack([boxes[..., 0].clamp(0, w), boxes[..., 1].clamp(0, h),
                        boxes[..., 2].clamp(0, w), boxes[..., 3].clamp(0, h)],
                       dim=-1)


def sides(boxes: torch.Tensor) -> torch.Tensor:
    """The smaller side of each box."""
    return torch.minimum(boxes[..., 2] - boxes[..., 0],
                         boxes[..., 3] - boxes[..., 1])


def roi_levels(cfg: dict, boxes: torch.Tensor,
               shift: float = 0.0) -> torch.Tensor:
    """LevelMapper: each box's index into the pooled levels, floor(4 +
    log2(sqrt(area) / 224) + 1e-6 + shift) clamped, in the boxes' dtype;
    `shift` moves the edges by the rounding room (judge)."""
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    lo, hi = cfg["roi_levels"][0], cfg["roi_levels"][-1]
    x = cfg["roi_canonical_level"] + torch.log2(
        torch.sqrt(area) / cfg["roi_canonical_scale"])
    level = torch.floor(x + torch.tensor(1e-6, dtype=boxes.dtype) + shift)
    return level.clamp(lo, hi).long() - lo


def _grid(start: torch.Tensor, end: torch.Tensor, p: int, s: int,
          size: int, border: float):
    """One axis of the samples of R boxes, torchvision's bilinear_interpolate
    on it: (R, P S) low and high index, their weights, and whether a
    sample lies beyond [-1, size] (+- `border`)."""
    step = (end - start).clamp_min(1.0) / p
    j = torch.arange(p * s, device=start.device)
    cell = torch.div(j, s, rounding_mode="floor").to(start.dtype)
    sub = (j % s).to(start.dtype) + 0.5
    at = (start[:, None] + cell * step[:, None]) + (sub * step[:, None]) / s
    beyond = (at < -1.0 - border) | (at > size + border)
    at = at.clamp_min(0.0)
    low = torch.floor(at)
    edge = low >= size - 1
    low = torch.where(edge, float(size - 1), low)
    high = torch.where(edge, low, low + 1)
    frac = torch.where(edge, low, at) - low
    return low.long(), high.long(), 1.0 - frac, frac, beyond


def roi_align(maps: List[torch.Tensor], boxes: torch.Tensor,
              levels: torch.Tensor, scales: List[float], size: int,
              ratio: int, border: float = 0.0) -> torch.Tensor:
    """torchvision's roi_align (aligned=False) of each box on its level:
    maps [(B, C, H_l, W_l)], (B, K, 4) pixel boxes and (B, K) level
    indices -> (B, K, C, size, size), the samples summed in row order and
    divided by ratio^2; `border` widens (or, negative, narrows) the range
    a sample reads in."""
    b, k, _ = boxes.shape
    c = maps[0].shape[1]
    p, s = size, ratio
    out = boxes.new_zeros((b, k, c, p, p))
    for i in range(b):
        for level, (m, scale) in enumerate(zip(maps, scales)):
            rows = torch.nonzero(levels[i] == level).reshape(-1)
            _, h, w = m[i].shape
            flat = m[i].reshape(c, h * w)
            for at in range(0, len(rows), CHUNK):
                part = rows[at:at + CHUNK]
                bx = boxes[i, part] * scale
                yl, yh, wyl, wyh, yb = _grid(bx[:, 1], bx[:, 3], p, s, h,
                                             border)
                xl, xh, wxl, wxh, xb = _grid(bx[:, 0], bx[:, 2], p, s, w,
                                             border)
                beyond = yb[:, :, None] | xb[:, None, :]
                total = None
                for y, wy in ((yl, wyl), (yh, wyh)):
                    for x, wx in ((xl, wxl), (xh, wxh)):
                        idx = torch.where(beyond, 0,
                                          y[:, :, None] * w + x[:, None, :])
                        wt = torch.where(beyond, 0.0,
                                         wy[:, :, None] * wx[:, None, :])
                        t = wt[None] * flat[:, idx.reshape(-1)].view(
                            c, *idx.shape)
                        total = t if total is None else total + t
                # (C, R, P S, P S) -> bins of S x S, summed in row order
                total = total.view(c, len(part), p, s, p, s)
                acc = torch.zeros_like(total[:, :, :, 0, :, 0])
                for iy in range(s):
                    for ix in range(s):
                        acc = acc + total[:, :, :, iy, :, ix]
                out[i, part] = (acc / float(s * s)).transpose(0, 1)
    return out


def pool(cfg: dict, maps: List[torch.Tensor], boxes: torch.Tensor,
         size: int, shift: float = 0.0, border: float = 0.0
         ) -> torch.Tensor:
    """(B, K, 4) boxes pooled on their levels of P2-P5 -> (B * K, C, size,
    size)."""
    n = len(cfg["roi_levels"])
    scales = [2.0 ** -lv for lv in cfg["roi_levels"]]
    return roi_align(maps[:n], boxes, roi_levels(cfg, boxes, shift), scales,
                     size, cfg["roi_sampling_ratio"], border).flatten(0, 1)


# ---------------------------------------------------------------------------
# The two selections.
# ---------------------------------------------------------------------------

def greedy(boxes: torch.Tensor, scores: torch.Tensor, groups: torch.Tensor,
           thr: float) -> torch.Tensor:
    """Greedy NMS within each group of the candidates: (T, 4) boxes, (T,)
    scores and groups -> the kept candidates' indices, group by group in
    ascending order, by score within a group (ties to the lower index)."""
    if len(scores) == 0:
        return torch.zeros(0, dtype=torch.long, device=scores.device)
    ids = torch.unique(groups)
    members = [torch.nonzero(groups == g).reshape(-1) for g in ids.tolist()]
    members = [m[_top(scores[m], len(m))] for m in members]
    n = max(len(m) for m in members)
    pad = torch.stack([F.pad(m, (0, n - len(m)), value=-1) for m in members])
    real = pad >= 0
    cand = boxes[pad.clamp_min(0)]                              # (G, n, 4)
    over = (iou(cand, cand) > thr).triu(1)
    keep = real.clone()
    for j in range(n):
        keep = keep & ~(keep[:, j:j + 1] & over[:, j, :])
    return pad[keep]


def rpn_postprocess(cfg: dict, anchors_t: torch.Tensor,
                    objectness: torch.Tensor, deltas: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
    """The proposals of each image -> {'proposals' (B, K, 4), 'scores' (B,
    K), 'count' (B,)}, K = rpn_post_nms_top_n, zeros past the count."""
    k_out = cfg["rpn_post_nms_top_n"]
    out = {"proposals": [], "scores": [], "count": []}
    for i in range(objectness.shape[0]):
        idx, lv, at = [], [], 0
        for level, n in enumerate(level_sizes(cfg)):
            top = _top(objectness[i, at:at + n],
                       min(cfg["rpn_pre_nms_top_n"], n))
            idx.append(top + at)
            lv.append(torch.full_like(top, level))
            at += n
        idx, lv = torch.cat(idx), torch.cat(lv)
        boxes = clip(cfg, decode(anchors_t[idx], deltas[i, idx],
                                 cfg["rpn_box_weights"], cfg["box_clamp"]))
        scores = torch.sigmoid(objectness[i, idx])
        ok = ((boxes[:, 2] - boxes[:, 0] >= cfg["rpn_min_size"])
              & (boxes[:, 3] - boxes[:, 1] >= cfg["rpn_min_size"])
              & (scores >= cfg["rpn_score_threshold"]))
        idx_ok = torch.nonzero(ok).reshape(-1)
        kept = idx_ok[greedy(boxes[idx_ok], scores[idx_ok], lv[idx_ok],
                             cfg["rpn_nms_iou_threshold"])]
        kept = kept[_top(scores[kept], len(kept))][:k_out]
        pad = k_out - len(kept)
        out["proposals"].append(F.pad(boxes[kept], (0, 0, 0, pad)))
        out["scores"].append(F.pad(scores[kept], (0, pad)))
        out["count"].append(torch.tensor(len(kept), device=scores.device))
    return {k: torch.stack(v) for k, v in out.items()}


def box_candidates(cfg: dict, proposals: torch.Tensor,
                   class_logits: torch.Tensor, deltas: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One image's K proposals and the box head's outputs -> decoded,
    clipped boxes (K, C-1, 4) and softmax scores (K, C-1) of the
    foreground classes."""
    boxes = clip(cfg, decode(proposals[:, None, :], deltas,
                             cfg["box_weights"], cfg["box_clamp"]))
    return boxes[:, 1:], torch.softmax(class_logits, dim=-1)[:, 1:]


def box_postprocess(cfg: dict, proposals: torch.Tensor, count: torch.Tensor,
                    class_logits: torch.Tensor, deltas: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
    """postprocess_detections of each image's first count[i] proposals ->
    {'boxes' (B, D, 4), 'scores' (B, D), 'classes' (B, D) in 1..C-1 (0
    padding), 'valid' (B,)}, D = box_detections_per_img."""
    total = cfg["box_detections_per_img"]
    out = {k: [] for k in ("boxes", "scores", "classes", "valid")}
    for i in range(proposals.shape[0]):
        n = int(count[i])
        boxes, scores = box_candidates(cfg, proposals[i, :n],
                                       class_logits[i, :n], deltas[i, :n])
        fg = scores.shape[1]
        boxes, scores = boxes.reshape(-1, 4), scores.reshape(-1)
        classes = torch.arange(fg, device=scores.device).repeat(n)
        ok = ((scores > cfg["box_score_threshold"])
              & (sides(boxes) >= cfg["box_min_size"]))
        cand = torch.nonzero(ok).reshape(-1)
        kept = cand[greedy(boxes[cand], scores[cand], classes[cand],
                           cfg["box_nms_iou_threshold"])]
        kept = kept[_top(scores[kept], len(kept))][:total]
        v, pad = len(kept), total - len(kept)
        out["boxes"].append(F.pad(boxes[kept], (0, 0, 0, pad)))
        out["scores"].append(F.pad(scores[kept], (0, pad)))
        out["classes"].append(F.pad(classes[kept] + 1, (0, pad)))
        out["valid"].append(torch.tensor(v, device=scores.device))
    return {k: torch.stack(v) for k, v in out.items()}


def mask_probs(cfg: dict, tree: Tree, maps: List[torch.Tensor],
               boxes: torch.Tensor, classes: torch.Tensor,
               shift: float = 0.0, border: float = 0.0) -> torch.Tensor:
    """The mask head on (B, D, 4) boxes -> (B, D, M, M) sigmoid maps of
    each row's class (channel = class)."""
    b, d = classes.shape
    logits = mask_head(cfg, tree, pool(cfg, maps, boxes, cfg["mask_roi_size"],
                                       shift, border))
    m = logits.shape[-1]
    pick = logits.view(b, d, -1, m, m)[
        torch.arange(b)[:, None], torch.arange(d)[None, :], classes.long()]
    return torch.sigmoid(pick)


def predict(cfg: dict, tree: Tree, images_u8: torch.Tensor,
            dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
    """The whole predict in `dtype` (the control): a reply in the
    program's MaskRCNNResult order (boxes, scores, classes, valid, masks,
    proposals, proposal_scores, proposal_count)."""
    maps = features(cfg, tree, preprocess(cfg, images_u8, dtype))
    objectness, deltas = rpn_head(cfg, tree, maps)
    a = torch.from_numpy(anchors(cfg)).to(images_u8.device, dtype)
    rpn = rpn_postprocess(cfg, a, objectness, deltas)
    b, k = rpn["scores"].shape
    logits, box_deltas = box_head(cfg, tree, pool(
        cfg, maps, rpn["proposals"], cfg["box_roi_size"]))
    det = box_postprocess(cfg, rpn["proposals"], rpn["count"],
                          logits.view(b, k, -1),
                          box_deltas.view(b, k, -1, 4))
    masks = mask_probs(cfg, tree, maps, det["boxes"], det["classes"])
    live = torch.arange(masks.shape[1], device=masks.device) < det[
        "valid"][:, None]
    masks = torch.where(live[..., None, None], masks, 0.0)
    return (det["boxes"], det["scores"], det["classes"], det["valid"],
            masks, rpn["proposals"], rpn["scores"], rpn["count"])


# ---------------------------------------------------------------------------
# FLOPs and the comparison.
# ---------------------------------------------------------------------------

def model_flops(cfg: dict) -> float:
    """FLOPs of the networks for one image at the published caps (every
    proposal through the box head, every detection through the mask
    head), counted by torch.utils.flop_counter over this reference on the
    meta device (no arithmetic runs); RoIAlign and the selections are not
    counted."""
    from torch.utils.flop_counter import FlopCounterMode

    tree = {k: torch.empty(s, device="meta") for k, s, _ in weight_specs(cfg)}
    h, w = cfg["padded_size"]
    c = cfg["fpn_channels"]
    with FlopCounterMode(display=False) as counter:
        maps = fpn(tree, trunk(cfg, tree, torch.empty((1, 3, h, w),
                                                      device="meta")))
        rpn_head(cfg, tree, maps)
        box_head(cfg, tree, torch.empty(
            (cfg["rpn_post_nms_top_n"], c, cfg["box_roi_size"],
             cfg["box_roi_size"]), device="meta"))
        mask_head(cfg, tree, torch.empty(
            (cfg["box_detections_per_img"], c, cfg["mask_roi_size"],
             cfg["mask_roi_size"]), device="meta"))
    return float(counter.get_total_flops())


def _box_gap(cfg: dict, ref: torch.Tensor, got: torch.Tensor
             ) -> torch.Tensor:
    """max over the four coordinates of |ref - got| in units of the
    frame's width (x) and height (y), broadcast."""
    h, w = cfg["image_size"]
    side = torch.tensor([w, h, w, h], dtype=ref.dtype, device=ref.device)
    return ((ref - got) / side).abs().amax(dim=-1)


def _grown(boxes: torch.Tensor, eps: float) -> torch.Tensor:
    """Boxes grown by eps on every side (shrunk for a negative eps, to no
    less than a point)."""
    lo = boxes[..., :2] - eps
    hi = torch.maximum(boxes[..., 2:] + eps, lo)
    return torch.cat([lo, hi], dim=-1)


def iou_range(a: torch.Tensor, b: torch.Tensor, eps: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The least and the largest IoU of [..., A, 4] and [..., B, 4] boxes
    when each coordinate may lie up to eps off: the intersection of the
    shrunk boxes over the union of the grown ones, and the intersection of
    the grown boxes over the union of the shrunk ones (at most 1)."""
    def inter(x, y):
        x, y = x[..., :, None, :], y[..., None, :, :]
        wh = (torch.minimum(x[..., 2:], y[..., 2:])
              - torch.maximum(x[..., :2], y[..., :2])).clamp_min(0)
        return wh[..., 0] * wh[..., 1]

    def area(x):
        return ((x[..., 2] - x[..., 0]).clamp_min(0)
                * (x[..., 3] - x[..., 1]).clamp_min(0))

    bounds = []
    for i_eps, u_eps in ((-eps, eps), (eps, -eps)):
        ia, ib = _grown(a, i_eps), _grown(b, i_eps)
        i = inter(ia, ib)
        union = (area(_grown(a, u_eps))[..., :, None]
                 + area(_grown(b, u_eps))[..., None, :] - i)
        bounds.append(torch.where(union > i, i / union.clamp_min(1e-8),
                                  (i > 0).to(i.dtype)))
    return bounds[0], bounds[1]


def _above_cut(above: torch.Tensor) -> torch.Tensor:
    """How far scores lie above a top-k cut (`above` = score - cut), 0
    within SCORE_SLACK of it: a candidate that the program's float32
    scores ranked on the other side of a near-tie at the cut is not a
    fault. (At the box stage's top 100 of up to 19,000 pairs an image,
    neighbours at the cut lie 1e-5 apart and closer.)"""
    return torch.where(above > SCORE_SLACK, above, torch.zeros_like(above))


def _box_error(ref: torch.Tensor, got: torch.Tensor) -> float:
    """The largest pixel distance of a coordinate of the served boxes from
    the reference's boxes they were matched to: how far rounding moved a
    box in this image, the room iou_range gives each box."""
    return float((ref - got).abs().max()) if len(got) else 0.0


def _judge_rpn(cfg: dict, ref_boxes: torch.Tensor, ref_scores: torch.Tensor,
               boxes: torch.Tensor, scores: torch.Tensor,
               n: int) -> Tuple[float, float]:
    """(rpn_det_gap, rpn_sel_gap) of one image's n served proposals
    against the reference's decode of every anchor (N, 4) and its sigmoid
    objectness (N,): detect.py's det_gap and sel_gap with the anchor's
    level as the class, IoU rpn_nms_iou_threshold and the cuts of the
    proposals (each level's top-k, boxes too small, the top K; a top-k's
    cut read either way within SCORE_SLACK, _above_cut)."""
    dev = ref_scores.device
    sizes = level_sizes(cfg)
    level = torch.cat([torch.full((s,), i, device=dev)
                       for i, s in enumerate(sizes)])
    box = boxes[:n].to(ref_boxes.dtype)
    score = scores[:n].to(ref_scores.dtype)
    det, match = 0.0, torch.zeros(n, dtype=torch.long, device=dev)
    for at in range(0, n, CHUNK):
        d = torch.maximum((ref_scores[:, None] - score[None, at:at + CHUNK]
                           ).abs(), _box_gap(cfg, ref_boxes[:, None],
                                             box[None, at:at + CHUNK]))
        best, match[at:at + CHUNK] = d.min(dim=0)
        det = max(det, float(best.max()))
    if not math.isfinite(det):
        return math.inf, math.inf
    if len(torch.unique(match)) != n:
        return det, math.inf
    thr = cfg["rpn_nms_iou_threshold"]
    sb, ss, sl = ref_boxes[match], ref_scores[match], level[match]
    eps = _box_error(sb, box)
    small = cfg["rpn_min_size"]
    sel = 0.0
    if n and float(sides(sb).min()) < small - SIZE_SLACK:
        return det, math.inf
    if n > 1:
        same = (sl[:, None] == sl[None, :]) & ~torch.eye(
            n, dtype=torch.bool, device=dev)
        over = torch.where(same, iou_range(sb, sb, eps)[0], 0.0)
        sel = max(0.0, float(over.max()) - thr)
    cut = (float(ss.min()) if n >= cfg["rpn_post_nms_top_n"] and n
           else -math.inf)
    excess = torch.empty_like(ref_scores)
    at = 0
    for size in sizes:
        s = ref_scores[at:at + size]
        k = cfg["rpn_pre_nms_top_n"]
        level_cut = torch.topk(s, k).values[-1] if k < size else -math.inf
        excess[at:at + size] = torch.minimum(_above_cut(s - level_cut),
                                             _above_cut(s - cut))
        at += size
    excess = torch.where(sides(ref_boxes) < small + SIZE_SLACK, 0.0, excess)
    excess[match] = 0.0
    open_ = torch.nonzero(excess > 0).reshape(-1)
    if n and len(open_):
        overlap = iou_range(ref_boxes[open_], sb, eps)[1] > thr - IOU_SLACK
        sup = (overlap & (level[open_, None] == sl[None, :])
               & (ss[None, :] >= ref_scores[open_, None] - SCORE_SLACK)
               ).any(dim=1)
        excess[open_[sup]] = 0.0
    return det, max(sel, float(excess.max().clamp_min(0.0)))


def _judge_boxes(cfg: dict, ref_boxes: torch.Tensor,
                 ref_scores: torch.Tensor, origin: torch.Tensor,
                 rows: int, boxes: torch.Tensor, scores: torch.Tensor,
                 classes: torch.Tensor, v: int) -> Tuple[float, float]:
    """(det_gap, sel_gap) of one image's v served detections against the
    reference's box head on the served proposals: decoded, clipped boxes
    (R', C', 4) and softmax scores (R', C') of R' rows, each the outputs
    of proposal origin[r] < rows (a proposal with two readings of a
    rounding choice has two rows). The cuts: the score threshold, boxes
    too small, the top D (when full; read either way within SCORE_SLACK,
    _above_cut), suppression by a served detection of the class."""
    dev = ref_scores.device
    nr, c = ref_scores.shape
    thr = cfg["box_nms_iou_threshold"]
    small = cfg["box_min_size"]
    if v == 0:
        det, served_row = 0.0, torch.zeros(0, dtype=torch.long, device=dev)
        cls = served_row
    else:
        cls = classes[:v].long() - 1
        d = torch.maximum(
            (ref_scores[:, cls] - scores[None, :v].to(ref_scores.dtype)
             ).abs(),
            _box_gap(cfg, ref_boxes[:, cls], boxes[None, :v].to(
                ref_boxes.dtype)))                                # (R', V)
        best, served_row = d.min(dim=0)
        det = float(best.max())
        if not math.isfinite(det):
            return math.inf, math.inf
    key = origin[served_row] * c + cls
    if len(torch.unique(key)) != len(key):
        return det, math.inf
    sb = ref_boxes[served_row, cls]                                # (V, 4)
    ss = ref_scores[served_row, cls]
    eps = _box_error(sb, boxes[:v].to(sb.dtype))
    if v and float(sides(sb).min()) < small - SIZE_SLACK:
        return det, math.inf
    sel = 0.0
    if v > 1:
        same = (cls[:, None] == cls[None, :]) & ~torch.eye(
            v, dtype=torch.bool, device=dev)
        sel = max(0.0, float(torch.where(same, iou_range(sb, sb, eps)[0],
                                         0.0).max()) - thr)
    cut = (float(ss.min()) if v >= cfg["box_detections_per_img"] and v
           else -math.inf)
    excess = torch.minimum(ref_scores - cfg["box_score_threshold"],
                           _above_cut(ref_scores - cut))
    excess = torch.where(sides(ref_boxes) < small + SIZE_SLACK, 0.0, excess)
    open_r, open_c = torch.nonzero(excess > 0, as_tuple=True)
    if v and len(open_r):
        overlap = iou_range(ref_boxes[open_r, open_c][:, None], sb[None],
                            eps)[1][:, 0]
        sup = ((overlap > thr - IOU_SLACK)
               & (open_c[:, None] == cls[None, :])
               & (ss[None, :] >= ref_scores[open_r, open_c][:, None]
                  - SCORE_SLACK)).any(dim=1)
        excess[open_r[sup], open_c[sup]] = 0.0
    # a served (proposal, class) is explained in each of its rows; a
    # proposal with two rows is explained where either row is
    for r, cl in zip(origin[served_row].tolist(), cls.tolist()):
        excess[origin == r, cl] = 0.0
    if rows == 0:
        return det, sel
    folded = torch.full((rows, c), math.inf, dtype=excess.dtype, device=dev)
    folded = folded.scatter_reduce(0, origin[:, None].expand(-1, c), excess,
                                   "amin")
    return det, max(sel, float(folded.max().clamp_min(0.0)))


def _two_readings(fn, boxes: torch.Tensor):
    """fn(shift, border) at both sides of the rounding room of the
    levels and the border -> (the first's (B, K, ...) outputs, the
    second's, and (B, K) where they differ)."""
    hi = fn(LEVEL_SLACK, BORDER_SLACK)
    lo = fn(-LEVEL_SLACK, -BORDER_SLACK)
    diff = (hi != lo).reshape(*boxes.shape[:2], -1).any(dim=-1)
    return hi, lo, diff


def judge(cfg: dict, tree: Tree, images_u8: torch.Tensor,
          served: Tuple) -> Dict[str, float]:
    """The numbers of one chunk of images, each the worst over them, for
    the reference (`tree` in its dtype, on the images' device) and
    `served` = the program's reply in MaskRCNNResult's order, on that
    device. Each stage of the reference runs on the program's own input
    to it:
      rpn_det_gap / rpn_sel_gap: the served proposals against the
        reference's RPN over every anchor (_judge_rpn);
      det_gap / sel_gap: the served detections against the reference's
        box head on the served proposals (_judge_boxes);
      mask_gap: the largest absolute gap of a served mask probability from
        the reference's mask head on the served detection boxes.
    A box's level and a sample at a map's border, within rounding of their
    edges, are read both ways, and either is accepted; so is a candidate
    within SCORE_SLACK of a top-k's cut, on either side of it. Non-finite
    values, counts outside their range, classes outside 1..C-1 and padding
    rows that are not zero read infinity."""
    boxes, scores, classes, valid, masks, props, prop_scores, count = served
    inf = {k: math.inf for k in ("rpn_det_gap", "rpn_sel_gap", "det_gap",
                                 "sel_gap", "mask_gap")}
    dtype = next(iter(tree.values())).dtype
    b, d = scores.shape
    k_cap = cfg["rpn_post_nms_top_n"]
    fg = cfg["num_classes"] - 1
    if (tuple(props.shape) != (b, k_cap, 4) or d != cfg[
            "box_detections_per_img"] or tuple(masks.shape[1:]) != (
                d, 2 * cfg["mask_roi_size"], 2 * cfg["mask_roi_size"])):
        return inf
    for i in range(b):
        n, v = int(count[i]), int(valid[i])
        if not (0 <= n <= k_cap and 0 <= v <= d):
            return inf
        if bool(((classes[i, :v] < 1) | (classes[i, :v] > fg)).any()):
            return inf
        finite = all(bool(torch.isfinite(t).all()) for t in (
            props[i, :n], prop_scores[i, :n], boxes[i, :v], scores[i, :v],
            masks[i, :v]))
        padded = all(not bool(t.any()) for t in (
            props[i, n:], prop_scores[i, n:], boxes[i, v:], scores[i, v:],
            classes[i, v:], masks[i, v:]))
        if not (finite and padded):
            return inf
    worst = {k: 0.0 for k in inf}
    maps = features(cfg, tree, preprocess(cfg, images_u8, dtype))
    objectness, deltas = rpn_head(cfg, tree, maps)
    a = torch.from_numpy(anchors(cfg)).to(images_u8.device, dtype)
    for i in range(b):
        ref_boxes = clip(cfg, decode(a, deltas[i], cfg["rpn_box_weights"],
                                     cfg["box_clamp"]))
        gaps = _judge_rpn(cfg, ref_boxes, torch.sigmoid(objectness[i]),
                          props[i], prop_scores[i], int(count[i]))
        worst["rpn_det_gap"] = max(worst["rpn_det_gap"], gaps[0])
        worst["rpn_sel_gap"] = max(worst["rpn_sel_gap"], gaps[1])
    del objectness, deltas
    p64 = props.to(dtype)

    def heads(shift, border):
        logits, box_deltas = box_head(cfg, tree, pool(
            cfg, maps, p64, cfg["box_roi_size"], shift, border))
        return torch.cat([logits, box_deltas.flatten(1)], dim=1).view(
            b, k_cap, -1)

    hi, lo, two = _two_readings(heads, p64)
    c = cfg["num_classes"]
    for i in range(b):
        n = int(count[i])
        alt = torch.nonzero(two[i, :n]).reshape(-1)
        out = torch.cat([hi[i, :n], lo[i, alt]])
        origin = torch.cat([torch.arange(n, device=alt.device), alt])
        ref_boxes, ref_scores = box_candidates(
            cfg, p64[i, origin], out[:, :c], out[:, c:].reshape(-1, c, 4))
        gaps = _judge_boxes(cfg, ref_boxes, ref_scores, origin, n, boxes[i],
                            scores[i], classes[i], int(valid[i]))
        worst["det_gap"] = max(worst["det_gap"], gaps[0])
        worst["sel_gap"] = max(worst["sel_gap"], gaps[1])
    del hi, lo
    det_boxes = boxes.to(dtype)
    got = masks.to(dtype)

    def probs(shift, border):
        return mask_probs(cfg, tree, maps, det_boxes, classes, shift,
                          border)

    m_hi, m_lo, _ = _two_readings(probs, det_boxes)
    for i in range(b):
        v = int(valid[i])
        if v:
            gap = torch.minimum(
                (m_hi[i, :v] - got[i, :v]).abs().flatten(1).amax(dim=1),
                (m_lo[i, :v] - got[i, :v]).abs().flatten(1).amax(dim=1))
            worst["mask_gap"] = max(worst["mask_gap"], float(gap.max()))
    return worst
