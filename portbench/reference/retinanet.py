"""The plain reference of RetinaNet with a ResNeXt50-32x4d FPN trunk, as
MLPerf Inference runs it (v2.1 on): architecture, seeded weights, forward
pass, anchors, decode, selection and class-wise NMS, the FLOP count, and
the comparison that judges a served NMSResult.

Written from torchvision's retinanet_resnet50_fpn (v1) code, on which
MLPerf's reference is built, with ResNeXt50-32x4d (Xie et al.,
arXiv:1611.05431) in place of ResNet50, the feature pyramid of Lin et al.
(arXiv:1612.03144) and the subnets of "Focal Loss for Dense Object
Detection" (Lin et al., arXiv:1708.02002):

  trunk: a 7x7 stride-2 conv to 64 (pad 3, no bias), BatchNorm, ReLU, a
  3x3 stride-2 max pool (pad 1); four stages of 3 / 4 / 6 / 3 bottlenecks
  of width 128 / 256 / 512 / 1,024 and output 256 / 512 / 1,024 / 2,048:
  1x1 conv, BN, ReLU; 3x3 conv with 32 groups and the stage's stride (2 in
  the first block of stages 2-4), BN, ReLU; 1x1 conv, BN; a 1x1 strided
  conv and BN on the shortcut where the shape changes; add, ReLU.
  BatchNorm is frozen (running statistics, epsilon 1e-5). C3-C5 are the
  outputs of stages 2-4.
  FPN: a 1x1 lateral conv with bias to 256 on each of C3-C5; inner5 =
  lat(C5), inner4 = lat(C4) + nearest(inner5, C4's size), inner3 likewise;
  P3-P5 a 3x3 conv with bias on each inner; P6 a 3x3 stride-2 conv on P5,
  P7 a 3x3 stride-2 conv on ReLU(P6) (torchvision's LastLevelP6P7(256,
  256); the paper takes P6 from C5).
  Heads, one set of weights over all levels: 4 x (3x3 conv 256 -> 256
  with bias, ReLU), then a 3x3 conv to 9 x classes (class subnet) or 9 x 4
  (box subnet); outputs location-major, anchor next, class last, the
  levels concatenated P3 first.
  Anchors: torchvision's AnchorGenerator, sizes (x, int(x 2^(1/3)),
  int(x 2^(2/3))) for x = 32 ... 512 on P3-P7, ratios (0.5, 1, 2)
  ratio-major, base boxes round([-w/2, -h/2, w/2, h/2]) with h = size
  sqrt(r), w = size / sqrt(r) in float32, shifted by (j stride, i stride)
  with stride = image side // map side (61 and 114 on P6 and P7 at 800).
  Decode: weights (1, 1, 1, 1), dw and dh clamped above at log(1000/16),
  boxes clipped to the image.
  Selection: scores sigmoid(logits); per image and level the (anchor,
  class) pairs scoring above 0.05, their top 1,000; class-wise greedy NMS
  at IoU 0.5 over all levels' candidates; the top 300 kept by score.

Departures from torchvision's code:
  - weights are a flat dict keyed by Flax-style names with HWIO kernels,
    the layout of reference/ssd.py; seeded (seeded_weights): He-normal
    trunk and FPN, the heads from a normal of std 0.01 as torchvision's
    but without the class conv's prior bias -log(99), so that every
    level's top 1,000 is full; zero biases; BatchNorm scale 1 and shift 0
    with running statistics taken from synthetic scenes;
  - boxes are normalised by the image's side and y-first, [y0, x0, y1,
    x1], as the system's other configurations give them (torchvision:
    pixels, x-first); the box subnet's outputs keep torchvision's (dx, dy,
    dw, dh) order; classes are 1..C (channel c is class c + 1), 0 on
    padding (torchvision: the channel);
  - images come at the configuration's side, so GeneralizedRCNNTransform's
    resize is the identity; its normalisation is kept;
  - score ties in the top-k and in the ordering go to the lower index
    (torch.topk promises no order); class-wise NMS is greedy NMS per class
    (batched_nms's coordinate offsets decide the same, up to their
    rounding).

Everything computes in the dtype of the tensors it is given (float64 for
the reference, float32 for the lower-precision control); the seeded
weights' calibration computes with TF32 off. This file imports torch,
numpy, the standard library and portbench's data, harness and detect
modules only.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench import data, harness
from portbench.reference.detect import IOU_SLACK, SCORE_SLACK, iou

Tree = Dict[str, torch.Tensor]

# The heads' kernels: torchvision's RetinaNetHead draws them from a normal
# of this std.
HEAD_STD = 0.01
# Synthetic scenes of the seed whose statistics the BatchNorms take.
CALIBRATION_IMAGES = 2


# ---------------------------------------------------------------------------
# Architecture: the leaves of the weight tree.
# ---------------------------------------------------------------------------

def _conv_bn(specs, path: str, k: int, cin: int, cout: int) -> None:
    specs.append((f"params/{path}/conv/kernel", (k, k, cin, cout), "conv"))
    specs.append((f"params/{path}/bn/scale", (cout,), "one"))
    specs.append((f"params/{path}/bn/bias", (cout,), "zero"))
    specs.append((f"batch_stats/{path}/bn/mean", (cout,), "zero"))
    specs.append((f"batch_stats/{path}/bn/var", (cout,), "one"))


def _conv(specs, path: str, k: int, cin: int, cout: int,
          init: str = "conv") -> None:
    specs.append((f"params/{path}/kernel", (k, k, cin, cout), init))
    specs.append((f"params/{path}/bias", (cout,), "zero"))


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


def weight_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(key, shape, init) of every leaf; init is 'conv' (He normal), 'head'
    (normal, std HEAD_STD), 'zero' or 'one'. A grouped kernel is (k, k,
    in / groups, out)."""
    specs: list = []
    g = cfg["groups"]
    _conv_bn(specs, "backbone/stem", 7, 3, cfg["stem_channels"])
    for path, cin, width, cout, stride in blocks(cfg):
        _conv_bn(specs, f"{path}/conv1", 1, cin, width)
        _conv_bn(specs, f"{path}/conv2", 3, width // g, width)
        _conv_bn(specs, f"{path}/conv3", 1, width, cout)
        if stride != 1 or cin != cout:
            _conv_bn(specs, f"{path}/downsample", 1, cin, cout)
    f = cfg["fpn_channels"]
    for level, c in zip((3, 4, 5), cfg["stage_channels"][1:]):
        _conv(specs, f"fpn/inner{level}", 1, c, f)
        _conv(specs, f"fpn/layer{level}", 3, f, f)
    _conv(specs, "fpn/p6", 3, f, f)
    _conv(specs, "fpn/p7", 3, f, f)
    a = anchors_per_cell(cfg)
    for sub, out in (("cls", a * cfg["num_classes"]), ("box", a * 4)):
        for i in range(cfg["head_convs"]):
            _conv(specs, f"head/{sub}_conv{i}", 3, f, f, "head")
        _conv(specs, f"head/{sub}_out", 3, f, out, "head")
    return specs


def seeded_weights(cfg: dict, seed: int, device) -> Tree:
    """The configuration's tree from `seed`, float32: the trunk's and the
    FPN's kernels a normal scaled by sqrt(2 / fan_in) (He; a grouped
    kernel's fan-in is its group's), the heads' a normal of std HEAD_STD
    (torchvision's RetinaNetHead, without its prior bias), all drawn in
    one call from a torch.Generator on `device` in the order of
    weight_specs; biases and BatchNorm shifts zero, BatchNorm scales one,
    and each BatchNorm's running mean and variance those of its input over
    CALIBRATION_IMAGES synthetic scenes of the seed (calibrate_batch_norm).
    With identity statistics instead, each of the 16 residual blocks adds
    its branch's variance to the trunk's, C5 reaches ~780 and the logits
    ~2,700 (float64 at 128 pixels): every score would be 0 or 1."""
    specs = weight_specs(cfg)
    total = sum(math.prod(s) for _, s, init in specs
                if init in ("conv", "head"))
    gen = torch.Generator(device=device).manual_seed(seed)
    draws = torch.randn(total, generator=gen, device=device,
                        dtype=torch.float32)
    tree: Tree = {}
    at = 0
    for key, shape, init in specs:
        n = math.prod(shape)
        if init in ("conv", "head"):
            std = (math.sqrt(2.0 / (shape[0] * shape[1] * shape[2]))
                   if init == "conv" else HEAD_STD)
            tree[key] = draws[at:at + n].view(shape) * std
            at += n
        else:
            tree[key] = torch.full(shape, 1.0 if init == "one" else 0.0,
                                   dtype=torch.float32, device=device)
    images = torch.from_numpy(data.synthetic(
        CALIBRATION_IMAGES, cfg["img_size"], seed)["image"]).to(device)
    calibrate_batch_norm(cfg, tree, images)
    return tree


def calibrate_batch_norm(cfg: dict, tree: Tree,
                         images_u8: torch.Tensor) -> None:
    """Set each BatchNorm's running mean and (biased) variance in `tree` to
    those of its input over `images_u8`, stage by stage, as BatchNorm in
    training mode would normalise that batch; computed in float64 with
    TF32 off, stored in the tree's dtype."""
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
# Forward pass.
# ---------------------------------------------------------------------------

def conv(x: torch.Tensor, tree: Tree, path: str, stride: int = 1,
         groups: int = 1, bias: bool = True) -> torch.Tensor:
    """NCHW conv with an HWIO kernel, PyTorch's symmetric padding k // 2."""
    kernel = tree[f"params/{path}/kernel"]
    w = kernel.permute(3, 2, 0, 1)
    b = tree[f"params/{path}/bias"] if bias else None
    return F.conv2d(x, w, b, stride, kernel.shape[0] // 2, 1, groups)


def conv_bn(x: torch.Tensor, tree: Tree, path: str, eps: float,
            stride: int = 1, groups: int = 1, act: bool = True,
            calibrate: bool = False) -> torch.Tensor:
    """Conv without bias, then frozen BatchNorm as torchvision's
    FrozenBatchNorm2d computes it: x * scale + (bias - mean * scale),
    scale = weight * rsqrt(var + eps). With `calibrate` the running
    statistics in `tree` are first set to the conv output's."""
    x = conv(x, tree, f"{path}/conv", stride, groups, bias=False)
    if calibrate:
        tree[f"batch_stats/{path}/bn/mean"] = x.mean(dim=(0, 2, 3))
        tree[f"batch_stats/{path}/bn/var"] = x.var(dim=(0, 2, 3),
                                                   unbiased=False)
    scale = tree[f"params/{path}/bn/scale"] * torch.rsqrt(
        tree[f"batch_stats/{path}/bn/var"] + eps)
    shift = tree[f"params/{path}/bn/bias"] - tree[
        f"batch_stats/{path}/bn/mean"] * scale
    x = x * scale[:, None, None] + shift[:, None, None]
    return F.relu(x) if act else x


def trunk(cfg: dict, tree: Tree, x: torch.Tensor,
          calibrate: bool = False) -> List[torch.Tensor]:
    """NCHW images -> [C3, C4, C5] (`calibrate`: conv_bn's)."""
    eps, g = cfg["bn_eps"], cfg["groups"]
    cal = dict(calibrate=calibrate)
    x = conv_bn(x, tree, "backbone/stem", eps, 2, **cal)
    x = F.max_pool2d(x, 3, 2, 1)
    outs = {}
    for path, cin, _, cout, stride in blocks(cfg):
        y = conv_bn(x, tree, f"{path}/conv1", eps, **cal)
        y = conv_bn(y, tree, f"{path}/conv2", eps, stride, g, **cal)
        y = conv_bn(y, tree, f"{path}/conv3", eps, act=False, **cal)
        if stride != 1 or cin != cout:
            x = conv_bn(x, tree, f"{path}/downsample", eps, stride,
                        act=False, **cal)
        x = F.relu(y + x)
        outs[path.split("/")[1]] = x
    return [outs["layer2"], outs["layer3"], outs["layer4"]]


def fpn(tree: Tree, feats: List[torch.Tensor]) -> List[torch.Tensor]:
    """[C3, C4, C5] -> [P3, P4, P5, P6, P7]."""
    inner = conv(feats[2], tree, "fpn/inner5")
    outs = [conv(inner, tree, "fpn/layer5")]
    for level, c in ((4, feats[1]), (3, feats[0])):
        inner = conv(c, tree, f"fpn/inner{level}") + F.interpolate(
            inner, size=c.shape[-2:], mode="nearest")
        outs.insert(0, conv(inner, tree, f"fpn/layer{level}"))
    p6 = conv(outs[-1], tree, "fpn/p6", 2)
    p7 = conv(F.relu(p6), tree, "fpn/p7", 2)
    return outs + [p6, p7]


def head(cfg: dict, tree: Tree, maps: List[torch.Tensor]
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two subnets over every level -> (deltas (B, N, 4), logits
    (B, N, C)), location-major, anchor next."""
    a = anchors_per_cell(cfg)
    out = {}
    for sub, k in (("cls", cfg["num_classes"]), ("box", 4)):
        parts = []
        for p in maps:
            y = p
            for i in range(cfg["head_convs"]):
                y = F.relu(conv(y, tree, f"head/{sub}_conv{i}"))
            y = conv(y, tree, f"head/{sub}_out")
            b, _, h, w = y.shape
            parts.append(y.view(b, a, k, h, w).permute(0, 3, 4, 1, 2)
                         .reshape(b, h * w * a, k))
        out[sub] = torch.cat(parts, dim=1)
    return out["box"], out["cls"]


def forward(cfg: dict, tree: Tree, images: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NHWC normalised images -> (deltas (B, N, 4), logits (B, N, C)), in
    the images' dtype."""
    feats = trunk(cfg, tree, images.permute(0, 3, 1, 2))
    maps = fpn(tree, feats)
    for m, side in zip(maps, cfg["feature_map_shapes"]):
        if m.shape[-1] != side:
            raise ValueError(f"a pyramid level is {tuple(m.shape)}, the "
                             f"configuration states side {side}")
    return head(cfg, tree, maps)


def preprocess(cfg: dict, images_u8: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """uint8 [0, 255] NHWC -> [0, 1], then (x - mean) / std per channel
    (the configuration's image_mean and image_std)."""
    mean, std = (torch.tensor(cfg[k], dtype=dtype, device=images_u8.device)
                 for k in ("image_mean", "image_std"))
    return (images_u8.to(dtype) / 255.0 - mean) / std


# ---------------------------------------------------------------------------
# Anchors, decode, selection and NMS.
# ---------------------------------------------------------------------------

def anchors_per_cell(cfg: dict) -> int:
    return len(cfg["anchor_ratios"]) * len(cfg["anchor_sizes"][0])


def level_sizes(cfg: dict) -> List[int]:
    """Anchors of each level."""
    a = anchors_per_cell(cfg)
    return [s * s * a for s in cfg["feature_map_shapes"]]


def base_anchors(sizes, ratios) -> np.ndarray:
    """torchvision's cell anchors of one level: (A, 4) float32 pixel
    [x0, y0, x1, y1], ratio-major."""
    scales = np.asarray(sizes, np.float32)
    h_ratios = np.sqrt(np.asarray(ratios, np.float32))
    w_ratios = np.float32(1) / h_ratios
    ws = (w_ratios[:, None] * scales[None, :]).reshape(-1)
    hs = (h_ratios[:, None] * scales[None, :]).reshape(-1)
    return np.round(np.stack([-ws, -hs, ws, hs], axis=1) / np.float32(2))


def anchors(cfg: dict) -> np.ndarray:
    """(N, 4) float64 anchors normalised by the image's side, y-first
    corners; not clipped."""
    side = cfg["img_size"]
    out = []
    for fm, sizes in zip(cfg["feature_map_shapes"], cfg["anchor_sizes"]):
        stride = side // fm
        base = base_anchors(sizes, cfg["anchor_ratios"]).astype(np.float64)
        shift = np.arange(fm, dtype=np.float64) * stride
        sy, sx = np.meshgrid(shift, shift, indexing="ij")
        shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
        xyxy = (shifts + base[None]).reshape(-1, 4)
        out.append(xyxy[:, [1, 0, 3, 2]] / side)
    a = np.concatenate(out)
    if len(a) != cfg["anchors"]:
        raise ValueError(f"{len(a)} anchors, the configuration states "
                         f"{cfg['anchors']}")
    return a


def decode(cfg: dict, anchors_t: torch.Tensor, deltas: torch.Tensor
           ) -> torch.Tensor:
    """(..., 4) deltas (dx, dy, dw, dh) against (..., 4) anchors -> boxes
    [y0, x0, y1, x1] clipped to [0, 1], in the deltas' dtype."""
    a = anchors_t.to(deltas.dtype)
    h, w = a[..., 2] - a[..., 0], a[..., 3] - a[..., 1]
    cy, cx = a[..., 0] + 0.5 * h, a[..., 1] + 0.5 * w
    wx, wy, ww, wh = cfg["box_weights"]
    dx, dy = deltas[..., 0] / wx, deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp(max=cfg["box_clamp"])
    dh = (deltas[..., 3] / wh).clamp(max=cfg["box_clamp"])
    pcx, pcy = dx * w + cx, dy * h + cy
    pw, ph = torch.exp(dw) * w, torch.exp(dh) * h
    return torch.stack([pcy - 0.5 * ph, pcx - 0.5 * pw, pcy + 0.5 * ph,
                        pcx + 0.5 * pw], dim=-1).clamp(0.0, 1.0)


def _top(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[
        ..., :k]


def postprocess(cfg: dict, anchors_t: torch.Tensor, deltas: torch.Tensor,
                logits: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Selection, class-wise greedy NMS and the top detections of each
    image -> {'boxes' (B, T, 4), 'scores' (B, T), 'classes' (B, T) in 1..C
    (0 padding), 'valid' (B,)}, T = max_total_detections."""
    total, c = cfg["max_total_detections"], cfg["num_classes"]
    out = {k: [] for k in ("boxes", "scores", "classes", "valid")}
    for i in range(deltas.shape[0]):
        boxes, scores, classes = [], [], []
        at = 0
        for n in level_sizes(cfg):
            s = torch.sigmoid(logits[i, at:at + n]).reshape(-1)
            idx = _top(torch.where(s > cfg["score_threshold"], s,
                                   torch.full_like(s, -math.inf)),
                       min(cfg["topk_candidates"], len(s)))
            idx = idx[s[idx] > cfg["score_threshold"]]
            anchor = at + torch.div(idx, c, rounding_mode="floor")
            boxes.append(decode(cfg, anchors_t[anchor], deltas[i, anchor]))
            scores.append(s[idx])
            classes.append(idx % c)
            at += n
        boxes, scores = torch.cat(boxes), torch.cat(scores)
        classes = torch.cat(classes)
        order = _top(scores, len(scores))
        boxes, scores, classes = boxes[order], scores[order], classes[order]
        over = (iou(boxes, boxes) > cfg["nms_iou_threshold"]) & (
            classes[:, None] == classes[None, :])
        over = over.triu(1)
        keep = torch.ones(len(scores), dtype=torch.bool,
                          device=scores.device)
        for j in range(len(scores)):
            keep = keep & ~(keep[j] & over[j])
        kept = torch.nonzero(keep).reshape(-1)[:total]
        v = len(kept)
        pad = total - v
        out["boxes"].append(F.pad(boxes[kept], (0, 0, 0, pad)))
        out["scores"].append(F.pad(scores[kept], (0, pad)))
        out["classes"].append(F.pad(classes[kept] + 1, (0, pad)))
        out["valid"].append(torch.tensor(v, device=scores.device))
    return {k: torch.stack(v) for k, v in out.items()}


# ---------------------------------------------------------------------------
# FLOPs and the comparison.
# ---------------------------------------------------------------------------

def model_flops(cfg: dict) -> float:
    """FLOPs of the forward for one image, counted by torch.utils.
    flop_counter over this reference's forward on the meta device (no
    arithmetic runs)."""
    from torch.utils.flop_counter import FlopCounterMode

    tree = {k: torch.empty(s, device="meta") for k, s, _ in weight_specs(cfg)}
    s = cfg["img_size"]
    images = torch.empty((1, s, s, 3), device="meta")
    with FlopCounterMode(display=False) as counter:
        forward(cfg, tree, images)
    return float(counter.get_total_flops())


def _image(cfg: dict, ref_boxes: torch.Tensor, ref_scores: torch.Tensor,
           boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
           v: int) -> Tuple[float, float]:
    """(det_gap, sel_gap) of one image's v served detections against the
    reference's decode of every anchor (N, 4) and its scores (N, C)."""
    n, c = ref_scores.shape
    dev = ref_scores.device
    if v == 0:
        served_anchor = cls = torch.zeros(0, dtype=torch.long, device=dev)
        det = 0.0
    else:
        cls = classes[:v].long() - 1
        box = boxes[:v].to(ref_boxes.dtype)
        score = scores[:v].to(ref_scores.dtype)
        d = (ref_scores[:, cls] - score[None, :]).abs()          # (N, V)
        for j in range(4):
            d = torch.maximum(d, (ref_boxes[:, j, None]
                                  - box[None, :, j]).abs())
        best, served_anchor = d.min(dim=0)
        det = float(best.max())
        if not math.isfinite(det):
            return math.inf, math.inf
    key = served_anchor * c + cls
    if len(torch.unique(key)) != len(key):
        return det, math.inf
    thr = cfg["nms_iou_threshold"]
    sb = ref_boxes[served_anchor]                                # (V, 4)
    ss = ref_scores[served_anchor, cls]                          # (V,)
    # 1. no two served detections of one class overlap beyond the
    #    threshold (the later one would have been suppressed)
    sel = 0.0
    if v > 1:
        same = (cls[:, None] == cls[None, :]) & ~torch.eye(
            v, dtype=torch.bool, device=dev)
        over = torch.where(same, iou(sb, sb), torch.zeros((), dtype=sb.dtype,
                                                          device=dev))
        sel = max(0.0, float(over.max()) - thr)
    # 2. every (anchor, class) left out is explained: by the score
    #    threshold, by its level's top-k, by the cut to the top detections
    #    (when the image's rows are full), or suppressed by a served
    #    detection of its class that scores at least as high
    full = v >= cfg["max_total_detections"]
    cut = float(ss.min()) if full and v else -math.inf
    excess = torch.empty_like(ref_scores)
    at = 0
    for size in level_sizes(cfg):
        s = ref_scores[at:at + size]
        k = cfg["topk_candidates"]
        level_cut = (torch.topk(s.reshape(-1), k).values[-1]
                     if k < s.numel() else -math.inf)
        excess[at:at + size] = torch.minimum(
            s - cfg["score_threshold"],
            torch.minimum(s - level_cut, s - cut))
        at += size
    if v:
        overlap = iou(ref_boxes, sb) > thr - IOU_SLACK           # (N, V)
        for cl in torch.unique(cls).tolist():
            mask = cls == cl
            sup = (overlap[:, mask]
                   & (ss[mask][None, :] >= ref_scores[:, cl, None]
                      - SCORE_SLACK)).any(dim=1)
            excess[:, cl] = torch.where(sup, torch.zeros_like(
                excess[:, cl]), excess[:, cl])
        excess[served_anchor, cls] = 0.0
    return det, max(sel, float(excess.max().clamp_min(0.0)))


def judge(cfg: dict, anchors_t: torch.Tensor, deltas: torch.Tensor,
          logits: torch.Tensor, served: Tuple) -> Dict[str, float]:
    """The numbers of one chunk of images, each the worst over them, for
    the reference's (deltas, logits) and `served` = (boxes, scores,
    classes, valid) as the program returned them, on the reference's
    device. det_gap and sel_gap as reference/detect.py:judge defines them,
    with this selection's cuts: the score threshold, each level's top-k
    over its (anchor, class) pairs, and the cut to the top detections.
    Non-finite values, classes outside 1..C, more valid rows than rows
    and a detection served twice read infinity."""
    boxes, scores, classes, valid = served
    worst = {"det_gap": 0.0, "sel_gap": 0.0}
    num_classes = logits.shape[-1]
    for i in range(logits.shape[0]):
        v = int(valid[i])
        bad = v > scores.shape[1] or v < 0 or bool(
            ((classes[i, :v] < 1) | (classes[i, :v] > num_classes)).any())
        if bad or not bool(torch.isfinite(scores[i, :v]).all()):
            return {"det_gap": math.inf, "sel_gap": math.inf}
        det, sel = _image(cfg, decode(cfg, anchors_t, deltas[i]),
                          torch.sigmoid(logits[i]), boxes[i], scores[i],
                          classes[i], v)
        worst["det_gap"] = max(worst["det_gap"], det)
        worst["sel_gap"] = max(worst["sel_gap"], sel)
    return worst
