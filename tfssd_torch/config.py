"""Model/training hyperparameter configs (port of the JAX package's config.py).

A plain copy: the same frozen dataclass, the same three backbone entries
and the same values (reference: utils/train_utils.py:get_hyper_params), so
both packages build identical anchors and thresholds. Fields that only the
TPU build reads (nms_impl, use_pallas, remat, compute_dtype) are kept so a
config round-trips between the two packages unchanged.

RetinaNetConfig states the fourth configuration, RetinaNet with a
ResNeXt50-32x4d FPN trunk (get_hyper_params("retinanet_rx50fpn_800")),
which the JAX package does not have: models/retinanet.py. MaskRCNNConfig
states the fifth, Mask R-CNN with a ResNet50-FPN trunk
(get_hyper_params("maskrcnn_r50fpn_800x1066")): models/maskrcnn.py.

Anchor-count bookkeeping: every cell of feature map k carries
``len(aspect_ratios[k]) + 1`` prior boxes — one per aspect ratio at scale
s_k plus the extra ar=1 box at scale sqrt(s_k * s_{k+1}) from the SSD paper
(arXiv:1512.02325 §2.2). For SSD300-VGG16 this yields the canonical 8732
priors: 38^2*4 + 19^2*6 + 10^2*6 + 5^2*6 + 3^2*4 + 1^2*4.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    """Static hyperparameters for one SSD variant.

    Field names mirror the reference hyper_params dict keys where one
    exists (reference: utils/train_utils.py:get_hyper_params).
    """

    backbone: str
    img_size: int
    feature_map_shapes: Tuple[int, ...]
    # Per-feature-map aspect-ratio lists. The extra ar=1 prime-scale box is
    # implicit (+1 per cell), matching the SSD paper and the reference.
    aspect_ratios: Tuple[Tuple[float, ...], ...]
    # Matching / loss hyperparameters (reference defaults).
    iou_threshold: float = 0.5
    neg_pos_ratio: int = 3
    loc_loss_alpha: float = 1.0
    variances: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)
    # Anchor scale schedule (SSD paper): s_k linearly spaced in
    # [scale_min, scale_max] over the feature maps; next-scale for the
    # extra ar=1 box uses s_{m+1} = 1.0.
    scale_min: float = 0.2
    scale_max: float = 0.9
    # Explicit per-map scales override the linear schedule (used by SSD512,
    # whose paper spec pins the first map to 0.07-ish scales).
    scales: Optional[Tuple[float, ...]] = None
    # 20 VOC classes + background (index 0).
    total_labels: int = 21
    # NMS / decode (reference: bbox_utils.non_max_suppression wrapper over
    # tf.image.combined_non_max_suppression with max_total_size 200).
    nms_iou_threshold: float = 0.45
    nms_score_threshold: float = 0.0
    max_detections_per_class: int = 200
    max_total_detections: int = 200
    # Suppression implementation: "blocked" (triangular solve — exact
    # greedy, deterministic cost), "xla" (fixpoint matvec — exact greedy,
    # cost grows with suppression-chain depth), "pallas" (fused kernel).
    nms_impl: str = "blocked"
    # Class-agnostic candidate cut before the per-class NMS stages: keep
    # the top-M anchors per image by max class score (0 = off/exact).
    # Near-exact (see ops/nms.py:combined_nms) and much faster: every
    # per-class stage runs at width M instead of total_anchors.
    # Tail-semantics coupling: with M < max_detections_per_class * C,
    # per-class candidates come from the shared M-anchor pool, so at
    # score_threshold 0.0 the COMPOSITION of the junk tail (scores below
    # any real detection) can differ from exact NMS even though every
    # real detection survives. Measured cost on trained SSD300 scores:
    # mAP delta -0.0001, zero churn among detections with score >= 0.05
    # (ARCHITECTURE.md "Accuracy cost of the prefilter default";
    # tools/prefilter_ab.py reproduces it).
    nms_prefilter_anchors: int = 512
    # Paper's bipartite "force match best prior for each gt" step. The
    # reference matches by threshold only; keep its behaviour by default.
    force_match_for_gt: bool = False
    # Static padding for variable ground-truth counts per image.
    max_gt_boxes: int = 64
    # TPU compute dtype for the conv trunk ("bfloat16" or "float32").
    # Parameters always live in float32.
    compute_dtype: str = "float32"
    # BatchNorm running-average momentum (Keras MobileNetV2 uses 0.999;
    # 0.99 converges the running stats in a few hundred steps, which the
    # reference's multi-epoch VOC schedules easily supply). Small-step
    # runs (tests, tiny overfit experiments) should lower this so eval
    # mode sees converged statistics.
    bn_momentum: float = 0.99
    # Use the Pallas native-tier kernels (ops/kernels/) where available
    # instead of the jnp reference implementations.
    use_pallas: bool = False
    # Rematerialize backbone activations in the backward pass
    # (activation checkpointing): trades ~30% more FLOPs for O(sqrt) activation
    # memory, enabling much larger per-chip batches.
    remat: bool = False
    # Inference-only: build ConvBN blocks as plain biased convs, with
    # the BatchNorm affine pre-folded into the conv weights at load time
    # (utils.fold_bn.fold_batch_norm). BN is exactly a per-channel
    # affine in inference mode, so folding is mathematically exact in
    # f32; serving keeps weights as runtime buffers (swappable without
    # recompiles), unlike the exported StableHLO artifact's
    # constant-folding. Training with fold_bn=True is invalid (no
    # batch statistics exist to update).
    fold_bn: bool = False

    # ---- derived ----

    @property
    def boxes_per_cell(self) -> Tuple[int, ...]:
        return tuple(len(ars) + 1 for ars in self.aspect_ratios)

    @property
    def anchors_per_map(self) -> Tuple[int, ...]:
        return tuple(
            fm * fm * bpc
            for fm, bpc in zip(self.feature_map_shapes, self.boxes_per_cell)
        )

    @property
    def total_anchors(self) -> int:
        return sum(self.anchors_per_map)

    @property
    def map_scales(self) -> Tuple[float, ...]:
        """Per-map scales s_1..s_m plus the s_{m+1}=1.0 sentinel."""
        if self.scales is not None:
            assert len(self.scales) == len(self.feature_map_shapes) + 1, (
                "explicit scales must include the s_{m+1} sentinel"
            )
            return self.scales
        m = len(self.feature_map_shapes)
        if m == 1:
            return (self.scale_min, 1.0)
        step = (self.scale_max - self.scale_min) / (m - 1)
        return tuple(self.scale_min + step * k for k in range(m)) + (1.0,)

    def validate(self) -> "SSDConfig":
        assert len(self.aspect_ratios) == len(self.feature_map_shapes)
        assert self.total_labels >= 2
        assert all(s > 0 for s in self.feature_map_shapes)
        for s0, s1 in zip(self.map_scales, self.map_scales[1:]):
            assert 0.0 < s0 and s0 < s1 <= 1.0 + 1e-6, "scales must increase"
        _ = math.sqrt  # keep import honest
        return self


@dataclasses.dataclass(frozen=True)
class RetinaNetConfig:
    """Static hyperparameters of RetinaNet (Lin et al., arXiv:1708.02002)
    with a ResNeXt trunk (arXiv:1611.05431) and an FPN (arXiv:1612.03144),
    as torchvision's retinanet_resnet50_fpn (v1) defines them and MLPerf
    Inference runs them (models/retinanet.py has the equations)."""

    backbone: str
    img_size: int
    # sides of P3-P7
    feature_map_shapes: Tuple[int, ...]
    # torchvision's AnchorGenerator: pixel sizes per level, ratios h / w
    # (ratio-major); base boxes round([-w/2, -h/2, w/2, h/2]), shifted by
    # multiples of img_size // side
    anchor_sizes: Tuple[Tuple[int, ...], ...]
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    # sigmoid classes, no background column
    num_classes: int = 264
    stem_channels: int = 64
    groups: int = 32
    stage_blocks: Tuple[int, ...] = (3, 4, 6, 3)
    stage_widths: Tuple[int, ...] = (128, 256, 512, 1024)
    stage_channels: Tuple[int, ...] = (256, 512, 1024, 2048)
    fpn_channels: int = 256
    head_convs: int = 4
    # torchvision's ImageNet normalisation of images in [0, 1]
    image_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    image_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    bn_eps: float = 1e-5
    # BoxCoder: deltas (dx, dy, dw, dh) over these weights, dw and dh
    # clamped above at box_clamp
    box_weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    box_clamp: float = math.log(1000.0 / 16)
    # per image and level: pairs scoring above score_threshold, their top
    # topk_candidates; class-wise NMS; the top max_total_detections
    score_threshold: float = 0.05
    topk_candidates: int = 1000
    nms_iou_threshold: float = 0.5
    max_total_detections: int = 300
    compute_dtype: str = "float32"
    # built as biased convs with BatchNorm folded in (utils/fold_bn.py)
    fold_bn: bool = False

    @property
    def anchors_per_cell(self) -> int:
        return len(self.anchor_ratios) * len(self.anchor_sizes[0])

    @property
    def anchors_per_map(self) -> Tuple[int, ...]:
        return tuple(s * s * self.anchors_per_cell
                     for s in self.feature_map_shapes)

    @property
    def total_anchors(self) -> int:
        return sum(self.anchors_per_map)

    @property
    def strides(self) -> Tuple[int, ...]:
        return tuple(self.img_size // s for s in self.feature_map_shapes)

    def validate(self) -> "RetinaNetConfig":
        assert len(self.anchor_sizes) == len(self.feature_map_shapes)
        assert len({len(s) for s in self.anchor_sizes}) == 1
        assert all(w % self.groups == 0 for w in self.stage_widths)
        assert self.compute_dtype == "float32", (
            "RetinaNet is built in float32 only")
        return self


@dataclasses.dataclass(frozen=True)
class MaskRCNNConfig:
    """Static hyperparameters of Mask R-CNN (He et al., arXiv:1703.06870)
    with a ResNet-50 trunk (arXiv:1512.03385), an FPN (arXiv:1612.03144)
    and Faster R-CNN's region proposals and box head (arXiv:1506.01497), as
    torchvision's maskrcnn_resnet50_fpn (v1) defines them
    (models/maskrcnn.py has the equations). Boxes are pixels, x-first
    [x0, y0, x1, y1], as torchvision's."""

    backbone: str
    # the frame (height, width) and the batch's size once padded to a
    # multiple of size_divisible, zeros on the right and the bottom
    image_size: Tuple[int, int]
    padded_size: Tuple[int, int]
    # (height, width) of P2-P6; P6 is max_pool2d(P5, 1, 2)
    feature_map_shapes: Tuple[Tuple[int, int], ...]
    # torchvision's AnchorGenerator: one pixel size a level, ratios h / w;
    # base boxes round([-w/2, -h/2, w/2, h/2]), shifted by multiples of the
    # per-axis stride padded_size // map size
    anchor_sizes: Tuple[Tuple[int, ...], ...] = (
        (32,), (64,), (128,), (256,), (512,))
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    size_divisible: int = 32
    # softmax classes, the background column 0 included (COCO's 91 ids)
    num_classes: int = 91
    stem_channels: int = 64
    groups: int = 1
    stage_blocks: Tuple[int, ...] = (3, 4, 6, 3)
    stage_widths: Tuple[int, ...] = (64, 128, 256, 512)
    stage_channels: Tuple[int, ...] = (256, 512, 1024, 2048)
    fpn_channels: int = 256
    image_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    image_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    bn_eps: float = 1e-5
    # BoxCoder: dw and dh clamped above at box_clamp
    box_clamp: float = math.log(1000.0 / 16)
    # region proposals, per image: each level's top rpn_pre_nms_top_n
    # objectness logits, decoded with rpn_box_weights, clipped, boxes of a
    # side under rpn_min_size and scores under rpn_score_threshold dropped,
    # NMS by level at rpn_nms_iou_threshold, the top rpn_post_nms_top_n
    rpn_box_weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0,
                                                          1.0)
    rpn_pre_nms_top_n: int = 1000
    rpn_post_nms_top_n: int = 1000
    rpn_nms_iou_threshold: float = 0.7
    rpn_score_threshold: float = 0.0
    rpn_min_size: float = 1e-3
    # MultiScaleRoIAlign over P2-P5 (aligned=False): a box of area a goes
    # to level floor(roi_canonical_level + log2(sqrt(a) /
    # roi_canonical_scale) + 1e-6), clamped to the pooled levels
    roi_levels: Tuple[int, ...] = (2, 3, 4, 5)
    roi_canonical_scale: int = 224
    roi_canonical_level: int = 4
    roi_sampling_ratio: int = 2
    box_roi_size: int = 7
    mask_roi_size: int = 14
    representation_size: int = 1024
    # detections, per image: pairs scoring above box_score_threshold,
    # boxes of a side under box_min_size dropped, NMS per class at
    # box_nms_iou_threshold, the top box_detections_per_img
    box_weights: Tuple[float, float, float, float] = (10.0, 10.0, 5.0, 5.0)
    box_score_threshold: float = 0.05
    box_min_size: float = 1e-2
    box_nms_iou_threshold: float = 0.5
    box_detections_per_img: int = 100
    mask_layers: Tuple[int, ...] = (256, 256, 256, 256)
    compute_dtype: str = "float32"
    fold_bn: bool = False

    @property
    def anchors_per_cell(self) -> int:
        return len(self.anchor_ratios) * len(self.anchor_sizes[0])

    @property
    def anchors_per_map(self) -> Tuple[int, ...]:
        return tuple(h * w * self.anchors_per_cell
                     for h, w in self.feature_map_shapes)

    @property
    def total_anchors(self) -> int:
        return sum(self.anchors_per_map)

    @property
    def strides(self) -> Tuple[Tuple[int, int], ...]:
        """torchvision's per-axis integer strides (down, across)."""
        ph, pw = self.padded_size
        return tuple((ph // h, pw // w) for h, w in self.feature_map_shapes)

    @property
    def roi_scales(self) -> Tuple[float, ...]:
        """The pooled levels' scales, 2 ** -level (MultiScaleRoIAlign's
        scales, inferred from the map heights)."""
        return tuple(2.0 ** -level for level in self.roi_levels)

    @property
    def mask_size(self) -> int:
        return 2 * self.mask_roi_size

    def validate(self) -> "MaskRCNNConfig":
        assert len(self.anchor_sizes) == len(self.feature_map_shapes)
        assert len({len(s) for s in self.anchor_sizes}) == 1
        assert all(p % self.size_divisible == 0 and p >= i for p, i in zip(
            self.padded_size, self.image_size))
        assert len(self.roi_levels) == len(self.feature_map_shapes) - 1
        assert self.compute_dtype == "float32", (
            "Mask R-CNN is built in float32 only")
        return self


_AR_4 = (1.0, 2.0, 0.5)                 # -> 4 boxes/cell (with extra ar=1)
_AR_6 = (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0)  # -> 6 boxes/cell


# Reference: utils/train_utils.py:SSD  (per-backbone static hyperparams).
_BACKBONE_CONFIGS = {
    # SSD300-VGG16: 8732 anchors. Scales are the SSD paper's canonical
    # schedule: conv4_3 pinned to 0.1, then s_k linear in [0.2, 0.9] over
    # the remaining five maps (arXiv:1512.02325 sec 2.2 / sec 3.1).
    "vgg16": SSDConfig(
        backbone="vgg16",
        img_size=300,
        feature_map_shapes=(38, 19, 10, 5, 3, 1),
        aspect_ratios=(_AR_4, _AR_6, _AR_6, _AR_6, _AR_4, _AR_4),
        scales=(0.1, 0.2, 0.375, 0.55, 0.725, 0.9, 1.0),
    ),
    # SSD300-MobileNetV2: taps at stride 16/32 + 4 extra maps -> 2268 anchors.
    "mobilenet_v2": SSDConfig(
        backbone="mobilenet_v2",
        img_size=300,
        feature_map_shapes=(19, 10, 5, 3, 2, 1),
        aspect_ratios=(_AR_4, _AR_6, _AR_6, _AR_6, _AR_4, _AR_4),
        scale_min=0.2,
        scale_max=0.9,
    ),
    # SSD512-VGG16 extension (BASELINE.md config #4): 7 feature maps,
    # paper-style scales with a dedicated small first scale.
    "vgg16_512": SSDConfig(
        backbone="vgg16",
        img_size=512,
        feature_map_shapes=(64, 32, 16, 8, 4, 2, 1),
        aspect_ratios=(_AR_4, _AR_6, _AR_6, _AR_6, _AR_6, _AR_4, _AR_4),
        scales=(0.07, 0.15, 0.2875, 0.425, 0.5625, 0.7, 0.8375, 1.0),
    ),
    # RetinaNet-ResNeXt50-32x4d-FPN at 800x800, 264 classes (MLPerf
    # Inference's detector): 120,087 anchors on P3-P7 (100/50/25/13/7).
    "retinanet_rx50fpn_800": RetinaNetConfig(
        backbone="resnext50_32x4d_fpn",
        img_size=800,
        feature_map_shapes=(100, 50, 25, 13, 7),
        anchor_sizes=tuple((x, int(x * 2 ** (1 / 3)), int(x * 2 ** (2 / 3)))
                           for x in (32, 64, 128, 256, 512)),
    ),
    # Mask R-CNN-ResNet50-FPN on COCO's 640x480 frames at min_size 800:
    # 800x1066, padded to 800x1088; 217,413 anchors on P2-P6.
    "maskrcnn_r50fpn_800x1066": MaskRCNNConfig(
        backbone="resnet50_fpn",
        image_size=(800, 1066),
        padded_size=(800, 1088),
        feature_map_shapes=((200, 272), (100, 136), (50, 68), (25, 34),
                            (13, 17)),
    ),
}


def get_hyper_params(backbone: str, **kwargs
                     ) -> Union[SSDConfig, RetinaNetConfig, MaskRCNNConfig]:
    """Mirror of reference `train_utils.get_hyper_params(backbone, **kwargs)`.

    Returns the per-backbone config with any keyword overrides applied.
    """
    if backbone not in _BACKBONE_CONFIGS:
        raise ValueError(
            f"unknown backbone {backbone!r}; expected one of "
            f"{sorted(_BACKBONE_CONFIGS)}"
        )
    cfg = _BACKBONE_CONFIGS[backbone]
    if kwargs:
        cfg = dataclasses.replace(cfg, **kwargs)
    return cfg.validate()
