"""Model/training hyperparameter configs (port of the JAX package's config.py).

A plain copy: the same frozen dataclass, the same three backbone entries
and the same values (reference: utils/train_utils.py:get_hyper_params), so
both packages build identical anchors and thresholds. Fields that only the
TPU build reads (nms_impl, use_pallas, remat, compute_dtype) are kept so a
config round-trips between the two packages unchanged.

Anchor-count bookkeeping: every cell of feature map k carries
``len(aspect_ratios[k]) + 1`` prior boxes — one per aspect ratio at scale
s_k plus the extra ar=1 box at scale sqrt(s_k * s_{k+1}) from the SSD paper
(arXiv:1512.02325 §2.2). For SSD300-VGG16 this yields the canonical 8732
priors: 38^2*4 + 19^2*6 + 10^2*6 + 5^2*6 + 3^2*4 + 1^2*4.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


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
}


def get_hyper_params(backbone: str, **kwargs) -> SSDConfig:
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
