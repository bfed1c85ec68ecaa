"""Parity of the port's config and box geometry (tfssd_torch.config,
tfssd_torch.ops.boxes) with the JAX package's: anchors bit-equal for all
three backbones, IoU / encode / decode / clip within 1e-6 on the same
seeded inputs, normalize_bboxes / denormalize_bboxes bit-equal."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tfssd_torch import config as tconfig  # noqa: E402
from tfssd_torch.ops import boxes as tboxes  # noqa: E402
from tfssd_tpu import config as jconfig  # noqa: E402
from tfssd_tpu.ops import boxes as jboxes  # noqa: E402

ATOL = 1e-6
BACKBONES = [("mobilenet_v2", 2268), ("vgg16", 8732), ("vgg16_512", 24564)]


@pytest.mark.parametrize("backbone,rows", BACKBONES)
def test_config_is_a_plain_copy(backbone, rows):
    t = tconfig.get_hyper_params(backbone)
    j = jconfig.get_hyper_params(backbone)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.total_anchors == rows
    assert t.map_scales == j.map_scales


def test_config_overrides_and_unknown_backbone():
    t = tconfig.get_hyper_params("mobilenet_v2", nms_iou_threshold=0.5)
    assert t.nms_iou_threshold == 0.5
    with pytest.raises(ValueError):
        tconfig.get_hyper_params("resnet50")


@pytest.mark.parametrize("backbone,rows", BACKBONES)
def test_anchors_bit_equal(backbone, rows):
    t = tboxes.generate_anchors(tconfig.get_hyper_params(backbone))
    j = jboxes.generate_anchors(jconfig.get_hyper_params(backbone))
    assert t.shape == (rows, 4) and t.dtype == np.float32
    np.testing.assert_array_equal(t, j)


def _random_boxes(rng, shape):
    y0 = rng.uniform(0, 0.8, shape)
    x0 = rng.uniform(0, 0.8, shape)
    h = rng.uniform(0, 0.5, shape)
    w = rng.uniform(0, 0.5, shape)
    h[..., :2] = 0.0  # zero-area rows (padding)
    return np.stack([y0, x0, y0 + h, x0 + w], -1).astype(np.float32)


def test_iou_matrix():
    rng = np.random.default_rng(0)
    a = _random_boxes(rng, (3, 40))
    b = _random_boxes(rng, (3, 25))
    want = np.asarray(jboxes.iou_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = tboxes.iou_matrix(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (3, 40, 25)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_encode_decode_round_trip():
    cfg = tconfig.get_hyper_params("mobilenet_v2")
    anchors = tboxes.generate_anchors(cfg)
    rng = np.random.default_rng(1)
    gt = _random_boxes(rng, (2, anchors.shape[0]))
    want = np.asarray(jboxes.encode(jnp.asarray(anchors), jnp.asarray(gt),
                                    cfg.variances))
    got = tboxes.encode(torch.from_numpy(anchors), torch.from_numpy(gt),
                        cfg.variances)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    deltas = rng.normal(0, 1, (2, anchors.shape[0], 4)).astype(np.float32)
    want = np.asarray(jboxes.decode(jnp.asarray(anchors),
                                    jnp.asarray(deltas), cfg.variances))
    got = tboxes.decode(torch.from_numpy(anchors), torch.from_numpy(deltas),
                        cfg.variances)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    clipped = tboxes.clip_boxes(got)
    np.testing.assert_allclose(
        clipped.numpy(), np.asarray(jboxes.clip_boxes(jnp.asarray(want))),
        atol=ATOL)
    assert clipped.min() >= 0 and clipped.max() <= 1


@pytest.mark.parametrize("height,width", [(200.0, 400.0), (375.0, 500.0)])
def test_normalize_and_denormalize_bboxes_equal_jax(height, width):
    rng = np.random.default_rng(3)
    pixels = (rng.uniform(0, 1, (2, 7, 4)) * [height, width, height, width]
              ).astype(np.float32)
    norm = tboxes.normalize_bboxes(torch.from_numpy(pixels), height, width)
    np.testing.assert_array_equal(norm.numpy(), np.asarray(
        jboxes.normalize_bboxes(jnp.asarray(pixels), height, width)))
    back = tboxes.denormalize_bboxes(norm, height, width)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jboxes.denormalize_bboxes(jnp.asarray(norm.numpy()), height, width)))
    np.testing.assert_allclose(back.numpy(), pixels, rtol=1e-6)
