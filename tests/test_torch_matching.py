"""Parity of the port's matcher (tfssd_torch.ops.matching, the plain
version of the match/encode kernel, and ops/kernels/match_encode.py's
dispatch) with the JAX package's ops/matching.match_batch and its Pallas
kernel match_batch_pallas in interpret mode, on the same numpy-seeded
gts.

Tolerances: matched labels are equal; deltas within 1e-5, the tolerance
of the JAX package's own kernel test (tests/test_kernels.py), because the
encode's log is not correctly rounded on either side and XLA may rewrite a
division by a variance as a multiplication.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tfssd_torch import get_hyper_params as t_hyper  # noqa: E402
from tfssd_torch.ops import matching as tmatch  # noqa: E402
from tfssd_torch.ops.kernels import match_encode as tkernel  # noqa: E402
from tfssd_tpu import get_hyper_params as j_hyper  # noqa: E402
from tfssd_tpu.ops.boxes import generate_anchors  # noqa: E402
from tfssd_tpu.ops.kernels.match_encode import match_batch_pallas  # noqa: E402
from tfssd_tpu.ops.matching import match_batch as j_match_batch  # noqa: E402

ATOL = 1e-5


def _random_gt(rng, b, g, num_classes=20):
    n_valid = rng.integers(0, g + 1, size=b)
    boxes = np.zeros((b, g, 4), np.float32)
    labels = np.zeros((b, g), np.int32)
    for i in range(b):
        for j in range(int(n_valid[i])):
            y0, x0 = rng.uniform(0, 0.7, 2)
            h, w = rng.uniform(0.1, 0.3, 2)
            boxes[i, j] = [y0, x0, min(y0 + h, 1), min(x0 + w, 1)]
            labels[i, j] = rng.integers(1, num_classes + 1)
    return boxes, labels


def _port(anchors, boxes, labels, cfg):
    return tkernel.match_batch(torch.from_numpy(anchors),
                               torch.from_numpy(boxes),
                               torch.from_numpy(labels), cfg)


def _assert_same(got, want):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=ATOL)


@pytest.mark.parametrize("backbone", ["mobilenet_v2", "vgg16", "vgg16_512"])
def test_plain_matcher_matches_jax_and_pallas(backbone):
    # vgg16's 8,732 and vgg16_512's 24,564 anchors are not multiples of
    # the Pallas 512 tile
    kw = dict(max_gt_boxes=16)
    jcfg, tcfg = j_hyper(backbone, **kw), t_hyper(backbone, **kw)
    anchors = generate_anchors(jcfg)
    boxes, labels = _random_gt(np.random.default_rng(0), 4, 16)
    got = _port(anchors, boxes, labels, tcfg)
    args = (jnp.asarray(anchors), jnp.asarray(boxes), jnp.asarray(labels),
            jcfg)
    _assert_same(got, j_match_batch(*args))
    _assert_same(got, match_batch_pallas(*args, interpret=True))
    assert got[1][..., 1:].sum() > 0  # the gts match some anchors


def test_anchor_aligned_gt_is_positive_with_zero_deltas():
    cfg = t_hyper("mobilenet_v2", max_gt_boxes=8)
    anchors = generate_anchors(cfg)
    boxes = np.zeros((1, 8, 4), np.float32)
    boxes[0, 0] = anchors[123]
    labels = np.zeros((1, 8), np.int32)
    labels[0, 0] = 7
    deltas, onehot = _port(anchors, boxes, labels, cfg)
    assert float(onehot[0, 123, 7]) == 1.0
    np.testing.assert_allclose(deltas[0, 123].numpy(), np.zeros(4),
                               atol=ATOL)


def test_zero_gt_is_all_background():
    cfg = t_hyper("mobilenet_v2", max_gt_boxes=8)
    anchors = generate_anchors(cfg)
    deltas, onehot = _port(anchors, np.zeros((2, 8, 4), np.float32),
                           np.zeros((2, 8), np.int32), cfg)
    assert float(deltas.abs().sum()) == 0.0
    np.testing.assert_array_equal(onehot[..., 0].numpy(), 1.0)


@pytest.mark.parametrize("seed", [0, 7, 11, 23, 42])
def test_force_match_matches_jax(seed):
    # Exact-IoU ties between symmetric anchors are common: the per-gt best
    # anchor must come from the same masked IoU expression on both paths
    # of the port (plain branch and post-pass) and agree with JAX's.
    kw = dict(max_gt_boxes=16, force_match_for_gt=True)
    jcfg, tcfg = j_hyper("mobilenet_v2", **kw), t_hyper("mobilenet_v2", **kw)
    anchors = generate_anchors(jcfg)
    boxes, labels = _random_gt(np.random.default_rng(seed), 4, 16)
    # a sub-threshold sliver gt in image 0: positive only by force-match
    boxes[0, 0] = [0.41, 0.41, 0.435, 0.435]
    labels[0, 0] = 3
    got = _port(anchors, boxes, labels, tcfg)
    args = (jnp.asarray(anchors), jnp.asarray(boxes), jnp.asarray(labels),
            jcfg)
    _assert_same(got, j_match_batch(*args))
    _assert_same(got, match_batch_pallas(*args, interpret=True))
    assert got[1][0, :, 3].sum() >= 1
    # the kernel's post-pass (applied to threshold-only targets) gives the
    # plain force branch's targets exactly
    a, b, lab = (torch.from_numpy(x) for x in (anchors, boxes, labels))
    d0, l0 = tmatch.match_targets(a, b, lab, tcfg.iou_threshold,
                                  tcfg.variances)
    d1, l1 = tmatch.force_match(d0, l0, a, b, lab, tcfg.variances)
    d2, l2 = tmatch.match_targets(a, b, lab, tcfg.iou_threshold,
                                  tcfg.variances, force_match_for_gt=True)
    assert torch.equal(l1, l2) and torch.equal(d1, d2)


def test_dispatch_cpu_takes_the_plain_version_and_cuda_refuses_cpu():
    cfg = t_hyper("mobilenet_v2", max_gt_boxes=4)
    anchors = torch.from_numpy(generate_anchors(cfg))
    boxes, labels = (torch.from_numpy(x) for x in
                     _random_gt(np.random.default_rng(5), 2, 4))
    before = tkernel.LAUNCHES
    deltas, lab = tkernel.match_encode(anchors, boxes, labels, cfg)
    want = tmatch.match_targets(anchors, boxes, labels, cfg.iou_threshold,
                                cfg.variances)
    assert torch.equal(deltas, want[0]) and torch.equal(lab, want[1])
    assert lab.dtype == torch.int32 and deltas.shape == (2, 2268, 4)
    assert tkernel.LAUNCHES == before  # no kernel ran
    with pytest.raises(ValueError):
        tkernel.match_encode_cuda(anchors, boxes, labels, 0.5, cfg.variances)
    with pytest.raises(TypeError):
        tkernel.match_encode(anchors, boxes, labels.long(), cfg)
    with pytest.raises(ValueError):
        tkernel.match_encode(anchors, boxes, labels[:, :2], cfg)


@pytest.mark.cuda
def test_match_encode_kernel_matches_reference_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    rng = np.random.default_rng(3)
    for backbone, g in (("mobilenet_v2", 64), ("vgg16", 16),
                        ("mobilenet_v2", 256), ("mobilenet_v2", 1)):
        cfg = t_hyper(backbone, max_gt_boxes=g)
        anchors = torch.from_numpy(generate_anchors(cfg)).cuda()
        boxes, labels = (torch.from_numpy(x).cuda()
                         for x in _random_gt(rng, 8, g))
        got = tkernel.match_encode_cuda(anchors, boxes, labels,
                                        cfg.iou_threshold, cfg.variances)
        torch.cuda.synchronize()
        want = tmatch.match_targets(anchors, boxes, labels,
                                    cfg.iou_threshold, cfg.variances)
        assert torch.equal(got[1], want[1]), (backbone, g)
        assert float((got[0] - want[0]).abs().max()) <= ATOL
