"""Parity of the port's matcher (tfssd_torch.ops.matching, the plain
version of the match/encode kernel, and ops/kernels/match_encode.py's
dispatch) with the JAX package's ops/matching.match_batch and its Pallas
kernel match_batch_pallas in interpret mode, on the same numpy-seeded
gts.

Tolerances: matched labels are equal; deltas within 1e-5, the tolerance
of the JAX package's own kernel test (tests/test_kernels.py), because the
encode's log is not correctly rounded on either side and XLA may rewrite a
division by a variance as a multiplication.

The crafted cases (ops/kernels/match_encode_cases.py) are held the same
way against both JAX matchers, computed in a subprocess whose XLA may not
emit FMA instructions (--xla_cpu_max_isa=AVX): XLA:CPU otherwise contracts
area_a + h * w in the IoU's union into a multiply-add, which rounds once
where float32 elementwise code (and the kernel, built with -fmad=false)
rounds twice, and an IoU on the threshold then moves by an ulp.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tfssd_torch import get_hyper_params as t_hyper  # noqa: E402
from tfssd_torch.ops import matching as tmatch  # noqa: E402
from tfssd_torch.ops.kernels import match_encode as tkernel  # noqa: E402
from tfssd_torch.ops.kernels.match_encode_cases import match_cases  # noqa: E402,E501
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


def _assert_same(got, want, err_msg=""):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]),
                                  err_msg=err_msg)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=ATOL, err_msg=err_msg)


def _encode_f64(anchors, boxes, labels, cfg):
    """The deltas of the port's matches (its float32 IoU and first-index
    argmax) encoded in float64 numpy: the witness that says which side
    moved when the port and JAX disagree."""
    iou = tmatch.masked_iou(torch.from_numpy(anchors),
                            torch.from_numpy(boxes),
                            torch.from_numpy(labels))
    best_gt = iou.argmax(dim=-1).numpy()
    positive = (iou.amax(dim=-1) > torch.tensor(
        cfg.iou_threshold, dtype=torch.float32)).numpy()
    gt = np.take_along_axis(boxes.astype(np.float64), best_gt[..., None],
                            axis=1)
    a = anchors.astype(np.float64)
    ah, aw = a[:, 2] - a[:, 0], a[:, 3] - a[:, 1]
    acy, acx = a[:, 0] + ah / 2, a[:, 1] + aw / 2
    gh, gw = gt[..., 2] - gt[..., 0], gt[..., 3] - gt[..., 1]
    gcy, gcx = gt[..., 0] + gh / 2, gt[..., 1] + gw / 2
    valid = (gh > 1e-8) & (gw > 1e-8)
    with np.errstate(divide="ignore", invalid="ignore"):
        d = np.stack([(gcy - acy) / ah, (gcx - acx) / aw,
                      np.log(gh / ah), np.log(gw / aw)], axis=-1)
    d = np.where((valid & positive)[..., None], d, 0.0)
    return d / np.asarray(cfg.variances, np.float64)


def _sides_from_f64(ref, **sides):
    """Each side's largest distance from the float64 encode, and its count
    of deltas more than ATOL from it, in all and by component (dcy, dcx,
    dh, dw: the divides against the logs)."""
    parts = []
    for name, deltas in sides.items():
        err = np.abs(np.asarray(deltas, np.float64) - ref)
        by = "/".join(str(int(n)) for n in (err > ATOL).reshape(
            -1, 4).sum(axis=0))
        parts.append(f"{name} {err.max():.3g} ({int((err > ATOL).sum())} "
                     f"deltas > {ATOL}; dcy/dcx/dh/dw {by})")
    return "distance from a float64 encode of the same matches: " + ", ".join(
        parts)


@pytest.mark.parametrize("backbone", ["mobilenet_v2", "vgg16", "vgg16_512"])
def test_plain_matcher_matches_jax_and_pallas(backbone):
    # vgg16's 8,732 and vgg16_512's 24,564 anchors are not multiples of
    # the Pallas 512 tile
    kw = dict(max_gt_boxes=16)
    jcfg, tcfg = j_hyper(backbone, **kw), t_hyper(backbone, **kw)
    anchors = generate_anchors(jcfg)
    boxes, labels = _random_gt(np.random.default_rng(0), 4, 16)
    inputs = [a.copy() for a in (anchors, boxes, labels)]
    got = _port(anchors, boxes, labels, tcfg)
    args = (jnp.asarray(anchors), jnp.asarray(boxes), jnp.asarray(labels),
            jcfg)
    eager = j_match_batch(*args)
    pallas = match_batch_pallas(*args, interpret=True)
    # On a failure the message says which side moved (two whole runs once
    # read 88 of 36,288 deltas 1.7e-4 from JAX's eager matcher, the port's
    # side moved), whether the port computes the same again after the JAX
    # calls, and whether the inputs changed meanwhile.
    again = _port(anchors, boxes, labels, tcfg)[0].numpy()
    msg = _sides_from_f64(_encode_f64(anchors, boxes, labels, tcfg),
                          port=got[0].numpy(), port_again=again,
                          jax_match_batch=eager[0], jax_pallas=pallas[0])
    unchanged = all(np.array_equal(a, b) for a, b in
                    zip(inputs, (anchors, boxes, labels)))
    msg += (f"; inputs unchanged {unchanged}; torch at "
            f"{torch.get_num_threads()} threads, "
            f"{torch.backends.cpu.get_cpu_capability()}")
    _assert_same(got, eager, msg)
    _assert_same(got, pallas, msg)
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


ROOT = Path(__file__).resolve().parents[1]
CASES = {c.name: c for c in match_cases()}
VARIANCES = (0.1, 0.1, 0.2, 0.2)

_JAX_SCRIPT = """
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from tfssd_torch.ops.kernels.match_encode_cases import match_cases
from tfssd_tpu import get_hyper_params
from tfssd_tpu.ops.kernels.match_encode import match_encode_pallas
from tfssd_tpu.ops.matching import match_batch
out = {}
for c in match_cases():
    cfg = get_hyper_params("mobilenet_v2", max_gt_boxes=c.labels.shape[1],
                           iou_threshold=c.iou_threshold,
                           force_match_for_gt=c.force_match)
    args = (jnp.asarray(c.anchors), jnp.asarray(c.boxes),
            jnp.asarray(c.labels), cfg)
    d, onehot = match_batch(*args)
    out[c.name + "/match_batch/deltas"] = np.asarray(d)
    out[c.name + "/match_batch/labels"] = np.asarray(onehot).argmax(-1)
    d, lab = match_encode_pallas(*args, interpret=True)
    out[c.name + "/pallas/deltas"] = np.asarray(d)
    out[c.name + "/pallas/labels"] = np.asarray(lab)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_targets(tmp_path_factory):
    out = tmp_path_factory.mktemp("match") / "targets.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(out)], env=env,
                   check=True, timeout=600)
    with np.load(out) as f:
        return {name: f[name] for name in f.files}


def _plain_case(case):
    return tmatch.match_targets(
        torch.from_numpy(case.anchors), torch.from_numpy(case.boxes),
        torch.from_numpy(case.labels), case.iou_threshold, VARIANCES,
        case.force_match)


@pytest.mark.parametrize("matcher", ["match_batch", "pallas"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matcher_matches_jax_on_crafted_cases(name, matcher,
                                                    jax_targets):
    deltas, labels = _plain_case(CASES[name])
    np.testing.assert_array_equal(
        labels.numpy(), jax_targets[f"{name}/{matcher}/labels"])
    np.testing.assert_allclose(deltas.numpy(),
                               jax_targets[f"{name}/{matcher}/deltas"],
                               atol=ATOL)


@pytest.mark.parametrize("grid", ["edge_dyadic", "edge_decimal"])
def test_match_edge_cases_sit_on_the_threshold(grid):
    """The 'at' case's threshold is the float32 best IoU of many anchors,
    the 'above' and 'below' thresholds one ulp either side; the labels of
    'above' and 'at' differ on exactly those anchors."""
    at = CASES[f"{grid}_at"]
    t = np.float32(at.iou_threshold)
    assert np.float32(CASES[f"{grid}_above"].iou_threshold) == np.nextafter(
        t, np.float32(-np.inf))
    assert np.float32(CASES[f"{grid}_below"].iou_threshold) == np.nextafter(
        t, np.float32(np.inf))
    best = tmatch.masked_iou(*(torch.from_numpy(x) for x in (
        at.anchors, at.boxes, at.labels))).amax(-1).numpy()
    assert int((best == t).sum()) >= 20
    above, on = (_plain_case(CASES[f"{grid}_{side}"])[1].numpy()
                 for side in ("above", "at"))
    np.testing.assert_array_equal(above != on, best == t)


def test_crafted_cases_reach_their_edges():
    """Each case holds the situation it is named for."""
    def parts(name):
        c = CASES[name]
        a, b, lab = (torch.from_numpy(x) for x in (c.anchors, c.boxes,
                                                   c.labels))
        iou = tmatch.masked_iou(a, b, lab)
        deltas, labels = _plain_case(c)
        return c, iou, deltas, labels

    # ties: positive anchors whose maximum is shared by real rows of
    # different labels, the first row's label winning
    c, iou, _, labels = parts("ties")
    best = iou.amax(-1, keepdim=True)
    shared = ((iou == best) & (best > 0.5)).sum(-1) >= 2
    assert int(shared.sum()) >= 4
    first = iou.argmax(-1)
    assert torch.equal(labels[shared], torch.from_numpy(c.labels).gather(
        1, first)[shared])
    # holes: a real row behind a hole of the same box wins its anchors
    c, iou, _, labels = parts("holes")
    assert (c.labels[:, 0] == 0).all()
    assert (c.boxes[:, 0] == c.boxes[:, 1]).all()
    assert int((labels == torch.from_numpy(c.labels[:, 1:2])).sum()) > 0
    # a negative threshold: anchors that overlap no real gt take row 0,
    # a hole with a box (label 0, non-zero deltas) or a degenerate gt (its
    # label, zero deltas)
    for name, label_zero in (("holes_negative", True),
                             ("negative_threshold", False),
                             ("no_gt_negative", True)):
        c, iou, deltas, labels = parts(name)
        none = iou.amax(-1) == 0
        assert int(none.sum()) > 0, name
        row0 = torch.from_numpy(c.labels[:, :1]).expand_as(labels)
        assert torch.equal(labels[none], row0[none]), name
        moved = deltas.abs().sum(-1) > 0
        assert bool((moved & none).any()) == label_zero, name
    for name in ("all_real_g64", "g256", "g1", "n129"):
        c = CASES[name]
        assert int((_plain_case(c)[1] > 0).sum()) > 0, name
    assert (CASES["all_real_g64"].labels > 0).all()
    assert CASES["g256"].labels.shape[1] == 256
    assert CASES["g1"].labels.shape[1] == 1
    assert all(c.anchors.shape[0] % 128 for c in CASES.values())
    # force-match makes the sliver gt positive
    c = CASES["force_match"]
    forced = _plain_case(c)[1]
    plain = tmatch.match_targets(*(torch.from_numpy(x) for x in (
        c.anchors, c.boxes, c.labels)), c.iou_threshold, VARIANCES)[1]
    assert int((forced != plain).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_match_encode_kernel_matches_reference_on_crafted_cases_on_card(
        name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    case = next(c for c in match_cases(32, 1) if c.name == name)
    cfg = t_hyper("mobilenet_v2", max_gt_boxes=case.labels.shape[1],
                  iou_threshold=case.iou_threshold,
                  force_match_for_gt=case.force_match)
    a, b, lab = (torch.from_numpy(x).cuda() for x in (
        case.anchors, case.boxes, case.labels))
    got = tkernel.match_encode(a, b, lab, cfg)
    torch.cuda.synchronize()
    want = tmatch.match_targets(a, b, lab, case.iou_threshold,
                                cfg.variances, case.force_match)
    assert torch.equal(got[1], want[1])
    assert float((got[0] - want[0]).abs().max()) <= ATOL
