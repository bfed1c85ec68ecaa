"""Parity of the port's NMS (tfssd_torch.ops.nms, ops/kernels/nms_keep.py)
with the JAX package's: the plain keep mask against the Pallas kernel in
interpret mode and against the default blocked solve, on random inputs and
on the crafted edge cases of ops/kernels/nms_keep_cases.py (on the card:
the kernel against the plain version on the same cases), and combined_nms
on the hand-made cases of tests/test_nms.py and on random inputs.

Keep masks and classes must be equal; boxes and scores within 1e-6 (both
sides gather the same float32 values, so they agree exactly in practice).
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

from tfssd_torch.ops import nms as tnms  # noqa: E402
from tfssd_torch.ops.boxes import iou_matrix  # noqa: E402
from tfssd_torch.ops.kernels import nms_keep as tkeep  # noqa: E402
from tfssd_torch.ops.kernels.nms_keep_cases import keep_cases  # noqa: E402
from tfssd_tpu.ops import nms as jnms  # noqa: E402
from tfssd_tpu.ops.kernels.nms_keep import nms_keep_pallas  # noqa: E402

ATOL = 1e-6


def _candidates(rng, r, k, spread=1.0):
    centers = rng.uniform(0.3, 0.7, (r, k, 2)) * spread + 0.15
    sizes = rng.uniform(0.05, 0.4, (r, k, 2)) * max(spread, 0.3)
    boxes = np.clip(np.concatenate(
        [centers - sizes / 2, centers + sizes / 2], -1), 0, 1)
    scores = np.sort(rng.uniform(0, 1, (r, k)), axis=-1)[:, ::-1]
    return boxes.astype(np.float32), np.ascontiguousarray(
        scores.astype(np.float32))


@pytest.mark.parametrize("iou_thr,score_thr", [(0.45, 0.05), (0.3, 0.5)])
def test_keep_reference_matches_pallas_interpret(iou_thr, score_thr):
    rng = np.random.default_rng(11)
    boxes, scores = _candidates(rng, 6, 32)
    scores[:, -4:] = 0.0
    want = nms_keep_pallas(jnp.asarray(boxes), jnp.asarray(scores),
                           iou_thr, score_thr, interpret=True)
    got = tkeep.nms_keep(torch.from_numpy(boxes), torch.from_numpy(scores),
                         iou_thr, score_thr)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k,spread", [(200, 1.0), (200, 0.1), (130, 0.3),
                                      (65, 0.05), (7, 1.0)])
def test_keep_reference_matches_greedy_blocked(k, spread):
    rng = np.random.default_rng(k + int(spread * 100))
    boxes, scores = _candidates(rng, 5, k, spread)
    valid = scores > 0.1
    want = jnms._greedy_keep_blocked(jnp.asarray(boxes), jnp.asarray(valid),
                                     0.45)
    got = tkeep.nms_keep_reference(torch.from_numpy(boxes),
                                   torch.from_numpy(scores), 0.45, 0.1)
    assert got.any() and not got.all()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_keep_dispatch_and_checks():
    boxes = torch.zeros((2, 3, 4))
    scores = torch.ones((2, 3))
    before = tkeep.LAUNCHES
    assert tkeep.nms_keep(boxes, scores, 0.45, 0.0).shape == (2, 3)
    assert tkeep.LAUNCHES == before  # the plain version counts nothing
    with pytest.raises(ValueError):
        tkeep.nms_keep_cuda(boxes, scores, 0.45, 0.0)
    with pytest.raises(ValueError):
        tkeep.nms_keep(boxes, scores[:, :2], 0.45, 0.0)
    with pytest.raises(TypeError):
        tkeep.nms_keep(boxes.double(), scores.double(), 0.45, 0.0)


@pytest.mark.cuda
def test_keep_kernel_matches_reference_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    rng = np.random.default_rng(3)
    for k, spread in [(200, 1.0), (200, 0.1), (256, 0.3), (65, 1.0), (1, 1)]:
        boxes, scores = _candidates(rng, 160, k, spread)
        b = torch.from_numpy(boxes).cuda()
        s = torch.from_numpy(scores).cuda()
        got = tkeep.nms_keep_cuda(b, s, 0.45, 0.1)
        torch.cuda.synchronize()
        want = tkeep.nms_keep_reference(b, s, 0.45, 0.1)
        assert torch.equal(got, want), (k, spread)


ROOT = Path(__file__).resolve().parents[1]
CASES = {c.name: c for c in keep_cases()}

# XLA:CPU always allows LLVM to fuse a multiply and an add into an FMA, so
# the jitted body of the Pallas kernel rounds some IoUs (area_i + area_j -
# inter) once where float32 elementwise code rounds twice: on the decimal
# grid case many pairs' IoUs move by an ulp, and at the exact threshold the
# keep mask then differs from the plain version's and from the JAX
# package's own _greedy_keep_blocked (which runs op by op). So the
# interpreted kernel runs in a process whose XLA may not emit FMA
# instructions (--xla_cpu_max_isa=AVX), where every operation rounds as
# written, as on the card under -fmad=false.
_PALLAS_SCRIPT = """
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from tfssd_torch.ops.kernels.nms_keep_cases import keep_cases
from tfssd_tpu.ops.kernels.nms_keep import nms_keep_pallas
np.savez(sys.argv[1], **{
    c.name: np.asarray(nms_keep_pallas(
        jnp.asarray(c.boxes), jnp.asarray(c.scores), c.iou_threshold,
        c.score_threshold, interpret=True))
    for c in keep_cases()})
"""


@pytest.fixture(scope="module")
def pallas_keep(tmp_path_factory):
    out = tmp_path_factory.mktemp("pallas") / "keep.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
               XLA_FLAGS="--xla_cpu_max_isa=AVX")
    subprocess.run([sys.executable, "-c", _PALLAS_SCRIPT, str(out)],
                   env=env, check=True, timeout=600)
    with np.load(out) as f:
        return {name: f[name] for name in f.files}


def _plain(case):
    return tkeep.nms_keep_reference(
        torch.from_numpy(case.boxes), torch.from_numpy(case.scores),
        case.iou_threshold, case.score_threshold).numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_keep_reference_matches_pallas_on_crafted_cases(name, pallas_keep):
    np.testing.assert_array_equal(_plain(CASES[name]), pallas_keep[name])


@pytest.mark.parametrize("name", sorted(CASES))
def test_keep_reference_matches_greedy_blocked_on_crafted_cases(name):
    case = CASES[name]
    valid = case.scores > np.float32(case.score_threshold)
    want = jnms._greedy_keep_blocked(jnp.asarray(case.boxes),
                                     jnp.asarray(valid), case.iou_threshold)
    np.testing.assert_array_equal(_plain(case), np.asarray(want))


@pytest.mark.parametrize("grid", ["edge_dyadic", "edge_decimal"])
def test_edge_cases_sit_on_the_threshold(grid):
    """The 'at' case's threshold is the float32 IoU of many pairs, the
    'above' and 'below' thresholds one ulp either side, and the three keep
    masks differ: the cases decide pairs exactly at the edge."""
    at = CASES[f"{grid}_at"]
    t = np.float32(at.iou_threshold)
    assert np.float32(CASES[f"{grid}_above"].iou_threshold) == np.nextafter(
        t, np.float32(-np.inf))
    assert np.float32(CASES[f"{grid}_below"].iou_threshold) == np.nextafter(
        t, np.float32(np.inf))
    b = torch.from_numpy(at.boxes)
    iou = iou_matrix(b, b).numpy()
    upper = np.triu(np.ones(iou.shape[1:], bool), 1)
    assert int(((iou == t) & upper).sum()) >= 20
    masks = [_plain(CASES[f"{grid}_{side}"])
             for side in ("above", "at", "below")]
    assert not np.array_equal(masks[0], masks[1])


def test_keep_cuda_refuses_tensor_thresholds():
    boxes = torch.zeros((2, 3, 4))
    scores = torch.ones((2, 3))
    with pytest.raises(TypeError):
        tkeep.nms_keep_cuda(boxes, scores, torch.tensor(0.45), 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_keep_kernel_matches_reference_on_crafted_cases_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    case = next(c for c in keep_cases(64, 1) if c.name == name)
    b = torch.from_numpy(case.boxes).cuda()
    s = torch.from_numpy(case.scores).cuda()
    got = tkeep.nms_keep_cuda(b, s, case.iou_threshold, case.score_threshold)
    torch.cuda.synchronize()
    want = tkeep.nms_keep_reference(b, s, case.iou_threshold,
                                    case.score_threshold)
    assert torch.equal(got, want)


def _compare(got, want, shift=0):
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes) + shift)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               atol=ATOL)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=ATOL)


def _both(boxes, scores, **kw):
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    if boxes.ndim == 2:
        boxes, scores = boxes[None], scores[None]
    want = jnms.combined_nms(jnp.asarray(boxes), jnp.asarray(scores), **kw)
    got = tnms.combined_nms(torch.from_numpy(boxes),
                            torch.from_numpy(scores), **kw)
    return got, want


def _grid_boxes(n):
    out = []
    for i in range(n):
        y, x = divmod(i, 10)
        out.append([y * 0.1, x * 0.1, y * 0.1 + 0.05, x * 0.1 + 0.05])
    return out


_OVERLAP = [[0.1, 0.1, 0.5, 0.5], [0.12, 0.12, 0.52, 0.52],
            [0.6, 0.6, 0.9, 0.9]]

HAND_CASES = {
    "overlap_suppressed": (_OVERLAP, [[0.9], [0.8], [0.7]],
                           dict(max_total_detections=10)),
    "no_cross_class": ([[0.1, 0.1, 0.5, 0.5]] * 2, [[0.9, 0.0], [0.0, 0.8]],
                       dict(max_total_detections=10)),
    "score_threshold": ([[0.1, 0.1, 0.5, 0.5], [0.6, 0.6, 0.9, 0.9]],
                        [[0.9], [0.05]],
                        dict(score_threshold=0.1, max_total_detections=10)),
    "max_total_truncates": (
        _grid_boxes(50),
        np.random.RandomState(0).uniform(0.1, 1.0, size=(50, 1)),
        dict(max_total_detections=5)),
    "negative_scores": (_OVERLAP, [[-0.3], [-0.5], [-1.2]],
                        dict(score_threshold=-1e9, max_total_detections=8)),
    "padding_rows": ([[0.1, 0.1, 0.5, 0.5]], [[0.9]],
                     dict(max_total_detections=8)),
    "ties": ([[0.1, 0.1, 0.5, 0.5], [0.6, 0.6, 0.9, 0.9],
              [0.11, 0.11, 0.5, 0.5], [0.0, 0.6, 0.3, 0.9]],
             [[0.5, 0.5], [0.5, 0.7], [0.5, 0.5], [0.7, 0.5]],
             dict(max_detections_per_class=3, max_total_detections=5)),
}


@pytest.mark.parametrize("case", sorted(HAND_CASES))
def test_combined_nms_hand_cases(case):
    boxes, scores, kw = HAND_CASES[case]
    got, want = _both(boxes, scores, **kw)
    _compare(got, want)


def _inf_case():
    rng = np.random.RandomState(11)
    n, c = 60, 3
    boxes = np.stack([
        rng.uniform(0, 0.45, (n,)), rng.uniform(0, 0.45, (n,)),
        rng.uniform(0.5, 1.0, (n,)), rng.uniform(0.5, 1.0, (n,)),
    ], axis=-1).astype(np.float32)
    scores = rng.uniform(-2, 2, (n, c)).astype(np.float32)
    scores[5:, :] = -np.inf
    scores[3, 1] = np.inf
    return boxes, scores


@pytest.mark.parametrize("prefilter", [0, 32])
def test_combined_nms_inf_scores(prefilter):
    boxes, scores = _inf_case()
    got, want = _both(boxes, scores, score_threshold=-np.inf,
                      max_total_detections=16, max_detections_per_class=16,
                      prefilter_anchors=prefilter)
    assert int(got.valid[0]) > 0
    _compare(got, want)


def test_merge_kept_minus_inf_outranks_suppressed():
    top = np.asarray([[[0.9, -np.inf, 0.5, 0.2]]], np.float32)
    keep = np.asarray([[[True, True, False, False]]])
    boxes = np.tile(np.asarray([0.1, 0.1, 0.2, 0.2], np.float32), (1, 4, 1))
    want = jnms._merge_detections(jnp.asarray(top), jnp.asarray(keep),
                                  jnp.asarray(boxes), num_classes=1, k=4,
                                  max_total_detections=6)
    got = tnms.merge_detections(torch.from_numpy(top),
                                torch.from_numpy(keep),
                                torch.from_numpy(boxes).reshape(1, 1, 4, 4),
                                max_total_detections=6)
    assert int(got.valid[0]) == 2 and np.isneginf(got.scores[0, 1].item())
    _compare(got, want)


@pytest.mark.parametrize("prefilter", [0, 128, 4096])
def test_combined_nms_random(prefilter):
    rng = np.random.RandomState(5)
    b, n, c = 2, 600, 8
    raw = rng.uniform(0, 1, size=(b, n, 2, 2)).astype(np.float32)
    boxes = np.concatenate([raw.min(axis=2), raw.max(axis=2)], axis=-1)
    scores = rng.uniform(0, 0.01, size=(b, n, c)).astype(np.float32)
    for img in range(b):
        strong = rng.choice(n, 40, replace=False)
        scores[img, strong, rng.randint(0, c, 40)] = rng.uniform(0.3, 1.0, 40)
    got, want = _both(boxes, scores, max_detections_per_class=50,
                      max_total_detections=60, score_threshold=0.005,
                      prefilter_anchors=prefilter)
    _compare(got, want)


def test_combined_nms_serving_shape():
    # The serving configuration: 2,268 anchors, 20 classes, prefilter 512,
    # per-class top-200, cross-class top-200, score threshold 0.
    rng = np.random.RandomState(9)
    b, n, c = 2, 2268, 20
    raw = rng.uniform(0, 1, size=(b, n, 2, 2)).astype(np.float32)
    boxes = np.concatenate([raw.min(axis=2), raw.max(axis=2)], axis=-1)
    logits = rng.normal(0, 2, size=(b, n, c + 1)).astype(np.float32)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    scores = (e / e.sum(-1, keepdims=True))[..., 1:].astype(np.float32)
    got, want = _both(boxes, scores, prefilter_anchors=512)
    _compare(got, want)
