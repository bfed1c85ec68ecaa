"""RetinaNet-ResNeXt50-32x4d-FPN in the port against the benchmark's plain
reference (portbench/reference/retinanet.py), on the CPU. The JAX package
has no RetinaNet, so the reference is the plain PyTorch one, on the seeded
weights the benchmark serves (He-normal trunk and FPN, heads at std 0.01,
BatchNorm statistics from synthetic scenes).

- The configuration: get_hyper_params("retinanet_rx50fpn_800") states what
  portbench/configs/retinanet-rx50fpn-800.json states (the serving
  driver's own field list); 120,087 anchors at 800, equal to the
  reference's to float32 rounding, and torchvision's base boxes of P3 and
  P7 (ratio-major, rounded half to even); 402.4 GFLOP an image.
- The parameters at the published widths: 37,060,652 in the convolutions,
  68,224 in BatchNorm's scales and shifts; 37,094,764 once folded.
- The forward: (deltas, logits) of the unfolded model in float64 against
  the reference in float64, at a small preset (128 px, 32 groups, narrow
  widths, 7 classes) and at the published widths at 128 px; the folded
  float32 model within float32's rounding.
- The selection and NMS: class-wise greedy NMS over candidates split
  unevenly over the classes, one class holding 700 (three rows of 256),
  and over every split of ops/kernels/classwise_keep_cases.py, against a
  greedy loop per class; the threshold at 0.05,
  each level's top-k and the class-wise NMS of the decoder against the
  reference's postprocess on crafted logits, bit for bit; a whole predict
  at the small preset judged by the benchmark's comparison.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import data
from portbench.drivers import serve_retinanet
from portbench.reference import retinanet as ref
from tfssd_torch import get_hyper_params
from tfssd_torch import predict as tpredict
from tfssd_torch.models.decoder import (make_predict_fn, normalize_images,
                                        retinanet_detections)
from tfssd_torch.models.ssd import get_model
from tfssd_torch.ops.boxes import generate_anchors, iou_matrix
from tfssd_torch.ops.kernels.classwise_keep_cases import (NAMES as CASE_NAMES,
                                                          random_candidates,
                                                          split_cases)
from tfssd_torch.ops.nms import classwise_nms
from tfssd_torch.utils.convert import load_variables
from tfssd_torch.utils.fold_bn import fold_for_serving

ROOT = Path(__file__).resolve().parents[1]
KEY = "retinanet_rx50fpn_800"
FILE_CFG = json.loads(
    (ROOT / "portbench/configs/retinanet-rx50fpn-800.json").read_text())
AT_128 = dict(img_size=128, feature_map_shapes=(16, 8, 4, 2, 1))
SMALL = dict(AT_128, stem_channels=8, stage_widths=(32, 32, 64, 64),
             stage_channels=(16, 32, 32, 64), fpn_channels=16,
             num_classes=7)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """torch at 2 threads: the test runner's workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfgs(**overrides):
    """(the program's config, the reference's dict) with `overrides`."""
    cfg = get_hyper_params(KEY, **overrides)
    rcfg = dict(FILE_CFG, **{k: list(v) if isinstance(v, tuple) else v
                             for k, v in overrides.items()})
    rcfg["anchors"] = cfg.total_anchors
    return cfg, rcfg


def _model(tree, overrides, fold_bn):
    """predict.load_model's steps at a preset: the tree loaded, BatchNorm
    folded where `fold_bn`, eval mode."""
    cfg = get_hyper_params(KEY, **overrides)
    model = load_variables(get_model(cfg), {k: v.numpy()
                                            for k, v in tree.items()})
    return fold_for_serving(cfg, model.eval())[1] if fold_bn else model.eval()


def test_the_configuration_file_states_the_program():
    cfg = get_hyper_params(KEY)
    serve_retinanet.check_program_config(cfg, FILE_CFG)
    with pytest.raises(ValueError, match="topk_candidates"):
        serve_retinanet.check_program_config(
            get_hyper_params(KEY, topk_candidates=500), FILE_CFG)
    anchors = generate_anchors(cfg)
    assert anchors.shape == (120_087, 4) == (FILE_CFG["anchors"], 4)
    assert cfg.strides == (8, 16, 32, 61, 114)
    # float32 against float64 division by 800
    assert np.abs(anchors - ref.anchors(FILE_CFG)).max() < 1e-7
    # torchvision's cell anchors, x-first pixels: P3 (32, 40, 50) and P7
    # (512, 645, 812); 645 / 2 = 322.5 rounds to even
    p3 = [[-23, -11, 23, 11], [-28, -14, 28, 14], [-35, -18, 35, 18],
          [-16, -16, 16, 16], [-20, -20, 20, 20], [-25, -25, 25, 25],
          [-11, -23, 11, 23], [-14, -28, 14, 28], [-18, -35, 18, 35]]
    p7 = [[-362, -181, 362, 181], [-456, -228, 456, 228],
          [-574, -287, 574, 287], [-256, -256, 256, 256],
          [-322, -322, 322, 322], [-406, -406, 406, 406],
          [-181, -362, 181, 362], [-228, -456, 228, 456],
          [-287, -574, 287, 574]]
    np.testing.assert_array_equal(ref.base_anchors(
        cfg.anchor_sizes[0], cfg.anchor_ratios), p3)
    np.testing.assert_array_equal(ref.base_anchors(
        cfg.anchor_sizes[4], cfg.anchor_ratios), p7)
    # the first P3 anchors, y-first and normalised; P7's last cell sits at
    # 6 x 114 pixels
    np.testing.assert_allclose(anchors[:9] * 800,
                               np.asarray(p3)[:, [1, 0, 3, 2]], atol=1e-4)
    np.testing.assert_allclose(anchors[-9:] * 800, np.asarray(p7)[
        :, [1, 0, 3, 2]] + 6 * 114, atol=1e-3)
    assert ref.model_flops(FILE_CFG) / 1e9 == pytest.approx(402.42, abs=0.01)


def test_the_published_parameter_count_through_load_model():
    cfg = get_hyper_params(KEY)
    model = get_model(cfg)
    n = sum(p.numel() for p in model.parameters())
    assert n == 37_060_652 + 68_224
    specs = ref.weight_specs(FILE_CFG)
    assert sum(math.prod(s) for k, s, _ in specs
               if k.startswith("params/")) == n
    # the serving entry point builds, loads and folds it from a tree of the
    # benchmark's layout (zeros: no forward at 800 on the CPU)
    tree = {k: np.zeros(s, np.float32) for k, s, _ in specs}
    got_cfg, folded = tpredict.load_model(KEY, tree, 0, "cpu", fold_bn=True)
    assert got_cfg.fold_bn and not folded.training
    assert type(folded).__name__ == "RetinaNet"
    assert not any(isinstance(m, torch.nn.BatchNorm2d)
                   for m in folded.modules())
    assert sum(p.numel() for p in folded.parameters()) == 37_094_764


@pytest.mark.parametrize("preset", ["small", "published"])
def test_the_forward_matches_the_reference(preset):
    overrides = SMALL if preset == "small" else AT_128
    _, rcfg = _cfgs(**overrides)
    tree = ref.seeded_weights(rcfg, 2**31 + 7, "cpu")
    ref.check_tree(rcfg, tree)
    images = torch.from_numpy(data.synthetic(2, 128, 3)["image"])
    t64 = {k: v.double() for k, v in tree.items()}
    with torch.no_grad():
        want = ref.forward(rcfg, t64, ref.preprocess(rcfg, images,
                                                     torch.float64))
        model = _model(tree, overrides, fold_bn=False).double()
        x = ref.preprocess(rcfg, images, torch.float64)
        got64 = model(x)
        folded = _model(tree, overrides, fold_bn=True)
        mean, std = (torch.tensor(v) for v in (rcfg["image_mean"],
                                               rcfg["image_std"]))
        got32 = folded(normalize_images(images, mean, std))
    for name, w, g64, g32 in zip(("deltas", "logits"), want, got64, got32):
        assert g64.shape == w.shape and g32.dtype == torch.float32
        scale = float(w.abs().max())
        assert scale > 0
        # float64 throughout, another order of the same sums
        assert float((g64 - w).abs().max()) <= 1e-12 * scale, name
        # float32 through ~60 layers, whose last five (the heads' std-0.01
        # convs) shrink their input: the rounding of the larger inputs
        # reads up to ~3e-5 of the output's scale (small preset; ~1e-5 at
        # the published widths); a TF32 product keeps 10 bits (~1e-3)
        assert float((g32.double() - w).abs().max()) <= 1e-4 * scale, name


def _greedy_per_class(boxes, scores, classes, thr, score_thr):
    """The plain definition: per class, by score (ties to the lower
    index), keep a candidate unless a kept one overlaps it beyond thr."""
    kept = []
    for c in torch.unique(classes).tolist():
        idx = torch.nonzero(classes == c).reshape(-1)
        idx = idx[torch.sort(scores[idx], descending=True,
                             stable=True).indices]
        mine = []
        for i in idx.tolist():
            if scores[i] <= score_thr:
                continue
            if mine and bool((iou_matrix(boxes[i][None], boxes[mine])
                              > thr).any()):
                continue
            mine.append(i)
        kept += mine
    return set(kept)


def _uneven_candidates():
    """1,500 candidates: class 0 holds 700 (rows 0-2 of 256), class 1 300,
    the rest spread over 40 classes; a tenth score at or below 0.05."""
    gen = torch.Generator().manual_seed(11)
    t = 1500
    classes = torch.cat([torch.zeros(700), torch.ones(300),
                         torch.randint(2, 42, (500,), generator=gen)
                         ]).long()[torch.randperm(t, generator=gen)]
    scores = torch.rand(t, generator=gen) * 0.9 + 0.06
    scores[torch.rand(t, generator=gen) < 0.1] = 0.05
    centre = torch.rand(t, 2, generator=gen) * 0.5 + 0.25
    size = torch.rand(t, 2, generator=gen) * 0.1 + 0.05
    boxes = torch.cat([centre - size / 2, centre + size / 2], dim=1)
    return boxes, scores, classes


def _rows(boxes, scores, classes):
    """(score, class, box) of each row, sorted: a keep compared as a
    multiset, whatever order equal scores took."""
    return sorted(zip(scores.tolist(), classes.tolist(),
                      map(tuple, boxes.tolist())))


@pytest.mark.parametrize("split", ("uneven",) + CASE_NAMES)
def test_classwise_nms_keeps_what_greedy_nms_per_class_keeps(split):
    """The uneven split through the top 300, then every split of
    ops/kernels/classwise_keep_cases.py (three images of 1,500 candidates
    over 42 classes; one class alone walks 6 rows, the last of 220) with
    every kept candidate in the output."""
    if split != "uneven":
        base = random_candidates(3, 1500, 42, 12)
        _, boxes, scores, classes = dict(
            (case[0], case) for case in split_cases(*base, 42, 0.05))[split]
        res = classwise_nms(boxes, scores, classes, 42, 0.5, 0.05, 1500)
        for i in range(3):
            want = sorted(_greedy_per_class(boxes[i], scores[i], classes[i],
                                            0.5, 0.05))
            v = int(res.valid[i])
            assert v == len(want) > 0
            assert _rows(res.boxes[i, :v], res.scores[i, :v],
                         res.classes[i, :v]) == _rows(
                             boxes[i, want], scores[i, want],
                             classes[i, want] + 1)
            assert not res.classes[i, v:].any()
        return
    boxes, scores, classes = _uneven_candidates()
    t = scores.shape[0]
    res = classwise_nms(boxes[None], scores[None], classes[None], 42, 0.5,
                        0.05, 300)
    want = _greedy_per_class(boxes, scores, classes, 0.5, 0.05)
    assert 300 < len(want) < t
    # across the row boundaries of class 0, kept ones were suppressed
    assert 0 < sum(1 for i in want if classes[i] == 0) < 500
    top = sorted(want, key=lambda i: -float(scores[i]))[:300]
    assert int(res.valid[0]) == 300
    torch.testing.assert_close(res.scores[0], scores[top], rtol=0, atol=0)
    torch.testing.assert_close(res.boxes[0], boxes[top], rtol=0, atol=0)
    assert res.classes[0].tolist() == (classes[top] + 1).tolist()
    # fewer candidates than the output: padding rows are class 0, score 0
    res = classwise_nms(boxes[None, :100], scores[None, :100],
                        classes[None, :100], 42, 0.5, 0.05, 300)
    v = int(res.valid[0])
    assert v == len(_greedy_per_class(boxes[:100], scores[:100],
                                      classes[:100], 0.5, 0.05))
    assert not res.classes[0, v:].any() and not res.scores[0, v:].any()


def test_the_selection_and_nms_match_the_reference():
    """Crafted logits (float32, the port's precision, in both): P3 holds
    more pairs above 0.05 than the top-k keeps, one class holds 400 of
    them, P4 a few pairs above the threshold, P5-P7 none; the program's
    decoder and the reference's postprocess agree bit for bit."""
    cfg, rcfg = _cfgs(**SMALL, topk_candidates=600)
    gen = torch.Generator().manual_seed(5)
    n = cfg.total_anchors
    logits = torch.full((2, n, cfg.num_classes), -6.0)
    p3 = cfg.anchors_per_map[0]
    logits[:, :p3] = torch.randn(2, p3, cfg.num_classes, generator=gen)
    logits[:, :p3, 3] += 1.5           # class 3 fills most of P3's top 600
    p4 = slice(p3, p3 + 20)
    logits[:, p4, 1] = torch.rand(2, 20, generator=gen) * 4 - 5  # ~half
    deltas = torch.randn(2, n, 4, generator=gen) * 0.2
    anchors = torch.from_numpy(generate_anchors(cfg))
    got = retinanet_detections(anchors, deltas, logits, cfg)
    want = ref.postprocess(rcfg, anchors, deltas, logits)
    s = torch.sigmoid(logits)
    assert int((s[:, :p3] > 0.05).sum()) > 2 * 600    # the top-k cuts
    assert 0 < int((s[:, p4] > 0.05).sum()) < 40      # the threshold cuts
    assert int((s[:, p3 + 20:] > 0.05).sum()) == 0
    for i in range(2):
        assert int(got.valid[i]) == int(want["valid"][i]) > 100
        assert got.classes[i].tolist() == want["classes"][i].tolist()
        torch.testing.assert_close(got.scores[i], want["scores"][i],
                                   rtol=0, atol=0)
        torch.testing.assert_close(got.boxes[i], want["boxes"][i], rtol=0,
                                   atol=0)
    assert int((got.classes == 4).sum()) > 256
    assert set(got.classes[got.scores > 0].unique().tolist()) <= set(
        range(1, cfg.num_classes + 1))


def test_a_predict_at_the_small_preset_passes_the_benchmarks_comparison():
    cfg, rcfg = _cfgs(**SMALL, topk_candidates=300)
    tree = ref.seeded_weights(rcfg, 4, "cpu")
    model = _model(tree, dict(SMALL, topk_candidates=300), fold_bn=True)
    predict = make_predict_fn(model, generate_anchors(cfg), cfg)
    images = torch.from_numpy(data.synthetic(2, 128, 9)["image"])
    res = predict(images)
    assert res.boxes.shape == (2, 300, 4) and bool((res.valid > 100).all())
    t64 = {k: v.double() for k, v in tree.items()}
    with torch.no_grad():
        deltas, logits = ref.forward(rcfg, t64, ref.preprocess(
            rcfg, images, torch.float64))
    anchors = torch.from_numpy(ref.anchors(rcfg))
    numbers = ref.judge(rcfg, anchors, deltas, logits, tuple(res))
    limits = FILE_CFG["limits"]["serve_retinanet"]
    assert numbers["det_gap"] <= limits["det_gap"], numbers
    assert numbers["sel_gap"] <= limits["sel_gap"], numbers
    # the reference's own NMS judged by its comparison reads 0
    own = ref.postprocess(rcfg, anchors, deltas, logits)
    assert ref.judge(rcfg, anchors, deltas, logits, tuple(
        own[k] for k in ("boxes", "scores", "classes", "valid"))) == {
            "det_gap": 0.0, "sel_gap": 0.0}
    # one score moved by 0.05 reads far from the limits
    moved = res.scores.clone()
    moved[0, 0] += 0.05
    assert ref.judge(rcfg, anchors, deltas, logits, (
        res.boxes, moved, res.classes, res.valid))["det_gap"] > 0.04
