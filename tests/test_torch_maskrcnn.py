"""Mask R-CNN-ResNet50-FPN in the port against the benchmark's plain
reference (portbench/reference/maskrcnn.py), on the CPU. The JAX package
has no Mask R-CNN, so the reference is the plain PyTorch one, on the
seeded weights the benchmark serves.

- The configuration: get_hyper_params("maskrcnn_r50fpn_800x1066") states
  what portbench/configs/maskrcnn-r50fpn-800x1066.json states (the
  serving driver's own field list); 217,413 anchors on the padded
  800x1088, equal to the reference's, P6's strides (61, 64); 461.6 GFLOP
  an image at the published caps; 44,401,393 parameters (torchvision's
  count) and BatchNorm's 53,120 through load_model.
- Each stage of the unfolded model in float64 against the reference in
  float64, at a small preset and at the published widths on a 120x150
  frame, on the same inputs to each stage; the folded float32 model
  within float32's rounding.
- Both selections (the proposals and the detections) against the
  reference's postprocess on crafted float32 inputs, bit for bit; the
  class-wise keep's plain version at the box stage's split (T = 90,000
  pairs, a class of 1,000) against greedy NMS per class.
- A whole predict at a small preset judged by the benchmark's comparison
  within the configuration's limits, the reference's own predict judged
  0, and four faults judged far from the limits.
- The comparison at a top-k's cut: a candidate left out within the score's
  rounding room of the last one served reads 0, one beyond it reads its
  excess (both selections).
- The reference imports nothing of the program.
"""

import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.drivers import serve_maskrcnn
from portbench.reference import maskrcnn as ref
from tfssd_torch import get_hyper_params
from tfssd_torch import predict as tpredict
from tfssd_torch.models.decoder import (box_detections, make_predict_fn,
                                        normalize_images, pad_images,
                                        rpn_proposals)
from tfssd_torch.models.maskrcnn import roi_levels
from tfssd_torch.models.ssd import get_model
from tfssd_torch.ops.boxes import generate_anchors
from tfssd_torch.ops.kernels.classwise_keep import classwise_keep_reference
from tfssd_torch.ops.nms import class_order
from tfssd_torch.utils.convert import load_variables
from tfssd_torch.utils.fold_bn import fold_for_serving

ROOT = Path(__file__).resolve().parents[1]
KEY = "maskrcnn_r50fpn_800x1066"
FILE_CFG = json.loads(
    (ROOT / "portbench/configs/maskrcnn-r50fpn-800x1066.json").read_text())
AT_120 = dict(image_size=(120, 150), padded_size=(128, 160),
              feature_map_shapes=((32, 40), (16, 20), (8, 10), (4, 5),
                                  (2, 3)))
SMALL = dict(AT_120, stem_channels=8, stage_widths=(8, 8, 16, 16),
             stage_channels=(16, 32, 32, 64), fpn_channels=16,
             representation_size=32, num_classes=7, mask_layers=(16, 16),
             rpn_pre_nms_top_n=200, rpn_post_nms_top_n=150,
             box_detections_per_img=30)


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
    rcfg = dict(FILE_CFG, **json.loads(json.dumps(overrides)))
    rcfg["anchors"] = cfg.total_anchors
    return cfg, rcfg


def _model(tree, overrides, fold_bn):
    cfg = get_hyper_params(KEY, **overrides)
    model = load_variables(get_model(cfg), {k: v.numpy()
                                            for k, v in tree.items()})
    return fold_for_serving(cfg, model.eval())[1] if fold_bn else model.eval()


def test_the_configuration_file_states_the_program():
    cfg = get_hyper_params(KEY)
    serve_maskrcnn.check_program_config(cfg, FILE_CFG)
    with pytest.raises(ValueError, match="rpn_post_nms_top_n"):
        serve_maskrcnn.check_program_config(
            get_hyper_params(KEY, rpn_post_nms_top_n=500), FILE_CFG)
    anchors = generate_anchors(cfg)
    assert anchors.shape == (217_413, 4) == (FILE_CFG["anchors"], 4)
    assert cfg.strides == ((4, 4), (8, 8), (16, 16), (32, 32), (61, 64))
    np.testing.assert_array_equal(anchors, ref.anchors(FILE_CFG))
    # torchvision's cell anchors of P2 (32) and P6 (512), x-first pixels;
    # P6's last cell sits at (16 x 64, 12 x 61)
    np.testing.assert_array_equal(anchors[:3], [
        [-23, -11, 23, 11], [-16, -16, 16, 16], [-11, -23, 11, 23]])
    np.testing.assert_array_equal(anchors[-3:], np.asarray([
        [-362, -181, 362, 181], [-256, -256, 256, 256],
        [-181, -362, 181, 362]]) + [1024, 732, 1024, 732])
    assert ref.model_flops(FILE_CFG) / 1e9 == pytest.approx(461.6, abs=0.05)


def test_the_published_parameter_count_through_load_model():
    cfg = get_hyper_params(KEY)
    model = get_model(cfg)
    n = sum(p.numel() for p in model.parameters())
    assert n == 44_401_393 + 53_120
    specs = ref.weight_specs(FILE_CFG)
    assert sum(math.prod(s) for k, s, _ in specs
               if k.startswith("params/")) == n
    tree = {k: np.zeros(s, np.float32) for k, s, _ in specs}
    got_cfg, folded = tpredict.load_model(KEY, tree, 0, "cpu", fold_bn=True)
    assert got_cfg.fold_bn and not folded.training
    assert type(folded).__name__ == "MaskRCNN"
    assert not any(isinstance(m, torch.nn.BatchNorm2d)
                   for m in folded.modules())
    # every ConvBN's conv gains a bias of its BatchNorm's width
    assert sum(p.numel() for p in folded.parameters()) == (
        44_401_393 + 53_120 // 2)


def _close(got, want, tol, name):
    scale = float(want.abs().max())
    assert scale > 0, name
    assert float((got.double() - want).abs().max()) <= tol * scale, name


@pytest.mark.parametrize("preset", ["small", "published"])
def test_each_stage_matches_the_reference(preset):
    overrides = SMALL if preset == "small" else AT_120
    cfg, rcfg = _cfgs(**overrides)
    tree = ref.seeded_weights(rcfg, 2**31 + 7, "cpu")
    ref.check_tree(rcfg, tree)
    images = ref.frames(rcfg, 2, 3)
    t64 = {k: v.double() for k, v in tree.items()}
    gen = torch.Generator().manual_seed(1)
    h, w = cfg.image_size
    boxes = torch.rand(2, 40, 4, generator=gen, dtype=torch.float64) * \
        torch.tensor([w, h, w, h], dtype=torch.float64) * 0.5
    boxes[..., 2:] += boxes[..., :2] + 4.0
    classes = torch.randint(1, cfg.num_classes, (2, 40), generator=gen)
    model64 = _model(tree, overrides, fold_bn=False).double()
    folded = _model(tree, overrides, fold_bn=True)
    mean, std = (torch.tensor(v) for v in (cfg.image_mean, cfg.image_std))
    with torch.no_grad():
        x = ref.preprocess(rcfg, images, torch.float64)
        want_maps = ref.features(rcfg, t64, x)
        want_rpn = ref.rpn_head(rcfg, t64, want_maps)
        want_box = ref.box_head(rcfg, t64, ref.pool(
            rcfg, want_maps, boxes, cfg.box_roi_size))
        want_mask = ref.mask_probs(rcfg, t64, want_maps, boxes, classes)
        for tol, model, maps_in, dtype in (
                (1e-12, model64, x, torch.float64),
                (1e-4, folded, pad_images(normalize_images(
                    images, mean, std), cfg.padded_size), torch.float32)):
            maps = model.features(maps_in)
            for level, (g, wnt) in enumerate(zip(maps, want_maps)):
                _close(g, wnt, tol, f"P{level + 2}")
            for g, wnt, name in zip(model.rpn(maps), want_rpn,
                                    ("objectness", "rpn deltas")):
                _close(g, wnt, tol, name)
            # the heads on the reference's boxes and its maps, so that
            # each stage is held on its own
            ref_maps = [m.to(dtype) for m in want_maps]
            logits, deltas = model.box_head(model.pool(
                ref_maps, boxes.to(dtype), cfg.box_roi_size))
            _close(logits, want_box[0], tol, "class logits")
            _close(deltas, want_box[1], tol, "box deltas")
            masks = model.masks(ref_maps, boxes.to(dtype), classes,
                                torch.full((2,), 40))
            _close(masks, want_mask, tol, "masks")
    # the levels: the program's mapper on float32 boxes against the
    # reference's in float64
    b32 = boxes.float()
    assert torch.equal(roi_levels(b32, cfg), ref.roi_levels(rcfg,
                                                            b32.double()))


def test_both_selections_match_the_reference_bit_for_bit():
    """Crafted float32 inputs: objectness logits whose per-level top-k
    cuts each level, deltas moving the boxes, some boxes clipped to
    nothing; class logits whose pairs pass 0.05 in bulk for class 3; the
    program's rpn_proposals and box_detections against the reference's
    rpn_postprocess and box_postprocess."""
    cfg, rcfg = _cfgs(**SMALL)
    gen = torch.Generator().manual_seed(7)
    n = cfg.total_anchors
    objectness = torch.randn(2, n, generator=gen)
    deltas = torch.randn(2, n, 4, generator=gen) * 0.3
    deltas[:, ::50, 2:] = -9.0       # boxes far under 1e-3 pixels
    anchors = torch.from_numpy(generate_anchors(cfg))
    boxes, scores, count = rpn_proposals(anchors, objectness, deltas, cfg)
    want = ref.rpn_postprocess(rcfg, anchors, objectness, deltas)
    assert count.tolist() == want["count"].tolist() == [150, 150]
    assert torch.equal(boxes, want["proposals"])
    assert torch.equal(scores, want["scores"])
    k, c = 150, cfg.num_classes
    logits = torch.randn(2, k, c, generator=gen) * 1.5
    logits[:, :, 3] += 2.0
    box_deltas = torch.randn(2, k, c, 4, generator=gen) * 0.5
    live = torch.tensor([150, 97])
    got = box_detections(boxes, live, logits, box_deltas, cfg)
    want = ref.box_postprocess(rcfg, boxes, live, logits, box_deltas)
    assert got.valid.tolist() == want["valid"].tolist() == [30, 30]
    assert torch.equal(got.boxes, want["boxes"])
    assert torch.equal(got.scores, want["scores"])
    assert got.classes.tolist() == want["classes"].tolist()
    assert int((got.classes == 3).sum()) >= 40


def test_the_keep_at_the_box_stages_split():
    """T = 90,000 pairs of 1,000 proposals and 90 classes: class 5 holds
    all 1,000 proposals above the threshold (four rows of 256), the rest a
    fifth each; the plain keep, bounded by the largest class, equals
    greedy NMS per class."""
    k, c = 1000, 90
    gen = torch.Generator().manual_seed(3)
    centre = torch.rand(k, 2, generator=gen) * 600 + 100
    size = torch.rand(k, 2, generator=gen) * 80 + 20
    props = torch.cat([centre - size / 2, centre + size / 2], dim=1)
    boxes = (props[:, None, :] + torch.randn(k, c, 4, generator=gen)
             ).reshape(1, k * c, 4)
    scores = torch.rand(k, c, generator=gen) * 0.3
    scores[torch.rand(k, c, generator=gen) > 0.2] = 0.0
    scores[:, 5] = torch.rand(k, generator=gen) * 0.9 + 0.06
    scores = scores.reshape(1, k * c)
    classes = torch.arange(c).repeat(k)[None]
    sb, ss, cls, counts, starts = class_order(boxes, scores, classes, c,
                                              0.05)
    assert int(counts[0, 5]) == k and int(counts[0, :c].sum()) < 19_000
    keep = classwise_keep_reference(sb, ss, counts[:, :c], starts[:, :c],
                                    0.5, 0.05, max_count=k)
    valid = ss[0] > 0.05
    want = ref.greedy(sb[0][valid], ss[0][valid], cls[0][valid], 0.5)
    got = torch.nonzero(keep[0]).reshape(-1)
    assert sorted(got.tolist()) == sorted(
        torch.nonzero(valid).reshape(-1)[want].tolist())
    assert 0 < int(keep[0][cls[0] == 5].sum()) < k


def _faulty(res, name):
    """The reply with one fault planted."""
    r = [t.clone() for t in res]
    if name == "score":
        r[1][0, 0] += 0.05
    elif name == "half":
        for t in r:
            t[len(t) // 2:] = 0
    elif name == "wrong_class_masks":
        r[4][:, :-1] = r[4][:, 1:].clone()
    elif name == "proposals":
        r[5][0, 0] += 8.0
    return tuple(r)


def test_a_predict_at_the_small_preset_passes_the_benchmarks_comparison():
    cfg, rcfg = _cfgs(**SMALL)
    tree = ref.seeded_weights(rcfg, 4, "cpu")
    model = _model(tree, SMALL, fold_bn=True)
    predict = make_predict_fn(model, generate_anchors(cfg), cfg)
    images = ref.frames(rcfg, 2, 9)
    res = predict(images)
    assert res.masks.shape == (2, 30, 28, 28)
    assert res.valid.tolist() == [30, 30]
    assert res.proposal_count.tolist() == [150, 150]
    t64 = {k: v.double() for k, v in tree.items()}
    limits = FILE_CFG["limits"]["serve_maskrcnn"]
    with torch.no_grad():
        numbers = ref.judge(rcfg, t64, images, tuple(res))
        assert set(numbers) == set(serve_maskrcnn.NUMBERS)
        assert all(numbers[k] <= limits[k] for k in numbers), numbers
        own = ref.predict(rcfg, t64, images, torch.float64)
        assert ref.judge(rcfg, t64, images, own) == {
            k: 0.0 for k in numbers}
        for fault, number in (("score", "det_gap"), ("half", "rpn_sel_gap"),
                              ("wrong_class_masks", "mask_gap"),
                              ("proposals", "rpn_det_gap")):
            got = ref.judge(rcfg, t64, images, _faulty(res, fault))
            assert got[number] > 10 * limits[number], (fault, got)


@pytest.mark.parametrize("above", [3e-5, 1e-3])
@pytest.mark.parametrize("stage", ["proposals", "detections"])
def test_a_near_tie_at_a_top_k_cut_reads_either_way(stage, above):
    """The served top-k (the proposals' 150, the detections' 30 at the
    small preset) leaves out a candidate whose reference score lies `above`
    the last one served, as where the program's float32 scores ranked it
    under: within SCORE_SLACK a rounding choice, read 0; beyond it a
    selection fault, read as its excess. Disjoint boxes, so that no
    suppression explains the candidate."""
    _, rcfg = _cfgs(**SMALL)
    assert 3e-5 < ref.SCORE_SLACK < 1e-3
    want = above if above > ref.SCORE_SLACK else 0.0
    if stage == "proposals":
        k = rcfg["rpn_post_nms_top_n"]
        n = sum(ref.level_sizes(rcfg))
        i = torch.arange(n, dtype=torch.float64)
        x, y = 3.0 * (i % 1000), 3.0 * torch.div(i, 1000, rounding_mode="floor")
        ref_boxes = torch.stack([x, y, x + 2.0, y + 2.0], dim=1)
        ref_scores = torch.full((n,), 0.1, dtype=torch.float64)
        ref_scores[:k] = 0.9 - 0.002 * torch.arange(k, dtype=torch.float64)
        ref_scores[k] = ref_scores[k - 1] + above
        det, sel = ref._judge_rpn(rcfg, ref_boxes, ref_scores,
                                  ref_boxes[:k].float(),
                                  ref_scores[:k].float(), k)
    else:
        d, fg = rcfg["box_detections_per_img"], rcfg["num_classes"] - 1
        rows = d + 1
        i = torch.arange(rows, dtype=torch.float64)
        box = torch.stack([4.0 * i, 0.0 * i, 4.0 * i + 3.0, 0.0 * i + 3.0],
                          dim=1)
        ref_boxes = box[:, None, :].expand(-1, fg, -1).clone()
        ref_scores = torch.zeros(rows, fg, dtype=torch.float64)
        ref_scores[:d, 0] = 0.9 - 0.01 * torch.arange(d, dtype=torch.float64)
        ref_scores[d, 0] = ref_scores[d - 1, 0] + above
        det, sel = ref._judge_boxes(
            rcfg, ref_boxes, ref_scores, torch.arange(rows), rows,
            box[:d].float(), ref_scores[:d, 0].float(),
            torch.ones(d, dtype=torch.int32), d)
    assert det < 1e-7
    assert sel == pytest.approx(want, abs=1e-12)


def test_the_reference_loads_nothing_of_the_program():
    code = ("import json, sys; import portbench.reference.maskrcnn; "
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    loaded = set(json.loads(out.strip().splitlines()[-1]))
    assert "portbench" in loaded
    assert not loaded & {"tfssd_torch", "tfssd_tpu", "jax", "flax"}
