"""Parity of the port's VGG16 serving path (SSD300-VGG16 and SSD512-VGG16)
with the JAX package, on the CPU.

- Blocks: L2Norm (with an all-zero pixel), the SAME max-pools (75 -> 38
  pads (0, 1) with -inf; pool5's 3x3 stride 1), fc6's dilated SAME conv and
  the bias + ReLU extra block in its SAME stride-2 and VALID stride-1 forms,
  from seeded numpy weights and inputs: within 1e-5.
- fc6 without autograd is a GEMM over its unfolded taps: within 1e-12 of
  F.conv2d at dilation 6 in float64 on fc6's maps (19, 32) and on maps
  narrower than its span (10, 1); with autograd recording, or in
  bfloat16, it stays F.conv2d, gradient and all.
- SSD512 whole, JAX's seeded init carried across, batch 1: each of the
  seven taps and (deltas, logits) within REL of that output's largest
  magnitude: without BatchNorm nothing holds the scales near 1 (the
  seeded SSD512's taps range from 4e-4 to 4.6), so one absolute gate
  would say nothing about the small ones.
- SSD300-VGG16 on the trained checkpoint trained/ssd_vgg16/4720 over the
  predictor's synthetic evaluation images: taps and (deltas, logits)
  within REL of each output's largest magnitude; NMSResult from the same
  (deltas, logits) equal in classes and valid, boxes and scores within
  1e-6; the JAX mAP above 0.5 and the port's within 1e-4 of it, through
  the modules and through `python -m tfssd_torch.predict`.

Batches are small (a VGG16 forward costs ~40x a MobileNetV2 one).
"""

import dataclasses
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tfssd_torch import get_hyper_params as t_hyper  # noqa: E402
from tfssd_torch import predict as tpredict  # noqa: E402
from tfssd_torch.evaluate import detections_from_nms_result as t_dets  # noqa: E402
from tfssd_torch.evaluate import evaluate_predictions as t_eval  # noqa: E402
from tfssd_torch.models import layers as tlayers  # noqa: E402
from tfssd_torch.models.decoder import decode_predictions as t_decode  # noqa: E402
from tfssd_torch.models.decoder import preprocess_images as t_pre  # noqa: E402
from tfssd_torch.models.ssd import get_model as t_model  # noqa: E402
from tfssd_torch.ops.boxes import generate_anchors as t_anchors  # noqa: E402
from tfssd_torch.utils import convert  # noqa: E402
from tfssd_torch.utils.fold_bn import fold_for_serving as t_fold  # noqa: E402
from tfssd_tpu import get_hyper_params as j_hyper  # noqa: E402
from tfssd_tpu.data.loader import batch_examples as j_batches  # noqa: E402
from tfssd_tpu.data.synthetic import SyntheticDataset as JSynth  # noqa: E402
from tfssd_tpu.evaluate import detections_from_nms_result as j_dets  # noqa: E402
from tfssd_tpu.evaluate import evaluate_predictions as j_eval  # noqa: E402
from tfssd_tpu.models import get_model as j_model  # noqa: E402
from tfssd_tpu.models import init_model as j_init  # noqa: E402
from tfssd_tpu.models import layers as jlayers  # noqa: E402
from tfssd_tpu.models.decoder import decode_predictions as j_decode  # noqa: E402
from tfssd_tpu.models.vgg16 import VGG16Backbone  # noqa: E402
from tfssd_tpu.ops.boxes import generate_anchors  # noqa: E402
from tfssd_tpu.train import TrainState, preprocess_images as j_pre  # noqa: E402
from tfssd_tpu.utils.checkpoint import CheckpointManager  # noqa: E402
from tfssd_tpu.utils.fold_bn import fold_for_serving as j_fold  # noqa: E402

CKPT = os.path.join(os.path.dirname(__file__), "..", "trained", "ssd_vgg16")
STEP = 4720
N_IMAGES = 16
BATCH = 8
ATOL_BLOCK = 1e-5
# |port - jax| <= REL * max|jax| per output: two float32 conv
# implementations summing 15+ layers in different orders. Measured on the
# CPU: 2.5e-6 to 5.0e-6 on the seeded SSD512, 4.7e-7 to 1.0e-6 on the
# trained SSD300.
REL = 2e-5
ATOL_NMS = 1e-6


def _close(got, want, rel=REL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max err {err} > {rel} x {scale}"


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


# ---- blocks ----------------------------------------------------------------

def test_l2norm_matches_with_a_zero_pixel():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, (2, 7, 7, 16)).astype(np.float32)
    x[0, 3, 4] = 0.0  # the 1e-10 inside the root keeps this pixel at 0
    jmod = jlayers.L2Norm(scale_init=20.0)
    variables = jmod.init(jax.random.key(0), jnp.asarray(x))
    gamma = rng.uniform(5, 30, 16).astype(np.float32)
    want = np.asarray(jmod.apply({"params": {"gamma": gamma}},
                                 jnp.asarray(x)))
    tmod = tlayers.L2Norm(16)
    np.testing.assert_array_equal(
        tmod.gamma.detach().numpy(),
        np.asarray(variables["params"]["gamma"]))  # both start at 20
    tmod.gamma.data = torch.from_numpy(gamma)
    with torch.no_grad():
        got = _nhwc(tmod(_nchw(x)))
    assert np.all(got[0, 3, 4] == 0.0)
    np.testing.assert_allclose(got, want, atol=ATOL_BLOCK, rtol=1e-6)


@pytest.mark.parametrize("size,kernel,stride", [
    (75, 2, 2), (150, 2, 2), (38, 2, 2), (19, 3, 1), (64, 2, 2)])
def test_same_max_pool_matches(size, kernel, stride):
    # Mostly negative inputs: a zero pad would show at the borders.
    rng = np.random.default_rng(size)
    x = (rng.normal(0, 1, (2, size, size, 4)) - 3.0).astype(np.float32)
    want = np.asarray(fnn.max_pool(jnp.asarray(x), (kernel, kernel),
                                   strides=(stride, stride),
                                   padding="SAME"))
    got = _nhwc(tlayers.same_max_pool2d(_nchw(x), kernel, stride))
    assert got.shape == want.shape == (2, -(-size // stride),
                                       -(-size // stride), 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [19, 32, 10])
def test_dilated_fc6_conv_matches(size):
    rng = np.random.default_rng(size)
    x = rng.normal(0, 1, (2, size, size, 8)).astype(np.float32)
    jmod = fnn.Conv(12, (3, 3), kernel_dilation=(6, 6))
    variables = jmod.init(jax.random.key(0), jnp.asarray(x))
    kernel = rng.normal(0, 1 / np.sqrt(72), (3, 3, 8, 12)).astype(np.float32)
    bias = rng.normal(0, 0.2, 12).astype(np.float32)
    assert variables["params"]["kernel"].shape == kernel.shape
    want = np.asarray(jmod.apply({"params": {"kernel": kernel, "bias": bias}},
                                 jnp.asarray(x)))
    tmod = tlayers.SameConv2d(8, 12, 3, dilation=6)
    tmod.load_state_dict({"weight": torch.from_numpy(
        kernel.transpose(3, 2, 0, 1).copy()), "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        got = _nhwc(tmod(_nchw(x)))
    np.testing.assert_allclose(got, want, atol=ATOL_BLOCK)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("size", [19, 32, 10, 1])
def test_fc6_gemm_is_the_dilated_conv(size, batch, bias, stride):
    # fc6's maps at SSD300 (19) and SSD512 (32), and 10 and 1, where the
    # kernel's span (13) is wider than the map; fewer channels than fc6's
    # 512 -> 1,024, which change only the length of each sum. fc6's stride
    # is 1; stride 2 holds the helper's output size.
    gen = torch.Generator().manual_seed(size * 10 + batch)
    x = torch.randn(batch, 16, size, size, generator=gen, dtype=torch.float64)
    w = torch.randn(24, 16, 3, 3, generator=gen, dtype=torch.float64) / 12
    b = torch.randn(24, generator=gen, dtype=torch.float64) if bias else None
    got = tlayers._atrous_gemm(x, w, b, (6, 6), (stride, stride), (6, 6))
    want = torch.nn.functional.conv2d(x, w, b, stride, 6, 6)
    out = -(-size // stride)
    assert got.shape == want.shape == (batch, 24, out, out)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("route", ["records", "no_grad", "frozen",
                                   "bfloat16"])
def test_fc6_takes_the_gemm_only_where_autograd_records_nothing(
        route, monkeypatch):
    calls = []
    gemm = tlayers._atrous_gemm

    def spy(*args):
        calls.append(args[0].shape)
        return gemm(*args)

    monkeypatch.setattr(tlayers, "_atrous_gemm", spy)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 19, 19, generator=gen, dtype=torch.float64)
    if route == "bfloat16":
        # cuDNN's tensor-core kernels beat the GEMM in bfloat16: F.conv2d
        conv = tlayers.SameConv2d(8, 12, 3, dilation=6,
                                  compute_dtype=torch.bfloat16)
        xb = x.to(torch.bfloat16)
        with torch.no_grad():
            got = conv(x.float())
            want = torch.nn.functional.conv2d(
                xb, conv.weight.to(torch.bfloat16), None, 1, 6, 6
            ) + conv.bias.to(torch.bfloat16)[:, None, None]
        assert calls == [] and torch.equal(got, want)
        return
    conv = tlayers.SameConv2d(8, 12, 3, dilation=6).double()
    if route == "frozen":
        conv.requires_grad_(False)
    x.requires_grad_(route == "records")
    with torch.set_grad_enabled(route != "no_grad"):
        got = conv(x)
    want = torch.nn.functional.conv2d(x, conv.weight, conv.bias, 1, 6, 6)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    if route != "records":
        assert calls == [x.shape] and got.grad_fn is None
        return
    # cuDNN's route (F.conv2d) and its gradient, as a train step takes it
    assert calls == [] and "Convolution" in type(got.grad_fn).__name__
    g = torch.randn(got.shape, generator=gen, dtype=torch.float64)
    grads = torch.autograd.grad(got, (x, conv.weight, conv.bias), g)
    wants = torch.autograd.grad(want, (x, conv.weight, conv.bias), g)
    for a, b in zip(grads, wants):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("size,stride,padding", [
    (19, 2, "SAME"), (10, 2, "SAME"), (2, 2, "SAME"), (5, 1, "VALID"),
    (3, 1, "VALID")])
def test_extra_block_without_bn_matches(size, stride, padding):
    rng = np.random.default_rng(size)
    x = rng.normal(0, 1, (2, size, size, 16)).astype(np.float32)
    jmod = jlayers.ExtraFeatureBlock(8, 24, strides=(stride, stride),
                                     padding=padding, use_bn=False)
    variables = jmod.init(jax.random.key(0), jnp.asarray(x))
    variables = jax.tree_util.tree_map(
        lambda v: rng.normal(0, 0.3, v.shape).astype(np.float32), variables)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    tmod = tlayers.ExtraFeatureBlock(16, 8, 24, stride=stride,
                                     padding=padding, use_bn=False)
    convert.load_variables(tmod, variables)
    with torch.no_grad():
        got = _nhwc(tmod(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL_BLOCK)


# ---- the converter ---------------------------------------------------------

def test_converter_maps_gamma_and_refuses_unknown_leaves():
    state = convert.variables_to_state_dict(
        {"params": {"backbone": {"conv4_3_norm": {
            "gamma": np.full(512, 7.0, np.float32)}}}})
    assert list(state) == ["backbone.conv4_3_norm.gamma"]
    assert torch.equal(state["backbone.conv4_3_norm.gamma"],
                       torch.full((512,), 7.0))
    with pytest.raises(KeyError):
        convert.variables_to_state_dict(
            {"params": {"backbone": {"conv4_3_norm": {
                "beta": np.zeros(512, np.float32)}}}})


@pytest.mark.parametrize("backbone,fold,folded", [
    ("mobilenet_v2", False, False), ("mobilenet_v2", True, True),
    ("vgg16", False, True)])
def test_is_folded_reads_the_jax_trees(backbone, fold, folded):
    cfg = j_hyper(backbone)
    variables = j_init(j_model(cfg), jax.random.key(0))
    if fold:
        _, _, variables = j_fold(cfg, variables)
    tree = jax.tree_util.tree_map(np.asarray, dict(variables))
    assert convert.is_folded(tree) is folded


# ---- SSD512 whole, seeded JAX weights ---------------------------------------

def _jax_forward(cfg, variables, images):
    """(taps, deltas, logits) of the JAX model, as numpy."""
    model = j_model(cfg)

    def fwd(v, x):
        (deltas, logits), state = model.apply(
            v, j_pre(x), capture_intermediates=lambda m, _: isinstance(
                m, VGG16Backbone))
        return state["intermediates"]["backbone"]["__call__"][0], deltas, \
            logits

    taps, deltas, logits = jax.jit(fwd)(variables, jnp.asarray(images))
    return [np.asarray(t) for t in taps], np.asarray(deltas), \
        np.asarray(logits)


def _torch_forward(model, images):
    with torch.no_grad():
        taps = model.features(t_pre(torch.from_numpy(images)))
        deltas, logits = model.head(taps)
    return [_nhwc(t) for t in taps], deltas, logits


def test_ssd512_seeded_weights_match():
    jcfg, tcfg = j_hyper("vgg16_512"), t_hyper("vgg16_512")
    variables = jax.tree_util.tree_map(
        np.asarray, j_init(j_model(jcfg), jax.random.key(3)))
    assert "batch_stats" not in variables or not variables["batch_stats"]
    image = np.random.default_rng(5).integers(0, 256, (1, 512, 512, 3),
                                              dtype=np.uint8)
    j_taps, j_d, j_l = _jax_forward(jcfg, variables, image)
    model = convert.load_variables(t_model(tcfg), variables).eval()
    t_taps, t_d, t_l = _torch_forward(model, image)
    assert [t.shape[1] for t in t_taps] == [64, 32, 16, 8, 4, 2, 1]
    assert [t.shape[3] for t in t_taps] == [512, 1024, 512, 256, 256, 256,
                                            256]
    for k, (jt, tt) in enumerate(zip(j_taps, t_taps)):
        _close(tt, jt, what=f"tap {k}")
    assert t_d.shape == (1, 24564, 4) and t_l.shape == (1, 24564, 21)
    _close(t_d, j_d, what="deltas")
    _close(t_l, j_l, what="logits")


# ---- SSD300-VGG16, trained checkpoint ---------------------------------------

@pytest.fixture(scope="module")
def trained():
    """Restored variables (no batch_stats), as numpy, and the predictor's
    synthetic evaluation images in batches."""
    ckpt = CheckpointManager(CKPT)
    try:
        state = ckpt.restore_weights(
            TrainState(step=0, params=None, batch_stats=None,
                       opt_state=None), STEP)
    finally:
        ckpt.close()
    variables = {"params": jax.tree_util.tree_map(np.asarray, state.params)}
    assert not state.batch_stats
    ds = JSynth(128, image_size=300, seed=10_000)
    batches = list(j_batches((ds.example(i) for i in range(N_IMAGES)),
                             BATCH, 64))
    return variables, batches


@pytest.fixture(scope="module")
def jax_side(trained):
    """The JAX predictor's model (fold_for_serving passes VGG16 through):
    taps, (deltas, logits), NMSResult and mAP over the images."""
    variables, batches = trained
    cfg = j_hyper("vgg16")
    fcfg, _, fvars = j_fold(cfg, variables)
    assert fcfg == cfg
    anchors = jnp.asarray(generate_anchors(cfg))
    decode = jax.jit(lambda d, l: j_decode(anchors, d, l, fcfg))
    out, gts, dets = [], [], []
    for batch in batches:
        taps, deltas, logits = _jax_forward(fcfg, fvars, batch["image"])
        res = decode(jnp.asarray(deltas), jnp.asarray(logits))
        out.append({"taps": taps, "deltas": deltas, "logits": logits,
                    "nms": res})
        dets.extend(j_dets(res))
        gts.extend({"boxes": batch["boxes"][i], "labels": batch["labels"][i],
                    "difficult": batch["difficult"][i]}
                   for i in range(BATCH))
    m = j_eval(gts, dets, num_classes=20, verbose=False)["map"]
    return {"cfg": fcfg, "batches": out, "map": m, "gts": gts}


@pytest.fixture(scope="module")
def torch_side(trained):
    """The port's model on the same converted weights (CPU), through
    fold_for_serving as the serving CLI takes it."""
    variables, batches = trained
    cfg, model = t_fold(t_hyper("vgg16"), convert.load_variables(
        t_model(t_hyper("vgg16")), variables).eval())
    anchors = torch.from_numpy(t_anchors(cfg))
    out = []
    for batch in batches:
        taps, deltas, logits = _torch_forward(model, batch["image"])
        out.append({"taps": taps, "deltas": deltas, "logits": logits,
                    "nms": t_decode(anchors, deltas, logits, cfg)})
    return {"cfg": cfg, "anchors": anchors, "batches": out}


def test_trained_taps_and_outputs_match(jax_side, torch_side):
    for jb, tb in zip(jax_side["batches"], torch_side["batches"]):
        assert [t.shape[1] for t in tb["taps"]] == [38, 19, 10, 5, 3, 1]
        for k, (jt, tt) in enumerate(zip(jb["taps"], tb["taps"])):
            _close(tt, jt, what=f"tap {k}")
        assert tb["deltas"].shape == (BATCH, 8732, 4)
        assert tb["logits"].shape == (BATCH, 8732, 21)
        _close(tb["deltas"], jb["deltas"], what="deltas")
        _close(tb["logits"], jb["logits"], what="logits")


def test_trained_nms_from_the_same_outputs(jax_side, torch_side):
    for jb in jax_side["batches"]:
        got = t_decode(torch_side["anchors"], torch.tensor(jb["deltas"]),
                       torch.tensor(jb["logits"]), torch_side["cfg"])
        want = jb["nms"]
        np.testing.assert_array_equal(got.classes.numpy(),
                                      np.asarray(want.classes))
        np.testing.assert_array_equal(got.valid.numpy(),
                                      np.asarray(want.valid))
        np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                                   atol=ATOL_NMS)
        np.testing.assert_allclose(got.scores.numpy(),
                                   np.asarray(want.scores), atol=ATOL_NMS)


def test_trained_map_matches(jax_side, torch_side):
    dets = []
    for tb in torch_side["batches"]:
        dets.extend(t_dets(type(tb["nms"])(*(t.numpy() for t in tb["nms"]))))
    m = t_eval(jax_side["gts"], dets, num_classes=20, verbose=False)["map"]
    assert jax_side["map"] > 0.5  # the trained model really detects
    assert abs(m - jax_side["map"]) <= 1e-4, (m, jax_side["map"])


def test_predict_cli_serves_vgg16_npz_weights(trained, jax_side, tmp_path):
    variables, _ = trained
    path = tmp_path / "vgg16.npz"
    np.savez(path, **convert.flatten_tree(variables))
    run = tpredict.main(["--backbone", "vgg16", "--weights", str(path),
                         "--limit", str(N_IMAGES), "--batch-size",
                         str(BATCH), "--device", "cpu"])
    # A tree without batch_stats reads as folded (utils.convert.is_folded);
    # VGG16 has no BatchNorm and serves the same model either way.
    assert run.config.fold_bn
    assert dataclasses.asdict(dataclasses.replace(
        run.config, fold_bn=False)) == dataclasses.asdict(jax_side["cfg"])
    assert sum(run.num_valid) == N_IMAGES
    assert abs(run.mean_ap - jax_side["map"]) <= 1e-4


@pytest.mark.parametrize("backbone", ["vgg16", "vgg16_512"])
def test_fold_for_serving_passes_vgg_through(backbone):
    cfg = t_hyper(backbone)
    model = t_model(cfg).eval()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    fcfg, fmodel = t_fold(cfg, model)
    assert fcfg is cfg and fmodel is model
    after = fmodel.state_dict()
    assert before.keys() == after.keys()
    assert all(torch.equal(before[k], after[k]) for k in before)



@pytest.mark.parametrize("backbone", ["vgg16", "vgg16_512"])
def test_predict_refuses_a_cuda_run_without_a_card(backbone):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpredict.main(["--backbone", backbone, "--random-weights",
                       "--limit", "1"])


def test_seeded_weights_keep_the_l2norm_scale():
    from tfssd_torch.models.ssd import init_random_weights

    model = t_model(t_hyper("vgg16"))
    with torch.no_grad():
        model.backbone.conv4_3_norm.gamma.fill_(1.0)
        model.backbone.fc6.bias.fill_(1.0)
    init_random_weights(model, seed=0)
    assert torch.equal(model.backbone.conv4_3_norm.gamma,
                       torch.full((512,), 20.0))
    assert not model.backbone.fc6.bias.any()
    again = init_random_weights(t_model(t_hyper("vgg16")), seed=0)
    for (name, a), b in zip(model.state_dict().items(),
                            again.state_dict().values()):
        assert torch.equal(a, b), name
