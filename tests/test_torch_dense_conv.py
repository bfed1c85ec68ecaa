"""tfssd::dense_conv, the ResNet trunks' groups-1 1x1 and 3x3 convs with
their bias, shortcut add and ReLU (ops/kernels/dense_conv.py), and its
dispatch in models/retinanet.py:ConvBN and Bottleneck, on the CPU:

  * the plain version against F.conv2d + bias + shortcut + ReLU at 1x1 and
    3x3, strides 1 and 2, with and without the shortcut and the ReLU, on
    the odd sides the cells' late stages have (25x34, 13x17, 25x25): to
    1e-12 of the scale in float64, within float32's round-off bound of a
    sum of K + 1 terms (K + 2 with the shortcut) in float32;
  * the operator's CPU implementation is the plain version and launches
    nothing; its fake implementation gives the shape; the operator and the
    kernel's wrapper raise on a grouped, 5x5 or mis-shaped weight, a
    shortcut of another shape, a dtype they do not take and a
    non-contiguous input;
  * the dispatch: the profiler counter conv/dense_kernel reads 52 a Mask
    R-CNN predict, 36 a RetinaNet predict (beside conv/grouped_kernel's 16)
    and 0 an SSD predict; a call autograd records, an unfolded conv, a
    dilated one, a channels-last input and a channels-last shortcut keep
    F.conv2d;
  * a bottleneck through the operator equals the same bottleneck through
    F.conv2d, its bias, add and ReLU; the folded Mask R-CNN and RetinaNet
    trunks, pyramids and heads in float64 equal their outputs through
    F.conv2d to 1e-12 of the scale;
  * on a card (cuda): the kernel against the plain version and F.conv2d
    within the float32 bound, bit-equal from run to run (each output one
    chain over K, no atomics).
"""

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

import test_torch_maskrcnn as tmask
import test_torch_retinanet as tretina
from portbench import data
from portbench.reference import maskrcnn as mask_ref
from portbench.reference import retinanet as retina_ref
from tfssd_torch import get_hyper_params
from tfssd_torch.models.decoder import make_predict_fn
from tfssd_torch.models.retinanet import Bottleneck, ConvBN
from tfssd_torch.models.ssd import get_model, init_random_weights
from tfssd_torch.ops.boxes import generate_anchors
from tfssd_torch.ops.kernels import dense_conv as dk
from tfssd_torch.utils import profiling

COUNTER = "conv/dense_kernel"
# (H, W) of the late stages the cells reach: Mask R-CNN's layer4 at
# 800x1088 (25x34) and its stride-2 conv's output of a 25x34 map (13x17),
# RetinaNet's layer4 at 800 (25x25); 8x8 for a plane whose size is a
# multiple of 4
SIDES = [(25, 34), (13, 17), (25, 25), (8, 8)]


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """torch at 2 threads: the test runner's workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def spans():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _inputs(k, hw, stride, shortcut, dtype=torch.float64, c=12, m=8, n=2,
            seed=0, device="cpu"):
    """x (n, c, H, W) of either sign, He-scaled (m, c, k, k) weights, a
    bias of either sign and, where asked, a shortcut of the output's
    shape."""
    gen = torch.Generator().manual_seed(seed)
    h, w = hw
    x = torch.randn(n, c, h, w, generator=gen, dtype=torch.float64)
    wt = torch.randn(m, c, k, k, generator=gen, dtype=torch.float64) * (
        2 / (c * k * k)) ** 0.5
    b = torch.randn(m, generator=gen, dtype=torch.float64) * 0.1
    r = torch.randn(n, m, dk.output_side(h, stride), dk.output_side(
        w, stride), generator=gen, dtype=torch.float64) if shortcut else None
    return tuple(None if t is None else t.to(dtype=dtype, device=device)
                 for t in (x, wt, b, r))


def _conv(x, w, b, r, stride, relu):
    """F.conv2d with the bias, then the shortcut, then the ReLU."""
    y = F.conv2d(x, w, b, stride, w.shape[-1] // 2)
    if r is not None:
        y = y + r
    return F.relu(y) if relu else y


def _mag(x, w, b, r, stride):
    """|x| * |w| + |b| + |r|: the sum of the terms' magnitudes."""
    return _conv(x.abs().double(), w.abs().double(), b.abs().double(),
                 None if r is None else r.abs().double(), stride, False)


def _bound(x, w, b, r, stride):
    """Each output's float32 round-off bound for two sums of the same
    K + 1 terms (K products and the bias; one more, the shortcut, where
    there is one) in any order: 2 (K + 1 [+ 1]) 2^-24 (|x| * |w| + |b|
    [+ |r|]), the ReLU moving neither."""
    k = w.shape[1] * w.shape[2] * w.shape[3]
    return 2 * (k + 1 + (r is not None)) * 2.0 ** -24 * _mag(x, w, b, r,
                                                             stride)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
@pytest.mark.parametrize("shortcut", [False, True], ids=["plain", "add"])
@pytest.mark.parametrize("hw", SIDES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", dk.SIDES)
def test_the_plain_version_equals_conv2d(k, stride, hw, shortcut, relu,
                                         dtype):
    x, w, b, r = _inputs(k, hw, stride, shortcut, dtype)
    got = dk.dense_conv_reference(x, w, b, r, stride, relu)
    want = _conv(x, w, b, r, stride, relu)
    ho, wo = (dk.output_side(s, stride) for s in hw)
    assert got.shape == want.shape == (2, 8, ho, wo)
    assert got.dtype == dtype
    err = (got.double() - want.double()).abs()
    if dtype == torch.float64:
        assert float(err.max()) <= 1e-12 * float(
            _mag(x, w, b, r, stride).max())
    else:
        bound = _bound(x, w, b, r, stride)
        assert bool((err <= bound).all()), float((err / bound).max())
    if relu:
        assert bool((got == 0).any()) and bool((got > 0).any())


def test_the_cpu_op_is_the_plain_version_and_launches_nothing():
    before = dk.LAUNCHES
    for k in dk.SIDES:
        for stride in dk.STRIDES:
            for shortcut in (False, True):
                x, w, b, r = _inputs(k, (13, 17), stride, shortcut,
                                     torch.float32)
                for relu in (False, True):
                    got = dk.dense_conv(x, w, b, r, stride, relu)
                    assert torch.equal(got, dk.dense_conv_reference(
                        x, w, b, r, stride, relu))
    assert dk.LAUNCHES == before


def test_the_fake_implementation_gives_the_shape_and_dtype():
    x, w, b, r = _inputs(3, (25, 34), 2, True, torch.float32)
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(t) for t in (x, w, b, r)]
        out = torch.ops.tfssd.dense_conv(*fake, 2, True)
    assert out.shape == (2, 8, 13, 17) and out.dtype == torch.float32


@pytest.mark.parametrize("case", [
    "not_4d", "grouped", "5x5", "1x3", "bias", "shortcut_shape", "stride",
    "dtype", "integer"])
def test_the_operator_rejects_what_the_kernel_does_not_take(case):
    x, w, b, r = _inputs(3, (9, 9), 1, True, torch.float32)
    args = dict(x=x, w=w, b=b, r=r, stride=1)
    error = ValueError
    if case == "not_4d":
        args["x"] = x[0]
    elif case == "grouped":            # a weight of C / 2 input channels
        args["w"] = w[:, :6].contiguous()
    elif case == "5x5":
        args["w"] = torch.zeros(8, 12, 5, 5)
    elif case == "1x3":
        args["w"] = w[..., :1, :].contiguous()
    elif case == "bias":
        args["b"] = b[:4]
    elif case == "shortcut_shape":     # the input's side at stride 2
        args["stride"] = 2
    elif case == "stride":
        args["stride"] = 3
    elif case == "dtype":
        args["w"], error = w.double(), TypeError
    else:
        args = {k: v.int() if torch.is_tensor(v) else v
                for k, v in args.items()}
        error = TypeError
    with pytest.raises(error):
        dk.dense_conv(args["x"], args["w"], args["b"], args["r"],
                      args["stride"], True)


@pytest.mark.parametrize("case", ["float64", "channels_last",
                                  "shortcut_channels_last", "cpu"])
def test_the_kernels_wrapper_takes_contiguous_float32_on_a_card(case):
    """dense_conv_cuda raises on what the kernel does not take and never
    falls back to the plain version."""
    x, w, b, r = _inputs(1, (8, 8), 1, True, torch.float32)
    if case == "float64":
        x, w, b, r = (t.double() for t in (x, w, b, r))
        error, match = TypeError, "float32"
    elif case == "channels_last":
        x = x.to(memory_format=torch.channels_last)
        error, match = ValueError, "contiguous"
    elif case == "shortcut_channels_last":
        r = r.to(memory_format=torch.channels_last)
        error, match = ValueError, "contiguous"
    else:
        error, match = ValueError, "CUDA"
    before = dk.LAUNCHES
    with pytest.raises(error, match=match):
        dk.dense_conv_cuda(x, w, b, r, 1, True)
    assert dk.LAUNCHES == before


def _counted(fn, *args):
    """(conv/dense_kernel's count, the output) of one call."""
    profiling.reset_spans()
    with _cpu_profile():
        y = fn(*args)
    n = profiling.span_summary()["counters"].get(COUNTER, 0)
    profiling.reset_spans()
    return n, y


def test_a_mask_rcnn_predict_runs_its_52_trunk_convs_in_the_op(spans):
    cfg, rcfg = tmask._cfgs(**tmask.SMALL)
    model = tmask._model(mask_ref.seeded_weights(rcfg, 4, "cpu"),
                         tmask.SMALL, fold_bn=True)
    predict = make_predict_fn(model, generate_anchors(cfg), cfg)
    n, res = _counted(predict, mask_ref.frames(rcfg, 1, 9))
    assert n == 3 * sum(cfg.stage_blocks) + len(cfg.stage_blocks) == 52
    assert res.valid.tolist() == [cfg.box_detections_per_img]


def test_a_retinanet_predict_runs_its_36_groups_one_convs_in_the_op(spans):
    overrides = dict(tretina.AT_128, groups=8, stem_channels=8,
                     stage_widths=(32, 64, 128, 256),
                     stage_channels=(16, 32, 64, 128), fpn_channels=16,
                     num_classes=7)
    cfg, rcfg = tretina._cfgs(**overrides)
    model = tretina._model(retina_ref.seeded_weights(rcfg, 5, "cpu"),
                           overrides, fold_bn=True)
    predict = make_predict_fn(model, generate_anchors(cfg), cfg)
    images = torch.from_numpy(data.synthetic(1, 128, 2)["image"])
    with _cpu_profile():
        predict(images)
    counters = profiling.span_summary()["counters"]
    assert counters[COUNTER] == 2 * sum(cfg.stage_blocks) + 4 == 36
    assert counters["conv/grouped_kernel"] == 16


@pytest.mark.parametrize("backbone", ["mobilenet_v2", "vgg16_512"])
def test_ssd_predicts_count_none(spans, backbone):
    small = dict(total_labels=6, max_gt_boxes=4)
    if backbone == "mobilenet_v2":
        small.update(img_size=64, feature_map_shapes=(4, 2, 1, 1, 1, 1))
    cfg = get_hyper_params(backbone, **small)
    model = init_random_weights(get_model(cfg), 0).eval()
    predict = make_predict_fn(model, generate_anchors(cfg), cfg)
    n, _ = _counted(predict, torch.zeros((1, cfg.img_size, cfg.img_size, 3),
                                         dtype=torch.uint8))
    assert n == 0


def _conv_bn(k=3, stride=1, fold_bn=True, act=True, seed=7):
    gen = torch.Generator().manual_seed(seed)
    m = ConvBN(16, 24, k, stride, fold_bn=fold_bn, act=act)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    return m.eval()


def _unfused(m, x, shortcut=None):
    """ConvBN's computation through F.conv2d: conv (+ BatchNorm), the
    shortcut, the ReLU."""
    y = m.conv(x)
    if m.bn is not None:
        y = m.bn(y)
    if shortcut is not None:
        y = y + shortcut
    return F.relu(y) if m.act else y


@pytest.mark.parametrize("grad,params,x_grad,want", [
    (True, True, False, 0),     # a train step's forward
    (True, False, True, 0),     # a gradient wanted of the input
    (True, False, False, 1),    # nothing requires a gradient
    (False, True, True, 1),     # under no_grad
])
def test_a_call_autograd_records_keeps_conv2d(spans, grad, params, x_grad,
                                              want):
    m = _conv_bn()
    m.requires_grad_(params)
    x = torch.randn(2, 16, 9, 9).requires_grad_(x_grad)
    with torch.set_grad_enabled(grad):
        n, y = _counted(m, x)
        plain = _unfused(m, x)
    assert n == want
    assert y.requires_grad == (grad and (params or x_grad))
    torch.testing.assert_close(y, plain, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", [
    "folded", "unfolded", "dilated", "channels_last",
    "shortcut_channels_last", "shortcut", "float64", "stride_2", "1x1",
    "7x7"])
def test_the_dispatch_follows_the_module_and_the_input(spans, case):
    k = {"1x1": 1, "7x7": 7}.get(case, 3)
    m = _conv_bn(k=k, stride=2 if case == "stride_2" else 1,
                 fold_bn=case != "unfolded")
    if case == "dilated":
        m.conv.dilation, m.conv.padding = (2, 2), (2, 2)
    x = torch.randn(2, 16, 10, 10)
    if case == "channels_last":
        x = x.to(memory_format=torch.channels_last)
    if case == "float64":
        m, x = m.double(), x.double()
    r = None
    if case.startswith("shortcut"):
        r = torch.randn(2, 24, 10, 10)
        if case == "shortcut_channels_last":
            r = r.to(memory_format=torch.channels_last)
    with torch.no_grad():
        n, y = _counted(m, x, r)
        want = _unfused(m, x, r)
    taken = case in ("folded", "shortcut", "float64", "stride_2", "1x1")
    assert n == (1 if taken else 0)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)


def _without_kernel(monkeypatch):
    """Every ConvBN through F.conv2d, its bias, add and ReLU, as before the
    kernel: the parent's computation."""
    monkeypatch.setattr(ConvBN, "_takes_dense_kernel",
                        lambda self, x, shortcut: False)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("stride,cin", [(1, 16), (1, 32), (2, 16)],
                         ids=["identity", "projection", "strided"])
def test_a_fused_bottleneck_equals_the_unfused_one(spans, monkeypatch,
                                                   stride, cin, dtype):
    gen = torch.Generator().manual_seed(3)
    block = Bottleneck(cin, 8, 32, stride, 1, fold_bn=True).eval()
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    block = block.to(dtype)
    x = torch.randn(2, cin, 13, 17, generator=gen).to(dtype)
    with torch.no_grad():
        n, got = _counted(block, x)
        with monkeypatch.context() as patch:
            _without_kernel(patch)
            m, want = _counted(block, x)
    assert (n, m) == (4 if cin != 32 or stride != 1 else 3, 0)
    scale = float(want.abs().max())
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert float((got - want).abs().max()) <= tol * scale
    assert bool((got == 0).any()) and bool((got > 0).any())


def _max_rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def test_the_folded_mask_rcnn_equals_its_unfused_outputs(spans,
                                                         monkeypatch):
    """The folded model in float64 (published widths at 120x150): the
    pyramid's maps and the RPN head's outputs through the operator within
    1e-12 of their scale of the same model through F.conv2d."""
    cfg, rcfg = tmask._cfgs(**tmask.AT_120)
    model = tmask._model(mask_ref.seeded_weights(rcfg, 2**31 + 7, "cpu"),
                         tmask.AT_120, fold_bn=True).double()
    x = torch.randn(1, *cfg.padded_size, 3, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        n, got = _counted(lambda t: model.rpn(model.features(t)), x)
        with monkeypatch.context() as patch:
            _without_kernel(patch)
            want = model.rpn(model.features(x))
    assert n == 52
    for g, w in zip(got, want):
        assert _max_rel(g, w) <= 1e-12


def test_the_folded_retinanet_equals_its_unfused_outputs(spans,
                                                         monkeypatch):
    """The folded model in float64 (published widths at 128 px): deltas and
    logits through the operator within 1e-12 of their scale of the same
    model through F.conv2d."""
    cfg, rcfg = tretina._cfgs(**tretina.AT_128)
    model = tretina._model(retina_ref.seeded_weights(rcfg, 2**31 + 7,
                                                     "cpu"),
                           tretina.AT_128, fold_bn=True).double()
    x = torch.randn(1, 128, 128, 3, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        n, got = _counted(model, x)
        with monkeypatch.context() as patch:
            _without_kernel(patch)
            want = model(x)
    assert n == 36
    for g, w in zip(got, want):
        assert _max_rel(g, w) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("shortcut", [False, True], ids=["plain", "add"])
@pytest.mark.parametrize("hw", [(25, 34), (13, 17), (24, 24)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("c", [13, 72])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", dk.SIDES)
def test_the_kernel_matches_the_plain_version_on_card(k, stride, c, hw,
                                                      shortcut):
    """C = 13 leaves a ragged K step at 1x1, M = 136 a ragged M tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    x, w, b, r = _inputs(k, hw, stride, shortcut, torch.float32, c=c,
                         m=136, n=3, device="cuda")
    before = dk.LAUNCHES
    got = dk.dense_conv_cuda(x, w, b, r, stride, True)
    torch.cuda.synchronize()
    assert dk.LAUNCHES == before + 1
    plain = dk.dense_conv_reference(x, w, b, r, stride, True)
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        conv = _conv(x, w, b, r, stride, True)
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    bound = _bound(x, w, b, r, stride).float()
    for want in (plain, conv):
        assert bool(((got - want).abs() <= bound).all())
    # one chain of FMAs over K an output, no atomics: the same bits
    assert torch.equal(got, dk.dense_conv_cuda(x, w, b, r, stride, True))
