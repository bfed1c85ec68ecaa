"""tfssd::grouped_conv3x3, RetinaNet's grouped 3x3 conv with its bias and
ReLU (ops/kernels/grouped_conv3x3.py), and its dispatch in
models/retinanet.py:ConvBN, on the CPU:

  * the plain version against F.conv2d + bias (+ ReLU) at group widths 4,
    8, 16 and 32, strides 1 and 2, even and odd sides (25 -> 13): to 1e-12
    of the scale in float64, within float32's round-off bound in float32;
  * the operator's CPU implementation is the plain version and launches
    nothing; its fake implementation gives the shape; the wrapper and the
    kernel's wrapper raise on a dtype, layout or shape they do not take;
  * a folded RetinaNet predict runs its 16 grouped convs through the
    operator (the profiler counter conv/grouped_kernel reads 16) at a
    preset whose stages have the kernel's four widths, and passes the
    benchmark's comparison; MobileNetV2 and SSD512 predicts read 0;
  * a call that autograd records, an unfolded conv, a group width the
    kernel does not take and a channels-last input keep F.conv2d;
  * on a card (cuda): the kernel against the plain version and F.conv2d.
"""

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from portbench import data
from portbench.reference import retinanet as ref
from test_torch_retinanet import AT_128, FILE_CFG, _cfgs, _model
from tfssd_torch import get_hyper_params
from tfssd_torch.models.decoder import make_predict_fn
from tfssd_torch.models.retinanet import ConvBN
from tfssd_torch.models.ssd import get_model, init_random_weights
from tfssd_torch.ops.boxes import generate_anchors
from tfssd_torch.ops.kernels import grouped_conv3x3 as gk
from tfssd_torch.utils import profiling

# 128 pixels, 8 groups: the stages' grouped convs have widths 4, 8, 16 and
# 32, as the published model's do at 32 groups
GROUPED = dict(AT_128, groups=8, stem_channels=8,
               stage_widths=(32, 64, 128, 256),
               stage_channels=(16, 32, 64, 128), fpn_channels=16,
               num_classes=7)
COUNTER = "conv/grouped_kernel"


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


def _inputs(cg, side, dtype=torch.float64, groups=3, n=2, seed=0):
    """x (n, groups*cg, side, side) of either sign, He-scaled weights and a
    bias of either sign."""
    gen = torch.Generator().manual_seed(seed)
    c = groups * cg
    x = torch.randn(n, c, side, side, generator=gen, dtype=torch.float64)
    w = torch.randn(c, cg, 3, 3, generator=gen, dtype=torch.float64) * (
        2 / (9 * cg)) ** 0.5
    b = torch.randn(c, generator=gen, dtype=torch.float64) * 0.1
    return tuple(t.to(dtype) for t in (x, w, b))


def _conv(x, w, b, stride, relu):
    y = F.conv2d(x, w, b, stride, 1, 1, x.shape[1] // w.shape[1])
    return F.relu(y) if relu else y


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
@pytest.mark.parametrize("side", [8, 25])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("cg", gk.WIDTHS)
def test_the_plain_version_equals_conv2d(cg, stride, side, relu, dtype):
    x, w, b = _inputs(cg, side, dtype)
    got = gk.grouped_conv3x3_reference(x, w, b, stride, relu)
    want = _conv(x, w, b, stride, relu)
    ho = (side - 1) // stride + 1
    assert got.shape == want.shape == (2, 3 * cg, ho, ho)
    assert got.dtype == dtype
    # |a| * |w| summed over the same products bounds each sum's rounding
    mag = _conv(x.abs(), w.abs(), b.abs(), stride, False).double()
    err = (got.double() - want.double()).abs()
    if dtype == torch.float64:
        assert float(err.max()) <= 1e-12 * float(mag.max())
    else:
        # two float32 sums of 9 * cg + 1 terms in any order: each within
        # (9 * cg + 1) * 2^-24 of the magnitude, so their difference
        # within twice that; the ReLU moves neither further
        bound = 2 * (9 * cg + 1) * 2.0 ** -24 * mag
        assert bool((err <= bound).all()), float((err / bound).max())


def test_the_cpu_op_is_the_plain_version_and_launches_nothing():
    x, w, b = _inputs(8, 13, torch.float32)
    before = gk.LAUNCHES
    for stride in (1, 2):
        for relu in (False, True):
            got = gk.grouped_conv3x3(x, w, b, stride, relu)
            want = gk.grouped_conv3x3_reference(x, w, b, stride, relu)
            assert torch.equal(got, want)
    assert gk.LAUNCHES == before
    assert bool((got == 0).any()) and bool((got > 0).any())


def test_the_fake_implementation_gives_the_shape_and_dtype():
    x, w, b = _inputs(4, 25, torch.float32)
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(t) for t in (x, w, b)]
        out = torch.ops.tfssd.grouped_conv3x3(*fake, 2, True)
    assert out.shape == (2, 12, 13, 13) and out.dtype == torch.float32


def test_the_inputs_are_checked():
    x, w, b = _inputs(4, 9, torch.float32)
    op = gk.grouped_conv3x3
    with pytest.raises(ValueError):
        op(x[0], w, b, 1, True)                       # not 4-D
    with pytest.raises(ValueError):
        op(x, w[:8], b, 1, True)                      # C out != C in
    with pytest.raises(ValueError):
        op(x, w[..., :1, :1].contiguous(), b, 1, True)  # 1x1
    with pytest.raises(ValueError):
        op(x[:, :10], w[:10], b[:10], 1, True)        # 4 does not divide 10
    with pytest.raises(ValueError):
        op(x, w, b[:4], 1, True)
    with pytest.raises(ValueError):
        op(x, w, b, 3, True)
    with pytest.raises(TypeError):
        op(x, w.double(), b, 1, True)
    with pytest.raises(TypeError):
        op(x.int(), w.int(), b.int(), 1, True)
    # the kernel's wrapper: float32, contiguous NCHW, the four widths, and
    # CUDA tensors only (it never falls back to the plain version)
    cuda = gk.grouped_conv3x3_cuda
    with pytest.raises(TypeError, match="float32"):
        cuda(x.double(), w.double(), b.double(), 1, True)
    with pytest.raises(ValueError, match="contiguous"):
        cuda(x.to(memory_format=torch.channels_last), w, b, 1, True)
    x2, w2, b2 = _inputs(2, 9, torch.float32)
    with pytest.raises(ValueError, match="group widths"):
        cuda(x2, w2, b2, 1, True)
    with pytest.raises(ValueError, match="CUDA"):
        cuda(x, w, b, 1, True)


def _grouped_predict(seed=4):
    """(cfg, rcfg, tree, the folded model's predict) at GROUPED with each
    level's top 300."""
    cfg, rcfg = _cfgs(**GROUPED, topk_candidates=300)
    tree = ref.seeded_weights(rcfg, seed, "cpu")
    model = _model(tree, dict(GROUPED, topk_candidates=300), fold_bn=True)
    return cfg, rcfg, tree, make_predict_fn(model, generate_anchors(cfg),
                                            cfg)


def test_a_retinanet_predict_runs_its_grouped_convs_in_the_op(spans):
    cfg, rcfg, tree, predict = _grouped_predict()
    images = torch.from_numpy(data.synthetic(2, 128, 9)["image"])
    widths = [w // cfg.groups for w in cfg.stage_widths]
    assert widths == list(gk.WIDTHS)
    with _cpu_profile():
        res = predict(images)
    assert profiling.span_summary()["counters"][COUNTER] == sum(
        cfg.stage_blocks) == 16
    assert bool((res.valid > 100).all())
    # the benchmark's comparison against the float64 reference
    t64 = {k: v.double() for k, v in tree.items()}
    with torch.no_grad():
        deltas, logits = ref.forward(rcfg, t64, ref.preprocess(
            rcfg, images, torch.float64))
    anchors = torch.from_numpy(ref.anchors(rcfg))
    numbers = ref.judge(rcfg, anchors, deltas, logits, tuple(res))
    limits = FILE_CFG["limits"]["serve_retinanet"]
    assert numbers["det_gap"] <= limits["det_gap"], numbers
    assert numbers["sel_gap"] <= limits["sel_gap"], numbers


def test_the_published_model_at_128_pixels_counts_16(spans):
    cfg, rcfg = _cfgs(**AT_128)
    model = _model(ref.seeded_weights(rcfg, 5, "cpu"), AT_128, fold_bn=True)
    images = torch.from_numpy(data.synthetic(1, 128, 2)["image"])
    predict = make_predict_fn(model, generate_anchors(cfg), cfg)
    with _cpu_profile():
        predict(images)
    assert profiling.span_summary()["counters"][COUNTER] == 16


@pytest.mark.parametrize("backbone", ["mobilenet_v2", "vgg16_512"])
def test_ssd_predicts_count_none(spans, backbone):
    small = dict(total_labels=6, max_gt_boxes=4)
    if backbone == "mobilenet_v2":
        small.update(img_size=64, feature_map_shapes=(4, 2, 1, 1, 1, 1))
    cfg = get_hyper_params(backbone, **small)
    model = init_random_weights(get_model(cfg), 0).eval()
    predict = make_predict_fn(model, generate_anchors(cfg), cfg)
    before = gk.LAUNCHES
    with _cpu_profile():
        predict(torch.zeros((1, cfg.img_size, cfg.img_size, 3),
                            dtype=torch.uint8))
    summary = profiling.span_summary()
    assert summary["spans"]["predict"]["calls"] == 1
    assert summary["counters"].get(COUNTER, 0) == 0
    assert gk.LAUNCHES == before


def _conv_bn(cg=4, stride=1, fold_bn=True, groups=8):
    gen = torch.Generator().manual_seed(7)
    m = ConvBN(groups * cg, groups * cg, 3, stride, groups, fold_bn=fold_bn)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    return m.eval()


def _counted(module, x):
    """(conv/grouped_kernel's count, the output) of one call."""
    profiling.reset_spans()
    with _cpu_profile():
        y = module(x)
    n = profiling.span_summary()["counters"].get(COUNTER, 0)
    profiling.reset_spans()
    return n, y


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
    x = torch.randn(2, 32, 9, 9).requires_grad_(x_grad)
    with torch.set_grad_enabled(grad):
        n, y = _counted(m, x)
        plain = F.relu(F.conv2d(x, m.conv.weight, m.conv.bias, 1, 1, 1, 8))
    assert n == want
    assert y.requires_grad == (grad and (params or x_grad))
    torch.testing.assert_close(y, plain, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["unfolded", "width_2", "channels_last",
                                  "float64", "stride_2"])
def test_the_dispatch_follows_the_module_and_the_input(spans, case):
    m = _conv_bn(cg=2 if case == "width_2" else 4,
                 stride=2 if case == "stride_2" else 1,
                 fold_bn=case != "unfolded")
    x = torch.randn(2, m.conv.in_channels, 10, 10)
    if case == "channels_last":
        x = x.to(memory_format=torch.channels_last)
    if case == "float64":
        m, x = m.double(), x.double()
    with torch.no_grad():
        n, y = _counted(m, x)
        want = m.conv(x)
        if m.bn is not None:
            want = m.bn(want)
        want = F.relu(want)
    # the plain version in float64 and at stride 2; F.conv2d elsewhere
    assert n == (1 if case in ("float64", "stride_2") else 0)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
@pytest.mark.parametrize("side", [25, 50])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("cg", gk.WIDTHS)
def test_the_kernel_matches_the_plain_version_on_card(cg, stride, side,
                                                      relu):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    x, w, b = (t.cuda() for t in _inputs(cg, side, torch.float32,
                                         groups=32, n=3))
    before = gk.LAUNCHES
    got = gk.grouped_conv3x3(x, w, b, stride, relu)
    torch.cuda.synchronize()
    assert gk.LAUNCHES == before + 1
    plain = gk.grouped_conv3x3_reference(x, w, b, stride, relu)
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        conv = _conv(x, w, b, stride, relu)
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    mag = _conv(x.abs(), w.abs(), b.abs(), stride, False)
    bound = 2 * (9 * cg + 1) * 2.0 ** -24 * mag
    for want in (plain, conv):
        assert bool(((got - want).abs() <= bound).all())
