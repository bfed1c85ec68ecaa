"""The port's custom operators and its exported predict (tfssd_torch.ops.
kernels, tfssd_torch.utils.export, predict --export) against the JAX
package's utils/export.py, on the CPU.

  * `torch.library.opcheck` on tfssd::nms_keep and tfssd::match_encode
    (schema, fake implementation, dispatch), and each op's CPU
    implementation is its plain version exactly.
  * The exported graph of each configuration holds one tfssd::nms_keep
    node and no unrolled greedy loop: at most GRAPH_NODES call nodes and
    no elementwise and/not (the plain version traced inline gave a
    1,105-node graph at B = 2, N = 2,268, C = 20, prefilter 512).
  * Each configuration at a small size (SMALL: 6 labels; MobileNetV2 at
    the dry run's tiny config, image 64 and feature maps (4, 2, 1, 1, 1,
    1). VGG16's channels are fixed, so its image is cut instead: to 260
    pixels, the smallest SSD300-VGG16 whose VALID extras still reach 1x1,
    6,766 anchors; SSD512 exists only at 512 pixels, its 24,564 anchors
    through the top-512 prefilter), random Flax weights carried over by
    utils/convert.py: JAX's load_exported(export_predict(...)) and the
    port's give the same NMSResult. float32: classes and valid equal,
    boxes and scores within ATOL_NMS = 1e-6 for MobileNetV2
    (tests/test_torch_serving.py's NMS tolerance; measured 6.0e-8 /
    3.0e-8 on an AVX512 CPU) and ATOL_NMS_VGG = 1e-5 for the VGG16
    configurations, whose random-weight forwards have no BatchNorm and
    sum up to 4,608 terms a convolution through 15 convolutions before
    the heads, rounded differently by oneDNN and XLA:CPU (measured: scores
    1.9e-6 / 1.8e-6 apart, boxes within 1e-6). bfloat16: two bfloat16
    convolutions round differently, and the junk tail below score 0.05
    reorders (MobileNetV2: valid 177 / 179 against 177 / 180 measured),
    so the detections are held by detection_agreement >= AGREEMENT, as
    tests/test_torch_bf16.py holds the bfloat16 serving path (measured
    1.0).
  * The artifact loaded in a fresh process that imports only
    tfssd_torch.ops.kernels and tfssd_torch.utils.export (no module of
    tfssd_torch.models) gives the eager result bit for bit.
  * `predict --export PATH --export-batch 2` through main() at full width
    (random weights, BatchNorm left unfolded): the artifact gives the
    eager unfolded model's NMSResult bit for bit.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tfssd_torch import get_hyper_params as t_hyper  # noqa: E402
from tfssd_torch import predict as tpredict  # noqa: E402
from tfssd_torch.evaluate import detection_agreement  # noqa: E402
from tfssd_torch.models.decoder import decode_predictions  # noqa: E402
from tfssd_torch.models.ssd import get_model as t_model  # noqa: E402
from tfssd_torch.ops import matching as tmatch  # noqa: E402
from tfssd_torch.ops.boxes import generate_anchors  # noqa: E402
from tfssd_torch.ops.kernels import match_encode as tmatch_op  # noqa: E402
from tfssd_torch.ops.kernels import nms_keep as tkeep  # noqa: E402
from tfssd_torch.ops.nms import NMSResult  # noqa: E402
from tfssd_torch.utils import export as texport  # noqa: E402
from tfssd_torch.utils.convert import flatten_tree, load_variables  # noqa: E402
from tfssd_tpu import get_hyper_params as j_hyper  # noqa: E402
from tfssd_tpu.models import get_model as j_model  # noqa: E402
from tfssd_tpu.models import init_model  # noqa: E402
from tfssd_tpu.utils import export as jexport  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
TINY = dict(img_size=64, feature_map_shapes=(4, 2, 1, 1, 1, 1),
            total_labels=6, max_gt_boxes=4)
SMALL = {"mobilenet_v2": TINY,
         "vgg16": dict(img_size=260, feature_map_shapes=(33, 17, 9, 5, 3, 1),
                       total_labels=6, max_gt_boxes=4),
         "vgg16_512": dict(total_labels=6, max_gt_boxes=4)}
BATCH = 2
ATOL_NMS = 1e-6
ATOL_NMS_VGG = 1e-5
AGREEMENT = 0.95
GRAPH_NODES = 600
THREADS = 2
LOOP_OPS = {"aten.bitwise_and.Tensor", "aten.bitwise_not.default",
            "aten.logical_and.default", "aten.logical_not.default"}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """torch at THREADS threads in this module and in its fresh process
    (a float32 forward's bits move with the thread count; the runner puts
    several workers on the cores), restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


def _boxes(rng, r, k):
    yx = rng.uniform(0, 0.8, (r, k, 2)).astype(np.float32)
    hw = rng.uniform(0.05, 0.3, (r, k, 2)).astype(np.float32)
    return torch.from_numpy(np.concatenate([yx, yx + hw], -1))


def test_nms_keep_op_passes_opcheck_and_is_the_plain_version():
    rng = np.random.default_rng(0)
    boxes = _boxes(rng, 3, 16)
    scores = torch.from_numpy(np.sort(rng.uniform(0, 1, (3, 16)).astype(
        np.float32))[:, ::-1].copy())
    torch.library.opcheck(torch.ops.tfssd.nms_keep.default,
                          (boxes, scores, 0.45, 0.1))
    before = tkeep.LAUNCHES
    got = torch.ops.tfssd.nms_keep(boxes, scores, 0.45, 0.1)
    assert torch.equal(got, tkeep.nms_keep_reference(boxes, scores, 0.45,
                                                     0.1))
    assert got.any() and not got.all()
    assert tkeep.LAUNCHES == before


@pytest.mark.parametrize("force", [False, True])
def test_match_encode_op_passes_opcheck_and_is_the_plain_version(force):
    cfg = t_hyper("mobilenet_v2", **TINY)
    anchors = torch.from_numpy(generate_anchors(cfg))
    rng = np.random.default_rng(1)
    boxes = _boxes(rng, BATCH, 4)
    labels = torch.from_numpy(np.array([[3, 1, 0, 0], [2, 0, 0, 0]],
                                       np.int32))
    args = (anchors, boxes, labels, 0.5, [0.1, 0.1, 0.2, 0.2], force)
    torch.library.opcheck(torch.ops.tfssd.match_encode.default, args)
    before = tmatch_op.LAUNCHES
    got = torch.ops.tfssd.match_encode(*args)
    want = tmatch.match_targets(anchors, boxes, labels, 0.5,
                                (0.1, 0.1, 0.2, 0.2), force)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (got[1] > 0).any()
    assert tmatch_op.LAUNCHES == before


@functools.lru_cache(maxsize=None)
def _variables(backbone):
    """Random Flax variables at SMALL (their values do not depend on the
    compute dtype: the parameters are float32)."""
    return init_model(j_model(j_hyper(backbone, **SMALL[backbone])),
                      jax.random.key(0))


def _pair(backbone, compute_dtype: str):
    """The JAX model and config, and the port's model with the variables
    carried over (utils/convert.py) and its config, at SMALL."""
    jcfg = j_hyper(backbone, compute_dtype=compute_dtype, **SMALL[backbone])
    tcfg = t_hyper(backbone, compute_dtype=compute_dtype, **SMALL[backbone])
    tree = flatten_tree(jax.tree_util.tree_map(np.asarray,
                                               _variables(backbone)))
    return jcfg, tcfg, j_model(jcfg), load_variables(t_model(tcfg),
                                                     tree).eval()


def _images(backbone="mobilenet_v2", seed=0):
    size = t_hyper(backbone, **SMALL[backbone]).img_size
    return np.random.default_rng(seed).uniform(
        -1, 1, (BATCH, size, size, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _float32_export(backbone):
    """(port model, config, artifact bytes) at SMALL in float32."""
    _, tcfg, _, tmodel = _pair(backbone, "float32")
    blob = texport.export_predict(tmodel, generate_anchors(tcfg), tcfg, BATCH)
    return tmodel, tcfg, blob


@pytest.fixture(scope="module")
def float32_export():
    return _float32_export("mobilenet_v2")


def _eager(model, cfg, x: np.ndarray) -> NMSResult:
    anchors = torch.from_numpy(generate_anchors(cfg))
    with torch.no_grad():
        deltas, logits = model(torch.from_numpy(x))
        return decode_predictions(anchors, deltas, logits, cfg)


@pytest.mark.parametrize("backbone", sorted(SMALL))
def test_export_graph_holds_one_nms_keep_node_and_no_unrolled_loop(
        backbone):
    import io

    program = torch.export.load(io.BytesIO(_float32_export(backbone)[2]))
    calls = [str(n.target) for n in program.graph.nodes
             if n.op == "call_function"]
    assert calls.count("tfssd.nms_keep.default") == 1
    assert not LOOP_OPS & set(calls), sorted(LOOP_OPS & set(calls))
    assert len(calls) <= GRAPH_NODES, len(calls)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backbone", sorted(SMALL))
def test_exported_predict_matches_jax_exported_predict(backbone,
                                                       compute_dtype):
    jcfg, tcfg, model, tmodel = _pair(backbone, compute_dtype)
    anchors = generate_anchors(jcfg)
    x = _images(backbone)
    jblob = jexport.export_predict(model, anchors, jcfg,
                                   _variables(backbone), BATCH,
                                   platforms=("cpu",))
    want = NMSResult(*(np.asarray(t) for t in
                       jexport.load_exported(jblob)(jnp.asarray(x))))
    blob = (_float32_export(backbone)[2] if compute_dtype == "float32" else
            texport.export_predict(tmodel, anchors, tcfg, BATCH))
    got = texport.load_exported(blob, "cpu")(torch.from_numpy(x))
    got = NMSResult(*(t.numpy() for t in got))
    if compute_dtype == "float32":
        np.testing.assert_array_equal(got.valid, want.valid)
        np.testing.assert_array_equal(got.classes, want.classes)
        atol = ATOL_NMS if backbone == "mobilenet_v2" else ATOL_NMS_VGG
        np.testing.assert_allclose(got.boxes, want.boxes, atol=atol)
        np.testing.assert_allclose(got.scores, want.scores, atol=atol)
    else:
        assert detection_agreement(got, want) >= AGREEMENT
    assert (got.scores[:, 0] >= 0.05).all()  # real detections compared


def test_artifact_serves_in_a_fresh_process_without_model_code(
        float32_export, tmp_path):
    tmodel, tcfg, blob = float32_export
    x = _images(seed=1)
    (tmp_path / "ssd.pt2").write_bytes(blob)
    np.save(tmp_path / "x.npy", x)
    code = (
        "import sys, numpy as np, torch\n"
        f"torch.set_num_threads({THREADS})\n"
        "import tfssd_torch.ops.kernels\n"
        "from tfssd_torch.utils.export import load_exported\n"
        "serve = load_exported(open(sys.argv[1], 'rb').read(), 'cpu')\n"
        "res = serve(torch.from_numpy(np.load(sys.argv[2])))\n"
        "np.savez(sys.argv[3], **{k: v.numpy() for k, v in "
        "res._asdict().items()})\n"
        "print(type(res).__name__, sorted(m for m in sys.modules if "
        "m.startswith('tfssd_torch.models')))\n")
    out = tmp_path / "res.npz"
    proc = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "ssd.pt2"),
         str(tmp_path / "x.npy"), str(out)], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == ["NMSResult", "[]"], proc.stdout
    got = np.load(out)
    want = _eager(tmodel, tcfg, x)
    for field in NMSResult._fields:
        np.testing.assert_array_equal(got[field],
                                      getattr(want, field).numpy(), field)


def test_predict_export_flag_writes_the_unfolded_predict(tmp_path, capsys):
    path = tmp_path / "mbv2.pt2"
    assert tpredict.main(["--export", str(path), "--export-batch", "2",
                          "--random-weights", "--device", "cpu"]) is None
    assert f"exported predict (batch 2, weights inside) to {path}" in \
        capsys.readouterr().out
    cfg, model = tpredict.load_model("mobilenet_v2", None, 0, "cpu",
                                     fold_bn=False)
    x = np.random.default_rng(2).uniform(
        -1, 1, (2, cfg.img_size, cfg.img_size, 3)).astype(np.float32)
    got = texport.load_exported(path.read_bytes(), "cpu")(
        torch.from_numpy(x))
    want = _eager(model, cfg, x)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
