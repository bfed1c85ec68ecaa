"""`--port-h5` in the port (tfssd_torch/utils/port_weights.py and both
CLIs) against Keras and the JAX package's utils/port_weights.py, on the
CPU.

One Keras MobileNetV2 (300, no top, its BatchNorm statistics and scales
seeded away from the identity) and one VGG16 trunk (300, no top, biases
seeded) are built once and saved by Keras as .h5 and .keras, and the
MobileNetV2 as a weights-only file (KERAS_BACKEND=jax where Keras is not
imported yet; a process that imported TensorFlow first, as a worker that
collected tests/test_port_weights.py did, has Keras on TensorFlow's
backend, which changes nothing here).

- load_keras_h5 of each file equals the JAX package's
  keras_model_weights(keras.models.load_model(path)) key for key (in
  order) and bit for bit; the port's port_mobilenet_v2 / port_vgg16 give
  the JAX package's trees.
- The JAX package's own port_h5_into_variables, unmodified, run with a
  stub `tensorflow` module whose .keras is Keras, grafts the committed
  checkpoint's variables; converted, its tree equals the port model's
  state after the port's graft bit for bit (every entry).
- Taps: the port's MobileNetV2 trunk against Keras's block_13_expand_relu
  and out_relu, and its VGG16 through conv3_3 against Keras's
  block3_conv3, within 2e-4 / 1e-3 (tests/test_port_weights.py's bar); the
  port's MobileNetV2 backbone against the Flax backbone on the same
  grafted weights, every tap, within test_torch_model.py's ATOL.
- graft raises KeyError for a tree of the other backbone and ValueError for
  a shape that differs, as the JAX package's graft does, and writes
  nothing then; a weights-only file is refused.
- predict's parser takes every option of predictor.py's with its default
  (--port-h5 among them), --dataset's apart (synthetic in the port).
- `predict --port-h5` over the committed checkpoint at --limit 8: the
  (deltas, logits) within 1e-4 of the JAX predictor's restore + port +
  fold path (test_torch_predict_cli.py's ATOL_MODEL) and the mAP within
  1e-4; with no checkpoint it serves the seeded heads.
- `trainer --port-h5` at batch 2 for one step: its state at step 0 has the
  JAX-ported trunk and the port's seeded heads, Adam steps the grafted
  parameters, the log directory's TensorBoard scalars equal the JSONL;
  with --resume and a checkpoint present the checkpoint wins.
"""

import json
import os
import sys
import types

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from test_torch_bf16 import AGREEMENT  # noqa: E402
from test_torch_model import ATOL  # noqa: E402
from test_torch_predict_cli import ATOL_MODEL  # noqa: E402
from tfssd_torch import get_hyper_params, predict, trainer  # noqa: E402
from tfssd_torch.evaluate import detection_agreement  # noqa: E402
from tfssd_torch.models.decoder import \
    decode_predictions as decode_predictions_t  # noqa: E402
from tfssd_torch.models.layers import same_max_pool2d  # noqa: E402
from tfssd_torch.models.ssd import (get_model,  # noqa: E402
                                    init_random_weights)
from tfssd_torch.ops.nms import NMSResult  # noqa: E402
from tfssd_torch.utils import port_weights as tpw  # noqa: E402
from tfssd_torch.utils.checkpoint import OrbaxCheckpoints  # noqa: E402
from tfssd_torch.utils.convert import (flatten_tree,  # noqa: E402
                                       load_variables,
                                       variables_to_state_dict)
from tfssd_torch.utils.tfevents import read_scalars  # noqa: E402
from tfssd_tpu.utils import port_weights as jpw  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
CHECKPOINTS = {"mobilenet_v2": (os.path.join(ROOT, "trained",
                                             "ssd_mobilenet_v2"), 7680),
               "vgg16": (os.path.join(ROOT, "trained", "ssd_vgg16"), 4720)}
# which saved format each backbone's JAX graft reads
GRAFT_FORMAT = {"mobilenet_v2": "h5", "vgg16": "keras"}
TAP_ATOL, TAP_RTOL = 2e-4, 1e-3
JAX_CONFIG = ("jax_platforms", "jax_enable_x64",
              "jax_default_matmul_precision", "jax_numpy_rank_promotion",
              "jax_default_prng_impl")


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_config():
    return {k: getattr(jax.config, k) for k in JAX_CONFIG}


def _seed_keras(model, rng):
    """Seeded BatchNorm scales, shifts and statistics and conv biases, so
    that no variable holds its initial constant."""
    for layer in model.layers:
        cls = type(layer).__name__
        if cls == "BatchNormalization":
            n = layer.weights[0].shape[0]
            layer.set_weights([rng.uniform(0.5, 1.5, n), rng.normal(0, .1, n),
                               rng.normal(0, .1, n),
                               rng.uniform(0.5, 1.5, n)])
        elif cls == "Conv2D" and layer.use_bias:
            kernel, bias = layer.get_weights()
            layer.set_weights([kernel, rng.normal(0, .1, bias.shape)])


@pytest.fixture(scope="module")
def keras_env(tmp_path_factory):
    os.environ.setdefault("KERAS_BACKEND", "jax")
    before = _jax_config()
    keras = pytest.importorskip("keras")
    after = _jax_config()
    out = tmp_path_factory.mktemp("keras")
    rng = np.random.default_rng(0)
    models = {"mobilenet_v2": keras.applications.MobileNetV2(
                  input_shape=(300, 300, 3), include_top=False, weights=None),
              "vgg16": keras.applications.VGG16(
                  input_shape=(300, 300, 3), include_top=False, weights=None)}
    paths = {}
    for name, model in models.items():
        _seed_keras(model, rng)
        for fmt in ("h5", "keras"):
            paths[name, fmt] = str(out / f"{name}.{fmt}")
            model.save(paths[name, fmt])
    weights_only = str(out / "mobilenet_v2.weights.h5")
    models["mobilenet_v2"].save_weights(weights_only)
    return types.SimpleNamespace(keras=keras, models=models, paths=paths,
                                 weights_only=weights_only,
                                 config=(before, after))


def test_importing_keras_leaves_the_jax_config(keras_env):
    before, after = keras_env.config
    assert after == before
    assert before["jax_platforms"] == "cpu" and not before["jax_enable_x64"]


@pytest.mark.parametrize("fmt", ["h5", "keras"])
@pytest.mark.parametrize("backbone", ["mobilenet_v2", "vgg16"])
def test_load_keras_h5_equals_keras_model_weights(keras_env, backbone, fmt):
    path = keras_env.paths[backbone, fmt]
    want = jpw.keras_model_weights(
        keras_env.keras.models.load_model(path, compile=False))
    got = tpw.load_keras_h5(path)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    porter = {"mobilenet_v2": (tpw.port_mobilenet_v2, jpw.port_mobilenet_v2),
              "vgg16": (tpw.port_vgg16, jpw.port_vgg16)}[backbone]
    tree, jtree = (flatten_tree(p(got)) for p in porter)
    assert list(tree) == list(jtree)
    assert all(np.array_equal(tree[k], jtree[k]) for k in jtree)


def _checkpoint(backbone):
    directory, step = CHECKPOINTS[backbone]
    tree = OrbaxCheckpoints(directory).restore_weights(step)
    return {k: tree[k] for k in ("params", "batch_stats")}


def _tensorflow_stub(keras_env):
    """A `tensorflow` module whose .keras is Keras, for the JAX package's
    load_keras_h5. Where TensorFlow is imported, Keras runs on its backend
    and imports from it while loading: every other name stays
    TensorFlow's."""
    stub = types.ModuleType("tensorflow")
    stub.keras = keras_env.keras
    real = sys.modules.get("tensorflow")
    if real is not None:
        stub.__getattr__ = lambda name: getattr(real, name)
    return stub


@pytest.fixture(scope="module")
def jax_grafted(keras_env):
    """The JAX package's port_h5_into_variables of each backbone's file over
    the committed checkpoint (numpy leaves), TensorFlow stubbed by Keras."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "tensorflow", _tensorflow_stub(keras_env))
        for backbone, fmt in GRAFT_FORMAT.items():
            variables = _checkpoint(backbone)
            tree = jpw.port_h5_into_variables(
                variables, backbone, keras_env.paths[backbone, fmt])
            out[backbone] = (variables,
                             jax.tree_util.tree_map(np.asarray, tree))
    return out


def _ported_model(backbone, path, variables):
    model = load_variables(get_model(get_hyper_params(backbone)), variables)
    return tpw.port_h5_into_variables(model, backbone, path).eval()


@pytest.mark.parametrize("backbone", ["mobilenet_v2", "vgg16"])
def test_grafted_state_equals_jax_port_h5_into_variables(
        keras_env, jax_grafted, backbone):
    variables, jtree = jax_grafted[backbone]
    model = _ported_model(
        backbone, keras_env.paths[backbone, GRAFT_FORMAT[backbone]],
        variables)
    want = variables_to_state_dict(jtree)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    # the graft changed the trunk and nothing else
    before = variables_to_state_dict(variables)
    changed = {k for k in want if not torch.equal(before[k], want[k])}
    assert changed and all(k.startswith("backbone.") for k in changed)


def _trunk_state(path):
    """The state_dict entries of the MobileNetV2 trunk of a Keras file."""
    tree = tpw.port_mobilenet_v2(tpw.load_keras_h5(path))
    return variables_to_state_dict({c: {"backbone": t}
                                    for c, t in tree.items()})


def _seeded_state():
    return init_random_weights(get_model(get_hyper_params("mobilenet_v2")),
                               0).state_dict()


def _taps(model, x):
    with torch.no_grad():
        return model.features(torch.from_numpy(x))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def test_taps_match_keras(keras_env, jax_grafted):
    x = np.random.default_rng(0).uniform(-1, 1, (1, 300, 300, 3)).astype(
        np.float32)
    keras = keras_env.keras
    mbv2 = keras_env.models["mobilenet_v2"]
    tap = keras.Model(mbv2.input, [mbv2.get_layer("block_13_expand_relu")
                                   .output, mbv2.output])
    want = [np.asarray(t) for t in tap(x)]
    model = _ported_model("mobilenet_v2",
                          keras_env.paths["mobilenet_v2", "keras"],
                          jax_grafted["mobilenet_v2"][0])
    got = _taps(model, x)
    for g, w in zip(got[:2], want):
        assert _nhwc(g).shape == w.shape
        np.testing.assert_allclose(_nhwc(g), w, atol=TAP_ATOL, rtol=TAP_RTOL)

    vgg = keras_env.models["vgg16"]
    want = np.asarray(keras.Model(vgg.input, vgg.get_layer(
        "block3_conv3").output)(x))
    model = _ported_model("vgg16", keras_env.paths["vgg16", "h5"],
                          jax_grafted["vgg16"][0])
    with torch.no_grad():
        y = torch.from_numpy(x).permute(0, 3, 1, 2)
        for g in (1, 2):
            y = same_max_pool2d(model.backbone._group(y, g), 2, 2)
        y = model.backbone._group(y, 3)
    assert _nhwc(y).shape == want.shape == (1, 75, 75, 256)
    np.testing.assert_allclose(_nhwc(y), want, atol=TAP_ATOL, rtol=TAP_RTOL)


def test_taps_match_flax(keras_env, jax_grafted):
    from tfssd_tpu.models.mobilenet_v2 import MobileNetV2Backbone

    variables, jtree = jax_grafted["mobilenet_v2"]
    x = np.random.default_rng(1).uniform(-1, 1, (1, 300, 300, 3)).astype(
        np.float32)
    want = MobileNetV2Backbone().apply(
        {c: jtree[c]["backbone"] for c in ("params", "batch_stats")},
        jnp.asarray(x), train=False)
    got = _taps(_ported_model(
        "mobilenet_v2", keras_env.paths["mobilenet_v2", "h5"], variables), x)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), atol=ATOL)


def test_graft_errors_as_jax_and_write_nothing(keras_env, jax_grafted):
    variables = jax_grafted["mobilenet_v2"][0]
    model = load_variables(get_model(get_hyper_params("mobilenet_v2")),
                           variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    vgg_tree = tpw.port_vgg16(tpw.load_keras_h5(
        keras_env.paths["vgg16", "h5"]))
    mbv2_tree = tpw.port_mobilenet_v2(tpw.load_keras_h5(
        keras_env.paths["mobilenet_v2", "h5"]))
    mbv2_tree["params"]["block16"]["project"]["conv"]["kernel"] = np.zeros(
        (1, 1, 960, 321), np.float32)
    for tree, error in ((vgg_tree, KeyError), (mbv2_tree, ValueError)):
        with pytest.raises(error):
            jpw.graft(variables, tree)
        with pytest.raises(error):
            tpw.graft(model, tree)
        after = model.state_dict()
        assert all(torch.equal(after[k], v) for k, v in before.items())


def test_weights_only_file_is_refused(keras_env):
    with pytest.raises(ValueError, match="model_config"):
        tpw.load_keras_h5(keras_env.weights_only)


def test_predict_parser_takes_every_jax_predictor_option():
    from test_torch_trainer_voc import _jax_options

    jax_opts = _jax_options("predictor.py")
    assert {"--port-h5", "--fold-bn", "--export", "-handle-gpu"} <= set(
        jax_opts)
    port = {s: a.default for a in predict.build_parser()._actions
            for s in a.option_strings}
    for opt, default in jax_opts.items():
        assert opt in port, opt
        if opt == "--dataset":
            assert default == "voc" and port[opt] == "synthetic"
        else:
            assert port[opt] == default, (opt, port[opt], default)


def test_predict_port_h5_matches_the_jax_predictor(keras_env, jax_grafted,
                                                   capsys, tmp_path):
    from tfssd_tpu import get_hyper_params as jax_params
    from tfssd_tpu.data.synthetic import SyntheticDataset
    from tfssd_tpu.models.decoder import decode_predictions
    from tfssd_tpu.ops.boxes import generate_anchors
    from tfssd_tpu.train import preprocess_images
    from tfssd_tpu.utils.fold_bn import fold_for_serving

    path = keras_env.paths["mobilenet_v2", "h5"]
    run = predict.main(["--device", "cpu", "--batch-size", "8", "--limit",
                        "8", "--port-h5", path])
    printed = capsys.readouterr().out
    assert "loaded checkpoint step 7680" in printed
    assert f"ported trunk weights from {path}" in printed
    assert run.config.fold_bn

    # the JAX predictor: restore, port, fold, predict
    cfg, model, variables = fold_for_serving(
        jax_params("mobilenet_v2"), jax_grafted["mobilenet_v2"][1])
    ds = SyntheticDataset(128, image_size=300, seed=10_000)
    images = np.stack([ds.example(i)["image"] for i in range(8)])
    assert np.array_equal(images, run.images[0])
    outs = [np.array(t) for t in jax.jit(lambda v, x: model.apply(
        v, preprocess_images(x), train=False))(variables,
                                               jnp.asarray(images))]
    for got, want in zip(run.outputs[0], outs):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL_MODEL)
    want = decode_predictions(jnp.asarray(generate_anchors(cfg)),
                              *map(jnp.asarray, outs), cfg)
    # The trained heads over a random trunk score junk boxes (mAP ~0.03)
    # whose scores tie to float32 noise: the order of tied boxes, and so
    # the mAP (0.0323 against 0.0276 measured on the same JAX outputs),
    # follows the softmax's last bits. The decode and NMS are held on the
    # JAX forward's own outputs, the served run by detection agreement,
    # the mAP on the trained trunk below, where it means something.
    mine = decode_predictions_t(torch.from_numpy(generate_anchors(cfg)),
                                *map(torch.from_numpy, outs), run.config)
    for name, g, w in zip(NMSResult._fields, mine, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   err_msg=name)
    assert detection_agreement(NMSResult(*(t.numpy() for t in
                                           run.results[0])),
                               NMSResult(*map(np.asarray, want))) \
        >= AGREEMENT

    # no checkpoint: the trunk from the file, the heads seeded
    run = predict.main(["--device", "cpu", "--batch-size", "2", "--limit",
                        "2", "--port-h5", path, "--model-dir",
                        str(tmp_path), "--no-fold-bn"])
    trunk = _trunk_state(path)
    seeded = _seeded_state()
    for k, v in run.model.state_dict().items():
        assert torch.equal(v, trunk[k] if k in trunk else seeded[k]), k


def _keras_file_of_the_checkpoint_trunk(keras_env, path):
    """A Keras-written .h5 of MobileNetV2 whose trunk is the committed
    checkpoint's (its Flax leaves mapped back to Keras's names through
    port_mobilenet_v2 itself, depthwise kernels transposed back)."""
    model = keras_env.keras.models.load_model(
        keras_env.paths["mobilenet_v2", "h5"], compile=False)
    names = jpw.keras_model_weights(model)
    # each Keras variable filled with its own index: where it lands in the
    # ported tree names it
    probe = {k: np.full(v.shape, i, np.float32)
             for i, (k, v) in enumerate(names.items())}
    ckpt = _checkpoint("mobilenet_v2")
    trunk = flatten_tree({c: ckpt[c]["backbone"] for c in ckpt})
    values = {}
    for leaf, marks in flatten_tree(tpw.port_mobilenet_v2(probe)).items():
        name = list(names)[int(marks.flat[0])]
        value = trunk[leaf]
        values[name] = (value.transpose(0, 1, 3, 2)
                        if "depthwise/" in name else value)
    assert sorted(values) == sorted(names)
    model.set_weights([values[k] for k in names])
    model.save(path)
    return path


def test_predict_port_h5_of_the_trained_trunk_serves_the_trained_map(
        keras_env, tmp_path, capsys):
    from test_torch_predict_parity import jax_map, jax_predictions
    from tfssd_tpu.data.synthetic import SyntheticDataset

    path = _keras_file_of_the_checkpoint_trunk(
        keras_env, str(tmp_path / "trained_trunk.h5"))
    ckpt = _checkpoint("mobilenet_v2")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "tensorflow", _tensorflow_stub(keras_env))
        grafted = jpw.port_h5_into_variables(ckpt, "mobilenet_v2", path)
    # the JAX package's port of the file writes the checkpoint's own trunk
    # back: its restore + port path is its restore path
    want_tree, got_tree = flatten_tree(ckpt), flatten_tree(
        jax.tree_util.tree_map(np.asarray, grafted))
    assert all(np.array_equal(got_tree[k], v) for k, v in want_tree.items())
    run = predict.main(["--device", "cpu", "--batch-size", "8", "--limit",
                        "8", "--port-h5", path])
    assert f"ported trunk weights from {path}" in capsys.readouterr().out
    ds = SyntheticDataset(128, image_size=300, seed=10_000)
    want = jax_map(jax_predictions([ds.example(i) for i in range(8)], 8))
    assert want > 0.5  # the trained model really detects
    assert abs(run.mean_ap - want) <= 1e-4, (run.mean_ap, want)


def test_trainer_port_h5_then_resume(keras_env, jax_grafted, tmp_path,
                                     monkeypatch, capsys):
    path = keras_env.paths["mobilenet_v2", "keras"]
    snapshots = []
    real = trainer.port_h5_into_variables

    def snapshot(model, backbone, h5):
        real(model, backbone, h5)
        snapshots.append({k: v.clone() for k, v in model.state_dict().items()})
        return model

    monkeypatch.setattr(trainer, "port_h5_into_variables", snapshot)
    argv = ["--device", "cpu", "--batch-size", "2", "--steps-per-epoch", "1",
            "--synthetic-size", "4", "--val-limit", "1", "--log-every", "1",
            "--epochs", "1", "--port-h5", path,
            "--model-dir", str(tmp_path / "m"), "--log-dir",
            str(tmp_path / "l")]
    run = trainer.main(argv)
    assert f"ported trunk weights from {path}; fine-tuning" in \
        capsys.readouterr().out
    start = snapshots[0]
    ported = _trunk_state(path)
    jax_state = variables_to_state_dict(jax_grafted["mobilenet_v2"][1])
    seeded = _seeded_state()
    for k, v in start.items():
        assert torch.equal(v, jax_state[k] if k in ported else seeded[k]), k
    assert run.steps_run == 1 and np.isfinite(run.step_metrics[0]["loss"])
    # Adam holds the grafted tensors: they moved, and its moments are theirs
    params = dict(run.state.model.named_parameters())
    opt_params = {id(p) for g in run.state.optimizer.param_groups
                  for p in g["params"]}
    assert {id(p) for p in params.values()} == opt_params
    moved = [k for k in params if k.startswith("backbone.block")
             and not torch.equal(params[k].detach(), start[k])]
    assert len(moved) > 100
    # the TensorBoard scalars equal the JSONL
    (log_dir,) = (tmp_path / "l" / "ssd_mobilenet_v2_torch").iterdir()
    (events,) = [f for f in os.listdir(log_dir) if "tfevents" in f]
    _, scalars = read_scalars(os.path.join(log_dir, events))
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        want = [(k, line["step"], float(np.float32(v)))
                for line in map(json.loads, f) for k, v in line.items()
                if k not in ("step", "time")]
    assert scalars == want

    # --resume finds the checkpoint of step 1: it wins over the file
    final = {k: v.clone() for k, v in run.state.model.state_dict().items()}
    snapshots.clear()
    resumed = trainer.main(argv + ["--resume"])
    assert len(snapshots) == 1 and resumed.steps_run == 0
    assert "resumed from step 1" in capsys.readouterr().out
    for k, v in resumed.state.model.state_dict().items():
        assert torch.equal(v, final[k]), k
