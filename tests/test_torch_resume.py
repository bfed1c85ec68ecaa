"""Resuming the JAX trainer's orbax checkpoint in the port
(tfssd_torch/utils/checkpoint.py:OrbaxCheckpoints.restore_train_state and
.restore, tfssd_torch/trainer.py --resume) against the JAX package, on
the CPU, torch at 2 threads (a module fixture).

  * restore_train_state of both committed checkpoints
    (trained/ssd_mobilenet_v2/7680, trained/ssd_vgg16/4720): every leaf,
    optax Adam's count, mu and nu and the schedule's count included,
    bit-equal to tfssd_tpu's CheckpointManager.restore into a template
    built as trainer.py builds it (by jax.eval_shape: the restore reads
    only the template's structure, shapes and dtypes).
  * The port's TrainState after OrbaxCheckpoints.restore: the weights,
    the BatchNorm statistics, and torch Adam's exp_avg / exp_avg_sq equal
    to the checkpoint's params, batch_stats, mu and nu with their layouts
    changed (a kernel (H, W, I, O) -> (O, I, H, W), a depthwise (3, 3, 1,
    C) -> (C, 1, 3, 3)), bit for bit; Adam's step equal to optax's count.
  * One full-width MobileNetV2 train step from step 7680 (batch 2,
    augmentation off, float32) through the port and through the JAX
    package's make_train_step from the same checkpoint and batch. The
    loss terms are held by the one-step gate of
    tests/test_torch_train.py (1e-4 relative). The rest (grad_norm, the
    update, Adam's moments, BatchNorm's statistics) is held as
    tests/test_torch_multistep.py holds its steps: at batch 2 the 1x1
    maps' train-mode BatchNorm normalises over 2 values, and the float32
    step is ill-conditioned even at the trained weights. Measured on this
    input, the port's own float32 step lies from its float64 step, by
    thread count (1, 2, 4, 8): grad_norm 8.7e-5 to 9.0e-3, the update
    4.8e-3 to 1.6e-2 in relative norm and 1.25 to 4.99 lr in its largest
    element, mu 5.5e-3 to 3.5e-2; JAX's float32 step lies 1.6e-3, 3.3e-3,
    0.51 lr and 3.8e-3 from it. So JAX may lie no farther from the port's
    float64 step than the port's own float32 step does at 1, 2 or 4
    threads, and the port's float32 step is the one the trainer runs.
  * The CLI: --resume on a model directory holding the JAX step (the
    committed step directory linked in, the JAX run's sidecar copied)
    restores it, says so, trains from it and writes only under
    ssd_mobilenet_v2_torch; a second --resume takes the port's own
    checkpoint, and the two runs give the uninterrupted run's metrics and
    weights bit for bit; a changed geometry warns against the JAX
    sidecar; the JAX step directory and sidecar stay byte for byte.
  * A tree that is not optax.adam's, or whose counts disagree, or whose
    moments do not have params' shapes, raises.
"""

import hashlib
import os
import shutil
from collections.abc import Mapping

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from test_torch_predict_parity import MBV2_DIR, MBV2_STEP, TRAINED  # noqa: E402,E501
from test_torch_train_parity import adam_state, flat, np_tree, rel, sd  # noqa: E402,E501
from tfssd_torch import get_hyper_params as t_hyper  # noqa: E402
from tfssd_torch import train as ttrain  # noqa: E402
from tfssd_torch import trainer as ttrainer  # noqa: E402
from tfssd_torch.utils import convert  # noqa: E402
from tfssd_torch.utils.checkpoint import OrbaxCheckpoints  # noqa: E402
from tfssd_tpu import get_hyper_params as j_hyper  # noqa: E402
from tfssd_tpu import train as jtrain  # noqa: E402
from tfssd_tpu.data import SyntheticDataset, batch_examples  # noqa: E402
from tfssd_tpu.models import get_model as j_get_model  # noqa: E402
from tfssd_tpu.ops.boxes import generate_anchors  # noqa: E402
from tfssd_tpu.train import TrainState  # noqa: E402
from tfssd_tpu.utils.checkpoint import CheckpointManager  # noqa: E402

CHECKPOINTS = {"mobilenet_v2": (MBV2_DIR, MBV2_STEP),
               "vgg16": (os.path.join(TRAINED, "ssd_vgg16"), 4720)}
# The JAX run's sidecar (steps_per_epoch 2, batch_size 8, steps_per_call 1)
SIDECAR = os.path.join(TRAINED, "ssd_mobilenet_v2_meta.json")
LOSSES = ("loss", "loc_loss", "conf_loss")


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """torch at 2 threads for the module: the test runner's workers share
    the machine's cores, and full-width steps at a thread per core in
    each of them oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_restore(backbone, steps_per_epoch=2):
    """CheckpointManager.restore of the committed step into the template
    trainer.py builds (model, make_lr_schedule, make_optimizer,
    create_train_state) as jax Arrays."""
    directory, step = CHECKPOINTS[backbone]
    model = j_get_model(j_hyper(backbone))
    optimizer = jtrain.make_optimizer(
        jtrain.make_lr_schedule(steps_per_epoch))
    template = jax.eval_shape(lambda: jtrain.create_train_state(
        model, jax.random.key(0), optimizer))
    ckpt = CheckpointManager(directory)
    try:
        return ckpt.restore(template, step), model, optimizer
    finally:
        ckpt.close()


@pytest.fixture(scope="module")
def mbv2_jax():
    return _jax_restore("mobilenet_v2")


def _as_tree(state):
    """A JAX TrainState in restore_train_state's form, numpy leaves."""
    adam, schedule = state.opt_state
    return np_tree({"step": state.step, "params": state.params,
                    "batch_stats": state.batch_stats,
                    "opt_state": {"0": {"count": adam.count, "mu": adam.mu,
                                        "nu": adam.nu},
                                  "1": {"count": schedule.count}}})


def _leaves(tree, prefix=()):
    if isinstance(tree, Mapping):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, prefix + (k,)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("backbone", sorted(CHECKPOINTS))
def test_restore_train_state_bit_equal_to_checkpoint_manager(backbone,
                                                             mbv2_jax):
    directory, step = CHECKPOINTS[backbone]
    state = (mbv2_jax if backbone == "mobilenet_v2"
             else _jax_restore(backbone))[0]
    want = _leaves(_as_tree(state))
    got = _leaves(OrbaxCheckpoints(directory).restore_train_state(step))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        assert isinstance(g, np.ndarray), key
        assert g.dtype == w.dtype and g.shape == w.shape, key
        assert g.tobytes() == w.tobytes(), key
    counts = [int(got[k]) for k in (("step",), ("opt_state", "0", "count"),
                                    ("opt_state", "1", "count"))]
    assert counts == [step] * 3
    # 735 leaves in MobileNetV2's step (410 of them opt_state), 216 in
    # VGG16's (its batch_stats is an empty container)
    n_opt = sum(k[0] == "opt_state" for k in got)
    assert (len(got), n_opt) == {"mobilenet_v2": (735, 410),
                                 "vgg16": (216, 144)}[backbone]


def _torch_layout(tree):
    """{torch name: array} of a params-shaped numpy tree, the layout
    changed here independently of utils/convert.py."""
    out = {}
    for path, arr in _leaves(tree).items():
        *mods, leaf = path
        if leaf == "kernel":
            arr = np.ascontiguousarray(arr.transpose(3, 2, 0, 1))
        out[".".join(mods + [{"kernel": "weight", "scale": "weight"}.get(
            leaf, leaf)])] = arr
    return out


@pytest.mark.parametrize("backbone", sorted(CHECKPOINTS))
def test_restore_loads_weights_and_adam_state_bit_for_bit(backbone):
    directory, step = CHECKPOINTS[backbone]
    tree = OrbaxCheckpoints(directory).restore_train_state(step)
    state = ttrain.create_train_state(t_hyper(backbone), 1, "cpu",
                                      ttrain.make_lr_schedule(2))
    OrbaxCheckpoints(directory).restore(state, step)
    assert state.step == step
    adam = tree["opt_state"]["0"]
    want = {"param": _torch_layout(tree["params"]),
            "exp_avg": _torch_layout(adam["mu"]),
            "exp_avg_sq": _torch_layout(adam["nu"])}
    params = dict(state.model.named_parameters())
    assert sorted(params) == sorted(want["param"])
    for name, p in params.items():
        for key in ("exp_avg", "exp_avg_sq"):
            got = state.optimizer.state[p][key]
            assert got.dtype == torch.float32, (name, key)
            assert np.array_equal(got.numpy(), want[key][name]), (name, key)
        assert np.array_equal(p.detach().numpy(), want["param"][name]), name
        s = state.optimizer.state[p]["step"]
        assert s.device.type == "cpu" and float(s) == float(adam["count"])
    stats = {".".join(k[:-1]) + {"mean": ".running_mean",
                                 "var": ".running_var"}[k[-1]]: v
             for k, v in _leaves(tree["batch_stats"]).items()}
    buffers = dict(state.model.named_buffers())
    assert len(stats) == (120 if backbone == "mobilenet_v2" else 0)
    for name, v in stats.items():
        assert np.array_equal(buffers[name].numpy(), v), name


def _port_step(batch, anchors, dtype, threads):
    """The port's step (augmentation off) from the committed MobileNetV2
    step, restored by OrbaxCheckpoints, with the model and Adam in
    `dtype`, torch at `threads`: its metrics, update, moments and
    running statistics."""
    before_threads = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        cfg = t_hyper("mobilenet_v2")
        state = ttrain.create_train_state(cfg, 1, "cpu",
                                          ttrain.make_lr_schedule(2))
        OrbaxCheckpoints(MBV2_DIR).restore(state)
        if dtype != torch.float32:
            # a float64 twin: Adam's moments follow the parameters' dtype
            # when its state is loaded
            state.model.to(dtype)
            saved = state.optimizer.state_dict()
            state.optimizer = ttrain.make_optimizer(state.model)
            state.optimizer.load_state_dict(saved)
        params = dict(state.model.named_parameters())
        before = {n: q.detach().clone() for n, q in params.items()}
        step = ttrain.make_train_step(torch.from_numpy(anchors), cfg,
                                      augment=False)
        b = {k: torch.from_numpy(v) for k, v in batch.items()}
        b["image"] = (b["image"].float() / 255.0).to(dtype)
        metrics = {k: float(v) for k, v in step(state, b).items()}
        assert state.step == MBV2_STEP + 1
        return dict(
            metrics=metrics,
            update={n: (q.detach() - before[n]).double()
                    for n, q in params.items()},
            mu=adam_state(state, "exp_avg"),
            nu=adam_state(state, "exp_avg_sq"),
            stats={k: v for k, v in state.model.state_dict().items()
                   if "running_" in k})
    finally:
        torch.set_num_threads(before_threads)


def _distance(got, want, lr):
    """Distances of one step's results from another's: the loss terms' and
    grad_norm's relative errors, the update in relative norm and its
    largest element error in units of lr (the head's and the whole's), the
    moments in relative norm, the running statistics' largest error
    relative to 2e-3 |want| + 2e-4."""
    names = sorted(want["update"])
    head = [n for n in names if n.startswith("head.")]
    d = {k: abs(got["metrics"][k] / want["metrics"][k] - 1)
         for k in LOSSES + ("grad_norm",)}
    d["update"] = rel(flat(got["update"], names), flat(want["update"], names))
    d["update_head_lr"], d["update_lr"] = (
        max(float((got["update"][n] - want["update"][n]).abs().max())
            for n in group) / lr for group in (head, names))
    for key in ("mu", "nu"):
        d[key] = rel(flat(got[key], names), flat(want[key], names))
    d["stats"] = max(
        float(((got["stats"][k].double() - v.double()).abs()
               / (2e-3 * v.double().abs() + 2e-4)).max())
        for k, v in want["stats"].items())
    return d


def test_one_step_from_the_checkpoint_matches_jax(mbv2_jax):
    jstate, model, optimizer = mbv2_jax
    cfg = j_hyper("mobilenet_v2")
    ds = SyntheticDataset(num_examples=2, image_size=cfg.img_size, seed=3)
    batch = next(batch_examples(ds, 2, cfg.max_gt_boxes))
    batch = {k: batch[k] for k in ("image", "boxes", "labels")}
    anchors = generate_anchors(cfg)
    step = jax.jit(jtrain.make_train_step(model, anchors, optimizer,
                                          augment=False))
    new, jm = step(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                   jax.random.key(1))
    assert int(new.step) == MBV2_STEP + 1
    old, jnew = sd(np_tree(jstate.params)), sd(np_tree(new.params))
    stats = convert.variables_to_state_dict(
        {"batch_stats": np_tree(new.batch_stats)})
    jax_run = dict(
        metrics={k: float(v) for k, v in jm.items()},
        update={n: (jnew[n] - old[n]).double() for n in old},
        mu=sd(np_tree(new.opt_state[0].mu)),
        nu=sd(np_tree(new.opt_state[0].nu)),
        stats={k: v for k, v in stats.items() if "running_" in k})
    # the rate at count 7680 of 2 steps an epoch, past both boundaries:
    # 1e-5 (1e-3 * 0.1 * 0.1 in float32)
    lr = ttrain.make_lr_schedule(2)(MBV2_STEP)
    assert lr == float(jtrain.make_lr_schedule(2)(MBV2_STEP))
    assert lr == pytest.approx(1e-5, rel=1e-6)

    exact = _port_step(batch, anchors, torch.float64, 2)
    port = _port_step(batch, anchors, torch.float32, 2)
    assert port["metrics"]["num_pos"] == jax_run["metrics"]["num_pos"] > 0
    loss_gap = {k: abs(port["metrics"][k] / jax_run["metrics"][k] - 1)
                for k in LOSSES}
    assert all(v < 1e-4 for v in loss_gap.values()), loss_gap

    floors = [_distance(port if threads == 2 else
                        _port_step(batch, anchors, torch.float32, threads),
                        exact, lr) for threads in (1, 2, 4)]
    floor = {k: max(f[k] for f in floors) for k in floors[0]}
    d = _distance(jax_run, exact, lr)
    print(f"JAX's float32 step from the port's float64 one: {d}; the "
          f"port's float32 floor: {floor}")
    assert all(d[k] <= floor[k] for k in d), (d, floor)


def _tree_digest(*paths):
    """{file: sha256} of every file under `paths` (links followed)."""
    out = {}
    for top in paths:
        if os.path.isfile(top):
            files = [top]
        else:
            files = [os.path.join(d, f) for d, _, fs in
                     os.walk(top, followlinks=True) for f in fs]
        for f in files:
            with open(f, "rb") as fh:
                out[f] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _jax_model_dir(root):
    """A model directory holding the committed JAX step (linked) and the
    JAX run's sidecar (copied), as trainer.py --model-dir would find
    them."""
    jax_dir = root / "ssd_mobilenet_v2"
    jax_dir.mkdir(parents=True)
    os.symlink(os.path.abspath(os.path.join(MBV2_DIR, str(MBV2_STEP))),
               jax_dir / str(MBV2_STEP))
    shutil.copy(SIDECAR, root / "ssd_mobilenet_v2_meta.json")
    return root


def test_trainer_resumes_the_jax_checkpoint_and_then_its_own(tmp_path,
                                                             capsys):
    committed = _tree_digest(os.path.join(MBV2_DIR, str(MBV2_STEP)),
                             SIDECAR)
    # the sidecar's geometry: 2 steps an epoch at batch 8, so step 7680
    # starts epoch 3840
    def run(root, epochs, batch=8):
        return ttrainer.main([
            "--device", "cpu", "--batch-size", str(batch),
            "--steps-per-epoch", "2", "--synthetic-size", "16",
            "--val-limit", "1", "--log-every", "1", "--resume",
            "--epochs", str(epochs), "--model-dir", str(root),
            "--log-dir", str(tmp_path / "logs")])

    a = _jax_model_dir(tmp_path / "a")
    jax_files = _tree_digest(str(a / "ssd_mobilenet_v2"),
                             str(a / "ssd_mobilenet_v2_meta.json"))
    first = run(a, 3841)
    out = capsys.readouterr().out
    assert (f"resumed from step {MBV2_STEP} of the JAX package's "
            f"checkpoint {a / 'ssd_mobilenet_v2'}") in out
    assert "WARNING" not in out
    assert first.steps_run == 2 and first.state.step == MBV2_STEP + 2
    assert sorted(first.val_losses) == [3840]
    assert all(np.isfinite(m["loss"]) for m in first.step_metrics)
    assert sorted(os.listdir(a)) == [
        "ssd_mobilenet_v2", "ssd_mobilenet_v2_meta.json",
        "ssd_mobilenet_v2_torch", "ssd_mobilenet_v2_torch_meta.json"]
    assert sorted(os.listdir(a / "ssd_mobilenet_v2_torch")) == [
        "ckpt_7682.json", "ckpt_7682.pt"]
    assert os.listdir(a / "ssd_mobilenet_v2") == [str(MBV2_STEP)]

    second = run(a, 3842)
    out = capsys.readouterr().out
    assert f"resumed from step {MBV2_STEP + 2}\n" in out and "JAX" not in out
    assert second.steps_run == 2 and second.state.step == MBV2_STEP + 4
    assert _tree_digest(str(a / "ssd_mobilenet_v2"),
                        str(a / "ssd_mobilenet_v2_meta.json")) == jax_files

    # the uninterrupted run from the JAX step: the same steps, bit for bit
    whole = run(_jax_model_dir(tmp_path / "b"), 3842)
    assert whole.steps_run == 4
    assert whole.step_metrics == first.step_metrics + second.step_metrics
    for (name, x), y in zip(whole.state.model.state_dict().items(),
                            second.state.model.state_dict().values()):
        assert torch.equal(x, y), name

    # a changed geometry warns against the JAX run's sidecar (no step runs:
    # epoch 3840 is where the checkpoint starts)
    assert run(_jax_model_dir(tmp_path / "c"), 3840, batch=4).steps_run == 0
    out = capsys.readouterr().out
    assert "WARNING: resuming with changed schedule geometry" in out
    assert "'batch_size': 8" in out and "'batch_size': 4" in out
    assert _tree_digest(os.path.join(MBV2_DIR, str(MBV2_STEP)),
                        SIDECAR) == committed


def _save(directory, state):
    ckpt = CheckpointManager(str(directory))
    try:
        ckpt.save(int(state.step), state)
    finally:
        ckpt.close()
    return OrbaxCheckpoints(str(directory))


@pytest.mark.parametrize("fault", ["sgd", "adam_count", "schedule_count",
                                   "mu_shape"])
def test_a_tree_that_is_not_adams_or_disagrees_raises(tmp_path, fault):
    params = {"conv": {"kernel": np.ones((1, 1, 2, 3), np.float32),
                       "bias": np.zeros(3, np.float32)}}
    opt = (optax.sgd(1e-3, momentum=0.9) if fault == "sgd"
           else jtrain.make_optimizer(jtrain.make_lr_schedule(2)))
    opt_state = opt.init(params)
    if fault != "sgd":
        # step 3, and each count 3 but where the fault says otherwise
        adam, schedule = opt_state
        adam = adam._replace(count=jnp.asarray(
            4 if fault == "adam_count" else 3, jnp.int32))
        schedule = schedule._replace(count=jnp.asarray(
            2 if fault == "schedule_count" else 3, jnp.int32))
        if fault == "mu_shape":
            adam = adam._replace(mu={"conv": {"kernel": jnp.ones((3, 2)),
                                              "bias": jnp.zeros(3)}})
        opt_state = (adam, schedule)
    state = TrainState(step=jnp.asarray(3, jnp.int32), params=params,
                       batch_stats={}, opt_state=opt_state)
    ckpt = _save(tmp_path, state)
    match = {"sgd": "not optax.adam's chain", "mu_shape": "Adam's mu",
             "adam_count": "counts differ",
             "schedule_count": "counts differ"}[fault]
    with pytest.raises(ValueError, match=match):
        ckpt.restore_train_state()
    # the weights alone still read
    assert int(ckpt.restore_weights()["step"]) == 3
