"""Training semantics of the port (tfssd_torch.train, trainer, checkpoint)
against the JAX package's train.py.

  * BatchNorm: the port's train-mode forward must leave running_mean and
    running_var equal to Flax's batch_stats (momentum from the config,
    the biased batch variance) within 1e-6 relative;
  * the LR schedule equals optax's at each boundary -1, 0 and +1;
  * one train step (augmentation off) from a JAX TrainState carried across
    by utils/convert.py, on the tiny config of tests/test_train.py;
  * the eval step's metrics;
  * a 2-epoch CPU run of the trainer with checkpoints, --resume, and
    retention of the 3 best.

Tolerances of the train step, each with its reason. At random weights a
BatchNorm network's float32 gradient is ill-conditioned: rounding
differences grow layer by layer from the loss towards the stem, and
train-mode BatchNorm on the 1x1 maps normalises over B = 4 values. The
port's float32 step moves with torch's thread count by more than JAX's
float32 step differs from the exact one (measured: loc_loss 2.4e-4 from
the float64 step at one thread, 1.3e-6 at eight). So the step is held in
two parts, each at any thread count:

  * semantics: the port's step in float64 (thread count changes it by
    1e-12) against JAX's float32 step, whose rounding sets the gates.
    Measured: losses within 1.6e-5 relative, grad_norm 5.9e-4, the head's
    gradient 1.2e-4 and the whole 1.3e-2 in relative norm, Adam's update
    7e-5 lr on the head's largest element, 0.08 lr on the whole's and
    2.1e-3 in relative norm, mu 3.1e-3, nu 1.6e-3. Gates: 1e-4, 1e-3,
    1e-3, 5e-2, 1e-3 lr, 0.25 lr, 1e-2, 1e-2, 1e-2; batch_stats within
    2e-3 relative + 2e-4. A port whose Adam does not step, steps at half
    the rate or uses beta2 0.99 fails them (eps does not matter here:
    nu >= 1e-3; the Adam test below catches eps 1e-6).
  * the port's own float32 path against its float64 step: rounding only.
    Measured at 1, 2, 4 and 8 threads, the largest: losses 2.4e-4,
    grad_norm 6.6e-3, the head's gradient 3.9e-4 and the whole 5.6e-2,
    the update 2.3e-4 lr (head), 0.26 lr (whole) and 9e-3, mu 1.4e-2, nu
    8.1e-3. Gates: 1e-3, 2e-2, 2e-3, 1.5e-1, 1e-3 lr, 0.6 lr, 3e-2, 5e-2,
    3e-2; batch_stats within 5e-2 relative + 1e-3 (the 1x1 maps' batch
    variance over 4 values cancels). The same step under bfloat16
    autocast fails them (the whole gradient 1.3 off).

Given JAX's own gradient, the port's Adam must give optax's update to
5e-5 relative (optax computes the bias correction 1 - 0.999^t in
float32, torch in float64: 1e-5 apart at t = 4) and its moments to 1e-6
relative or 2 ulp of the larger term.
"""

import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from tfssd_torch import get_hyper_params as t_hyper  # noqa: E402
from tfssd_torch import train as ttrain  # noqa: E402
from tfssd_torch import trainer as ttrainer  # noqa: E402
from tfssd_torch.models import layers as tlayers  # noqa: E402
from tfssd_torch.models.ssd import get_model as t_get_model  # noqa: E402
from tfssd_torch.utils import convert  # noqa: E402
from tfssd_torch.utils.checkpoint import CheckpointManager  # noqa: E402
from tfssd_tpu import get_hyper_params as j_hyper  # noqa: E402
from tfssd_tpu import train as jtrain  # noqa: E402
from tfssd_tpu.data import SyntheticDataset, batch_examples  # noqa: E402
from tfssd_tpu.models import get_model as j_get_model  # noqa: E402
from tfssd_tpu.models import layers as jlayers  # noqa: E402
from test_torch_train_parity import (LR, adam_state, distance,  # noqa: E402
                                     eval_metrics, jax_reference, jax_step,
                                     np_tree, port_state, port_step, sd,
                                     seeded_moments)

TINY = dict(img_size=96, feature_map_shapes=(6, 3, 2, 1, 1, 1),
            total_labels=6, max_gt_boxes=8, bn_momentum=0.8)


@pytest.mark.parametrize("shape", [(32, 1, 1, 8), (4, 5, 5, 8)])
def test_batchnorm_running_stats_match_flax(shape):
    # (32, 1, 1, C) is the 1x1 extra map at batch 32, where torch's
    # unbiased running variance would be 32/31 of Flax's.
    rng = np.random.default_rng(0)
    x = (rng.normal(0.5, 2.0, shape)).astype(np.float32)
    jmod = jlayers.ConvBN(8, (1, 1), bn_momentum=0.8)
    variables = jmod.init(jax.random.key(0), jnp.asarray(x))
    want, upd = jmod.apply(variables, jnp.asarray(x), train=True,
                           mutable=["batch_stats"])
    stats = np_tree(upd["batch_stats"]["bn"])

    tmod = tlayers.ConvBN(8, 8, 1, bn_momentum=0.8)
    convert.load_variables(tmod, np_tree(variables))
    tmod.train()
    got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(tmod.bn.running_mean.numpy(), stats["mean"],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tmod.bn.running_var.numpy(), stats["var"],
                               rtol=1e-6)
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-5)
    assert tmod.bn.momentum == pytest.approx(0.2)


def test_model_threads_bn_momentum_from_the_config():
    model = t_get_model(t_hyper("mobilenet_v2", bn_momentum=0.8))
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert bns and all(m.momentum == pytest.approx(0.2) for m in bns)
    default = t_get_model(t_hyper("mobilenet_v2"))
    assert all(m.momentum == pytest.approx(0.01) for m in default.modules()
               if isinstance(m, torch.nn.BatchNorm2d))


@pytest.mark.parametrize("steps_per_epoch", [1, 3, 10])
def test_lr_schedule_equals_optax_at_the_boundaries(steps_per_epoch):
    want = jtrain.make_lr_schedule(steps_per_epoch)
    got = ttrain.make_lr_schedule(steps_per_epoch)
    for b in (80, 110):
        for c in (b * steps_per_epoch - 1, b * steps_per_epoch,
                  b * steps_per_epoch + 1):
            assert got(c) == float(want(c)), c
    assert got(0) == float(want(0))
    for epoch in (0, 79, 80, 109, 110, 500):
        assert ttrain.scheduler(epoch) == jtrain.scheduler(epoch)
    assert ttrain.get_step_size(100, 32) == jtrain.get_step_size(100, 32)


@pytest.fixture(scope="module")
def tiny():
    """A JAX state with non-zero Adam moments (count 3), its batch, and
    the JAX step's loss, metrics, grads, updated params and batch_stats."""
    jcfg, tcfg = j_hyper("mobilenet_v2", **TINY), t_hyper("mobilenet_v2",
                                                          **TINY)
    model = j_get_model(jcfg)
    opt = jtrain.make_optimizer(LR)
    state = jtrain.create_train_state(model, jax.random.key(0), opt)
    mu, nu = seeded_moments(np_tree(state.params))
    ds = SyntheticDataset(num_examples=4, image_size=96, max_objects=2,
                          seed=7, num_classes=5)
    batch = next(batch_examples(ds, 4, jcfg.max_gt_boxes))
    batch = {k: batch[k] for k in ("image", "boxes", "labels")}
    return jax_reference(jcfg, tcfg, state, batch, mu, nu)


@pytest.fixture(scope="module")
def port_steps(tiny):
    return {dtype: port_step(tiny, dtype)
            for dtype in (torch.float64, torch.float32)}


def test_train_step_from_a_converted_jax_state_matches_jax(tiny, port_steps):
    # the converter carried Adam's moments across, transposed like kernels
    state = port_state(tiny)
    name = "backbone.stem.conv.weight"
    p = dict(state.model.named_parameters())[name]
    assert torch.equal(state.optimizer.state[p]["exp_avg"],
                       sd(tiny["mu"])[name])

    got, want = port_steps[torch.float64], jax_step(tiny)
    assert got["metrics"]["num_pos"] == want["metrics"]["num_pos"] > 0
    d = distance(got, want)
    gates = {"loss": 1e-4, "loc_loss": 1e-4, "conf_loss": 1e-4,
             "grad_norm": 1e-3, "grads_head": 1e-3, "grads": 5e-2,
             "update_head_lr": 1e-3, "update_lr": 0.25, "update": 1e-2,
             "mu": 1e-2, "nu": 1e-2}
    assert all(d[k] < v for k, v in gates.items()), (d, gates)
    for k, v in want["stats"].items():
        np.testing.assert_allclose(got["stats"][k].numpy(), v.numpy(),
                                   rtol=2e-3, atol=2e-4, err_msg=k)


def test_train_step_in_float32_is_the_float64_step_rounded(port_steps):
    # The port's own path (float32) against the same step in float64:
    # nothing but rounding, at any thread count.
    got, want = port_steps[torch.float32], port_steps[torch.float64]
    assert got["metrics"]["num_pos"] == want["metrics"]["num_pos"]
    d = distance(got, want)
    gates = {"loss": 1e-3, "loc_loss": 1e-3, "conf_loss": 1e-3,
             "grad_norm": 2e-2, "grads_head": 2e-3, "grads": 1.5e-1,
             "update_head_lr": 1e-3, "update_lr": 0.6, "update": 3e-2,
             "mu": 5e-2, "nu": 3e-2}
    assert all(d[k] < v for k, v in gates.items()), (d, gates)
    for k, v in want["stats"].items():
        np.testing.assert_allclose(got["stats"][k].double().numpy(),
                                   v.numpy(), rtol=5e-2, atol=1e-3,
                                   err_msg=k)


@pytest.mark.parametrize("count", [3, 80])
def test_adam_update_equals_optax_given_the_same_gradients(tiny, count):
    # JAX's gradient put into .grad: the port's Adam (rate from the
    # schedule at optax's count, betas, eps, bias correction) must give
    # optax's update. nu spans 1e-20..1e-2, so eps decides some elements;
    # at count 80 (one step per epoch) the rate has decayed to 1e-4.
    rng = np.random.default_rng(1)
    params = np_tree(tiny["state"].params)
    mu = jax.tree_util.tree_map(
        lambda p: rng.normal(0, 0.05, p.shape).astype(np.float32), params)
    nu = jax.tree_util.tree_map(
        lambda p: (10.0 ** rng.uniform(-20, -2, p.shape)).astype(np.float32),
        params)
    schedule = jtrain.make_lr_schedule(1)
    opt = jtrain.make_optimizer(schedule)
    adam, sched = opt.init(params)  # scale_by_adam, scale_by_schedule
    opt_state = (adam._replace(count=jnp.asarray(count, jnp.int32),
                               mu=jax.tree_util.tree_map(jnp.asarray, mu),
                               nu=jax.tree_util.tree_map(jnp.asarray, nu)),
                 sched._replace(count=jnp.asarray(count, jnp.int32)))
    updates, new_opt = opt.update(
        jax.tree_util.tree_map(jnp.asarray, tiny["grads"]), opt_state)
    want_u = sd(np_tree(updates))

    state = port_state(tiny, mu, nu, count, ttrain.make_lr_schedule(1))
    grads = sd(tiny["grads"])
    named = dict(state.model.named_parameters())
    before = {n: q.detach().clone() for n, q in named.items()}
    for n, q in named.items():
        q.grad = grads[n].clone()
    ttrain.apply_gradients(state)
    assert state.step == count + 1
    for n, q in named.items():
        got = (q.detach() - before[n]).numpy()
        # new - old loses the update's low bits to the parameter's ulp
        ulp = np.spacing(np.abs(before[n].numpy()))
        want = want_u[n].numpy()
        assert np.all(np.abs(got - want) <= 5e-5 * np.abs(want) + 2 * ulp), n
    # the moments to 1e-6 relative, or 2 ulp of the larger term where
    # b * m + (1 - b) * g cancels (torch lerps, optax multiplies and adds)
    terms = {"exp_avg": (mu, 0.9, lambda g: 0.1 * g),
             "exp_avg_sq": (nu, 0.999, lambda g: 1e-3 * g * g)}
    for key, want in (("exp_avg", new_opt[0].mu),
                      ("exp_avg_sq", new_opt[0].nu)):
        got, want = adam_state(state, key), sd(np_tree(want))
        old_m, b, term = terms[key]
        old_m = sd(old_m)
        for n in named:
            w, g = want[n].numpy(), grads[n].numpy()
            scale = np.maximum(b * np.abs(old_m[n].numpy()),
                               np.abs(term(g)))
            err = np.abs(got[n].numpy() - w)
            assert np.all(err <= 1e-6 * np.abs(w) + 2 * np.spacing(scale)), (
                key, n, float(err.max()))


def test_eval_step_matches_jax(tiny):
    got, multi = eval_metrics(tiny)
    want = tiny["eval_metrics"]
    for k in ("loss", "loc_loss", "conf_loss", "num_pos"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    # the cached multi-batch form: one row per batch, the same metrics
    assert multi.shape == (2,)
    np.testing.assert_allclose(multi.numpy(), got["loss"], rtol=1e-6)


def test_trainer_cpu_run_saves_resumes_and_keeps_the_3_best(tmp_path):
    common = ["--device", "cpu", "--batch-size", "2", "--synthetic-size",
              "8", "--steps-per-epoch", "2", "--val-limit", "1",
              "--log-every", "1", "--model-dir", str(tmp_path / "m"),
              "--log-dir", str(tmp_path / "l")]
    first = ttrainer.main(["--epochs", "2"] + common)
    assert first.state.step == 4 and first.steps_run == 4
    assert first.val_batches == 2 and sorted(first.val_losses) == [0, 1]
    assert all(np.isfinite(m["loss"]) for m in first.train_metrics)
    assert first.e2e_img_per_s is not None
    assert first.model_path.endswith("ssd_mobilenet_v2_torch")
    ckpt = CheckpointManager(first.model_path)
    assert ckpt.latest_step() == 4

    second = ttrainer.main(["--epochs", "5", "--resume"] + common)
    assert second.steps_run == 6 and second.state.step == 10
    assert sorted(second.val_losses) == [2, 3, 4]
    # five checkpoints were written (steps 2..10); the 3 best remain
    losses = {2 * (e + 1): v for run in (first, second)
              for e, v in run.val_losses.items()}
    best = sorted(losses, key=lambda s: (losses[s], -s))[:3]
    assert sorted(ckpt.steps()) == sorted(best)
    files = sorted(os.listdir(first.model_path))
    assert len([f for f in files if f.endswith(".pt")]) == 3
    with open(first.model_path + "_meta.json") as f:
        assert json.load(f)["steps_per_epoch"] == 2
    logs = list((tmp_path / "l").rglob("metrics.jsonl"))
    assert logs and all(json.loads(line)["step"] > 0
                        for p in logs for line in p.read_text().splitlines())

    # a restore gives back the saved model, optimizer and step exactly
    step = ckpt.best_step()
    state = ttrain.create_train_state(t_hyper("mobilenet_v2"), 1, "cpu",
                                      ttrain.make_lr_schedule(2))
    ckpt.restore(state, step)
    saved = torch.load(os.path.join(first.model_path, f"ckpt_{step}.pt"),
                       weights_only=True)
    assert state.step == step
    for k, v in saved["model"].items():
        assert torch.equal(state.model.state_dict()[k], v), k


def test_trainer_refuses_a_cuda_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrainer.main(["--epochs", "1", "--model-dir", str(tmp_path)])
