"""Training parity of the port's SSD300-VGG16 (tfssd_torch.train, trainer,
checkpoint) with the JAX package, on the CPU.

  * L2Norm (conv4_3's norm) computes in float64 for a float64 input, so
    the float64 witness step stays float64 through it, and its float32
    output is bit for bit the float32 formula of the serving path;
  * one train step (augmentation off, batch 2) from a JAX TrainState
    carried across by utils/convert.py: the trained
    trained/ssd_vgg16/4720 params, seeded Adam moments at count 3;
  * the eval step's metrics;
  * a 2-epoch CPU run of `python -m tfssd_torch.trainer --backbone
    vgg16`, then --resume: checkpoints, retention of the 3 best, the
    schedule sidecar and the e2e metric's name.

Tolerances of the train step, each with its reason. The trained VGG16
has no BatchNorm and its gradient is well conditioned, so the float32
and float64 steps differ by rounding alone, at any thread count.
Measured on the CPU (1, 2, 4 and 8 torch threads, the largest):

  * semantics, the port's float64 step against JAX's float32 step:
    losses 6.5e-8 relative, grad_norm 5.2e-7, the head's gradient 3.4e-7
    and the whole 8.4e-7 in relative norm, Adam's update 3.4e-5 lr on
    the head's largest element, 9.5e-4 lr on the whole's (a float32
    parameter's ulp: new - old keeps no finer bit) and 2.1e-5 in
    relative norm, mu 3.8e-8, nu 3.0e-8. Gates, 20x-30x above:
    SEMANTICS_GATES.
  * the port's float32 path against its float64 step: losses 1.8e-7,
    grad_norm 3.9e-6, the head's gradient 5.3e-7 and the whole 9.9e-7,
    the update 3.0e-5 lr (head), 9.5e-4 lr (whole) and 1.9e-5, mu 2.6e-8,
    nu 3.0e-8. Gates: ROUNDING_GATES. The same step under bfloat16
    autocast fails them (losses 1.4e-4, the whole gradient 6.7e-2 off).

The MobileNetV2 gates (tests/test_torch_train.py) are looser by 10-1000x:
BatchNorm at random weights is what they allow for.
"""

import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tfssd_torch import get_hyper_params as t_hyper  # noqa: E402
from tfssd_torch import train as ttrain  # noqa: E402
from tfssd_torch import trainer as ttrainer  # noqa: E402
from tfssd_torch.models import layers as tlayers  # noqa: E402
from tfssd_torch.utils.checkpoint import CheckpointManager  # noqa: E402
from tfssd_tpu import get_hyper_params as j_hyper  # noqa: E402
from tfssd_tpu import train as jtrain  # noqa: E402
from tfssd_tpu.data import SyntheticDataset, batch_examples  # noqa: E402
from tfssd_tpu.train import TrainState  # noqa: E402
from tfssd_tpu.utils.checkpoint import CheckpointManager as JCkpt  # noqa: E402
from test_torch_train_parity import (LR, distance, eval_metrics,  # noqa: E402
                                     jax_reference, jax_step, np_tree,
                                     port_step, seeded_moments, trainer_args,
                                     vgg_threads)

CKPT = os.path.join(os.path.dirname(__file__), "..", "trained", "ssd_vgg16")
STEP = 4720
BATCH = 2

SEMANTICS_GATES = {"loss": 2e-6, "loc_loss": 2e-6, "conf_loss": 2e-6,
                   "grad_norm": 1e-5, "grads_head": 1e-5, "grads": 2e-5,
                   "update_head_lr": 1e-3, "update_lr": 2e-2,
                   "update": 5e-4, "mu": 1e-6, "nu": 1e-6}
ROUNDING_GATES = {"loss": 2e-6, "loc_loss": 2e-6, "conf_loss": 2e-6,
                  "grad_norm": 5e-5, "grads_head": 1e-5, "grads": 2e-5,
                  "update_head_lr": 1e-3, "update_lr": 2e-2,
                  "update": 5e-4, "mu": 1e-6, "nu": 1e-6}

pytestmark = pytest.mark.usefixtures("vgg_threads")


# ---- L2Norm in float64 -------------------------------------------------------

def _l2norm_numpy(x, gamma):
    norm = np.sqrt((x * x).sum(axis=1, keepdims=True) + 1e-10)
    return x / norm * gamma[None, :, None, None]


def test_l2norm_computes_in_float64_for_a_float64_input():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, (2, 16, 5, 5))
    x[0, :, 2, 3] = 0.0
    gamma = rng.uniform(5, 30, 16)
    mod = tlayers.L2Norm(16).double()
    mod.gamma.data = torch.from_numpy(gamma)
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    assert got.dtype == torch.float64
    # float64 throughout: a float32 pass would be ~1e-7 relative off
    np.testing.assert_allclose(got.numpy(), _l2norm_numpy(x, gamma),
                               rtol=1e-13, atol=0)
    assert np.all(got.numpy()[0, :, 2, 3] == 0.0)


def test_l2norm_float32_is_the_float32_formula_bit_for_bit():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(0, 3, (2, 16, 7, 7)).astype(np.float32))
    mod = tlayers.L2Norm(16)
    mod.gamma.data = torch.from_numpy(rng.uniform(5, 30, 16).astype(
        np.float32))
    with torch.no_grad():
        got = mod(x)
        xf = x.float()
        norm = torch.sqrt((xf * xf).sum(dim=1, keepdim=True) + 1e-10)
        want = (xf / norm * mod.gamma[:, None, None]).to(x.dtype)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


# ---- one train step from the trained checkpoint ------------------------------

@pytest.fixture(scope="module")
def vgg():
    """The JAX step from the trained SSD300-VGG16 with seeded Adam
    moments (count 3) on 2 synthetic images."""
    ckpt = JCkpt(CKPT)
    try:
        restored = ckpt.restore_weights(
            TrainState(step=0, params=None, batch_stats=None,
                       opt_state=None), STEP)
    finally:
        ckpt.close()
    params = np_tree(restored.params)
    jcfg, tcfg = j_hyper("vgg16"), t_hyper("vgg16")
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats={},
                       opt_state=jtrain.make_optimizer(LR).init(params))
    mu, nu = seeded_moments(params)
    ds = SyntheticDataset(num_examples=BATCH, image_size=300, seed=7)
    batch = next(batch_examples(ds, BATCH, jcfg.max_gt_boxes))
    batch = {k: batch[k] for k in ("image", "boxes", "labels")}
    return jax_reference(jcfg, tcfg, state, batch, mu, nu)


@pytest.fixture(scope="module")
def port_steps(vgg):
    return {dtype: port_step(vgg, dtype)
            for dtype in (torch.float64, torch.float32)}


def test_train_step_from_the_trained_jax_state_matches_jax(vgg, port_steps):
    got, want = port_steps[torch.float64], jax_step(vgg)
    assert got["metrics"]["num_pos"] == want["metrics"]["num_pos"] > 0
    assert not got["stats"] and not want["stats"]  # no BatchNorm
    d = distance(got, want)
    assert all(d[k] < v for k, v in SEMANTICS_GATES.items()), (
        d, SEMANTICS_GATES)


def test_train_step_in_float32_is_the_float64_step_rounded(port_steps):
    got, want = port_steps[torch.float32], port_steps[torch.float64]
    assert got["metrics"]["num_pos"] == want["metrics"]["num_pos"]
    d = distance(got, want)
    assert all(d[k] < v for k, v in ROUNDING_GATES.items()), (
        d, ROUNDING_GATES)


def test_eval_step_matches_jax(vgg):
    got, multi = eval_metrics(vgg)
    for k in ("loss", "loc_loss", "conf_loss", "num_pos"):
        np.testing.assert_allclose(got[k], vgg["eval_metrics"][k],
                                   rtol=1e-5, err_msg=k)
    assert multi.shape == (2,)
    np.testing.assert_allclose(multi.numpy(), got["loss"], rtol=1e-6)


# ---- the trainer ---------------------------------------------------------------

def test_trainer_cpu_run_saves_resumes_and_keeps_the_3_best(tmp_path,
                                                            capsys):
    common = trainer_args(tmp_path, "vgg16", BATCH) + [
        "--steps-per-epoch", "1"]
    first = ttrainer.main(["--epochs", "2"] + common)
    assert first.state.step == 2 and first.val_batches == 2
    assert all(np.isfinite(m["loss"]) for m in first.train_metrics)
    assert first.model_path.endswith("ssd_vgg16_torch")
    metric = [json.loads(line) for line in capsys.readouterr().out.split(
        "\n") if line.startswith("{")]
    assert [m["metric"] for m in metric] == [
        "train_vgg16_e2e_images_per_sec"]
    assert first.e2e_img_per_s is not None

    second = ttrainer.main(["--epochs", "4", "--resume"] + common)
    assert second.steps_run == 2 and second.state.step == 4
    assert sorted(second.val_losses) == [2, 3]
    ckpt = CheckpointManager(first.model_path)
    losses = {e + 1: v for run in (first, second)
              for e, v in run.val_losses.items()}
    assert sorted(ckpt.steps()) == sorted(
        sorted(losses, key=lambda s: (losses[s], -s))[:3])
    with open(first.model_path + "_meta.json") as f:
        assert json.load(f) == {"steps_per_epoch": 1, "batch_size": BATCH,
                                "steps_per_call": 1}

    # a VGG state (parameters and Adam; no buffers) restores exactly
    step = ckpt.best_step()
    state = ttrain.create_train_state(t_hyper("vgg16"), 1, "cpu",
                                      ttrain.make_lr_schedule(1))
    assert not list(state.model.buffers())
    ckpt.restore(state, step)
    saved = torch.load(os.path.join(first.model_path, f"ckpt_{step}.pt"),
                       weights_only=True)
    assert state.step == step
    for k, v in saved["model"].items():
        assert torch.equal(state.model.state_dict()[k], v), k
    assert state.optimizer.state_dict()["state"].keys() == saved[
        "optimizer"]["state"].keys()


def test_trainer_refuses_a_cuda_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrainer.main(["--backbone", "vgg16", "--epochs", "1",
                       "--model-dir", str(tmp_path)])

