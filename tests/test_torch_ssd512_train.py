"""Training parity of the port's SSD512-VGG16 (tfssd_torch.train, trainer,
checkpoint) with the JAX package, on the CPU, at the full 512 x 512 input
and 24,564 anchors.

  * one train step (augmentation off, batch 1) from a JAX TrainState
    carried across by utils/convert.py: the JAX package's seeded init
    (models.init_model, key 3), seeded Adam moments at count 3;
  * the eval step's metrics;
  * a 2-epoch CPU run of `python -m tfssd_torch.trainer --backbone
    vgg16_512`, then --resume: the checkpoint directory and schedule
    sidecar (<model-dir>/ssd_vgg16_512_torch_meta.json) and the e2e
    metric's name (train_ssd512_e2e_images_per_sec).

Tolerances of the train step, each with its reason. At random weights
SSD512 has no BatchNorm to hold its scales (its taps range from 4e-4 to
4.6, tests/test_torch_vgg16.py), so the rounding of a float32 step grows
from the head (8e-8) to the stem (the whole gradient 1e-4), but it does
not move with torch's thread count. Measured on the CPU (1, 2, 4 and 8
torch threads, the largest):

  * semantics, the port's float64 step against JAX's float32 step:
    losses 1.1e-7 relative, grad_norm 3.8e-6, the head's gradient 8.3e-8
    and the whole 1.5e-4 in relative norm, Adam's update 1.1e-5 lr on the
    head's largest element, 2.9e-3 lr on the whole's and 3.3e-5 in
    relative norm, mu 2.6e-5, nu 2.3e-6. Gates, ~20x-30x above:
    SEMANTICS_GATES.
  * the port's float32 path against its float64 step: losses equal,
    grad_norm 4.0e-5, the head's gradient 2.2e-7 and the whole 3.8e-5,
    the update 2.0e-6 lr (head), 9.5e-4 lr (whole, a float32 parameter's
    ulp) and 2.0e-5, mu 6.5e-6, nu 4.3e-7. Gates: ROUNDING_GATES. The same
    step under bfloat16 autocast fails them (losses 6.6e-4, the whole
    gradient 1.7e-2 off).
"""

import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tfssd_torch import get_hyper_params as t_hyper  # noqa: E402
from tfssd_torch import trainer as ttrainer  # noqa: E402
from tfssd_torch.utils.checkpoint import CheckpointManager  # noqa: E402
from tfssd_tpu import get_hyper_params as j_hyper  # noqa: E402
from tfssd_tpu import train as jtrain  # noqa: E402
from tfssd_tpu.data import SyntheticDataset, batch_examples  # noqa: E402
from tfssd_tpu.models import get_model as j_model  # noqa: E402
from tfssd_tpu.models import init_model as j_init  # noqa: E402
from tfssd_tpu.train import TrainState  # noqa: E402
from test_torch_train_parity import (LR, distance, eval_metrics,  # noqa: E402
                                     jax_reference, jax_step, np_tree,
                                     port_step, seeded_moments, trainer_args,
                                     vgg_threads)

SEMANTICS_GATES = {"loss": 2e-6, "loc_loss": 2e-6, "conf_loss": 2e-6,
                   "grad_norm": 1e-4, "grads_head": 2e-6, "grads": 3e-3,
                   "update_head_lr": 3e-4, "update_lr": 5e-2,
                   "update": 1e-3, "mu": 5e-4, "nu": 5e-5}
ROUNDING_GATES = {"loss": 2e-6, "loc_loss": 2e-6, "conf_loss": 2e-6,
                  "grad_norm": 1e-3, "grads_head": 5e-6, "grads": 1e-3,
                  "update_head_lr": 5e-5, "update_lr": 2e-2,
                  "update": 5e-4, "mu": 2e-4, "nu": 1e-5}

pytestmark = pytest.mark.usefixtures("vgg_threads")


@pytest.fixture(scope="module")
def ssd512():
    """The JAX step from the seeded SSD512 with seeded Adam moments
    (count 3) on one synthetic 512 x 512 image."""
    jcfg, tcfg = j_hyper("vgg16_512"), t_hyper("vgg16_512")
    assert jcfg.total_anchors == tcfg.total_anchors == 24564
    params = np_tree(j_init(j_model(jcfg), jax.random.key(3))["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats={},
                       opt_state=jtrain.make_optimizer(LR).init(params))
    mu, nu = seeded_moments(params)
    ds = SyntheticDataset(num_examples=1, image_size=512, seed=7)
    batch = next(batch_examples(ds, 1, jcfg.max_gt_boxes))
    batch = {k: batch[k] for k in ("image", "boxes", "labels")}
    return jax_reference(jcfg, tcfg, state, batch, mu, nu)


@pytest.fixture(scope="module")
def port_steps(ssd512):
    return {dtype: port_step(ssd512, dtype)
            for dtype in (torch.float64, torch.float32)}


def test_train_step_from_a_seeded_jax_state_matches_jax(ssd512, port_steps):
    got, want = port_steps[torch.float64], jax_step(ssd512)
    assert got["metrics"]["num_pos"] == want["metrics"]["num_pos"] > 0
    d = distance(got, want)
    assert all(d[k] < v for k, v in SEMANTICS_GATES.items()), (
        d, SEMANTICS_GATES)


def test_train_step_in_float32_is_the_float64_step_rounded(port_steps):
    got, want = port_steps[torch.float32], port_steps[torch.float64]
    assert got["metrics"]["num_pos"] == want["metrics"]["num_pos"]
    d = distance(got, want)
    assert all(d[k] < v for k, v in ROUNDING_GATES.items()), (
        d, ROUNDING_GATES)


def test_eval_step_matches_jax(ssd512):
    got, multi = eval_metrics(ssd512)
    for k in ("loss", "loc_loss", "conf_loss", "num_pos"):
        np.testing.assert_allclose(got[k], ssd512["eval_metrics"][k],
                                   rtol=1e-5, err_msg=k)
    assert multi.shape == (2,)
    np.testing.assert_allclose(multi.numpy(), got["loss"], rtol=1e-6)


def test_trainer_cpu_run_resumes_with_its_own_sidecar(tmp_path, capsys):
    common = trainer_args(tmp_path, "vgg16_512", 1) + [
        "--steps-per-epoch", "1"]
    first = ttrainer.main(["--epochs", "2"] + common)
    assert first.state.step == 2 and first.val_batches == 2
    assert all(np.isfinite(m["loss"]) for m in first.train_metrics)
    assert first.model_path == str(tmp_path / "m" / "ssd_vgg16_512_torch")
    metric = [json.loads(line) for line in capsys.readouterr().out.split(
        "\n") if line.startswith("{")]
    assert [m["metric"] for m in metric] == [
        "train_ssd512_e2e_images_per_sec"]
    sidecar = tmp_path / "m" / "ssd_vgg16_512_torch_meta.json"
    assert json.loads(sidecar.read_text()) == {
        "steps_per_epoch": 1, "batch_size": 1, "steps_per_call": 1}
    assert sorted(CheckpointManager(first.model_path).steps()) == [1, 2]

    second = ttrainer.main(["--epochs", "3", "--resume"] + common)
    assert second.steps_run == 1 and second.state.step == 3
    assert sorted(second.val_losses) == [2]
    assert CheckpointManager(first.model_path).latest_step() == 3
    assert sorted(os.listdir(tmp_path / "m")) == [
        "ssd_vgg16_512_torch", "ssd_vgg16_512_torch_meta.json"]
