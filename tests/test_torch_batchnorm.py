"""Train-mode BatchNorm over one value per channel (a 1x1 map at batch 1)
against Flax's nn.BatchNorm, in one layer, in the MobileNetV2 detector
and through the trainer's command line.

Flax normalises a single value with its own mean and variance
E[x^2] - E[x]^2 = 0, so the output is the bias, no gradient reaches the
input or the scale, and the running variance becomes momentum * running.
torch's F.batch_norm refuses that input in train mode; the port computes
Flax's formula itself there (models/layers.py: FlaxBatchNorm2d).

Tolerances: the single layer's output, statistics and gradients are
exact operations on the same float32 numbers (rtol 1e-6). The detector's
train forward at random weights normalises maps of 4 and 9 values, where
JAX's float32 rounding is amplified: the port's outputs lie 6.3e-5 to
7.0e-5 in relative norm from jitted JAX's in float32 and in float64 alike
(measured on two seeds), so they are held within 2e-4; its running
statistics within 3e-2 of each layer's largest + 1e-6 (measured 1.1e-2
to 1.3e-2: the variances of 4 values cancel, and some means are ~1e-10).
The layers that see one value per channel leave running_var = momentum *
running_var, bit for bit.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tfssd_torch import get_hyper_params as t_hyper  # noqa: E402
from tfssd_torch import trainer as ttrainer  # noqa: E402
from tfssd_torch.models.layers import FlaxBatchNorm2d  # noqa: E402
from tfssd_torch.models.ssd import get_model as t_get_model  # noqa: E402
from tfssd_torch.utils import convert  # noqa: E402
from tfssd_tpu import get_hyper_params as j_hyper  # noqa: E402
from tfssd_tpu.models import get_model as j_get_model  # noqa: E402

C = 6
FLAX_MOMENTUM = 0.99
EPS = 1e-3
TINY = dict(img_size=96, feature_map_shapes=(6, 3, 2, 1, 1, 1),
            total_labels=6, max_gt_boxes=8)


def _flax_layer(x, scale, bias, mean, var, cot):
    bn = nn.BatchNorm(use_running_average=False, momentum=FLAX_MOMENTUM,
                      epsilon=EPS)
    stats = {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}

    def loss(params, x):
        y, upd = bn.apply({"params": params, "batch_stats": stats}, x,
                          mutable=["batch_stats"])
        return (y * cot).sum(), (y, upd["batch_stats"])

    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    (_, (y, new)), (g_params, g_x) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    return {"y": y, "mean": new["mean"], "var": new["var"], "x": g_x,
            "scale": g_params["scale"], "bias": g_params["bias"]}


def _port_layer(x, scale, bias, mean, var, cot):
    bn = FlaxBatchNorm2d(C, eps=EPS, momentum=1.0 - FLAX_MOMENTUM)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    bn.train()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = bn(xt)
    (y * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    assert int(bn.num_batches_tracked) == 1
    nhwc = (lambda t: t.detach().permute(0, 2, 3, 1).numpy())
    return {"y": nhwc(y), "mean": bn.running_mean.numpy(),
            "var": bn.running_var.numpy(), "x": nhwc(xt.grad),
            "scale": bn.weight.grad.numpy(), "bias": bn.bias.grad.numpy()}


@pytest.mark.parametrize("seed", [0, 1])
def test_one_value_per_channel_matches_flax(seed):
    rng = np.random.default_rng(seed)
    f32 = (lambda *a: rng.normal(*a).astype(np.float32))
    args = (f32(0.5, 2.0, (1, 1, 1, C)), f32(1.0, 0.5, C), f32(0.0, 0.5, C),
            f32(0.0, 1.0, C), rng.uniform(0.5, 2.0, C).astype(np.float32),
            f32(0.0, 1.0, (1, 1, 1, C)))
    want, got = _flax_layer(*args), _port_layer(*args)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    # what Flax's formula gives at n = 1
    np.testing.assert_array_equal(got["y"].reshape(-1), args[2])
    assert not got["x"].any() and not got["scale"].any()


def test_mobilenet_v2_train_forward_at_batch_1_matches_jax():
    jcfg, tcfg = j_hyper("mobilenet_v2", **TINY), t_hyper("mobilenet_v2",
                                                          **TINY)
    images = np.random.default_rng(3).uniform(
        -1.0, 1.0, (1, 96, 96, 3)).astype(np.float32)
    jmodel = j_get_model(jcfg)
    variables = jax.jit(jmodel.init)(jax.random.key(0), jnp.asarray(images))
    (want_d, want_l), upd = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables,
                                                    jnp.asarray(images))
    tree = jax.tree_util.tree_map(np.asarray, dict(variables))
    model = convert.load_variables(t_get_model(tcfg), tree)
    model.train()
    got_d, got_l = model(torch.from_numpy(images))
    for got, want in ((got_d, want_d), (got_l, want_l)):
        got, want = got.detach().numpy(), np.asarray(want)
        assert np.isfinite(got).all() and got.shape == want.shape
        assert np.linalg.norm(got - want) <= 2e-4 * np.linalg.norm(want)
    want_state = convert.variables_to_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": variables["params"], **upd}))
    state = model.state_dict()
    stats = [k for k in want_state if k.endswith(("running_mean",
                                                  "running_var"))]
    assert len(stats) > 50
    for k in stats:
        want = want_state[k].numpy()
        np.testing.assert_allclose(state[k].numpy(), want, rtol=0,
                                   atol=3e-2 * np.abs(want).max() + 1e-6,
                                   err_msg=k)
    # the extra blocks' 1x1 maps: one value per channel, batch variance 0
    single = [k for k in stats if k.endswith("running_var")
              and (want_state[k].numpy() == np.float32(FLAX_MOMENTUM)).all()]
    assert single
    for k in single:
        assert torch.equal(state[k], want_state[k]), k


def test_trainer_trains_mobilenet_v2_at_batch_1(tmp_path):
    run = ttrainer.main([
        "--device", "cpu", "--batch-size", "1", "--epochs", "1",
        "--steps-per-epoch", "1", "--synthetic-size", "4", "--val-limit",
        "1", "--model-dir", str(tmp_path / "m"),
        "--log-dir", str(tmp_path / "l")])
    assert run.steps_run == 1 and run.val_batches == 1
    losses = [m["loss"] for m in run.train_metrics] + list(
        run.val_losses.values())
    assert losses and all(np.isfinite(x) for x in losses)
