"""Rematerialisation (SSDConfig.remat, trainer --remat) of the port against
its own plain step and against the JAX package's nn.remat, on the CPU.

- The port's remat train step from the same state and batch as its plain
  step, in float32 and in bfloat16: the same metrics, bit-equal gradients
  and parameters after Adam, the same BatchNorm running statistics, and
  every num_batches_tracked at 1. torch.utils.checkpoint runs each
  backbone stage's forward a second time in the backward; Flax updates
  batch_stats once, so the recompute must leave them alone (without that
  the statistics take a second momentum step and the counts read 2).
- Remat changes no parameter or buffer name (checkpoints move between the
  settings), for the three configurations.
- JAX's remat step (float32) against the port's remat step in float64,
  with tests/test_torch_train.py's gates for the plain step (the port's
  float64 step carries its semantics; JAX's float32 rounding sets them):
  losses 1e-4, grad_norm 1e-3, the head's gradient 1e-3 and the whole's
  5e-2, Adam's update and moments, batch_stats within 2e-3 relative +
  2e-4. Measured: the same as the plain step's (recompute in XLA and in
  torch is the same arithmetic).
- `python -m tfssd_torch.trainer --bf16 --remat` on the CPU at a tiny
  synthetic size, then --resume with the same flags.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

from tfssd_torch import get_hyper_params as t_hyper  # noqa: E402
from tfssd_torch import train as ttrain  # noqa: E402
from tfssd_torch import trainer as ttrainer  # noqa: E402
from tfssd_torch.models.ssd import get_model as t_get_model  # noqa: E402
from tfssd_torch.ops.boxes import generate_anchors  # noqa: E402
from tfssd_torch.utils.checkpoint import CheckpointManager  # noqa: E402
from tfssd_tpu import get_hyper_params as j_hyper  # noqa: E402
from tfssd_tpu import train as jtrain  # noqa: E402
from tfssd_tpu.data import SyntheticDataset, batch_examples  # noqa: E402
from tfssd_tpu.models import get_model as j_get_model  # noqa: E402
from test_torch_train_parity import (LR, distance, jax_reference,  # noqa: E402
                                     jax_step, np_tree, port_step,
                                     seeded_moments, trainer_args,
                                     vgg_threads)

# torch at two threads: the test runner puts several workers on the
# machine's cores, and torch's threads spin while JAX compiles beside them
# (the bfloat16 / remat steps ran 10x slower at one thread per core).
pytestmark = pytest.mark.usefixtures("vgg_threads")

TINY = dict(img_size=96, feature_map_shapes=(6, 3, 2, 1, 1, 1),
            total_labels=6, max_gt_boxes=8, bn_momentum=0.8)
TRAIN_GATES = {"loss": 1e-4, "loc_loss": 1e-4, "conf_loss": 1e-4,
               "grad_norm": 1e-3, "grads_head": 1e-3, "grads": 5e-2,
               "update_head_lr": 1e-3, "update_lr": 0.25, "update": 1e-2,
               "mu": 1e-2, "nu": 1e-2}


def _batch(cfg, n=4):
    ds = SyntheticDataset(num_examples=n, image_size=cfg.img_size,
                          max_objects=2, seed=7, num_classes=5)
    batch = next(batch_examples(ds, n, cfg.max_gt_boxes))
    return {k: torch.from_numpy(batch[k]) for k in ("image", "boxes",
                                                     "labels")}


def _step(cfg, batch):
    """One train step (augmentation off) from seeded weights: metrics,
    the model's state_dict and parameter gradients after it."""
    state = ttrain.create_train_state(cfg, 0, "cpu",
                                      ttrain.make_lr_schedule(10))
    step = ttrain.make_train_step(torch.from_numpy(generate_anchors(cfg)),
                                  cfg, augment=False)
    metrics = step(state, dict(batch))
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.clone() for k, v in state.model.state_dict().items()},
            {n: p.grad.clone() for n, p in state.model.named_parameters()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_step_equals_the_plain_step(dtype):
    cfgs = [t_hyper("mobilenet_v2", compute_dtype=dtype, remat=r, **TINY)
            for r in (False, True)]
    batch = _batch(cfgs[0])
    (m0, s0, g0), (m1, s1, g1) = (_step(c, batch) for c in cfgs)
    assert m0 == m1
    assert s0.keys() == s1.keys() and g0.keys() == g1.keys()
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    for key in s0:  # parameters after Adam, running statistics, counts
        assert torch.equal(s0[key], s1[key]), key
    counts = [v for k, v in s1.items() if k.endswith("num_batches_tracked")]
    assert counts and all(int(c) == 1 for c in counts)


@pytest.mark.parametrize("backbone", ["mobilenet_v2", "vgg16", "vgg16_512"])
def test_remat_keeps_the_state_dict_keys(backbone):
    plain = t_get_model(t_hyper(backbone)).state_dict()
    remat = t_get_model(t_hyper(backbone, remat=True,
                                compute_dtype="bfloat16")).state_dict()
    assert list(plain) == list(remat)
    assert all(plain[k].shape == remat[k].shape
               and remat[k].dtype == plain[k].dtype for k in plain)


@pytest.fixture(scope="module")
def jax_remat():
    jcfg = j_hyper("mobilenet_v2", remat=True, **TINY)
    tcfg = t_hyper("mobilenet_v2", remat=True, **TINY)
    state = jtrain.create_train_state(j_get_model(jcfg), jax.random.key(0),
                                      jtrain.make_optimizer(LR))
    mu, nu = seeded_moments(np_tree(state.params))
    batch = {k: v.numpy() for k, v in _batch(jcfg).items()}
    return jax_reference(jcfg, tcfg, state, batch, mu, nu, with_eval=False)


def test_jax_remat_step_matches_the_port_remat_step(jax_remat):
    got, want = port_step(jax_remat, torch.float64), jax_step(jax_remat)
    assert got["metrics"]["num_pos"] == want["metrics"]["num_pos"] > 0
    d = distance(got, want)
    assert all(d[k] < v for k, v in TRAIN_GATES.items()), (d, TRAIN_GATES)
    for k, v in want["stats"].items():
        np.testing.assert_allclose(got["stats"][k].numpy(), v.numpy(),
                                   rtol=2e-3, atol=2e-4, err_msg=k)


def test_trainer_bf16_remat_cpu_run_and_resume(tmp_path, capsys):
    common = trainer_args(tmp_path, "mobilenet_v2", 2) + [
        "--bf16", "--remat", "--steps-per-epoch", "2"]
    first = ttrainer.main(["--epochs", "2"] + common)
    cfg = first.state.model.config
    assert cfg.compute_dtype == "bfloat16" and cfg.remat
    assert first.steps_run == 4 and first.state.step == 4
    assert all(np.isfinite(m["loss"]) for m in first.train_metrics)
    assert all(np.isfinite(v) for v in first.val_losses.values())
    assert all(p.dtype == torch.float32
               for p in first.state.model.parameters())
    assert first.model_path.endswith("ssd_mobilenet_v2_torch")
    out = capsys.readouterr().out
    assert "compute_dtype=bfloat16 remat=True" in out
    assert "bfloat16, remat" in out
    assert CheckpointManager(first.model_path).latest_step() == 4
    plain_keys = list(t_get_model(t_hyper("mobilenet_v2")).state_dict())
    saved = torch.load(f"{first.model_path}/ckpt_4.pt", weights_only=True)
    assert list(saved["model"]) == plain_keys

    second = ttrainer.main(["--epochs", "3", "--resume"] + common)
    assert second.steps_run == 2 and second.state.step == 6
    assert all(np.isfinite(m["loss"]) for m in second.train_metrics)
