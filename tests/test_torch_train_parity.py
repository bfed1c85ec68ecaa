"""Shared parts of the train-step parity tests (tests/test_torch_train.py,
test_torch_vgg16_train.py and test_torch_ssd512_train.py): the JAX step's
results from a TrainState with Adam moments set, the port's step from the
same state carried across by utils/convert.py, and the distances between
two steps' results. It holds no test of its own.
"""

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from tfssd_torch import train as ttrain  # noqa: E402
from tfssd_torch.models.ssd import get_model as t_get_model  # noqa: E402
from tfssd_torch.utils import convert  # noqa: E402
from tfssd_tpu import train as jtrain  # noqa: E402
from tfssd_tpu.models import get_model as j_get_model  # noqa: E402
from tfssd_tpu.ops.boxes import generate_anchors  # noqa: E402
from tfssd_tpu.ops.losses import ssd_losses as j_ssd_losses  # noqa: E402
from tfssd_tpu.ops.matching import match_batch as j_match_batch  # noqa: E402

LR = 1e-3

# Torch threads of the VGG train-step files. The test runner puts several
# workers on the machine's cores; a full-width VGG step with a thread per
# core in each of them oversubscribes the cores (and spins), so every
# worker slows. The steps' results do not depend on the thread count
# (measured at 1, 2, 4 and 8; the files' docstrings).
VGG_THREADS = 2


@pytest.fixture(scope="module")
def vgg_threads():
    """torch at VGG_THREADS threads for one module, restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(VGG_THREADS)
    yield
    torch.set_num_threads(before)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def seeded_moments(params, seed: int = 0):
    """Adam moments for `params` (numpy trees): mu ~ N(0, 0.05), nu ~
    U(1e-3, 1e-2), drawn from one numpy generator."""
    rng = np.random.default_rng(seed)
    mu = jax.tree_util.tree_map(
        lambda p: rng.normal(0, 0.05, p.shape).astype(np.float32), params)
    nu = jax.tree_util.tree_map(
        lambda p: rng.uniform(1e-3, 1e-2, p.shape).astype(np.float32),
        params)
    return mu, nu


def jax_reference(jcfg, tcfg, state, batch, mu, nu, count: int = 3,
                  with_eval: bool = True):
    """The JAX train step (augmentation off) and eval step from `state`
    with Adam's moments `mu`, `nu` at `count`: a dict of the inputs and the
    step's loss metrics, gradients, updated params, batch_stats, moments,
    grad_norm and the eval step's metrics (None without `with_eval`), as
    numpy."""
    model = j_get_model(jcfg)
    anchors = generate_anchors(jcfg)
    opt = jtrain.make_optimizer(LR)
    adam = state.opt_state[0]._replace(
        count=jnp.asarray(count, jnp.int32),
        mu=jax.tree_util.tree_map(jnp.asarray, mu),
        nu=jax.tree_util.tree_map(jnp.asarray, nu))
    opt_state = (adam,) + tuple(state.opt_state[1:])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    # the JAX train step's loss_fn and update, for augment=False
    def loss_fn(params):
        images = jb["image"].astype(jnp.float32) / 255.0 * 2.0 - 1.0
        deltas, labels = j_match_batch(jnp.asarray(anchors), jb["boxes"],
                                       jb["labels"], jcfg)
        (pd, pl), upd = model.apply(
            {"params": params, "batch_stats": state.batch_stats}, images,
            train=True, mutable=["batch_stats"])
        total, metrics = j_ssd_losses(deltas, labels, pd, pl,
                                      jcfg.neg_pos_ratio,
                                      jcfg.loc_loss_alpha)
        return total, (metrics, upd.get("batch_stats", {}))

    # The batch is a constant of the step, as the port's images (/ 255 and
    # the match) are computed exactly; the eval step takes the state as an
    # argument, so XLA does not fold a whole forward into constants.
    @jax.jit
    def step(params, opt_state):
        (_, (metrics, stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, new_opt = opt.update(grads, opt_state, params)
        return (metrics, grads, optax.apply_updates(params, updates), stats,
                optax.global_norm(grads), new_opt[0])

    metrics, grads, new_params, stats, gnorm, adam = step(state.params,
                                                          opt_state)
    eval_metrics = (jax.jit(jtrain.make_eval_step(model, anchors))(state, jb)
                    if with_eval else {})
    return dict(tcfg=tcfg, anchors=anchors, state=state, mu=mu, nu=nu,
                count=count, batch=batch,
                metrics={k: float(v) for k, v in metrics.items()},
                grads=np_tree(grads), params=np_tree(new_params),
                stats=np_tree(stats), new_mu=np_tree(adam.mu),
                new_nu=np_tree(adam.nu), grad_norm=float(gnorm),
                eval_metrics={k: float(v) for k, v in eval_metrics.items()})


def port_state(t, mu=None, nu=None, count=None, schedule=lambda c: LR,
               dtype=torch.float32):
    """The port's TrainState from jax_reference's state, moments and count
    (or the ones given), its model in `dtype`."""
    count = t["count"] if count is None else count
    model = t_get_model(t["tcfg"]).to(dtype)
    opt = ttrain.make_optimizer(model, LR)
    convert.load_train_state(
        model, opt, {"params": np_tree(t["state"].params),
                     "batch_stats": np_tree(t["state"].batch_stats)},
        t["mu"] if mu is None else mu, t["nu"] if nu is None else nu, count)
    return ttrain.TrainState(count, model, opt, schedule)


def rel(a, b):
    return float((a - b).norm() / b.norm())


def sd(tree):
    """A params-shaped numpy tree as the port's state-dict tensors."""
    return convert.variables_to_state_dict({"params": tree})


def flat(d, names):
    return torch.cat([d[n].reshape(-1).double() for n in names])


def adam_state(state, key):
    params = dict(state.model.named_parameters())
    return {n: state.optimizer.state[p][key] for n, p in params.items()}


def port_step(t, dtype):
    """The port's train step (augmentation off) from the converted JAX
    state with the model, Adam and the images in `dtype` (the images
    scaled by /255 in float32 first, as the step does): its metrics,
    gradients, update (new minus old parameters), Adam's moments and
    running statistics after the step."""
    state = port_state(t, dtype=dtype)
    step = ttrain.make_train_step(torch.from_numpy(t["anchors"]), t["tcfg"],
                                  augment=False)
    batch = {k: torch.from_numpy(v) for k, v in t["batch"].items()}
    batch["image"] = (batch["image"].float() / 255.0).to(dtype)
    params = dict(state.model.named_parameters())
    before = {n: q.detach().clone() for n, q in params.items()}
    metrics = step(state, batch)
    assert state.step == t["count"] + 1
    return dict(
        metrics={k: float(v) for k, v in metrics.items()},
        grads={n: q.grad for n, q in params.items()},
        update={n: q.detach() - before[n] for n, q in params.items()},
        mu=adam_state(state, "exp_avg"), nu=adam_state(state, "exp_avg_sq"),
        stats={k: v for k, v in state.model.state_dict().items()
               if "running_" in k})


def jax_step(t):
    """The JAX step's results in port_step's form."""
    old, new = sd(np_tree(t["state"].params)), sd(t["params"])
    stats = convert.variables_to_state_dict({"batch_stats": t["stats"]})
    return dict(metrics=dict(t["metrics"], grad_norm=t["grad_norm"]),
                grads=sd(t["grads"]),
                update={n: new[n] - old[n] for n in old},
                mu=sd(t["new_mu"]), nu=sd(t["new_nu"]),
                stats={k: v for k, v in stats.items() if "running_" in k})


def distance(got, want):
    """Relative distances of one step's results from another's: losses and
    grad_norm, the head's and the whole gradient and update in relative
    norm, the update's largest element error in units of lr, the moments
    in relative norm."""
    names = sorted(want["grads"])
    head = [n for n in names if n.startswith("head.")]
    d = {k: abs(got["metrics"][k] / want["metrics"][k] - 1)
         for k in ("loss", "loc_loss", "conf_loss", "grad_norm")}
    for key in ("grads", "update", "mu", "nu"):
        d[key] = rel(flat(got[key], names), flat(want[key], names))
    d["grads_head"] = rel(flat(got["grads"], head),
                          flat(want["grads"], head))
    d["update_head_lr"], d["update_lr"] = (
        max(float((got["update"][n].double()
                   - want["update"][n].double()).abs().max())
            for n in group) / LR for group in (head, names))
    return d


def eval_metrics(t):
    """The port's eval step's metrics from the converted state, and the
    cached multi-batch form's losses over the batch twice."""
    state = port_state(t)
    batch = {k: torch.from_numpy(v) for k, v in t["batch"].items()}
    anchors = torch.from_numpy(t["anchors"])
    got = ttrain.make_eval_step(anchors, t["tcfg"])(state, batch)
    b = batch["image"].shape[0]
    data = {k: torch.cat([v, v]) for k, v in batch.items()}
    idx = torch.arange(2 * b).reshape(2, b)
    multi = ttrain.make_cached_multi_eval_step(anchors, t["tcfg"])(
        state, data, idx)
    return {k: float(v) for k, v in got.items()}, multi["loss"]


def trainer_args(tmp_path, backbone, batch):
    """The trainer's flags for a short CPU run under tmp_path."""
    return ["--backbone", backbone, "--device", "cpu", "--batch-size",
            str(batch), "--synthetic-size", "8", "--val-limit", "1",
            "--log-every", "1", "--model-dir", str(tmp_path / "m"),
            "--log-dir", str(tmp_path / "l")]

