"""K optimizer steps per call (tfssd_torch.train.make_multi_train_step,
make_cached_multi_train_step) against K single steps and against the JAX
package's make_multi_train_step (its lax.scan), on the tiny config of
tests/test_torch_train.py.

  * The port's K = 3 call is the same computation as three calls of
    make_train_step from the same state, augmentation on: parameters,
    BatchNorm statistics, Adam's moments and the stacked metrics bit for
    bit (on the CPU, where the same operations on the same inputs give the
    same bits). The cached form, which gathers its rows from a staged
    dataset, equals the super-batch form on those rows.
  * The port's K = 3 call in float64 from a JAX TrainState carried across
    by utils/convert.py, augmentation off, against JAX's jitted
    make_multi_train_step in float32. Its first step is held by the
    one-step gates of tests/test_torch_train.py (losses 1e-4 relative,
    grad_norm 1e-3). The call as a whole cannot be: at random weights each
    step amplifies the last one's rounding, so after three steps any
    float32 run (the port's own too) lies far past those gates from the
    float64 one. The whole call (each step's metrics, the update, Adam's
    moments, BatchNorm statistics) is held instead to that float32 floor,
    measured in the test: JAX may lie no farther from the port's float64
    call than the port's own float32 call does at 1, 4 or 8 threads.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tfssd_torch import get_hyper_params as t_hyper  # noqa: E402
from tfssd_torch import train as ttrain  # noqa: E402
from tfssd_torch.data.loader import (batch_examples, stack_batches,  # noqa: E402,E501
                                     stage_arrays)
from tfssd_torch.data.synthetic import SyntheticDataset  # noqa: E402
from tfssd_torch.ops.boxes import generate_anchors  # noqa: E402
from tfssd_torch.utils import convert  # noqa: E402
from tfssd_tpu import get_hyper_params as j_hyper  # noqa: E402
from tfssd_tpu import train as jtrain  # noqa: E402
from tfssd_tpu.models import get_model as j_get_model  # noqa: E402
from test_torch_train import TINY  # noqa: E402
from test_torch_train_parity import (LR, adam_state, flat, np_tree,  # noqa: E402,E501
                                     port_state, rel, sd, seeded_moments)

K, B = 3, 4
KEYS = ("image", "boxes", "labels")
LOSSES = ("loss", "loc_loss", "conf_loss")


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """torch at 2 threads for the module: the test runner's workers share
    the machine's cores, and a step at a thread per core in each of them
    oversubscribes the cores (and spins), so every worker slows. The
    comparisons here are between runs in one process, at one count."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _superbatch():
    ds = SyntheticDataset(K * B, image_size=TINY["img_size"], max_objects=2,
                          seed=7, num_classes=5)
    sb = next(stack_batches(batch_examples(ds, B, TINY["max_gt_boxes"]), K))
    return {k: torch.from_numpy(sb[k]) for k in KEYS}


def _fresh(cfg):
    return ttrain.create_train_state(cfg, 3, "cpu",
                                     ttrain.make_lr_schedule(2))


def _assert_states_equal(a, b):
    assert a.step == b.step
    for (name, x), y in zip(a.model.state_dict().items(),
                            b.model.state_dict().values()):
        assert torch.equal(x, y), name
    for key in ("exp_avg", "exp_avg_sq"):
        sa, sb = adam_state(a, key), adam_state(b, key)
        for name in sa:
            assert torch.equal(sa[name], sb[name]), (key, name)


def test_multi_step_is_k_single_steps_bit_for_bit():
    cfg = t_hyper("mobilenet_v2", **TINY)
    anchors = torch.from_numpy(generate_anchors(cfg))
    sb = _superbatch()
    single, multi = _fresh(cfg), _fresh(cfg)
    step = ttrain.make_train_step(anchors, cfg, augment=True, seed=5)
    per_step = [step(single, {k: sb[k][i] for k in KEYS}) for i in range(K)]
    stacked = ttrain.make_multi_train_step(anchors, cfg, augment=True,
                                           seed=5)(multi, sb)
    assert multi.step == single.step == K
    for name, v in stacked.items():
        assert v.shape == (K,), name
        assert torch.equal(v, torch.stack([m[name] for m in per_step])), name
    assert len(set(float(v) for v in stacked["loss"])) == K
    _assert_states_equal(multi, single)


def test_cached_multi_step_equals_the_multi_step_on_its_rows():
    cfg = t_hyper("mobilenet_v2", **TINY)
    anchors = torch.from_numpy(generate_anchors(cfg))
    ds = SyntheticDataset(2 * K * B, image_size=TINY["img_size"],
                          max_objects=2, seed=8, num_classes=5)
    host, n = stage_arrays(ds, TINY["max_gt_boxes"], workers=1)
    data = {k: torch.from_numpy(host[k]) for k in KEYS}
    idx = torch.from_numpy(
        np.random.default_rng(0).permutation(n)[:K * B].reshape(K, B))
    cached, multi = _fresh(cfg), _fresh(cfg)
    got = ttrain.make_cached_multi_train_step(anchors, cfg, seed=1)(
        cached, data, idx)
    want = ttrain.make_multi_train_step(anchors, cfg, seed=1)(
        multi, {k: data[k][idx] for k in KEYS})
    for name in want:
        assert torch.equal(got[name], want[name]), name
    _assert_states_equal(cached, multi)
    # the cached eval step on one batch equals the eval step on its rows
    row = idx[0]
    ev = ttrain.make_cached_eval_step(anchors, cfg)(cached, data, row)
    plain = ttrain.make_eval_step(anchors, cfg)(
        cached, {k: data[k][row] for k in KEYS})
    assert all(torch.equal(ev[k], plain[k]) for k in plain)


def _port_multi(t, sb, anchors, dtype, threads):
    """The port's K-step call from the converted state in `dtype` at
    `threads` torch threads: its stacked metrics, the update (new minus
    old parameters) and Adam's moments, in float64."""
    before_threads = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        port = port_state(t, dtype=dtype)
        params = dict(port.model.named_parameters())
        before = {n: q.detach().clone() for n, q in params.items()}
        batch = {k: torch.from_numpy(v) for k, v in sb.items()}
        batch["image"] = (batch["image"].float() / 255.0).to(dtype)
        got = ttrain.make_multi_train_step(torch.from_numpy(anchors),
                                           t["tcfg"], augment=False)(
                                               port, batch)
    finally:
        torch.set_num_threads(before_threads)
    assert port.step == t["count"] + K
    return dict(metrics={k: v.double().numpy() for k, v in got.items()},
                update={n: (q.detach() - before[n]).double()
                        for n, q in params.items()},
                mu=adam_state(port, "exp_avg"),
                nu=adam_state(port, "exp_avg_sq"),
                stats={k: v for k, v in port.model.state_dict().items()
                       if "running_" in k})


def _trajectory_distance(got, want):
    """Distances of one K-step result from another: each loss metric's and
    grad_norm's largest relative error over the K steps, the update in
    relative norm and in units of lr (the head's and the whole's largest
    element), the moments in relative norm, the running statistics'
    largest error relative to 2e-3 |want| + 2e-4 (1 is the one-step
    gate)."""
    names = sorted(want["update"])
    head = [n for n in names if n.startswith("head.")]
    d = {k: float(np.max(np.abs(got["metrics"][k] / want["metrics"][k] - 1)))
         for k in LOSSES + ("grad_norm",)}
    d["update"] = rel(flat(got["update"], names), flat(want["update"], names))
    d["update_head_lr"], d["update_lr"] = (
        max(float((got["update"][n] - want["update"][n]).abs().max())
            for n in group) / LR for group in (head, names))
    for key in ("mu", "nu"):
        d[key] = rel(flat(got[key], names), flat(want[key], names))
    d["stats"] = max(
        float(((got["stats"][k].double() - v.double()).abs()
               / (2e-3 * v.double().abs() + 2e-4)).max())
        for k, v in want["stats"].items())
    return d


def test_multi_step_from_a_converted_jax_state_matches_jax():
    # Each step of the call rounds, and at random weights the next step
    # amplifies the last one's rounding (train-mode BatchNorm over 4
    # values on the 1x1 maps): after 3 steps the port's own float32 call
    # lies up to 7e-3 (loss), 0.14 (grad_norm), 2.2 lr (update) and 0.36
    # (mu) from its float64 call, by thread count. So the first step, a
    # one-step quantity, is held to tests/test_torch_train.py's one-step
    # gates, and the whole call to that float32 floor: JAX's float32 scan
    # may lie no farther from the port's float64 call than the port's own
    # float32 call does at 1, 4 or 8 threads (measured: JAX at 0.10-0.72
    # of that floor, distance by distance; the test prints both).
    jcfg, tcfg = j_hyper("mobilenet_v2", **TINY), t_hyper("mobilenet_v2",
                                                          **TINY)
    model = j_get_model(jcfg)
    opt = jtrain.make_optimizer(LR)
    state = jtrain.create_train_state(model, jax.random.key(0), opt)
    mu, nu = seeded_moments(np_tree(state.params))
    count = 3
    adam = state.opt_state[0]._replace(
        count=jnp.asarray(count, jnp.int32),
        mu=jax.tree_util.tree_map(jnp.asarray, mu),
        nu=jax.tree_util.tree_map(jnp.asarray, nu))
    jstate = state.replace(opt_state=(adam,) + tuple(state.opt_state[1:]))
    sb = {k: v.numpy() for k, v in _superbatch().items()}
    anchors = generate_anchors(jcfg)
    multi = jax.jit(jtrain.make_multi_train_step(model, anchors, opt,
                                                 augment=False))
    new, jm = multi(jstate, {k: jnp.asarray(v) for k, v in sb.items()},
                    jax.random.key(1))
    assert int(new.step) == K

    t = dict(tcfg=tcfg, state=state, mu=mu, nu=nu, count=count)
    exact = _port_multi(t, sb, anchors, torch.float64,
                        torch.get_num_threads())
    old, jnew = sd(np_tree(state.params)), sd(np_tree(new.params))
    stats = convert.variables_to_state_dict(
        {"batch_stats": np_tree(new.batch_stats)})
    jax_run = dict(
        metrics={k: np.asarray(v, np.float64) for k, v in jm.items()},
        update={n: (jnew[n] - old[n]).double() for n in exact["update"]},
        mu=sd(np_tree(new.opt_state[0].mu)),
        nu=sd(np_tree(new.opt_state[0].nu)),
        stats={k: v for k, v in stats.items() if "running_" in k})

    assert np.array_equal(exact["metrics"]["num_pos"],
                          jax_run["metrics"]["num_pos"])
    first = {k: abs(exact["metrics"][k][0] / jax_run["metrics"][k][0] - 1)
             for k in LOSSES + ("grad_norm",)}
    gates = dict(dict.fromkeys(LOSSES, 1e-4), grad_norm=1e-3)
    assert all(first[k] < v for k, v in gates.items()), (first, gates)

    floors = [_trajectory_distance(
        _port_multi(t, sb, anchors, torch.float32, threads), exact)
        for threads in (1, 4, 8)]
    floor = {k: max(f[k] for f in floors) for k in floors[0]}
    d = _trajectory_distance(jax_run, exact)
    print(f"JAX's float32 call from the port's float64 one: {d}; the "
          f"port's float32 floor: {floor}")
    assert all(d[k] <= floor[k] for k in d), (d, floor)
    # the steps differ: three batches, three states
    assert len(set(exact["metrics"]["loss"].tolist())) == K
