"""Training traffic: train steps back to back on a dataset staged on the
device. The traffic file gives `batch`, `pool` (synthetic scenes made from
the seed and staged on the card once), `augment`, `warmup_steps` (the
first steps, run in set-up; the reference follows the first
`checked_steps` of them) and `profile_steps` (the traced stretch).

Set-up: the seeded weights (reference/ssd.py, made on the device) loaded
into the program's TrainState from tfssd_torch.train.create_train_state,
the step from tfssd_torch.train.make_cached_train_step (augmentation as
the traffic says, its stream from the seed), rows in the trainer's
shuffled epoch order (data.epoch_indices). The warm-up steps go through
the same call and feed as the window's; after the first the program's
gradient is read from Adam's first moment (exp_avg / (1 - beta1)), after
the `checked_steps`-th its parameters' change, per leaf. The window runs
steps back to back with no host read between them and closes with a
synchronise. Then one more step goes through the same call and feed on
the next rows, from the state the window left: the program's parameters,
Adam's moments and its update count are copied to the host before it, and
its loss, its gradient per leaf (from Adam's first moment, (exp_avg' -
beta1 exp_avg) / (1 - beta1)) and its change per leaf are read after it.

The reference (reference/train.py) then runs the checked steps from the
same weights on the same rows in its own dtype: loss_gap, loss1_gap,
grad_gap and change_gap (reference/train.py:judge); and the step after
the window from the program's state before it, as the program's Adam
holds it (the reference cannot follow the window's steps itself in its
time): post_loss_gap, post_grad_gap and post_change_gap.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import data, harness
from portbench import trace as tracing
from portbench.reference import ssd
from portbench.reference import train as reference

BETA1 = 0.9


def flax_name(name: str) -> str:
    """A state_dict name of the program's model -> the tree's key."""
    parts = name.split(".")
    leaf = parts[-1]
    if leaf == "weight":
        leaf = "scale" if parts[-2] == "bn" else "kernel"
    return "params/" + "/".join(parts[:-1] + [leaf])


def first_gradient_norm(optimizer, param) -> torch.Tensor:
    """The norm of the gradient Adam got at its first step, from its first
    moment (exp_avg = (1 - beta1) g); NaN where Adam holds no state."""
    moment = optimizer.state.get(param, {}).get("exp_avg")
    if moment is None:
        return torch.tensor(float("nan"))
    return moment.norm() / (1 - BETA1)


def reference_layout(x: torch.Tensor) -> torch.Tensor:
    """A parameter of the program, or its moment, in the tree's layout: a
    conv kernel (O, I, H, W) -> (H, W, I, O)."""
    return x.permute(2, 3, 1, 0) if x.dim() == 4 else x


def step_after_window(state, step, dataset, rows, t: int, params) -> Dict:
    """One step through the window's call and feed on rows(t), from the
    state the window left: that state, copied to the host in the tree's
    keys and layout ('params', and 'adam' = (first moments, second
    moments, update count)), and the step's 'loss', 'grad_norms' (from
    Adam's first moment) and 'change_norms' per leaf."""
    opt = state.optimizer

    def held(p: torch.Tensor, key: str) -> torch.Tensor:
        """Adam's `key` for p; NaN where Adam holds none."""
        return opt.state.get(p, {}).get(key, torch.full_like(p, math.nan))

    def copy(x: torch.Tensor) -> torch.Tensor:
        return x.detach().to("cpu", copy=True)

    before = {k: copy(p) for k, p in params.items()}
    m0 = {k: copy(held(p, "exp_avg")) for k, p in params.items()}
    v0 = {k: copy(held(p, "exp_avg_sq")) for k, p in params.items()}
    count = int(opt.state.get(next(iter(params.values())), {}).get("step", 0))
    loss = step(state, dataset, rows(t))["loss"]
    grads, change = {}, {}
    for k, p in params.items():
        m1 = held(p, "exp_avg").double()
        g = (m1 - BETA1 * m0[k].to(m1)) / (1 - BETA1)
        grads[flax_name(k)] = float(g.norm())
        change[flax_name(k)] = float(
            (p.detach().double() - before[k].to(m1)).norm())
    return {"loss": float(loss), "grad_norms": grads, "change_norms": change,
            "params": {flax_name(k): reference_layout(v)
                       for k, v in before.items()},
            "adam": ({flax_name(k): reference_layout(v)
                      for k, v in m0.items()},
                     {flax_name(k): reference_layout(v)
                      for k, v in v0.items()}, count),
            "step": t}


class Rows:
    """The batches' rows in the shuffled epoch order, on the device."""

    def __init__(self, seed: int, pool: int, batch: int, device: str):
        self.seed, self.pool, self.batch, self.device = (seed, pool, batch,
                                                         device)
        self.per_epoch = pool // batch
        self.epochs: Dict[int, torch.Tensor] = {}

    def __call__(self, step: int) -> torch.Tensor:
        e, k = divmod(step, self.per_epoch)
        if e not in self.epochs:
            # pinned, so that the copy does not wait for the steps queued
            idx = torch.from_numpy(data.epoch_indices(
                self.seed, e, self.pool, self.per_epoch, self.batch))
            if self.device != "cpu":
                idx = idx.pin_memory()
            self.epochs = {e: idx.to(self.device, non_blocking=True)}
        return self.epochs[e][k]


def staged(ctx: harness.Context, cfg: dict, traffic: dict):
    host = data.synthetic(traffic["pool"], cfg["img_size"], ctx.seed,
                          cfg["max_gt_boxes"])
    return {k: torch.from_numpy(v).to(ctx.device) for k, v in host.items()}


def run(ctx: harness.Context, control: bool = False) -> harness.Outcome:
    """One run of the cell; with `control`, the control's readings in the
    program's place (check)."""
    from tfssd_torch import get_hyper_params
    from tfssd_torch.ops.boxes import generate_anchors
    from tfssd_torch.train import (create_train_state,
                                   make_cached_train_step, make_lr_schedule)
    from tfssd_torch.utils.convert import load_variables

    cfg, traffic = ctx.cell.config, ctx.cell.traffic
    batch, dev = traffic["batch"], ctx.device
    program_cfg = get_hyper_params(cfg["port_backbone"])
    harness.check_program_config(program_cfg, cfg)
    dataset = staged(ctx, cfg, traffic)
    tree = harness.numpy_tree(ssd.seeded_weights(cfg, ctx.seed, dev))
    rows = Rows(ctx.seed, traffic["pool"], batch, dev)
    state = create_train_state(program_cfg, ctx.seed, dev,
                               make_lr_schedule(rows.per_epoch))
    load_variables(state.model, tree)
    step = make_cached_train_step(
        torch.from_numpy(generate_anchors(program_cfg)).to(dev),
        program_cfg, augment=traffic["augment"], seed=ctx.seed)

    params = dict(state.model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    checked = traffic["checked_steps"]
    losses: List[torch.Tensor] = []
    grad_norms: Dict[str, torch.Tensor] = {}
    change_norms: Dict[str, torch.Tensor] = {}
    for t in range(traffic["warmup_steps"]):
        metrics = step(state, dataset, rows(t))
        if t < checked:
            losses.append(metrics["loss"])
        if t == 0:
            grad_norms = {k: first_gradient_norm(state.optimizer, p)
                          for k, p in params.items()}
        if t == checked - 1:
            change_norms = {k: (p.detach() - start[k]).norm()
                            for k, p in params.items()}
    del start
    sync = harness.sync_fn(dev)
    sync()
    setup_peak = torch.cuda.max_memory_allocated() if dev != "cpu" else 0
    if dev != "cpu":
        torch.cuda.reset_peak_memory_stats()

    window: List[dict] = []
    t_window = time.perf_counter()
    setup_s = t_window - ctx.started
    t = traffic["warmup_steps"]
    while time.perf_counter() - t_window < ctx.seconds:
        window.append(step(state, dataset, rows(t)))
        t += 1
    sync()
    window_s = time.perf_counter() - t_window
    timings = {"setup_s": setup_s, "window_s": window_s}
    window_peak = torch.cuda.max_memory_allocated() if dev != "cpu" else 0
    e2e = {"train_img_per_s": harness.window_rate(len(window) * batch,
                                                  window_s),
           "train_peak_gib": window_peak / 2 ** 30,
           "setup_s": setup_s}
    failed = sum(1 for m in window if not bool(torch.isfinite(m["loss"])))
    attempted = len(window)
    post = step_after_window(state, step, dataset, rows, t, params)
    t += 1

    flops = ssd.model_flops(cfg, train=True)
    trace = None
    if ctx.trace:
        n = traffic["profile_steps"]
        first = t
        shapes = {"anchors": cfg["anchors"], "batch": batch,
                  "max_gt": cfg["max_gt_boxes"],
                  "real_gts": int(np.mean([
                      int((dataset["labels"].index_select(
                          0, rows(first + j)) > 0).sum()) for j in range(n)]))}

        def one(j: int) -> None:
            step(state, dataset, rows(first + j))

        if dev == "cpu":
            for j in range(n):
                one(j)
            trace = tracing.empty("train", e2e["train_img_per_s"], flops,
                                  shapes)
        else:
            prof, profiled_s = tracing.profile(one, n, sync)
            trace = tracing.reduce(prof, "train", n, profiled_s,
                                   e2e["train_img_per_s"], flops, shapes)
            del prof
    peak = max(setup_peak, torch.cuda.max_memory_allocated()
               if dev != "cpu" else 0)
    got = {"losses": [float(x) for x in losses],
           "grad_norms": {flax_name(k): float(v)
                          for k, v in grad_norms.items()},
           "change_norms": {flax_name(k): float(v)
                            for k, v in change_norms.items()}}
    del state, step, params, window
    harness.free(dev)

    t_check = time.perf_counter()
    numbers = check(ctx, cfg, traffic, tree, dataset, rows, got, post,
                    control)
    timings["reference_s"] = time.perf_counter() - t_check
    checks = harness.judged(numbers, harness.limits(ctx.cell))
    return harness.Outcome(
        correct=harness.passes(checks) and failed == 0,
        attempted=attempted, failed=failed, end_to_end=e2e, checks=checks,
        memory_peak_bytes=peak, trace=trace, timings=timings)


def reference_steps(ctx: harness.Context, cfg: dict, traffic: dict, tree,
                    dataset, rows: Rows, dtype, allow_tf32: bool) -> Dict:
    tree_t = {k: torch.as_tensor(np.asarray(v)).to(ctx.device)
              for k, v in tree.items()}
    if not traffic["augment"]:
        raise ValueError("the reference follows augmented steps only")
    with harness.tf32(allow_tf32):
        return reference.run_steps(
            cfg, tree_t, dataset,
            [rows(t) for t in range(traffic["checked_steps"])], ctx.seed,
            dtype)


def check(ctx: harness.Context, cfg: dict, traffic: dict, tree, dataset,
          rows: Rows, got: Dict, post: Dict, control: bool = False
          ) -> Dict[str, float]:
    """The numbers of reference/train.py:judge for the program's checked
    steps `got`, and as post_* for its step after the window `post`; with
    `control`, for the reference's own steps in the control's lower
    precision (float32 with TF32) in the program's place, the step after
    the window from the same state."""
    dtype = harness.reference_dtype(cfg)
    ref = reference_steps(ctx, cfg, traffic, tree, dataset, rows, dtype,
                          False)
    if control:
        got = reference_steps(ctx, cfg, traffic, tree, dataset, rows,
                              torch.float32, True)
    numbers = reference.judge(ref, got)

    start = {k: torch.as_tensor(v).to(ctx.device)
             for k, v in {**tree, **post["params"]}.items()}

    def after(dt, allow_tf32: bool) -> Dict:
        with harness.tf32(allow_tf32):
            return reference.run_steps(
                cfg, start, dataset, [rows(post["step"])], ctx.seed, dt,
                first_step=post["step"], adam=post["adam"])

    ref_post = after(dtype, False)
    got_post = (after(torch.float32, True) if control else
                {"losses": [post["loss"]], "grad_norms": post["grad_norms"],
                 "change_norms": post["change_norms"]})
    judged = reference.judge(ref_post, got_post)
    numbers.update({"post_loss_gap": judged["loss1_gap"],
                    "post_grad_gap": judged["grad_gap"],
                    "post_change_gap": judged["change_gap"]})
    return numbers
