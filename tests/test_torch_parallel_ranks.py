"""The rank side of tests/test_torch_parallel.py: what each data-parallel
rank runs, and the same runs in one process for the reference (no tests
here; no JAX, so a spawned rank imports only torch and the port).

Every run starts from seeded weights (or a converted JAX state) and
trains the model in float64, its images augmented in float32 as the step
does: a float32 step at random weights is ill-conditioned (its gradient
moves with the thread count, tests/test_torch_train.py), and a float64
step shows the data-parallel path's semantics to rounding.
"""

import numpy as np
import torch

from tfssd_torch import get_hyper_params, parallel, predict, trainer
from tfssd_torch.data.loader import batch_examples, stack_batches
from tfssd_torch.data.synthetic import SyntheticDataset
from tfssd_torch.models.ssd import get_model, init_random_weights
from tfssd_torch.ops.boxes import generate_anchors
from tfssd_torch.train import (TrainState, create_train_state,
                               make_cached_train_step, make_lr_schedule,
                               make_multi_train_step, make_optimizer,
                               make_train_step)
from tfssd_torch.utils import convert

# The JAX dry run's tiny config (__graft_entry__.py:_dryrun_body).
TINY = dict(img_size=64, feature_map_shapes=(4, 2, 1, 1, 1, 1),
            total_labels=6, max_gt_boxes=4)
GLOBAL_BATCH = 4
STEPS = 2
KEYS = ("image", "boxes", "labels")


def _host(x):
    return x.detach().cpu().numpy()


def _state_arrays(state: TrainState):
    sd = state.model.state_dict()
    return {k: _host(v) for k, v in sd.items() if "num_batches" not in k}


def train_form(form: str, shard: parallel.Shard):
    """STEPS steps of `form` (single: one step per call on the streamed
    feed's batches; multi: one call of STEPS steps on the stacked
    batches; cached: one step per call gathering global row indices from
    the whole set; remat: single with the backbone rematerialised) at
    GLOBAL_BATCH, augmentation on, the model in float64; this rank's
    metrics per step and final weights and running statistics."""
    cfg = get_hyper_params("mobilenet_v2", remat=form == "remat", **TINY)
    anchors = torch.from_numpy(generate_anchors(cfg))
    state = create_train_state(cfg, 0, "cpu", make_lr_schedule(1))
    state.model.double()
    # the step's float32-augmented images enter the model in float64
    state.model.register_forward_pre_hook(lambda m, args: (args[0].double(),))
    parallel.broadcast_state(state.model, state.optimizer, shard)
    ds = SyntheticDataset(STEPS * GLOBAL_BATCH, image_size=64,
                          num_classes=5, seed=3)
    kw = dict(augment=True, seed=1, shard=shard)
    if form == "cached":
        whole = next(batch_examples(ds, len(ds), cfg.max_gt_boxes))
        data = {k: torch.from_numpy(whole[k]) for k in KEYS}
        rows = torch.from_numpy(np.random.default_rng(5).permutation(
            len(ds)).reshape(STEPS, GLOBAL_BATCH))
        step = make_cached_train_step(anchors, cfg, **kw)
        metrics = [step(state, data, idx) for idx in rows]
    else:
        host = list(batch_examples(ds, GLOBAL_BATCH, cfg.max_gt_boxes,
                                   shuffle_seed=7,
                                   shard=(shard.rank, shard.world)))
        if form in ("single", "remat"):
            step = make_train_step(anchors, cfg, **kw)
            metrics = [step(state, {k: torch.from_numpy(b[k]) for k in KEYS})
                       for b in host]
        else:
            sb = next(stack_batches(host, STEPS))
            stacked = make_multi_train_step(anchors, cfg, **kw)(
                state, {k: torch.from_numpy(sb[k]) for k in KEYS})
            metrics = [{k: v[i] for k, v in stacked.items()}
                       for i in range(STEPS)]
    return {"metrics": [{k: float(v) for k, v in m.items()}
                        for m in metrics],
            "state": _state_arrays(state), "step": state.step}


def jax_state_step(t, shard: parallel.Shard):
    """One step (augmentation off) from a JAX TrainState carried across by
    utils/convert.py, the model and Adam in float64, on this rank's rows
    of t's batch: the step's metrics, reduced gradients, update, moments
    and running statistics, as numpy (test_torch_train_parity.port_step's
    form)."""
    model = get_model(t["tcfg"]).to(torch.float64)
    opt = make_optimizer(model, t["lr"])
    convert.load_train_state(
        model, opt, {"params": t["params"], "batch_stats": t["batch_stats"]},
        t["mu"], t["nu"], t["count"])
    state = TrainState(t["count"], model, opt, lambda c: t["lr"])
    step = make_train_step(torch.from_numpy(t["anchors"]), t["tcfg"],
                           augment=False, shard=shard)
    rows = shard.rows(len(t["batch"]["image"]))
    batch = {k: torch.from_numpy(v[rows]) for k, v in t["batch"].items()}
    batch["image"] = (batch["image"].float() / 255.0).double()
    params = dict(model.named_parameters())
    before = {n: q.detach().clone() for n, q in params.items()}
    metrics = step(state, batch)

    def moments(key):
        return {n: _host(opt.state[q][key]) for n, q in params.items()}

    return dict(
        metrics={k: float(v) for k, v in metrics.items()},
        grads={n: _host(q.grad) for n, q in params.items()},
        update={n: _host(q.detach() - before[n]) for n, q in params.items()},
        mu=moments("exp_avg"), nu=moments("exp_avg_sq"),
        stats={k: _host(v) for k, v in model.state_dict().items()
               if "running_" in k})


def serve_run(device_cache: bool, shard: parallel.Shard):
    """predict.serve of 10 synthetic images at batch 4 (the last batch
    half padding, so one rank holds only padding there) through seeded
    weights at TINY, float32: the gathered NMSResults, ids and mAP."""
    cfg = get_hyper_params("mobilenet_v2", **TINY)
    model = init_random_weights(get_model(cfg), 0).eval()
    ds = SyntheticDataset(10, image_size=64, num_classes=5, seed=4)
    run = predict.serve(model, cfg, ds, GLOBAL_BATCH,
                        device_cache=device_cache, shard=shard)
    return {"results": [[_host(t) for t in r] for r in run.results],
            "ids": run.ids, "num_valid": run.num_valid,
            "mean_ap": run.mean_ap}


def trainer_run(model_dir: str, log_dir: str, batch_size: int):
    """trainer.main at full width on the CPU, one step and one validation
    batch, streamed; the TrainRun's step metrics and validation loss (or
    the SystemExit's message)."""
    argv = ["--device", "cpu", "--epochs", "1", "--steps-per-epoch", "1",
            "--batch-size", str(batch_size), "--synthetic-size", "4",
            "--val-limit", "1", "--device-cache", "off", "--workers", "1",
            "--model-dir", model_dir, "--log-dir", log_dir]
    try:
        run = trainer.main(argv)
    except SystemExit as e:
        return {"exit": str(e)}
    return {"step_metrics": run.step_metrics, "val": run.val_losses,
            "rank": run.shard.rank}


def form_on_rank(form: str):
    """train_form on this process's rank."""
    torch.set_num_threads(1)
    return train_form(form, parallel.current())


def rank_work(jax_state, model_dir: str, log_dir: str):
    """Everything one rank of the two-rank world runs, in order."""
    torch.set_num_threads(1)
    shard = parallel.current()
    return {
        "forms": {f: train_form(f, shard)
                  for f in ("single", "multi", "cached", "remat")},
        "jax_state": jax_state_step(jax_state, shard),
        "serve": {c: serve_run(c, shard) for c in (True, False)},
        "trainer": trainer_run(model_dir, log_dir, 2),
        "trainer_odd": trainer_run(model_dir + "_odd", log_dir, 3),
    }
