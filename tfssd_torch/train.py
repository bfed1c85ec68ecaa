"""Training semantics: train state, train/eval steps, LR schedule (port of
the JAX package's train.py; reference: trainer.py, utils/train_utils.py).

Adam(1e-3, eps 1e-8) with the reference's step decay (1e-3 -> 1e-4 ->
1e-5 at epochs 80 and 110), GT matching + target encoding per batch, loss
= loc + conf. One train step, on the batch's device:

  1. uint8 -> float / 255        2. augment (data/augment.py)
  3. x 2 - 1                     4. match (the match/encode kernel on CUDA)
  5. forward in train mode (in the config's compute dtype; the model's
     outputs, the loss and Adam are float32)
  6. loss (ops/losses.py)
  7. backward                    8. Adam at the schedule's rate
  9. BatchNorm running statistics (updated by the forward, as Flax's
     mutable batch_stats)

Metrics stay on the device until the caller reads them (with
utils/profiling.py's enable_debug_nans, each step reads its loss metrics
and gradient norm before the update and raises FloatingPointError at a
non-finite one). Under data parallelism (`shard`, tfssd_torch/
parallel.py) a rank's step keeps the global batch's semantics: it draws
the augmentation of the global batch and applies its rows' draws,
BatchNorm takes the global statistics (batch_stats_global around
the forward and the backward), the gradients are averaged over the
ranks before grad_norm is read and Adam steps, and the metrics come back
global (loss terms averaged, num_pos summed); the cached forms take the
global batch's row indices and gather the rank's rows. A Shard of one
rank in a process group communicates and changes no bit. The
device-resident feed (make_cached_train_step)
gathers each batch from a uint8 dataset staged on the device, as the JAX
package's cached path does. The multi-step forms
(make_multi_train_step, make_cached_multi_train_step) run K steps in one
call, as the JAX package's lax.scan does: the same computation as K
single calls (the step count, and with it the rate and the augmentation
draws, advances per step) with no read of a metric between them, their
metrics stacked (K,). Each step runs inside a profiler range
"train_step#<step>". Under a torch profiler a step records the span
`train_step` (id: the step) and under it `gather` (the cached forms),
`augment` (1-3), `match`, `forward`, `loss`, `backward` (with the
all-reduce and the gradient norm) and `adam`, and counts the real gts
that enter the match in `match/real_gts` (utils/profiling.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from tfssd_torch import parallel
from tfssd_torch.config import SSDConfig
from tfssd_torch.data.augment import augment_batch
from tfssd_torch.models.decoder import preprocess_images
from tfssd_torch.models.layers import batch_stats_global
from tfssd_torch.models.ssd import SSD, get_model, init_random_weights
from tfssd_torch.ops.kernels.match_encode import match_batch
from tfssd_torch.ops.losses import ssd_losses
from tfssd_torch.utils import profiling

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]
Schedule = Callable[[int], float]


def scheduler(epoch: int, init_lr: float = 1e-3,
              boundaries: Tuple[int, int] = (80, 110)) -> float:
    """The reference's train_utils.scheduler(epoch): step decay
    1e-3 -> 1e-4 -> 1e-5 at the epoch boundaries."""
    if epoch < boundaries[0]:
        return init_lr
    if epoch < boundaries[1]:
        return init_lr * 0.1
    return init_lr * 0.01


def get_step_size(total_items: int, batch_size: int) -> int:
    """The reference's train_utils.get_step_size (ceil division)."""
    return math.ceil(total_items / batch_size)


def make_lr_schedule(steps_per_epoch: int, init_lr: float = 1e-3,
                     boundaries: Tuple[int, int] = (80, 110)) -> Schedule:
    """The per-epoch step decay as a schedule of the step count (the number
    of updates before this one), with optax.piecewise_constant_schedule's
    float32 arithmetic: the rate falls by 0.1 at count >= boundary."""
    steps = sorted(b * steps_per_epoch for b in boundaries)
    f32 = np.float32

    def schedule(count: int) -> float:
        v = f32(init_lr)
        for threshold in steps:
            ind = f32(max(0.0, float(np.sign(threshold - count))))
            v = f32(v * ind) + f32(f32(f32(1.0) - ind) * f32(0.1)) * v
            v = f32(v)
        return float(v)

    return schedule


def make_optimizer(model: torch.nn.Module, init_lr: float = 1e-3
                   ) -> torch.optim.Adam:
    """Adam, as the reference compiles with (optax.adam's defaults); the
    train step sets the rate from the schedule before every update."""
    return torch.optim.Adam(model.parameters(), lr=init_lr,
                            betas=(0.9, 0.999), eps=1e-8)


@dataclasses.dataclass
class TrainState:
    """What a train step updates: the step count, the model (parameters
    and BatchNorm running statistics) and Adam's state; plus the schedule
    that sets Adam's rate from the step count."""

    step: int
    model: SSD
    optimizer: torch.optim.Adam
    schedule: Schedule


def create_train_state(config: SSDConfig, seed: int, device,
                       schedule: Schedule) -> TrainState:
    """A fresh state on `device`: seeded weights (models/ssd.py), Adam."""
    model = init_random_weights(get_model(config), seed).to(device)
    return TrainState(0, model, make_optimizer(model, schedule(0)), schedule)


def apply_gradients(state: TrainState) -> None:
    """One Adam update from the parameters' .grad at the schedule's rate
    for the updates so far (optax's count), then the step count + 1."""
    lr = state.schedule(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.step += 1


def augment_seed(seed: int, step: int) -> int:
    """Seed of step `step`'s augmentation draws: a function of the step,
    so a resumed run draws what the uninterrupted run would have."""
    return seed * 1_000_003 + step


def _make_step_body(anchors: torch.Tensor, config: SSDConfig, augment: bool,
                    seed: int, shard: parallel.Shard):
    """(state, batch) -> metrics: one train step inside its step span."""
    gen = torch.Generator(device=anchors.device) if augment else None

    def one_step(state: TrainState, batch: Batch) -> Metrics:
        model, opt = state.model, state.optimizer
        with profiling.span("augment"):
            images = batch["image"]
            if images.dtype == torch.uint8:
                images = images.float() / 255.0
            gt_boxes, gt_labels = batch["boxes"], batch["labels"]
            if augment:
                gen.manual_seed(augment_seed(seed, state.step))
                images, gt_boxes, gt_labels = augment_batch(
                    gen, images, gt_boxes, gt_labels, shard.rank,
                    shard.world)
            images = images * 2.0 - 1.0
        with profiling.span("match"):
            if profiling.recording():
                profiling.count("match/real_gts", (gt_labels > 0).sum())
            actual_deltas, actual_labels = match_batch(
                anchors, gt_boxes.contiguous(), gt_labels.contiguous(),
                config)
        model.train()
        # one rank's step skips the walk over the modules (host time)
        with (batch_stats_global(model, shard.world) if shard.world > 1
              else contextlib.nullcontext()):
            with profiling.span("forward"):
                pred_deltas, pred_logits = model(images)
            with profiling.span("loss"):
                total, metrics = ssd_losses(actual_deltas, actual_labels,
                                            pred_deltas, pred_logits,
                                            config.neg_pos_ratio,
                                            config.loc_loss_alpha)
            with profiling.span("backward"):
                opt.zero_grad(set_to_none=True)
                total.backward()
                parallel.all_reduce_grads(model, shard)
                metrics = parallel.reduce_metrics(metrics, shard)
                grads = [p.grad for p in model.parameters()
                         if p.grad is not None]
                metrics["grad_norm"] = torch.nn.utils.get_total_norm(grads)
        if profiling.debug_nans_enabled():
            profiling.check_finite(metrics, state.step)
        with profiling.span("adam"):
            apply_gradients(state)
        return metrics

    return one_step


def make_train_step(anchors: torch.Tensor, config: SSDConfig,
                    augment: bool = True, seed: int = 0,
                    shard: parallel.Shard = parallel.SINGLE):
    """(state, batch) -> metrics, updating `state` in place. `batch` =
    {'image' (B,S,S,3) uint8, 'boxes' (B,G,4) float32, 'labels' (B,G)
    int32} on the anchors' device: the rank's rows of the global batch
    under data parallelism."""
    one_step = _make_step_body(anchors, config, augment, seed, shard)

    def train_step(state: TrainState, batch: Batch) -> Metrics:
        with profiling.step_annotation("train_step", state.step):
            return one_step(state, batch)

    return train_step


def stack_metrics(per_step: List[Metrics]) -> Metrics:
    """Per-step metrics -> each metric stacked (K,), on the device."""
    return {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}


def make_multi_train_step(anchors: torch.Tensor, config: SSDConfig,
                          augment: bool = True, seed: int = 0,
                          shard: parallel.Shard = parallel.SINGLE):
    """(state, superbatch) -> metrics stacked (K,): K train steps in one
    call over a super-batch {'image' (K,B,S,S,3), 'boxes' (K,B,G,4),
    'labels' (K,B,G)} (data/loader.py:stack_batches), each slice through
    make_train_step as K separate calls would go (under data parallelism
    the rank's (K, B / world) part, parallel.superbatch_rows)."""
    base = make_train_step(anchors, config, augment, seed, shard)

    def multi_step(state: TrainState, superbatch: Batch) -> Metrics:
        k = superbatch["image"].shape[0]
        return stack_metrics([
            base(state, {key: superbatch[key][i]
                         for key in ("image", "boxes", "labels")})
            for i in range(k)])

    return multi_step


def gather_rows(data: Batch, idx: torch.Tensor) -> Batch:
    """One batch gathered on the device from a device-resident dataset
    ({'image' (N,S,S,3) uint8, 'boxes', 'labels'}); idx (B,) int64. The
    images stay 4-D: the JAX package stages them flat (flatten_images)
    because XLA's gather would otherwise relayout the whole dataset,
    which index_select does not do."""
    return {k: data[k].index_select(0, idx)
            for k in ("image", "boxes", "labels") if k in data}


def make_cached_train_step(anchors: torch.Tensor, config: SSDConfig,
                           augment: bool = True, seed: int = 0,
                           shard: parallel.Shard = parallel.SINGLE):
    """(state, data, idx) -> metrics: the train step fed by gather_rows
    from a dataset staged on the device once; idx holds the global
    batch's rows, of which the rank gathers its own."""
    one_step = _make_step_body(anchors, config, augment, seed, shard)

    def cached_step(state: TrainState, data: Batch,
                    idx: torch.Tensor) -> Metrics:
        with profiling.step_annotation("train_step", state.step):
            with profiling.span("gather"):
                batch = gather_rows(data, idx[shard.rows(len(idx))])
            return one_step(state, batch)

    return cached_step


def make_cached_multi_train_step(anchors: torch.Tensor, config: SSDConfig,
                                 augment: bool = True, seed: int = 0,
                                 shard: parallel.Shard = parallel.SINGLE):
    """(state, data, idx (K, B)) -> metrics stacked (K,): K train steps in
    one call over device-resident data, each gathering its own rows (the
    rank's columns of idx)."""
    cached_step = make_cached_train_step(anchors, config, augment, seed,
                                         shard)

    def multi_step(state: TrainState, data: Batch,
                   idx: torch.Tensor) -> Metrics:
        return stack_metrics([cached_step(state, data, row)
                              for row in idx])

    return multi_step


def make_eval_step(anchors: torch.Tensor, config: SSDConfig,
                   shard: parallel.Shard = parallel.SINGLE):
    """(state, batch) -> metrics: validation loss, no augmentation, the
    running BatchNorm statistics; the global batch's metrics under data
    parallelism."""

    def eval_step(state: TrainState, batch: Batch) -> Metrics:
        model = state.model
        model.eval()
        with torch.no_grad():
            images = preprocess_images(batch["image"])
            actual_deltas, actual_labels = match_batch(
                anchors, batch["boxes"].contiguous(),
                batch["labels"].contiguous(), config)
            pred_deltas, pred_logits = model(images)
            _, metrics = ssd_losses(actual_deltas, actual_labels,
                                    pred_deltas, pred_logits,
                                    config.neg_pos_ratio,
                                    config.loc_loss_alpha)
        return parallel.reduce_metrics(metrics, shard)

    return eval_step


def make_cached_eval_step(anchors: torch.Tensor, config: SSDConfig,
                          shard: parallel.Shard = parallel.SINGLE):
    """(state, data, idx (B,)) -> metrics: the eval step on rows gathered
    from device-resident data (the rank's rows of the global idx)."""
    base = make_eval_step(anchors, config, shard)

    def cached_eval(state: TrainState, data: Batch,
                    idx: torch.Tensor) -> Metrics:
        return base(state, gather_rows(data, idx[shard.rows(len(idx))]))

    return cached_eval


def make_cached_multi_eval_step(anchors: torch.Tensor, config: SSDConfig,
                                shard: parallel.Shard = parallel.SINGLE):
    """(state, data, idx (K, B)) -> metrics stacked (K,): the whole
    validation pass over device-resident data, one batch after another."""
    base = make_cached_eval_step(anchors, config, shard)

    def multi_eval(state: TrainState, data: Batch,
                   idx: torch.Tensor) -> Metrics:
        return stack_metrics([base(state, data, row) for row in idx])

    return multi_eval
