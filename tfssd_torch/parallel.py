"""Data parallelism over torch.distributed (port of the JAX package's
parallel/mesh.py and of __graft_entry__.py:dryrun_multichip).

The JAX package puts a 1-D "data" mesh over every visible device: the
global batch is split on dim 0 (a K-step super-batch on dim 1), the train
state is replicated, and under jit the sharded step keeps the global
batch's semantics. Here each rank is a process with its own device:

  * `setup` joins the process group that `torchrun` describes in the
    environment (NCCL on the card, each rank on cuda:LOCAL_RANK; gloo for
    the CPU), or takes the one a caller already initialised; without
    either the world is one process and nothing is communicated;
  * a rank keeps its rows of every global batch (`Shard.rows`:
    dim 0, `superbatch_rows`: dim 1 of a K-step super-batch);
  * the weights and Adam's state are broadcast from rank 0
    (`broadcast_state`);
  * the gradients are summed over the ranks and divided by the world
    (`all_reduce_grads`): with equal shards the mean of the ranks' local
    mean losses is the global batch's mean loss, as the JAX step's
    jnp.mean over all images; BatchNorm takes the global batch's
    statistics (the train step's models/layers.py:batch_stats_global);
    the augmentation draws are the global batch's
    (data/augment.py:augment_batch);
  * `reduce_metrics` returns the global metrics (loss terms averaged,
    num_pos summed) and `gather_results` the global batch's NMSResult.

Launch: `torchrun --nproc_per_node=N -m tfssd_torch.trainer ...` (or
`tfssd_torch.predict`). `dryrun_multichip(n)` runs one full train step
over n gloo ranks on the CPU at tiny shapes.
"""

from __future__ import annotations

import dataclasses
import math
import os
import queue as queue_module
import socket
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from tfssd_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class Shard:
    """This process's place in the data-parallel world: its rank, the
    number of ranks, and whether a process group exists (a group of one
    rank communicates too, and changes no bit)."""

    rank: int = 0
    world: int = 1
    distributed: bool = False

    def rows(self, global_batch: int) -> slice:
        """This rank's rows of a global batch of `global_batch`."""
        local = global_batch // self.world
        return slice(self.rank * local, (self.rank + 1) * local)


SINGLE = Shard()


def current() -> Shard:
    """The Shard of the process group this process is in, or SINGLE."""
    if dist.is_available() and dist.is_initialized():
        return Shard(dist.get_rank(), dist.get_world_size(), True)
    return SINGLE


def setup(device="cuda") -> Tuple[Shard, torch.device, bool]:
    """(shard, device, owned): join the data-parallel world. An initialised
    process group is taken as it is, with `device` as given (two gloo
    ranks may share one card). Otherwise, under torchrun (WORLD_SIZE in
    the environment) the group is initialised from the environment: NCCL
    on the card, with this rank on cuda:LOCAL_RANK, gloo for the CPU.
    Otherwise the world is this process alone. `owned` says whether this
    call initialised the group (then `teardown` destroys it)."""
    dev = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return current(), dev, False
    if "WORLD_SIZE" not in os.environ:
        return SINGLE, dev, False
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev)
    else:
        dist.init_process_group("gloo")
    return current(), dev, True


def teardown(owned: bool) -> None:
    """Destroy the process group if `setup` initialised it."""
    if owned and dist.is_initialized():
        dist.destroy_process_group()


def barrier(shard: Shard) -> None:
    if shard.distributed:
        dist.barrier()


def superbatch_rows(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """This rank's part of a (K, B, ...) super-batch or (K, B) row index:
    dim 1 split, as the JAX package's superbatch_sharding splits it."""
    return x[:, shard.rows(x.shape[1])]


def broadcast_state(model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer],
                    shard: Shard) -> None:
    """Rank 0's parameters, buffers and Adam state on every rank."""
    if not shard.distributed:
        return
    tensors = list(model.parameters()) + list(model.buffers())
    if optimizer is not None:
        for group in optimizer.param_groups:
            for p in group["params"]:
                tensors += [v for v in optimizer.state.get(p, {}).values()
                            if isinstance(v, torch.Tensor)]
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0)


def all_reduce_grads(model: torch.nn.Module, shard: Shard) -> None:
    """Each parameter's .grad replaced by the mean of the ranks' (one flat
    all-reduce of every gradient)."""
    if not shard.distributed:
        return
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= shard.world
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


# Metrics summed over the ranks; every other metric is averaged.
SUMMED = ("num_pos",)


def reduce_metrics(metrics: Dict[str, torch.Tensor], shard: Shard
                   ) -> Dict[str, torch.Tensor]:
    """The global batch's metrics from each rank's: num_pos summed, the
    loss terms (local means over equal shards) averaged. One all-reduce of
    the stacked scalars."""
    if not shard.distributed:
        return metrics
    keys = list(metrics)
    stacked = torch.stack([metrics[k].float() for k in keys])
    dist.all_reduce(stacked)
    return {k: stacked[i] if k in SUMMED else stacked[i] / shard.world
            for i, k in enumerate(keys)}


def gather_results(result: Sequence[torch.Tensor], shard: Shard):
    """A namedtuple of batch-leading tensors (an NMSResult) gathered from
    every rank, concatenated on dim 0 in rank order."""
    if not shard.distributed:
        return result
    out = []
    for t in result:
        parts = [torch.empty_like(t) for _ in range(shard.world)]
        dist.all_gather(parts, t.contiguous())
        out.append(torch.cat(parts))
    return type(result)(*out)


def gather_objects(obj: Any, shard: Shard) -> List[Any]:
    """Picklable `obj` of every rank, in rank order."""
    if not shard.distributed:
        return [obj]
    out: List[Any] = [None] * shard.world
    dist.all_gather_object(out, obj)
    return out


def free_port() -> int:
    """A free TCP port on localhost for a process group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


SPAWN_TIMEOUT_S = 600


class Group:
    """`world` fresh processes (multiprocessing's spawn) running fn(*args)
    after joining one process group of `backend` at tcp://localhost:<a
    free port>; `wait` collects their results. `fn` must be importable by
    name (a module-level function) and return something picklable."""

    def __init__(self, fn, world: int, *args, backend: str = "gloo"):
        ctx = torch.multiprocessing.get_context("spawn")
        port = free_port()
        self.world = world
        self.queue = ctx.Queue()
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(r, world, port, backend, fn, args,
                                        self.queue))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def wait(self, timeout: float = SPAWN_TIMEOUT_S) -> List[Any]:
        """Each rank's result, in rank order. Raises with the failing
        ranks' tracebacks if any rank fails or exits without a result, and
        kills every rank still running after `timeout` seconds."""
        results: Dict[int, Any] = {}
        errors: List[str] = []
        deadline = time.monotonic() + timeout
        try:
            while len(results) + len(errors) < self.world:
                try:
                    rank, ok, value = self.queue.get(timeout=1.0)
                except queue_module.Empty:
                    dead = [r for r, p in enumerate(self.procs)
                            if p.exitcode is not None and r not in results]
                    if dead and self.queue.empty():
                        errors.append(
                            f"ranks {dead} exited without a result (exit "
                            f"codes {[self.procs[r].exitcode for r in dead]})")
                        break
                    if time.monotonic() > deadline:
                        errors.append(f"no result after {timeout} s")
                        break
                    continue
                if ok:
                    results[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
        finally:
            for p in self.procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
        if errors:
            raise RuntimeError("\n".join(errors))
        return [results[r] for r in range(self.world)]


def spawn(fn, world: int, *args, backend: str = "gloo",
          timeout: float = SPAWN_TIMEOUT_S) -> List[Any]:
    """fn(*args) on `world` ranks of a fresh process group (Group), each
    rank's result in rank order."""
    return Group(fn, world, *args, backend=backend).wait(timeout)


def _rank_main(rank: int, world: int, port: int, backend: str, fn, args,
               queue) -> None:
    import traceback

    try:
        dist.init_process_group(backend,
                                init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        try:
            result = fn(*args)
        finally:
            dist.destroy_process_group()
    except Exception:  # reported to the parent, which raises
        queue.put((rank, False, traceback.format_exc()))
    else:
        queue.put((rank, True, result))


# ---------------------------------------------------------------------------
# The multi-rank dry run (__graft_entry__.py:dryrun_multichip)
# ---------------------------------------------------------------------------


def dryrun_multichip(n: int) -> None:
    """One full train step (augment -> match -> forward -> loss ->
    backward -> Adam) over n gloo ranks on the CPU at the JAX dry run's
    tiny config (image 64, feature maps (4, 2, 1, 1, 1, 1), 6 labels, 4
    gts, global batch 2n), then one step of the device-cached form; prints
    `dryrun_multichip(n): ok`. Raises if a rank fails, a loss is not
    finite or the ranks' parameters differ after the steps."""
    results = spawn(_dryrun_body, n, n)
    if len({r["checksum"] for r in results}) != 1:
        raise RuntimeError(f"ranks' parameters differ: {results}")
    losses = [r[k] for r in results for k in ("loss", "cached_loss")]
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"non-finite loss {losses}")
    print(f"dryrun_multichip({n}): ok")


def _dryrun_body(world: int) -> Dict[str, float]:
    from tfssd_torch import get_hyper_params
    from tfssd_torch.data.loader import batch_examples
    from tfssd_torch.data.synthetic import SyntheticDataset
    from tfssd_torch.ops.boxes import generate_anchors
    from tfssd_torch.train import (create_train_state, make_cached_train_step,
                                   make_lr_schedule, make_train_step)

    torch.set_num_threads(1)
    shard = current()
    cfg = get_hyper_params("mobilenet_v2", img_size=64,
                           feature_map_shapes=(4, 2, 1, 1, 1, 1),
                           total_labels=6, max_gt_boxes=4)
    anchors = torch.from_numpy(generate_anchors(cfg))
    state = create_train_state(cfg, 0, "cpu", make_lr_schedule(1))
    broadcast_state(state.model, state.optimizer, shard)
    batch_size = 2 * world
    ds = SyntheticDataset(batch_size, image_size=64, num_classes=5)
    host = next(batch_examples(ds, batch_size, cfg.max_gt_boxes,
                               shard=(shard.rank, shard.world)))
    batch = {k: torch.from_numpy(host[k]) for k in ("image", "boxes",
                                                     "labels")}
    step = make_train_step(anchors, cfg, augment=True, seed=1, shard=shard)
    loss = float(step(state, batch)["loss"])
    # the device-cached form: every rank holds the whole set and gathers
    # its rows of the global batch
    whole = next(batch_examples(ds, batch_size, cfg.max_gt_boxes))
    data = {k: torch.from_numpy(whole[k]) for k in ("image", "boxes",
                                                     "labels")}
    cached = make_cached_train_step(anchors, cfg, augment=True, seed=1,
                                    shard=shard)
    closs = float(cached(state, data, torch.arange(batch_size))["loss"])
    if state.step != 2:
        raise RuntimeError(f"step count {state.step} after two steps")
    with torch.no_grad():
        checksum = float(sum(p.double().sum() for p in
                             state.model.parameters()))
    return {"loss": loss, "cached_loss": closs, "checksum": checksum}
