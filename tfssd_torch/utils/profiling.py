"""Tracing and profiling hooks (port of the JAX package's
utils/profiling.py: trace, step_annotation, enable_debug_nans,
device_memory_stats).

    with trace("logs/run"):                  # a torch.profiler trace
        for step in range(10):
            with step_annotation("train_step", step):
                train_step(state, batch)

    enable_debug_nans()                      # fail fast on a non-finite
                                             # loss or gradient

`trace` records the host and, on a card, the device (CUPTI: every kernel,
the hand-written ones launched through ctypes included) and writes a
Chrome trace (trace.pt.trace.json, for Perfetto or chrome://tracing) into
the log directory, also when the traced code raises. `enable_debug_nans`
is the counterpart of jax_debug_nans: the train step (train.py) then reads
its loss metrics and gradient norm after each step, before the update,
and raises FloatingPointError at the first non-finite one. The read waits
for the device, so it happens only when the check is on.

Not ported: honor_platform_env and enable_persistent_compile_cache
configure XLA's platform and its compilation cache, which have no PyTorch
counterpart; the kernels' build cache under build/
(ops/kernels/build.py) plays the second one's part.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Dict, Iterator, Mapping, Optional

import torch

TRACE_FILE = "trace.pt.trace.json"
# The loss metrics and the gradient norm the check reads, in this order;
# grad_norm is non-finite when any gradient element is.
CHECKED_METRICS = ("loss", "loc_loss", "conf_loss", "grad_norm")

_debug_nans = False


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """A torch.profiler trace of the block (CPU, and CUDA where a card is
    present) written to `log_dir`/trace.pt.trace.json when the block ends
    or raises."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def step_annotation(name: str, step: Optional[int] = None):
    """A named range in the profiler's timeline: `name`, or `name#step`
    when a step is given (costs a few microseconds when no profiler
    runs)."""
    return torch.profiler.record_function(
        name if step is None else f"{name}#{step}")


def enable_debug_nans(enable: bool = True) -> bool:
    """Turn the train step's finite check on or off (the process-wide
    switch, as jax_debug_nans is); returns the previous setting."""
    global _debug_nans
    previous, _debug_nans = _debug_nans, bool(enable)
    return previous


def debug_nans_enabled() -> bool:
    return _debug_nans


def check_finite(metrics: Mapping[str, torch.Tensor], step: int) -> None:
    """Raise FloatingPointError naming the step and the metric at the
    first non-finite value of CHECKED_METRICS (one read from the
    device)."""
    names = [k for k in CHECKED_METRICS if k in metrics]
    values = torch.stack([metrics[k].detach().float().reshape(())
                          for k in names]).tolist()
    for name, value in zip(names, values):
        if not math.isfinite(value):
            raise FloatingPointError(
                f"non-finite {name} ({value}) at step {step} "
                f"(--debug-nans)")


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per CUDA device: bytes_in_use and peak_bytes_in_use (PyTorch's
    caching allocator) and bytes_limit (the device's total memory); {}
    without a card."""
    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        _, total = torch.cuda.mem_get_info(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": total,
        }
    return out
