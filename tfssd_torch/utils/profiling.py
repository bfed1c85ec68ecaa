"""Tracing and profiling hooks (port of the JAX package's
utils/profiling.py: trace, step_annotation, enable_debug_nans,
device_memory_stats), and the program's spans and counters.

    with trace("logs/run"):                  # a torch.profiler trace
        for step in range(10):
            with step_annotation("train_step", step):
                train_step(state, batch)

    enable_debug_nans()                      # fail fast on a non-finite
                                             # loss or gradient

`trace` records the host and, on a card, the device (CUPTI: every kernel,
the hand-written ones launched through ctypes included) and writes a
Chrome trace (trace.pt.trace.json, for Perfetto or chrome://tracing) into
the log directory, also when the traced code raises; beside it spans.json,
span_summary() of the traced block. `enable_debug_nans` is the counterpart
of jax_debug_nans: the train step (train.py) then reads its loss metrics
and gradient norm after each step, before the update, and raises
FloatingPointError at the first non-finite one. The read waits for the
device, so it happens only when the check is on.

Spans and counters are on exactly while a torch profiler is active:

    with span("decode"):                     # a stage of a request / step
        boxes, scores = decode_boxes_and_scores(...)
    if recording():
        count("match/real_gts", (labels > 0).sum())
    span_summary()   # per name: calls, host seconds, device seconds

Off, `span` reads the profiler's enabled flag once and returns one shared
no-op context: nothing is allocated, recorded or launched. On, it opens a
record_function range of its name (so the stage lies on the profiler's
timeline beside the device's kernels, and names the device's idle gaps
that fall inside it) and keeps a record in memory: its name, its parent
span, the id its request or step shares (the outermost span's, e.g. the
train step number), its host interval by time.time_ns() (the profiler's
clock) and, where CUDA is initialised, a timing event on the current
stream at entry and at exit, resolved only at read-out (no synchronise
inside the span). A span's device time is the stream time between its two
events: on a card-bound stream a parent's consecutive children partition
it; on a host-bound stage it includes the card's wait for the host's
launches. `count` keeps device tensors as they are and sums them at
read-out.

Not ported: honor_platform_env and enable_persistent_compile_cache
configure XLA's platform and its compilation cache, which have no PyTorch
counterpart; the kernels' build cache under build/
(ops/kernels/build.py) plays the second one's part.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import time
from typing import Dict, Iterator, List, Mapping, Optional, Union

import torch
import torch.autograd.profiler as _autograd_profiler

TRACE_FILE = "trace.pt.trace.json"
SPANS_FILE = "spans.json"
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
    reset_spans()
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
        with open(os.path.join(log_dir, SPANS_FILE), "w") as f:
            json.dump(span_summary(), f, indent=1)


if hasattr(_autograd_profiler, "_is_profiler_enabled"):
    def recording() -> bool:
        """Whether a torch profiler is active, so spans record."""
        return _autograd_profiler._is_profiler_enabled
else:
    recording = torch._C._autograd._profiler_enabled


class _Span:
    """One recorded span (made only while a profiler is active)."""

    __slots__ = ("name", "parent", "id", "range", "events", "host_start_ns",
                 "host_end_ns")

    def __init__(self, name: str, id_, range_name: str):
        self.name, self.parent, self.id = name, None, id_
        self.range = torch.profiler.record_function(range_name)
        self.events = None

    # The events enclose the span's own bookkeeping, so that on a stream
    # that waits for the host the time it costs falls inside the span and
    # not between it and its sibling.
    def __enter__(self):
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.range.__enter__()
        if _stack:
            self.parent = _stack[-1].name
            if self.id is None:
                self.id = _stack[-1].id
        _stack.append(self)
        self.host_start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.host_end_ns = time.time_ns()
        _stack.pop()
        _records.append(self)
        self.range.__exit__(*exc)
        if self.events is not None:
            self.events[1].record()
        return False


_OFF = contextlib.nullcontext()
_stack: List[_Span] = []
_records: List[_Span] = []
_counters: Dict[str, list] = {}


def span(name: str, id: Optional[int] = None):
    """A stage of the program, recorded while a torch profiler is active
    (module docstring); `id` defaults to the enclosing span's."""
    if not recording():
        return _OFF
    return _Span(name, id, name)


def step_annotation(name: str, step: Optional[int] = None):
    """A span `name` with id `step`, whose range in the profiler's timeline
    is `name`, or `name#step` when a step is given; nothing when no
    profiler runs."""
    if not recording():
        return _OFF
    return _Span(name, step, name if step is None else f"{name}#{step}")


def count(name: str, value: Union[int, torch.Tensor]) -> None:
    """Add `value` (an int, or a tensor left on its device) to the counter
    `name` while a profiler is active."""
    if recording():
        _counters.setdefault(name, []).append(value)


def span_records() -> List[dict]:
    """Every closed span, in the order they closed: name, parent, id,
    host_start_ns and host_end_ns (time.time_ns)."""
    return [{"name": r.name, "parent": r.parent, "id": r.id,
             "host_start_ns": r.host_start_ns, "host_end_ns": r.host_end_ns}
            for r in _records]


def span_summary() -> dict:
    """{"spans": {name: {"calls", "host_s", "device_s"}}, "counters":
    {name: total}} over the spans and counts recorded so far; device_s is
    None where a span recorded no CUDA events. Waits for the events."""
    spans: Dict[str, dict] = {}
    if any(r.events is not None for r in _records):
        torch.cuda.synchronize()
    for r in _records:
        s = spans.setdefault(r.name, {"calls": 0, "host_s": 0.0,
                                      "device_s": None})
        s["calls"] += 1
        s["host_s"] += (r.host_end_ns - r.host_start_ns) * 1e-9
        if r.events is not None:
            s["device_s"] = (s["device_s"] or 0.0) + 1e-3 * \
                r.events[0].elapsed_time(r.events[1])
    counters = {k: int(sum(values)) for k, values in _counters.items()}
    return {"spans": spans, "counters": counters}


def reset_spans() -> None:
    """Forget every recorded span and counter."""
    _records.clear()
    _counters.clear()


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
