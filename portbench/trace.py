"""What a traced run hands the per-layer metric readers: a profiled stretch
of requests or steps reduced to device busy time, kernels by name and
launch, convolution time, and the longest idle gaps by what the host was
doing; beside it the unprofiled window's rate and the model's FLOPs.

A kernel under aten::convolution (and, in training, aten::convolution_
backward) counts as convolution: the rule of the program's
profile_serving / profile_train, copied here so that the yardstick stays
with the benchmark.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

CONV_OPS = {"serve": ("aten::convolution",),
            "train": ("aten::convolution", "aten::convolution_backward")}
TOP = 10


@dataclasses.dataclass
class Trace:
    """kind: 'serve' or 'train'; count: requests or steps profiled;
    window_s: the host clock over them; busy_s: the union of the device's
    activity in it; kernels: (name, seconds) of every kernel launched;
    conv_s: device seconds of the convolutions; items_per_s and
    flops_per_item: the unprofiled window's images per second and the
    model's FLOPs per image; shapes: what the kernel readers need (see the
    drivers); breakdown: the heaviest device operations and the longest
    idle gaps."""

    kind: str
    count: int
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float]]
    conv_s: float
    items_per_s: float
    flops_per_item: float
    shapes: dict
    breakdown: dict


def profile(fn: Callable[[int], None], count: int, sync: Callable[[], None]
            ) -> Tuple[object, float]:
    """Run fn(0..count-1) under torch.profiler (CPU and CUDA activity);
    (the profiler, the host seconds from the first call to the sync after
    the last)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    sync()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(count):
            fn(i)
        sync()
        window = time.perf_counter() - t0
    return prof, window


def _union(intervals: List[Tuple[int, int]]) -> Tuple[int, list]:
    """(covered ns, the gaps between covered stretches)."""
    total, gaps, end = 0, [], None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total, gaps


def reduce(prof, kind: str, count: int, window_s: float,
           items_per_s: float, flops_per_item: float,
           shapes: dict) -> Trace:
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    ranges = {e.name() for e in events
              if e.device_type() != cuda and e.is_user_annotation()}
    device, host = [], []
    for e in events:
        if e.device_type() == cuda:
            if _annotation(e, ranges):
                continue  # a range drawn over the device's timeline
            device.append((e.name(), e.start_ns(), e.start_ns()
                           + e.duration_ns()))
        else:
            host.append((e.name(), e.start_ns(), e.start_ns()
                         + e.duration_ns()))
    busy_ns, gaps = _union([(s, e) for _, s, e in device])
    kernels = [(n, (e - s) * 1e-9) for n, s, e in device
               if not n.startswith(("Memcpy", "Memset"))]
    conv_ns = 0.0
    ops = CONV_OPS[kind]
    for evt in prof.events():
        if evt.name not in ops:
            continue
        parent, nested = evt.cpu_parent, False
        while parent is not None:
            nested = nested or parent.name in ops
            parent = parent.cpu_parent
        if nested:
            continue
        stack = [evt]
        while stack:
            x = stack.pop()
            conv_ns += sum(k.duration for k in x.kernels) * 1e3
            stack.extend(x.cpu_children)
    by_name = collections.defaultdict(float)
    for n, s, e in device:
        by_name[n[:120]] += (e - s) * 1e-9
    return Trace(
        kind=kind, count=count, window_s=window_s, busy_s=busy_ns * 1e-9,
        kernels=kernels, conv_s=conv_ns * 1e-9, items_per_s=items_per_s,
        flops_per_item=flops_per_item, shapes=shapes,
        breakdown={"device_ops": [[n, t] for n, t in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:TOP]],
            "idle_gaps": _idle_by_host(gaps, host)})


def _annotation(event, ranges) -> bool:
    """A user annotation (a record_function range such as the program's
    train_step#<n>) that the profiler also draws on the device's timeline:
    not device work. Torch versions differ in what they mark, so a device
    event named as a host range is one too."""
    return bool(event.is_user_annotation()) or event.name() in ranges


def _idle_by_host(gaps, host) -> List[list]:
    """The device's idle gaps summed by the innermost host operation that
    ran at each gap's middle ('no host operation' where none did); the
    ten largest."""
    if not gaps:
        return []
    starts = np.asarray([s for _, s, _ in host], np.int64)
    ends = np.asarray([e for _, _, e in host], np.int64)
    out: Dict[str, float] = collections.defaultdict(float)
    for s, e in gaps:
        mid = (s + e) // 2
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
        name = (host[inside[np.argmax(starts[inside])]][0][:120]
                if len(inside) else "no host operation")
        out[name] += (e - s) * 1e-9
    return [[n, t] for n, t in sorted(out.items(), key=lambda kv: -kv[1])
            [:TOP]]


def empty(kind: str, items_per_s: float, flops_per_item: float,
          shapes: dict) -> Trace:
    """A trace with nothing profiled (no device: the CPU tests)."""
    return Trace(kind, 0, 0.0, 0.0, [], 0.0, items_per_s, flops_per_item,
                 shapes, {"device_ops": [], "idle_gaps": []})


def kernel_seconds(trace: Trace, fragment: str) -> Optional[List[float]]:
    """Device seconds of each launch of the kernels whose name holds
    `fragment`, or None where none ran."""
    out = [t for n, t in trace.kernels if fragment in n]
    return out or None
