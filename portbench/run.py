"""Run one cell of BENCHMARK.json once, in this process, on the card:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

It finds the cell's configuration, traffic mix and metrics by name
(cells.py), runs the traffic's driver (drivers/<driver>.py): set-up from
the seed, a warm-up of the cell's own shapes, a window of --seconds, and
with --trace 1 a profiled stretch after it; then the reference judges what
the window produced. It prints each number compared beside its limit as
the last lines of standard error, and as the last line of standard output
one JSON object: correct, attempted, failed, metrics (--trace 0: the
cell's end-to-end metrics; --trace 1: its per-layer metrics), device
(with --trace 1 also busy_s and window_s), with --trace 1 a breakdown,
and last the checks. It exits 0 only when the run was correct. With no
card, or fewer cards than the cell asks for, it exits 2 and prints no
result; so it does when the JAX package or JAX is loaded in this process
once the window has closed. It never falls back to the CPU.

The program's build caches go to build/ inside the checkout, at fixed
paths (the port builds its kernels into build/tfssd_torch/ itself).
"""

from __future__ import annotations

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tfssd_tpu")


def process_age() -> float:
    """Seconds since this process started (Linux; 0 where unknown)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


# the host clock (time.perf_counter) at this process's start
STARTED = _STARTED - process_age()


def set_cache_dirs(root: Path) -> None:
    build = root / "build" / "portbench"
    for var, sub in (("CUDA_CACHE_PATH", "nv"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(build / sub)


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> float:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return math.nan


def fail(message: str) -> None:
    print(f"portbench: {message}", file=sys.stderr, flush=True)
    sys.exit(2)


def finite(x):
    """The line with every infinite or NaN number as null (JSON has none)."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    return x


def result_line(cell, outcome, trace_on: bool, device: dict) -> dict:
    from portbench import cells

    if trace_on:
        metrics = cells.read_metrics(cell, outcome.trace) \
            if outcome.trace is not None else {}
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in outcome.end_to_end.items() if k in units}
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": device}
    if trace_on and outcome.trace is not None:
        line["breakdown"] = outcome.trace.breakdown
    line["checks"] = outcome.checks
    return line


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    set_cache_dirs(ROOT)
    from portbench import cells, harness

    try:
        cell = cells.find_cell(args.workload, ROOT)
    except (OSError, KeyError, ValueError) as e:
        fail(f"cannot read the cell: {e}")
    if not (ROOT / "tfssd_torch" / "__init__.py").is_file():
        fail("the program (tfssd_torch/) is not in this checkout")
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is available; the benchmark runs on the card "
             "only")
    if torch.cuda.device_count() < cell.chips:
        fail(f"the cell needs {cell.chips} cards, "
             f"{torch.cuda.device_count()} are visible")
    ctx = harness.Context(cell=cell, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device="cuda",
                          root=ROOT, started=STARTED)
    outcome = cells.driver(cell.traffic).run(ctx)
    found = loaded_forbidden()
    if found:
        fail(f"loaded in this process: {found}")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": int(outcome.memory_peak_bytes),
              "power_limit_w": power_limit()}
    if args.trace and outcome.trace is not None:
        device["busy_s"] = outcome.trace.busy_s
        device["window_s"] = outcome.trace.window_s
    line = result_line(cell, outcome, bool(args.trace), device)
    print("timings " + json.dumps(outcome.timings), file=sys.stderr)
    for name, c in outcome.checks.items():
        held = "not held" if c["limit"] is None else f"limit {c['limit']!r}"
        print(f"check {name} {c['value']!r} {held}", file=sys.stderr)
    print(f"correct {outcome.correct}", file=sys.stderr, flush=True)
    print(json.dumps(finite(line)), flush=True)
    sys.exit(0 if outcome.correct else 1)


if __name__ == "__main__":
    main()
