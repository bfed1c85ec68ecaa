"""The readings that a cell's correctness limits are set from, on the card:

    python3 -m portbench.calibrate --workload <name> --seeds 1 2 ... \
        [--control-seeds 7 8 9] [--seconds 3] [--fault <name>]

For each of --seeds, a whole run of the cell's driver with a window of
--seconds (the program's readings: the lower ones; with --fault, the
readings of that fault of portbench/faults.py planted in the program);
for each of --control-seeds, the control in the program's place: the
reference itself computed in the nearest precision below the
configuration's (float32 with TF32), judged by the same comparison (the
upper ones; a train cell's control runs the program through its window
first, for the state the step after it starts from). One JSON line per
reading, then the largest program reading and the smallest control
reading of each number. The limits live in the configuration's file
(`limits`), set between the two by PERF.md's rule.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from portbench import cells, faults, harness
from portbench.drivers import serve, train


def context(cell, seed: int, seconds: float, root: Path) -> harness.Context:
    return harness.Context(cell=cell, seed=seed, seconds=seconds,
                           trace=False, device="cuda", root=root,
                           started=time.perf_counter())


def program_readings(cell, seed: int, seconds: float, root: Path) -> dict:
    out = cells.driver(cell.traffic).run(context(cell, seed, seconds, root))
    return {k: c["value"] for k, c in out.checks.items()}


def control_readings(cell, seed: int, root: Path,
                     seconds: float = 3.0) -> dict:
    """The control's numbers for `seed`: the same inputs as a run of that
    seed, the reference in float32 with TF32 in the program's place."""
    ctx = context(cell, seed, seconds, root)
    cfg, traffic = cell.config, cell.traffic
    if traffic["driver"] == "serve":
        tree = serve.load_weights(ctx, cfg)
        pool = serve.image_pool(ctx, cfg, traffic)
        n = len(pool) // traffic["batch"]
        return serve.check(ctx, cfg, traffic, tree, pool,
                           [(i, None) for i in range(n)], control=True)
    out = train.run(ctx, control=True)
    return {k: c["value"] for k, c in out.checks.items()}


def plant(name: str):
    """Plant fault `name` in the program; returns what undoes it."""
    undo = []

    def patch(owner, attr, value):
        undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    faults.FAULTS[name](patch)
    return lambda: [setattr(*u) for u in reversed(undo)]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = p.parse_args(argv)
    from portbench.run import ROOT, set_cache_dirs

    set_cache_dirs(ROOT)
    cell = cells.find_cell(args.workload, ROOT)

    def read(kind: str, seeds, fn) -> dict:
        got = {}
        for s in seeds:
            t0 = time.perf_counter()
            r = fn(s)
            print(json.dumps({"workload": cell.name, "kind": kind,
                              "seed": s, "readings": r,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
            for k, v in r.items():
                got.setdefault(k, []).append(v)
        return got

    undo = plant(args.fault) if args.fault else (lambda: None)
    lower = read(f"fault:{args.fault}" if args.fault else "program",
                 args.seeds, lambda s: program_readings(
                     cell, s, args.seconds, ROOT))
    undo()
    upper = read("control", args.control_seeds, lambda s: control_readings(
        cell, s, ROOT, args.seconds))
    print(json.dumps({"workload": cell.name,
                      "lower": {k: max(v) for k, v in lower.items()},
                      "upper": {k: min(v) for k, v in upper.items()},
                      "card": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
