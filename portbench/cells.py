"""BENCHMARK.json and the files it names, found by name: a cell's
configuration (the file its `configs` entry names), its traffic mix
(portbench/traffic/<traffic>.json, which names the driver module that runs
that kind of traffic, portbench/drivers/<driver>.py) and its per-layer
metrics (portbench/metrics/<metric>.py, one reader each). A cell, a
configuration, a traffic mix or a metric is added by adding its files and
its entries; nothing here lists them.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    run_seconds: int


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT,
              bench: Optional[dict] = None) -> Cell:
    """The workload `name` of `root`/BENCHMARK.json with its files read."""
    bench = bench if bench is not None else load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(root / "portbench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _reports(m, name) and m["moves"] in moved]
    return Cell(name, w["chips"], config, traffic, e2e, layer,
                bench["run_seconds"])


def driver(traffic: dict):
    """The module that runs this kind of traffic."""
    return importlib.import_module(f"portbench.drivers.{traffic['driver']}")


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """read(trace) -> value or None, from portbench/metrics/<name>.py."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}",
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(cell: Cell, trace, root: Path = ROOT) -> Dict[str, dict]:
    """The cell's per-layer metrics that find something to read."""
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"], root)(trace)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
