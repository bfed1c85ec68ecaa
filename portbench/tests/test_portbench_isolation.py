"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Each set of modules is imported in
a fresh interpreter and sys.modules is compared by top-level name (the
part before the first dot), whole: the program's name, tfssd_torch, begins
with the JAX package's."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

from .conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "tfssd_tpu"}
PORTBENCH = ROOT / "portbench"

# What a run imports: the entry point, every driver with the program's
# modules it imports when it runs, every metric reader, the calibration.
HARNESS = """
import glob, json, os, sys
import portbench.run, portbench.calibrate, portbench.cells as cells
import portbench.drivers.serve, portbench.drivers.train
from tfssd_torch import predict, get_hyper_params
from tfssd_torch.models.decoder import make_predict_fn
from tfssd_torch.ops.boxes import generate_anchors
from tfssd_torch.train import (create_train_state, make_cached_train_step,
                               make_lr_schedule)
from tfssd_torch.utils.convert import load_variables
for path in glob.glob('portbench/metrics/*.py'):
    cells.metric_reader(os.path.basename(path)[:-3])
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""

REFERENCE = """
import json, sys
import portbench.reference.ssd, portbench.reference.detect
import portbench.reference.train, portbench.data, portbench.peaks
import portbench.ckpt.orbax
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    loaded = _top_level(HARNESS)
    assert "tfssd_torch" in loaded and "portbench" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level(REFERENCE)
    assert not loaded & (FORBIDDEN | {"tfssd_torch"}), loaded


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_under_the_benchmark_names_jax():
    for path in PORTBENCH.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path
    for sub in ("reference", "ckpt"):
        for path in (PORTBENCH / sub).rglob("*.py"):
            assert "tfssd_torch" not in _imports(path), path
    for path in (PORTBENCH / "data.py", PORTBENCH / "peaks.py"):
        assert "tfssd_torch" not in _imports(path), path
