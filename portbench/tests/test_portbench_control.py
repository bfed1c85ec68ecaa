"""The control comes out not correct: the reference itself, computed in
the nearest precision below the configuration's (float32 with TF32 in
cuDNN and matmuls; the configurations state float32 with TF32 off), put in
the program's place and judged by each cell's comparison, fails at least
one of the cell's limits. On the card only (TF32 exists only there): run
with

    python -m pytest portbench/tests/test_portbench_control.py -m cuda

The cells run at their own sizes; a serving cell judges one request, a
training cell runs a window of 3 seconds before its step after the
window."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from portbench import calibrate, cells, harness

from .conftest import ROOT

CELLS = [w["name"] for w in cells.load_benchmark(ROOT)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [4000001001, 4000001002, 4000001003])
def test_the_control_is_not_correct(name, seed):
    if not torch.cuda.is_available():
        pytest.skip("TF32, the control's precision, exists only on the card")
    cell = cells.find_cell(name, ROOT)
    if cell.traffic["driver"] == "serve":
        cell = dataclasses.replace(
            cell, traffic=dict(cell.traffic, check_requests=1))
    readings = calibrate.control_readings(cell, seed, ROOT, seconds=3.0)
    checks = harness.judged(readings, harness.limits(cell))
    assert not harness.passes(checks), checks
