"""Shared fixtures of the benchmark's own tests: a cell of BENCHMARK.json
cut to a few images and a one-second window, run on the CPU through the
same drivers (the harness itself refuses the CPU; these drive the layers
under it)."""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import pytest
import torch

from portbench import cells, harness

ROOT = Path(__file__).resolve().parents[2]

SMALL = {"serve": dict(batch=2, pool=4, check_requests=2, check_chunk=2,
                       profile_requests=1, keep_share=1.0),
         "train": dict(batch=2, pool=4, warmup_steps=3, profile_steps=1)}


def small_cell(name: str):
    cell = cells.find_cell(name, ROOT)
    traffic = dict(cell.traffic, **SMALL[cell.traffic["driver"]])
    return dataclasses.replace(cell, traffic=traffic)


def cpu_run(cell, seed: int = 3, seconds: float = 0.5, trace: bool = False):
    ctx = harness.Context(cell=cell, seed=seed, seconds=seconds, trace=trace,
                          device="cpu", root=ROOT,
                          started=time.perf_counter())
    return cells.driver(cell.traffic).run(ctx)


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)
