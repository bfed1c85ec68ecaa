"""A run with the program's timed path broken underneath comes out not
correct: each fault a cell can have (portbench/faults.py), planted in the
program for the test, driven through the same driver as a run on the CPU
at a few images; and the sound run comes out correct. The same faults are
read on the card at the cells' own sizes by `portbench.calibrate
--fault`."""

from __future__ import annotations

import pytest

from portbench import faults

from .conftest import cpu_run, small_cell


@pytest.mark.parametrize("fault", [None, *faults.SERVE])
def test_serving_faults_are_not_correct(monkeypatch, fault):
    if fault is not None:
        faults.FAULTS[fault](monkeypatch.setattr)
    out = cpu_run(small_cell("mbv2-serve-b64"))
    assert out.attempted >= 2
    assert out.correct is (fault is None), out.checks


@pytest.mark.parametrize("fault", [None, *faults.TRAIN])
def test_training_faults_are_not_correct(monkeypatch, fault):
    if fault is not None:
        faults.FAULTS[fault](monkeypatch.setattr)
    out = cpu_run(small_cell("ssd512-train-b32"))
    assert out.correct is (fault is None), out.checks


def test_a_fault_from_the_window_on_is_not_correct(monkeypatch):
    """A fault that starts only once the warm-up's steps are done (as a
    path switched on after some calls would) is seen by the step after
    the window."""
    import tfssd_torch.train as port_train

    cell = small_cell("ssd512-train-b32")
    original = port_train.apply_gradients

    def later(state):
        if state.step < cell.traffic["warmup_steps"]:
            original(state)
        else:
            state.step += 1

    monkeypatch.setattr(port_train, "apply_gradients", later)
    out = cpu_run(cell)
    assert out.checks["change_gap"]["value"] <= out.checks["change_gap"][
        "limit"], out.checks
    assert not out.correct, out.checks
