"""The port's tracing hooks (tfssd_torch.utils.profiling) and the
trainer's --profile and --debug-nans, on the CPU:

  * trace() writes a Chrome trace with step_annotation's ranges, also when
    the traced block raises;
  * check_finite() names the step and the first non-finite metric;
  * trainer.main --profile traces epoch 0 and only epoch 0, one
    "train_step#<step>" range per step;
  * trainer.main --debug-nans with an --init-lr that makes the second
    step's loss NaN raises FloatingPointError at step 1, and with
    --profile the trace is still written; without the flag the same run
    ends with NaN losses; the switch is restored after either run;
  * device_memory_stats() is {} without a card, as JAX's is for a backend
    that reports nothing.
"""

import json
import math
from pathlib import Path

import pytest
import torch

from tfssd_torch import trainer as ttrainer
from tfssd_torch.make_voc_drill import make_drill
from tfssd_torch.utils import profiling


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """torch at 2 threads for the module: the test runner's workers share
    the machine's cores, and a step at a thread per core in each of them
    oversubscribes the cores (and spins), so every worker slows. The
    comparisons here are between runs in one process, at one count."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    return make_drill(str(tmp_path_factory.mktemp("drill")), train=4,
                      test=2)


def _args(drill, tmp, *extra):
    return ["--dataset", "voc", "--data-root", drill, "--val-split", "test",
            "--device", "cpu", "--batch-size", "2", "--epochs", "1",
            "--log-every", "1", "--workers", "2", "--device-cache", "off",
            "--model-dir", str(tmp / "m"), "--log-dir", str(tmp / "l"),
            *extra]


def _trace_names(log_path):
    with open(Path(log_path) / profiling.TRACE_FILE) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_trace_keeps_annotations_and_is_written_when_the_block_raises(
        tmp_path):
    with pytest.raises(RuntimeError, match="inside"):
        with profiling.trace(str(tmp_path)):
            for step in range(2):
                with profiling.step_annotation("train_step", step):
                    torch.ones(4).sum()
            with profiling.step_annotation("other"):
                raise RuntimeError("inside the trace")
    names = _trace_names(tmp_path)
    assert {"train_step#0", "train_step#1", "other"} <= names


def test_check_finite_names_the_step_and_the_metric():
    ok = {"loss": torch.tensor(1.0), "grad_norm": torch.tensor(2.0),
          "num_pos": torch.tensor(float("nan"))}  # not a checked metric
    profiling.check_finite(ok, 3)
    bad = dict(ok, conf_loss=torch.tensor(float("inf")),
               grad_norm=torch.tensor(float("nan")))
    with pytest.raises(FloatingPointError, match="conf_loss.*step 7"):
        profiling.check_finite(bad, 7)


def test_profile_traces_each_step_of_the_first_epoch(drill, tmp_path):
    run = ttrainer.main(_args(drill, tmp_path, "--profile", "--epochs",
                              "2"))
    names = _trace_names(run.log_path)
    assert {"train_step#0", "train_step#1"} <= names
    assert not {"train_step#2", "train_step#3"} & names
    assert run.steps_run == 4


def test_debug_nans_raises_at_the_first_nan_and_the_trace_is_written(
        drill, tmp_path):
    # Adam moves every weight by ~lr in step 0, so at lr 1e30 step 1's
    # forward overflows
    with pytest.raises(FloatingPointError, match="non-finite loss.*step 1"):
        ttrainer.main(_args(drill, tmp_path, "--init-lr", "1e30",
                            "--debug-nans", "--profile"))
    assert not profiling.debug_nans_enabled()
    traces = list((tmp_path / "l").rglob(profiling.TRACE_FILE))
    assert len(traces) == 1
    assert "train_step#1" in _trace_names(traces[0].parent)


def test_without_debug_nans_the_diverging_run_goes_on(drill, tmp_path):
    profiling.enable_debug_nans(False)
    run = ttrainer.main(_args(drill, tmp_path, "--init-lr", "1e30"))
    losses = [m["loss"] for m in run.step_metrics]
    assert math.isfinite(losses[0]) and math.isnan(losses[1])
    assert run.steps_run == 2


def test_device_memory_stats_is_empty_without_a_card():
    if torch.cuda.is_available():
        stats = profiling.device_memory_stats()
        assert set(stats["cuda:0"]) == {"bytes_in_use", "peak_bytes_in_use",
                                        "bytes_limit"}
    else:
        assert profiling.device_memory_stats() == {}
