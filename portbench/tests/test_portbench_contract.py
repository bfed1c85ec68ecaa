"""The benchmark's contract, on the CPU: BENCHMARK.json's form, cells
found by name (one added from files alone), the last line's keys, the
window arithmetic, the roofline and MFU counters on hand-computed shapes,
and the refusals of portbench.run."""

from __future__ import annotations

import json
import math
import re
import shutil
import subprocess
import sys

import pytest

from portbench import cells, harness, peaks, run
from portbench import trace as tracing

from .conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
    assert len(BENCH["command"]) <= 32 and all(_line(w)
                                               for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert w["config"] in names
        assert NAME.match(w["traffic"])
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_metrics_follow_the_rules():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells_ = {w["name"] for w in BENCH["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m.get("workloads", cells_):
            assert w in cells_
            moved = e2e[m["moves"]]
            assert w in moved.get("workloads", cells_)
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    for w in cells_:
        cell = cells.find_cell(w, ROOT)
        assert "setup_s" in [m["name"] for m in cell.end_to_end]
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_every_cell_found_by_name():
    for w in BENCH["workloads"]:
        cell = cells.find_cell(w["name"], ROOT)
        assert cell.config["name"] == w["config"]
        assert cells.driver(cell.traffic).run
        for m in cell.per_layer:
            assert callable(cells.metric_reader(m["name"], ROOT))
    with pytest.raises(KeyError):
        cells.find_cell("no-such-cell", ROOT)


def test_a_cell_added_from_files_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    (tmp_path / "portbench" / "traffic" / "serve-b8-pool64.json").write_text(
        json.dumps({"driver": "serve", "batch": 8, "pool": 64,
                    "warmup_requests": 3, "profile_requests": 20,
                    "keep_share": 0.125, "keep_slots": 256,
                    "check_requests": 4, "check_chunk": 8,
                    "limits": {"det_gap": 5e-5}}))
    (tmp_path / "portbench" / "metrics" / "host_share.serve.py").write_text(
        "def read(trace):\n    return 42.0\n")
    bench["workloads"].append({"name": "mbv2-serve-b8",
                               "config": "ssd300-mobilenetv2",
                               "traffic": "serve-b8-pool64", "chips": 1,
                               "why": "launch-bound latency"})
    for m in bench["end_to_end"]:
        if m["name"] in ("serve_img_per_s", "serve_ms_p95"):
            m["workloads"].append("mbv2-serve-b8")
    bench["per_layer"].append({"name": "host_share.serve", "unit": "%",
                               "better": "lower", "source": "device_trace",
                               "layer": "device", "moves": "serve_img_per_s",
                               "workloads": ["mbv2-serve-b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.find_cell("mbv2-serve-b8", tmp_path)
    assert cell.traffic["batch"] == 8 and cell.config["anchors"] == 2268
    # the traffic file's limits over the configuration's
    assert harness.limits(cell) == {"det_gap": 5e-5, "sel_gap": 1e-5}
    assert [m["name"] for m in cell.per_layer] == ["host_share.serve"]
    t = tracing.empty("serve", 1.0, 1.0, {})
    assert cells.read_metrics(cell, t, tmp_path) == {
        "host_share.serve": {"value": 42.0, "unit": "%"}}
    # the cells already there are unchanged
    old = cells.find_cell("mbv2-serve-b64", tmp_path)
    assert "host_share.serve" not in [m["name"] for m in old.per_layer]


def test_last_line_keys():
    cell = cells.find_cell("mbv2-serve-b64", ROOT)
    outcome = harness.Outcome(
        correct=True, attempted=10, failed=0,
        end_to_end={"serve_img_per_s": 100.0, "serve_ms_p95": math.inf,
                    "setup_s": 9.5},
        checks={"det_gap": {"value": 1e-6, "limit": 1e-4}},
        memory_peak_bytes=123, trace=None)
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
              "memory_peak_bytes": 123}
    line = run.finite(run.result_line(cell, outcome, False, device))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["metrics"]["serve_ms_p95"] == {"value": None, "unit": "ms"}
    assert line["metrics"]["setup_s"] == {"value": 9.5, "unit": "s"}
    json.loads(json.dumps(line))
    t = tracing.Trace("serve", 20, 1.0, 0.9, [("nms_keep_kernel", 5e-5)] * 20,
                      0.5, 3000.0, 2.0e9, {"keep_r": 1280, "keep_k": 200},
                      {"device_ops": [["conv", 0.5]], "idle_gaps": []})
    outcome.trace = t
    line = run.result_line(cell, outcome, True, dict(device, busy_s=0.9,
                                                     window_s=1.0))
    assert list(line)[-2:] == ["breakdown", "checks"]
    assert set(line["metrics"]) == {m["name"] for m in cell.per_layer}


def test_window_rate_and_p95():
    assert harness.window_rate(640, 2.0) == 320.0
    lat = [0.02] * 99 + [0.5]           # one stall among 100 requests
    assert harness.p95(lat) == pytest.approx(0.02)
    lat = [0.02] * 90 + [0.5] * 10      # the stall is the tail
    assert harness.p95(lat) == pytest.approx(0.5)
    lat = [0.01 * i for i in range(1, 21)]
    assert harness.p95(lat) == pytest.approx(0.1905)
    assert math.isinf(harness.p95([0.02] * 90 + [math.inf] * 10))
    assert harness.p95([0.02] * 99 + [math.inf]) == pytest.approx(0.02)


def test_roofline_and_mfu_counters():
    # R = 1,280 instances of K = 200: 1280 * 19900 pairs * 15 operations
    t, by = peaks.keep_bound_s(1280, 200)
    assert by == "operations"
    assert t == pytest.approx(1280 * 19900 * 15 / 67e12)
    t, by = peaks.match_bound_s(24564, 32, 64, 112)
    assert by == "bytes"
    assert t == pytest.approx((24564 * 16 + 32 * 64 * 20 + 32 * 24564 * 20)
                              / 3.35e12)
    shapes = {"keep_r": 1280, "keep_k": 200}
    calls = [("nms_keep_kernel", 50e-6), ("nms_keep_kernel", 40e-6),
             ("cudnn_conv", 1e-3)]
    trace = tracing.Trace("serve", 2, 0.05, 0.04, calls, 1e-3, 3000.0,
                          2.0e9, shapes, {})
    read = {m: cells.metric_reader(m, ROOT) for m in (
        "nms_keep_roofline", "mfu.serve", "launches.serve",
        "device_idle.serve", "conv_ms.serve", "mfu.train",
        "match_encode_roofline")}
    bound = 1280 * 19900 * 15 / 67e12
    assert read["nms_keep_roofline"](trace) == pytest.approx(
        100 * bound / 45e-6)
    assert read["mfu.serve"](trace) == pytest.approx(100 * 2e9 * 3000 / 67e12)
    assert read["launches.serve"](trace) == 1.5
    assert read["device_idle.serve"](trace) == pytest.approx(20.0)
    assert read["conv_ms.serve"](trace) == pytest.approx(0.5)
    assert read["mfu.train"](trace) is None
    assert read["match_encode_roofline"](trace) is None
    assert read["nms_keep_roofline"](tracing.Trace(
        "serve", 2, 0.05, 0.04, [("cudnn_conv", 1e-3)], 0, 1, 1, shapes,
        {})) is None


def test_run_refuses_without_a_card_or_the_program(tmp_path):
    cmd = [sys.executable, "-m", "portbench.run", "--workload",
           "mbv2-serve-b64", "--seed", "3", "--seconds", "1"]
    import torch

    if not torch.cuda.is_available():
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=120)
        assert p.returncode == 2 and p.stdout.strip() == ""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_traced_stretch_reduces():
    calls = [("k", 0, 10), ("k", 20, 30), ("Memcpy HtoD", 25, 40)]
    busy, gaps = tracing._union([(s, e) for _, s, e in calls])
    assert busy == 30 and gaps == [(10, 20)]
    idle = tracing._idle_by_host(gaps, [("aten::sort", 5, 25),
                                        ("outer", 0, 100)])
    assert idle == [["aten::sort", 10e-9]]


def test_program_config_must_match_the_file():
    from tfssd_torch import get_hyper_params

    cfg = cells.find_cell("ssd512-train-b32", ROOT).config
    harness.check_program_config(get_hyper_params("vgg16_512"), cfg)
    with pytest.raises(ValueError, match="nms_prefilter_anchors"):
        harness.check_program_config(get_hyper_params(
            "vgg16_512", nms_prefilter_anchors=0), cfg)
    with pytest.raises(ValueError, match="img_size"):
        harness.check_program_config(get_hyper_params("mobilenet_v2"), cfg)
