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
    that reports nothing;
  * the spans: under a profiler one predict records `predict` with its six
    stages under it and one cached train step `train_step` with its seven,
    each sharing the outer span's id, and the counter of real gts equals
    the augmented batch's; each recorded host interval lies inside its
    profiler range (the shared clock); with no profiler nothing is
    recorded and no range opened; the flag is the profiler's own;
    `--profile` writes spans.json; the benchmark's span readers turn a
    known store into per-request and per-step numbers; the counter of
    fc6's GEMM (conv/atrous_gemm) reads 1 in an SSD300-VGG16 predict and
    0 in its train step and in a MobileNetV2 predict; a RetinaNet predict
    at a small preset records `trunk`, `fpn` and `head` under `forward`,
    its selection's stages, and the counter `select/candidates`;
  * on the card (cuda): a predict's stages partition its device time, and
    `keep` holds the nms_keep kernel.
"""

import functools
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from tfssd_torch import get_hyper_params
from tfssd_torch import trainer as ttrainer
from tfssd_torch.data.augment import augment_batch
from tfssd_torch.make_voc_drill import make_drill
from tfssd_torch.models.decoder import make_predict_fn
from tfssd_torch.models.ssd import get_model, init_random_weights
from tfssd_torch.ops.boxes import generate_anchors
from tfssd_torch.train import (augment_seed, create_train_state,
                               make_cached_train_step, make_lr_schedule)
from tfssd_torch.utils import profiling

TINY = dict(img_size=64, feature_map_shapes=(4, 2, 1, 1, 1, 1),
            total_labels=6, max_gt_boxes=4)
PREDICT_STAGES = ("preprocess", "forward", "decode", "select", "keep",
                  "merge")
TRAIN_STAGES = ("gather", "augment", "match", "forward", "loss", "backward",
                "adam")


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


@pytest.fixture
def spans():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _tiny_predict():
    cfg = get_hyper_params("mobilenet_v2", **TINY)
    model = init_random_weights(get_model(cfg), 0).eval()
    return make_predict_fn(model, generate_anchors(cfg), cfg)


def _tiny_train():
    """(step, state, staged data, its rows) at TINY: 4 scenes with 1-4
    real gts each, batch 4."""
    cfg = get_hyper_params("mobilenet_v2", **TINY)
    rng = np.random.default_rng(0)
    lo = rng.uniform(0.0, 0.5, (4, 4, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(0.2, 0.5, (4, 4, 2))], -1)
    labels = np.array([[1, 2, 0, 0], [3, 0, 0, 0], [1, 2, 3, 4],
                       [5, 5, 5, 0]], np.int32)
    data = {"image": torch.from_numpy(rng.integers(
                0, 256, (4, 64, 64, 3), dtype=np.uint8)),
            "boxes": torch.from_numpy(boxes.astype(np.float32)),
            "labels": torch.from_numpy(labels)}
    state = create_train_state(cfg, 0, "cpu", make_lr_schedule(1))
    step = make_cached_train_step(torch.from_numpy(generate_anchors(cfg)),
                                  cfg, augment=True, seed=5)
    return step, state, data, torch.arange(4)


def _ranges(prof):
    """(name, start ns, end ns) of the profiler's host ranges."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()]


def _inside_its_range(records, ranges):
    """Each record's host interval inside the profiler range of its name
    (the n-th of that name), within 100 us."""
    slack = 100_000
    for r in records:
        same = sorted(x for x in ranges if x[0] == r["name"]
                      or x[0].startswith(r["name"] + "#"))
        n = [q["name"] for q in sorted(records, key=lambda q: q[
            "host_start_ns"]) if q["name"] == r["name"]].index(r["name"])
        _, start, end = same[n]
        assert start - slack <= r["host_start_ns"] <= r["host_end_ns"] \
            <= end + slack, (r, start, end)


def test_the_flag_is_the_profilers(spans, monkeypatch):
    assert not profiling.recording()
    with _cpu_profile():
        assert profiling.recording()
        assert torch._C._autograd._profiler_enabled()
    assert not profiling.recording()
    import torch.autograd.profiler as autograd_profiler

    if hasattr(autograd_profiler, "_is_profiler_enabled"):
        # the cheap read, where torch has it: a module attribute that the
        # profiler sets, no call into C++
        monkeypatch.setattr(autograd_profiler, "_is_profiler_enabled", True)
        assert profiling.recording()


def test_a_predict_records_its_stages_under_predict(spans):
    predict = _tiny_predict()
    x = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8)
    predict(x)                                   # call 0, no profiler
    with _cpu_profile() as prof:
        predict(x)                               # call 1
    records = profiling.span_records()
    assert [r["name"] for r in records] == [*PREDICT_STAGES, "predict"]
    assert records[-1]["parent"] is None
    assert all(r["parent"] == "predict" for r in records[:-1])
    assert {r["id"] for r in records} == {1}
    _inside_its_range(records, _ranges(prof))
    summary = profiling.span_summary()
    assert summary["spans"]["predict"]["calls"] == 1
    assert summary["spans"]["keep"]["device_s"] is None      # no card
    assert summary["spans"]["predict"]["host_s"] >= sum(
        summary["spans"][k]["host_s"] for k in PREDICT_STAGES)


def test_a_cached_train_step_records_its_stages_and_real_gts(spans):
    step, state, data, rows = _tiny_train()
    step(state, data, rows)                      # step 0, no profiler
    with _cpu_profile() as prof:
        step(state, data, rows)                  # step 1
    records = profiling.span_records()
    assert [r["name"] for r in records] == [*TRAIN_STAGES, "train_step"]
    assert all(r["parent"] == "train_step" for r in records[:-1])
    assert {r["id"] for r in records} == {1}
    _inside_its_range(records, _ranges(prof))
    assert "train_step#1" in {n for n, _, _ in _ranges(prof)}
    gen = torch.Generator()
    gen.manual_seed(augment_seed(5, 1))
    _, _, labels = augment_batch(gen, data["image"].float() / 255.0,
                                 data["boxes"], data["labels"])
    real = int((labels > 0).sum())
    assert 0 < real
    assert profiling.span_summary()["counters"] == {"match/real_gts": real}


@pytest.mark.parametrize("backbone,call,want", [
    ("vgg16", "predict", 1), ("vgg16", "train_step", 0),
    ("mobilenet_v2", "predict", 0)])
def test_the_atrous_gemm_counter(spans, backbone, call, want):
    # SSD300-VGG16 at 260 pixels, the smallest whose VALID extras reach
    # 1x1: fc6 is its one dilated convolution
    small = TINY if backbone == "mobilenet_v2" else dict(
        TINY, img_size=260, feature_map_shapes=(33, 17, 9, 5, 3, 1))
    cfg = get_hyper_params(backbone, **small)
    images = torch.zeros((1, cfg.img_size, cfg.img_size, 3),
                         dtype=torch.uint8)
    if call == "train_step":
        data = {"image": images,
                "boxes": torch.tensor([[[0.1, 0.1, 0.6, 0.5]] * 4]),
                "labels": torch.tensor([[1, 0, 0, 0]], dtype=torch.int32)}
        state = create_train_state(cfg, 0, "cpu", make_lr_schedule(1))
        step = make_cached_train_step(torch.from_numpy(generate_anchors(
            cfg)), cfg, augment=False, seed=0)
        run = functools.partial(step, state, data, torch.arange(1))
    else:
        model = init_random_weights(get_model(cfg), 0).eval()
        run = functools.partial(make_predict_fn(
            model, generate_anchors(cfg), cfg), images)
    with _cpu_profile():
        run()
    summary = profiling.span_summary()
    assert summary["spans"][call]["calls"] == 1
    assert summary["counters"].get("conv/atrous_gemm", 0) == want


def test_a_retinanet_predict_records_its_model_stages_and_candidates(
        spans):
    # 128 pixels, 32 groups, narrow widths, 7 classes; each level's top 40
    cfg = get_hyper_params(
        "retinanet_rx50fpn_800", img_size=128,
        feature_map_shapes=(16, 8, 4, 2, 1), stem_channels=8,
        stage_widths=(32, 32, 64, 64), stage_channels=(16, 32, 32, 64),
        fpn_channels=16, num_classes=7, topk_candidates=40)
    model = init_random_weights(get_model(cfg), 0).eval()
    predict = make_predict_fn(model, generate_anchors(cfg), cfg)
    x = torch.randint(0, 256, (2, 128, 128, 3), dtype=torch.uint8)
    with _cpu_profile():
        res = predict(x)
    records = profiling.span_records()
    assert [r["name"] for r in records] == [
        "preprocess", "trunk", "fpn", "head", "forward", "select", "decode",
        "keep", "merge", "predict"]
    parents = {r["name"]: r["parent"] for r in records}
    assert {parents[k] for k in ("trunk", "fpn", "head")} == {"forward"}
    assert parents["forward"] == parents["keep"] == "predict"
    # 5 levels x 40 pairs an image, those above 0.05
    counters = profiling.span_summary()["counters"]
    cands = counters["select/candidates"]
    assert 0 < cands <= 2 * 5 * 40
    assert int(res.valid.sum()) <= cands
    # the keep walks one row of up to 256 for each (image, class) that
    # holds a candidate: at most 7 classes an image here
    assert 0 < counters["keep/rows"] <= min(cands, 2 * 7)


def test_without_a_profiler_nothing_is_recorded_and_no_range_opened(
        spans, monkeypatch):
    opened = []
    real_range = torch.profiler.record_function

    def counting(*args, **kwargs):
        opened.append(args)
        return real_range(*args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    _tiny_predict()(torch.zeros((1, 64, 64, 3), dtype=torch.uint8))
    step, state, data, rows = _tiny_train()
    step(state, data, rows)
    assert opened == [] and profiling.span_records() == []
    assert profiling.span_summary() == {"spans": {}, "counters": {}}
    assert profiling.span("a") is profiling.span("b", 3) is \
        profiling.step_annotation("train_step", 0)
    profiling.count("x", 1)
    assert profiling.span_summary()["counters"] == {}


def test_profile_writes_the_span_summary(drill, tmp_path):
    run = ttrainer.main(_args(drill, tmp_path, "--profile"))
    summary = json.loads((Path(run.log_path) / profiling.SPANS_FILE)
                         .read_text())
    # the streamed feed: no gather
    assert summary["spans"]["train_step"]["calls"] == 2
    for stage in TRAIN_STAGES[1:]:
        assert summary["spans"][stage]["calls"] == 2
    assert summary["counters"]["match/real_gts"] > 0


SERVE_READERS = {f"{s}_ms.serve": s for s in PREDICT_STAGES}
TRAIN_READERS = {f"{s}_ms.train": s for s in TRAIN_STAGES}


def test_the_benchmarks_span_readers(monkeypatch):
    from portbench import cells
    from portbench import trace as tracing

    known = {"spans": {"predict": {"calls": 4, "host_s": 0.1,
                                   "device_s": 0.09},
                       "decode": {"calls": 4, "host_s": 0.01,
                                  "device_s": 0.008},
                       "train_step": {"calls": 4, "host_s": 2.0,
                                      "device_s": 1.9},
                       "adam": {"calls": 4, "host_s": 0.02,
                                "device_s": 0.04}},
             "counters": {"match/real_gts": 300}}
    monkeypatch.setattr(profiling, "span_summary", lambda: known)
    serve = tracing.Trace("serve", 4, 0.1, 0.09, [], 0.05, 1.0, 1.0, {}, {})
    train = tracing.Trace("train", 4, 2.0, 1.9, [], 1.5, 1.0, 1.0,
                          {"batch": 32}, {})
    read = {m: cells.metric_reader(m) for m in [
        *SERVE_READERS, *TRAIN_READERS, "predict_host_ms.serve",
        "step_host_ms.train", "match_gts.train"]}
    assert read["decode_ms.serve"](serve) == pytest.approx(2.0)
    assert read["predict_host_ms.serve"](serve) == pytest.approx(25.0)
    assert read["adam_ms.train"](train) == pytest.approx(10.0)
    assert read["step_host_ms.train"](train) == pytest.approx(500.0)
    assert read["match_gts.train"](train) == pytest.approx(300 / 128)
    # a span the stretch never entered reads 0
    assert read["keep_ms.serve"](serve) == 0.0
    assert read["gather_ms.train"](train) == 0.0
    # none where nothing was profiled, or in the other kind of cell
    for name, reader in read.items():
        kind = "serve" if name.endswith(".serve") else "train"
        assert reader(tracing.empty(kind, 1.0, 1.0, {"batch": 32})) is None
        assert reader(train if kind == "serve" else serve) is None


@pytest.mark.cuda
def test_on_the_card_the_stages_partition_a_predict(spans):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = get_hyper_params("mobilenet_v2")
    model = init_random_weights(get_model(cfg), 0).to("cuda").eval()
    predict = make_predict_fn(model, generate_anchors(cfg), cfg)
    x = torch.randint(0, 256, (64, 300, 300, 3), dtype=torch.uint8,
                      device="cuda")
    for _ in range(3):
        predict(x)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        predict(x)       # a profiler's first ranges take longer to open
        torch.cuda.synchronize()
        profiling.reset_spans()
        for _ in range(3):
            predict(x)
        torch.cuda.synchronize()
    spans = profiling.span_summary()["spans"]
    whole = spans["predict"]["device_s"]
    stages = sum(spans[k]["device_s"] for k in PREDICT_STAGES)
    assert spans["predict"]["calls"] == 3
    assert abs(stages - whole) <= 0.03 * whole, (stages, whole)
    cuda = torch.autograd.DeviceType.CUDA
    kernel_ns = [e.duration_ns()
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == cuda and "nms_keep" in e.name()
                 and not e.is_user_annotation()]
    assert len(kernel_ns) == 4
    assert 1e-9 * sum(kernel_ns) / 4 <= spans["keep"]["device_s"] / 3, (
        kernel_ns, spans)
