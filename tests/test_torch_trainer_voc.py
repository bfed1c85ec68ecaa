"""The port's training CLI on VOC directories (tfssd_torch.trainer) against
the JAX package's trainer.py and data/loader.py, on a drill tree of 8
trainval and 4 test images at 300x300 (tfssd_torch.make_voc_drill):

  * the drill tree equals tools/make_voc_drill.py's, file for file;
  * shuffled, parallel-decoded, padded batches and their super-batches
    (batch_examples, stack_batches) equal JAX's byte for byte;
  * trainer.main at batch 2, 2 epochs of 2 steps: the streamed feed
    (--device-cache off), the device cache (on) and --steps-per-call 2
    give the same step metrics, validation losses, final parameters,
    BatchNorm statistics and Adam state, bit for bit (the same batches in
    the same order; on the CPU the same operations give the same bits),
    and the sidecar records steps_per_call;
  * the device-cache, clamp and floor messages are JAX's, evaluated from
    trainer.py's own f-strings;
  * two --data-root's concatenate and validation reads the first, as
    JAX's make_datasets; --dataset voc without a root exits with JAX's
    message;
  * stage_arrays holds a decoded dataset once: its host peak (tracemalloc)
    on 32 drill images stays under 1.5x the arrays it returns (1.127x
    measured; listing the examples and collating a copy read 2.000x);
  * every option of trainer.py's parser exists in the port's with the
    same default, --port-h5 included since the port reads Keras files,
    except --dataset (the port's default is synthetic).
"""

import ast
import importlib.util
import itertools
import json
import sys
import tracemalloc
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from tfssd_torch import trainer as ttrainer  # noqa: E402
from tfssd_torch.data import loader as tloader  # noqa: E402
from tfssd_torch.data.voc import VOCDataset as TVOC  # noqa: E402
from tfssd_torch.make_voc_drill import make_drill  # noqa: E402
from tfssd_tpu.data import loader as jloader  # noqa: E402
from tfssd_tpu.data.voc import VOCDataset as JVOC  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARRAYS = ("image", "boxes", "labels", "difficult")


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
    return make_drill(str(tmp_path_factory.mktemp("drill")), train=8,
                      test=4)


def _jax_trainer_source():
    return ast.parse((ROOT / "trainer.py").read_text())


def test_drill_tree_equals_the_tools(drill, tmp_path, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "make_voc_drill_tool", ROOT / "tools" / "make_voc_drill.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(sys, "argv", ["make_voc_drill.py", "--out",
                                      str(tmp_path), "--train", "8",
                                      "--test", "4"])
    tool.main()
    got, want = Path(drill), tmp_path / "VOC2007"
    files = sorted(p.relative_to(want) for p in want.rglob("*")
                   if p.is_file())
    assert len(files) == 2 * 12 + 2
    assert files == sorted(p.relative_to(got) for p in got.rglob("*")
                           if p.is_file())
    for rel in files:
        assert (got / rel).read_bytes() == (want / rel).read_bytes(), rel


def _equal_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for k in ARRAYS:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert g["ids"] == w["ids"]
        assert g["num_valid"] == w["num_valid"]


def test_shuffled_batches_and_super_batches_equal_jax(drill):
    tds = TVOC(drill, "trainval", image_size=300)
    jds = JVOC(drill, "trainval", image_size=300)
    kw = dict(shuffle_seed=10_001, workers=3, drop_remainder=False)
    # 8 images at batch 3: the last batch holds 2 and is padded
    _equal_batches(tloader.batch_examples(tds, 3, 64, **kw),
                   jloader.batch_examples(jds, 3, 64, **kw))
    _equal_batches(
        tloader.stack_batches(tloader.batch_examples(tds, 2, 64, **kw), 3),
        jloader.stack_batches(jloader.batch_examples(jds, 2, 64, **kw), 3))
    # repeat: each pass draws the generator's next permutation
    _equal_batches(
        itertools.islice(tloader.batch_examples(
            tds, 4, 64, shuffle_seed=3, repeat=True), 5),
        itertools.islice(jloader.batch_examples(
            jds, 4, 64, shuffle_seed=3, repeat=True), 5))
    for bad in (dict(shuffle_seed=0), dict(workers=2)):
        with pytest.raises(ValueError, match="random-access"):
            next(tloader.batch_examples(iter(tds), 2, 64, **bad))


def test_stage_arrays_holds_the_dataset_once(tmp_path):
    ds = TVOC(make_drill(str(tmp_path), train=32, test=1), "trainval",
              image_size=300)
    tracemalloc.start()
    try:
        out, n = tloader.stage_arrays(ds, 64, workers=1)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    arrays = sum(out[k].nbytes for k in ARRAYS)
    print(f"stage_arrays host peak {peak} bytes, {peak / arrays:.3f}x the "
          f"{arrays} bytes of arrays it returns")
    assert n == 32 and arrays > 32 * 300 * 300 * 3
    assert peak < 1.5 * arrays, (peak, arrays)


def _args(drill, tmp, cache, spc, *extra):
    """trainer.main's flags for a CPU run on the drill; `extra` comes last
    and so overrides."""
    return ["--dataset", "voc", "--data-root", drill, "--val-split", "test",
            "--device", "cpu", "--batch-size", "2", "--epochs", "2",
            "--steps-per-epoch", "2", "--log-every", "1", "--workers", "2",
            "--device-cache", cache, "--steps-per-call", str(spc),
            "--model-dir", str(tmp / "m"), "--log-dir", str(tmp / "l"),
            *extra]


@pytest.fixture(scope="module")
def runs(drill, tmp_path_factory):
    """trainer.main by (device cache, steps per call), each run once."""
    done = {}

    def run(cache, spc):
        if (cache, spc) not in done:
            tmp = tmp_path_factory.mktemp(f"run_{cache}_{spc}")
            done[cache, spc] = ttrainer.main(_args(drill, tmp, cache, spc))
        return done[cache, spc]

    return run


@pytest.mark.parametrize("cache,spc", [("on", 1), ("off", 2), ("on", 2)])
def test_feeds_and_steps_per_call_train_the_same(runs, cache, spc):
    want, got = runs("off", 1), runs(cache, spc)
    assert not want.device_cache and got.device_cache == (cache == "on")
    assert got.steps_per_call == spc and got.steps_run == want.steps_run == 4
    assert len(got.step_metrics) == 4
    assert got.step_metrics == want.step_metrics
    assert len(set(m["loss"] for m in want.step_metrics)) == 4
    assert got.val_losses == want.val_losses and len(got.val_losses) == 2
    assert got.val_batches == want.val_batches == 4
    a, b = got.state.model.state_dict(), want.state.model.state_dict()
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for p, q in zip(got.state.model.parameters(),
                    want.state.model.parameters()):
        sa = got.state.optimizer.state[p]
        sb = want.state.optimizer.state[q]
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[key], sb[key]), key
    with open(got.model_path + "_meta.json") as f:
        assert json.load(f) == {"steps_per_epoch": 2, "batch_size": 2,
                                "steps_per_call": spc}
    if cache == "off":
        # the streamed feed took one item per call from its prefetch queue
        assert got.prefetch.items == 4 // spc


def _jax_message(fragment, **values):
    """The JAX trainer's print f-string containing `fragment`, evaluated
    with `values`."""
    for node in ast.walk(_jax_trainer_source()):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", "")
                == "print" and node.args
                and fragment in ast.unparse(node.args[0])):
            code = compile(ast.Expression(node.args[0]), "trainer.py",
                           "eval")
            return eval(code, {}, values)  # noqa: S307 - the repo's source
    raise AssertionError(f"no print of {fragment!r} in trainer.py")


def test_cache_clamp_and_floor_messages_equal_jax(drill, tmp_path,
                                                  monkeypatch, capsys):
    # auto turns the cache off above the threshold; 10 steps clamp to the
    # one pass of 4, then floor to a multiple of 3
    monkeypatch.setattr(ttrainer, "DEVICE_CACHE_BYTES", 0)
    run = ttrainer.main(_args(drill, tmp_path, "auto", 3,
                              "--steps-per-epoch", "10", "--epochs", "1",
                              "--val-limit", "1"))
    lines = capsys.readouterr().out.splitlines()
    est = (8 + 4) * 300 ** 2 * 3
    for want in (_jax_message("device cache off", est_bytes=est),
                 _jax_message("clamped to", one_pass_steps=4),
                 _jax_message("floored to", steps_per_epoch=3, spc=3)):
        assert want in lines, want
    assert not run.device_cache and run.steps_run == 3
    assert run.steps_per_epoch == 3 and run.val_batches == 1
    with open(run.model_path + "_meta.json") as f:
        assert json.load(f)["steps_per_call"] == 3


def _parsed(argv):
    return ttrainer.build_parser().parse_args(argv)


def test_two_roots_concatenate_and_validation_reads_the_first(
        drill, tmp_path):
    import trainer as jtrainer

    second = make_drill(str(tmp_path), train=5, test=3)
    args = _parsed(["--dataset", "voc", "--data-root", drill,
                    "--data-root", second + ":test", "--val-split", "test"])
    got, want = (ttrainer.make_datasets(args, 300),
                 jtrainer.make_datasets(args, 300))
    assert len(got[0]) == len(want[0]) == 8 + 3
    assert len(got[1]) == len(want[1]) == 4
    for g, w in zip(got, want):
        for i in range(len(w)):
            ge, we = g.example(i), w.example(i)
            assert ge["id"] == we["id"]
            for k in ("image", "boxes", "labels"):
                np.testing.assert_array_equal(ge[k], we[k], err_msg=k)
    # the second root's rows come from its test split, after the first's
    assert got[0].example(8)["id"] == "test_000000"
    assert got[1].root == drill and got[1].split == "test"


def test_voc_without_a_root_exits_with_jax_message():
    import trainer as jtrainer

    args = _parsed(["--dataset", "voc"])
    with pytest.raises(SystemExit) as want:
        jtrainer.make_datasets(args, 300)
    with pytest.raises(SystemExit) as got:
        ttrainer.make_datasets(args, 300)
    assert str(got.value) == str(want.value)
    assert "--data-root" in str(got.value)


def _jax_options(cli="trainer.py"):
    """{option string: default} of the JAX package's `cli` parser and of
    tfssd_tpu/utils/io.py:handle_args, read from their source."""
    out = {}
    for path in (ROOT / cli, ROOT / "tfssd_tpu" / "utils" / "io.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if not (isinstance(node, ast.Call) and getattr(
                    node.func, "attr", "") == "add_argument"):
                continue
            kw = {k.arg: k.value for k in node.keywords}
            if "default" in kw:
                default = ast.literal_eval(kw["default"])
            else:
                default = (False if "action" in kw and ast.literal_eval(
                    kw["action"]) == "store_true" else None)
            for arg in node.args:
                out[ast.literal_eval(arg)] = default
    return out


def test_parser_takes_every_jax_trainer_option_but_port_h5():
    # the name predates --port-h5 in the port; the option is held too
    jax_opts = _jax_options()
    assert {"--steps-per-call", "--device-cache", "--profile",
            "--debug-nans", "--pallas", "-handle-gpu",
            "--port-h5"} <= set(jax_opts)
    port = {s: a.default for a in ttrainer.build_parser()._actions
            for s in a.option_strings}
    assert port["--port-h5"] is None
    for opt, default in jax_opts.items():
        assert opt in port, opt
        if opt == "--dataset":
            assert default == "voc" and port[opt] == "synthetic"
        else:
            assert port[opt] == default, (opt, port[opt], default)
