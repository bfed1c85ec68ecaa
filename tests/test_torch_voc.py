"""VOC directories, image folders and drawing in the port
(tfssd_torch/data/{voc,loader}.py, utils/drawing.py, utils/io.py and
`predict --dataset voc / --image-dir / --draw`) against the JAX package,
on the CPU, on a drill tree that tools/make_voc_drill.py writes (16 test
images at 300 x 300, every 17th object difficult).

- parse_annotation and VOCDataset.example, with difficult objects kept
  and skipped: byte-equal to the JAX package's.
- ConcatDataset, TakeDataset and parse_data_root behave as the JAX
  package's.
- `predict --dataset voc --data-root ROOT --split test` on the committed
  checkpoint: mAP within 1e-4 of the JAX predictor's on the same split
  (measured: equal); with --limit 5 on both feeds, within 1e-4 of the JAX
  predictor's on the first 5 images.
- `--image-dir`: the JAX predictor's detections (the same detections
  scoring at least 0.05 both ways) and no mAP; with --limit 2 at batch 4,
  the batch's third image is not served.
- `--draw 2`: PNGs pixel-equal to the JAX package's draw_predictions of
  the same detections.
- Without PIL, decoding an image or drawing raises an ImportError that
  names Pillow.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
Image = pytest.importorskip("PIL.Image")

from test_torch_predict_parity import jax_map, jax_predictions  # noqa: E402
from tfssd_torch import predict  # noqa: E402
from tfssd_torch.data import loader as tloader  # noqa: E402
from tfssd_torch.data import voc as tvoc  # noqa: E402
from tfssd_torch.evaluate import detection_agreement  # noqa: E402
from tfssd_torch.ops.nms import NMSResult  # noqa: E402
from tfssd_torch.utils import drawing as tdrawing  # noqa: E402
from tfssd_torch.utils.io import parse_data_root as t_parse  # noqa: E402
from tfssd_tpu.data import loader as jloader  # noqa: E402
from tfssd_tpu.data import voc as jvoc  # noqa: E402
from tfssd_tpu.utils import drawing as jdrawing  # noqa: E402
from tfssd_tpu.utils.io import parse_data_root as j_parse  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N_TEST = 16
BATCH = 8
CPU = ["--device", "cpu", "--batch-size", str(BATCH)]


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    """The VOC2007 root of a drill tree: 4 trainval and 16 test images."""
    out = tmp_path_factory.mktemp("voc_drill")
    subprocess.run([sys.executable, str(ROOT / "tools" / "make_voc_drill.py"),
                    "--out", str(out), "--train", "4", "--test",
                    str(N_TEST), "--image-size", "300"],
                   check=True, capture_output=True, timeout=300,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return str(out / "VOC2007")


@pytest.fixture(scope="module")
def jax_test_split(drill):
    """The JAX predictor's detections on the drill's test split (difficult
    objects kept, as the predictor reads it)."""
    ds = jvoc.VOCDataset(drill, "test", image_size=300, skip_difficult=False)
    return jax_predictions([ds.example(i) for i in range(len(ds))], BATCH)


def _equal_examples(got, want):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[key].dtype == w.dtype, key
            np.testing.assert_array_equal(got[key], w, err_msg=key)
        else:
            assert got[key] == w, key


def test_parse_annotation_equals_jax(drill):
    files = sorted(Path(drill, "Annotations").glob("*.xml"))
    assert len(files) == 4 + N_TEST
    difficult = 0
    for path in files:
        for keep in (False, True):
            want = jvoc.parse_annotation(str(path), keep_difficult=keep)
            _equal_examples(tvoc.parse_annotation(str(path), keep), want)
        difficult += int(want["difficult"].sum())
    assert difficult > 0  # the drill marks some objects difficult


@pytest.mark.parametrize("skip_difficult", [True, False])
def test_voc_examples_byte_equal_to_jax(drill, skip_difficult):
    kw = dict(image_size=300, skip_difficult=skip_difficult)
    got = tvoc.VOCDataset(drill, "test", **kw)
    want = jvoc.VOCDataset(drill, "test", **kw)
    assert len(got) == len(want) == N_TEST
    for i in range(N_TEST):
        _equal_examples(got.example(i), want.example(i))
    assert tvoc.get_labels() == jvoc.get_labels()


def test_concat_take_and_parse_data_root_as_jax(drill):
    parts = [("trainval", 4), ("test", N_TEST)]
    t = tloader.ConcatDataset([tvoc.VOCDataset(drill, s, image_size=300)
                               for s, _ in parts])
    j = jloader.ConcatDataset([jvoc.VOCDataset(drill, s, image_size=300)
                               for s, _ in parts])
    assert len(t) == len(j) == 4 + N_TEST
    for i in (0, 3, 4, 19):
        _equal_examples(t.example(i), j.example(i))
    for bad in (-1, len(t)):
        with pytest.raises(IndexError):
            t.example(bad)
    with pytest.raises(ValueError):
        tloader.ConcatDataset([])
    with pytest.raises(TypeError):
        tloader.ConcatDataset([[1, 2]])
    for n in (0, 3, 100):
        tt, jt = tloader.TakeDataset(t, n), jloader.TakeDataset(j, n)
        assert len(tt) == len(jt)
        assert [e["id"] for e in tt] == [e["id"] for e in jt]
    with pytest.raises(IndexError):
        tloader.TakeDataset(t, 3).example(3)
    for spec in ("VOC2007", "VOC2007:test", "/data/VOC2012:trainval",
                 "a/b:c/d", ":test", "VOC2007:"):
        assert t_parse(spec, "val") == j_parse(spec, "val"), spec


def test_batches_with_workers_equal_one_worker(drill):
    ds = tvoc.VOCDataset(drill, "test", image_size=300,
                         skip_difficult=False)
    one = list(tloader.batch_examples(ds, 5, 64, drop_remainder=False))
    four = list(tloader.batch_examples(ds, 5, 64, drop_remainder=False,
                                       workers=4))
    assert len(one) == len(four) == 4
    for a, b in zip(one, four):
        for key in ("image", "boxes", "labels", "difficult"):
            np.testing.assert_array_equal(a[key], b[key])
        assert a["ids"] == b["ids"] and a["num_valid"] == b["num_valid"]
    with pytest.raises(ValueError, match="random-access"):
        next(tloader.batch_examples(iter([]), 5, 64, workers=2))


def test_predict_voc_split_map_equals_jax(drill, jax_test_split):
    run = predict.main(CPU + ["--dataset", "voc", "--data-root", drill,
                              "--split", "test"])
    assert sum(run.num_valid) == N_TEST and run.device_cached
    want = jax_map(jax_test_split)
    assert want > 0.3
    assert abs(run.mean_ap - want) <= 1e-4, (run.mean_ap, want)


@pytest.mark.parametrize("feed", ["on", "off"])
def test_predict_voc_limit_on_both_feeds(drill, jax_test_split, feed):
    run = predict.main(CPU + ["--dataset", "voc", "--data-root",
                              f"{drill}:test", "--limit", "5",
                              "--device-cache", feed, "--workers", "2"])
    assert run.num_valid == [5] and run.device_cached == (feed == "on")
    assert abs(run.mean_ap - jax_map(jax_test_split, 5)) <= 1e-4


@pytest.fixture(scope="module")
def image_dir(drill, tmp_path_factory):
    """Three drill images in a folder, one as PNG at another size, and a
    file that is no image."""
    out = tmp_path_factory.mktemp("images")
    src = sorted(Path(drill, "JPEGImages").glob("test_*.jpg"))[:3]
    shutil.copy(src[0], out / "a.jpg")
    shutil.copy(src[1], out / "b.JPEG")
    Image.open(src[2]).resize((320, 240)).save(out / "c.png")
    (out / "notes.txt").write_text("not an image")
    return str(out)


def test_predict_image_dir_gives_jax_detections(image_dir):
    run = predict.main(CPU + ["--image-dir", image_dir])
    assert run.mean_ap is None and not run.device_cached
    assert run.ids == [["a.jpg", "b.JPEG", "c.png"]]
    examples = list(jvoc.custom_image_generator(
        jvoc.get_custom_imgs(image_dir), 300))
    want = jax_predictions(examples, BATCH)["results"][0]
    got = NMSResult(*(t.numpy()[:3] for t in run.results[0]))
    assert detection_agreement(got, want) == 1.0
    strong = got.scores >= 0.5
    assert strong.sum() > 0
    np.testing.assert_array_equal(strong, want.scores >= 0.5)
    np.testing.assert_array_equal(got.classes[strong], want.classes[strong])


def test_predict_image_dir_limit(image_dir):
    run = predict.main(CPU + ["--image-dir", image_dir, "--limit", "2",
                              "--batch-size", "4"])
    assert run.num_valid == [2] and run.ids == [["a.jpg", "b.JPEG"]]


def test_draw_writes_what_jax_draws(drill, tmp_path):
    out = tmp_path / "drawn"
    run = predict.main(CPU + ["--dataset", "voc", "--data-root", drill,
                              "--limit", "4", "--draw", "2",
                              "--output-dir", str(out), "--no-eval",
                              "--score-threshold", "0.3"])
    assert run.mean_ap is None
    written = sorted(p.name for p in out.iterdir())
    assert written == [f"{i}.png" for i in run.ids[0][:2]]
    host = NMSResult(*(t.numpy() for t in run.results[0]))
    labels = jvoc.get_labels()
    for i in range(2):
        want = jdrawing.draw_predictions(
            run.images[0][i], host.boxes[i], host.scores[i],
            host.classes[i], labels, score_threshold=0.3)
        got = Image.open(out / written[i])
        assert got.size == want.size
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert not np.array_equal(np.asarray(got), run.images[0][i])
    assert tdrawing.class_colors(21) == jdrawing.class_colors(21)


_NO_PIL = """
import sys
sys.modules["PIL"] = None
import numpy as np
from tfssd_torch.data import voc
from tfssd_torch.utils import drawing
for call in (lambda: voc.VOCDataset(sys.argv[1], "test", 300).example(0),
             lambda: drawing.draw_predictions(
                 np.zeros((4, 4, 3), np.uint8), np.zeros((0, 4)),
                 np.zeros(0), np.zeros(0, int))):
    try:
        call()
    except ImportError as e:
        assert "Pillow" in str(e), e
    else:
        raise AssertionError("no ImportError without PIL")
print("ok")
"""


def test_without_pil_the_error_names_pillow(drill):
    proc = subprocess.run([sys.executable, "-c", _NO_PIL, drill], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip() == "ok"
