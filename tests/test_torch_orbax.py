"""The port's reader of the JAX package's orbax checkpoints
(tfssd_torch/utils/{zstd,ocdbt,checkpoint}.py) against orbax, tensorstore
and the JAX package's CheckpointManager, on the CPU.

- Both committed checkpoints (trained/ssd_mobilenet_v2/7680,
  trained/ssd_vgg16/4720): every leaf of `step`, `params` and
  `batch_stats`, its dtype and shape, bit-equal to
  CheckpointManager.restore_weights, with the same keys.
- The OCDBT store: the keys and values tensorstore reads, for the
  committed MobileNetV2 checkpoint (its merged `default/` store and its
  per-process one) and for stores tensorstore writes here with B-tree
  interior nodes, uncompressed, and empty.
- The zarr layer: arrays tensorstore's zarr driver writes into an OCDBT
  store, several chunks, some never written (read as the fill value),
  zstd-compressed and raw.
- latest_step / best_step as orbax gives them (val_loss 3, 1, 2 and
  max_to_keep 2; saves without metrics), and the restore bit-equal, one
  leaf all zeros.
- The zstd decoder (libzstd through ctypes) gives the bytes the zstandard
  module gives, on every frame of the MobileNetV2 checkpoint and on a
  frame whose header has no content size; without libzstd the error names
  it.
- A process with jax, orbax, tensorstore, zarr, zstandard and PIL blocked
  reads the checkpoint and serves 8 images through `predict --device cpu`.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
ts = pytest.importorskip("tensorstore")
zstandard = pytest.importorskip("zstandard")

import jax  # noqa: E402

from test_torch_predict_parity import (MBV2_DIR, MBV2_STEP, TRAINED,  # noqa: E402
                                       jax_restore)
from tfssd_torch.utils import zstd  # noqa: E402
from tfssd_torch.utils.checkpoint import (OrbaxCheckpoints,  # noqa: E402
                                         read_zarr_array)
from tfssd_torch.utils.ocdbt import (MANIFEST_MAGIC, NODE_MAGIC,  # noqa: E402
                                     OcdbtStore)
from tfssd_tpu.train import TrainState  # noqa: E402
from tfssd_tpu.utils.checkpoint import CheckpointManager  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CHECKPOINTS = {"mobilenet_v2": (MBV2_DIR, MBV2_STEP),
               "vgg16": (os.path.join(TRAINED, "ssd_vgg16"), 4720)}
MBV2_ITEM = os.path.join(MBV2_DIR, str(MBV2_STEP), "default")


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _assert_bit_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        assert isinstance(g, np.ndarray), key
        assert g.dtype == w.dtype and g.shape == w.shape, (key, g.dtype,
                                                           w.dtype)
        assert g.tobytes() == w.tobytes(), key


def _kvstore(path):
    return ts.KvStore.open({"driver": "ocdbt",
                            "base": f"file://{os.path.abspath(path)}/"}
                           ).result()


@pytest.mark.parametrize("name", sorted(CHECKPOINTS))
def test_restore_weights_bit_equal_to_checkpoint_manager(name, monkeypatch):
    directory, step = CHECKPOINTS[name]
    want = jax_restore(directory, step)
    ckpt = OrbaxCheckpoints(directory)
    assert ckpt.all_steps() == [step]
    assert ckpt.latest_step() == ckpt.best_step() == step
    read = []
    original = OcdbtStore.read
    monkeypatch.setattr(OcdbtStore, "read", lambda self, key: (
        read.append(key), original(self, key))[1])
    got = ckpt.restore_weights(step)
    assert read and not any(k.startswith("opt_state") for k in read)
    _assert_bit_equal(got, want)
    assert got["step"].dtype == np.int32 and int(got["step"]) == step
    assert len(_flat(got["params"])) == len(_flat(want["params"])) > 30


@pytest.mark.parametrize("store", ["default", "default/ocdbt.process_0"])
def test_ocdbt_store_reads_what_tensorstore_reads(store):
    path = os.path.join(MBV2_DIR, str(MBV2_STEP), store)
    kv = _kvstore(path)
    keys = kv.list().result()
    got = OcdbtStore(path)
    assert got.keys() == sorted(keys) and len(keys) == 1470
    for key in keys:
        assert got.read(key) == kv.read(key).result().value, key
    assert got.read(b"no/such/key") is None and "step/0" in got


def test_vgg16_store_keys_and_small_values():
    path = os.path.join(TRAINED, "ssd_vgg16", "4720", "default")
    kv = _kvstore(path)
    keys = kv.list().result()
    got = OcdbtStore(path)
    assert got.keys() == sorted(keys)
    for key in keys:
        if key.endswith(b".zarray") or key.startswith(b"step/"):
            assert got.read(key) == kv.read(key).result().value, key


@pytest.mark.parametrize("config", [
    {"max_decoded_node_bytes": 300, "max_inline_value_bytes": 16},
    {"max_decoded_node_bytes": 300, "compression": None},
    {},
], ids=["interior-nodes", "uncompressed", "empty"])
def test_ocdbt_stores_tensorstore_writes(tmp_path, config):
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{tmp_path}/",
                          "config": config}).result()
    rng = np.random.default_rng(0)
    if config:
        for _ in range(3):  # three versions; the reader takes the newest
            with ts.Transaction() as txn:
                for j in range(100):
                    value = rng.integers(0, 256, int(rng.integers(0, 90)),
                                         dtype=np.uint8).tobytes()
                    key = f"k{rng.integers(0, 400):04d}/v{j}".encode()
                    kv.with_transaction(txn).write(key, value).result()
    else:
        kv.write(b"gone", b"x").result()
        kv.delete_range(ts.KvStore.KeyRange(b"a", b"z")).result()
    keys = _kvstore(tmp_path).list().result()
    got = OcdbtStore(str(tmp_path))
    assert got.keys() == sorted(keys)
    assert len(keys) > 100 if config else not keys
    for key in keys:
        assert got.read(key) == kv.read(key).result().value, key
    if config:  # the tree really has interior nodes
        assert got.root_height >= 2


@pytest.mark.parametrize("compressor,fill", [
    ({"id": "zstd", "level": 1}, None), (None, 0), (None, "NaN")],
    ids=["zstd-null-fill", "raw-zero-fill", "raw-nan-fill"])
def test_zarr_arrays_with_absent_chunks(tmp_path, compressor, fill):
    spec = {"driver": "zarr",
            "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}/"},
            "path": "a.b",
            "metadata": {"shape": [5, 7], "chunks": [2, 3],
                         "dtype": "<f4", "compressor": compressor,
                         "fill_value": fill, "order": "C",
                         "dimension_separator": "."}}
    arr = ts.open(spec, create=True).result()
    data = np.arange(35, dtype=np.float32).reshape(5, 7)
    arr[0:2, 0:3].write(data[0:2, 0:3]).result()  # one whole chunk
    arr[4:5, 6:7].write(data[4:5, 6:7]).result()  # the corner edge chunk
    arr[1:4, 3:5].write(data[1:4, 3:5]).result()  # across four chunks
    want = ts.open(spec).result().read().result()
    got = read_zarr_array(OcdbtStore(str(tmp_path)), "a.b")
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[4, 0]) if fill == "NaN" else got[4, 0] == 0


def _write_with_checkpoint_manager(directory, val_losses, max_to_keep=2):
    rng = np.random.default_rng(0)
    mgr = CheckpointManager(str(directory), max_to_keep=max_to_keep)
    try:
        for step, val in enumerate(val_losses, 1):
            mgr.save(step, TrainState(
                step=np.int32(step),
                params={"conv": {"kernel": rng.normal(
                    0, 1, (3, 3, 2, 4)).astype(np.float32)},
                    "zeros": {"bias": np.zeros(5, np.float32)}},
                batch_stats={"bn": {"mean": rng.normal(0, 1, 4).astype(
                    np.float32)}},
                opt_state={"count": np.int32(step)}), val_loss=val)
        return mgr.latest_step(), mgr.best_step()
    finally:
        mgr.close()


def test_steps_and_restore_follow_orbax(tmp_path):
    latest, best = _write_with_checkpoint_manager(tmp_path, (3.0, 1.0, 2.0))
    ckpt = OrbaxCheckpoints(str(tmp_path))
    assert (latest, best) == (3, 2)
    assert ckpt.all_steps() == [2, 3]  # max_to_keep 2 dropped step 1
    assert (ckpt.latest_step(), ckpt.best_step()) == (latest, best)
    assert ckpt.serving_step() == best
    for step in (2, 3):
        jax_mgr = CheckpointManager(str(tmp_path))
        try:
            state = jax_mgr.restore_weights(TrainState(
                step=0, params=None, batch_stats=None, opt_state=None), step)
        finally:
            jax_mgr.close()
        want = jax.tree_util.tree_map(np.asarray, {
            "step": state.step, "params": state.params,
            "batch_stats": state.batch_stats})
        got = ckpt.restore_weights(step)
        _assert_bit_equal(got, want)
        assert not got["params"]["zeros"]["bias"].any()


def test_checkpoints_without_metrics_follow_orbax(tmp_path):
    latest, best = _write_with_checkpoint_manager(tmp_path / "none",
                                                  (None, None, None))
    ckpt = OrbaxCheckpoints(str(tmp_path / "none"))
    assert (ckpt.latest_step(), ckpt.best_step()) == (latest, best) == (3,
                                                                        None)
    assert ckpt.serving_step() == 3
    empty = OrbaxCheckpoints(str(tmp_path / "missing"))
    assert empty.serving_step() is None
    with pytest.raises(FileNotFoundError):
        empty.restore_weights()


def _mbv2_frames():
    """Every zstd frame of the MobileNetV2 checkpoint: its manifests' and
    nodes' bodies and its compressed chunks."""
    frames = []
    for path in sorted(Path(MBV2_ITEM).rglob("*")):
        if not path.is_file() or path.name == "_METADATA":
            continue
        data = path.read_bytes()
        magic = int.from_bytes(data[:4], "big")
        if magic in (MANIFEST_MAGIC, NODE_MAGIC):
            frames.append(data[14:-4])
    store = OcdbtStore(MBV2_ITEM)
    frames += [store.read(k) for k in store.keys()
               if not k.endswith(b".zarray")]
    return frames


def _witness(frame: bytes) -> bytes:
    """The zstandard module's reading of exactly one frame."""
    obj = zstandard.ZstdDecompressor().decompressobj()
    out = obj.decompress(frame)
    assert obj.eof and not obj.unused_data
    return out


def test_libzstd_gives_zstandards_bytes_on_every_frame():
    frames = _mbv2_frames()
    assert len(frames) > 400 and all(f[:4] == zstd.MAGIC for f in frames)
    for frame in frames:
        assert zstd.decompress(frame) == _witness(frame)
    assert zstd.describe().startswith("libzstd 1.")
    with pytest.raises(ValueError, match="bytes after"):
        zstd.decompress(frames[0] + b"\0")
    with pytest.raises(ValueError, match="bad magic"):
        zstd.decompress(b"\0" + frames[0])


def test_libzstd_streams_a_frame_without_its_size():
    # Larger than one ZSTD_DStreamOutSize block (128 KiB), so the stream
    # loop runs several times.
    data = np.random.default_rng(0).integers(
        0, 7, size=300_000, dtype=np.uint8).tobytes()
    frame = zstandard.ZstdCompressor(write_content_size=False).compress(data)
    assert zstandard.get_frame_parameters(frame).content_size == \
        zstandard.CONTENTSIZE_UNKNOWN
    assert zstd.decompress(frame) == _witness(frame) == data
    with pytest.raises(ValueError, match="truncated"):
        zstd.decompress(frame[:-8])
    with pytest.raises(ValueError, match="bytes after"):
        zstd.decompress(frame + frame)


def test_no_zstd_decoder_names_libzstd(monkeypatch):
    def no_library(*args, **kwargs):
        raise OSError("blocked")

    monkeypatch.setattr(zstd.ctypes, "CDLL", no_library)
    monkeypatch.setattr(zstd.ctypes.util, "find_library", lambda name: None)
    zstd._libzstd.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="libzstd"):
            zstd.decompress(b"\x28\xb5\x2f\xfd")
    finally:
        zstd._libzstd.cache_clear()


_BLOCKED = ("jax", "jaxlib", "flax", "orbax", "tensorstore", "zarr",
            "zstandard", "PIL")

_SERVE_BLOCKED = """
import sys
for name in {blocked!r}:
    sys.modules[name] = None
from tfssd_torch import predict
from tfssd_torch.utils import zstd
run = predict.main(["--device", "cpu", "--limit", "8", "--batch-size", "8"])
assert run.mean_ap > 0.5, run.mean_ap
assert sum(run.num_valid) == 8
leaked = sorted(n for n in sys.modules if n.split(".")[0] in {blocked!r}
                and sys.modules[n] is not None)
assert not leaked, leaked
print("decoder", zstd.describe())
"""


def test_reads_and_serves_with_jax_orbax_tensorstore_zarr_pil_blocked():
    code = _SERVE_BLOCKED.format(blocked=_BLOCKED)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert f"loaded checkpoint step {MBV2_STEP}" in proc.stdout
    assert "decoder libzstd" in proc.stdout, proc.stdout[-2000:]


def test_metadata_lists_what_the_reader_skips():
    with open(os.path.join(MBV2_ITEM, "_METADATA")) as f:
        meta = json.load(f)
    firsts = {v["key_metadata"][0]["key"]
              for v in meta["tree_metadata"].values()}
    assert firsts == {"step", "params", "batch_stats", "opt_state"}
    assert meta["use_zarr3"] is False
