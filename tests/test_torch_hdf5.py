"""The port's HDF5 reader (tfssd_torch/utils/hdf5.py) against h5py, and the
Keras drill writer (tfssd_torch/make_keras_drill.py) read back by h5py.

- Files that h5py writes at its defaults, covering floats, integers,
  fixed-length and variable-length strings, scalars, nested groups, a group
  of 200 children (a B-tree over many symbol-table nodes), an object with
  many attributes (its header continued), an empty array attribute (as
  Keras writes weight_names of a layer without weights) and a compact
  dataset: every object's path, every attribute and every dataset equal
  h5py's, bit for bit, read from a path and from bytes.
- Chunked and filtered datasets and the newer file format are refused with
  a ValueError that names them; a missing path raises KeyError.
- The drill writer's .h5 (both trunks) reads back through h5py bit-equal to
  the arrays it was given, and through the port's reader as h5py reads it;
  load_keras_h5 reads its .h5 and .keras as those arrays.
"""

import zipfile

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from tfssd_torch import make_keras_drill  # noqa: E402
from tfssd_torch.utils.hdf5 import H5File  # noqa: E402
from tfssd_torch.utils.port_weights import load_keras_h5  # noqa: E402


def _h5py_value(value):
    """h5py's value with bytes decoded, as the port's reader gives it."""
    if isinstance(value, bytes):
        return value.decode()
    if isinstance(value, np.ndarray) and value.dtype.kind in "OS":
        return np.array([v.decode() if isinstance(v, bytes) else v
                         for v in value.ravel()],
                        dtype=object).reshape(value.shape)
    return value


def _assert_reads_as_h5py(path):
    ours = H5File(path)
    with open(path, "rb") as f:
        from_bytes = H5File(f.read())
    with h5py.File(path, "r") as ref:
        names = []
        ref.visit(names.append)
        assert list(ours.walk()) == ["/" + n for n in names]
        assert list(from_bytes.walk()) == ["/" + n for n in names]
        datasets = 0
        for name in [""] + names:
            obj = ref[name or "/"]
            got, want = ours.attrs("/" + name), obj.attrs
            assert sorted(got) == sorted(want), name
            for k in want:
                w = _h5py_value(want[k])
                assert type(got[k]) is type(w) or isinstance(
                    got[k], np.ndarray), (name, k, type(got[k]), type(w))
                assert np.array_equal(np.asarray(got[k]), np.asarray(w)), (
                    name, k)
                assert np.asarray(got[k]).dtype == np.asarray(w).dtype, (
                    name, k)
            if isinstance(obj, h5py.Dataset):
                want = _h5py_value(obj[()])
                for reader in (ours, from_bytes):
                    got = reader.read("/" + name)
                    assert got.shape == obj.shape, name
                    assert got.dtype == np.asarray(want).dtype, name
                    assert np.array_equal(got, want), name
                datasets += 1
            else:
                assert ours.is_group("/" + name)
                assert ours.keys("/" + name) == sorted(obj.keys())
    return datasets


@pytest.fixture(scope="module")
def varied(tmp_path_factory):
    path = tmp_path_factory.mktemp("h5") / "varied.h5"
    rng = np.random.default_rng(0)
    with h5py.File(path, "w") as f:
        f.attrs["title"] = "a root attribute"
        f.attrs["count"] = np.int64(7)
        f.attrs["scale"] = 0.25
        f.create_dataset("f32", data=rng.normal(size=(3, 4, 5)).astype(
            np.float32))
        f.create_dataset("f64", data=rng.normal(size=(17,)))
        f.create_dataset("scalar", data=np.float32(1.5))
        for dt in ("i1", "i2", "i4", "i8", "u1", "u2", "u4", "u8"):
            info = np.iinfo(dt)
            f.create_dataset(f"ints/{dt}", data=rng.integers(
                info.min, info.max, size=(6,), dtype=dt, endpoint=True))
        f.create_dataset("strings/fixed",
                         data=np.array([b"ab", b"cde", b""], dtype="S5"))
        f.create_dataset("strings/vlen", data=["x", "longer text", "é"],
                         dtype=h5py.string_dtype())
        f.create_dataset("a/b/c/d/deep", data=np.arange(4, dtype=np.int32))
        wide = f.create_group("wide")
        for i in range(200):
            wide.create_dataset(f"child_{i:03d}", data=np.float32(i))
        many = f.create_group("many")
        for i in range(120):
            many.attrs[f"attr_{i}"] = f"value {i} " * (i % 9)
        many.attrs["floats"] = rng.normal(size=(64,))
        many.attrs["names"] = np.array([b"Conv1", b"bn_Conv1"])
        many.attrs["vlen_names"] = ["block_1_expand", "block_1_expand_BN"]
        many.attrs["empty"] = np.asarray([])
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        space = h5py.h5s.create_simple((3, 2))
        dset = h5py.h5d.create(f.id, b"compact", h5py.h5t.IEEE_F32LE, space,
                               dcpl=dcpl)
        dset.write(h5py.h5s.ALL, h5py.h5s.ALL,
                   np.arange(6, dtype=np.float32).reshape(3, 2))
    return path


def test_reads_what_h5py_writes(varied):
    assert _assert_reads_as_h5py(varied) == 3 + 8 + 2 + 1 + 200 + 1
    f = H5File(varied)
    assert len(f.keys("/wide")) == 200
    assert len(f.attrs("/many")) == 124
    assert f.attrs("/")["title"] == "a root attribute"
    # the cases the file exists for: a header continued past its first
    # block, a group B-tree above its leaves, a compact dataset
    with h5py.File(varied, "r") as ref:
        assert h5py.h5o.get_info(ref["many"].id).hdr.nchunks > 1
        assert ref["compact"].id.get_create_plist().get_layout() == \
            h5py.h5d.COMPACT
    table = [body for kind, body in f._messages(f._find("/wide"))
             if kind == 0x11][0]
    btree = int.from_bytes(table[:8], "little")
    assert f._data[btree + 5] >= 1  # the root node's level


def test_missing_path_raises_key_error(varied):
    with pytest.raises(KeyError, match="a/x"):
        H5File(varied).read("/a/x/y")


@pytest.mark.parametrize("case,match", [
    ("chunked", "chunked"),
    ("gzip", "filter pipeline"),
    ("latest", "superblock version"),
])
def test_refuses_what_it_does_not_read(tmp_path, case, match):
    path = tmp_path / f"{case}.h5"
    data = np.arange(64, dtype=np.float32).reshape(8, 8)
    with h5py.File(path, "w", libver="latest" if case == "latest"
                   else "earliest") as f:
        if case == "chunked":
            f.create_dataset("x", data=data, chunks=(4, 4))
        elif case == "gzip":
            f.create_dataset("x", data=data, compression="gzip")
        else:
            f.create_dataset("x", data=data)
    with pytest.raises(ValueError, match=match):
        H5File(path).read("/x")


@pytest.mark.parametrize("backbone", ["mobilenet_v2", "vgg16"])
def test_drill_files_read_back(tmp_path, backbone):
    h5, zipped = tmp_path / "drill.h5", tmp_path / "drill.keras"
    weights = make_keras_drill.write_drill(h5, backbone, seed=3)
    assert make_keras_drill.write_drill(zipped, backbone, seed=3).keys() == \
        weights.keys()
    _assert_reads_as_h5py(h5)
    with h5py.File(h5, "r") as f:
        assert "drill" in f.attrs["model_config"]
        layers = [n.decode() if isinstance(n, bytes) else n
                  for n in f["model_weights"].attrs["layer_names"]]
        got = {}
        for layer in layers:
            group = f["model_weights"][layer]
            for w in group.attrs["weight_names"]:
                w = w.decode() if isinstance(w, bytes) else w
                got[w] = group[w][()]
    assert list(got) == list(weights)
    for k, v in weights.items():
        assert got[k].dtype == np.float32 and np.array_equal(got[k], v), k
    with zipfile.ZipFile(zipped) as z:
        assert z.namelist() == ["metadata.json", "config.json",
                                "model.weights.h5"]
        assert all(i.compress_type == zipfile.ZIP_STORED
                   for i in z.infolist())
        inner = tmp_path / "model.weights.h5"
        inner.write_bytes(z.read("model.weights.h5"))
    _assert_reads_as_h5py(inner)
    for path in (h5, zipped):
        loaded = load_keras_h5(path)
        assert list(loaded) == list(weights)
        assert all(np.array_equal(loaded[k], weights[k]) for k in weights)
