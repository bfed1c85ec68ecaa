"""Write Keras trunk files of seeded arrays, for --port-h5 where Keras is not
installed (test support, as make_voc_drill.py is; neither CLI has a flag
for it).

    python -m tfssd_torch.make_keras_drill --backbone mobilenet_v2 \\
        --out build/mbv2.h5 [--seed 0]
    python -m tfssd_torch.make_keras_drill --backbone vgg16 \\
        --out build/vgg16.keras
    python -m tfssd_torch.predict --port-h5 build/mbv2.h5 ...

The arrays have the names, classes and shapes of the variables of
keras.applications.MobileNetV2(include_top=False) (width 1.0) or
VGG16(include_top=False), drawn as Keras initialises such a model
(glorot_uniform kernels), with small biases and BatchNorm scales,
shifts and statistics drawn near the identity, so that no two variables
of a layer are equal. Only the layers that hold variables are written, in
Keras's layer order.

  .h5     Keras's legacy model.save layout: the root attributes backend,
          keras_version and model_config (a JSON layer list of each layer's
          class_name and the config keys the loader reads, marked as a
          drill file), and model_weights/<layer>/<layer>/<variable>, with
          the attributes layer_names and weight_names;
  .keras  a zip, stored, of config.json (the same layer list),
          metadata.json and model.weights.h5 with
          layers/<auto name>/vars/<i>, as Keras's saving_lib names them.

The HDF5 files are written by a minimal writer of the subset that
utils/hdf5.py reads, as h5py writes it: superblock version 0, version 1
object headers, symbol-table groups (B-tree and local heap), contiguous
float32 datasets and variable-length UTF-8 string attributes, whose bytes
lie in one global heap collection.
"""

from __future__ import annotations

import argparse
import datetime
import io
import json
import struct
import zipfile
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from tfssd_torch.utils.hdf5 import SIGNATURE, UNDEFINED
from tfssd_torch.utils.port_weights import snake_case

DRILL = ("seeded arrays written by tfssd_torch.make_keras_drill in the "
         "layout of Keras's model.save; not a trained model")
KERAS_VERSION = "3 (drill)"
# B-tree widths of the superblock: symbols per SNOD (2 x 4) and children
# per B-tree node (2 x 16), as the HDF5 library's defaults.
LEAF_K, NODE_K = 4, 16
# the smallest global heap collection the HDF5 library writes
GCOL_MIN = 4096

# A layer that holds variables: (name, class name, config, [(variable,
# shape)]).
Layer = Tuple[str, str, Dict, List[Tuple[str, Tuple[int, ...]]]]


def _conv(name: str, shape: Tuple[int, ...], bias: bool,
          depthwise: bool = False) -> Layer:
    variables = [("kernel", shape)] + ([("bias", (shape[-1],))]
                                       if bias else [])
    return (name, "DepthwiseConv2D" if depthwise else "Conv2D",
            {"name": name, "use_bias": bias}, variables)


def _bn(name: str, channels: int) -> Layer:
    return (name, "BatchNormalization",
            {"name": name, "scale": True, "center": True, "epsilon": 1e-3},
            [(v, (channels,)) for v in ("gamma", "beta", "moving_mean",
                                        "moving_variance")])


def mobilenet_v2_layers() -> List[Layer]:
    """keras.applications.MobileNetV2(alpha=1.0, include_top=False)'s layers
    that hold variables."""
    layers = [_conv("Conv1", (3, 3, 3, 32), False), _bn("bn_Conv1", 32)]
    cin = 32
    schedule = ((1, 16, 1), (6, 24, 2), (6, 32, 3), (6, 64, 4), (6, 96, 3),
                (6, 160, 3), (6, 320, 1))
    block = 0
    for t, c, n in schedule:
        for _ in range(n):
            prefix = f"block_{block}_" if block else "expanded_conv_"
            width = cin * t
            if block:
                layers += [_conv(prefix + "expand", (1, 1, cin, width), False),
                           _bn(prefix + "expand_BN", width)]
            layers += [_conv(prefix + "depthwise", (3, 3, width, 1), False,
                             depthwise=True),
                       _bn(prefix + "depthwise_BN", width),
                       _conv(prefix + "project", (1, 1, width, c), False),
                       _bn(prefix + "project_BN", c)]
            cin, block = c, block + 1
    return layers + [_conv("Conv_1", (1, 1, 320, 1280), False),
                     _bn("Conv_1_bn", 1280)]


def vgg16_layers() -> List[Layer]:
    """keras.applications.VGG16(include_top=False)'s layers."""
    layers, cin = [], 3
    for b, (n, c) in enumerate(((2, 64), (2, 128), (3, 256), (3, 512),
                                (3, 512)), start=1):
        for i in range(1, n + 1):
            layers.append(_conv(f"block{b}_conv{i}", (3, 3, cin, c), True))
            cin = c
    return layers


def trunk(backbone: str, seed: int = 0
          ) -> Tuple[List[Layer], Dict[str, np.ndarray]]:
    """The layers of the trunk of `backbone` (a config name: mobilenet_v2,
    else VGG16) and their seeded float32 arrays {'<layer>/<variable>'}."""
    layers = (mobilenet_v2_layers() if backbone == "mobilenet_v2"
              else vgg16_layers())
    rng = np.random.default_rng(seed)
    out = {}
    for name, _, _, variables in layers:
        for var, shape in variables:
            if var == "kernel":  # Keras's glorot_uniform
                field = int(np.prod(shape[:-2]))
                limit = np.sqrt(6.0 / (field * (shape[-2] + shape[-1])))
                a = rng.uniform(-limit, limit, shape)
            elif var in ("gamma", "moving_variance"):
                a = rng.uniform(0.75, 1.25, shape)
            else:  # bias, beta, moving_mean
                a = rng.normal(0, 0.1, shape)
            out[f"{name}/{var}"] = a.astype(np.float32)
    return layers, out


def _model_config(layers: Sequence[Layer]) -> str:
    return json.dumps({
        "class_name": "Functional", "drill": DRILL,
        "config": {"name": "drill", "layers": [
            {"class_name": cls, "config": config, "name": name}
            for name, cls, config, _ in layers]}})


# -- the HDF5 writer ------------------------------------------------------


class Group:
    """A group: children (Group or float32 array) and attributes (str or a
    list of str, written as variable-length UTF-8 strings)."""

    def __init__(self, attrs: Optional[Mapping[str, Union[str, List[str]]]]
                 = None):
        self.attrs = dict(attrs or {})
        self.children: Dict[str, Union["Group", np.ndarray]] = {}

    def group(self, path: str) -> "Group":
        """The group at '/'-separated `path` below this one, made where
        missing."""
        node = self
        for part in path.split("/"):
            node = node.children.setdefault(part, Group())
        return node

    def dataset(self, path: str, array: np.ndarray) -> None:
        head, _, name = path.rpartition("/")
        (self.group(head) if head else self).children[name] = array


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _header(messages: Sequence[Tuple[int, bytes]]) -> bytes:
    """A version 1 object header of (type, body) messages."""
    body = b"".join(struct.pack("<HHB3x", kind, len(_pad8(m)), 0) + _pad8(m)
                    for kind, m in messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _dataspace(shape: Tuple[int, ...]) -> bytes:
    return struct.pack(f"<BBB5x{len(shape)}Q", 1, len(shape), 0, *shape)


FLOAT32 = (bytes([0x11, 0x20, 0x1F, 0x00]) + struct.pack("<I", 4)
           + struct.pack("<HHBBBBI", 0, 32, 23, 8, 0, 23, 127))
# a variable-length UTF-8 string over unsigned chars
VLEN_UTF8 = (bytes([0x19, 0x01, 0x01, 0x00]) + struct.pack("<I", 16)
             + bytes([0x10, 0, 0, 0]) + struct.pack("<IHH", 1, 0, 8))


class _Writer:
    def __init__(self):
        self.out = bytearray(96)  # the superblock, written last
        self.strings: Dict[str, int] = {}  # global heap object index
        self.heap = 0

    def put(self, data: bytes) -> int:
        addr = len(self.out)
        self.out += data
        return addr

    def collect(self, group: Group) -> None:
        for value in group.attrs.values():
            for s in [value] if isinstance(value, str) else value:
                self.strings.setdefault(s, len(self.strings) + 1)
        for child in group.children.values():
            if isinstance(child, Group):
                self.collect(child)

    def global_heap(self) -> None:
        objects = b"".join(
            struct.pack("<HHIQ", i, 0, 0, len(s.encode()))
            + _pad8(s.encode()) for s, i in self.strings.items())
        size = max(GCOL_MIN, 16 + len(objects) + 16)
        free = size - 16 - len(objects)  # the free-space object, its header
        self.heap = self.put(b"GCOL" + struct.pack("<B3xQ", 1, size) + objects
                             + struct.pack("<HHIQ", 0, 0, 0, free)
                             + b"\0" * (free - 16))

    def attribute(self, name: str, value: Union[str, List[str]]) -> bytes:
        items = [value] if isinstance(value, str) else list(value)
        space = _dataspace(() if isinstance(value, str) else (len(items),))
        data = b"".join(struct.pack("<IQI", len(s.encode()), self.heap,
                                    self.strings[s]) for s in items)
        raw_name = name.encode() + b"\0"
        return (struct.pack("<BBHHH", 1, 0, len(raw_name), len(VLEN_UTF8),
                            len(space))
                + _pad8(raw_name) + _pad8(VLEN_UTF8) + _pad8(space) + data)

    def dataset(self, array: np.ndarray) -> int:
        if array.dtype != np.float32:
            raise ValueError(f"only float32 datasets are written, not "
                             f"{array.dtype}")
        raw = np.ascontiguousarray(array).astype("<f4").tobytes()
        addr = self.put(raw)
        layout = struct.pack("<BBQQ", 3, 1, addr, len(raw))
        return self.put(_header([(0x01, _dataspace(array.shape)),
                                 (0x03, FLOAT32), (0x08, layout)]))

    def group(self, group: Group) -> Tuple[int, int, int]:
        """(object header, B-tree, local heap) addresses of `group`, its
        children written first."""
        names = sorted(group.children, key=str.encode)
        headers = [self.group(c)[0] if isinstance(c, Group)
                   else self.dataset(c)
                   for c in (group.children[n] for n in names)]
        # the local heap: "" at offset 0 (B-tree key 0), then the names
        segment, offsets = bytearray(8), []
        for n in names:
            offsets.append(len(segment))
            segment += _pad8(n.encode() + b"\0")
        heap = self.put(b"HEAP" + struct.pack("<B3xQQQ", 0, len(segment), 1,
                                              len(self.out) + 32) + segment)
        # symbol table nodes of 2 x LEAF_K entries, each allocated whole
        children, keys = [], [0]
        for i in range(0, len(names), 2 * LEAF_K):
            entries = b"".join(struct.pack("<QQII16x", offsets[j], headers[j],
                                           0, 0)
                               for j in range(i, min(i + 2 * LEAF_K,
                                                     len(names))))
            children.append(self.put(
                b"SNOD" + struct.pack("<BBH", 1, 0, len(entries) // 40)
                + entries + b"\0" * (2 * LEAF_K * 40 - len(entries))))
            keys.append(offsets[min(i + 2 * LEAF_K, len(names)) - 1])
        level = 0
        while True:
            nodes, node_keys = [], [0]
            for i in range(0, max(len(children), 1), 2 * NODE_K):
                kids = children[i:i + 2 * NODE_K]
                body = struct.pack("<Q", keys[i]) + b"".join(
                    struct.pack("<QQ", kid, keys[i + 1 + j])
                    for j, kid in enumerate(kids))
                nodes.append(self.put(
                    b"TREE" + struct.pack("<BBHQQ", 0, level, len(kids),
                                          UNDEFINED, UNDEFINED)
                    + body + b"\0" * (8 * (4 * NODE_K + 1) - len(body))))
                node_keys.append(keys[i + len(kids)])
            if len(nodes) == 1:
                break
            children, keys, level = nodes, node_keys, level + 1
        messages = [(0x11, struct.pack("<QQ", nodes[0], heap))]
        messages += [(0x0C, self.attribute(k, v))
                     for k, v in group.attrs.items()]
        return self.put(_header(messages)), nodes[0], heap

    def file(self, root: Group) -> bytes:
        self.collect(root)
        self.global_heap()
        header, btree, heap = self.group(root)
        self.out[:96] = (
            SIGNATURE + struct.pack("<8BHHI", 0, 0, 0, 0, 0, 8, 8, 0, LEAF_K,
                                    NODE_K, 0)
            + struct.pack("<QQQQ", 0, UNDEFINED, len(self.out), UNDEFINED)
            + struct.pack("<QQIIQQ", 0, header, 1, 0, btree, heap))
        return bytes(self.out)


def write_hdf5(root: Group) -> bytes:
    """The bytes of an HDF5 file holding `root` as its root group."""
    return _Writer().file(root)


# -- the Keras layouts ------------------------------------------------------


def h5_bytes(layers: Sequence[Layer], weights: Mapping[str, np.ndarray]
             ) -> bytes:
    """Keras's legacy model.save layout."""
    root = Group({"backend": "drill", "keras_version": KERAS_VERSION,
                  "model_config": _model_config(layers)})
    mw = root.group("model_weights")
    mw.attrs.update(layer_names=[name for name, *_ in layers],
                    backend="drill", keras_version=KERAS_VERSION)
    for name, _, _, variables in layers:
        paths = [f"{name}/{var}" for var, _ in variables]
        mw.group(name).attrs["weight_names"] = paths
        for path in paths:
            mw.group(name).dataset(path, weights[path])
    return write_hdf5(root)


def keras_bytes(layers: Sequence[Layer], weights: Mapping[str, np.ndarray]
                ) -> bytes:
    """Keras's .keras zip: config.json, metadata.json and model.weights.h5
    with layers/<auto name>/vars/<i>."""
    root, used = Group(), {}
    for name, cls, _, variables in layers:
        auto = snake_case(cls)
        used[auto] = used.get(auto, -1) + 1
        if used[auto]:
            auto = f"{auto}_{used[auto]}"
        for i, (var, _) in enumerate(variables):
            root.dataset(f"layers/{auto}/vars/{i}", weights[f"{name}/{var}"])
    config = json.loads(_model_config(layers))
    config["module"] = "keras"
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as z:
        z.writestr("metadata.json", json.dumps({
            "keras_version": KERAS_VERSION,
            "date_saved": datetime.datetime.now().strftime(
                "%Y-%m-%d@%H:%M:%S")}))
        z.writestr("config.json", json.dumps(config))
        z.writestr("model.weights.h5", write_hdf5(root))
    return buf.getvalue()


def write_drill(path: str, backbone: str = "mobilenet_v2", seed: int = 0
                ) -> Dict[str, np.ndarray]:
    """Write the trunk of `backbone` to `path` (.keras: the zip; else the
    legacy .h5); returns the arrays written."""
    layers, weights = trunk(backbone, seed)
    data = (keras_bytes if str(path).endswith(".keras") else h5_bytes)(
        layers, weights)
    with open(path, "wb") as f:
        f.write(data)
    return weights


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(prog="python -m tfssd_torch.make_keras_drill",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--backbone", default="mobilenet_v2",
                   help="mobilenet_v2, or a VGG16 config (vgg16, vgg16_512)")
    p.add_argument("--out", required=True,
                   help="the file: .keras for the zip, else the .h5 layout")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    weights = write_drill(args.out, args.backbone, args.seed)
    print(f"wrote {len(weights)} arrays of the {args.backbone} trunk to "
          f"{args.out}")


if __name__ == "__main__":
    main()
