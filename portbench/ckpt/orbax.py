"""The weights of one step of an orbax checkpoint directory, as a flat
{'params/...': array, 'batch_stats/...': array} tree of numpy arrays keyed
by the Flax names (a frozen copy of the weight-reading part of
tfssd_torch/utils/checkpoint.py:OrbaxCheckpoints).

A step is a directory <step>/default/ whose _METADATA lists the tree's
leaves and whose OCDBT store (ocdbt.py) holds each leaf as a zarr v2
array: <name>/.zarray (dtype, shape, chunks, order, compressor, fill
value) and one key per chunk, each a zstd frame (zstd.py) or raw bytes. A
chunk that is absent reads as the fill value. <name> is the leaf's path
joined by ".".
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict

import numpy as np

from portbench.ckpt import zstd
from portbench.ckpt.ocdbt import OcdbtStore

COLLECTIONS = ("params", "batch_stats")

_FILL = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}


def read_weights(step_dir: str) -> Dict[str, np.ndarray]:
    """The params and batch_stats leaves of checkpoint step directory
    `step_dir` (e.g. trained/ssd_mobilenet_v2/7680), flat, '/'-joined."""
    item = os.path.join(step_dir, "default")
    with open(os.path.join(item, "_METADATA")) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{item}: zarr v3 arrays are not read")
    store = OcdbtStore(item)
    out: Dict[str, np.ndarray] = {}
    for entry in meta["tree_metadata"].values():
        path = [k["key"] for k in entry["key_metadata"]]
        if path[0] not in COLLECTIONS:
            continue
        if entry["value_metadata"].get("skip_deserialize"):
            continue  # an empty container, not an array
        out["/".join(path)] = read_zarr_array(store, ".".join(path))
    if not any(k.startswith("params/") for k in out):
        raise KeyError(f"{item}: no params")
    return out


def read_zarr_array(store: OcdbtStore, name: str) -> np.ndarray:
    """The zarr v2 array `name` of `store`, assembled from its chunks."""
    raw = store.read(f"{name}/.zarray")
    if raw is None:
        raise KeyError(f"no array {name!r} in the checkpoint")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2 or meta.get("filters"):
        raise ValueError(f"{name}: not a plain zarr v2 array")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {compressor}")
    dtype = np.dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    fill = meta.get("fill_value")
    out = np.full(shape, 0 if fill is None else _FILL.get(fill, fill), dtype)
    sep = meta.get("dimension_separator", ".")
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for index in np.ndindex(*grid):
        raw = store.read(f"{name}/{sep.join(map(str, index)) or '0'}")
        if raw is None:
            continue
        if compressor is not None:
            raw = zstd.decompress(raw)
        chunk = np.frombuffer(raw, dtype).reshape(chunks,
                                                  order=meta["order"])
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(index, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start)
                                  for r in region)]
    return out
