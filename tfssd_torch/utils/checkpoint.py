"""Checkpoints: the port's own, written with torch.save, and the JAX
package's orbax checkpoints, read with numpy (port of the JAX package's
utils/checkpoint.py:CheckpointManager).

A checkpoint is <directory>/ckpt_<step>.pt, holding the step, the model's
state_dict (parameters and BatchNorm running statistics), Adam's
state_dict and the validation loss, beside ckpt_<step>.json with the step
and the validation loss alone (read to rank checkpoints without loading
them). The manager keeps the
`max_to_keep` best by validation loss (lowest first; a checkpoint without
one ranks last) and restores the latest step it kept, so `--resume`
continues training exactly: the reference's save_best_only, with the
optimizer state kept too.

`OrbaxCheckpoints` reads what the JAX package's CheckpointManager wrote
(its --model-dir's ssd_<backbone>, e.g. the committed
trained/ssd_mobilenet_v2/7680) without orbax, tensorstore or zarr: a step
is a directory <step>/ holding metrics/metrics (JSON, {"val_loss": ...})
and default/, whose _METADATA lists the tree's leaves and whose OCDBT
store (utils/ocdbt.py) holds each leaf as a zarr v2 array: <name>/.zarray
(dtype, shape, chunks, order, compressor, fill value) and one key per
chunk (indices joined by the separator; "0" for a scalar), each a zstd
frame (utils/zstd.py) or raw bytes. A chunk that is absent reads as the
fill value (0 where it is null). <name> is the leaf's path joined by ".".
Besides the weights a step holds optax.adam's state (opt_state.0.count,
.mu, .nu and the schedule's opt_state.1.count): `restore` loads it whole
into the port's TrainState, so the port's --resume continues a JAX run.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from tfssd_torch.train import TrainState
from tfssd_torch.utils import zstd
from tfssd_torch.utils.convert import flatten_tree, load_train_state
from tfssd_torch.utils.ocdbt import OcdbtStore

_NAME = re.compile(r"^ckpt_(\d+)\.json$")


class CheckpointManager:
    """save(step, state, val_loss), latest_step(), restore(state)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int, suffix: str = ".pt") -> str:
        return os.path.join(self.directory, f"ckpt_{step}{suffix}")

    def steps(self) -> Dict[int, float]:
        """{step: val_loss} of the checkpoints on disk (inf when a
        checkpoint was saved without one)."""
        out = {}
        for name in os.listdir(self.directory):
            m = _NAME.match(name)
            if m:
                out[int(m.group(1))] = self._val_loss(int(m.group(1)))
        return out

    def _val_loss(self, step: int) -> float:
        with open(self._path(step, ".json")) as f:
            v = json.load(f)["val_loss"]
        return math.inf if v is None else float(v)

    def save(self, step: int, state: TrainState,
             val_loss: Optional[float] = None) -> str:
        """Write checkpoint `step` (through a temporary file renamed into
        place), then drop all but the best `max_to_keep`."""
        path = self._path(step)
        val = None if val_loss is None else float(val_loss)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({"step": int(step),
                    "model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "val_loss": val}, tmp)
        os.replace(tmp, path)
        # the sidecar last: a step is listed only once its file is whole
        with open(tmp, "w") as f:
            json.dump({"step": int(step), "val_loss": val}, f)
        os.replace(tmp, self._path(step, ".json"))
        ranked = sorted(self.steps().items(), key=lambda kv: (kv[1], -kv[0]))
        for old, _ in ranked[self.max_to_keep:]:
            os.remove(self._path(old, ".json"))
            os.remove(self._path(old))
        return path

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return max(steps) if steps else None

    def best_step(self) -> Optional[int]:
        steps = self.steps()
        return min(steps, key=lambda s: (steps[s], -s)) if steps else None

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Load checkpoint `step` (default: the latest) into `state`, on the
        device its model lives on."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint found in {self.directory}")
        device = next(state.model.parameters()).device
        ckpt = torch.load(self._path(step), map_location=device,
                          weights_only=True)
        state.model.load_state_dict(ckpt["model"])
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = int(ckpt["step"])
        return state


# The leaves a weights-only restore reads (never opt_state).
WEIGHT_COLLECTIONS = ("step", "params", "batch_stats")
# The empty containers orbax records as leaves with no array.
_EMPTY = {"Dict": dict, "List": list, "Tuple": tuple, "None": lambda: None}


class OrbaxCheckpoints:
    """The JAX package's checkpoint directory, read-only: latest_step(),
    best_step(), restore_weights(step) and the whole TrainState
    (restore_train_state(step), restore(state, step)), as its
    CheckpointManager (best_fn = val_loss, best_mode = "min") gives
    them."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)

    def all_steps(self) -> List[int]:
        """The steps on disk, ascending: directories named by an integer
        (orbax's temporary directories are named otherwise)."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isdir(
                          os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def metrics(self, step: int) -> Optional[Dict[str, Any]]:
        """The metrics saved with `step`, or None where it has none."""
        path = os.path.join(self.directory, str(step), "metrics", "metrics")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def best_step(self) -> Optional[int]:
        """The step of the lowest val_loss (of equal ones, the later), over
        the steps saved with metrics; None where none has any, as orbax."""
        scored = [(m["val_loss"], s) for s in self.all_steps()
                  if (m := self.metrics(s)) is not None]
        return min(scored, key=lambda vs: (vs[0], -vs[1]))[1] \
            if scored else None

    def serving_step(self) -> Optional[int]:
        """The step the predictor serves: the best, else the latest."""
        step = self.best_step()
        return self.latest_step() if step is None else step

    def restore_weights(self, step: Optional[int] = None) -> Dict[str, Any]:
        """{'step', 'params', 'batch_stats'} of checkpoint `step` (default:
        the latest) as numpy: the step a 0-d array, the others nested dicts
        keyed by the Flax names. No optimizer state is read."""
        item, out = self._read(step, WEIGHT_COLLECTIONS)
        missing = set(WEIGHT_COLLECTIONS) - set(out)
        if missing:
            raise KeyError(f"{item}: no {sorted(missing)}")
        return out

    def restore_train_state(self, step: Optional[int] = None
                            ) -> Dict[str, Any]:
        """The whole TrainState of checkpoint `step` (default: the latest),
        as the JAX trainer's --resume restores it, in numpy: {'step',
        'params', 'batch_stats', 'opt_state': {'0': {'count', 'mu', 'nu'},
        '1': {'count'}}}, keyed by the Flax names and optax's chain index
        (optax.adam(schedule) = scale_by_adam, scale_by_learning_rate).
        Raises ValueError where the tree is not that chain's, where mu or
        nu does not have params' keys and shapes, or where the step and the
        two counts differ (the port's schedule reads the step, optax's
        scale_by_learning_rate its own count)."""
        item, out = self._read(step, None)
        if sorted(out) != sorted(WEIGHT_COLLECTIONS + ("opt_state",)):
            raise ValueError(f"{item}: a TrainState has step, params, "
                             f"batch_stats and opt_state, not {sorted(out)}")
        opt = out["opt_state"]
        if (not isinstance(opt, dict) or sorted(opt) != ["0", "1"]
                or not isinstance(opt["0"], dict)
                or not isinstance(opt["1"], dict)
                or sorted(opt["0"]) != ["count", "mu", "nu"]
                or sorted(opt["1"]) != ["count"]):
            raise ValueError(
                f"{item}: opt_state is not optax.adam's chain (scale_by_adam"
                f" {{count, mu, nu}}, scale_by_learning_rate {{count}}); "
                f"its leaves: {sorted(flatten_tree(opt))[:8]}")
        params = _shapes(out["params"])
        for moment in ("mu", "nu"):
            if _shapes(opt["0"][moment]) != params:
                raise ValueError(f"{item}: Adam's {moment} does not have "
                                 f"the keys and shapes of params")
        counts = {"step": int(out["step"]),
                  "opt_state.0.count": int(opt["0"]["count"]),
                  "opt_state.1.count": int(opt["1"]["count"])}
        if len(set(counts.values())) != 1:
            raise ValueError(f"{item}: the step and Adam's and the "
                             f"schedule's counts differ: {counts}")
        return out

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Load checkpoint `step` (default: the latest) whole into the
        port's `state`: the weights and BatchNorm statistics, Adam's
        moments and count (utils/convert.py:load_train_state) and the
        step, on the device its model lives on."""
        tree = self.restore_train_state(step)
        adam = tree["opt_state"]["0"]
        load_train_state(state.model, state.optimizer,
                         {"params": tree["params"],
                          "batch_stats": tree["batch_stats"]},
                         adam["mu"], adam["nu"], int(adam["count"]))
        state.step = int(tree["step"])
        return state

    def _read(self, step: Optional[int],
              collections: Optional[Tuple[str, ...]]
              ) -> Tuple[str, Dict[str, Any]]:
        """(the step's item directory, its leaves under `collections`, or
        all of them, as nested dicts of numpy arrays)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint found in {self.directory}")
        item = os.path.join(self.directory, str(step), "default")
        with open(os.path.join(item, "_METADATA")) as f:
            meta = json.load(f)
        if meta.get("use_zarr3"):
            raise ValueError(f"{item}: zarr v3 arrays are not read")
        store = OcdbtStore(item)
        out: Dict[str, Any] = {}
        for entry in meta["tree_metadata"].values():
            path = [k["key"] for k in entry["key_metadata"]]
            if collections is not None and path[0] not in collections:
                continue
            meta_value = entry["value_metadata"]
            if meta_value.get("skip_deserialize"):
                # an empty container (VGG16's batch_stats), not an array
                value = _EMPTY[meta_value["value_type"]]()
            else:
                value = read_zarr_array(store, ".".join(path))
            if len(path) == 1:
                out[path[0]] = value
                continue
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = value
        return item, out


def _shapes(tree: Dict[str, Any]) -> Dict[str, Tuple[int, ...]]:
    """{'a/b': shape} of a nested dict of arrays."""
    return {k: v.shape for k, v in flatten_tree(tree).items()}


_FILL = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}


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
