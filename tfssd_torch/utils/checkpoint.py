"""Checkpoint and resume with torch.save (port of the JAX package's
utils/checkpoint.py:CheckpointManager, which uses orbax).

A checkpoint is <directory>/ckpt_<step>.pt, holding the step, the model's
state_dict (parameters and BatchNorm running statistics), Adam's
state_dict and the validation loss, beside ckpt_<step>.json with the step
and the validation loss alone (read to rank checkpoints without loading
them). The manager keeps the
`max_to_keep` best by validation loss (lowest first; a checkpoint without
one ranks last) and restores the latest step it kept, so `--resume`
continues training exactly: the reference's save_best_only, with the
optimizer state kept too.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import Dict, Optional

import torch

from tfssd_torch.train import TrainState

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
