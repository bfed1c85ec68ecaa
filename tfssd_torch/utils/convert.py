"""Weight bridge: the JAX package's Flax variable tree -> a torch state_dict.

The tree comes as nested dicts of numpy arrays ({'params': ...,
'batch_stats': ...}), folded or not, or flat with '/'-joined keys as
`flatten_tree` writes it into an .npz. Module names are the Flax names
(models/), so only the leaf names and layouts change:

  params/.../kernel   (H, W, I, O) -> .../weight (O, I, H, W), transpose
                      (3, 2, 0, 1); a depthwise (3, 3, 1, C) becomes
                      (C, 1, 3, 3)
  params/.../bias     -> .../bias
  params/.../bn/scale -> .../bn/weight
  params/.../gamma    -> .../gamma (L2Norm's scale, VGG16's conv4_3_norm)
  batch_stats/.../bn/mean, var -> .../bn/running_mean, running_var

Any leaf this does not know raises, and so does any state_dict entry that
the model does not have (load_variables).

`load_train_state` carries a whole JAX TrainState across: the variables as
above, Adam's first and second moments (optax's mu and nu, trees shaped as
params) into torch Adam's exp_avg and exp_avg_sq with the same layout
changes, and the step count.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_PARAM_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "weight",
                 "gamma": "gamma"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def flatten_tree(tree: Mapping[str, Any], prefix: str = ""
                 ) -> Dict[str, np.ndarray]:
    """Nested dicts of arrays -> {'a/b/c': numpy array} (np.savez-ready).
    A tree that is already flat comes back with the same keys."""
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(flatten_tree(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def variables_to_state_dict(tree: Mapping[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """Flax variables (nested or '/'-flat, numpy leaves) -> state_dict."""
    state: Dict[str, torch.Tensor] = {}
    for path, arr in flatten_tree(tree).items():
        collection, *parts = path.split("/")
        if collection not in ("params", "batch_stats") or len(parts) < 2:
            raise KeyError(f"unexpected variable {path!r}")
        leaf = parts[-1]
        names = _PARAM_LEAVES if collection == "params" else _STAT_LEAVES
        if leaf not in names:
            raise KeyError(f"unexpected variable {path!r}")
        arr = np.asarray(arr, dtype=np.float32)
        if leaf == "kernel":
            if arr.ndim != 4:
                raise ValueError(f"{path}: kernel of rank {arr.ndim}")
            arr = arr.transpose(3, 2, 0, 1)
        key = ".".join(parts[:-1] + [names[leaf]])
        if key in state:
            raise KeyError(f"two variables map to {key!r}")
        state[key] = torch.tensor(arr)
        if leaf == "mean":
            state[".".join(parts[:-1] + ["num_batches_tracked"])] = (
                torch.zeros((), dtype=torch.long))
    return state


def load_variables(model: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Load Flax variables into `model`; raises on any key the model lacks
    and on any model entry the tree does not supply."""
    state = variables_to_state_dict(tree)
    model.load_state_dict(state, strict=True)
    return model


def is_folded(tree: Mapping[str, Any]) -> bool:
    """True for a tree whose BatchNorm is already folded (no batch_stats)."""
    return not any(k.startswith("batch_stats/") for k in flatten_tree(tree))


def load_train_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                     variables: Mapping[str, Any], mu: Mapping[str, Any],
                     nu: Mapping[str, Any], count: int
                     ) -> Tuple[nn.Module, torch.optim.Optimizer]:
    """Load a JAX TrainState (numpy leaves) into `model` and `optimizer`, a
    torch.optim.Adam built over model.parameters(): the variables, Adam's
    mu/nu (each a tree shaped as params) and the update count."""
    load_variables(model, variables)
    exp_avg = variables_to_state_dict({"params": mu})
    exp_avg_sq = variables_to_state_dict({"params": nu})
    index = {id(p): i for i, p in enumerate(
        p for g in optimizer.param_groups for p in g["params"])}
    state = {}
    for name, param in model.named_parameters():
        if name not in exp_avg or name not in exp_avg_sq:
            raise KeyError(f"no Adam moments for {name!r}")
        state[index[id(param)]] = {
            "step": torch.tensor(float(count)),
            "exp_avg": exp_avg[name], "exp_avg_sq": exp_avg_sq[name]}
    if len(state) != len(exp_avg):
        raise KeyError("Adam moments for parameters the model does not have")
    sd = optimizer.state_dict()
    optimizer.load_state_dict({"state": state,
                               "param_groups": sd["param_groups"]})
    return model, optimizer
