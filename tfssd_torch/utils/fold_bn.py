"""Fold inference-mode BatchNorm into conv weights (port of the JAX
package's utils/fold_bn.py).

At inference BN is the per-channel affine
    y = (conv(x) - mean) * gamma / sqrt(var + eps) + beta,
so with s = gamma / sqrt(var + eps) it equals a conv with weight * s and
bias beta - mean * s. Folding runs in float32 with the model's own eps:
1e-3 in the SSD models, as the JAX package folds, so both serve the same
numbers; 1e-5 in RetinaNet's trunk (torchvision's frozen BatchNorm). The folded model keeps the
config's compute dtype: under bfloat16 the folded float32 weight and bias
are cast at the conv, as any biased conv's (models/layers.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from tfssd_torch.models.layers import BN_EPSILON
from tfssd_torch.models.ssd import get_model


def fold_batch_norm(state: Dict[str, torch.Tensor],
                    eps: float = BN_EPSILON) -> Dict[str, torch.Tensor]:
    """state_dict of a fold_bn=False model -> state_dict of the same config
    with fold_bn=True. Every `<P>conv.weight` with a `<P>bn.*` sibling
    becomes a biased conv (BatchNorm epsilon `eps`); every other entry
    passes through."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in state.items():
        if key != "conv.weight" and not key.endswith(".conv.weight"):
            continue
        p = key[:-len("conv.weight")]          # "" or "<module path>."
        if f"{p}bn.weight" not in state:
            continue
        gamma = state[f"{p}bn.weight"].float()
        mean = state[f"{p}bn.running_mean"].float()
        var = state[f"{p}bn.running_var"].float()
        scale = gamma / torch.sqrt(var + eps)
        out[key] = val.float() * scale[:, None, None, None]
        out[f"{p}conv.bias"] = state[f"{p}bn.bias"].float() - mean * scale
    for key, val in state.items():
        module = key.rpartition(".")[0]
        is_bn = module == "bn" or module.endswith(".bn")
        if key in out or (is_bn and f"{module[:-2]}conv.bias" in out):
            continue  # folded conv weight, or an entry of a folded BN
        out[key] = val
    return out


def fold_for_serving(config, model: torch.nn.Module):
    """(config, model with BN) -> (folded config, folded model), on the
    model's device and in eval mode, for an SSDConfig, a RetinaNetConfig or
    a MaskRCNNConfig. Other config overrides are kept; an already folded
    config, or a model without BatchNorm (VGG16), passes through unchanged,
    as in the JAX package."""
    bns = [m for m in model.modules()
           if isinstance(m, torch.nn.BatchNorm2d)]
    if config.fold_bn or not bns:
        return config, model
    cfg = dataclasses.replace(config, fold_bn=True).validate()
    ref = next(model.parameters())
    folded = get_model(cfg).to(device=ref.device)
    folded.load_state_dict(fold_batch_norm(model.state_dict(), bns[0].eps))
    return cfg, folded.eval()
