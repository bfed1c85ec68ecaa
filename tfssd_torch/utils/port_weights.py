"""Keras trunk files -> the port's model: the `--port-h5` path of both CLIs
(port of the JAX package's utils/port_weights.py), with no TensorFlow,
Keras or h5py: the files are read by utils/hdf5.py.

A user of the reference brings a Keras model whose conv trunk the SSD is
fine-tuned from:

  * keras.applications.MobileNetV2 trunk -> models/mobilenet_v2.py names
  * keras.applications.VGG16 conv trunk  -> models/vgg16.py names

`load_keras_h5` reads a file that Keras's `model.save` wrote, in either
format, and gives the dict that the JAX package's
`keras_model_weights(keras.models.load_model(path))` gives, key for key:
`<layer name>/<variable name>`, in the model's layer order.

  .h5     (legacy HDF5) the root attribute `model_config` (the model's
          JSON), and under `model_weights` one group per layer, listed by
          the attribute `layer_names`, each with its `weight_names` (split
          into `layer_names0`, `layer_names1`, ... where too large for one
          attribute, as Keras splits them). A file without `model_config`
          (one that `save_weights` wrote) holds no model and is refused.
  .keras  a zip of `config.json` (the model's JSON) and `model.weights.h5`,
          whose variables lie under `layers/<auto name>/vars/<i>`: the auto
          name is the layer's class in snake case, numbered from its second
          occurrence in the model's layer list (Keras's saving_lib), so the
          layer list of `config.json` names them.

In both, a variable's name comes from its layer's class and config, and its
value from its position, as Keras assigns a loaded model's variables:
Conv2D and DepthwiseConv2D hold `kernel`, then `bias` where `use_bias`;
BatchNormalization `gamma` where `scale`, `beta` where `center`, then
`moving_mean` and `moving_variance`. Any other layer that holds variables
raises.

Layout: Keras Conv2D kernels are HWIO, as Flax's; a DepthwiseConv2D kernel
(H, W, Cin, 1) becomes Flax's grouped (H, W, 1, Cin). `port_mobilenet_v2` /
`port_vgg16` give the Flax-named {"params", "batch_stats"} subtree of the
backbone that the JAX package's functions give, and `graft` writes it into
a model through utils/convert.py's Flax -> torch bridge, in place.
"""

from __future__ import annotations

import json
import re
import zipfile
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from tfssd_torch.utils.convert import flatten_tree, variables_to_state_dict
from tfssd_torch.utils.hdf5 import H5File

# MobileNetV2 block schedule (t, c, n, s), as models/mobilenet_v2.py's.
_MBV2_SCHEDULE = (
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
)


def _conv_bn(weights: Mapping[str, np.ndarray], conv_name: str, bn_name: str,
             depthwise: bool = False) -> Dict:
    """One ConvBN Flax subtree from Keras layer weights."""
    kernel = weights[f"{conv_name}/kernel"]
    if depthwise:
        kernel = np.transpose(kernel, (0, 1, 3, 2))  # (H,W,Cin,1)->(H,W,1,Cin)
    return {
        "params": {"conv": {"kernel": kernel},
                   "bn": {"scale": weights[f"{bn_name}/gamma"],
                          "bias": weights[f"{bn_name}/beta"]}},
        "batch_stats": {"bn": {"mean": weights[f"{bn_name}/moving_mean"],
                               "var": weights[f"{bn_name}/moving_variance"]}},
    }


def _merge(dst: Dict, name: str, sub: Dict) -> None:
    dst.setdefault("params", {})[name] = sub["params"]
    dst.setdefault("batch_stats", {})[name] = sub["batch_stats"]


def port_mobilenet_v2(weights: Mapping[str, np.ndarray]) -> Dict:
    """Keras MobileNetV2 trunk -> the {'params', 'batch_stats'} subtree of
    the MobileNetV2 backbone (trunk and head_conv; the SSD extras are not in
    the Keras model)."""
    tree: Dict = {"params": {}, "batch_stats": {}}
    _merge(tree, "stem", _conv_bn(weights, "Conv1", "bn_Conv1"))
    block_idx = 0
    for t, c, n, s in _MBV2_SCHEDULE:
        for i in range(n):
            stride = s if i == 0 else 1
            sub: Dict = {"params": {}, "batch_stats": {}}
            if block_idx == 0:
                # Keras's "expanded_conv": no expand conv (t = 1)
                _merge(sub, "depthwise", _conv_bn(
                    weights, "expanded_conv_depthwise",
                    "expanded_conv_depthwise_BN", depthwise=True))
                _merge(sub, "project", _conv_bn(
                    weights, "expanded_conv_project",
                    "expanded_conv_project_BN"))
            else:
                kp = f"block_{block_idx}"
                for part, depthwise in (("expand", False),
                                        ("depthwise", True),
                                        ("project", False)):
                    _merge(sub, part, _conv_bn(weights, f"{kp}_{part}",
                                               f"{kp}_{part}_BN", depthwise))
            if stride == 2 and c == 160:
                # the tap block is flattened in the backbone:
                # block{idx}_expand / _depthwise / _project
                for part in ("expand", "depthwise", "project"):
                    _merge(tree, f"block{block_idx}_{part}",
                           {k: v[part] for k, v in sub.items()})
            else:
                _merge(tree, f"block{block_idx}", sub)
            block_idx += 1
    _merge(tree, "head_conv", _conv_bn(weights, "Conv_1", "Conv_1_bn"))
    return tree


def port_vgg16(weights: Mapping[str, np.ndarray]) -> Dict:
    """Keras VGG16 conv trunk -> the params subtree of the VGG16 backbone
    (conv1_1 .. conv5_3; fc6, fc7, the extras and L2Norm are SSD's own)."""
    params: Dict = {}
    for b, n in enumerate((2, 2, 3, 3, 3), start=1):
        for i in range(1, n + 1):
            k = f"block{b}_conv{i}"
            params[f"conv{b}_{i}"] = {"kernel": weights[f"{k}/kernel"],
                                      "bias": weights[f"{k}/bias"]}
    return {"params": params}


def _variable_names(layer: str, class_name: str, config: Mapping) -> List[str]:
    """The names of a layer's variables, in the order Keras saves them
    (trainable, then non-trainable)."""
    if class_name in ("Conv2D", "DepthwiseConv2D"):
        return ["kernel"] + (["bias"] if config.get("use_bias", True) else [])
    if class_name == "BatchNormalization":
        return ((["gamma"] if config.get("scale", True) else [])
                + (["beta"] if config.get("center", True) else [])
                + ["moving_mean", "moving_variance"])
    raise ValueError(f"layer {layer!r} of class {class_name} holds variables; "
                     f"only Conv2D, DepthwiseConv2D and BatchNormalization "
                     f"layers are read")


def _layers(model_config: str) -> List[Tuple[str, str, Mapping]]:
    """(name, class name, config) of every layer of a model's JSON, in
    the model's layer order."""
    layers = json.loads(model_config)["config"]["layers"]
    return [(e["config"]["name"], e["class_name"], e["config"])
            for e in layers]


def snake_case(name: str) -> str:
    """A class name as keras.src.utils.naming.to_snake_case writes it: the
    stem of a layer's auto name in a .keras file."""
    name = re.sub(r"\W+", "", name)
    name = re.sub("(.)([A-Z][a-z]+)", r"\1_\2", name)
    return re.sub("([a-z])([A-Z])", r"\1_\2", name).lower()


def _split_attribute(attrs: Mapping, name: str) -> List:
    """An attribute that Keras may have split into name0, name1, ..."""
    if name in attrs:
        return list(attrs[name])
    out, i = [], 0
    while f"{name}{i}" in attrs:
        out.extend(attrs[f"{name}{i}"])
        i += 1
    return out


def _named(out: Dict[str, np.ndarray], layer: str, class_name: str,
           config: Mapping, values: List[np.ndarray]) -> None:
    names = _variable_names(layer, class_name, config)
    if len(names) != len(values):
        raise ValueError(f"layer {layer!r} ({class_name}) holds "
                         f"{len(values)} variables where its config names "
                         f"{len(names)}: {names}")
    for name, value in zip(names, values):
        out[f"{layer}/{name}"] = value


def _load_legacy_h5(path: str, f: H5File) -> Dict[str, np.ndarray]:
    root = f.attrs("/")
    if "model_config" not in root:
        raise ValueError(f"{path}: no model_config attribute: not a model "
                         f"that Keras's model.save wrote (a save_weights "
                         f"file holds no model)")
    if "model_weights" not in f.keys("/"):
        raise ValueError(f"{path}: no model_weights group")
    layers = {name: (cls, cfg) for name, cls, cfg in
              _layers(root["model_config"])}
    out: Dict[str, np.ndarray] = {}
    for layer in _split_attribute(f.attrs("/model_weights"), "layer_names"):
        group = f"/model_weights/{layer}"
        weight_names = _split_attribute(f.attrs(group), "weight_names")
        if not weight_names:
            continue
        if layer not in layers:
            raise ValueError(f"{path}: layer {layer!r} holds weights but is "
                             f"not in model_config")
        _named(out, layer, *layers[layer],
               [f.read(f"{group}/{w}") for w in weight_names])
    return out


def _load_keras_zip(path: str) -> Dict[str, np.ndarray]:
    with zipfile.ZipFile(path) as z:
        model_config = z.read("config.json").decode("utf-8")
        f = H5File(z.read("model.weights.h5"))
    saved = set(f.keys("/layers"))
    used: Dict[str, int] = {}
    out: Dict[str, np.ndarray] = {}
    for layer, class_name, config in _layers(model_config):
        auto = snake_case(class_name)
        if auto in used:
            used[auto] += 1
            auto = f"{auto}_{used[auto]}"
        else:
            used[auto] = 0
        group = f"/layers/{auto}/vars"
        if auto not in saved or "vars" not in f.keys(f"/layers/{auto}"):
            continue
        count = len(f.keys(group))
        if count:
            _named(out, layer, class_name, config,
                   [f.read(f"{group}/{i}") for i in range(count)])
    return out


def load_keras_h5(path: str) -> Dict[str, np.ndarray]:
    """{'<layer>/<variable>': array} of a Keras model file, .h5 or .keras
    (told apart by their contents), in the model's layer order."""
    path = str(path)
    if zipfile.is_zipfile(path):
        return _load_keras_zip(path)
    return _load_legacy_h5(path, H5File(path))


def graft(model: nn.Module, backbone_tree: Mapping,
          backbone_name: str = "backbone") -> nn.Module:
    """Write a ported backbone subtree ({'params', 'batch_stats'}, Flax
    names and layouts) into `model`'s parameters and buffers in place,
    through utils/convert.py's bridge: only the ported leaves change (the
    heads and extras keep theirs), and an optimizer built over the model
    keeps stepping the same tensors. Every leaf is checked before any is
    written: a leaf with no destination raises KeyError (a tree of another
    backbone), one whose shape differs ValueError."""
    tree = {coll: {backbone_name: sub} for coll, sub in backbone_tree.items()
            if sub}
    targets = dict(model.named_parameters())
    targets.update(model.named_buffers())
    updates = []
    for path, arr in flatten_tree(tree).items():
        (key, value), = [kv for kv in variables_to_state_dict(
            {path: arr}).items() if not kv[0].endswith("num_batches_tracked")]
        if key not in targets:
            raise KeyError(f"ported weight {path} has no destination in the "
                           f"model (wrong backbone for this weight tree?)")
        if value.shape != targets[key].shape:
            raise ValueError(f"shape mismatch at {path}: ported "
                             f"{tuple(arr.shape)} (as {key}: "
                             f"{tuple(value.shape)}) vs model "
                             f"{tuple(targets[key].shape)}")
        updates.append((targets[key], value))
    with torch.no_grad():
        for target, value in updates:
            target.copy_(value)
    return model


def port_h5_into_variables(model: nn.Module, backbone: str,
                           h5_path: str) -> nn.Module:
    """The --port-h5 path of tfssd_torch.predict and tfssd_torch.trainer:
    read a Keras model file, port its trunk (MobileNetV2 for the
    mobilenet_v2 config, VGG16 otherwise) and graft it into `model`."""
    weights = load_keras_h5(h5_path)
    porter = port_mobilenet_v2 if backbone == "mobilenet_v2" else port_vgg16
    return graft(model, porter(weights))
