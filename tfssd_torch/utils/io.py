"""CLI argument handling and path conventions (port of the JAX package's
utils/io.py; reference: utils/io_utils.py).

The port's checkpoints go to <model-dir>/ssd_<backbone>_torch, never to
the JAX package's <model-dir>/ssd_<backbone>: the repository's trained/
holds the JAX package's committed checkpoint there, which the port only
reads (get_jax_model_path; the predictor's default weights).
"""

from __future__ import annotations

import argparse
import datetime
import os

# The JAX package's three configurations: SSD300-MobileNetV2,
# SSD300-VGG16 and SSD512-VGG16. The trainer and the predictor take each.
VALID_BACKBONES = ("mobilenet_v2", "vgg16", "vgg16_512")


def handle_args(description: str = "tfssd_torch",
                datasets=("synthetic",)) -> argparse.ArgumentParser:
    """Base argparse surface of the port's CLIs (callers add their own
    flags). `datasets` are the --dataset choices; with "voc" among them
    comes the repeatable --data-root ROOT[:SPLIT]."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--backbone", default="mobilenet_v2",
                   choices=VALID_BACKBONES,
                   help="which SSD configuration: mobilenet_v2 "
                        "(SSD300), vgg16 (SSD300) or vgg16_512 (SSD512)")
    p.add_argument("-handle-gpu", "--handle-gpu", action="store_true",
                   help="accepted so that the reference's command lines "
                        "parse; changes nothing (PyTorch's caching "
                        "allocator grows device memory as needed)")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--dataset", default="synthetic", choices=datasets)
    if "voc" in datasets:
        p.add_argument("--data-root", action="append", default=None,
                       help="VOCdevkit/VOC2007-style directory, optionally "
                            "with a split as ROOT:SPLIT; repeatable, the "
                            "roots read one after another")
    p.add_argument("--model-dir", default="trained")
    p.add_argument("--log-dir", default="logs")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p


def parse_data_root(spec: str, default_split: str):
    """A --data-root spec "ROOT[:SPLIT]" -> (root, split). The part after
    the last colon is a split only when it has no path separator, so a
    plain path keeps working."""
    root, sep, split = spec.rpartition(":")
    if sep and split and os.sep not in split and root:
        return root, split
    return spec, default_split


def get_jax_model_path(backbone: str, model_dir: str = "trained") -> str:
    """The JAX package's checkpoint directory for a backbone,
    <model_dir>/ssd_<backbone> (read by the predictor; nothing is
    created)."""
    return os.path.join(model_dir, f"ssd_{backbone}")


def get_model_path(backbone: str, model_dir: str = "trained") -> str:
    """The port's checkpoint directory for a backbone:
    <model_dir>/ssd_<backbone>_torch."""
    os.makedirs(model_dir, exist_ok=True)
    return os.path.join(model_dir, f"ssd_{backbone}_torch")


def get_log_path(backbone: str, log_dir: str = "logs") -> str:
    """A timestamped run directory under <log_dir>/ssd_<backbone>_torch."""
    stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    path = os.path.join(log_dir, f"ssd_{backbone}_torch", stamp)
    os.makedirs(path, exist_ok=True)
    return path
