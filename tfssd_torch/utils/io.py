"""CLI argument handling and path conventions (port of the JAX package's
utils/io.py; reference: utils/io_utils.py).

The port's checkpoints go to <model-dir>/ssd_<backbone>_torch, never to
the JAX package's <model-dir>/ssd_<backbone>: the repository's trained/
holds the JAX package's committed checkpoint there, which the port only
reads.
"""

from __future__ import annotations

import argparse
import datetime
import os

# The trainer's choices. The port serves VGG16 and SSD512 too
# (predict.py), but trains only MobileNetV2: "vgg16" and "vgg16_512" join
# here when VGG16 training is ported (ROADMAP.md).
VALID_BACKBONES = ("mobilenet_v2",)


def handle_args(description: str = "tfssd_torch") -> argparse.ArgumentParser:
    """Base argparse surface of the port's CLIs (callers add their own
    flags)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--backbone", default="mobilenet_v2",
                   choices=VALID_BACKBONES,
                   help="which SSD backbone to train (only MobileNetV2 "
                        "trains in the port so far)")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--dataset", default="synthetic", choices=("synthetic",),
                   help="VOC directories are not ported yet")
    p.add_argument("--model-dir", default="trained")
    p.add_argument("--log-dir", default="logs")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p


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
