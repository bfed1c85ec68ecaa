"""tfssd_torch — the PyTorch/CUDA port of the SSD detection system.

The JAX package beside it is the reference every module here is held
against (tests/test_torch_*.py). This package imports torch, numpy and the
standard library only. Its structure mirrors the JAX package's file names:

  config.py            SSDConfig, get_hyper_params (plain copy)
  ops/boxes.py         anchors, IoU, encode/decode, clip
  ops/nms.py           combined per-class NMS
  ops/matching.py      gt matching + target encoding (plain version)
  ops/losses.py        hard-negative-mined SSD loss
  ops/kernels/         hand-written CUDA kernels as custom ops, their plain
                       versions, build
  models/              MobileNetV2 and VGG16 (SSD300, SSD512) trunks +
                       extras, multibox head, SSD, decoder
  utils/fold_bn.py     BatchNorm folding for serving
  utils/convert.py     Flax variables / TrainState (numpy) -> torch
  utils/checkpoint.py  torch.save checkpoints, best-3 retention, resume;
                       the JAX package's orbax checkpoints, read-only
  utils/ocdbt.py       reader of orbax's OCDBT key-value store
  utils/zstd.py        one zstd frame, libzstd by ctypes
  utils/metrics.py     JSONL metrics log, step timer
  utils/io.py          CLI arguments, model and log paths, --data-root
  utils/drawing.py     detections drawn on images (PIL, lazily)
  utils/export.py      the predict path as one torch.export artifact
  data/                synthetic scenes, VOC roots and image folders,
                       padding/batching, staging, augmentation on the
                       device
  train.py             train state, train/eval steps, LR schedule
  evaluate.py          VOC mAP
  predict.py           the serving CLI (python -m tfssd_torch.predict)
  trainer.py           the training CLI (python -m tfssd_torch.trainer)
  parallel.py          data parallelism over torch.distributed (torchrun)
  profile_serving.py   where the serving time goes on the card
  profile_train.py     where a train step's time goes on the card
  time_paths.py        serving img/s and train ms/step, to compare checkouts

Public functions keep the JAX package's layouts (NHWC images, (B, N, 4)
boxes); modules inside are NCHW. Entry points run on "cuda" unless the
caller passes device="cpu".
"""

import torch

from tfssd_torch.config import SSDConfig, get_hyper_params  # noqa: F401

__version__ = "0.1.0"

# The port computes in float32 unless SSDConfig.compute_dtype says
# bfloat16, and its float32 parts stay float32 then too. cuDNN convolutions
# default to TF32 on Hopper, which keeps about three decimal digits: turn it
# off for convolutions and matmuls alike.
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. "cuda" (the default) needs a card
    and raises without one: nothing falls back to the CPU unless the
    caller asks for device="cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run the plain CPU path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
