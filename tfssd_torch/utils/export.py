"""Ahead-of-time export of the whole predict path (port of the JAX
package's utils/export.py).

`export_predict` records forward + decode + combined NMS, the weights
inside, with `torch.export` and serialises it (`torch.export.save`) to
bytes; `load_exported` turns those bytes back into a callable on the
device asked for. The JAX package serialises StableHLO for ("cpu", "tpu");
here one artifact serves on the CPU and on the card: the program is moved
with `torch.export.passes.move_to_device_pass`, and its one NMS node is the
custom operator `tfssd::nms_keep`, whose dispatcher runs the plain version
on CPU tensors and launches the hand-written kernel on CUDA tensors.

What a serving process needs: `tfssd_torch.ops.kernels` (imported here:
it registers `tfssd::nms_keep`) and `tfssd_torch.ops.nms` (imported here:
it registers `NMSResult` under its stable name), but no model code, as the
JAX artifact needs only its namedtuple's registration:

    from tfssd_torch.utils.export import export_predict, load_exported
    blob = export_predict(model, anchors, cfg, batch_size=8)
    open("ssd.pt2", "wb").write(blob)
    ...
    serve = load_exported(open("ssd.pt2", "rb").read(), "cuda")
    result = serve(images)   # NMSResult (boxes, scores, classes, valid)

The exported function takes one float32 (batch_size, S, S, 3) image batch
already in [-1, 1] (models/decoder.py:preprocess_images) and returns the
NMSResult with classes in the label space. `predict --export PATH`
exposes it.
"""

from __future__ import annotations

import io
from typing import Callable

import numpy as np
import torch

import tfssd_torch.ops.kernels  # noqa: F401  (registers tfssd::nms_keep)
from tfssd_torch.ops.nms import NMSResult


class _Predict(torch.nn.Module):
    """forward(images in [-1, 1]) -> NMSResult: the model in eval mode,
    then decode and combined NMS (models/decoder.py)."""

    def __init__(self, model: torch.nn.Module, anchors: torch.Tensor,
                 config):
        super().__init__()
        self.model = model
        self.register_buffer("anchors", anchors)
        self.config = config

    def forward(self, images: torch.Tensor) -> NMSResult:
        # imported here, where only an export traces it: a process that
        # loads an artifact imports no module of tfssd_torch.models
        from tfssd_torch.models.decoder import decode_predictions

        deltas, logits = self.model(images)
        return decode_predictions(self.anchors, deltas, logits, self.config)


def export_predict(model: torch.nn.Module, anchors: np.ndarray, config,
                   batch_size: int) -> bytes:
    """The predict path of `model` (its weights inside) for float32
    (batch_size, S, S, 3) images in [-1, 1], exported on the model's
    device and serialised. The model is put in eval mode."""
    device = next(model.parameters()).device
    wrapper = _Predict(model.eval(), torch.as_tensor(
        anchors, dtype=torch.float32, device=device), config).eval()
    example = torch.zeros((batch_size, config.img_size, config.img_size, 3),
                          dtype=torch.float32, device=device)
    with torch.no_grad():
        program = torch.export.export(wrapper, (example,))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_exported(blob: bytes, device="cuda"
                  ) -> Callable[[torch.Tensor], NMSResult]:
    """An export_predict artifact as a callable on `device`: images
    (batch_size, S, S, 3) float32 in [-1, 1] on that device -> NMSResult,
    without autograd."""
    from torch.export.passes import move_to_device_pass

    program = torch.export.load(io.BytesIO(blob))
    module = move_to_device_pass(program, torch.device(device)).module()

    def serve(images: torch.Tensor) -> NMSResult:
        with torch.no_grad():
            return module(images)

    return serve
