"""The JAX predictor's side of the serving CLI's parity tests
(test_torch_predict_cli.py, test_torch_voc.py); no tests here.

`jax_predictions` runs what predictor.py runs on the examples it is given
(the committed checkpoint restored by CheckpointManager.restore_weights,
BatchNorm folded unless asked not to, the model's forward and
decode_predictions jitted, batches padded by the JAX package's
batch_examples), on one CPU device: the JAX
predictor's data-parallel mesh only splits a batch across devices, and
gives the same detections (its mAP on the 128 synthetic images is the same
to the last digit at 1 and 8 devices).
"""

import functools
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tfssd_tpu import get_hyper_params  # noqa: E402
from tfssd_tpu.data.loader import batch_examples  # noqa: E402
from tfssd_tpu.evaluate import (detections_from_nms_result,  # noqa: E402
                                evaluate_predictions)
from tfssd_tpu.models import get_model  # noqa: E402
from tfssd_tpu.models.decoder import decode_predictions  # noqa: E402
from tfssd_tpu.ops.boxes import generate_anchors  # noqa: E402
from tfssd_tpu.train import TrainState, preprocess_images  # noqa: E402
from tfssd_tpu.utils.checkpoint import CheckpointManager  # noqa: E402
from tfssd_tpu.utils.fold_bn import fold_for_serving  # noqa: E402

TRAINED = os.path.join(os.path.dirname(__file__), "..", "trained")
MBV2_DIR = os.path.join(TRAINED, "ssd_mobilenet_v2")
MBV2_STEP = 7680


@functools.lru_cache(maxsize=None)
def jax_restore(directory: str = MBV2_DIR, step: int = MBV2_STEP):
    """CheckpointManager.restore_weights of `step`, leaves as numpy:
    {'step', 'params', 'batch_stats'}."""
    ckpt = CheckpointManager(directory)
    try:
        state = ckpt.restore_weights(
            TrainState(step=0, params=None, batch_stats=None,
                       opt_state=None), step)
    finally:
        ckpt.close()
    return jax.tree_util.tree_map(np.asarray, {
        "step": state.step, "params": state.params,
        "batch_stats": state.batch_stats})


@functools.lru_cache(maxsize=None)
def _predict_fn(fold: bool, compute_dtype: str):
    variables = {k: v for k, v in jax_restore().items() if k != "step"}
    cfg = get_hyper_params("mobilenet_v2", compute_dtype=compute_dtype)
    model = get_model(cfg)
    if fold:
        cfg, model, variables = fold_for_serving(cfg, variables)
    anchors = jnp.asarray(generate_anchors(cfg))
    apply = jax.jit(lambda v, x: model.apply(v, preprocess_images(x),
                                             train=False))
    decode = jax.jit(lambda d, l: decode_predictions(anchors, d, l, cfg))
    return cfg, variables, apply, decode


def jax_predictions(examples, batch_size: int = 8, fold: bool = True,
                    compute_dtype: str = "float32"):
    """Per image of `examples`: its detections (as
    detections_from_nms_result splits them) and ground truth; per batch,
    the host NMSResult of its real rows and the model's (deltas, logits).
    The forward and the decode are jitted apart (one compile of the model
    serves both), as make_predict_fn chains them."""
    cfg, variables, apply, decode = _predict_fn(fold, compute_dtype)
    dets, gts, results, outs = [], [], [], []
    for batch in batch_examples(list(examples), batch_size,
                                cfg.max_gt_boxes, drop_remainder=False):
        deltas, logits = apply(variables, jnp.asarray(batch["image"]))
        res = decode(deltas, logits)
        nv = batch["num_valid"]
        dets.extend(detections_from_nms_result(res, num_valid=nv))
        gts.extend({"boxes": batch["boxes"][i], "labels": batch["labels"][i],
                    "difficult": batch["difficult"][i]} for i in range(nv))
        results.append(type(res)(*(np.asarray(t)[:nv] for t in res)))
        outs.append((np.asarray(deltas), np.asarray(logits)))
    return {"dets": dets, "gts": gts, "results": results, "outputs": outs}


def jax_map(pred, n=None) -> float:
    """The JAX package's VOC07 mAP over the first `n` images of a
    jax_predictions result."""
    n = len(pred["gts"]) if n is None else n
    return evaluate_predictions(pred["gts"][:n], pred["dets"][:n],
                                num_classes=20, verbose=False)["map"]
