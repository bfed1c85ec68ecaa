"""The whole serving slice at full width (SSD300-MobileNetV2, 2,268 anchors,
21 labels) on the trained checkpoint trained/ssd_mobilenet_v2/7680: the JAX
package restores and folds it, tfssd_torch.utils.convert carries it over,
and both paths run on the same synthetic images (the predictor's
evaluation split, SyntheticDataset(128, seed=10_000)).

Tolerances: taps and (deltas, logits) within 1e-4 (two float32 conv
implementations summing in different orders); NMSResult from the same
(deltas, logits) equal in classes and valid, boxes and scores within 1e-6;
mAP on 16 images within 1e-4.
"""

import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tfssd_torch import get_hyper_params as t_hyper  # noqa: E402
from tfssd_torch import predict as tpredict  # noqa: E402
from tfssd_torch.data.loader import batch_examples as t_batches  # noqa: E402
from tfssd_torch.data.synthetic import SyntheticDataset as TSynth  # noqa: E402
from tfssd_torch.evaluate import detections_from_nms_result as t_dets  # noqa: E402
from tfssd_torch.evaluate import evaluate_predictions as t_eval  # noqa: E402
from tfssd_torch.models.decoder import decode_predictions as t_decode  # noqa: E402
from tfssd_torch.models.decoder import preprocess_images as t_pre  # noqa: E402
from tfssd_torch.models.ssd import get_model as t_model  # noqa: E402
from tfssd_torch.ops.boxes import generate_anchors as t_anchors  # noqa: E402
from tfssd_torch.utils.convert import flatten_tree, load_variables  # noqa: E402
from tfssd_torch.utils.fold_bn import fold_for_serving as t_fold  # noqa: E402
from tfssd_tpu import get_hyper_params as j_hyper  # noqa: E402
from tfssd_tpu.data.loader import batch_examples as j_batches  # noqa: E402
from tfssd_tpu.data.synthetic import SyntheticDataset as JSynth  # noqa: E402
from tfssd_tpu.evaluate import detections_from_nms_result as j_dets  # noqa: E402
from tfssd_tpu.evaluate import evaluate_predictions as j_eval  # noqa: E402
from tfssd_tpu.models import get_model as j_model  # noqa: E402
from tfssd_tpu.models.decoder import decode_predictions as j_decode  # noqa: E402
from tfssd_tpu.models.mobilenet_v2 import MobileNetV2Backbone  # noqa: E402
from tfssd_tpu.ops.boxes import generate_anchors  # noqa: E402
from tfssd_tpu.train import TrainState, preprocess_images as j_pre  # noqa: E402
from tfssd_tpu.utils.checkpoint import CheckpointManager  # noqa: E402
from tfssd_tpu.utils.fold_bn import fold_for_serving as j_fold  # noqa: E402

CKPT = os.path.join(os.path.dirname(__file__), "..", "trained",
                    "ssd_mobilenet_v2")
STEP = 7680
N_IMAGES = 16
BATCH = 8
ATOL_MODEL = 1e-4
ATOL_NMS = 1e-6


@pytest.fixture(scope="module")
def trained():
    """Restored (unfolded) variables, as numpy, and the eval images."""
    ckpt = CheckpointManager(CKPT)
    try:
        state = ckpt.restore_weights(
            TrainState(step=0, params=None, batch_stats=None,
                       opt_state=None), STEP)
    finally:
        ckpt.close()
    variables = jax.tree_util.tree_map(
        np.asarray, {"params": state.params,
                     "batch_stats": state.batch_stats})
    ds = JSynth(128, image_size=300, seed=10_000)
    batches = list(j_batches((ds.example(i) for i in range(N_IMAGES)),
                             BATCH, 64))
    return variables, batches


@pytest.fixture(scope="module")
def jax_side(trained):
    """The JAX package's folded model: taps, (deltas, logits), NMSResult
    and mAP over the eval images."""
    variables, batches = trained
    cfg = j_hyper("mobilenet_v2")
    fcfg, fmodel, fvars = j_fold(cfg, variables)
    anchors = jnp.asarray(generate_anchors(cfg))

    def fwd(v, images):
        (deltas, logits), state = fmodel.apply(
            v, j_pre(images), capture_intermediates=lambda m, _: isinstance(
                m, MobileNetV2Backbone))
        taps = state["intermediates"]["backbone"]["__call__"][0]
        return taps, deltas, logits

    fwd = jax.jit(fwd)
    decode = jax.jit(lambda d, l: j_decode(anchors, d, l, fcfg))
    out, gts, dets = [], [], []
    for batch in batches:
        taps, deltas, logits = fwd(fvars, jnp.asarray(batch["image"]))
        res = decode(deltas, logits)
        out.append({"taps": [np.asarray(t) for t in taps],
                    "deltas": np.asarray(deltas),
                    "logits": np.asarray(logits), "nms": res})
        dets.extend(j_dets(res))
        gts.extend({"boxes": batch["boxes"][i], "labels": batch["labels"][i],
                    "difficult": batch["difficult"][i]}
                   for i in range(BATCH))
    m = j_eval(gts, dets, num_classes=20, verbose=False)["map"]
    return {"cfg": fcfg, "batches": out, "map": m, "gts": gts}


@pytest.fixture(scope="module")
def torch_side(trained):
    """The port's folded model on the same converted weights (CPU)."""
    variables, batches = trained
    model = load_variables(t_model(t_hyper("mobilenet_v2")), variables)
    cfg, model = t_fold(t_hyper("mobilenet_v2"), model.eval())
    anchors = torch.from_numpy(t_anchors(cfg))
    out = []
    with torch.no_grad():
        for batch in batches:
            images = t_pre(torch.from_numpy(batch["image"]))
            taps = model.features(images)
            deltas, logits = model.head(taps)
            out.append({"taps": [t.permute(0, 2, 3, 1).numpy() for t in taps],
                        "deltas": deltas, "logits": logits,
                        "nms": t_decode(anchors, deltas, logits, cfg)})
    return {"cfg": cfg, "anchors": anchors, "batches": out}


def test_synthetic_images_and_batches_byte_equal():
    jd, td = JSynth(128, image_size=300, seed=10_000), TSynth(
        128, image_size=300, seed=10_000)
    jb = list(j_batches((jd.example(i) for i in range(5)), 4, 64,
                        drop_remainder=False))
    tb = list(t_batches((td.example(i) for i in range(5)), 4, 64,
                        drop_remainder=False))
    assert len(jb) == len(tb) == 2
    for a, b in zip(jb, tb):
        for key in ("image", "boxes", "labels", "difficult"):
            np.testing.assert_array_equal(a[key], b[key])
        assert a["ids"] == b["ids"] and a["num_valid"] == b["num_valid"]


def test_taps_and_outputs_match(jax_side, torch_side):
    for jb, tb in zip(jax_side["batches"], torch_side["batches"]):
        assert [t.shape[1] for t in tb["taps"]] == [19, 10, 5, 3, 2, 1]
        for k, (jt, tt) in enumerate(zip(jb["taps"], tb["taps"])):
            np.testing.assert_allclose(tt, jt, atol=ATOL_MODEL,
                                       err_msg=f"tap {k}")
        assert tb["deltas"].shape == (BATCH, 2268, 4)
        assert tb["logits"].shape == (BATCH, 2268, 21)
        np.testing.assert_allclose(tb["deltas"].numpy(), jb["deltas"],
                                   atol=ATOL_MODEL)
        np.testing.assert_allclose(tb["logits"].numpy(), jb["logits"],
                                   atol=ATOL_MODEL)


def test_nms_from_the_same_outputs(jax_side, torch_side):
    for jb in jax_side["batches"]:
        got = t_decode(torch_side["anchors"], torch.tensor(jb["deltas"]),
                       torch.tensor(jb["logits"]), torch_side["cfg"])
        want = jb["nms"]
        np.testing.assert_array_equal(got.classes.numpy(),
                                      np.asarray(want.classes))
        np.testing.assert_array_equal(got.valid.numpy(),
                                      np.asarray(want.valid))
        np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                                   atol=ATOL_NMS)
        np.testing.assert_allclose(got.scores.numpy(),
                                   np.asarray(want.scores), atol=ATOL_NMS)


def test_map_matches(jax_side, torch_side):
    dets = []
    for tb in torch_side["batches"]:
        dets.extend(t_dets(type(tb["nms"])(*(t.numpy() for t in tb["nms"]))))
    m = t_eval(jax_side["gts"], dets, num_classes=20, verbose=False)["map"]
    assert jax_side["map"] > 0.5  # the trained model really detects
    assert abs(m - jax_side["map"]) <= 1e-4, (m, jax_side["map"])


def test_predict_cli_with_npz_weights(trained, jax_side, tmp_path):
    # Unfolded tree in the .npz: the CLI converts and folds it itself.
    variables, _ = trained
    path = tmp_path / "mbv2.npz"
    np.savez(path, **flatten_tree(variables))
    run = tpredict.main(["--weights", str(path), "--limit", str(N_IMAGES),
                         "--batch-size", str(BATCH), "--device", "cpu"])
    assert sum(run.num_valid) == N_IMAGES
    assert abs(run.mean_ap - jax_side["map"]) <= 1e-4


def test_predict_cli_with_folded_npz_weights(trained, jax_side, tmp_path):
    # Folded tree (the JAX fold_for_serving's output) in the .npz: the CLI
    # reads it as folded and serves it as it is.
    variables, _ = trained
    _, _, fvars = j_fold(j_hyper("mobilenet_v2"), variables)
    path = tmp_path / "mbv2_folded.npz"
    np.savez(path, **flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                         dict(fvars))))
    run = tpredict.main(["--weights", str(path), "--limit", str(N_IMAGES),
                         "--batch-size", str(BATCH), "--device", "cpu"])
    assert run.config.fold_bn
    assert sum(run.num_valid) == N_IMAGES
    assert abs(run.mean_ap - jax_side["map"]) <= 1e-4


def test_unfolded_model_matches(trained):
    variables, batches = trained
    images = batches[0]["image"][:2]
    model = j_model(j_hyper("mobilenet_v2"))
    deltas, logits = jax.jit(model.apply)(variables,
                                          j_pre(jnp.asarray(images)))
    tmodel = load_variables(t_model(t_hyper("mobilenet_v2")),
                            variables).eval()
    with torch.no_grad():
        td, tl = tmodel(t_pre(torch.from_numpy(images)))
    np.testing.assert_allclose(td.numpy(), np.asarray(deltas),
                               atol=ATOL_MODEL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(logits),
                               atol=ATOL_MODEL)
