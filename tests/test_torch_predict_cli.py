"""`python -m tfssd_torch.predict` against the JAX predictor on the committed
checkpoint (trained/ssd_mobilenet_v2/7680), on the CPU, at full width
(SSD300-MobileNetV2, 2,268 anchors) on the predictor's synthetic
evaluation split, SyntheticDataset(128, seed=10_000), batch 8.

- With no weight flag the CLI reads the checkpoint's best step without
  orbax and serves it: mAP within 1e-4 of the JAX predictor's on 16
  images (measured: equal).
- chip_smoke.TRAINED_MAP_JAX, the constant the card is held to, is the
  JAX predictor's mAP on the 128 images within 1e-6.
- A missing checkpoint stops the run with the reference's message before
  the model is built; --dataset voc without --data-root too.
- --no-fold-bn serves the unfolded model: its (deltas, logits) within
  1e-4 of JAX's unfolded model on the same images, and the mAP within
  1e-4.
- --device-cache on and off give identical NMSResults, and --limit serves
  exactly that many images on both feeds.
- bfloat16 (load_model on the checkpoint directory + serve) against JAX's
  bfloat16 predictor, in the terms of tests/test_torch_bf16.py: (deltas,
  logits) within REL of each output's scale with at least MBV2_BIT_EQUAL
  of them bit-equal, detection agreement at least AGREEMENT, mAP within
  MAP_TOL.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from test_torch_bf16 import (AGREEMENT, MAP_TOL, MBV2_BIT_EQUAL,  # noqa: E402
                             REL, _held)
from test_torch_predict_parity import (MBV2_DIR, MBV2_STEP,  # noqa: E402
                                       jax_map, jax_predictions)
from tfssd_torch import predict  # noqa: E402
from tfssd_torch.data.synthetic import SyntheticDataset as TSynth  # noqa: E402
from tfssd_torch.evaluate import detection_agreement  # noqa: E402
from tfssd_torch.ops.nms import NMSResult  # noqa: E402
from tfssd_tpu.data.synthetic import SyntheticDataset  # noqa: E402

N_CLI = 16
BATCH = 8
ATOL_MODEL = 1e-4
CPU = ["--device", "cpu", "--batch-size", str(BATCH)]


def _concat(results):
    return NMSResult(*(np.concatenate(f) for f in zip(*results)))


def _eval_examples(n):
    ds = SyntheticDataset(128, image_size=300, seed=10_000)
    return [ds.example(i) for i in range(n)]


@pytest.fixture(scope="module")
def jax_128():
    """The JAX predictor's detections on the 128 evaluation images."""
    return jax_predictions(_eval_examples(128), BATCH)


def test_trained_map_jax_constant_is_the_jax_predictors(jax_128):
    assert abs(jax_map(jax_128) - chip_smoke.TRAINED_MAP_JAX) <= 1e-6


def test_cli_serves_the_committed_checkpoint(jax_128, capsys):
    run = predict.main(CPU + ["--limit", str(N_CLI)])
    assert f"loaded checkpoint step {MBV2_STEP}" in capsys.readouterr().out
    assert run.config.fold_bn and run.device_cached
    assert sum(run.num_valid) == N_CLI
    want = jax_map(jax_128, N_CLI)
    assert want > 0.5  # the trained model really detects
    assert abs(run.mean_ap - want) <= 1e-4, (run.mean_ap, want)


def test_missing_checkpoint_exits_before_the_model_is_built(tmp_path,
                                                            monkeypatch):
    def no_build(*args, **kwargs):
        raise AssertionError("the model was built")

    monkeypatch.setattr(predict, "get_model", no_build)
    monkeypatch.setattr(predict, "init_random_weights", no_build)
    with pytest.raises(SystemExit, match="no checkpoint for mobilenet_v2 "
                       f"under {tmp_path}; train first or pass "
                       "--random-weights"):
        predict.main(CPU + ["--model-dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="--dataset voc needs a --data-root"):
        predict.main(CPU + ["--dataset", "voc"])


def test_no_fold_bn_serves_the_unfolded_model():
    examples = _eval_examples(BATCH)
    want = jax_predictions(examples, BATCH, fold=False)
    run = predict.main(CPU + ["--limit", str(BATCH), "--no-fold-bn"])
    assert not run.config.fold_bn
    assert any(isinstance(m, torch.nn.BatchNorm2d)
               for m in run.model.modules())
    for got, ref in zip(run.outputs[0], want["outputs"][0]):
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL_MODEL)
    assert abs(run.mean_ap - jax_map(want)) <= 1e-4


def test_device_cache_on_and_off_serve_the_same_rows():
    argv = CPU + ["--limit", "10", "--batch-size", "4"]
    on = predict.main(argv + ["--device-cache", "on"])
    off = predict.main(argv + ["--device-cache", "off", "--workers", "3"])
    assert on.device_cached and not off.device_cached
    # --limit 10 at batch 4: three batches, the last with 2 real rows
    assert on.num_valid == off.num_valid == [4, 4, 2]
    assert on.ids == off.ids
    for a, b in zip(on.results, off.results):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert on.mean_ap == off.mean_ap


def test_bfloat16_on_the_checkpoint_against_jax():
    examples = _eval_examples(2 * BATCH)
    want = jax_predictions(examples, BATCH, compute_dtype="bfloat16")
    cfg, model = predict.load_model("mobilenet_v2", MBV2_DIR, device="cpu",
                                    compute_dtype="bfloat16")
    assert cfg.fold_bn and cfg.compute_dtype == "bfloat16"
    dataset = TSynth(128, image_size=300, seed=10_000)
    run = predict.serve(model, cfg, dataset, BATCH, 2 * BATCH)
    for got, ref in zip(run.outputs, want["outputs"]):
        for g, r, name in zip(got, ref, ("deltas", "logits")):
            _held(g, r, REL, MBV2_BIT_EQUAL, name)
    got = NMSResult(*(np.concatenate([t.numpy() for t in f])
                      for f in zip(*run.results)))
    assert detection_agreement(got, _concat(want["results"])) >= AGREEMENT
    assert abs(run.mean_ap - jax_map(want)) <= MAP_TOL
