"""Smoke test of the PyTorch/CUDA port (tfssd_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

  1. build  — nvcc builds every kernel of the serving path from
              tfssd_torch/csrc/ into build/tfssd_torch/ (seconds printed).
  2. kernel — the NMS keep kernel on the real candidates of the path's
              first batch (R = 8 images x 20 classes, K = 200) and of a
              batch of 64, held bit-equal against its plain PyTorch version
              on the card; both kept and suppressed entries must occur.
  3. path   — `python -m tfssd_torch.predict` (its main()) serves 32
              synthetic images at batch 8 through SSD300-MobileNetV2 at
              full width with seeded weights; the kernel's launch counter is
              set to 0 just before and read just after. The card's
              (deltas, logits) are held against the same model on the CPU
              (|card - cpu| <= 1e-3 + 1e-3 |cpu|, float32 without TF32), and
              the card's NMSResult against the CPU plain path fed the card's
              decoded boxes and scores (classes and valid equal, boxes and
              scores within 1e-6).
  4. timing — img/s at batch 8 and 64 (device-resident uint8 images ->
              NMSResult), the kernel's and the plain version's ms per call
              at R = 160 and R = 1280, the card's name and power limit.
  5. the `kernels` JSON line, then the one-line JSON result, last.

It exits non-zero without a result when no CUDA device is available, and
in a directory that holds this script without the tfssd_torch package.
It writes nothing outside build/.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from tfssd_torch import predict
from tfssd_torch.data.synthetic import SyntheticDataset
from tfssd_torch.models.decoder import (decode_boxes_and_scores,
                                        make_predict_fn, preprocess_images)
from tfssd_torch.ops import nms
from tfssd_torch.ops.boxes import generate_anchors
from tfssd_torch.ops.kernels import build
from tfssd_torch.ops.kernels import nms_keep

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# Operations of one IoU and its comparison: 4 max/min, 2 subtractions,
# 2 clamps, 1 multiply (intersection), 2 add/sub (union), 1 clamp, 1 divide,
# 1 compare; areas and the scan are O(K) per instance and left out.
OPS_PER_IOU = 15

PATH_BATCH = 8
PATH_IMAGES = 32
SEED = 0


def section(name: str) -> None:
    print(f"== {name}", flush=True)


def reference_site(rel: str, func: str) -> str:
    """'<package>/<rel>:<line>' of `def func` in the JAX package's copy of
    `rel`, read from the checkout so the line number stays current."""
    for path in sorted(ROOT.glob(f"*/{rel}")):
        if path.parts[-len(Path(rel).parts) - 1] == "tfssd_torch":
            continue
        for no, line in enumerate(path.read_text().splitlines(), 1):
            if line.startswith(f"def {func}("):
                return f"{path.relative_to(ROOT)}:{no}"
    raise FileNotFoundError(f"no def {func} in any */{rel}")


def candidates(model, cfg, anchors_t, images: np.ndarray):
    """The keep kernel's inputs on the serving path: (R, K, 4) boxes and
    (R, K) scores of the per-class top-K candidates."""
    with torch.no_grad():
        x = torch.from_numpy(images).to(anchors_t.device)
        deltas, logits = model(preprocess_images(x))
        boxes, scores = decode_boxes_and_scores(anchors_t, deltas, logits, cfg)
        top_boxes, top_scores = nms.select_candidates(
            boxes, scores, cfg.max_detections_per_class,
            cfg.nms_prefilter_anchors)
    b, c, k = top_scores.shape
    return (top_boxes.reshape(b * c, k, 4).contiguous(),
            top_scores.reshape(b * c, k).contiguous())


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call of `fn` on the card (CUDA events around `iters`
    back-to-back calls, after `warmup` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def keep_bound(r: int, k: int):
    """(bound_ms, bound_by) of one keep call: inputs read once, the keep
    bytes written once; every pair i < j gets one IoU."""
    bytes_moved = r * k * (16 + 4 + 1)
    ops = r * (k * (k - 1) // 2) * OPS_PER_IOU
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOP_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible")

    section("1. build")
    report = build.build_library("nms_keep")
    print(f"build: nms_keep {'built' if report.built else 'already built'} "
          f"in {report.seconds:.2f} s -> {report.path.relative_to(ROOT)}")
    for line in report.log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    section("2. kernel")
    cfg, model = predict.load_model("mobilenet_v2", None, SEED, device)
    anchors_t = torch.from_numpy(generate_anchors(cfg)).to(device)
    dataset = SyntheticDataset(predict.SYNTHETIC_EVAL_SIZE,
                               image_size=cfg.img_size,
                               seed=predict.SYNTHETIC_EVAL_SEED)
    images = {bs: np.stack([dataset.example(i)["image"] for i in range(bs)])
              for bs in (PATH_BATCH, 64)}
    thr = (cfg.nms_iou_threshold, cfg.nms_score_threshold)
    cands, parity = {}, {}
    for bs, imgs in images.items():
        boxes, scores = candidates(model, cfg, anchors_t, imgs)
        got = nms_keep.nms_keep_cuda(boxes, scores, *thr)
        torch.cuda.synchronize()
        want = nms_keep.nms_keep_reference(boxes, scores, *thr)
        valid = scores > cfg.nms_score_threshold
        err = (got.int() - want.int()).abs().max().item()
        kept = int(got.sum())
        suppressed = int((valid & ~got).sum())
        r, k = scores.shape
        print(f"kernel: R={r} K={k} bit_equal={torch.equal(got, want)} "
              f"kept={kept} suppressed={suppressed} "
              f"invalid={int((~valid).sum())}")
        if not torch.equal(got, want):
            raise AssertionError(f"keep mask differs at R={r}: "
                                 f"{int((got != want).sum())} entries")
        if kept == 0 or suppressed == 0:
            raise AssertionError("the candidates exercise no suppression")
        cands[r] = (boxes, scores)
        parity[r] = err

    section("3. path")
    nms_keep.LAUNCHES = 0
    run = predict.main([
        "--backbone", "mobilenet_v2", "--dataset", "synthetic",
        "--limit", str(PATH_IMAGES), "--batch-size", str(PATH_BATCH),
        "--random-weights", "--seed", str(SEED), "--device", "cuda"])
    torch.cuda.synchronize()
    launches = nms_keep.LAUNCHES
    n_batches = len(run.results)
    print(f"path: {sum(run.num_valid)} images in {n_batches} batches, "
          f"nms_keep launches={launches}, mAP={run.mean_ap:.4f}")
    if launches != n_batches:
        raise AssertionError(f"nms_keep launched {launches} times for "
                             f"{n_batches} batches")
    if not np.isfinite(run.mean_ap):
        raise AssertionError("mAP is not finite")

    cpu_cfg, cpu_model = predict.load_model("mobilenet_v2", None, SEED,
                                            "cpu")
    for b in range(2):
        deltas, logits = run.outputs[b]
        if not (torch.isfinite(deltas).all() and torch.isfinite(logits).all()):
            raise AssertionError(f"batch {b}: non-finite model outputs")
        with torch.no_grad():
            ref_d, ref_l = cpu_model(
                preprocess_images(torch.from_numpy(run.images[b])))
        for name, card, ref in (("deltas", deltas, ref_d),
                                ("logits", logits, ref_l)):
            card = card.cpu()
            err = (card - ref).abs()
            worst = float(err.max())
            print(f"path: batch {b} {name} {tuple(card.shape)} max|card-cpu|"
                  f"={worst:.3g} (|cpu| <= {float(ref.abs().max()):.3g})")
            if not bool((err <= 1e-3 + 1e-3 * ref.abs()).all()):
                raise AssertionError(f"batch {b} {name} differ: {worst}")
        boxes, scores = decode_boxes_and_scores(anchors_t, deltas, logits,
                                                run.config)
        want = nms.combined_nms(
            boxes.cpu(), scores.cpu(),
            max_detections_per_class=cpu_cfg.max_detections_per_class,
            max_total_detections=cpu_cfg.max_total_detections,
            iou_threshold=cpu_cfg.nms_iou_threshold,
            score_threshold=cpu_cfg.nms_score_threshold,
            prefilter_anchors=cpu_cfg.nms_prefilter_anchors)
        got = run.results[b]
        classes = torch.where(want.classes >= 0, want.classes + 1,
                              torch.zeros_like(want.classes))
        if not (torch.equal(got.classes.cpu(), classes)
                and torch.equal(got.valid.cpu(), want.valid)):
            raise AssertionError(f"batch {b}: classes/valid differ")
        box_err = float((got.boxes.cpu() - want.boxes).abs().max())
        score_err = float((got.scores.cpu() - want.scores).abs().max())
        print(f"path: batch {b} NMSResult vs CPU plain path: classes and "
              f"valid equal (valid={got.valid.tolist()}), max box err "
              f"{box_err:.3g}, max score err {score_err:.3g}")
        if box_err > 1e-6 or score_err > 1e-6:
            raise AssertionError(f"batch {b}: boxes/scores differ")
    del cpu_model

    section("4. timing")
    predict_fn = make_predict_fn(run.model, run.anchors, run.config)
    for bs, iters in ((PATH_BATCH, 30), (64, 10)):
        x = torch.from_numpy(images[bs]).to(device)
        ms = time_ms(lambda: predict_fn(x), iters)
        print(f"timing: serving {bs * 1e3 / ms:.1f} img/s at batch {bs} "
              f"({ms:.3f} ms per batch, uint8 on device -> NMSResult)")
    rows = {}
    for r, (boxes, scores) in sorted(cands.items()):
        k = scores.shape[1]
        ms = time_ms(lambda: nms_keep.nms_keep_cuda(boxes, scores, *thr), 200)
        plain = time_ms(
            lambda: nms_keep.nms_keep_reference(boxes, scores, *thr), 10)
        bound, bound_by = keep_bound(r, k)
        rows[r] = (ms, plain, bound, bound_by)
        print(f"timing: nms_keep R={r} K={k}: kernel {ms:.5f} ms/call, plain "
              f"{plain:.5f} ms/call, bound {bound:.6f} ms ({bound_by})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])

    section("5. kernels")
    r_path = PATH_BATCH * (cfg.total_labels - 1)
    ms, plain, bound, bound_by = rows[r_path]
    r_big = max(rows)
    entry = {
        "name": "nms_keep", "route": "cuda",
        "source": "tfssd_torch/csrc/nms_keep.cu",
        "replaces": reference_site("ops/kernels/nms_keep.py",
                                   "nms_keep_pallas"),
        "launches": launches, "max_abs_err": float(max(parity.values())),
        "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": bound_by,
        "library_ms": None, "bit_equal": True,
        "shape": f"R={r_path},K={cfg.max_detections_per_class}",
        "ms_R1280": rows[r_big][0], "plain_ms_R1280": rows[r_big][1],
        "bound_ms_R1280": rows[r_big][2],
    }
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
