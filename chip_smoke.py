"""Smoke test of the PyTorch/CUDA port (tfssd_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

  1. build  — nvcc builds every kernel of the serving and training paths
              from tfssd_torch/csrc/ into build/tfssd_torch/, all at once
              (seconds, registers and shared memory printed).
  2. kernel — the NMS keep kernel on the real candidates of the path's
              first batch (R = 8 images x 20 classes, K = 200) and of a
              batch of 64, held bit-equal against its plain PyTorch version
              on the card; both kept and suppressed entries must occur.
              The same on the candidates of a batch of 8 through
              SSD300-VGG16 and SSD512-VGG16 (seeded weights, each
              config's own synthetic images).
              The same on every crafted case of
              tfssd_torch/ops/kernels/nms_keep_cases.py (64 instances each:
              K from 1 to 256, IoUs at the threshold and one ulp either
              side, identical, invalid, -inf, zero-area and inverted boxes,
              equal scores).
              The match/encode kernel on a real training batch (32
              SyntheticDataset(seed=0) images augmented by the port on the
              card; N = 2,268 anchors, G = 64): labels bit-equal to its
              plain version, deltas within 1e-5 (both call logf, which is
              not correctly rounded), positives and negatives present; the
              same with force_match_for_gt. The same at SSD300-VGG16's
              N = 8,732 and SSD512's N = 24,564 (B = 32, G = 64, each
              config's own augmented synthetic batch).
  3. path   — serving: `python -m tfssd_torch.predict` (its main()) serves 32
              synthetic images at batch 8 through SSD300-MobileNetV2 at
              full width with seeded weights; the kernel's launch counter is
              set to 0 just before and read just after. The card's
              (deltas, logits) are held against the same model on the CPU
              (|card - cpu| <= 1e-3 + 1e-3 |cpu|, float32 without TF32), and
              the card's NMSResult against the CPU plain path fed the card's
              decoded boxes and scores (classes and valid equal, boxes and
              scores within 1e-6).
              The same for `--backbone vgg16` and `--backbone vgg16_512`
              at full width, 24 images at batch 8 (launches == batches),
              the first batch's outputs held against the CPU on 2 images.
              training: `python -m tfssd_torch.trainer --backbone <b>`
              (its main()) for mobilenet_v2, vgg16 and vgg16_512 at full
              width (300 / 300 / 512 input, 2,268 / 8,732 / 24,564
              anchors), batch 32 (16 where 32 does not fit; neither
              fails), 2 epochs x 3 steps with augmentation, one
              validation batch per epoch, checkpoints under build/, each
              config its own directory; the match/encode launch counter
              is set to 0 just before and must equal train steps +
              validation batches just after; finite losses; a checkpoint
              written, and --resume continues from its step; the peak
              device memory printed. For each config, one train step
              (augmentation off, batch 8 / 2 / 1, synthetic images and
              noise images under the same gts) from the same seeded
              weights on the card and on the CPU: the card's losses and
              gradients (float32 without TF32) held against the float64
              CPU step, the witness of the exact gradient, by the
              config's STEP_GATES; the same step in TF32 on the card is a
              control that the gates must refuse; the float32 CPU step's
              distance is printed beside them.
  4. timing — serving img/s at batch 8 and 64 (device-resident uint8
              images -> NMSResult), for each VGG16 config at batch 8 and
              the largest of 64 / 32 that fits; train ms/step, img/s and
              peak device memory of each config at its training batch
              (augmentation on, device-resident data); each kernel's and
              its plain version's ms per call (nms_keep at R = 160 and
              R = 1280 and on each VGG16 config's R = 160, match_encode at
              B = 32, G = 64 and N = 2,268, 8,732 and 24,564, and on a
              batch whose 64 rows are all real at N = 24,564) beside its
              bound (match_encode: the bytes against the real pairs'
              operations, the padded pairs' figure of earlier runs beside
              it); also the device us per launch (CUDA events around
              replays of a CUDA graph of 20 wrapper calls: no host work
              between launches) and the host us per call (host clock
              around 200 back-to-back wrapper calls, launches included);
              the card's name and power limit.
  5. the whole run's seconds, the `kernels` JSON line (match_encode's
     launches on each train path and each VGG16 config's train batch
     among its keys), then the one-line JSON result, last.

It exits non-zero without a result when no CUDA device is available, and
in a directory that holds this script without the tfssd_torch package.
It writes nothing outside build/.
"""

from __future__ import annotations

import dataclasses
import json
import math
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from tfssd_torch import get_hyper_params, predict, trainer
from tfssd_torch.data.augment import augment_batch
from tfssd_torch.data.loader import stage_arrays
from tfssd_torch.data.synthetic import SyntheticDataset
from tfssd_torch.models.decoder import (decode_boxes_and_scores,
                                        make_predict_fn, preprocess_images)
from tfssd_torch.ops import matching, nms
from tfssd_torch.ops.boxes import generate_anchors
from tfssd_torch.ops.kernels import build, match_encode, nms_keep
from tfssd_torch.ops.kernels.match_encode_cases import (match_cases,
                                                       random_gts)
from tfssd_torch.ops.kernels.nms_keep_cases import keep_cases
from tfssd_torch.profile_nms_keep import host_us
from tfssd_torch.train import (create_train_state, make_cached_train_step,
                               make_lr_schedule, make_train_step)

ROOT = Path(__file__).resolve().parent
CARD = torch.device("cuda", 0)

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# Operations of one IoU and its comparison: 4 max/min, 2 subtractions,
# 2 clamps, 1 multiply (intersection), 2 add/sub (union), 1 clamp, 1 divide,
# 1 compare; areas and the scan are O(K) per instance and left out.
OPS_PER_IOU = 15

# Operations of one anchor-gt pair in match_encode: 4 max/min, 2
# subtractions, 2 clamps, a multiply (intersection), an add and a
# subtract (union), a clamp, a divide, the padding mask, the compare and
# the argmax update; the encode is O(1) per anchor and left out. The
# function needs them for the real gts (label > 0) only; the padded
# pairs' count is the figure of runs before the bound was recounted.
OPS_PER_MATCH = 16

PATH_BATCH = 8
PATH_IMAGES = 32
VGG_CONFIGS = ("vgg16", "vgg16_512")
VGG_PATH_IMAGES = 24
VGG_CPU_IMAGES = 2
TRAIN_CONFIGS = ("mobilenet_v2",) + VGG_CONFIGS
TRAIN_BATCH = 32
TRAIN_EPOCHS = 2
TRAIN_STEPS = 3
# Images of the card-vs-CPU train step: its float64 CPU witness costs
# ~40x (SSD300-VGG16) and ~110x (SSD512) a MobileNetV2 image.
PARITY_BATCH = {"mobilenet_v2": 8, "vgg16": 2, "vgg16_512": 1}
SEED = 0
KERNELS = ("nms_keep", "match_encode")


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


def graph_us(fn, per_graph: int = 20, replays: int = 20) -> float:
    """Device us per call of `fn`: CUDA events around `replays` replays of
    a CUDA graph that holds `per_graph` calls, so no host work sits between
    the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / (per_graph * replays)


def check_keep_cases(device) -> None:
    """The keep kernel against its plain version on the card, bit for bit,
    on every crafted case."""
    cases = keep_cases(instances=64, seed=1)
    for case in cases:
        boxes = torch.from_numpy(case.boxes).to(device)
        scores = torch.from_numpy(case.scores).to(device)
        thr = (case.iou_threshold, case.score_threshold)
        got = nms_keep.nms_keep_cuda(boxes, scores, *thr)
        torch.cuda.synchronize()
        want = nms_keep.nms_keep_reference(boxes, scores, *thr)
        if not torch.equal(got, want):
            raise AssertionError(f"keep mask differs on crafted case "
                                 f"{case.name}: {int((got != want).sum())} "
                                 f"entries")
    print(f"kernel: nms_keep crafted cases bit-equal ({len(cases)} cases, "
          f"64 instances each): {', '.join(c.name for c in cases)}")


def keep_bound(r: int, k: int):
    """(bound_ms, bound_by) of one keep call: inputs read once, the keep
    bytes written once; every pair i < j gets one IoU."""
    bytes_moved = r * k * (16 + 4 + 1)
    ops = r * (k * (k - 1) // 2) * OPS_PER_IOU
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOP_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def match_bound(n: int, labels: torch.Tensor) -> dict:
    """Bounds of one match_encode call on (B, G) `labels` and N anchors:
    anchors and gts read once, deltas and labels written once, against
    one IoU and compare for each pair of an anchor and a real gt (what
    this batch needs); and the figure of earlier runs, which counts every
    padded pair too."""
    b, g = labels.shape
    real = int((labels > 0).sum())
    t_bytes = (n * 16 + b * g * (16 + 4) + b * n * (16 + 4)) \
        / HBM_BYTES_PER_S * 1e3
    t_real = n * real * OPS_PER_MATCH / F32_FLOP_PER_S * 1e3
    t_padded = b * n * g * OPS_PER_MATCH / F32_FLOP_PER_S * 1e3
    return dict(
        bound_ms=max(t_bytes, t_real),
        bound_by="operations" if t_real > t_bytes else "bytes",
        bound_ms_padded=max(t_bytes, t_padded),
        bound_by_padded="operations" if t_padded > t_bytes else "bytes",
        real_gts=real)


def check_match_cases(device) -> None:
    """The match/encode kernel (with the force-match post-pass where a case
    asks) against its plain version on the card, on every crafted case:
    labels bit for bit, deltas within 1e-5."""
    cases = match_cases(images=TRAIN_BATCH, seed=1)
    for case in cases:
        cfg = get_hyper_params(
            "mobilenet_v2", max_gt_boxes=case.labels.shape[1],
            iou_threshold=case.iou_threshold,
            force_match_for_gt=case.force_match)
        anchors, boxes, labels = (torch.from_numpy(x).to(device) for x in (
            case.anchors, case.boxes, case.labels))
        got_d, got_l = match_encode.match_encode(anchors, boxes, labels, cfg)
        torch.cuda.synchronize()
        want_d, want_l = matching.match_targets(
            anchors, boxes, labels, case.iou_threshold, cfg.variances,
            case.force_match)
        err = float((got_d - want_d).abs().max())
        if not torch.equal(got_l, want_l):
            raise AssertionError(f"match_encode labels differ on crafted "
                                 f"case {case.name}: "
                                 f"{int((got_l != want_l).sum())} anchors")
        if err > 1e-5:
            raise AssertionError(f"match_encode deltas differ on crafted "
                                 f"case {case.name}: {err}")
    print(f"kernel: match_encode crafted cases labels bit-equal, deltas "
          f"within 1e-5 ({len(cases)} cases, {TRAIN_BATCH} images each): "
          f"{', '.join(c.name for c in cases)}")


def full_g_batch(cfg, device):
    """A batch of 32 images whose 64 gt rows are all real (seeded boxes of
    the synthetic data's sizes): the most pairs per anchor for the
    match/encode kernel -> (anchors, gt_boxes, gt_labels)."""
    g = cfg.max_gt_boxes
    boxes, labels = random_gts(np.random.default_rng(SEED), TRAIN_BATCH, g,
                               g)
    anchors = torch.from_numpy(generate_anchors(cfg)).to(device)
    return (anchors, torch.from_numpy(boxes).to(device),
            torch.from_numpy(labels).to(device))


def build_all() -> None:
    """One nvcc per kernel source, all started together."""
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        reports = list(pool.map(build.build_library, KERNELS))
    for name, report in zip(KERNELS, reports):
        print(f"build: {name} {'built' if report.built else 'already built'}"
              f" in {report.seconds:.2f} s -> "
              f"{report.path.relative_to(ROOT)}")
        for line in report.log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}")


def training_batch(cfg, device):
    """The match/encode kernel's input on the training path: 32 images of
    the trainer's SyntheticDataset(seed=0), augmented by the port on the
    card -> (anchors, gt_boxes, gt_labels) on the card."""
    ds = SyntheticDataset(TRAIN_BATCH, image_size=cfg.img_size, seed=0)
    host, _ = stage_arrays(ds, cfg.max_gt_boxes)
    images = torch.from_numpy(host["image"]).to(device).float() / 255.0
    boxes = torch.from_numpy(host["boxes"]).to(device)
    labels = torch.from_numpy(host["labels"]).to(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    _, boxes, labels = augment_batch(gen, images, boxes, labels)
    anchors = torch.from_numpy(generate_anchors(cfg)).to(device)
    return anchors, boxes.contiguous(), labels.contiguous()


def check_match_encode(cfg, anchors, boxes, labels) -> float:
    """Kernel against plain on the card, threshold-only and with
    force-match; returns the largest delta error."""
    worst = 0.0
    for force in (False, True):
        fcfg = dataclasses.replace(cfg, force_match_for_gt=force)
        got_d, got_l = match_encode.match_encode(anchors, boxes, labels,
                                                 fcfg)
        torch.cuda.synchronize()
        want_d, want_l = matching.match_targets(
            anchors, boxes, labels, fcfg.iou_threshold, fcfg.variances,
            force)
        err = float((got_d - want_d).abs().max())
        pos = int((want_l > 0).sum())
        print(f"kernel: match_encode B={labels.shape[0]} "
              f"N={anchors.shape[0]} G={labels.shape[1]} force={force} "
              f"labels_bit_equal={torch.equal(got_l, want_l)} "
              f"max|delta err|={err:.3g} positives={pos} "
              f"negatives={want_l.numel() - pos} "
              f"gts={int((labels > 0).sum())}")
        if not torch.equal(got_l, want_l):
            raise AssertionError(f"match_encode labels differ (force={force})"
                                 f": {int((got_l != want_l).sum())} anchors")
        if err > 1e-5:
            raise AssertionError(f"match_encode deltas differ: {err}")
        if pos == 0 or pos == want_l.numel():
            raise AssertionError("the batch has no positives or no negatives")
        worst = max(worst, err)
    return worst


def eval_images(cfg, count: int) -> np.ndarray:
    """The first `count` uint8 images of the predictor's synthetic
    evaluation split at the config's size."""
    dataset = SyntheticDataset(predict.SYNTHETIC_EVAL_SIZE,
                               image_size=cfg.img_size,
                               seed=predict.SYNTHETIC_EVAL_SEED)
    return np.stack([dataset.example(i)["image"] for i in range(count)])


def check_keep_on_candidates(model, cfg, images: np.ndarray, label: str):
    """The keep kernel against its plain version on the serving path's
    candidates of `images`: bit-equal, with kept and suppressed entries.
    Returns (boxes, scores, max abs error)."""
    anchors_t = torch.from_numpy(generate_anchors(cfg)).to(CARD)
    boxes, scores = candidates(model, cfg, anchors_t, images)
    thr = (cfg.nms_iou_threshold, cfg.nms_score_threshold)
    got = nms_keep.nms_keep_cuda(boxes, scores, *thr)
    torch.cuda.synchronize()
    want = nms_keep.nms_keep_reference(boxes, scores, *thr)
    valid = scores > cfg.nms_score_threshold
    err = (got.int() - want.int()).abs().max().item()
    kept = int(got.sum())
    suppressed = int((valid & ~got).sum())
    r, k = scores.shape
    print(f"kernel: nms_keep {label} R={r} K={k} "
          f"bit_equal={torch.equal(got, want)} kept={kept} "
          f"suppressed={suppressed} invalid={int((~valid).sum())}")
    if not torch.equal(got, want):
        raise AssertionError(f"keep mask differs ({label}, R={r}): "
                             f"{int((got != want).sum())} entries")
    if kept == 0 or suppressed == 0:
        raise AssertionError(f"the candidates ({label}) exercise no "
                             f"suppression")
    return boxes, scores, err


def serving_path(backbone: str, limit: int, checked: int, cpu_images: int):
    """Drive `python -m tfssd_torch.predict --backbone <backbone>` at full
    width on the card with seeded weights, its keep launch counter set to
    0 just before and read just after; hold the first `checked` batches'
    (deltas, logits) (their first `cpu_images` images) against the same
    model on the CPU, and their NMSResult against the CPU plain path fed
    the card's decoded boxes and scores. Returns (run, launches)."""
    nms_keep.LAUNCHES = 0
    run = predict.main([
        "--backbone", backbone, "--dataset", "synthetic",
        "--limit", str(limit), "--batch-size", str(PATH_BATCH),
        "--random-weights", "--seed", str(SEED), "--device", "cuda"])
    torch.cuda.synchronize()
    launches = nms_keep.LAUNCHES
    n_batches = len(run.results)
    print(f"path: {backbone} {sum(run.num_valid)} images in {n_batches} "
          f"batches, nms_keep launches={launches}, mAP={run.mean_ap:.4f}")
    if launches != n_batches:
        raise AssertionError(f"nms_keep launched {launches} times for "
                             f"{n_batches} batches ({backbone})")
    if not np.isfinite(run.mean_ap):
        raise AssertionError(f"mAP is not finite ({backbone})")

    cpu_cfg, cpu_model = predict.load_model(backbone, None, SEED, "cpu")
    anchors_t = torch.from_numpy(run.anchors).to(CARD)
    for b in range(checked):
        deltas, logits = run.outputs[b]
        if not (torch.isfinite(deltas).all() and torch.isfinite(logits).all()):
            raise AssertionError(f"{backbone} batch {b}: non-finite model "
                                 f"outputs")
        with torch.no_grad():
            ref_d, ref_l = cpu_model(preprocess_images(
                torch.from_numpy(run.images[b][:cpu_images])))
        for name, card, ref in (("deltas", deltas, ref_d),
                                ("logits", logits, ref_l)):
            card = card[:cpu_images].cpu()
            err = (card - ref).abs()
            worst = float(err.max())
            print(f"path: {backbone} batch {b} {name} {tuple(card.shape)} "
                  f"max|card-cpu|={worst:.3g} "
                  f"(|cpu| <= {float(ref.abs().max()):.3g})")
            if not bool((err <= 1e-3 + 1e-3 * ref.abs()).all()):
                raise AssertionError(f"{backbone} batch {b} {name} differ: "
                                     f"{worst}")
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
            raise AssertionError(f"{backbone} batch {b}: classes/valid "
                                 f"differ")
        box_err = float((got.boxes.cpu() - want.boxes).abs().max())
        score_err = float((got.scores.cpu() - want.scores).abs().max())
        print(f"path: {backbone} batch {b} NMSResult vs CPU plain path: "
              f"classes and valid equal (valid={got.valid.tolist()}), max "
              f"box err {box_err:.3g}, max score err {score_err:.3g}")
        if box_err > 1e-6 or score_err > 1e-6:
            raise AssertionError(f"{backbone} batch {b}: boxes/scores "
                                 f"differ")
    return run, launches


def time_serving(run, images: np.ndarray, batches, label: str) -> dict:
    """img/s of uint8 images on the card -> NMSResult at each batch size
    of `batches`; a batch that does not fit in memory is reported and
    left out of the result, which the caller checks. Returns
    {batch: img/s}."""
    predict_fn = make_predict_fn(run.model, run.anchors, run.config)
    out = {}
    for bs, iters in batches:
        x = torch.from_numpy(images[:bs]).to(CARD)
        try:
            ms = time_ms(lambda: predict_fn(x), iters)
        except torch.cuda.OutOfMemoryError:
            del x
            torch.cuda.empty_cache()
            print(f"timing: {label} serving at batch {bs} does not fit")
            continue
        out[bs] = bs * 1e3 / ms
        print(f"timing: {label} serving {out[bs]:.1f} img/s at batch {bs} "
              f"({ms:.3f} ms per batch, uint8 on device -> NMSResult)")
    return out


def time_keep(boxes, scores, thr, label: str) -> dict:
    """nms_keep and its plain version on one set of candidates: ms per call
    through the wrapper, device us per launch, host us per call, bound."""
    r, k = scores.shape

    def call():
        return nms_keep.nms_keep_cuda(boxes, scores, *thr)

    ms = time_ms(call, 200)
    dev_us = graph_us(call)
    h_us = host_us(call)
    plain = time_ms(lambda: nms_keep.nms_keep_reference(boxes, scores, *thr),
                    10)
    bound, bound_by = keep_bound(r, k)
    print(f"timing: nms_keep {label} R={r} K={k}: kernel {ms:.5f} ms/call "
          f"through the wrapper, device {dev_us:.2f} us per launch "
          f"(graph replay), host {h_us:.2f} us per call, plain "
          f"{plain:.5f} ms/call, bound {bound:.6f} ms ({bound_by})")
    return dict(ms=ms, device_us=dev_us, host_us=h_us, plain_ms=plain,
                bound_ms=bound, bound_by=bound_by)


def time_match(anchors, boxes, labels, cfg) -> dict:
    """match_encode and its plain version on one batch: ms per call
    through the wrapper, device us per launch, host us per call, bound."""
    args = (anchors, boxes, labels, cfg.iou_threshold, cfg.variances)

    def call():
        return match_encode.match_encode_cuda(*args)

    ms = time_ms(call, 200)
    dev_us = graph_us(call)
    h_us = host_us(call)
    plain = time_ms(lambda: matching.match_targets(*args), 20)
    b, g = labels.shape
    n = anchors.shape[0]
    bound = match_bound(n, labels)
    print(f"timing: match_encode B={b} N={n} G={g} real gts "
          f"{bound['real_gts']}: kernel {ms:.5f} ms/call, device "
          f"{dev_us:.2f} us per launch (graph replay), host {h_us:.2f} us "
          f"per call, plain {plain:.5f} ms/call, bound "
          f"{bound['bound_ms']:.6f} ms ({bound['bound_by']}; padded pairs "
          f"{bound['bound_ms_padded']:.6f} ms, {bound['bound_by_padded']})")
    return dict(ms=ms, device_us=dev_us, host_us=h_us, plain_ms=plain,
                **bound)


def train_path(backbone: str, batch: int) -> int:
    """Drive `python -m tfssd_torch.trainer --backbone <backbone>` at full
    width on the card, then resume it; return the match_encode launches of
    the first run."""
    out = ROOT / "build" / "chip_smoke_train" / backbone
    common = ["--backbone", backbone, "--device", "cuda",
              "--batch-size", str(batch),
              "--dataset", "synthetic", "--synthetic-size", "256",
              "--steps-per-epoch", str(TRAIN_STEPS), "--val-limit", "1",
              "--seed", str(SEED), "--log-every", "1",
              "--model-dir", str(out / "model"),
              "--log-dir", str(out / "logs")]
    if out.exists():
        shutil.rmtree(out)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    match_encode.LAUNCHES = 0
    run = trainer.main(["--epochs", str(TRAIN_EPOCHS)] + common)
    torch.cuda.synchronize()
    launches = match_encode.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    want = run.steps_run + run.val_batches
    print(f"path: {backbone} trainer at batch {batch} ran {run.steps_run} "
          f"steps and {run.val_batches} validation batches, match_encode "
          f"launches={launches}, val_losses={run.val_losses}, e2e "
          f"img/s={run.e2e_img_per_s}, peak device memory "
          f"{peak / 2**30:.2f} GiB ({held / 2**30:.2f} GiB held before)")
    if launches != want:
        raise AssertionError(f"match_encode launched {launches} times for "
                             f"{want} train steps + val batches ({backbone})")
    losses = [m["loss"] for m in run.train_metrics] + list(
        run.val_losses.values())
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss ({backbone}): {losses}")
    from tfssd_torch.utils.checkpoint import CheckpointManager
    latest = CheckpointManager(run.model_path).latest_step()
    if latest != run.state.step:
        raise AssertionError(f"latest checkpoint {latest}, trained to step "
                             f"{run.state.step} ({backbone})")
    del run
    resumed = trainer.main(["--epochs", str(TRAIN_EPOCHS + 1), "--resume"]
                           + common)
    print(f"path: {backbone} --resume from step {latest} ran "
          f"{resumed.steps_run} steps to step {resumed.state.step}")
    if (resumed.steps_run != TRAIN_STEPS
            or resumed.state.step != latest + TRAIN_STEPS):
        raise AssertionError(f"--resume did not continue from the "
                             f"checkpoint ({backbone})")
    return launches


def train_path_that_fits(backbone: str):
    """(batch, match_encode launches) of train_path at batch 32, or at 16
    where 32 does not fit in device memory; fails where neither fits."""
    for batch in (TRAIN_BATCH, TRAIN_BATCH // 2):
        try:
            return batch, train_path(backbone, batch)
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            print(f"path: {backbone} training at batch {batch} does not fit")
    raise AssertionError(f"{backbone} trains at neither batch "
                         f"{TRAIN_BATCH} nor {TRAIN_BATCH // 2}")


def _one_train_step(cfg, device: str, host, dtype=torch.float32,
                    tf32: bool = False):
    """(metrics, {name: gradient on the CPU}) of one train step without
    augmentation from the seeded weights, on `device`, with the model in
    `dtype` (the images scaled by /255 in float32, as the step does) and
    cuDNN and matmuls in TF32 if `tf32`."""
    dev = torch.device(device)
    state = create_train_state(cfg, SEED, dev, make_lr_schedule(TRAIN_STEPS))
    state.model.to(dtype)
    anchors = torch.from_numpy(generate_anchors(cfg)).to(dev)
    step = make_train_step(anchors, cfg, augment=False)
    batch = {k: torch.from_numpy(host[k]).to(dev)
             for k in ("image", "boxes", "labels")}
    batch["image"] = (batch["image"].float() / 255.0).to(dtype)
    flags = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = tf32
    try:
        metrics = step(state, batch)
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.double().cpu()
             for n, p in state.model.named_parameters()})


def _rel_norm(got, want, names) -> float:
    g = torch.cat([got[n].reshape(-1) for n in names])
    w = torch.cat([want[n].reshape(-1) for n in names])
    return float((g - w).norm() / w.norm())


# Gates of the card's float32 train step against the float64 CPU witness,
# each near the geometric mean of the largest reading of the sound step
# and the smallest reading of a control that computes less exactly (the
# same step with TF32 convolutions and matmuls on the card), over noise and
# synthetic images (this script on an NVIDIA H100 80GB HBM3 at 700 W;
# PERF.md): the largest relative loss error / the head gradient's and the
# whole gradient's relative distance, sound step / control:
#   MobileNetV2, batch 8: 1.0e-6 / 4.1e-4; 6.9e-6 / 5.1e-2; 1.0e-2 / 0.43.
#     BatchNorm at random weights grows the rounding 2000x from the head
#     to the stem.
#   SSD300-VGG16, batch 2: 4.4e-7 / 1.1e-4; 7.2e-7 / 4.2e-3; 3.4e-4 /
#     1.6e-2.
#   SSD512-VGG16, batch 1: 2.2e-7 / 1.0e-4; 7.6e-7 / 1.8e-3; 4.3e-4 /
#     1.3e-2.
STEP_GATES = {
    "mobilenet_v2": {"loss": 2e-5, "head": 6e-4, "whole": 6e-2},
    "vgg16": {"loss": 7e-6, "head": 5e-5, "whole": 2.5e-3},
    "vgg16_512": {"loss": 5e-6, "head": 4e-5, "whole": 2.5e-3},
}

# Parameter groups of each backbone, head to stem, whose card-vs-CPU
# gradient distance is printed (where the rounding differences grow).
DEPTH_GROUPS = {
    "mobilenet_v2": ("backbone.extra", "backbone.head_conv",
                     "backbone.block16", "backbone.block8.",
                     "backbone.block0.", "backbone.stem"),
    "vgg16": ("backbone.conv8", "backbone.fc7", "backbone.fc6",
              "backbone.conv4_", "backbone.conv3_", "backbone.conv1_")}


def _distances(got, want, names, head) -> dict:
    """Relative distances of one step's (metrics, gradients) from
    another's: the largest of the three losses', the head's and the whole
    gradient's in relative norm, and whether num_pos agrees."""
    (m, g), (want_m, want_g) = got, want
    return {"loss": max(abs(m[k] - want_m[k]) / abs(want_m[k])
                        for k in ("loss", "loc_loss", "conf_loss")),
            "num_pos": m["num_pos"] == want_m["num_pos"],
            "head": _rel_norm(g, want_g, head),
            "whole": _rel_norm(g, want_g, names)}


def _step_readings(cfg, card: str, host) -> dict:
    """One train step of `host` on the card (float32, and TF32 as the
    control) and on the CPU (float32, and the float64 witness); each one's
    distances from the witness."""
    steps = {"card": _one_train_step(cfg, card, host),
             "tf32": _one_train_step(cfg, card, host, tf32=True),
             "cpu": _one_train_step(cfg, "cpu", host),
             "f64": _one_train_step(cfg, "cpu", host, torch.float64)}
    names = sorted(steps["f64"][1])
    head = [n for n in names if n.startswith("head.")]
    out = {run: _distances(steps[run], steps["f64"], names, head)
           for run in ("card", "tf32", "cpu")}
    out["by_depth"] = {
        grp: _rel_norm(steps["card"][1], steps["f64"][1],
                       [n for n in names if n.startswith(grp)])
        for grp in DEPTH_GROUPS[cfg.backbone]}
    out["losses"] = {run: steps[run][0]["loss"] for run in steps}
    return out


def _refused(reading: dict, gates: dict) -> list:
    """The gates that `reading` fails."""
    failed = [k for k in ("loss", "head", "whole") if reading[k] > gates[k]]
    return failed + ([] if reading["num_pos"] else ["num_pos"])


def train_step_card_vs_cpu(name: str, card: str = "cuda") -> dict:
    """One train step of config `name`, augmentation off, from the same
    seeded weights and batch on the card (kernel) and on the CPU (plain),
    on two batches: the images of SyntheticDataset(seed=0) and seeded
    uniform noise under the same gts. The card's float32 step is held
    against the float64 CPU step, the witness of the exact gradient, by
    STEP_GATES[name]; the same step with TF32 on the card is the control
    that the gates must refuse. The float32 CPU step is printed beside
    them: at random weights it is no closer to the witness than the card,
    and how far it lies depends on the host's CPU (MobileNetV2's whole
    gradient 1.4e-2 to 8.1e-2 off). Flat synthetic rectangles make
    neighbouring anchors' losses tie exactly in the hard-negative ranking,
    where a rounding difference moves the gradient to another anchor of
    the same loss; noise has no such ties. Rounding differences grow from
    the head towards the stem (BatchNorm in MobileNetV2; VGG16 has no norm
    but conv4_3's), so the whole gradient is held looser than the
    head's."""
    cfg, gates, batch = get_hyper_params(name), STEP_GATES[name], \
        PARITY_BATCH[name]
    ds = SyntheticDataset(batch, image_size=cfg.img_size, seed=0)
    synthetic, _ = stage_arrays(ds, cfg.max_gt_boxes)
    noise = dict(synthetic, image=np.random.default_rng(SEED).integers(
        0, 256, synthetic["image"].shape, dtype=np.uint8))
    cpu = (f"{torch.backends.cpu.get_cpu_capability()}, "
           f"{torch.get_num_threads()} threads")
    readings = {}
    for kind, host in (("noise", noise), ("synthetic", synthetic)):
        r = readings[kind] = _step_readings(cfg, card, host)
        print(f"path: {name} train step card vs cpu ({kind} images, batch "
              f"{batch}, no augmentation; cpu {cpu}): losses "
              + ", ".join(f"{k} {v:.6f}" for k, v in r["losses"].items())
              + "; vs the float64 witness: float32 card "
              + json.dumps(r["card"])
              + "; TF32 control " + json.dumps(r["tf32"])
              + "; float32 cpu " + json.dumps(r["cpu"])
              + "; card by depth " + json.dumps(r["by_depth"]))
        failed = _refused(r["card"], gates)
        if failed:
            raise AssertionError(f"{name} train step card vs cpu ({kind}): "
                                 f"{failed} beyond {gates}")
    for kind, r in readings.items():
        missed = set(gates) - set(_refused(r["tf32"], gates))
        if missed:
            raise AssertionError(f"the TF32 control ({name}, {kind}) passes "
                                 f"the gates {sorted(missed)}: they cannot "
                                 f"see a less exact step")
    return readings


def time_train_step(backbone: str, batch: int) -> None:
    """Print the ms per train step of `backbone` at `batch`, augmentation
    on, device-resident data (host clock around synchronised steps), and
    the peak device memory of those steps."""
    cfg = get_hyper_params(backbone)
    ds = SyntheticDataset(256, image_size=cfg.img_size, seed=0)
    host, n = stage_arrays(ds, cfg.max_gt_boxes)
    data = {k: torch.from_numpy(host[k]).to(CARD)
            for k in ("image", "boxes", "labels")}
    torch.cuda.reset_peak_memory_stats()
    state = create_train_state(cfg, SEED, CARD, make_lr_schedule(100))
    anchors = torch.from_numpy(generate_anchors(cfg)).to(CARD)
    step = make_cached_train_step(anchors, cfg, augment=True, seed=SEED)
    rows = torch.from_numpy(trainer.epoch_indices(
        SEED, 0, n, 13, batch)).to(CARD)
    for i in range(3):
        step(state, data, rows[i])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(3, 13):
        step(state, data, rows[i])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 10
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"timing: {backbone} train {ms:.3f} ms per step, "
          f"{batch * 1e3 / ms:.1f} img/s at batch {batch} (augmentation on, "
          f"device-resident uint8 data), peak device memory {peak:.2f} GiB")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    device = CARD
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible")

    section("1. build")
    build_all()

    section("2. kernel")
    cfg, model = predict.load_model("mobilenet_v2", None, SEED, device)
    images = {bs: eval_images(cfg, bs) for bs in (PATH_BATCH, 64)}
    thr = (cfg.nms_iou_threshold, cfg.nms_score_threshold)
    cands, parity = {}, {}
    for bs, imgs in images.items():
        boxes, scores, err = check_keep_on_candidates(model, cfg, imgs,
                                                      "mobilenet_v2")
        cands[scores.shape[0]] = (boxes, scores)
        parity["mobilenet_v2", bs] = err
    vgg_cands, vgg_images, vgg_match = {}, {}, {}
    for name in VGG_CONFIGS:
        vcfg, vmodel = predict.load_model(name, None, SEED, device)
        vgg_images[name] = eval_images(vcfg, 64)
        boxes, scores, err = check_keep_on_candidates(
            vmodel, vcfg, vgg_images[name][:PATH_BATCH], name)
        vgg_cands[name] = (boxes, scores)
        parity[name, PATH_BATCH] = err
        vgg_match[name] = training_batch(vcfg, device)
        del vmodel
    check_keep_cases(device)
    m_anchors, m_boxes, m_labels = training_batch(cfg, device)
    match_err = max([check_match_encode(cfg, m_anchors, m_boxes, m_labels)]
                    + [check_match_encode(get_hyper_params(name), *batch)
                       for name, batch in vgg_match.items()])
    check_match_cases(device)

    section("3. path")
    run, launches = serving_path("mobilenet_v2", PATH_IMAGES, 2, PATH_BATCH)
    vgg_runs, vgg_launches = {}, {}
    for name in VGG_CONFIGS:
        vgg_runs[name], vgg_launches[name] = serving_path(
            name, VGG_PATH_IMAGES, 1, VGG_CPU_IMAGES)
    trained = {name: train_path_that_fits(name) for name in TRAIN_CONFIGS}
    for name in TRAIN_CONFIGS:
        train_step_card_vs_cpu(name)

    section("4. timing")
    fits = time_serving(run, images[64], ((PATH_BATCH, 30), (64, 10)),
                        "mobilenet_v2")
    if set(fits) != {PATH_BATCH, 64}:
        raise AssertionError(f"mobilenet_v2 serves at batches {sorted(fits)}"
                             f" only")
    for name in VGG_CONFIGS:
        fits = time_serving(vgg_runs[name], vgg_images[name],
                            ((PATH_BATCH, 10), (64, 5)), name)
        if 64 not in fits:
            fits.update(time_serving(vgg_runs[name], vgg_images[name],
                                     ((32, 5),), name))
        if PATH_BATCH not in fits or len(fits) < 2:
            raise AssertionError(f"{name} serves at batches {sorted(fits)} "
                                 f"only: neither 64 nor 32 fits")
    rows = {r: time_keep(boxes, scores, thr, "mobilenet_v2")
            for r, (boxes, scores) in sorted(cands.items())}
    vgg_rows = {name: time_keep(boxes, scores, thr, name)
                for name, (boxes, scores) in vgg_cands.items()}
    for name, (batch, _) in trained.items():
        time_train_step(name, batch)
    me_row = time_match(m_anchors, m_boxes, m_labels, cfg)
    me_rows = {batch[0].shape[0]: time_match(*batch, get_hyper_params(name))
               for name, batch in vgg_match.items()}
    ssd512 = get_hyper_params("vgg16_512")
    full_row = time_match(*full_g_batch(ssd512, device), ssd512)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])

    section("5. kernels")
    print(f"chip_smoke: whole run {time.perf_counter() - t_start:.1f} s")
    r_path = PATH_BATCH * (cfg.total_labels - 1)
    path_row, big_row = rows[r_path], rows[max(rows)]
    timed = ("ms", "device_us", "host_us", "plain_ms", "bound_ms")
    match_timed = timed + ("bound_ms_padded", "real_gts")
    entry = {
        "name": "nms_keep", "route": "cuda",
        "source": "tfssd_torch/csrc/nms_keep.cu",
        "replaces": reference_site("ops/kernels/nms_keep.py",
                                   "nms_keep_pallas"),
        "launches": launches, "max_abs_err": float(max(parity.values())),
        **path_row, "library_ms": None, "bit_equal": True,
        "shape": f"R={r_path},K={cfg.max_detections_per_class}",
        **{f"{key}_R{max(rows)}": big_row[key] for key in timed},
    }
    for name in VGG_CONFIGS:
        entry[f"launches_{name}"] = vgg_launches[name]
        entry.update({f"{key}_{name}": vgg_rows[name][key]
                      for key in timed})
    b, g = m_labels.shape
    match_entry = {
        "name": "match_encode", "route": "cuda",
        "source": "tfssd_torch/csrc/match_encode.cu",
        "replaces": reference_site("ops/kernels/match_encode.py",
                                   "match_encode_pallas"),
        "launches": trained["mobilenet_v2"][1],
        "max_abs_err": match_err,
        **me_row, "library_ms": None, "labels_bit_equal": True,
        "shape": f"B={b},N={m_anchors.shape[0]},G={g}",
    }
    for n, row in me_rows.items():
        match_entry.update({f"{key}_N{n}": row[key] for key in match_timed})
    match_entry.update({f"{key}_N{ssd512.total_anchors}_full_G": full_row[key]
                        for key in match_timed})
    for name in VGG_CONFIGS:
        match_entry[f"train_batch_{name}"], match_entry[
            f"launches_{name}"] = trained[name]
    print(json.dumps({"kernels": [entry, match_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
