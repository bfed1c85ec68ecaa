"""Smoke test of the PyTorch/CUDA port (tfssd_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

  1. build  — nvcc builds every kernel of the serving and training paths
              from tfssd_torch/csrc/ into build/tfssd_torch/, all at once
              (seconds, registers and shared memory printed).
  2. kernel — every kernel through its custom operator (tfssd::nms_keep,
              tfssd::match_encode: the main paths' call, whose CUDA
              implementation is the kernel), held against its plain
              version as below.
              The NMS keep kernel on the real candidates of the path's
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
              The keep kernel again on the bfloat16 serving path's
              candidates of each config (float32 scores from bfloat16
              logits), bit-equal, with the count of exactly tied scores
              printed; match/encode's inputs do not depend on the compute
              dtype, so the batches above are the bfloat16 train paths'
              too.
  3. path   — serving: `python -m tfssd_torch.predict --random-weights`
              (its main(), device-cached) serves 32
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
              bfloat16 (SSDConfig.compute_dtype, the JAX benchmark's
              serving and training dtype): serving through
              predict.load_model(..., compute_dtype="bfloat16") +
              predict.serve for each config on the same images as its
              float32 path (launches == batches), the card's (deltas,
              logits) held against its float32 ones by BF16_VS_F32 (and
              at least BF16_MIN_VS_F32 from them), the NMSResult against
              the CPU plain path fed the card's boxes and scores (as for
              float32: ties included), and the outputs and detections
              against the port's bfloat16 CPU path on the same images and
              weights by BF16_VS_CPU and BF16_AGREEMENT; training through
              `trainer --bf16` for each config as the float32 paths, and
              `trainer --bf16 --remat` for SSD512; the one-step parity
              above also runs the bfloat16 step on the card (and on the
              CPU, printed) against the same float64 witness, held by
              BF16_STEP_GATES, and it must fail the float32 gates (it does
              compute in bfloat16); MobileNetV2's bfloat16 backward, whose
              whole gradient is rounding noise at random weights, is held
              stage by stage (each stage fed the step's own inputs and
              output gradients in a float64 twin) by BF16_LOCAL_GATES.
              Remat: one bfloat16 step at batch 32
              of SSD512 and of MobileNetV2 from the same state and batch,
              plain twice and with remat: equal loss and BatchNorm
              statistics (every count 1), the gradient within REMAT_GRAD
              of the plain step's (beside the plain step repeated), the
              peak device memory of each.
  4. trained — the committed checkpoint trained/ssd_mobilenet_v2/7680,
              read without orbax (utils/checkpoint.py: OCDBT and zarr in
              numpy, zstd through libzstd.so.1 by ctypes; the decoder and
              the seconds printed), served by
              `predict.main(["--limit", "128", "--batch-size", "8"])` with
              every other flag at its default (mobilenet_v2, --model-dir
              trained, the card, BatchNorm folded, device-cached) on
              SyntheticDataset(128, seed=10_000); the keep launch counter
              set to 0 just before and read just after must equal the 16
              batches. The first 2 batches' (deltas, logits) held against
              the port's CPU path on the same weights, every batch's
              NMSResult against the CPU plain path (the gates of phase 3);
              the mAP within TRAINED_MAP_GATE (1e-3) of TRAINED_MAP_JAX,
              the JAX predictor's mAP on these images, which a CPU test
              computes with JAX and asserts (past 1e-4, the first
              detection that differs from the CPU path's is printed). The
              same images with --device-cache off --workers 4: NMSResults
              bit-equal to the cached run's; with --no-fold-bn: mAP within
              FOLD_MAP_GATE (1e-4) of the folded run's. bfloat16 through
              predict.load_model(<checkpoint directory>,
              compute_dtype="bfloat16") + predict.serve: its mAP printed,
              its detection agreement with float32 at least
              BF16_AGREEMENT, its (deltas, logits) of every kept batch
              within [BF16_MIN_VS_F32, BF16_TRAINED_VS_F32] of the float32
              run's (a path that served float32 reads 0) and on batch 0
              within BF16_TRAINED_VS_CPU of the port's bfloat16 CPU path
              (the card's float32 outputs against that CPU path printed
              as the control), launches == batches. The
              keep kernel on the trained candidates of batches 8 and 64
              (R = 160, 1,280): bit-equal, timed as in phase 5, with the
              rows holding a valid candidate and the valid candidates per
              row beside the seeded weights'. Serving img/s, device-resident
              images, at batches 8, 64 and 256, and bfloat16 at 256.
  4b. voc   — the trainer CLI on VOC directories: drill trees written by
              tfssd_torch.make_voc_drill under build/ (128 trainval + 32
              test images at 300 for mobilenet_v2 and vgg16 and at 512
              for vgg16_512: 4 steps and 1 validation batch an epoch); for each config at its training batch of
              phase 3, `trainer.main(["--dataset", "voc", "--data-root",
              <drill>, "--val-split", "test", "--epochs", "2", ...])`
              (a) streamed (--device-cache off --workers 8
              --prefetch-depth 4), (b) device-cached, twice, (c) streamed
              with --steps-per-call 2, and for mobilenet_v2 also
              device-cached with --steps-per-call 2, all with cuDNN's
              deterministic algorithms (its default heuristic picks some
              whose sums vary from run to run, so two default runs part
              at step 0's gradient); then (b) with cuDNN's default
              algorithms, as users train, step 0's loss metrics bit-equal
              to (b)'s and its distance printed. Each run's
              match/encode launches, counted from 0, must equal its train
              steps + validation batches; its metrics finite; step 0's
              metrics bit-equal across the runs; every later metric and
              the final validation loss of each run within the card's
              run-to-run floor, the distance between (b)'s two runs
              (printed beside them). Each run prints its e2e img/s,
              seconds per epoch, the share of steps that waited on the
              prefetch queue and device_memory_stats()'s peak beside the
              card's name and power limit. --profile on mobilenet_v2's (a):
              the trace names match_encode_kernel and holds a
              train_step#<step> range for each step of epoch 0 and none
              of epoch 1. --debug-nans on a run whose --init-lr diverges:
              FloatingPointError, and its --profile trace still written;
              the same run without the flag printed.
  4c. export — `predict.main(["--export", P, "--export-batch", "8"])` at
              the CLI's other defaults (the committed checkpoint, the card,
              BatchNorm left unfolded); a fresh `python -c` process that
              imports only tfssd_torch.ops.kernels and
              tfssd_torch.utils.export (no module of tfssd_torch.models)
              loads P on the card and serves phase 4's 128 images
              (preprocessed, batch 8): its nms_keep launches, counted from
              0, must equal its 16 calls; its NMSResults equal the eager
              --no-fold-bn run's of phase 4 (classes and valid equal, boxes
              and scores within EXPORT_ATOL; bit-equality printed); their
              mAP within TRAINED_MAP_GATE of TRAINED_MAP_JAX. The same
              process loads P on the CPU and serves the first batch,
              held against the port's CPU path (the unfolded model) by the
              same gate. The same for SSD300-VGG16 and SSD512 with seeded
              weights (trained/ssd_vgg16 is not copied to the card):
              `predict.main(["--backbone", <b>, "--random-weights",
              "--export", P, "--export-batch", <2 / 1>])`, served in the
              same fresh process (8 / 4 images: launches == calls) and held
              against the eager `--no-fold-bn` run of those images through
              predict.main, and its first batch on the CPU against the
              port's CPU path; these artifacts (~100 MiB each) are deleted
              after the phase. Then live against artifact img/s (the JAX
              package's tools/export_bench.py cell: MobileNetV2 bfloat16,
              seeded, unfolded, batch 256), in turns in this run.
  4d. dp    — data-parallel training on the one card: trainer.main at
              full width (SSD300-MobileNetV2, 2,268 anchors), global batch
              32, 2 epochs x 3 steps, device cache, augmentation on, cuDNN
              deterministic, (b) on one NCCL rank (parallel.Group): every
              step's metrics, the validation losses and the final weights
              bit-equal to the run without a process group; (a) on two
              gloo ranks sharing cuda:0 (16 rows each): step 0's losses and
              grad_norm within DP_STEP0_LOSS / DP_STEP0_GRAD_NORM of the
              one process's, the later steps, the validation loss and the
              final weights within DP_LATER (float32's drift; the control,
              one process with cuDNN's default algorithms, printed
              beside), num_pos equal at every step, the ranks' weights
              bit-equal; then the same two ranks and one process with the
              model and Adam in float64, device-cached and streamed, every
              step, the validation loss and the weights within DP_F64 of
              the one process's (distances printed). Each rank's
              match/encode launches, counted from 0, must equal its steps
              + validation batches in every run.
  4e. resume — the JAX trainer's committed checkpoint continued by the
              port: trained/ssd_mobilenet_v2/7680 read whole without orbax
              (OrbaxCheckpoints.restore_train_state: 735 arrays, 410 of
              them optax Adam's state; the seconds and MiB printed),
              restored into the port's TrainState on the card and on the
              CPU, the eval loss terms of a fixed synthetic batch within
              RESUME_EVAL_GATE of each other; the first train step from
              the trained weights (batch 8, no augmentation) in float32 and
              in bfloat16 on the card against the float64 CPU step (loss,
              grad_norm and gradient distances printed); then
              `trainer.main(["--resume", "--model-dir", <the step linked
              in, the JAX run's sidecar copied>, ...])` at the sidecar's
              geometry (batch 8, 2 steps an epoch) for one epoch from step
              7680, a second --resume from the port's own checkpoint for
              one more, and an uninterrupted run of both epochs from the
              JAX checkpoint, all with cuDNN's deterministic algorithms:
              match_encode's launches, counted from 0, equal each run's
              steps + validation batches; the first run says it restored
              the JAX package's checkpoint and writes ckpt_7682 under
              ssd_mobilenet_v2_torch only; the two resumed runs equal the
              uninterrupted one bit for bit (every step's metrics, the
              validation losses, the weights); the JAX step and sidecar
              are byte for byte as before.
  4f. port-h5 — Keras trunk files of seeded arrays, written by
              tfssd_torch.make_keras_drill under build/ (the card's machine
              has no Keras or h5py): MobileNetV2 as .h5 and .keras,
              SSD300-VGG16 as .h5. `predict.main(["--port-h5", <.h5>,
              "--limit", "32", "--batch-size", "8", "--no-fold-bn"])` over
              the committed checkpoint: every trunk tensor of the served
              model bit-equal to the file's array (after the Flax -> torch
              layout), every other one to the checkpoint's, nms_keep
              launched once a batch, the outputs and NMSResults held
              against the CPU by phase 4's gates; the same with the .keras
              (its NMSResults bit-equal to the .h5 run's) and with
              BatchNorm folded (the default). `trainer.main(["--port-h5",
              <.h5>, ...])` on synthetic data at batch 8, 2 steps and 1
              validation batch: the state just after the graft holds the
              file's trunk and the seeded rest, match_encode launched 3
              times, finite losses, every ported trunk parameter moved by
              Adam, which holds the model's parameters; the run's
              TensorBoard event file read back (each record's CRC-32Cs
              checked) equal to its metrics.jsonl, scalar for scalar. A
              second `trainer.main([..., "--resume"])` on the same model
              directory grafts the file, then restores its checkpoint:
              weights bit-equal to the first run's last. `predict.main([
              "--backbone", "vgg16", "--random-weights", "--port-h5", <.h5>,
              "--limit", "8", "--batch-size", "2"])`: conv1_1 .. conv5_3
              from the file, the rest seeded, a launch a batch, the first
              batch against the CPU.
  5. timing — serving img/s at batch 8 and 64 (device-resident uint8
              images -> NMSResult), for each VGG16 config at batch 8 and
              the largest of 64 / 32 that fits; train ms/step, img/s and
              peak device memory of each config at its training batch
              (augmentation on, device-resident data); each kernel's and
              its plain version's ms per call (nms_keep at R = 160 and
              R = 1280 and on each VGG16 config's R = 160, match_encode at
              B = 32, G = 64 and N = 2,268, 8,732 and 24,564, and on a
              batch whose 64 rows are all real at N = 24,564), through
              the op, beside its
              bound (match_encode: the bytes against the real pairs'
              operations, the padded pairs' figure of earlier runs beside
              it); also the device us per launch (CUDA events around
              replays of a CUDA graph of 20 wrapper calls: no host work
              between launches) and the host us per call (host clock
              around 200 back-to-back calls, launches included) through
              the op and through the ctypes wrapper alone;
              bfloat16 beside float32: serving img/s of each config at
              batch 8 and 64 (MobileNetV2 also at 256, the JAX
              benchmark's headline batch), train ms/step and peak memory
              of each config at its training batch, and SSD512 with
              remat; the card's name and power limit on every timing
              line.
  6. the whole run's seconds, the `kernels` JSON line (match_encode's
     launches on each train path and each VGG16 config's train batch
     among its keys; the launches of both kernels on the bfloat16 paths
     as launches_bf16_<config>; nms_keep's on the trained paths as
     launches_trained_mobilenet_v2 and launches_trained_bf16_mobilenet_v2,
     and its timing on the trained candidates as <key>_trained_R<R>;
     match_encode's on the VOC runs as
     launches_voc_<config>_{streamed,cached,spc2[,cached_spc2]} and on
     the data-parallel runs as launches_dp_nccl1 and
     launches_dp_gloo2_rank<r>, and on the resume phase's runs as
     launches_resume_{jax_checkpoint,own_checkpoint,uninterrupted};
     nms_keep's in the export phase's fresh process as
     launches_export_fresh_process[_<vgg config>], with the artifacts'
     sizes and the live and artifact img/s; nms_keep's on the port-h5
     phase's serving runs as launches_port_h5_{predict_h5,predict_keras,
     predict_h5_fold,predict_vgg16} and match_encode's on its trainer runs
     as launches_port_h5_{train,resume}), then the one-line JSON result,
     last.

It exits non-zero without a result when no CUDA device is available, and
in a directory that holds this script without the tfssd_torch package
(or without trained/ssd_mobilenet_v2, or without a zstd decoder). It runs
from the checkout's root and writes nothing outside build/. The whole run
takes ~390-445 s on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6): phase
4b ~68 s, 4c ~43-54 s, 4d ~42-51 s with its two process groups started
together, 4f ~13 s (429.4 s in all with it); phase 4b's 300-pixel drill
tree was halved to make room for 4d's float64 runs.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from tfssd_torch import get_hyper_params, parallel, predict, train, trainer
from tfssd_torch.data.augment import augment_batch
from tfssd_torch.data.loader import TakeDataset, stage_arrays
from tfssd_torch.data.synthetic import SyntheticDataset
from tfssd_torch.evaluate import detection_agreement
from tfssd_torch.make_voc_drill import make_drill
from tfssd_torch.models.decoder import (decode_boxes_and_scores,
                                        decode_predictions, make_predict_fn,
                                        preprocess_images)
from tfssd_torch.models.ssd import get_model, init_random_weights
from tfssd_torch.ops import matching, nms
from tfssd_torch.ops.boxes import generate_anchors
from tfssd_torch.ops.kernels import build, match_encode, nms_keep
from tfssd_torch.ops.kernels.match_encode_cases import (match_cases,
                                                       random_gts)
from tfssd_torch.ops.kernels.nms_keep_cases import keep_cases
from tfssd_torch.profile_nms_keep import host_us
from tfssd_torch.utils import profiling
from tfssd_torch.utils.convert import flatten_tree, variables_to_state_dict
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
BF16 = "bfloat16"
# The JAX benchmark's serving headline batch (MobileNetV2, bfloat16).
HEADLINE_BATCH = 256
# The configuration of the remat checks: SSD512 (bfloat16), where remat is
# the documented fallback when training runs out of device memory, and
# MobileNetV2 (bfloat16) for its BatchNorm statistics.
REMAT_CONFIGS = ("vgg16_512", "mobilenet_v2")
# nvidia-smi's name and power limit of the card, set in main() and printed
# beside every timing.
CARD_LINE = ""


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
    """The keep kernel, through tfssd::nms_keep, against its plain version
    on the card, bit for bit, on every crafted case."""
    cases = keep_cases(instances=64, seed=1)
    for case in cases:
        boxes = torch.from_numpy(case.boxes).to(device)
        scores = torch.from_numpy(case.scores).to(device)
        thr = (case.iou_threshold, case.score_threshold)
        got = nms_keep.nms_keep(boxes, scores, *thr)
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
    """`count` uint8 images of the predictor's synthetic evaluation split
    at the config's size: its first, over again from the start past its
    128."""
    dataset = SyntheticDataset(predict.SYNTHETIC_EVAL_SIZE,
                               image_size=cfg.img_size,
                               seed=predict.SYNTHETIC_EVAL_SEED)
    return np.stack([dataset.example(i % len(dataset))["image"]
                     for i in range(count)])


def check_keep_on_candidates(model, cfg, images: np.ndarray, label: str):
    """The keep kernel (tfssd::nms_keep) against its plain version on the
    serving path's
    candidates of `images`: bit-equal, with kept and suppressed entries.
    Returns (boxes, scores, max abs error)."""
    anchors_t = torch.from_numpy(generate_anchors(cfg)).to(CARD)
    boxes, scores = candidates(model, cfg, anchors_t, images)
    thr = (cfg.nms_iou_threshold, cfg.nms_score_threshold)
    got = nms_keep.nms_keep(boxes, scores, *thr)
    torch.cuda.synchronize()
    want = nms_keep.nms_keep_reference(boxes, scores, *thr)
    valid = scores > cfg.nms_score_threshold
    err = (got.int() - want.int()).abs().max().item()
    kept = int(got.sum())
    suppressed = int((valid & ~got).sum())
    # candidates rows are score-sorted: a tie equals its predecessor
    ties = int(((scores[:, 1:] == scores[:, :-1]) & valid[:, 1:]).sum())
    r, k = scores.shape
    print(f"kernel: nms_keep {label} R={r} K={k} "
          f"bit_equal={torch.equal(got, want)} kept={kept} "
          f"suppressed={suppressed} invalid={int((~valid).sum())} "
          f"tied_scores={ties}")
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

    _, cpu_model = predict.load_model(backbone, None, SEED, "cpu")
    check_outputs_on_cpu(backbone, run, cpu_model, checked, cpu_images)
    return run, launches


def check_outputs_on_cpu(label: str, run, cpu_model, checked: int,
                         cpu_images: int) -> None:
    """The first `checked` batches of a float32 serving run on the card:
    their (deltas, logits) (the first `cpu_images` images) against
    `cpu_model` on the same images (|card - cpu| <= 1e-3 + 1e-3 |cpu|),
    and their NMSResult against the CPU plain path fed the card's decoded
    boxes and scores (check_nms_on_cpu)."""
    anchors_t = torch.from_numpy(run.anchors).to(CARD)
    for b in range(checked):
        deltas, logits = run.outputs[b]
        if not (torch.isfinite(deltas).all() and torch.isfinite(logits).all()):
            raise AssertionError(f"{label} batch {b}: non-finite model "
                                 f"outputs")
        with torch.no_grad():
            ref_d, ref_l = cpu_model(preprocess_images(
                torch.from_numpy(run.images[b][:cpu_images])))
        for name, card, ref in (("deltas", deltas, ref_d),
                                ("logits", logits, ref_l)):
            card = card[:cpu_images].cpu()
            err = (card - ref).abs()
            worst = float(err.max())
            print(f"path: {label} batch {b} {name} {tuple(card.shape)} "
                  f"max|card-cpu|={worst:.3g} "
                  f"(|cpu| <= {float(ref.abs().max()):.3g})")
            if not bool((err <= 1e-3 + 1e-3 * ref.abs()).all()):
                raise AssertionError(f"{label} batch {b} {name} differ: "
                                     f"{worst}")
        check_nms_on_cpu(f"{label} batch {b}", run, b, anchors_t)


def check_nms_on_cpu(label: str, run, b: int, anchors_t) -> None:
    """Batch `b`'s NMSResult of a serving run on the card against the CPU
    plain path fed the card's decoded boxes and scores: classes and valid
    equal, boxes and scores within 1e-6."""
    cfg = run.config
    deltas, logits = run.outputs[b]
    boxes, scores = decode_boxes_and_scores(anchors_t, deltas, logits, cfg)
    want = nms.combined_nms(
        boxes.cpu(), scores.cpu(),
        max_detections_per_class=cfg.max_detections_per_class,
        max_total_detections=cfg.max_total_detections,
        iou_threshold=cfg.nms_iou_threshold,
        score_threshold=cfg.nms_score_threshold,
        prefilter_anchors=cfg.nms_prefilter_anchors)
    got = run.results[b]
    classes = torch.where(want.classes >= 0, want.classes + 1,
                          torch.zeros_like(want.classes))
    if not (torch.equal(got.classes.cpu(), classes)
            and torch.equal(got.valid.cpu(), want.valid)):
        raise AssertionError(f"{label}: classes/valid differ")
    box_err = float((got.boxes.cpu() - want.boxes).abs().max())
    score_err = float((got.scores.cpu() - want.scores).abs().max())
    print(f"path: {label} NMSResult vs CPU plain path: classes and valid "
          f"equal (valid={got.valid.tolist()}), max box err {box_err:.3g}, "
          f"max score err {score_err:.3g}")
    if box_err > 1e-6 or score_err > 1e-6:
        raise AssertionError(f"{label}: boxes/scores differ")


# Gates of the bfloat16 serving paths, each ~2x the reading of this
# script on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6): the
# card's bfloat16 (deltas, logits) against its float32 ones on the same
# images, max |bf16 - f32| over max |f32| of each output (read 0.150-0.174
# for MobileNetV2, whose seeded BatchNorm holds no scale, 0.0103-0.0127 for
# the VGG16 configs), which must also reach BF16_MIN_VS_F32 (a path that
# served in float32 reads 0: the two run the same kernels); the same
# outputs against the port's bfloat16 CPU path on the same images and
# weights, max |card - cpu| over max |cpu| (read 0.0484-0.0578 for
# MobileNetV2, 0.00585-0.00758 for the VGG16 configs); and the card's
# bfloat16 NMSResult against that CPU path's by detection_agreement
# (detections scoring >= 0.05 matched by class at IoU >= 0.5, the smaller
# direction; read 0.938-0.985: seeded weights score many near-equal junk
# boxes, whose order one bfloat16 ulp can swap).
BF16_VS_F32 = {"mobilenet_v2": 0.35, "vgg16": 0.03, "vgg16_512": 0.03}
BF16_MIN_VS_F32 = 1e-3
BF16_VS_CPU = {"mobilenet_v2": 0.12, "vgg16": 0.016, "vgg16_512": 0.016}
BF16_AGREEMENT = 0.85


def serving_path_bf16(backbone: str, limit: int, checked: int,
                      cpu_images: int, f32_run):
    """The JAX benchmark's bfloat16 serving configuration (BatchNorm
    folded, backbone and heads in bfloat16) through the serving API,
    predict.load_model(..., compute_dtype="bfloat16") + predict.serve, at
    full width on the card with seeded weights, the keep launch counter
    set to 0 just before and read just after. The first `checked` batches'
    outputs are held against `f32_run`'s (the float32 path on the same
    images) by BF16_VS_F32[backbone] and BF16_MIN_VS_F32 and their
    NMSResult against the CPU plain path fed the card's boxes and scores;
    their first `cpu_images` images' outputs against the port's bfloat16
    CPU path by BF16_VS_CPU[backbone], and their detections by
    BF16_AGREEMENT.
    Returns (run, launches)."""
    cfg, model = predict.load_model(backbone, None, SEED, "cuda",
                                    compute_dtype=BF16)
    dataset = SyntheticDataset(predict.SYNTHETIC_EVAL_SIZE,
                               image_size=cfg.img_size,
                               seed=predict.SYNTHETIC_EVAL_SEED)
    nms_keep.LAUNCHES = 0
    run = predict.serve(model, cfg, dataset, PATH_BATCH, limit)
    torch.cuda.synchronize()
    launches = nms_keep.LAUNCHES
    n_batches = len(run.results)
    label = f"{backbone} bf16"
    print(f"path: {label} {sum(run.num_valid)} images in {n_batches} "
          f"batches, nms_keep launches={launches}, mAP={run.mean_ap:.4f} "
          f"(float32 {f32_run.mean_ap:.4f})")
    if launches != n_batches:
        raise AssertionError(f"nms_keep launched {launches} times for "
                             f"{n_batches} batches ({label})")
    if not np.isfinite(run.mean_ap):
        raise AssertionError(f"mAP is not finite ({label})")
    _, cpu_model = predict.load_model(backbone, None, SEED, "cpu",
                                      compute_dtype=BF16)
    anchors_t = torch.from_numpy(run.anchors).to(CARD)
    for b in range(checked):
        outputs = run.outputs[b]
        if not all(torch.isfinite(t).all() for t in outputs):
            raise AssertionError(f"{label} batch {b}: non-finite outputs")
        with torch.no_grad():
            x = torch.from_numpy(run.images[b][:cpu_images])
            cpu_d, cpu_l = cpu_model(preprocess_images(x))
        for name, got, f32, cpu in zip(("deltas", "logits"), outputs,
                                       f32_run.outputs[b], (cpu_d, cpu_l)):
            rel = float((got - f32).abs().max() / f32.abs().max())
            head = got[:cpu_images].cpu()
            cpu_rel = float((head - cpu).abs().max() / cpu.abs().max())
            share = float((head == cpu).float().mean())
            print(f"path: {label} batch {b} {name}: max|bf16 - f32| / "
                  f"max|f32| = {rel:.4g} on the card; card vs cpu bf16 "
                  f"max err / scale {cpu_rel:.4g}, bit-equal share "
                  f"{share:.4f}")
            if not BF16_MIN_VS_F32 <= rel <= BF16_VS_F32[backbone]:
                raise AssertionError(f"{label} batch {b} {name}: {rel} "
                                     f"from float32 outside "
                                     f"[{BF16_MIN_VS_F32}, "
                                     f"{BF16_VS_F32[backbone]}]")
            if not cpu_rel <= BF16_VS_CPU[backbone]:
                raise AssertionError(f"{label} batch {b} {name}: {cpu_rel} "
                                     f"from the bfloat16 CPU path > "
                                     f"{BF16_VS_CPU[backbone]}")
        check_nms_on_cpu(f"{label} batch {b}", run, b, anchors_t)
        cpu_res = decode_predictions(torch.from_numpy(run.anchors), cpu_d,
                                     cpu_l, cfg)
        card_res = run.results[b]
        agree = detection_agreement(
            nms.NMSResult(*(t[:cpu_images].cpu().numpy() for t in card_res)),
            nms.NMSResult(*(t.numpy() for t in cpu_res)))
        print(f"path: {label} batch {b} detections card vs cpu bf16 on "
              f"{cpu_images} images: agreement {agree:.4f} (gate "
              f"{BF16_AGREEMENT})")
        if agree < BF16_AGREEMENT:
            raise AssertionError(f"{label} batch {b}: detection agreement "
                                 f"{agree} < {BF16_AGREEMENT}")
    return run, launches


# The trained phase: the committed checkpoint, which predict.main serves
# at its defaults (--model-dir trained, --backbone mobilenet_v2), on the
# predictor's synthetic evaluation split.
TRAINED_DIR = Path("trained") / "ssd_mobilenet_v2"
TRAINED_IMAGES = 128
# The JAX predictor's mAP with trained/ssd_mobilenet_v2/7680 on
# SyntheticDataset(128, seed=10_000) at batch 8 (`predictor.py --dataset
# synthetic --limit 128 --batch-size 8`), computed with JAX on the CPU and
# asserted by tests/test_torch_predict_cli.py: the card is held to the
# reference, not to itself.
TRAINED_MAP_JAX = 0.8878397369672909
# The card's mAP against TRAINED_MAP_JAX; past the CPU's bar (the port's
# CPU path against the JAX predictor, tests/test_torch_predict_cli.py) the
# first detection that differs from the CPU path's is printed.
TRAINED_MAP_GATE = 1e-3
TRAINED_MAP_CPU_BAR = 1e-4
# --no-fold-bn against the folded run's mAP.
FOLD_MAP_GATE = 1e-4
# Gates of the bfloat16 serving path on the trained weights, from this
# script's readings on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6). The
# card's bfloat16 (deltas, logits) against the port's bfloat16 CPU path on
# the same images, max |card - cpu| over max |cpu| of each: read
# 0.0043-0.0050, gate ~2x that. The control, the card's float32 outputs
# against the same CPU path, reads 0.0154 and fails it; so would a card
# that served float32. The same bfloat16 outputs of every kept batch
# against the card's float32 run on the same images: read 0.0118-0.0186,
# held within [BF16_MIN_VS_F32, BF16_TRAINED_VS_F32]; their detections by
# BF16_AGREEMENT (read 0.9992).
BF16_TRAINED_VS_CPU = 0.01
BF16_TRAINED_VS_F32 = 2.0 ** -5


def candidate_stats(scores: torch.Tensor, score_threshold: float) -> str:
    """The keep kernel's input density: rows with a valid candidate, and
    the mean valid candidates per row."""
    valid = scores > score_threshold
    r, k = scores.shape
    return (f"rows with a valid candidate {int(valid.any(1).sum())} of {r}, "
            f"valid candidates per row "
            f"{float(valid.sum(1).float().mean()):.2f}"
            f" of K={k}")


def first_difference(got, want) -> str:
    """The first detection (batch, image, row) where two lists of host
    NMSResults differ: classes or valid unequal, or boxes or scores more
    than 1e-6 apart."""
    for b, (g, w) in enumerate(zip(got, want)):
        for i in range(len(g.valid)):
            if g.valid[i] != w.valid[i]:
                return (f"batch {b} image {i}: valid {g.valid[i]} against "
                        f"{w.valid[i]}")
            for j in range(int(g.valid[i])):
                if (g.classes[i, j] != w.classes[i, j]
                        or abs(g.scores[i, j] - w.scores[i, j]) > 1e-6
                        or np.abs(g.boxes[i, j] - w.boxes[i, j]).max() > 1e-6):
                    return (f"batch {b} image {i} row {j}: class "
                            f"{g.classes[i, j]} score {g.scores[i, j]:.7g} "
                            f"box {g.boxes[i, j].tolist()} against class "
                            f"{w.classes[i, j]} score {w.scores[i, j]:.7g} "
                            f"box {w.boxes[i, j].tolist()}")
    return "none"


def _host_results(run) -> list:
    return [nms.NMSResult(*(t.cpu().numpy() for t in res))
            for res in run.results]


def _concat(results) -> nms.NMSResult:
    return nms.NMSResult(*(np.concatenate(parts)
                           for parts in zip(*results)))


def _max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|, on the host in float32."""
    got, want = got.cpu().float(), want.cpu().float()
    return float((got - want).abs().max() / want.abs().max())


def _serve_counted(argv) -> tuple:
    """predict.main(argv) with the keep launch counter set to 0 just before
    and read just after: (run, launches), launches == batches held."""
    nms_keep.LAUNCHES = 0
    run = predict.main(argv)
    torch.cuda.synchronize()
    launches = nms_keep.LAUNCHES
    if launches != len(run.results):
        raise AssertionError(f"nms_keep launched {launches} times for "
                             f"{len(run.results)} batches ({argv})")
    return run, launches


def trained_path(seeded_cands) -> dict:
    """The committed checkpoint on the card: read without orbax, served by
    predict.main at its defaults, held against the CPU and the JAX
    predictor's mAP; the streamed feed, --no-fold-bn and bfloat16 beside
    it; the keep kernel on trained candidates; serving img/s."""
    from tfssd_torch.utils import zstd
    from tfssd_torch.utils.checkpoint import OrbaxCheckpoints

    t0 = time.perf_counter()
    ckpt = OrbaxCheckpoints(str(TRAINED_DIR))
    step = ckpt.serving_step()
    if step is None:
        raise AssertionError(f"no checkpoint under {TRAINED_DIR}")
    tree = ckpt.restore_weights(step)
    seconds = time.perf_counter() - t0
    leaves = list(flatten_tree(
        {k: tree[k] for k in ("params", "batch_stats")}).values())
    print(f"trained: {TRAINED_DIR}/{step} read without orbax through "
          f"{zstd.describe()} in {seconds:.3f} s ({len(leaves)} arrays, "
          f"{sum(a.nbytes for a in leaves) / 2**20:.2f} MiB)")

    argv = ["--limit", str(TRAINED_IMAGES), "--batch-size", str(PATH_BATCH)]
    run, launches = _serve_counted(argv)
    n_batches = len(run.results)
    gap = abs(run.mean_ap - TRAINED_MAP_JAX)
    print(f"trained: predict.main({argv}) served {sum(run.num_valid)} "
          f"images in {n_batches} batches (device-cached="
          f"{run.device_cached}), nms_keep launches={launches}, mAP="
          f"{run.mean_ap!r}; JAX predictor {TRAINED_MAP_JAX!r}, |diff| "
          f"{gap:.3g} (gate {TRAINED_MAP_GATE})")
    if not run.device_cached or not np.isfinite(run.mean_ap):
        raise AssertionError("the trained run was not device-cached or its "
                             "mAP is not finite")
    _, cpu_model = predict.load_model("mobilenet_v2", tree, device="cpu")
    check_outputs_on_cpu("mobilenet_v2 trained", run, cpu_model, 2,
                         PATH_BATCH)
    anchors_t = torch.from_numpy(run.anchors).to(CARD)
    for b in range(2, n_batches):
        check_nms_on_cpu(f"mobilenet_v2 trained batch {b}", run, b,
                         anchors_t)
    if gap > TRAINED_MAP_CPU_BAR:
        cpu_run = predict.main(argv + ["--device", "cpu"])
        print(f"trained: mAP beyond the CPU's bar {TRAINED_MAP_CPU_BAR}: "
              f"CPU mAP {cpu_run.mean_ap!r}; first detection that differs "
              f"card vs CPU: "
              + first_difference(_host_results(run),
                                 _host_results(cpu_run)))
    if gap > TRAINED_MAP_GATE:
        raise AssertionError(f"trained mAP {run.mean_ap} is {gap} from the "
                             f"JAX predictor's {TRAINED_MAP_JAX}")

    streamed, _ = _serve_counted(argv + ["--device-cache", "off",
                                         "--workers", "4"])
    equal = (len(streamed.results) == n_batches and all(
        torch.equal(a, b) for ra, rb in zip(streamed.results, run.results)
        for a, b in zip(ra, rb)))
    print(f"trained: --device-cache off --workers 4: {n_batches} NMSResults "
          f"bit-equal to the device-cached run's: {equal}; mAP "
          f"{streamed.mean_ap!r}")
    if not equal or streamed.device_cached:
        raise AssertionError("the streamed run's NMSResults differ from the "
                             "device-cached run's")

    unfolded, _ = _serve_counted(argv + ["--no-fold-bn"])
    unfolded_kept = dict(results=_host_results(unfolded),
                         images=np.concatenate(unfolded.images),
                         mean_ap=unfolded.mean_ap)
    fold_gap = abs(unfolded.mean_ap - run.mean_ap)
    print(f"trained: --no-fold-bn mAP {unfolded.mean_ap!r}, |diff| from the "
          f"folded run {fold_gap:.3g} (gate {FOLD_MAP_GATE})")
    if unfolded.config.fold_bn or fold_gap > FOLD_MAP_GATE:
        raise AssertionError(f"--no-fold-bn: fold_bn="
                             f"{unfolded.config.fold_bn}, mAP {fold_gap} "
                             f"from the folded run's")
    del unfolded, streamed

    bcfg, bmodel = predict.load_model("mobilenet_v2", str(TRAINED_DIR),
                                      device="cuda", compute_dtype=BF16)
    dataset = SyntheticDataset(predict.SYNTHETIC_EVAL_SIZE,
                               image_size=bcfg.img_size,
                               seed=predict.SYNTHETIC_EVAL_SEED)
    nms_keep.LAUNCHES = 0
    bf16_run = predict.serve(bmodel, bcfg, dataset, PATH_BATCH,
                             TRAINED_IMAGES)
    torch.cuda.synchronize()
    launches_bf16 = nms_keep.LAUNCHES
    if launches_bf16 != len(bf16_run.results):
        raise AssertionError(f"nms_keep launched {launches_bf16} times for "
                             f"{len(bf16_run.results)} bfloat16 batches")
    agree = detection_agreement(_concat(_host_results(bf16_run)),
                                _concat(_host_results(run)))
    print(f"trained: bf16 mAP {bf16_run.mean_ap!r} (float32 "
          f"{run.mean_ap!r}), nms_keep launches={launches_bf16}, detection "
          f"agreement with float32 {agree:.4f} (gate {BF16_AGREEMENT})")
    if not np.isfinite(bf16_run.mean_ap) or agree < BF16_AGREEMENT:
        raise AssertionError(f"trained bf16: mAP {bf16_run.mean_ap}, "
                             f"detection agreement {agree} < "
                             f"{BF16_AGREEMENT}")
    vs_f32 = [_max_rel(got, want)
              for pair, f32 in zip(bf16_run.outputs, run.outputs)
              for got, want in zip(pair, f32)]
    print(f"trained: bf16 vs float32 on the card, max err / scale over "
          f"{len(bf16_run.outputs)} batches' deltas and logits: "
          f"{min(vs_f32):.4g}-{max(vs_f32):.4g} (gate [{BF16_MIN_VS_F32}, "
          f"{BF16_TRAINED_VS_F32:.5g}])")
    if not BF16_MIN_VS_F32 <= min(vs_f32) <= max(vs_f32) <= \
            BF16_TRAINED_VS_F32:
        raise AssertionError(f"trained bf16 outputs {min(vs_f32)}-"
                             f"{max(vs_f32)} from float32, outside "
                             f"[{BF16_MIN_VS_F32}, {BF16_TRAINED_VS_F32}]")
    _, cpu_bf16 = predict.load_model("mobilenet_v2", tree, device="cpu",
                                     compute_dtype=BF16)
    with torch.no_grad():
        cpu_out = cpu_bf16(preprocess_images(torch.from_numpy(
            bf16_run.images[0])))
    rels = {name: _max_rel(got, want) for name, got, want in zip(
        ("deltas", "logits"), bf16_run.outputs[0], cpu_out)}
    control = {name: _max_rel(got, want) for name, got, want in zip(
        ("deltas", "logits"), run.outputs[0], cpu_out)}
    print(f"trained: card bf16 vs the port's bf16 CPU path on batch 0, max "
          f"err / scale: "
          + ", ".join(f"{k} {v:.4g}" for k, v in rels.items())
          + f" (gate {BF16_TRAINED_VS_CPU:.5g}); control, card float32 vs "
          f"the same CPU path: "
          + ", ".join(f"{k} {v:.4g}" for k, v in control.items()))
    if not all(v <= BF16_TRAINED_VS_CPU for v in rels.values()):
        raise AssertionError(f"trained bf16 outputs {rels} from the bf16 "
                             f"CPU path > {BF16_TRAINED_VS_CPU}")
    check_nms_on_cpu("mobilenet_v2 trained bf16 batch 0", bf16_run, 0,
                     anchors_t)

    thr = (run.config.nms_iou_threshold, run.config.nms_score_threshold)
    keep_rows = {}
    for bs in (PATH_BATCH, 64):
        boxes, scores, _ = check_keep_on_candidates(
            run.model, run.config, eval_images(run.config, bs),
            "mobilenet_v2 trained")
        r = scores.shape[0]
        print(f"trained: candidates R={r}: "
              f"{candidate_stats(scores, thr[1])}; seeded weights: "
              f"{candidate_stats(seeded_cands[r][1], thr[1])}")
        keep_rows[r] = time_keep(boxes, scores, thr, "mobilenet_v2 trained")
    images = eval_images(run.config, HEADLINE_BATCH)
    time_serving(run, images, ((PATH_BATCH, 30), (64, 10),
                               (HEADLINE_BATCH, 5)), "mobilenet_v2 trained")
    time_serving(bf16_run, images, ((HEADLINE_BATCH, 5),),
                 "mobilenet_v2 trained bf16")
    return dict(launches=launches, launches_bf16=launches_bf16,
                keep_rows=keep_rows, unfolded=unfolded_kept)


# The VOC phase: the trainer CLI on drill trees (tfssd_torch.make_voc_drill)
# through both feeds and --steps-per-call 2, at each config's training
# batch. (trainval, test) images of each image size: at batch 32, 4 steps
# and 1 validation batch an epoch, enough for --steps-per-call 2 and for
# the run-to-run floor, and short enough for the script's time.
VOC_DRILL = {300: (128, 32), 512: (128, 32)}
VOC_EPOCHS = 2
# MobileNetV2's diverging run for --debug-nans: Adam moves every weight by
# ~lr in step 0, so step 1's forward overflows.
NAN_LR = "1e30"
# The match/encode kernel's name in a profiler trace (csrc/match_encode.cu).
MATCH_KERNEL = "match_encode_kernel"


def make_voc_drills() -> dict:
    """{image size: VOC root} of fresh drill trees under build/."""
    roots = {}
    for size, (train, test) in VOC_DRILL.items():
        out = ROOT / "build" / "chip_smoke_voc" / f"drill{size}"
        if out.exists():
            shutil.rmtree(out)
        t0 = time.perf_counter()
        roots[size] = make_drill(str(out), train, test, size)
        print(f"voc: drill tree of {train} + {test} images at {size} "
              f"written in {time.perf_counter() - t0:.2f} s")
    return roots


@dataclasses.dataclass
class VocRun:
    """What the VOC phase keeps of one trainer run (not its state, whose
    device memory would count in every later peak): every step's metrics,
    the validation losses, the steps, the log directory and steps per
    epoch, and the match/encode launches."""

    step_metrics: list
    val_losses: dict
    steps_run: int
    log_path: str
    steps_per_epoch: int
    launches: int


def voc_run(name: str, batch: int, root: str, label: str,
            flags: Sequence[str] = ()) -> VocRun:
    """trainer.main on the drill tree `root` with `flags`; the match/encode
    launches (counted from 0) must equal its train steps and validation
    batches, its metrics finite. Prints its readings."""
    out = ROOT / "build" / "chip_smoke_voc" / name / label
    if out.exists():
        shutil.rmtree(out)
    argv = ["--backbone", name, "--device", "cuda", "--batch-size",
            str(batch), "--dataset", "voc", "--data-root", root,
            "--val-split", "test", "--epochs", str(VOC_EPOCHS),
            "--seed", str(SEED), "--model-dir", str(out / "model"),
            "--log-dir", str(out / "logs"), *flags]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    match_encode.LAUNCHES = 0
    run = trainer.main(argv)
    torch.cuda.synchronize()
    launches = match_encode.LAUNCHES
    peak = profiling.device_memory_stats()["cuda:0"]["peak_bytes_in_use"]
    want = run.steps_run + run.val_batches
    wait = run.prefetch
    wait_text = (f"prefetch waits {wait.waited} of {wait.items} calls "
                 f"(share {wait.wait_share}, {wait.wait_s:.3f} s)"
                 if not run.device_cache else "device-cached")
    print(f"voc: {name} {label} ({' '.join(flags)}; cuDNN deterministic "
          f"{torch.backends.cudnn.deterministic}) batch {batch}: "
          f"{run.steps_run} steps + {run.val_batches} validation batches, "
          f"match_encode launches={launches}, e2e img/s="
          f"{run.e2e_img_per_s}, seconds per epoch {run.epoch_seconds}, "
          f"{wait_text}, peak device memory {peak / 2**30:.2f} GiB "
          f"(device_memory_stats; {held / 2**30:.2f} GiB held before), "
          f"val_losses={run.val_losses} ({CARD_LINE})")
    if launches != want:
        raise AssertionError(f"match_encode launched {launches} times for "
                             f"{want} train steps + val batches ({name} "
                             f"{label})")
    values = [v for m in run.step_metrics for v in m.values()] + list(
        run.val_losses.values())
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"non-finite metric ({name} {label})")
    return VocRun(run.step_metrics, run.val_losses, run.steps_run,
                  run.log_path, run.steps_per_epoch, launches)


def run_distance(got, want) -> dict:
    """Per metric, the largest relative difference over the steps of two
    runs, and the final validation loss's."""
    keys = want.step_metrics[0].keys()
    d = {k: max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
                for g, w in zip(got.step_metrics, want.step_metrics))
         for k in keys}
    last = max(want.val_losses)
    d["val_loss"] = (abs(got.val_losses[last] - want.val_losses[last])
                     / abs(want.val_losses[last]))
    return d


def voc_config(name: str, batch: int, root: str) -> dict:
    """The feeds of one config on its drill tree. With cuDNN's
    deterministic algorithms (its default heuristic picks some that
    accumulate in a varying order, so two default runs part from step 0's
    gradient on): (a) streamed with 8 decode threads 4 batches ahead, (b)
    device-cached, twice (the card's run-to-run floor), (c) streamed at
    --steps-per-call 2, for MobileNetV2 also (d) device-cached at 2. Step
    0's metrics must be bit-equal across them, every later metric and the
    final validation loss of each within the floor. Then (b) once more
    with cuDNN's default algorithms, as users train: step 0's loss metrics
    bit-equal to (b)'s, its distance from (b) printed."""
    labels = {
        "streamed": ("--device-cache", "off", "--workers", "8",
                     "--prefetch-depth", "4"),
        "cached": ("--device-cache", "on"),
        "cached_again": ("--device-cache", "on"),
        "spc2": ("--device-cache", "off", "--steps-per-call", "2"),
    }
    if name == "mobilenet_v2":
        labels["cached_spc2"] = ("--device-cache", "on", "--steps-per-call",
                                 "2")
    default_algorithms = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {label: voc_run(name, batch, root, label, flags)
                for label, flags in labels.items()}
    finally:
        torch.backends.cudnn.deterministic = default_algorithms
    runs["cached_default"] = voc_run(name, batch, root, "cached_default",
                                     labels["cached"])
    base = runs["cached"]
    if len({r.steps_run for r in runs.values()}) != 1:
        raise AssertionError(f"{name}: the feeds ran different step counts")
    floor = run_distance(runs["cached_again"], base)
    print(f"voc: {name} floor (device-cached twice, cuDNN deterministic): "
          f"{floor} ({CARD_LINE})")
    for label, run in runs.items():
        first, want = run.step_metrics[0], base.step_metrics[0]
        if label == "cached_default":
            # the forward is deterministic; the gradient need not be
            first = {k: v for k, v in first.items() if k != "grad_norm"}
            want = {k: v for k, v in want.items() if k != "grad_norm"}
        if first != want:
            raise AssertionError(f"{name} {label}: step 0 metrics {first} "
                                 f"!= device-cached {want}")
        if label in ("cached", "cached_again"):
            continue
        d = run_distance(run, base)
        if label == "cached_default":
            print(f"voc: {name} cuDNN's default algorithms against "
                  f"deterministic ones, device-cached: {d}; step 0's "
                  f"grad_norm {run.step_metrics[0]['grad_norm']!r} / "
                  f"{base.step_metrics[0]['grad_norm']!r}")
            continue
        over = [k for k in d if d[k] > floor[k]]
        print(f"voc: {name} {label} against device-cached: {d}; beyond "
              f"the floor: {over or 'none'}")
        if over:
            raise AssertionError(f"{name} {label}: {over} beyond the "
                                 f"card's run-to-run floor")
    return runs


def voc_profile_and_nans(batch: int, root: str) -> None:
    """--profile on MobileNetV2's streamed run: the trace names the
    match/encode kernel and a train_step range for each step of epoch 0.
    --debug-nans on a diverging run raises FloatingPointError and, with
    --profile, still writes its trace; the same run without the flag is
    printed."""
    run = voc_run("mobilenet_v2", batch, root, "profile", (
        "--device-cache", "off", "--profile"))
    trace = (Path(run.log_path) / profiling.TRACE_FILE).read_text()
    steps = run.steps_per_epoch
    missing = [k for k in range(steps) if f'"train_step#{k}"' not in trace]
    if MATCH_KERNEL not in trace or missing:
        raise AssertionError(f"profile trace: match_encode_kernel "
                             f"{MATCH_KERNEL in trace}, steps "
                             f"without a train_step range {missing}")
    if f'"train_step#{steps}"' in trace:
        raise AssertionError("the trace holds a step of epoch 1")
    print(f"voc: --profile trace {len(trace) / 2**20:.1f} MiB names "
          f"{MATCH_KERNEL} and train_step#0..{steps - 1}")
    out = ROOT / "build" / "chip_smoke_voc" / "nans"
    if out.exists():
        shutil.rmtree(out)
    argv = ["--device", "cuda", "--batch-size", str(batch), "--dataset",
            "voc", "--data-root", root, "--val-split", "test", "--epochs",
            "1", "--steps-per-epoch", "2", "--log-every", "1",
            "--init-lr", NAN_LR, "--device-cache", "off",
            "--model-dir", str(out / "model")]
    match_encode.LAUNCHES = 0
    try:
        trainer.main(argv + ["--debug-nans", "--profile", "--log-dir",
                             str(out / "logs_flag")])
    except FloatingPointError as e:
        raised = str(e)
    else:
        raise AssertionError("--debug-nans did not raise on a diverging run")
    traces = list((out / "logs_flag").rglob(profiling.TRACE_FILE))
    if len(traces) != 1 or MATCH_KERNEL not in traces[0].read_text():
        raise AssertionError("--debug-nans --profile wrote no trace of the "
                             "kernel")
    print(f"voc: --debug-nans raised FloatingPointError: {raised}; its "
          f"trace was written ({match_encode.LAUNCHES} match_encode "
          f"launches)")
    losses = trainer.main(argv + ["--log-dir", str(out / "logs_plain")])
    print(f"voc: without --debug-nans the same run ends: losses "
          f"{[m['loss'] for m in losses.step_metrics]}, val_losses "
          f"{losses.val_losses}")
    del losses


# The export phase: predict --export of the committed checkpoint, loaded
# in a fresh process that imports only the ops and utils/export.py.
EXPORT_DIR = Path("build") / "chip_smoke_export"
EXPORT_BATCH = 8
# batches of the artifact served on the CPU in the fresh process, held
# against the port's CPU path
EXPORT_CPU_BATCHES = 1
# the artifact on the card against the eager --no-fold-bn run on the card
# (the same ATen graph and the same cuDNN kernels: bit-equal expected),
# and on the CPU against the port's CPU path; boxes and scores, max |diff|
EXPORT_ATOL = 1e-6
EXPORT_TIMING_ITERS = 20
EXPORT_CHILD_TIMEOUT_S = 600

# The VGG16 configurations exported with seeded weights (the committed
# SSD300-VGG16 checkpoint is not copied to the card): (export batch,
# images served) each; a batch the CPU copy serves in seconds.
EXPORT_VGG = {"vgg16": (2, 8), "vgg16_512": (1, 4)}

# What the fresh process runs: no module of tfssd_torch.models; the
# images are preprocessed with models/decoder.py:preprocess_images's ops.
# Its argument is a JSON list of jobs (artifact, images, output, batch, CPU
# batches); each artifact serves its images on the card, nms_keep's
# launches counted from 0, then its first batches on the CPU.
EXPORT_CHILD = r"""
import json, sys, time
import numpy as np
import torch
import tfssd_torch.ops.kernels as kernels
from tfssd_torch.utils.export import load_exported

def pre(x):
    return x.float() / 255.0 * 2.0 - 1.0

reports = []
for job in json.loads(sys.argv[1]):
    blob = open(job["path"], "rb").read()
    images = np.load(job["images"])
    batch = job["batch"]
    t0 = time.perf_counter()
    serve = load_exported(blob, "cuda")
    load_s = time.perf_counter() - t0
    kernels.nms_keep.LAUNCHES = 0
    card = []
    for b in range(0, len(images), batch):
        res = serve(pre(torch.from_numpy(images[b:b + batch]).cuda()))
        card.append([t.cpu().numpy() for t in res])
    torch.cuda.synchronize()
    launches = kernels.nms_keep.LAUNCHES
    del serve
    cpu_serve = load_exported(blob, "cpu")
    cpu = [[t.numpy() for t in cpu_serve(pre(torch.from_numpy(
        images[b:b + batch])))]
        for b in range(0, job["cpu_batches"] * batch, batch)]
    fields = type(res)._fields
    np.savez(job["out"], **{f"card_{f}": np.concatenate([r[i] for r in card])
                            for i, f in enumerate(fields)},
             **{f"cpu_{f}": np.concatenate([r[i] for r in cpu])
                for i, f in enumerate(fields)})
    reports.append({"launches": launches, "calls": len(card),
                    "load_s": load_s, "result_type": type(res).__name__})
print(json.dumps({"jobs": reports, "model_modules": sorted(
    m for m in sys.modules if m.startswith("tfssd_torch.models"))}))
"""


def _results_map(results: nms.NMSResult, config) -> float:
    """VOC07 mAP of host NMSResults (B = TRAINED_IMAGES) on the predictor's
    synthetic evaluation split, as predict.serve scores them."""
    from tfssd_torch.data.voc import LABELS
    from tfssd_torch.evaluate import (detections_from_nms_result,
                                      evaluate_predictions)

    dataset = SyntheticDataset(predict.SYNTHETIC_EVAL_SIZE,
                               image_size=config.img_size,
                               seed=predict.SYNTHETIC_EVAL_SEED)
    n = len(results.valid)
    host, _ = stage_arrays(TakeDataset(dataset, n), config.max_gt_boxes)
    gts = [{"boxes": host["boxes"][i], "labels": host["labels"][i],
            "difficult": host["difficult"][i]} for i in range(n)]
    dets = detections_from_nms_result(results, num_valid=n)
    return evaluate_predictions(gts, dets,
                                num_classes=config.total_labels - 1,
                                class_names=LABELS)["map"]


def _nms_distance(got: nms.NMSResult, want: nms.NMSResult) -> dict:
    """classes and valid equal or not; boxes' and scores' max |diff|."""
    return dict(valid=bool(np.array_equal(got.valid, want.valid)),
                classes=bool(np.array_equal(got.classes, want.classes)),
                boxes=float(np.abs(got.boxes - want.boxes).max()),
                scores=float(np.abs(got.scores - want.scores).max()))


def _check_nms_distance(d: dict, label: str) -> None:
    if not (d["valid"] and d["classes"] and d["boxes"] <= EXPORT_ATOL
            and d["scores"] <= EXPORT_ATOL):
        raise AssertionError(f"export: {label}: {d} (gate: classes and "
                             f"valid equal, boxes and scores within "
                             f"{EXPORT_ATOL})")


def _export(argv: list, path: Path) -> tuple:
    """predict.main(["--export", path, ...argv]): (seconds, MiB)."""
    t0 = time.perf_counter()
    if predict.main(["--export", str(path)] + argv) is not None:
        raise AssertionError("predict --export served instead of exporting")
    return time.perf_counter() - t0, path.stat().st_size / 2**20


def _serve_fresh(jobs: list) -> dict:
    """EXPORT_CHILD in a fresh process on `jobs`: its report, each job's
    (card, cpu) NMSResults added; the launches must equal the calls, no
    model module imported."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", EXPORT_CHILD, json.dumps(jobs)],
        cwd=ROOT, capture_output=True, text=True,
        timeout=EXPORT_CHILD_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"export: the fresh process failed:\n"
                             f"{proc.stderr[-4000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    report["seconds"] = time.perf_counter() - t0
    if report["model_modules"]:
        raise AssertionError(f"export: the fresh process imported "
                             f"{report['model_modules']}")
    for job, r in zip(jobs, report["jobs"]):
        n = len(np.load(job["images"], mmap_mode="r"))
        if (r["launches"] != r["calls"] or r["calls"] * job["batch"] != n
                or r["result_type"] != "NMSResult"):
            raise AssertionError(f"export: the fresh process's report {r} "
                                 f"({job['path']})")
        with np.load(job["out"]) as out:
            r["card"], r["cpu"] = (nms.NMSResult(*(
                out[f"{side}_{f}"] for f in nms.NMSResult._fields))
                for side in ("card", "cpu"))
    return report


def _cpu_eager(backbone: str, weights, images: np.ndarray) -> nms.NMSResult:
    """The port's CPU path (the unfolded model) on uint8 `images`."""
    cfg, cpu_model = predict.load_model(backbone, weights, SEED,
                                        device="cpu", fold_bn=False)
    anchors = torch.from_numpy(generate_anchors(cfg))
    with torch.no_grad():
        deltas, logits = cpu_model(preprocess_images(torch.from_numpy(
            images)))
        return nms.NMSResult(*(t.numpy() for t in decode_predictions(
            anchors, deltas, logits, cfg)))


def export_phase(unfolded: dict) -> dict:
    """predict --export of the committed checkpoint at its defaults, and of
    SSD300-VGG16 and SSD512 with seeded weights, served by one fresh
    process on the card (nms_keep launched once per call) and on the CPU;
    held against the eager --no-fold-bn runs (phase 4's for the
    checkpoint), the port's CPU path and TRAINED_MAP_JAX; then live
    against artifact img/s, MobileNetV2 bfloat16 at batch 256."""
    EXPORT_DIR.mkdir(parents=True, exist_ok=True)
    exports = {}
    np.save(EXPORT_DIR / "mobilenet_v2.npy", unfolded["images"])
    exports["mobilenet_v2"] = dict(
        argv=["--export-batch", str(EXPORT_BATCH)],
        eager=_concat(unfolded["results"]),
        job=dict(path=str(EXPORT_DIR / "ssd_mobilenet_v2_b8.pt2"),
                 images=str(EXPORT_DIR / "mobilenet_v2.npy"),
                 out=str(EXPORT_DIR / "mobilenet_v2.npz"),
                 batch=EXPORT_BATCH, cpu_batches=EXPORT_CPU_BATCHES))
    for name, (batch, count) in EXPORT_VGG.items():
        seeded = ["--backbone", name, "--random-weights", "--seed", str(SEED)]
        eager, _ = _serve_counted(seeded + [
            "--no-fold-bn", "--no-eval", "--limit", str(count),
            "--batch-size", str(batch)])
        images = EXPORT_DIR / f"{name}.npy"
        np.save(images, np.concatenate(eager.images))
        exports[name] = dict(
            argv=seeded + ["--export-batch", str(batch)],
            eager=_concat(_host_results(eager)),
            job=dict(path=str(EXPORT_DIR / f"ssd_{name}_b{batch}.pt2"),
                     images=str(images), out=str(EXPORT_DIR / f"{name}.npz"),
                     batch=batch, cpu_batches=1))
        del eager
    for name, e in exports.items():
        e["export_s"], e["size_mib"] = _export(e["argv"],
                                               Path(e["job"]["path"]))
    report = _serve_fresh([e["job"] for e in exports.values()])
    print(f"export: fresh process ({report['seconds']:.1f} s; "
          f"tfssd_torch.models modules imported "
          f"{report['model_modules']})")
    out = {}
    for (name, e), r in zip(exports.items(), report["jobs"]):
        job = e["job"]
        d_card = _nms_distance(r["card"], e["eager"])
        cli = ["--export", job["path"]] + e["argv"]
        print(f"export: {name}: predict.main({cli}) wrote "
              f"{e['size_mib']:.2f} MiB in {e['export_s']:.1f} s; "
              f"loaded in {r['load_s']:.2f} s, {r['calls']} calls of "
              f"{job['batch']} on the card, nms_keep launches="
              f"{r['launches']}; against the eager --no-fold-bn run "
              f"({len(e['eager'].valid)} images): {d_card} (bit-equal: "
              f"{d_card['boxes'] == d_card['scores'] == 0.0})")
        _check_nms_distance(d_card, f"{name}: card against eager")
        images = np.load(job["images"])[:job["batch"] * job["cpu_batches"]]
        weights = str(TRAINED_DIR) if name == "mobilenet_v2" else None
        d_cpu = _nms_distance(r["cpu"], _cpu_eager(name, weights, images))
        print(f"export: {name}: artifact on the CPU against the port's CPU "
              f"path ({len(images)} images): {d_cpu}")
        _check_nms_distance(d_cpu, f"{name}: CPU against the port's CPU "
                                   f"path")
        out[name] = dict(launches=r["launches"], size_mib=e["size_mib"],
                         export_s=e["export_s"], card=d_card, cpu=d_cpu)
        if name != "mobilenet_v2":
            os.remove(job["path"])
    card = report["jobs"][0]["card"]
    artifact_map = _results_map(card, get_hyper_params("mobilenet_v2"))
    gap = abs(artifact_map - TRAINED_MAP_JAX)
    print(f"export: mobilenet_v2 artifact mAP {artifact_map!r} (eager "
          f"unfolded {unfolded['mean_ap']!r}), |diff| from the JAX "
          f"predictor's {gap:.3g} (gate {TRAINED_MAP_GATE})")
    if gap > TRAINED_MAP_GATE:
        raise AssertionError(f"export: artifact mAP {artifact_map} is {gap} "
                             f"from {TRAINED_MAP_JAX}")
    timing = time_export(EXPORT_DIR / "ssd_mobilenet_v2_bf16_b256.pt2")
    return dict(out["mobilenet_v2"], mean_ap=artifact_map, vgg={
        name: out[name] for name in EXPORT_VGG}, **timing)


def time_export(path: Path) -> dict:
    """Live against artifact img/s (tools/export_bench.py's cell):
    MobileNetV2 bfloat16, seeded weights, BatchNorm unfolded, batch
    HEADLINE_BATCH of images in [-1, 1], CUDA events around
    EXPORT_TIMING_ITERS calls, in turns live, artifact, artifact, live."""
    from tfssd_torch.utils.export import export_predict, load_exported

    cfg, model = predict.load_model("mobilenet_v2", None, SEED, CARD,
                                    compute_dtype=BF16, fold_bn=False)
    anchors = generate_anchors(cfg)
    anchors_t = torch.from_numpy(anchors).to(CARD)
    x = torch.from_numpy(np.random.default_rng(SEED).uniform(
        -1, 1, (HEADLINE_BATCH, cfg.img_size, cfg.img_size, 3)).astype(
            np.float32)).to(CARD)

    def live():
        with torch.no_grad():
            deltas, logits = model(x)
            return decode_predictions(anchors_t, deltas, logits, cfg)

    blob = export_predict(model, anchors, cfg, HEADLINE_BATCH)
    path.write_bytes(blob)
    serve = load_exported(path.read_bytes(), "cuda")
    same = all(torch.equal(a, b) for a, b in zip(live(), serve(x)))
    readings = {"live": [], "artifact": []}
    for name in ("live", "artifact", "artifact", "live"):
        fn = live if name == "live" else (lambda: serve(x))
        readings[name].append(
            HEADLINE_BATCH * 1e3 / time_ms(fn, EXPORT_TIMING_ITERS))
    live_ips = float(np.mean(readings["live"]))
    art_ips = float(np.mean(readings["artifact"]))
    print(f"export: MobileNetV2 bf16 batch {HEADLINE_BATCH}: live "
          f"{readings['live']} img/s, artifact {readings['artifact']} img/s "
          f"(ratio {art_ips / live_ips:.3f}; {len(blob) / 2**20:.2f} MiB; "
          f"NMSResults bit-equal {same}; {CARD_LINE})")
    return dict(live_img_per_s=live_ips, artifact_img_per_s=art_ips,
                bf16_same=same)


# The resume phase: the JAX trainer's committed checkpoint, read whole
# without orbax (weights, BatchNorm statistics, Adam's moments and counts)
# and continued by the port's trainer --resume.
RESUME_DIR = ROOT / "build" / "chip_smoke_resume"
RESUME_STEP = 7680
# the JAX run's schedule geometry (its sidecar): 2 steps an epoch at batch
# 8, so step 7680 starts epoch 3840
RESUME_SIDECAR = TRAINED_DIR.parent / "ssd_mobilenet_v2_meta.json"
RESUME_BATCH = 8
RESUME_STEPS_PER_EPOCH = 2
RESUME_EPOCH = RESUME_STEP // RESUME_STEPS_PER_EPOCH
# the restored model's eval loss terms on the card against the CPU's, the
# float32 train step's loss gate (STEP_GATES["mobilenet_v2"]); eval-mode
# BatchNorm at the trained weights is better conditioned than that step
RESUME_EVAL_GATE = 2e-5


def _resume_model_dir(name: str) -> Path:
    """A model directory holding the committed JAX step (linked) and the JAX
    run's sidecar (copied), as trainer.py --model-dir would find them."""
    root = RESUME_DIR / name
    if root.exists():
        shutil.rmtree(root)
    (root / "ssd_mobilenet_v2").mkdir(parents=True)
    (root / "ssd_mobilenet_v2" / str(RESUME_STEP)).symlink_to(
        (TRAINED_DIR / str(RESUME_STEP)).resolve())
    shutil.copy(RESUME_SIDECAR, root / "ssd_mobilenet_v2_meta.json")
    return root


def _digest(*paths: Path) -> dict:
    """{file: sha256} of every file under `paths` (links followed)."""
    import hashlib

    out = {}
    for top in paths:
        files = [top] if top.is_file() else sorted(
            Path(d) / f for d, _, fs in os.walk(top, followlinks=True)
            for f in fs)
        for f in files:
            out[str(f)] = hashlib.sha256(f.read_bytes()).hexdigest()
    return out


def _resume_run(root: Path, epochs: int, label: str):
    """trainer.main(--resume) on `root` at the JAX run's geometry up to
    `epochs`, cuDNN deterministic: (run, match_encode launches counted
    from 0, its printed lines). Launches must equal its train steps +
    validation batches, its metrics finite."""
    import contextlib
    import io

    argv = ["--device", "cuda", "--batch-size", str(RESUME_BATCH),
            "--steps-per-epoch", str(RESUME_STEPS_PER_EPOCH),
            "--synthetic-size", "64", "--val-limit", "1", "--log-every", "1",
            "--seed", str(SEED), "--resume", "--epochs", str(epochs),
            "--model-dir", str(root),
            "--log-dir", str(RESUME_DIR / "logs")]
    printed = io.StringIO()
    match_encode.LAUNCHES = 0
    with contextlib.redirect_stdout(printed):
        run = trainer.main(argv)
    torch.cuda.synchronize()
    launches = match_encode.LAUNCHES
    want = run.steps_run + run.val_batches
    losses = [m["loss"] for m in run.step_metrics]
    print(f"resume: {label}: {run.steps_run} steps + {run.val_batches} "
          f"validation batches to step {run.state.step}, match_encode "
          f"launches={launches}, losses {losses}, val_losses "
          f"{run.val_losses}; the trainer printed: "
          + " | ".join(printed.getvalue().strip().splitlines()[:3]))
    if launches != want:
        raise AssertionError(f"resume: {label}: match_encode launched "
                             f"{launches} times for {want} train steps + "
                             f"val batches")
    values = [v for m in run.step_metrics for v in m.values()] + list(
        run.val_losses.values())
    if not values or not all(math.isfinite(v) for v in values):
        raise AssertionError(f"resume: {label}: non-finite metric")
    return run, launches, printed.getvalue()


def resume_phase() -> dict:
    """The committed JAX checkpoint read whole, restored on the card and on
    the CPU (the eval losses held against each other), its first step in
    float32 and bfloat16 against the float64 CPU witness (printed), then
    `trainer.main([..., "--model-dir", <the step linked in>, "--resume"])`
    at the JAX run's geometry: 2 steps from 7680, a second --resume from
    the port's own checkpoint, and an uninterrupted 4-step run that the
    two must equal, cuDNN deterministic. The JAX step directory (the
    committed files, linked) and the JAX run's sidecar stay byte for
    byte."""
    from tfssd_torch.utils.checkpoint import OrbaxCheckpoints

    t0 = time.perf_counter()
    tree = OrbaxCheckpoints(str(TRAINED_DIR)).restore_train_state(
        RESUME_STEP)
    read_s = time.perf_counter() - t0
    leaves = flatten_tree(tree)
    opt = [a for k, a in leaves.items() if k.startswith("opt_state/")]
    counts = [int(leaves[k]) for k in ("step", "opt_state/0/count",
                                       "opt_state/1/count")]
    mib = sum(a.nbytes for a in leaves.values()) / 2**20
    print(f"resume: {TRAINED_DIR / str(RESUME_STEP)} read whole in "
          f"{read_s:.2f} s: {len(leaves)} arrays, {mib:.2f} MiB, of them "
          f"opt_state {len(opt)} arrays, "
          f"{sum(a.nbytes for a in opt) / 2**20:.2f} MiB; step, Adam's "
          f"count, the schedule's count {counts}")
    if counts != [RESUME_STEP] * 3 or len(opt) != 410:
        raise AssertionError(f"resume: read {len(opt)} opt_state arrays, "
                             f"counts {counts}")

    cfg = get_hyper_params("mobilenet_v2")
    ds = SyntheticDataset(RESUME_BATCH, image_size=cfg.img_size, seed=SEED)
    host, _ = stage_arrays(ds, cfg.max_gt_boxes)
    evals = {}
    for where, dev in (("card", CARD), ("cpu", torch.device("cpu"))):
        state = create_train_state(cfg, SEED, dev, make_lr_schedule(
            RESUME_STEPS_PER_EPOCH))
        t0 = time.perf_counter()
        OrbaxCheckpoints(str(TRAINED_DIR)).restore(state, RESUME_STEP)
        restore_s = time.perf_counter() - t0
        p = next(state.model.parameters())
        adam = state.optimizer.state[p]
        if (state.step != RESUME_STEP or p.device.type != dev.type
                or adam["exp_avg"].device.type != dev.type
                or adam["step"].device.type != "cpu"
                or float(adam["step"]) != RESUME_STEP):
            raise AssertionError(f"resume: restored on {dev}: step "
                                 f"{state.step}, Adam's step {adam['step']}")
        anchors = torch.from_numpy(generate_anchors(cfg)).to(dev)
        batch = {k: torch.from_numpy(host[k]).to(dev)
                 for k in ("image", "boxes", "labels")}
        evals[where] = {k: float(v) for k, v in train.make_eval_step(
            anchors, cfg)(state, batch).items()}
        print(f"resume: restored into the port's TrainState on {dev} in "
              f"{restore_s:.2f} s; eval metrics {evals[where]}")
        if where == "card":
            # the resumed train step as the trainer runs it (augmentation
            # on), the batch on the card
            step = make_train_step(anchors, cfg, seed=SEED + 1)
            step_ms = time_ms(lambda: step(state, batch), 20)
            print(f"resume: the resumed train step at batch {RESUME_BATCH}"
                  f": {step_ms:.3f} ms ({CARD_LINE})")
        del state
    eval_gap = max(abs(evals["card"][k] / evals["cpu"][k] - 1)
                   for k in ("loss", "loc_loss", "conf_loss"))
    print(f"resume: eval loss terms, card against CPU: {eval_gap:.3g} "
          f"(gate {RESUME_EVAL_GATE})")
    if not eval_gap <= RESUME_EVAL_GATE or (
            evals["card"]["num_pos"] != evals["cpu"]["num_pos"]):
        raise AssertionError(f"resume: eval on the card {evals['card']} "
                             f"against the CPU {evals['cpu']}")

    # the first step from the trained weights, float32 and bfloat16 on the
    # card, against the float64 CPU witness (printed: PERF.md's question)
    bf16 = dataclasses.replace(cfg, compute_dtype=BF16)
    steps = {"float32": _one_train_step(cfg, "cuda", host,
                                        checkpoint=TRAINED_DIR),
             "bfloat16": _one_train_step(bf16, "cuda", host,
                                         checkpoint=TRAINED_DIR),
             "float64_cpu": _one_train_step(cfg, "cpu", host, torch.float64,
                                            checkpoint=TRAINED_DIR)}
    names = sorted(steps["float64_cpu"][1])
    head = [n for n in names if n.startswith("head.")]
    step_d = {}
    for run_name in ("float32", "bfloat16"):
        d = _distances(steps[run_name], steps["float64_cpu"], names, head)
        d["grad_norm"] = abs(steps[run_name][0]["grad_norm"]
                             / steps["float64_cpu"][0]["grad_norm"] - 1)
        step_d[run_name] = d
    bf_f32 = _distances(steps["bfloat16"], steps["float32"], names, head)
    print(f"resume: first step from the trained weights (batch "
          f"{RESUME_BATCH}, no augmentation): metrics "
          + "; ".join(f"{k} {v[0]}" for k, v in steps.items())
          + f"; against the float64 CPU witness: {step_d}; bfloat16 "
          f"against float32: {bf_f32} ({CARD_LINE})")
    for run_name, d in step_d.items():
        if not (d["num_pos"] and all(math.isfinite(d[k]) for k in (
                "loss", "head", "whole", "grad_norm"))):
            raise AssertionError(f"resume: {run_name} step {d}")

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        a = _resume_model_dir("a")
        jax_files = _digest(a / "ssd_mobilenet_v2",
                            a / "ssd_mobilenet_v2_meta.json")
        first, launches, printed = _resume_run(a, RESUME_EPOCH + 1,
                                               "from the JAX checkpoint")
        said = (f"resumed from step {RESUME_STEP} of the JAX package's "
                f"checkpoint {a / 'ssd_mobilenet_v2'}")
        written = sorted(os.listdir(a / "ssd_mobilenet_v2_torch"))
        if (said not in printed or "WARNING" in printed
                or first.steps_run != RESUME_STEPS_PER_EPOCH
                or first.state.step != RESUME_STEP + RESUME_STEPS_PER_EPOCH
                or written != [f"ckpt_{first.state.step}.json",
                               f"ckpt_{first.state.step}.pt"]):
            raise AssertionError(f"resume: the first run: step "
                                 f"{first.state.step}, wrote {written}")
        second, launches_own, printed = _resume_run(
            a, RESUME_EPOCH + 2, "again, from the port's own checkpoint")
        if (f"resumed from step {first.state.step}\n" not in printed
                or "JAX" in printed
                or second.steps_run != RESUME_STEPS_PER_EPOCH
                or second.state.step != first.state.step
                + RESUME_STEPS_PER_EPOCH):
            raise AssertionError(f"resume: the second run did not continue "
                                 f"the port's checkpoint (step "
                                 f"{second.state.step})")
        whole, launches_whole, _ = _resume_run(
            _resume_model_dir("b"), RESUME_EPOCH + 2,
            "uninterrupted, from the JAX checkpoint")
    finally:
        torch.backends.cudnn.deterministic = saved
    split = first.step_metrics + second.step_metrics
    gap = {k: max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
                  for g, w in zip(split, whole.step_metrics))
           for k in whole.step_metrics[0]}
    val_split = {**first.val_losses, **second.val_losses}
    weights_equal = all(
        torch.equal(x, y) for x, y in zip(
            whole.state.model.state_dict().values(),
            second.state.model.state_dict().values()))
    equal = (split == whole.step_metrics and val_split == whole.val_losses
             and weights_equal)
    print(f"resume: 2 + 2 steps against 4 uninterrupted (cuDNN "
          f"deterministic): metrics, validation losses and weights "
          f"bit-equal {equal} (weights {weights_equal}; largest relative "
          f"metric difference {gap}; validation {val_split} / "
          f"{whole.val_losses})")
    if not equal or whole.steps_run != 2 * RESUME_STEPS_PER_EPOCH:
        raise AssertionError("resume: the resumed-then-resumed run differs "
                             "from the uninterrupted one")
    if _digest(a / "ssd_mobilenet_v2",
               a / "ssd_mobilenet_v2_meta.json") != jax_files:
        raise AssertionError("resume: the JAX step directory or sidecar "
                             "changed")
    shutil.rmtree(RESUME_DIR)
    return dict(launches=launches, launches_own=launches_own,
                launches_whole=launches_whole, read_s=read_s, mib=mib,
                step_ms=step_ms, steps=step_d)


# The port-h5 phase: Keras trunk files of seeded arrays (written by
# tfssd_torch.make_keras_drill: the card's machine has no Keras or h5py to
# make them) read without Keras by both CLIs' --port-h5, and the trainer's
# TensorBoard scalars.
KERAS_DIR = ROOT / "build" / "chip_smoke_keras"
PORT_H5_IMAGES = 32
PORT_H5_VGG_IMAGES = 8
PORT_H5_VGG_BATCH = 2
PORT_H5_TRAIN_BATCH = 8
PORT_H5_TRAIN_STEPS = 2


def _trunk_state(backbone: str, arrays) -> dict:
    """The state_dict entries that --port-h5 writes from a trunk's arrays."""
    from tfssd_torch.utils.port_weights import port_mobilenet_v2, port_vgg16

    porter = port_mobilenet_v2 if backbone == "mobilenet_v2" else port_vgg16
    return variables_to_state_dict({c: {"backbone": t}
                                    for c, t in porter(arrays).items()})


def _check_state(label: str, state: dict, trunk: dict, rest: dict) -> None:
    """Every entry of `state` bit-equal to `trunk`'s where it has one, else
    to `rest`'s."""
    differ = [k for k, v in state.items()
              if not torch.equal(v.cpu(), (trunk if k in trunk else rest)[k])]
    print(f"port-h5: {label}: {len(state)} tensors, the {len(trunk)} of the "
          f"trunk bit-equal to the file's and the rest to the weights "
          f"grafted over: {not differ}")
    if differ:
        raise AssertionError(f"port-h5: {label}: {len(differ)} tensors "
                             f"differ, e.g. {differ[:4]}")


def _port_h5_train(argv: list, snapshots: list):
    """trainer.main(argv), the state recorded just after the graft, and
    match_encode's launches counted from 0: (run, launches)."""
    real = trainer.port_h5_into_variables

    def recorded(model, backbone, path):
        real(model, backbone, path)
        snapshots.append({k: v.detach().cpu().clone()
                          for k, v in model.state_dict().items()})
        return model

    trainer.port_h5_into_variables = recorded
    try:
        match_encode.LAUNCHES = 0
        run = trainer.main(argv)
        torch.cuda.synchronize()
        return run, match_encode.LAUNCHES
    finally:
        trainer.port_h5_into_variables = real


def port_h5_phase() -> dict:
    """predict --port-h5 (MobileNetV2 .h5 and .keras over the committed
    checkpoint, unfolded and folded; SSD300-VGG16 over seeded weights) and
    trainer --port-h5 (then --resume), on the card: the served and trained
    states against the files, the launches of both kernels, the outputs
    against the CPU; the trainer's event file against its JSONL."""
    from tfssd_torch.make_keras_drill import write_drill
    from tfssd_torch.utils.checkpoint import OrbaxCheckpoints
    from tfssd_torch.utils.port_weights import port_h5_into_variables
    from tfssd_torch.utils.tfevents import read_records, read_scalars

    if KERAS_DIR.exists():
        shutil.rmtree(KERAS_DIR)
    KERAS_DIR.mkdir(parents=True)
    files = {"mbv2.h5": "mobilenet_v2", "mbv2.keras": "mobilenet_v2",
             "vgg16.h5": "vgg16"}
    t0 = time.perf_counter()
    arrays = {name: write_drill(str(KERAS_DIR / name), backbone, SEED)
              for name, backbone in files.items()}
    print(f"port-h5: drill files written in {time.perf_counter() - t0:.2f} "
          f"s: " + ", ".join(
              f"{n} {os.path.getsize(KERAS_DIR / n) / 2**20:.2f} MiB"
              for n in files))
    import_s = {}
    for name, backbone in files.items():
        # the weight import layer: read the file, port it, graft it into a
        # model on the card
        _, model = predict.load_model(backbone, None, SEED, CARD,
                                      fold_bn=False)
        t0 = time.perf_counter()
        port_h5_into_variables(model, backbone, str(KERAS_DIR / name))
        torch.cuda.synchronize()
        import_s[name] = time.perf_counter() - t0
        del model
    print("port-h5: read, port and graft onto the card: " + ", ".join(
        f"{n} {t:.3f} s" for n, t in import_s.items()) + f" ({CARD_LINE})")
    mb_trunk = _trunk_state("mobilenet_v2", arrays["mbv2.h5"])
    ckpt = OrbaxCheckpoints(str(TRAINED_DIR))
    tree = ckpt.restore_weights(ckpt.serving_step())
    ckpt_state = variables_to_state_dict(
        {k: tree[k] for k in ("params", "batch_stats")})
    launches = {}

    # predict --port-h5 over the committed checkpoint: .h5 and .keras
    # unfolded, the .h5 folded
    h5 = str(KERAS_DIR / "mbv2.h5")
    base = ["--limit", str(PORT_H5_IMAGES), "--batch-size", str(PATH_BATCH)]
    runs = {}
    for label, path, fold in (("h5", h5, False),
                              ("keras", str(KERAS_DIR / "mbv2.keras"), False),
                              ("h5_fold", h5, True)):
        t0 = time.perf_counter()
        runs[label], launches[f"predict_{label}"] = _serve_counted(
            base + ["--port-h5", path] + ([] if fold else ["--no-fold-bn"]))
        run = runs[label]
        print(f"port-h5: predict.main(--port-h5 {path}"
              f"{'' if fold else ' --no-fold-bn'}): {sum(run.num_valid)} "
              f"images in {len(run.results)} batches, nms_keep launches="
              f"{launches[f'predict_{label}']}, {time.perf_counter() - t0:.2f}"
              f" s, mAP {run.mean_ap!r} (heads trained for another trunk)")
        if run.config.fold_bn != fold:
            raise AssertionError(f"port-h5: {label}: fold_bn "
                                 f"{run.config.fold_bn}")
        if not fold:
            _check_state(f"predict {label}", run.model.state_dict(),
                         mb_trunk, ckpt_state)
        _, cpu_model = predict.load_model(
            "mobilenet_v2", str(TRAINED_DIR), device="cpu", fold_bn=fold,
            port_h5=path)
        check_outputs_on_cpu(f"mobilenet_v2 port-h5 {label}", run, cpu_model,
                             2, PATH_BATCH)
        anchors_t = torch.from_numpy(run.anchors).to(CARD)
        for b in range(2, len(run.results)):
            check_nms_on_cpu(f"mobilenet_v2 port-h5 {label} batch {b}", run,
                             b, anchors_t)
    same = all(torch.equal(a, b) for ra, rb in zip(runs["h5"].results,
                                                    runs["keras"].results)
               for a, b in zip(ra, rb))
    print(f"port-h5: the .keras run's NMSResults bit-equal to the .h5 run's: "
          f"{same}")
    if not same:
        raise AssertionError("port-h5: .keras and .h5 serve differently")
    del runs

    # trainer --port-h5: the trunk at step 0, Adam steps it; then --resume
    train_argv = [
        "--device", "cuda", "--batch-size", str(PORT_H5_TRAIN_BATCH),
        "--steps-per-epoch", str(PORT_H5_TRAIN_STEPS), "--epochs", "1",
        "--synthetic-size", "16", "--val-limit", "1", "--log-every", "1",
        "--seed", str(SEED), "--port-h5", h5,
        "--model-dir", str(KERAS_DIR / "model"),
        "--log-dir", str(KERAS_DIR / "logs")]
    snapshots = []
    t0 = time.perf_counter()
    run, launches["train"] = _port_h5_train(train_argv, snapshots)
    seeded = init_random_weights(get_model(get_hyper_params("mobilenet_v2")),
                                 SEED).state_dict()
    _check_state("trainer at step 0", snapshots[0], mb_trunk, seeded)
    want = run.steps_run + run.val_batches
    losses = [m["loss"] for m in run.step_metrics]
    params = dict(run.state.model.named_parameters())
    held = {id(p) for g in run.state.optimizer.param_groups
            for p in g["params"]}
    moved = sum(not torch.equal(params[k].detach().cpu(), snapshots[0][k])
                for k in params if k in mb_trunk)
    trunk_params = sum(k in mb_trunk for k in params)
    print(f"port-h5: trainer.main(--port-h5 {h5}): {run.steps_run} steps + "
          f"{run.val_batches} validation batch, match_encode launches="
          f"{launches['train']}, losses {losses}, {moved} of the "
          f"{trunk_params} ported trunk parameters moved, Adam holds every "
          f"parameter: {held == {id(p) for p in params.values()}}, "
          f"{time.perf_counter() - t0:.2f} s")
    if (launches["train"] != want or run.steps_run != PORT_H5_TRAIN_STEPS
            or not all(math.isfinite(x) for x in losses)
            or moved != trunk_params
            or held != {id(p) for p in params.values()}):
        raise AssertionError("port-h5: the trainer's run")
    (log_dir,) = (KERAS_DIR / "logs" / "ssd_mobilenet_v2_torch").iterdir()
    (events,) = log_dir.glob("events.out.tfevents.*.v2")
    records = read_records(str(events))  # both CRC-32Cs of each checked
    version, scalars = read_scalars(str(events))
    with open(log_dir / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    logged = [(k, line["step"], float(np.float32(v))) for line in lines
              for k, v in line.items() if k not in ("step", "time")]
    print(f"port-h5: {events.name}: {len(records)} records, CRC-32Cs "
          f"checked, {version}; its {len(scalars)} scalars equal the "
          f"{len(logged)} of metrics.jsonl at their steps: "
          f"{scalars == logged}")
    if version != "brain.Event:2" or scalars != logged or not logged:
        raise AssertionError("port-h5: the event file and the JSONL differ")
    final = {k: v.detach().cpu().clone()
             for k, v in run.state.model.state_dict().items()}
    del run
    snapshots.clear()
    resumed, launches["resume"] = _port_h5_train(train_argv + ["--resume"],
                                                 snapshots)
    equal = all(torch.equal(v.cpu(), final[k])
                for k, v in resumed.state.model.state_dict().items())
    print(f"port-h5: trainer.main(--resume --port-h5): grafted "
          f"{len(snapshots)} time, resumed at step {resumed.state.step}, "
          f"its weights bit-equal to the checkpoint's: {equal}")
    if len(snapshots) != 1 or not equal or resumed.state.step != \
            PORT_H5_TRAIN_STEPS or resumed.steps_run:
        raise AssertionError("port-h5: --resume did not override the file")
    del resumed

    # SSD300-VGG16 over seeded weights
    vgg = str(KERAS_DIR / "vgg16.h5")
    run, launches["predict_vgg16"] = _serve_counted([
        "--backbone", "vgg16", "--random-weights", "--seed", str(SEED),
        "--port-h5", vgg, "--limit", str(PORT_H5_VGG_IMAGES),
        "--batch-size", str(PORT_H5_VGG_BATCH)])
    print(f"port-h5: predict.main(--backbone vgg16 --random-weights "
          f"--port-h5 {vgg}): {len(run.results)} batches, nms_keep "
          f"launches={launches['predict_vgg16']}")
    _, cpu_seeded = predict.load_model("vgg16", None, SEED, "cpu")
    _check_state("predict vgg16", run.model.state_dict(),
                 _trunk_state("vgg16", arrays["vgg16.h5"]),
                 cpu_seeded.state_dict())
    _, cpu_model = predict.load_model("vgg16", None, SEED, "cpu",
                                      port_h5=vgg)
    check_outputs_on_cpu("vgg16 port-h5", run, cpu_model, 1,
                         PORT_H5_VGG_BATCH)
    shutil.rmtree(KERAS_DIR)
    return dict(launches, import_s=import_s)


# The data-parallel phase: trainer.main under a process group on the one
# card; cases (a) two gloo ranks sharing cuda:0, (b) NCCL at world size 1.
DP_DIR = ROOT / "build" / "chip_smoke_dp"
DP_BATCH = 32
DP_EPOCHS = 2
# Two ranks against one process at the global batch, cuDNN deterministic.
# In float32 (the trainer as users run it) step 0 differs by rounding only
# (the ranks' augmentation resamples 16 rows, whose batched matmuls round
# otherwise than 32 rows'; BatchNorm's two-pass statistics summed over the
# ranks against cuDNN's): loss 0, loc / conf 7.7e-7 / 2.3e-7, grad_norm
# 4.0e-4 relative on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6);
# gates DP_STEP0_LOSS, DP_STEP0_GRAD_NORM. Adam's first steps at
# random weights amplify that rounding as much as a change of cuDNN's
# algorithms does (the control, printed beside): the later steps read
# loss 1.8%, conf 2.4%, grad_norm 10%, the weights 1.41% in every run. A
# first gate of 1e-2 on the weights was refused by that reading; DP_LATER
# now sits at 2-4x the readings and refuses only a gross fault. The later
# steps' semantics, both feeds' sharding of epoch 1 included, are held
# tightly by the float64 runs and DP_F64.
DP_STEP0_LOSS = 1e-4
DP_STEP0_GRAD_NORM = 1e-3
DP_LATER = {"loss": 5e-2, "loc_loss": 5e-2, "conf_loss": 5e-2,
            "grad_norm": 0.3, "val_loss": 2e-2, "params": 5e-2}
# The same runs with the model and Adam in float64, device-cached and
# streamed. The augmentation stays float32, as the step computes it, and
# its resample rounds by batch size on the card (16 rows against 32: 2.4e-7
# apart), which Adam's first steps at random weights amplify to the
# float32 run's 1.4% in the weights; so the one process augments its 32
# rows as the two ranks do (_augment_as_two_ranks). Then the runs differ
# by float64 rounding and the float32 loss: on an NVIDIA H100 80GB HBM3
# at 700 W (PERF.md §6) the loss terms read <= 1.16e-7 (the loss
# is computed in float32), grad_norm 0 at every step, the validation loss
# 0, the weights 1.59e-10 in relative norm. Gates: the loss terms at
# float32's rounding, the rest ~10x the reading or far below any fault.
DP_F64 = {"step0_loss": 1e-6, "step0_loc_loss": 1e-6,
          "step0_conf_loss": 1e-6, "step0_grad_norm": 1e-9,
          "loss": 1e-6, "loc_loss": 1e-6, "conf_loss": 1e-6,
          "grad_norm": 1e-9, "val_loss": 1e-6, "params": 2e-9}


def _float64_train_state(*args, **kwargs):
    """train.create_train_state with the model in float64 (Adam's state
    follows) and a hook that casts the model's float32 input to float64:
    the float64 witness of the trainer's float32 run."""
    state = create_train_state(*args, **kwargs)
    state.model.double()
    state.model.register_forward_pre_hook(lambda m, a: (a[0].double(),))
    return state


def _augment_as_two_ranks(gen, images, boxes, labels, rank=0, world=1):
    """train.augment_batch of a whole batch, computed in two halves as two
    ranks compute theirs (each from the global batch's draws): on the card
    the float32 resample's batched matmuls round by batch size, and these
    halves are bit for bit the two ranks' rows."""
    start = gen.get_state()
    half = images.shape[0] // 2
    parts = []
    for r in range(2):
        gen.set_state(start)
        rows = slice(r * half, (r + 1) * half)
        parts.append(augment_batch(gen, images[rows], boxes[rows],
                                   labels[rows], r, 2))
    return tuple(torch.cat(t) for t in zip(*parts))


def dp_train(out: str, deterministic: bool = True, float64: bool = False,
             device_cache: str = "on") -> dict:
    """trainer.main at DP_BATCH on the card, augmentation on, cuDNN
    deterministic (unless asked for its default algorithms), in float32
    or with the model in float64, device-cached or streamed, with the
    match/encode launch counter set to 0 just before and read just after;
    in a process group or without one. Runs on each spawned rank
    (parallel.Group) and in this process, where a float64 run augments
    as two ranks do (_augment_as_two_ranks)."""
    shard = parallel.current()
    argv = ["--backbone", "mobilenet_v2", "--device", "cuda",
            "--batch-size", str(DP_BATCH), "--dataset", "synthetic",
            "--synthetic-size", "256", "--epochs", str(DP_EPOCHS),
            "--steps-per-epoch", str(TRAIN_STEPS), "--val-limit", "1",
            "--device-cache", device_cache, "--seed", str(SEED),
            "--model-dir", os.path.join(out, "model"),
            "--log-dir", os.path.join(out, "logs")]
    before = (torch.backends.cudnn.deterministic, trainer.create_train_state,
              train.augment_batch)
    torch.backends.cudnn.deterministic = deterministic
    if float64:
        trainer.create_train_state = _float64_train_state
        if not shard.distributed:
            train.augment_batch = _augment_as_two_ranks
    try:
        t0 = time.perf_counter()
        match_encode.LAUNCHES = 0
        run = trainer.main(argv)
        torch.cuda.synchronize()
        launches = match_encode.LAUNCHES
        seconds = time.perf_counter() - t0
    finally:
        (torch.backends.cudnn.deterministic, trainer.create_train_state,
         train.augment_batch) = before
    return dict(rank=shard.rank, world=shard.world,
                backend=(torch.distributed.get_backend()
                         if shard.distributed else None),
                launches=launches, steps=run.steps_run,
                val_batches=run.val_batches, seconds=seconds,
                metrics=run.step_metrics, val=run.val_losses,
                params={k: v.detach().cpu().numpy() for k, v in
                        run.state.model.state_dict().items()})


# The float64 runs of the data-parallel phase: (label, dp_train kwargs).
DP_F64_RUNS = (("float64 cached", dict(float64=True)),
               ("float64 streamed", dict(float64=True, device_cache="off")))


def dp_gloo_runs(out: str) -> dict:
    """One gloo rank's runs: float32 device-cached, then DP_F64_RUNS."""
    runs = {"float32": dp_train(os.path.join(out, "f32"))}
    for i, (label, kw) in enumerate(DP_F64_RUNS):
        runs[label] = dp_train(os.path.join(out, f"f64_{i}"), **kw)
    return runs


def _dp_distance(got: dict, want: dict) -> dict:
    """Step 0's and the later steps' largest relative metric differences,
    the final validation loss's, the final weights' relative norm."""
    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    keys = ("loss", "loc_loss", "conf_loss", "grad_norm")
    d = {f"step0_{k}": rel(got["metrics"][0][k], want["metrics"][0][k])
         for k in keys}
    d.update({k: max(rel(g[k], w[k]) for g, w in
                     zip(got["metrics"][1:], want["metrics"][1:]))
              for k in keys})
    last = max(want["val"])
    d["val_loss"] = rel(got["val"][last], want["val"][last])
    names = [k for k in want["params"] if "num_batches" not in k]
    a = np.concatenate([got["params"][k].ravel() for k in names])
    b = np.concatenate([want["params"][k].ravel() for k in names])
    d["params"] = float(np.linalg.norm(a.astype(np.float64) - b)
                        / np.linalg.norm(b.astype(np.float64)))
    d["num_pos_equal"] = all(g["num_pos"] == w["num_pos"] for g, w in
                             zip(got["metrics"], want["metrics"]))
    return d


def _format_distance(d: dict) -> str:
    return ", ".join(f"{k} {v:.3g}" if isinstance(v, float) else f"{k} {v}"
                     for k, v in d.items())


def _check_dp_rank(r: dict, label: str) -> None:
    want = r["steps"] + r["val_batches"]
    print(f"dp: {label} rank {r['rank']}/{r['world']} ({r['backend']}): "
          f"{r['steps']} steps + {r['val_batches']} validation batches, "
          f"match_encode launches={r['launches']}, {r['seconds']:.1f} s, "
          f"val_losses={r['val']}")
    if r["launches"] != want or r["steps"] != DP_EPOCHS * TRAIN_STEPS:
        raise AssertionError(f"dp: {label} rank {r['rank']}: match_encode "
                             f"launched {r['launches']} times for {want} "
                             f"train steps + validation batches")
    values = [v for m in r["metrics"] for v in m.values()] + list(
        r["val"].values())
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"dp: {label}: non-finite metric")


def _ranks_equal(ranks: Sequence[dict]) -> bool:
    return all(np.array_equal(ranks[1]["params"][k], v)
               for k, v in ranks[0]["params"].items())


def dp_phase() -> dict:
    """Data-parallel training on the one card: one process without a
    process group, (b) NCCL at world size 1 (bit-equal to it), (a) two
    gloo ranks sharing cuda:0, in float32 (held to the one process by
    DP_STEP0_* and DP_LATER) and in float64 on both feeds (held by
    DP_F64); each rank's match/encode launches equal its steps +
    validation batches."""
    if DP_DIR.exists():
        shutil.rmtree(DP_DIR)
    torch.cuda.empty_cache()
    # both worlds at once, beside this process's runs: each rank's cold
    # start (CUDA context, cuDNN plans) overlaps the others' work; their
    # seconds are not timings
    nccl_group = parallel.Group(dp_train, 1, str(DP_DIR / "nccl1"),
                                backend="nccl")
    gloo_group = parallel.Group(dp_gloo_runs, 2, str(DP_DIR / "gloo2"),
                                backend="gloo")
    single = dp_train(str(DP_DIR / "single"))
    _check_dp_rank(single, "one process")
    control = _dp_distance(dp_train(str(DP_DIR / "default"), False), single)
    single64 = {}
    for i, (label, kw) in enumerate(DP_F64_RUNS):
        single64[label] = dp_train(str(DP_DIR / f"single_f64_{i}"), **kw)
        _check_dp_rank(single64[label], f"one process, {label}")
    (nccl,) = nccl_group.wait()
    gloo = gloo_group.wait()
    out = {}
    _check_dp_rank(nccl, "NCCL world 1")
    equal = (nccl["metrics"] == single["metrics"]
             and nccl["val"] == single["val"]
             and all(np.array_equal(nccl["params"][k], v)
                     for k, v in single["params"].items()))
    print(f"dp: NCCL world 1 bit-equal to no process group (every step's "
          f"metrics, validation losses, final weights): {equal}")
    if not equal:
        raise AssertionError("dp: NCCL at world size 1 is not bit-equal to "
                             "the run without a process group")
    out["nccl1"] = nccl["launches"]
    f32 = [r["float32"] for r in gloo]
    for r in f32:
        _check_dp_rank(r, "gloo, two ranks on cuda:0")
    same = _ranks_equal(f32)
    d = _dp_distance(f32[0], single)
    print(f"dp: two gloo ranks against one process at batch {DP_BATCH}, "
          f"float32: {_format_distance(d)}; gates step 0 loss terms "
          f"{DP_STEP0_LOSS}, grad_norm {DP_STEP0_GRAD_NORM}, later "
          f"{DP_LATER}; the ranks' weights bit-equal {same}; control, one "
          f"process with cuDNN's default algorithms against it: "
          f"{_format_distance(control)} ({CARD_LINE})")
    refused = [k for k in ("loss", "loc_loss", "conf_loss")
               if d[f"step0_{k}"] > DP_STEP0_LOSS]
    refused += ["step0_grad_norm"] * (d["step0_grad_norm"]
                                      > DP_STEP0_GRAD_NORM)
    refused += [k for k, gate in DP_LATER.items() if d[k] > gate]
    if refused or not same or not d["num_pos_equal"]:
        raise AssertionError(f"dp: two ranks against one process: {refused}"
                             f", weights equal {same}, num_pos equal "
                             f"{d['num_pos_equal']}")
    out["gloo2"] = [r["launches"] for r in f32]
    out["distance"] = d
    for label, _ in DP_F64_RUNS:
        ranks = [r[label] for r in gloo]
        for r in ranks:
            _check_dp_rank(r, f"gloo, two ranks on cuda:0, {label}")
        same = _ranks_equal(ranks)
        d = _dp_distance(ranks[0], single64[label])
        print(f"dp: two gloo ranks against one process at batch "
              f"{DP_BATCH}, {label}: {_format_distance(d)}; gates {DP_F64}"
              f"; the ranks' weights bit-equal {same} ({CARD_LINE})")
        refused = [k for k, gate in DP_F64.items() if d[k] > gate]
        if refused or not same or not d["num_pos_equal"]:
            raise AssertionError(
                f"dp: two ranks against one process, {label}: {refused}, "
                f"weights equal {same}, num_pos equal {d['num_pos_equal']}")
        out[f"distance {label}"] = d
    return out


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
              f"({ms:.3f} ms per batch, uint8 on device -> NMSResult; "
              f"{CARD_LINE})")
    return out


def time_keep(boxes, scores, thr, label: str) -> dict:
    """nms_keep and its plain version on one set of candidates: ms per call
    through the op (tfssd::nms_keep, the main path's call), device us per
    launch, host us per call through the op and through the ctypes
    wrapper alone (nms_keep_cuda), bound."""
    r, k = scores.shape

    def call():
        return nms_keep.nms_keep(boxes, scores, *thr)

    ms = time_ms(call, 200)
    dev_us = graph_us(call)
    h_us = host_us(call)
    h_ctypes = host_us(lambda: nms_keep.nms_keep_cuda(boxes, scores, *thr))
    plain = time_ms(lambda: nms_keep.nms_keep_reference(boxes, scores, *thr),
                    10)
    bound, bound_by = keep_bound(r, k)
    print(f"timing: nms_keep {label} R={r} K={k}: kernel {ms:.5f} ms/call "
          f"through the op, device {dev_us:.2f} us per launch "
          f"(graph replay), host {h_us:.2f} us per call through the op, "
          f"{h_ctypes:.2f} through the ctypes wrapper alone, plain "
          f"{plain:.5f} ms/call, bound {bound:.6f} ms ({bound_by}; "
          f"{CARD_LINE})")
    return dict(ms=ms, device_us=dev_us, host_us=h_us,
                host_us_ctypes=h_ctypes, plain_ms=plain, bound_ms=bound,
                bound_by=bound_by)


def time_match(anchors, boxes, labels, cfg) -> dict:
    """match_encode and its plain version on one batch: ms per call
    through the op (tfssd::match_encode, the main path's call), device us
    per launch, host us per call through the op and through the ctypes
    wrapper alone (match_encode_cuda), bound."""
    args = (anchors, boxes, labels, cfg.iou_threshold, cfg.variances)

    def call():
        return match_encode.match_encode(anchors, boxes, labels, cfg)

    ms = time_ms(call, 200)
    dev_us = graph_us(call)
    h_us = host_us(call)
    h_ctypes = host_us(lambda: match_encode.match_encode_cuda(*args))
    plain = time_ms(lambda: matching.match_targets(*args), 20)
    b, g = labels.shape
    n = anchors.shape[0]
    bound = match_bound(n, labels)
    print(f"timing: match_encode B={b} N={n} G={g} real gts "
          f"{bound['real_gts']}: kernel {ms:.5f} ms/call through the op, "
          f"device {dev_us:.2f} us per launch (graph replay), host "
          f"{h_us:.2f} us per call through the op, {h_ctypes:.2f} through "
          f"the ctypes wrapper alone, plain {plain:.5f} ms/call, bound "
          f"{bound['bound_ms']:.6f} ms ({bound['bound_by']}; padded pairs "
          f"{bound['bound_ms_padded']:.6f} ms, {bound['bound_by_padded']}; "
          f"{CARD_LINE})")
    return dict(ms=ms, device_us=dev_us, host_us=h_us,
                host_us_ctypes=h_ctypes, plain_ms=plain, **bound)


def train_path(backbone: str, batch: int, flags: Sequence[str] = ()) -> int:
    """Drive `python -m tfssd_torch.trainer --backbone <backbone> <flags>`
    at full width on the card, then resume it with the same flags; return
    the match_encode launches of the first run."""
    label = " ".join((backbone,) + tuple(flags))
    out = ROOT / "build" / "chip_smoke_train" / "_".join(
        (backbone,) + tuple(f.strip("-") for f in flags))
    common = list(flags) + ["--backbone", backbone, "--device", "cuda",
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
    print(f"path: {label} trainer at batch {batch} ran {run.steps_run} "
          f"steps and {run.val_batches} validation batches, match_encode "
          f"launches={launches}, val_losses={run.val_losses}, e2e "
          f"img/s={run.e2e_img_per_s}, peak device memory "
          f"{peak / 2**30:.2f} GiB ({held / 2**30:.2f} GiB held before)")
    if launches != want:
        raise AssertionError(f"match_encode launched {launches} times for "
                             f"{want} train steps + val batches ({label})")
    losses = [m["loss"] for m in run.train_metrics] + list(
        run.val_losses.values())
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss ({label}): {losses}")
    from tfssd_torch.utils.checkpoint import CheckpointManager
    latest = CheckpointManager(run.model_path).latest_step()
    if latest != run.state.step:
        raise AssertionError(f"latest checkpoint {latest}, trained to step "
                             f"{run.state.step} ({label})")
    del run
    resumed = trainer.main(["--epochs", str(TRAIN_EPOCHS + 1), "--resume"]
                           + common)
    print(f"path: {label} --resume from step {latest} ran "
          f"{resumed.steps_run} steps to step {resumed.state.step}")
    if (resumed.steps_run != TRAIN_STEPS
            or resumed.state.step != latest + TRAIN_STEPS):
        raise AssertionError(f"--resume did not continue from the "
                             f"checkpoint ({label})")
    return launches


def train_path_that_fits(backbone: str, flags: Sequence[str] = ()):
    """(batch, match_encode launches) of train_path at batch 32, or at 16
    where 32 does not fit in device memory; fails where neither fits."""
    for batch in (TRAIN_BATCH, TRAIN_BATCH // 2):
        try:
            return batch, train_path(backbone, batch, flags)
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            print(f"path: {backbone} {' '.join(flags)} training at batch "
                  f"{batch} does not fit")
    raise AssertionError(f"{backbone} trains at neither batch "
                         f"{TRAIN_BATCH} nor {TRAIN_BATCH // 2}")


def _one_train_step(cfg, device: str, host, dtype=torch.float32,
                    tf32: bool = False, checkpoint=None):
    """(metrics, {name: gradient on the CPU}) of one train step without
    augmentation from the seeded weights (or the whole TrainState of the
    JAX checkpoint directory `checkpoint`), on `device`, with the model in
    `dtype` (the images scaled by /255 in float32, as the step does) and
    cuDNN and matmuls in TF32 if `tf32`."""
    from tfssd_torch.utils.checkpoint import OrbaxCheckpoints

    dev = torch.device(device)
    state = create_train_state(cfg, SEED, dev, make_lr_schedule(TRAIN_STEPS))
    if checkpoint is not None:
        OrbaxCheckpoints(str(checkpoint)).restore(state)
    state.model.to(dtype)
    # Adam's moments take the parameters' dtype when its state is loaded
    state.optimizer.load_state_dict(state.optimizer.state_dict())
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

# Gates of the card's bfloat16 train step against the float64 CPU witness
# (the largest relative loss error / the head gradient's and the whole
# gradient's relative distance), ~3x the largest reading of this script
# over noise and synthetic images (NVIDIA H100 80GB HBM3, 700 W; PERF.md
# §6), with the bfloat16 CPU step's beside it:
#   MobileNetV2, batch 8: 5.2e-3-1.2e-2 (cpu 2.0e-3-5.9e-3); 0.154-0.162
#     (0.159-0.162); 1.14-1.17 (1.10-1.20). At random weights BatchNorm
#     amplifies bfloat16 rounding below the head until the backbone's
#     whole gradient is noise (JAX's bfloat16 step too,
#     tests/test_torch_bf16.py): an all-zero gradient reads 1.0, so no
#     gate on it can tell a wrong backward from rounding. It has none; the
#     backbone's backward is held stage by stage instead
#     (BF16_LOCAL_GATES).
#   SSD300-VGG16, batch 2: 3.9e-4-4.8e-4 (1.4e-4-5.0e-4); 0.019-0.027
#     (0.019-0.032); 0.050-0.062 (0.051-0.070).
#   SSD512-VGG16, batch 1: 1.2e-3 (6.0e-4-1.1e-3); 8.4e-3-8.6e-3
#     (7.1e-3-9.2e-3); 0.040-0.047 (0.041-0.044).
# The step must also fail the float32 gates above: it computes in
# bfloat16.
BF16_STEP_GATES = {
    "mobilenet_v2": {"loss": 4e-2, "head": 0.5},
    "vgg16": {"loss": 2e-3, "head": 0.08, "whole": 0.2},
    "vgg16_512": {"loss": 4e-3, "head": 0.03, "whole": 0.15},
}

# Gate of the bfloat16 train step's backward held stage by stage
# (_local_backward): the largest relative distance over the stages'
# parameter gradients and output gradients, ~3x the largest reading of
# this script (MobileNetV2, batch 8, noise and synthetic images: 0.063
# parameters, 0.066 output gradients; NVIDIA H100 80GB HBM3, 700 W;
# PERF.md §6). A stage whose backward returned nothing reads 1.0.
BF16_LOCAL_GATES = {"mobilenet_v2": 0.2}

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
    """One train step of `host` on the card (float32, TF32 as the control,
    and bfloat16) and on the CPU (float32, bfloat16, and the float64
    witness); each one's distances from the witness."""
    bf16 = dataclasses.replace(cfg, compute_dtype=BF16)
    steps = {"card": _one_train_step(cfg, card, host),
             "tf32": _one_train_step(cfg, card, host, tf32=True),
             "bf16": _one_train_step(bf16, card, host),
             "cpu": _one_train_step(cfg, "cpu", host),
             "bf16_cpu": _one_train_step(bf16, "cpu", host),
             "f64": _one_train_step(cfg, "cpu", host, torch.float64)}
    names = sorted(steps["f64"][1])
    head = [n for n in names if n.startswith("head.")]
    out = {run: _distances(steps[run], steps["f64"], names, head)
           for run in ("card", "tf32", "bf16", "cpu", "bf16_cpu")}
    for key, run in (("by_depth", "card"), ("by_depth_bf16", "bf16")):
        out[key] = {
            grp: _rel_norm(steps[run][1], steps["f64"][1],
                           [n for n in names if n.startswith(grp)])
            for grp in DEPTH_GROUPS[cfg.backbone]}
    out["losses"] = {run: steps[run][0]["loss"] for run in steps}
    return out


def _refused(reading: dict, gates: dict) -> list:
    """The gates that `reading` fails (a NaN reading fails)."""
    failed = [k for k in gates if not reading[k] <= gates[k]]
    return failed + ([] if reading["num_pos"] else ["num_pos"])


def _local_backward(cfg, card: str, host) -> dict:
    """One train step of `host` on the card (augmentation off), its
    backward held stage by stage: each child of the backbone that holds
    parameters, and the head, is run again in a float64 copy of the seeded
    weights on the CPU, on the step's own inputs of that stage and
    backward from the step's own gradients of its outputs. Returns
    {stage: (distance of its parameters' gradient, of its outputs'
    gradients)}: the latter against the sum of the witness gradients of
    the stages that read them (None where no stage does). Held so, a
    stage's rounding is not amplified by the stages after it."""
    dev = torch.device(card)
    state = create_train_state(cfg, SEED, dev, make_lr_schedule(TRAIN_STEPS))
    witness = init_random_weights(get_model(dataclasses.replace(
        cfg, compute_dtype="float32")), SEED).double().train()
    stages = [(f"backbone.{n}", m)
              for n, m in state.model.backbone.named_children()
              if next(m.parameters(), None) is not None]
    stages.append(("head", state.model.head))
    seen = []

    def hook(name):
        def record(module, args, out):
            outs = list(out) if isinstance(out, tuple) else [out]
            for o in outs:
                o.retain_grad()
            ins = [t for a in args
                   for t in (a if isinstance(a, (list, tuple)) else [a])]
            seen.append((name, module, ins, outs))
        return record

    handles = [m.register_forward_hook(hook(n)) for n, m in stages]
    try:
        make_train_step(torch.from_numpy(generate_anchors(cfg)).to(dev), cfg,
                        augment=False)(state, {
                            k: torch.from_numpy(host[k]).to(dev)
                            for k in ("image", "boxes", "labels")})
    finally:
        for h in handles:
            h.remove()

    def dist(got, want) -> float:
        scale = float(want.norm())
        err = float((got - want).norm())
        return err / scale if scale else (0.0 if err == 0 else math.inf)

    wanted, params = {}, {}
    for name, module, ins, outs in seen:
        twin = witness.get_submodule(name)
        xs = [x.detach().double().cpu().requires_grad_(x.requires_grad)
              for x in ins]
        ys = twin(xs) if name == "head" else twin(*xs)
        torch.autograd.backward(
            list(ys) if isinstance(ys, tuple) else [ys],
            [o.grad.double().cpu() for o in outs])
        for x, wx in zip(ins, xs):
            if wx.grad is not None:
                wanted[id(x)] = wanted.get(id(x), 0) + wx.grad
        got = torch.cat([p.grad.double().cpu().reshape(-1)
                         for p in module.parameters()])
        want = torch.cat([p.grad.reshape(-1) for p in twin.parameters()])
        params[name] = dist(got, want)
    return {name: (params[name],
                   max((dist(o.grad.double().cpu(), wanted[id(o)])
                        for o in outs if id(o) in wanted),
                       default=None))
            for name, _, _, outs in seen}


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
    head's. The bfloat16 step is held by BF16_STEP_GATES[name], and where
    its whole gradient is rounding noise (MobileNetV2) its backward stage
    by stage by BF16_LOCAL_GATES[name]."""
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
        print(f"path: {name} bf16 train step card vs cpu ({kind} images): "
              f"vs the float64 witness: bfloat16 card "
              + json.dumps(r["bf16"]) + "; bfloat16 cpu "
              + json.dumps(r["bf16_cpu"]) + "; bfloat16 card by depth "
              + json.dumps(r["by_depth_bf16"]))
        failed = _refused(r["card"], gates)
        if failed:
            raise AssertionError(f"{name} train step card vs cpu ({kind}): "
                                 f"{failed} beyond {gates}")
        failed = _refused(r["bf16"], BF16_STEP_GATES[name])
        if failed:
            raise AssertionError(f"{name} bf16 train step card vs cpu "
                                 f"({kind}): {failed} beyond "
                                 f"{BF16_STEP_GATES[name]}")
        if not _refused(r["bf16"], gates):
            raise AssertionError(f"{name} bf16 train step ({kind}) passes "
                                 f"the float32 gates: it does not compute "
                                 f"in bfloat16")
        if name in BF16_LOCAL_GATES:
            local = _local_backward(dataclasses.replace(
                cfg, compute_dtype=BF16), card, host)
            values = [v for pair in local.values() for v in pair
                      if v is not None]
            worst = math.nan if any(map(math.isnan, values)) \
                else max(values)
            print(f"path: {name} bf16 train step's backward stage by stage "
                  f"({kind} images) vs the float64 witness, (parameters, "
                  f"outputs): " + json.dumps(
                      {k: [v if v is None else round(v, 6) for v in pair]
                       for k, pair in local.items()})
                  + f"; largest {worst:.4g} (gate {BF16_LOCAL_GATES[name]})")
            if not worst <= BF16_LOCAL_GATES[name]:
                raise AssertionError(f"{name} bf16 backward stage by stage "
                                     f"({kind}): {worst} > "
                                     f"{BF16_LOCAL_GATES[name]}")
    for kind, r in readings.items():
        missed = set(gates) - set(_refused(r["tf32"], gates))
        if missed:
            raise AssertionError(f"the TF32 control ({name}, {kind}) passes "
                                 f"the gates {sorted(missed)}: they cannot "
                                 f"see a less exact step")
    return readings


# Gate of the remat step against the plain step (bfloat16, batch 32, the
# same state and batch): the whole gradient's relative distance, beside
# the plain step repeated (cuDNN's backward could sum in another order from
# one run to the next; it read 0, and so did remat, on an NVIDIA H100 80GB
# HBM3, PERF.md §6); the loss and the BatchNorm statistics must be
# equal.
REMAT_GRAD = 1e-6


def remat_step_check(name: str) -> dict:
    """One bfloat16 train step of `name` at TRAIN_BATCH (augmentation off,
    the synthetic images) from the same seeded state on the card: plain,
    plain again, and with remat. The remat step's loss and BatchNorm
    statistics must equal the plain step's (each count at 1: the recompute
    leaves them alone) and its gradient lie within REMAT_GRAD of it; the
    peak device memory of each step (the state included) is printed."""
    base = get_hyper_params(name, compute_dtype=BF16)
    host, _ = stage_arrays(SyntheticDataset(TRAIN_BATCH,
                                            image_size=base.img_size,
                                            seed=0), base.max_gt_boxes)
    anchors = torch.from_numpy(generate_anchors(base)).to(CARD)
    out = {}
    for label, remat in (("plain", False), ("again", False), ("remat", True)):
        cfg = dataclasses.replace(base, remat=remat)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        state = create_train_state(cfg, SEED, CARD,
                                   make_lr_schedule(TRAIN_STEPS))
        data = {k: torch.from_numpy(host[k]).to(CARD)
                for k in ("image", "boxes", "labels")}
        metrics = make_train_step(anchors, cfg, augment=False)(state, data)
        torch.cuda.synchronize()
        out[label] = dict(
            loss=float(metrics["loss"]),
            peak=(torch.cuda.max_memory_allocated() - held) / 2**30,
            grads={n: p.grad.double().cpu()
                   for n, p in state.model.named_parameters()},
            stats={k: v.cpu() for k, v in state.model.state_dict().items()
                   if "running_" in k or "num_batches" in k})
        del state, data, metrics
    names = sorted(out["plain"]["grads"])
    again = _rel_norm(out["again"]["grads"], out["plain"]["grads"], names)
    remat = _rel_norm(out["remat"]["grads"], out["plain"]["grads"], names)
    stats_equal = all(torch.equal(out["remat"]["stats"][k], v)
                      for k, v in out["plain"]["stats"].items())
    counts = [int(v) for k, v in out["remat"]["stats"].items()
              if "num_batches" in k]
    print(f"path: {name} bf16 remat step at batch {TRAIN_BATCH}: loss plain "
          f"{out['plain']['loss']:.6f} again {out['again']['loss']:.6f} "
          f"remat {out['remat']['loss']:.6f}; whole gradient vs plain: "
          f"again {again:.3g}, remat {remat:.3g}; BatchNorm statistics "
          f"equal={stats_equal} ({len(counts)} counts, all 1="
          f"{all(c == 1 for c in counts)}); peak device memory plain "
          f"{out['plain']['peak']:.2f} GiB, remat "
          f"{out['remat']['peak']:.2f} GiB ({CARD_LINE})")
    if out["remat"]["loss"] != out["plain"]["loss"]:
        raise AssertionError(f"{name} remat loss differs")
    if remat > REMAT_GRAD:
        raise AssertionError(f"{name} remat gradient {remat} from the "
                             f"plain step > {REMAT_GRAD}")
    if not stats_equal or any(c != 1 for c in counts):
        raise AssertionError(f"{name} remat BatchNorm statistics differ")
    return {k: out[k]["peak"] for k in out}


def time_train_step(backbone: str, batch: int, compute_dtype="float32",
                    remat: bool = False) -> dict:
    """Print the ms per train step of `backbone` at `batch`, augmentation
    on, device-resident data (host clock around synchronised steps), and
    the peak device memory of those steps; return both."""
    cfg = get_hyper_params(backbone, compute_dtype=compute_dtype,
                           remat=remat)
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
    print(f"timing: {backbone} {compute_dtype}{' remat' if remat else ''} "
          f"train {ms:.3f} ms per step, {batch * 1e3 / ms:.1f} img/s at "
          f"batch {batch} (augmentation on, device-resident uint8 data), "
          f"peak device memory {peak:.2f} GiB ({CARD_LINE})")
    return {"ms": ms, "peak_gib": peak}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def main() -> int:
    global CARD_LINE
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    # predict.main's defaults read trained/ relative to the working
    # directory: run from the checkout's root
    os.chdir(ROOT)
    device = CARD
    kind = torch.cuda.get_device_name(0)
    CARD_LINE = card_line()
    print(f"device: {kind}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible; "
          f"{CARD_LINE}")

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
    # the bfloat16 serving path's candidates (float32 scores from
    # bfloat16 logits: more exact ties)
    for name in TRAIN_CONFIGS:
        bcfg, bmodel = predict.load_model(name, None, SEED, device,
                                          compute_dtype=BF16)
        imgs = images if name == "mobilenet_v2" else {
            PATH_BATCH: vgg_images[name][:PATH_BATCH]}
        for bs, batch_images in imgs.items():
            _, _, parity[f"{name}_bf16", bs] = check_keep_on_candidates(
                bmodel, bcfg, batch_images, f"{name} bf16")
        del bmodel
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
    bf16_runs, bf16_launches = {}, {}
    for name in TRAIN_CONFIGS:
        f32_run = run if name == "mobilenet_v2" else vgg_runs[name]
        depth = ((PATH_IMAGES, 2, PATH_BATCH) if name == "mobilenet_v2"
                 else (VGG_PATH_IMAGES, 1, VGG_CPU_IMAGES))
        bf16_runs[name], bf16_launches[name] = serving_path_bf16(
            name, *depth, f32_run)
    trained = {name: train_path_that_fits(name) for name in TRAIN_CONFIGS}
    trained_bf16 = {name: train_path_that_fits(name, ("--bf16",))
                    for name in TRAIN_CONFIGS}
    trained_remat = train_path_that_fits("vgg16_512", ("--bf16", "--remat"))
    for name in TRAIN_CONFIGS:
        train_step_card_vs_cpu(name)
    for name in REMAT_CONFIGS:
        remat_step_check(name)

    section("4. trained")
    trained_run = trained_path(cands)

    section("4b. voc")
    t_voc = time.perf_counter()
    roots = make_voc_drills()
    voc = {name: voc_config(name, trained[name][0],
                            roots[get_hyper_params(name).img_size])
           for name in TRAIN_CONFIGS}
    voc_profile_and_nans(trained["mobilenet_v2"][0], roots[300])
    print(f"voc: phase took {time.perf_counter() - t_voc:.1f} s")

    section("4c. export")
    t_phase = time.perf_counter()
    exported = export_phase(trained_run["unfolded"])
    print(f"export: phase took {time.perf_counter() - t_phase:.1f} s")

    section("4d. data parallel")
    t_phase = time.perf_counter()
    dp = dp_phase()
    print(f"dp: phase took {time.perf_counter() - t_phase:.1f} s")

    section("4e. resume")
    t_phase = time.perf_counter()
    resumed = resume_phase()
    print(f"resume: phase took {time.perf_counter() - t_phase:.1f} s")

    section("4f. port-h5")
    t_phase = time.perf_counter()
    ported = port_h5_phase()
    print(f"port-h5: phase took {time.perf_counter() - t_phase:.1f} s")

    section("5. timing")
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
    bf16_fits = time_serving(bf16_runs["mobilenet_v2"],
                             eval_images(cfg, HEADLINE_BATCH),
                             ((PATH_BATCH, 30), (64, 10),
                              (HEADLINE_BATCH, 5)), "mobilenet_v2 bf16")
    if set(bf16_fits) != {PATH_BATCH, 64, HEADLINE_BATCH}:
        raise AssertionError(f"mobilenet_v2 bf16 serves at batches "
                             f"{sorted(bf16_fits)} only")
    for name in VGG_CONFIGS:
        bf16_fits = time_serving(bf16_runs[name], vgg_images[name],
                                 ((PATH_BATCH, 10), (64, 5)),
                                 f"{name} bf16")
        if set(bf16_fits) != {PATH_BATCH, 64}:
            raise AssertionError(f"{name} bf16 serves at batches "
                                 f"{sorted(bf16_fits)} only")
    rows = {r: time_keep(boxes, scores, thr, "mobilenet_v2")
            for r, (boxes, scores) in sorted(cands.items())}
    vgg_rows = {name: time_keep(boxes, scores, thr, name)
                for name, (boxes, scores) in vgg_cands.items()}
    for name, (batch, _) in trained.items():
        time_train_step(name, batch)
    for name, (batch, _) in trained_bf16.items():
        time_train_step(name, batch, BF16)
    time_train_step("vgg16_512", trained_remat[0], BF16, remat=True)
    me_row = time_match(m_anchors, m_boxes, m_labels, cfg)
    me_rows = {batch[0].shape[0]: time_match(*batch, get_hyper_params(name))
               for name, batch in vgg_match.items()}
    ssd512 = get_hyper_params("vgg16_512")
    full_row = time_match(*full_g_batch(ssd512, device), ssd512)
    print(card_line())

    section("6. kernels")
    print(f"chip_smoke: whole run {time.perf_counter() - t_start:.1f} s")
    r_path = PATH_BATCH * (cfg.total_labels - 1)
    path_row, big_row = rows[r_path], rows[max(rows)]
    timed = ("ms", "device_us", "host_us", "host_us_ctypes", "plain_ms",
             "bound_ms")
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
    for name in TRAIN_CONFIGS:
        entry[f"launches_bf16_{name}"] = bf16_launches[name]
    entry["launches_trained_mobilenet_v2"] = trained_run["launches"]
    entry["launches_trained_bf16_mobilenet_v2"] = trained_run["launches_bf16"]
    entry["launches_export_fresh_process"] = exported["launches"]
    for name, e in exported["vgg"].items():
        entry[f"launches_export_fresh_process_{name}"] = e["launches"]
        entry[f"export_size_mib_{name}"] = e["size_mib"]
    entry.update({f"export_{k}": exported[k] for k in (
        "live_img_per_s", "artifact_img_per_s", "size_mib")})
    for r, row in trained_run["keep_rows"].items():
        entry.update({f"{key}_trained_R{r}": row[key] for key in timed})
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
    for name in TRAIN_CONFIGS:
        match_entry[f"train_batch_bf16_{name}"], match_entry[
            f"launches_bf16_{name}"] = trained_bf16[name]
    match_entry["train_batch_bf16_remat_vgg16_512"], match_entry[
        "launches_bf16_remat_vgg16_512"] = trained_remat
    for name, runs in voc.items():
        for label, reading in runs.items():
            match_entry[f"launches_voc_{name}_{label}"] = reading.launches
    match_entry["launches_dp_nccl1"] = dp["nccl1"]
    match_entry["launches_resume_jax_checkpoint"] = resumed["launches"]
    match_entry["launches_resume_own_checkpoint"] = resumed["launches_own"]
    match_entry["launches_resume_uninterrupted"] = resumed["launches_whole"]
    for rank, n in enumerate(dp["gloo2"]):
        match_entry[f"launches_dp_gloo2_rank{rank}"] = n
    match_entry["launches_port_h5_train"] = ported["train"]
    match_entry["launches_port_h5_resume"] = ported["resume"]
    for key in ("predict_h5", "predict_keras", "predict_h5_fold",
                "predict_vgg16"):
        entry[f"launches_port_h5_{key}"] = ported[key]
    print(json.dumps({"kernels": [entry, match_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
