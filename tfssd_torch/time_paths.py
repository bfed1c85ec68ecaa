"""Serving img/s and train ms/step of SSD300-MobileNetV2 on the card, timed
as chip_smoke.py's timing phase times them, to compare two checkouts of
the port in one call:

    python -m tfssd_torch.time_paths [--rounds 3]

Serving: seeded weights, BatchNorm folded (predict.load_model's default),
float32, uint8 synthetic images on the device -> NMSResult at batch 8
(CUDA events around 30 back-to-back calls after 3). Training: the
device-cached train step at batch 32, augmentation on, float32 (host
clock around 10 synchronised steps after 3). Each round prints one JSON
line with both and the card's name and power limit. The script uses only
functions the port's serving and training CLIs have long had, so a copy of
it in an older checkout's tfssd_torch/ times that checkout: run the two
checkouts in turns (A, B, B, A) within one call.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Optional, Sequence

import torch

from tfssd_torch import get_hyper_params, predict, trainer
from tfssd_torch.data.loader import stage_arrays
from tfssd_torch.data.synthetic import SyntheticDataset
from tfssd_torch.models.decoder import make_predict_fn
from tfssd_torch.ops.boxes import generate_anchors
from tfssd_torch.train import (create_train_state, make_cached_train_step,
                               make_lr_schedule)

SERVE_BATCH = 8
TRAIN_BATCH = 32
SEED = 0


def serving_img_per_s(images: torch.Tensor, iters: int = 30) -> float:
    cfg, model = predict.load_model("mobilenet_v2", None, SEED, "cuda")
    predict_fn = make_predict_fn(model, generate_anchors(cfg), cfg)
    x = images[:SERVE_BATCH]
    for _ in range(3):
        predict_fn(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        predict_fn(x)
    end.record()
    torch.cuda.synchronize()
    return SERVE_BATCH * iters * 1e3 / start.elapsed_time(end)


def train_ms_per_step(data: dict, n: int, steps: int = 10) -> float:
    cfg = get_hyper_params("mobilenet_v2")
    state = create_train_state(cfg, SEED, "cuda", make_lr_schedule(100))
    anchors = torch.from_numpy(generate_anchors(cfg)).cuda()
    step = make_cached_train_step(anchors, cfg, augment=True, seed=SEED)
    rows = torch.from_numpy(trainer.epoch_indices(
        SEED, 0, n, steps + 3, TRAIN_BATCH)).cuda()
    for i in range(3):
        step(state, data, rows[i])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(3, steps + 3):
        step(state, data, rows[i])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rounds", type=int, default=3)
    args = p.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    host, n = stage_arrays(SyntheticDataset(256, image_size=300, seed=SEED),
                           get_hyper_params("mobilenet_v2").max_gt_boxes)
    data = {k: torch.from_numpy(host[k]).cuda()
            for k in ("image", "boxes", "labels")}
    for r in range(args.rounds):
        print(json.dumps({
            "round": r,
            "serving_img_per_s_batch8": serving_img_per_s(data["image"]),
            "train_ms_per_step_batch32": train_ms_per_step(data, n),
            "card": card}), flush=True)


if __name__ == "__main__":
    main()
