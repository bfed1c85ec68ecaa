"""Serving traffic of Mask R-CNN: the closed loop of one client of
drivers/serve.py (its Client, kept requests, request images and sample,
used unchanged), with Mask R-CNN's frames, weights, reference and
comparison (reference/maskrcnn.py). The traffic file gives serve.py's
parameters.

Set-up: the seeded weights (reference/maskrcnn.py:seeded_weights, on the
device), the program's model through tfssd_torch.predict.load_model
(BatchNorm folded as the configuration states) and its predict through
tfssd_torch.models.decoder.make_predict_fn; each field the configuration
file states (STATED) checked against the program's configuration, and the
anchors' count; the pool of synthetic frames (reference/maskrcnn.py:
frames) in a seeded order, pinned; the requests' shape warmed up. The
window and the traced stretch are serve.py's; the traced stretch hands
roi_align_roofline the two RoIAlign calls of a request (`roi_align`: boxes,
channels and side of each). The reference then judges the sampled
requests: rpn_det_gap, rpn_sel_gap, det_gap, sel_gap and mask_gap
(reference/maskrcnn.py:judge), each the worst over them; and `unfilled`,
the share of the warm-up requests' images that do not fill their
proposals and detections (the FLOPs are counted at those caps, so the
work counted is the work done only where it is 0).

The control, the reference itself in float32 with TF32 in the program's
place:

    python3 -m portbench.drivers.serve_maskrcnn --workload <cell> \
        --control-seeds 7 8 9
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import harness
from portbench import trace as tracing
from portbench.drivers.serve import (Client, kept_requests, request_images,
                                     sample)
from portbench.reference import maskrcnn

# Fields of the program's MaskRCNNConfig that the configuration file
# states.
STATED = ("backbone", "image_size", "padded_size", "feature_map_shapes",
          "anchor_sizes", "anchor_ratios", "size_divisible", "num_classes",
          "stem_channels", "groups", "stage_blocks", "stage_widths",
          "stage_channels", "fpn_channels", "image_mean", "image_std",
          "bn_eps", "box_clamp", "rpn_box_weights", "rpn_pre_nms_top_n",
          "rpn_post_nms_top_n", "rpn_nms_iou_threshold",
          "rpn_score_threshold", "rpn_min_size", "roi_levels",
          "roi_canonical_scale", "roi_canonical_level",
          "roi_sampling_ratio", "box_roi_size", "mask_roi_size",
          "representation_size", "box_weights", "box_score_threshold",
          "box_min_size", "box_nms_iou_threshold", "box_detections_per_img",
          "mask_layers", "compute_dtype")
NUMBERS = ("rpn_det_gap", "rpn_sel_gap", "det_gap", "sel_gap", "mask_gap")

Reply = Tuple[torch.Tensor, ...]


def check_program_config(program_cfg, cfg: dict) -> None:
    """Raise where the program's configuration departs from the file's,
    or the file does not state a field of STATED."""
    missing = [k for k in STATED if k not in cfg]
    bad = [f"{k}: program {getattr(program_cfg, k, None)!r}, file "
           f"{cfg[k]!r}" for k in STATED if k in cfg and not harness._same(
               getattr(program_cfg, k, None), cfg[k])]
    if missing or bad:
        raise ValueError("the program does not run the configuration as "
                         f"stated: missing {missing}; " + "; ".join(bad))


def load_weights(ctx: harness.Context, cfg: dict) -> Dict[str, np.ndarray]:
    if cfg["serve_weights"] != "seeded":
        raise ValueError("Mask R-CNN serves seeded weights only")
    return harness.numpy_tree(maskrcnn.seeded_weights(cfg, ctx.seed,
                                                      ctx.device))


def frame_pool(ctx: harness.Context, cfg: dict, traffic: dict
               ) -> torch.Tensor:
    """The pool's frames in the seeded order of the requests, pinned."""
    if traffic["pool"] % traffic["batch"]:
        raise ValueError("the pool must be a multiple of the batch")
    frames = maskrcnn.frames(cfg, traffic["pool"], ctx.seed)
    order = np.random.default_rng([ctx.seed, 1]).permutation(len(frames))
    pool = frames[torch.from_numpy(order)]
    return pool.pin_memory() if ctx.device != "cpu" else pool


def unfilled(cfg: dict, reply: Reply) -> int:
    """The images of `reply` (on the host) short of their caps of
    proposals or detections."""
    valid, count = reply[3], reply[7]
    return int(((valid < cfg["box_detections_per_img"])
                | (count < cfg["rpn_post_nms_top_n"])).sum())


def run(ctx: harness.Context) -> harness.Outcome:
    from tfssd_torch import predict as port_predict
    from tfssd_torch.models.decoder import make_predict_fn
    from tfssd_torch.ops.boxes import generate_anchors

    cfg, traffic = ctx.cell.config, ctx.cell.traffic
    batch = traffic["batch"]
    tree = load_weights(ctx, cfg)
    maskrcnn.check_tree(cfg, tree)
    program_cfg, model = port_predict.load_model(
        cfg["port_backbone"], tree, 0, ctx.device, fold_bn=cfg["fold_bn"])
    check_program_config(program_cfg, cfg)
    anchors = generate_anchors(program_cfg)
    if len(anchors) != cfg["anchors"]:
        raise ValueError(f"the program has {len(anchors)} anchors, the "
                         f"configuration states {cfg['anchors']}")
    predict = make_predict_fn(model, anchors, program_cfg)
    pool = frame_pool(ctx, cfg, traffic)
    keep = kept_requests(ctx, traffic)
    request = Client(predict, ctx.device, traffic["keep_slots"])
    short = 0
    for i in range(traffic["warmup_requests"]):
        request(request_images(pool, batch, i), False)
        short += unfilled(cfg, request.scratch)
    sync = harness.sync_fn(ctx.device)
    sync()

    served: List[Tuple[int, Reply]] = []
    latencies: List[float] = []
    failed = done = 0
    t_window = time.perf_counter()
    setup_s = t_window - ctx.started
    i = 0
    while True:
        t0 = time.perf_counter()
        if t0 - t_window >= ctx.seconds:
            break
        try:
            out = request(request_images(pool, batch, i), keep[i])
        except RuntimeError:
            failed += 1
            latencies.append(float("inf"))
        else:
            latencies.append(time.perf_counter() - t0)
            done += 1
            if out is not None:
                served.append((i, out))
        i += 1
    window_s = time.perf_counter() - t_window
    timings = {"setup_s": setup_s, "window_s": window_s,
               "latency_ms_p50_p90_p99": [1e3 * float(np.percentile(
                   latencies, q)) for q in (50, 90, 99)]}
    e2e = {"serve_img_per_s": harness.window_rate(done * batch, window_s),
           "serve_ms_p95": 1e3 * harness.p95(latencies),
           "setup_s": setup_s}

    flops = maskrcnn.model_flops(cfg)
    c = cfg["fpn_channels"]
    shapes = {"batch": batch, "roi_align": [
        [batch * cfg["rpn_post_nms_top_n"], c, cfg["box_roi_size"]],
        [batch * cfg["box_detections_per_img"], c, cfg["mask_roi_size"]]]}
    trace = None
    if ctx.trace:
        n = traffic["profile_requests"]

        def one(j: int) -> None:
            out = request(request_images(pool, batch, i + j), keep[i + j])
            if out is not None:
                served.append((i + j, out))

        if ctx.device == "cpu":
            for j in range(n):
                one(j)
            trace = tracing.empty("serve", e2e["serve_img_per_s"], flops,
                                  shapes)
        else:
            prof, profiled_s = tracing.profile(one, n, sync)
            trace = tracing.reduce(prof, "serve", n, profiled_s,
                                   e2e["serve_img_per_s"], flops, shapes)
            del prof
    peak = (torch.cuda.max_memory_allocated() if ctx.device != "cpu"
            else 0)
    del predict, request, model
    harness.free(ctx.device)

    t_check = time.perf_counter()
    numbers = check(ctx, cfg, traffic, tree, pool, served)
    numbers["unfilled"] = short / (traffic["warmup_requests"] * batch)
    timings["reference_s"] = time.perf_counter() - t_check
    checks = harness.judged(numbers, harness.limits(ctx.cell))
    return harness.Outcome(
        correct=harness.passes(checks) and failed == 0 and done > 0,
        attempted=i, failed=failed, end_to_end=e2e, checks=checks,
        memory_peak_bytes=peak, trace=trace, timings=timings)


def check(ctx: harness.Context, cfg: dict, traffic: dict, tree,
          pool: torch.Tensor, served: List[Tuple[int, Reply]],
          control: bool = False) -> Dict[str, float]:
    """The worst of each number over the sampled requests, the reference
    judging `check_chunk` images at a time. With `control`, the program's
    replies are replaced by the reference's own predict
    (reference/maskrcnn.py:predict) in float32 with TF32, judged alike."""
    dtype = harness.reference_dtype(cfg)
    tree_t = {k: torch.as_tensor(np.asarray(v)).to(ctx.device, dtype)
              for k, v in tree.items()}
    low = {k: v.to(torch.float32) for k, v in tree_t.items()}
    worst: Dict[str, float] = {}
    batch, chunk = traffic["batch"], traffic["check_chunk"]
    positions = sample(ctx, traffic, len(served))
    if not positions:  # nothing kept to judge: not a correct run
        return {k: math.inf for k in NUMBERS}
    for pos in positions:
        i, out = served[pos]
        images = request_images(pool, batch, i).to(ctx.device)
        for at in range(0, batch, chunk):
            x = images[at:at + chunk]
            if control:
                with torch.no_grad(), harness.tf32(True):
                    got = maskrcnn.predict(cfg, low, x, torch.float32)
            else:
                got = tuple(t[at:at + chunk].to(ctx.device) for t in out)
            if len(got) != 8 or any(len(t) != len(x) for t in got):
                numbers = {k: math.inf for k in NUMBERS}
            else:
                with torch.no_grad(), harness.tf32(False):
                    numbers = maskrcnn.judge(cfg, tree_t, x, got)
            for k, v in numbers.items():
                worst[k] = max(worst.get(k, 0.0), v)
    return worst


def control_readings(cell, seed: int, root: Path) -> Dict[str, float]:
    """The control's numbers for `seed`: the inputs of a run of that seed,
    every request of the pool a candidate for the sample."""
    ctx = harness.Context(cell=cell, seed=seed, seconds=0.0, trace=False,
                          device="cuda", root=root,
                          started=time.perf_counter())
    cfg, traffic = cell.config, cell.traffic
    tree = load_weights(ctx, cfg)
    pool = frame_pool(ctx, cfg, traffic)
    n = len(pool) // traffic["batch"]
    return check(ctx, cfg, traffic, tree, pool,
                 [(i, None) for i in range(n)], control=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="python3 -m portbench.drivers.serve_maskrcnn")
    p.add_argument("--workload", required=True)
    p.add_argument("--control-seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    from portbench import cells
    from portbench.run import ROOT, set_cache_dirs

    set_cache_dirs(ROOT)
    cell = cells.find_cell(args.workload, ROOT)
    got: Dict[str, list] = {}
    for s in args.control_seeds:
        t0 = time.perf_counter()
        r = control_readings(cell, s, ROOT)
        print(json.dumps({"workload": cell.name, "kind": "control",
                          "seed": s, "readings": r,
                          "seconds": time.perf_counter() - t0}), flush=True)
        for k, v in r.items():
            got.setdefault(k, []).append(v)
    print(json.dumps({"workload": cell.name,
                      "upper": {k: min(v) for k, v in got.items()},
                      "card": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
