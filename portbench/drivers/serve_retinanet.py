"""Serving traffic of RetinaNet: the closed loop of one client of
drivers/serve.py (its image pool, Client, kept requests and sample, used
unchanged), with RetinaNet's weights, reference and comparison
(reference/retinanet.py). The traffic file gives serve.py's parameters.

Set-up: the seeded weights (reference/retinanet.py:seeded_weights, on the
device), the program's model through tfssd_torch.predict.load_model
(BatchNorm folded as the configuration states) and its predict through
tfssd_torch.models.decoder.make_predict_fn; each field the configuration
file states (STATED) checked against the program's configuration, and the
anchors' count; the pool pinned; the requests' shape warmed up. The window
and the traced stretch are serve.py's. The reference then judges the
sampled requests: det_gap and sel_gap (reference/retinanet.py:judge), each
the worst over them.

The control, the reference itself in float32 with TF32 in the program's
place (calibrate.py reads it only for the `serve` driver):

    python3 -m portbench.drivers.serve_retinanet --workload <cell> \
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
from portbench.drivers.serve import (Client, Served, image_pool,
                                     kept_requests, request_images, sample)
from portbench.reference import retinanet

# Fields of the program's RetinaNetConfig that the configuration file
# states.
STATED = ("backbone", "img_size", "feature_map_shapes", "anchor_sizes",
          "anchor_ratios", "num_classes", "stem_channels", "groups",
          "stage_blocks", "stage_widths", "stage_channels", "fpn_channels",
          "head_convs", "image_mean", "image_std", "bn_eps", "box_weights",
          "box_clamp", "score_threshold", "topk_candidates",
          "nms_iou_threshold", "max_total_detections", "compute_dtype")


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
        raise ValueError("RetinaNet serves seeded weights only")
    return harness.numpy_tree(retinanet.seeded_weights(cfg, ctx.seed,
                                                       ctx.device))


def run(ctx: harness.Context) -> harness.Outcome:
    from tfssd_torch import predict as port_predict
    from tfssd_torch.models.decoder import make_predict_fn
    from tfssd_torch.ops.boxes import generate_anchors

    cfg, traffic = ctx.cell.config, ctx.cell.traffic
    batch = traffic["batch"]
    tree = load_weights(ctx, cfg)
    retinanet.check_tree(cfg, tree)
    program_cfg, model = port_predict.load_model(
        cfg["port_backbone"], tree, 0, ctx.device, fold_bn=cfg["fold_bn"])
    check_program_config(program_cfg, cfg)
    anchors = generate_anchors(program_cfg)
    if len(anchors) != cfg["anchors"]:
        raise ValueError(f"the program has {len(anchors)} anchors, the "
                         f"configuration states {cfg['anchors']}")
    predict = make_predict_fn(model, anchors, program_cfg)
    pool = image_pool(ctx, cfg, traffic)
    keep = kept_requests(ctx, traffic)
    request = Client(predict, ctx.device, traffic["keep_slots"])
    for i in range(traffic["warmup_requests"]):
        request(request_images(pool, batch, i), False)
    sync = harness.sync_fn(ctx.device)
    sync()

    served: List[Tuple[int, Served]] = []
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

    flops = retinanet.model_flops(cfg)
    shapes = {"batch": batch}
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
    timings["reference_s"] = time.perf_counter() - t_check
    checks = harness.judged(numbers, harness.limits(ctx.cell))
    return harness.Outcome(
        correct=harness.passes(checks) and failed == 0 and done > 0,
        attempted=i, failed=failed, end_to_end=e2e, checks=checks,
        memory_peak_bytes=peak, trace=trace, timings=timings)


def check(ctx: harness.Context, cfg: dict, traffic: dict, tree,
          pool: torch.Tensor, served: List[Tuple[int, Served]],
          control: bool = False) -> Dict[str, float]:
    """The worst det_gap and sel_gap over the sampled requests, the
    reference computing `check_chunk` images at a time. With `control`,
    the program's replies are replaced by the reference's own selection
    and NMS (reference/retinanet.py:postprocess) in float32 with TF32,
    judged alike."""
    dtype = harness.reference_dtype(cfg)
    tree_t = {k: torch.as_tensor(np.asarray(v)).to(ctx.device, dtype)
              for k, v in tree.items()}
    low = {k: v.to(torch.float32) for k, v in tree_t.items()}
    anchors_t = torch.from_numpy(retinanet.anchors(cfg)).to(ctx.device)
    worst: Dict[str, float] = {}
    batch, chunk = traffic["batch"], traffic["check_chunk"]
    total = cfg["max_total_detections"]
    positions = sample(ctx, traffic, len(served))
    if not positions:  # nothing kept to judge: not a correct run
        return {"det_gap": math.inf, "sel_gap": math.inf}
    for pos in positions:
        i, out = served[pos]
        images = request_images(pool, batch, i).to(ctx.device)
        for at in range(0, batch, chunk):
            x = images[at:at + chunk]
            with torch.no_grad(), harness.tf32(False):
                deltas, logits = retinanet.forward(
                    cfg, tree_t, retinanet.preprocess(cfg, x, dtype))
            if control:
                with torch.no_grad(), harness.tf32(True):
                    d32, l32 = retinanet.forward(
                        cfg, low, retinanet.preprocess(cfg, x,
                                                       torch.float32))
                    got = retinanet.postprocess(cfg, anchors_t, d32, l32)
                got = (got["boxes"], got["scores"], got["classes"],
                       got["valid"])
            else:
                got = tuple(t[at:at + chunk].to(ctx.device) for t in out)
            if (tuple(got[0].shape) != (len(x), total, 4)
                    or tuple(got[1].shape) != (len(x), total)):
                numbers = {"det_gap": math.inf, "sel_gap": math.inf}
            else:
                numbers = retinanet.judge(cfg, anchors_t, deltas, logits,
                                          got)
            del deltas, logits
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
    pool = image_pool(ctx, cfg, traffic)
    n = len(pool) // traffic["batch"]
    return check(ctx, cfg, traffic, tree, pool,
                 [(i, None) for i in range(n)], control=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="python3 -m portbench.drivers.serve_retinanet")
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
