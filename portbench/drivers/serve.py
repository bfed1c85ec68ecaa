"""Serving traffic: a closed loop of one client. The traffic file gives
`batch` (images a request), `pool` (distinct images, a multiple of the
batch), `warmup_requests`, `profile_requests` (the traced stretch),
`keep_share` and `keep_slots` (the share of requests, drawn from the seed,
whose replies the client keeps for the check, in at most that many slots
made at set-up), `check_requests` (how many of the kept the reference
judges, drawn from the seed) and `check_chunk` (images the reference runs
at once).

Set-up: the weights (the configuration's `serve_weights`: a checkpoint
step read by portbench/ckpt, or "seeded" from the seed on the device),
the program's model through tfssd_torch.predict.load_model (BatchNorm
folded as the configuration states) and its predict through
tfssd_torch.models.decoder.make_predict_fn; the pool of synthetic scenes
from the seed, in a seeded order, in pinned host memory; the requests'
shape warmed up. A request copies its `batch` images to the card, runs
the program's predict and brings the NMSResult back to the host; the next
is sent when the reply is in, until the window's seconds are up. No
request allocates host memory (Client).

The reference (portbench/reference) then judges the sampled requests'
NMSResults on the same images and weights: det_gap and sel_gap
(reference/detect.py), each the worst over the sampled requests.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import data, harness
from portbench import trace as tracing
from portbench.ckpt import orbax
from portbench.reference import detect, ssd

Served = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def load_weights(ctx: harness.Context, cfg: dict) -> Dict[str, np.ndarray]:
    if cfg["serve_weights"] == "seeded":
        return harness.numpy_tree(ssd.seeded_weights(cfg, ctx.seed,
                                                     ctx.device))
    return orbax.read_weights(str(ctx.root / cfg["serve_weights"]))


def image_pool(ctx: harness.Context, cfg: dict, traffic: dict
               ) -> torch.Tensor:
    """The pool's images in the seeded order of the requests, pinned."""
    if traffic["pool"] % traffic["batch"]:
        raise ValueError("the pool must be a multiple of the batch")
    images = data.synthetic(traffic["pool"], cfg["img_size"],
                            ctx.seed)["image"]
    order = np.random.default_rng([ctx.seed, 1]).permutation(len(images))
    pool = torch.from_numpy(images[order])
    return pool.pin_memory() if ctx.device != "cpu" else pool


def request_images(pool: torch.Tensor, batch: int, i: int) -> torch.Tensor:
    at = (i * batch) % len(pool)
    return pool[at:at + batch]


class Client:
    """One client's requests: images (host) -> the NMSResult on the host,
    copied into pinned memory made at the first request, so that no
    request allocates host memory: a reply the check may read goes to one
    of `slots` kept slots, every other reply to one scratch slot that the
    next request overwrites."""

    def __init__(self, predict, device: str, slots: int):
        self.predict, self.device, self.slots = predict, device, slots
        self.scratch: List[torch.Tensor] = []
        self.kept: List[torch.Tensor] = []
        self.used = 0

    def _allocate(self, res) -> None:
        pin = self.device != "cpu"
        self.scratch = [torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                        for t in res]
        self.kept = [torch.empty((self.slots,) + tuple(t.shape),
                                 dtype=t.dtype, pin_memory=pin) for t in res]

    def __call__(self, x: torch.Tensor, keep: bool):
        """The reply where it is kept (keep, and a slot left), else None."""
        res = self.predict(x.to(self.device, non_blocking=True))
        if not self.scratch:
            self._allocate(res)
        keep = keep and self.used < self.slots
        dst = ([k[self.used] for k in self.kept] if keep
               else self.scratch)
        for d, t in zip(dst, res):
            d.copy_(t, non_blocking=True)
        if self.device != "cpu":
            torch.cuda.current_stream().synchronize()
        if not keep:
            return None
        self.used += 1
        return tuple(dst)


def kept_requests(ctx: harness.Context, traffic: dict) -> np.ndarray:
    """Which request indices keep their reply for the check: each with
    probability `keep_share`, drawn from the seed, for the first 2**20."""
    rng = np.random.default_rng([ctx.seed, 3])
    return rng.random(2 ** 20) < traffic["keep_share"]


def run(ctx: harness.Context) -> harness.Outcome:
    from tfssd_torch import predict as port_predict
    from tfssd_torch.models.decoder import make_predict_fn
    from tfssd_torch.ops.boxes import generate_anchors

    cfg, traffic = ctx.cell.config, ctx.cell.traffic
    batch = traffic["batch"]
    tree = load_weights(ctx, cfg)
    ssd.check_tree(cfg, tree)
    program_cfg, model = port_predict.load_model(
        cfg["port_backbone"], tree, 0, ctx.device, fold_bn=cfg["fold_bn"])
    harness.check_program_config(program_cfg, cfg)
    predict = make_predict_fn(model, generate_anchors(program_cfg),
                              program_cfg)
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

    flops = ssd.model_flops(cfg, train=False)
    shapes = {"keep_r": batch * (cfg["total_labels"] - 1),
              "keep_k": cfg["max_detections_per_class"]}
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


def sample(ctx: harness.Context, traffic: dict, count: int) -> List[int]:
    """Positions of the requests the reference judges, from the seed."""
    k = min(traffic["check_requests"], count)
    rng = np.random.default_rng([ctx.seed, 2])
    return sorted(rng.choice(count, size=k, replace=False).tolist())


def reference_outputs(cfg: dict, tree_t: Dict[str, torch.Tensor],
                      images: torch.Tensor, chunk: int, dtype,
                      allow_tf32: bool):
    """The reference's decode (boxes, scores) and NMS of `images` (on the
    reference's device), computed `chunk` images at a time."""
    anchors_t = torch.from_numpy(ssd.anchors(cfg)).to(images.device)
    parts = []
    with torch.no_grad(), harness.tf32(allow_tf32):
        for at in range(0, len(images), chunk):
            x = ssd.preprocess(images[at:at + chunk], dtype)
            deltas, logits = ssd.forward(cfg, tree_t, x)
            boxes, scores = ssd.decode(cfg, anchors_t, deltas, logits)
            parts.append((boxes, scores, detect.combined_nms(cfg, boxes,
                                                             scores)))
    boxes = torch.cat([p[0] for p in parts])
    scores = torch.cat([p[1] for p in parts])
    nms = {k: torch.cat([p[2][k] for p in parts]) for k in parts[0][2]}
    return boxes, scores, nms


def check(ctx: harness.Context, cfg: dict, traffic: dict, tree,
          pool: torch.Tensor, served: List[Tuple[int, Served]],
          control: bool = False) -> Dict[str, float]:
    """The worst det_gap and sel_gap over the sampled requests. With
    `control`, the program's replies are replaced by the reference's own
    in the control's lower precision (float32 with TF32), judged alike."""
    dtype = harness.reference_dtype(cfg)
    tree_t = {k: torch.as_tensor(np.asarray(v)).to(ctx.device, dtype)
              for k, v in tree.items()}
    worst: Dict[str, float] = {}
    batch = traffic["batch"]
    positions = sample(ctx, traffic, len(served))
    if not positions:  # nothing kept to judge: not a correct run
        return {"det_gap": float("inf"), "sel_gap": float("inf")}
    for pos in positions:
        i, out = served[pos]
        images = request_images(pool, batch, i).to(ctx.device)
        boxes, scores, nms = reference_outputs(
            cfg, tree_t, images, traffic["check_chunk"], dtype, False)
        if control:
            low = {k: v.to(torch.float32) for k, v in tree_t.items()}
            _, _, cn = reference_outputs(cfg, low, images,
                                         traffic["check_chunk"],
                                         torch.float32, True)
            out = (cn["boxes"], cn["scores"], cn["classes"], cn["valid"])
        got = tuple(t.to(ctx.device) for t in out)
        if (got[0].shape != nms["boxes"].shape
                or got[1].shape != nms["scores"].shape):
            numbers = {"det_gap": float("inf"), "sel_gap": float("inf")}
        else:
            numbers = detect.judge(cfg, boxes, scores, got)
        for k, v in numbers.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst
