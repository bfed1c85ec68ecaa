"""What every driver shares: the run's context, its outcome, the window
statistics, and the checks that the program runs the configuration as the
configuration file states it.
"""

from __future__ import annotations

import dataclasses
import gc
import math
from pathlib import Path
from typing import Dict, List

import numpy as np

# Fields of the program's SSDConfig that the configuration file states.
STATED = ("backbone", "img_size", "feature_map_shapes", "aspect_ratios",
          "scales", "scale_min", "scale_max", "variances", "iou_threshold",
          "neg_pos_ratio", "loc_loss_alpha", "total_labels",
          "nms_iou_threshold", "nms_score_threshold",
          "max_detections_per_class", "max_total_detections",
          "nms_prefilter_anchors", "force_match_for_gt", "max_gt_boxes",
          "compute_dtype", "bn_momentum")


@dataclasses.dataclass
class Context:
    """One run: the cell's files, its seed and window, whether it is
    traced, the device, the checkout's root and the host clock
    (time.perf_counter) at the process's start."""

    cell: object
    seed: int
    seconds: float
    trace: bool
    device: str
    root: Path
    started: float


@dataclasses.dataclass
class Outcome:
    correct: bool
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    checks: Dict[str, dict]
    memory_peak_bytes: int
    trace: object = None
    # seconds of the run's phases (set-up, window, the reference's check)
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)


def p95(latencies: List[float]) -> float:
    """The 95th percentile of all latencies (linear between the two
    nearest ranks, as numpy's default); a failed request is infinite."""
    x = sorted(latencies)
    if not x:
        return math.inf
    k = (len(x) - 1) * 0.95
    lo = math.floor(k)
    hi = min(lo + 1, len(x) - 1)
    if math.isinf(x[hi]):
        return math.inf if k > lo or math.isinf(x[lo]) else x[lo]
    return x[lo] + (x[hi] - x[lo]) * (k - lo)


def window_rate(items: int, seconds: float) -> float:
    """Items of all work finished in the window over the window."""
    return items / seconds if seconds > 0 else 0.0


def check_program_config(program_cfg, cfg: dict) -> None:
    """Raise where the program's configuration departs from the file's."""
    bad = [f"{key}: program {getattr(program_cfg, key)!r}, file "
           f"{cfg[key]!r}" for key in STATED
           if key in cfg and not _same(getattr(program_cfg, key), cfg[key])]
    if bad:
        raise ValueError("the program does not run the configuration as "
                         "stated: " + "; ".join(bad))


def _same(got, want) -> bool:
    if isinstance(got, (list, tuple)) or isinstance(want, (list, tuple)):
        return (isinstance(got, (list, tuple))
                and isinstance(want, (list, tuple)) and len(got) == len(want)
                and all(_same(g, w) for g, w in zip(got, want)))
    if isinstance(got, float) or isinstance(want, float):
        return (got is not None and want is not None
                and abs(float(got) - float(want)) <= 1e-12)
    return got == want


def numpy_tree(tree) -> Dict[str, np.ndarray]:
    """A tree of tensors (one device) as numpy arrays, in one copy."""
    import torch

    keys = list(tree)
    flat = torch.cat([tree[k].reshape(-1) for k in keys]).cpu().numpy()
    out, at = {}, 0
    for k in keys:
        n = tree[k].numel()
        out[k] = flat[at:at + n].reshape(tuple(tree[k].shape))
        at += n
    return out


def free(device: str) -> None:
    """Release what the program held before the reference runs."""
    import torch

    gc.collect()
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def sync_fn(device: str):
    import torch

    if device == "cpu":
        return lambda: None
    return torch.cuda.synchronize


def limits(cell) -> Dict[str, float]:
    """The cell's correctness limits: its configuration's for the
    traffic's driver, with any its traffic file adds (so that a cell added
    later can hold a number its configuration file has no limit for)."""
    kind = cell.traffic["driver"]
    return {**cell.config["limits"].get(kind, {}),
            **cell.traffic.get("limits", {})}


def judged(numbers: Dict[str, float], limits: Dict[str, float]
           ) -> Dict[str, dict]:
    """Each number with its limit (None where it is read but not held)."""
    return {k: {"value": v, "limit": limits.get(k)}
            for k, v in numbers.items()}


def passes(checks: Dict[str, dict]) -> bool:
    return all(c["limit"] is None or (
        math.isfinite(c["value"]) and c["value"] <= c["limit"])
        for c in checks.values())


def reference_dtype(cfg: dict):
    """The dtype the configuration's reference computes in."""
    import torch

    return {"float64": torch.float64,
            "float32": torch.float32}[cfg["reference_dtype"]]


class tf32:
    """Within the block cuDNN and matmuls may (or may not) use TF32."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        import torch

        self.saved = (torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = self.on
        torch.backends.cuda.matmul.allow_tf32 = self.on

    def __exit__(self, *exc):
        import torch

        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.saved
