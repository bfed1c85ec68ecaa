"""Crafted inputs of the NMS keep mask: the edges where a kernel could part
from its plain version.

Each case is a batch of R (image, class) instances of K score-sorted
candidates with its two thresholds. The CPU tests hold the plain version
against the JAX package on every case; chip_smoke.py and the card's tests
hold the kernel against the plain version, bit for bit, on the same cases.

  k<K>                  random overlapping boxes for K in EDGE_KS: one, a
                        ragged and a full last 32-wide block, 256
  edge_dyadic_<side>    boxes on a 1/64 grid (every IoU operand exact), the
                        IoU threshold at the float32 IoU of a shift that
                        many pairs share: one ulp below it ("above": those
                        pairs suppress), at it (they do not), one ulp above
  edge_decimal_<side>   the same on a grid of step 0.01, where each
                        operation rounds; the threshold is the float32 IoU
                        most pairs share
  identical             all boxes the same: only the first is kept, the
                        longest chain of suppressions
  below_score           every score at or below the score threshold
  neg_inf_scores        -inf scores at the tail and inside, score threshold
                        0.05 and -inf
  degenerate_<thr>      zero-area and inverted boxes among real ones, IoU
                        threshold 0.45, 0 and -0.5 (0 > threshold: pairs
                        that do not intersect suppress too)
  equal_scores          every score the same

Everything is made with numpy from a seed; the edge thresholds are read
from the plain version's own IoU (ops/boxes.py: iou_matrix).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from tfssd_torch.ops.boxes import iou_matrix

EDGE_KS = (1, 31, 32, 33, 63, 64, 65, 130, 200, 255, 256)


@dataclasses.dataclass(frozen=True)
class KeepCase:
    name: str
    boxes: np.ndarray       # (R, K, 4) float32 corners
    scores: np.ndarray      # (R, K) float32
    iou_threshold: float
    score_threshold: float


def _sorted_scores(rng, r: int, k: int) -> np.ndarray:
    s = np.sort(rng.uniform(0.0, 1.0, (r, k)), axis=-1)[:, ::-1]
    return np.ascontiguousarray(s, dtype=np.float32)


def _random_boxes(rng, r: int, k: int, spread: float = 0.5) -> np.ndarray:
    centers = rng.uniform(0.5 - spread / 2, 0.5 + spread / 2, (r, k, 2))
    sizes = rng.uniform(0.05, 0.4, (r, k, 2))
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], -1)
    return np.clip(boxes, 0.0, 1.0).astype(np.float32)


def _grid_boxes(rng, r: int, k: int, step: float, size: int) -> np.ndarray:
    """Square boxes of side size*step at random multiples of step."""
    cells = rng.integers(0, 24, (r, k, 2))
    lo = (cells * step).astype(np.float32)
    hi = ((cells + size) * step).astype(np.float32)
    return np.concatenate([lo, hi], -1)


def _pair_ious(boxes: np.ndarray) -> np.ndarray:
    """float32 IoU of every pair i < j, by the plain version's iou_matrix."""
    t = torch.from_numpy(boxes)
    rows, cols = np.triu_indices(boxes.shape[1], 1)
    return iou_matrix(t, t).numpy()[:, rows, cols]


def _edge_cases(name: str, boxes, scores, t: float) -> List[KeepCase]:
    t = np.float32(t)
    sides = (("above", np.nextafter(t, np.float32(-np.inf))), ("at", t),
             ("below", np.nextafter(t, np.float32(np.inf))))
    return [KeepCase(f"{name}_{side}", boxes, scores, float(thr), 0.05)
            for side, thr in sides]


def keep_cases(instances: int = 4, seed: int = 0) -> List[KeepCase]:
    """Every crafted case, each with `instances` instances."""
    rng = np.random.default_rng(seed)
    r = instances
    cases = [KeepCase(f"k{k}", _random_boxes(rng, r, k),
                      _sorted_scores(rng, r, k), 0.45, 0.05)
             for k in EDGE_KS]

    # 1/64 grid, side 16/64: a shift of (3, 4) cells gives inter 156/4096
    # and union 356/4096, both exact, so every such pair has IoU
    # fl(156/356) in every implementation.
    k = 200
    dyadic = _grid_boxes(rng, r, k, 1.0 / 64.0, 16)
    t = np.float32(156.0) / np.float32(356.0)
    cases += _edge_cases("edge_dyadic", dyadic, _sorted_scores(rng, r, k), t)

    decimal = _grid_boxes(rng, r, k, 0.01, 16)
    ious = _pair_ious(decimal)
    values, counts = np.unique(ious[(ious > 0.2) & (ious < 0.8)],
                               return_counts=True)
    t = values[np.argmax(counts)]
    cases += _edge_cases("edge_decimal", decimal, _sorted_scores(rng, r, k),
                         t)

    same = np.broadcast_to(np.asarray([0.2, 0.3, 0.6, 0.7], np.float32),
                           (r, k, 4)).copy()
    cases.append(KeepCase("identical", same, _sorted_scores(rng, r, k),
                          0.45, 0.05))

    below = _sorted_scores(rng, r, k) * np.float32(0.3)
    below[:, : k // 2] = np.float32(0.3)
    cases.append(KeepCase("below_score", _random_boxes(rng, r, k),
                          np.ascontiguousarray(below), 0.45, 0.3))

    inf = _sorted_scores(rng, r, k)
    inf[:, -40:] = -np.inf
    inf[:, 50:60] = -np.inf
    boxes = _random_boxes(rng, r, k)
    for thr in (0.05, -np.inf):
        cases.append(KeepCase(f"neg_inf_scores_{thr}", boxes, inf, 0.45,
                              float(thr)))

    degenerate = _random_boxes(rng, r, k)
    pick = rng.integers(0, 4, (r, k))
    degenerate[..., 2] = np.where(pick == 1, degenerate[..., 0],
                                  degenerate[..., 2])      # zero height
    degenerate[..., 3] = np.where(pick == 2, degenerate[..., 1],
                                  degenerate[..., 3])      # zero width
    inverted = pick == 3
    degenerate[inverted] = degenerate[inverted][:, [2, 3, 0, 1]]
    scores = _sorted_scores(rng, r, k)
    for thr in (0.45, 0.0, -0.5):
        cases.append(KeepCase(f"degenerate_{thr}", degenerate, scores, thr,
                              0.05))

    cases.append(KeepCase("equal_scores", _random_boxes(rng, r, k),
                          np.full((r, k), 0.5, np.float32), 0.45, 0.05))
    return cases
