"""Crafted inputs of the matcher: the edges where a kernel could part from
its plain version.

Each case is one set of N anchors, a batch of B images of G gt rows (label
0 = padding), an IoU threshold and the force-match switch. The CPU tests
hold the plain version against the JAX package (match_batch and the
interpreted Pallas kernel) on every case; chip_smoke.py and the card's
tests hold the kernel against the plain version on the same cases: labels
bit for bit, deltas within 1e-5.

Unless a case says otherwise the anchors are N = 961 squares of side 16
cells at every cell of a 31 x 31 grid (961 is a multiple of neither the
kernel's 128-anchor block nor the Pallas kernel's 512-anchor tile), the
threshold is 0.5 and G = 8.

  edge_dyadic_<side>    grid step 1/64 (every IoU operand exact); gts on
                        the same grid, so every anchor shifted (3, 4) cells
                        from a gt has IoU fl(156/356) with it; threshold one
                        ulp below that IoU ("above": those anchors are
                        positive), at it (negative), one ulp above
  edge_decimal_<side>   the same on a grid of step 0.01, where each
                        operation rounds; the threshold is the float32 best
                        IoU most anchors share
  ties                  exact argmax ties between real gts with different
                        labels: identical boxes, and boxes mirrored about
                        anchors' centres (the first row must win)
  holes                 label-0 rows with real boxes before real gts of the
                        same box, as augmentation leaves dropped gts in
                        place
  holes_negative        the same with threshold -0.5: anchors that overlap
                        no real gt match row 0, a hole, with its box
  degenerate            zero-height, zero-width and inverted real gts among
                        real ones
  negative_threshold    threshold -0.5 and a degenerate row 0: every anchor
                        is positive, those that overlap no real gt with row
                        0's label and zero deltas
  no_gt                 images without a real gt: zero rows, and rows with
                        boxes but label 0
  no_gt_negative        the same at threshold -0.5
  all_real_g64          all 64 rows real (the most pairs per anchor)
  g1                    G = 1, one image with its gt and one without
  g256                  G = 256, three quarters real, holes between
  n129                  N = 129 random anchors: one past a kernel block
  force_match           force_match_for_gt with a sub-threshold sliver gt
                        and a degenerate gt that may not claim
  force_match_ties      force_match_for_gt on the ties case

Everything is made with numpy from a seed; the edge thresholds are read
from the plain version's own IoU (ops/matching.py: masked_iou).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from tfssd_torch.ops.matching import masked_iou

GRID = 31    # anchor cells along each axis
SIDE = 16    # anchor and gt side, in cells
LABELS = 20  # real labels are 1..LABELS


@dataclasses.dataclass(frozen=True)
class MatchCase:
    name: str
    anchors: np.ndarray   # (N, 4) float32 corners
    boxes: np.ndarray     # (B, G, 4) float32 corners
    labels: np.ndarray    # (B, G) int32, 0 = padding
    iou_threshold: float
    force_match: bool = False


def _square(cy, cx, step: float, side: int = SIDE) -> np.ndarray:
    """Squares of `side` cells at cells (cy, cx) of a grid of `step`."""
    cy, cx = np.asarray(cy), np.asarray(cx)
    return np.stack([cy * step, cx * step, (cy + side) * step,
                     (cx + side) * step], -1).astype(np.float32)


def _grid_anchors(step: float) -> np.ndarray:
    cy, cx = np.meshgrid(np.arange(GRID), np.arange(GRID), indexing="ij")
    return _square(cy.reshape(-1), cx.reshape(-1), step)


def _grid_gts(rng, images: int, g: int, real: int, step: float):
    cells = rng.integers(0, GRID, (images, g, 2))
    boxes = _square(cells[..., 0], cells[..., 1], step)
    labels = rng.integers(1, LABELS + 1, (images, g)).astype(np.int32)
    boxes[:, real:] = 0.0
    labels[:, real:] = 0
    return boxes, labels


def random_gts(rng, images: int, g: int, real: int):
    """(images, g) gts whose first `real` rows are real: boxes of the
    synthetic data's sizes (sides 0.15-0.6) in [0, 1], labels 1..20."""
    hw = rng.uniform(0.15, 0.6, (images, g, 2))
    lo = rng.uniform(0.0, 1.0, (images, g, 2)) * (1.0 - hw)
    boxes = np.concatenate([lo, lo + hw], -1).astype(np.float32)
    labels = rng.integers(1, LABELS + 1, (images, g)).astype(np.int32)
    boxes[:, real:] = 0.0
    labels[:, real:] = 0
    return boxes, labels


def _best_ious(anchors, boxes, labels) -> np.ndarray:
    """float32 best IoU of every (image, anchor), by the plain version."""
    iou = masked_iou(torch.from_numpy(anchors), torch.from_numpy(boxes),
                     torch.from_numpy(labels))
    return iou.amax(dim=-1).numpy()


def _edge_cases(name, anchors, boxes, labels, t) -> List[MatchCase]:
    t = np.float32(t)
    sides = (("above", np.nextafter(t, np.float32(-np.inf))), ("at", t),
             ("below", np.nextafter(t, np.float32(np.inf))))
    return [MatchCase(f"{name}_{side}", anchors, boxes, labels, float(thr))
            for side, thr in sides]


def _degenerate(boxes: np.ndarray, rows) -> np.ndarray:
    """Make `rows` of every image zero-height, zero-width and inverted, in
    turn."""
    boxes = boxes.copy()
    for r, row in enumerate(rows):
        kind = r % 3
        if kind == 0:
            boxes[:, row, 2] = boxes[:, row, 0]
        elif kind == 1:
            boxes[:, row, 3] = boxes[:, row, 1]
        else:
            boxes[:, row] = boxes[:, row][:, [2, 3, 0, 1]]
    return boxes


def match_cases(images: int = 2, seed: int = 0) -> List[MatchCase]:
    """Every crafted case, each with `images` images."""
    rng = np.random.default_rng(seed)
    dyadic, decimal = _grid_anchors(1.0 / 64.0), _grid_anchors(0.01)

    # a gt has IoU fl(156/356) with every anchor shifted (3, 4) or (4, 3)
    # cells from it: inter 13*12 = 156 cells, union 2*256 - 156 = 356, and
    # every operand is exact (a multiple of 1/4096)
    boxes, labels = _grid_gts(rng, images, 8, 4, 1.0 / 64.0)
    t = np.float32(156.0) / np.float32(356.0)
    cases = _edge_cases("edge_dyadic", dyadic, boxes, labels, t)

    boxes, labels = _grid_gts(rng, images, 8, 4, 0.01)
    best = _best_ious(decimal, boxes, labels)
    values, counts = np.unique(best[(best > 0.2) & (best < 0.8)],
                               return_counts=True)
    cases += _edge_cases("edge_decimal", decimal, boxes, labels,
                         values[np.argmax(counts)])

    # ties: row 0 at cell (8, 4), row 1 mirrored 8 cells right of it (the
    # anchors at x = 8 are 4 cells from both: equal IoUs), row 2 row 0's
    # box again, then random gts; labels all different
    step = 1.0 / 64.0
    ties = np.zeros((images, 8, 4), np.float32)
    ties[:, 0] = _square(8, 4, step)
    ties[:, 1] = _square(8, 12, step)
    ties[:, 2] = ties[:, 0]
    ties[:, 3:6] = _grid_gts(rng, images, 3, 3, step)[0]
    tie_labels = np.tile(np.arange(1, 9, dtype=np.int32), (images, 1))
    tie_labels[:, 6:] = 0
    cases.append(MatchCase("ties", dyadic, ties, tie_labels, 0.5))

    # holes: rows 0, 2 and 5 are label 0 with real boxes; rows 1 and 3
    # repeat the boxes of rows 0 and 2
    boxes, labels = _grid_gts(rng, images, 8, 8, step)
    boxes[:, 1], boxes[:, 3] = boxes[:, 0], boxes[:, 2]
    labels[:, [0, 2, 5]] = 0
    cases.append(MatchCase("holes", dyadic, boxes, labels, 0.5))
    cases.append(MatchCase("holes_negative", dyadic, boxes, labels, -0.5))

    boxes, labels = _grid_gts(rng, images, 8, 8, step)
    boxes = _degenerate(boxes, (1, 3, 5, 6))
    cases.append(MatchCase("degenerate", dyadic, boxes, labels, 0.5))
    cases.append(MatchCase("negative_threshold", dyadic,
                           _degenerate(boxes, (0,)), labels, -0.5))

    boxes, labels = _grid_gts(rng, images, 8, 8, step)
    boxes[0] = 0.0
    labels[:] = 0
    cases.append(MatchCase("no_gt", dyadic, boxes, labels, 0.5))
    cases.append(MatchCase("no_gt_negative", dyadic, boxes, labels, -0.5))

    anchors = rng.uniform(0.0, 0.5, (GRID * GRID, 2))
    sides = rng.uniform(0.05, 0.5, (GRID * GRID, 2))
    rand_anchors = np.clip(np.concatenate([anchors, anchors + sides], -1),
                           0.0, 1.0).astype(np.float32)
    boxes, labels = random_gts(rng, images, 64, 64)
    cases.append(MatchCase("all_real_g64", rand_anchors, boxes, labels, 0.5))

    boxes, labels = _grid_gts(rng, images, 1, 1, step)
    labels[1:] = 0
    cases.append(MatchCase("g1", dyadic, boxes, labels, 0.5))

    boxes, labels = random_gts(rng, images, 256, 256)
    labels[rng.uniform(size=labels.shape) < 0.25] = 0
    cases.append(MatchCase("g256", rand_anchors, boxes, labels, 0.5))

    boxes, labels = random_gts(rng, images, 8, 5)
    cases.append(MatchCase("n129", np.ascontiguousarray(rand_anchors[:129]),
                           boxes, labels, 0.5))

    # a sliver gt below every anchor's threshold, claimed only by force,
    # and a zero-height gt that overlaps nothing and may not claim
    boxes, labels = _grid_gts(rng, images, 8, 6, step)
    boxes[:, 0] = np.asarray([0.41, 0.41, 0.435, 0.435], np.float32)
    boxes = _degenerate(boxes, (4,))
    cases.append(MatchCase("force_match", dyadic, boxes, labels, 0.5, True))
    cases.append(MatchCase("force_match_ties", dyadic, ties, tie_labels,
                           0.5, True))
    return cases
