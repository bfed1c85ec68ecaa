"""Inputs made from the seed: synthetic detection scenes and the shuffled
epoch order, frozen copies of the program's generators (tfssd_torch/data/
synthetic.py:SyntheticDataset, tfssd_torch/trainer.py:epoch_indices), so
that a later change to the program cannot change what the benchmark feeds
it. A seed gives byte-equal images, boxes and labels to the program's
SyntheticDataset(n, size, seed=seed).

Each scene: uniform noise in [0, 80) as background, 1..6 axis-aligned
filled rectangles whose colour gives the label (20 classes), boxes the
exact rectangle extents, normalised; a later rectangle may overdraw an
earlier one whose box is kept.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import numpy as np

PALETTE = np.asarray(
    [[220, 30, 30], [30, 220, 30], [30, 30, 220], [220, 220, 30],
     [220, 30, 220], [30, 220, 220], [240, 140, 20], [140, 20, 240],
     [20, 240, 140], [120, 120, 120], [240, 240, 240], [90, 40, 10],
     [10, 90, 40], [40, 10, 90], [200, 100, 100], [100, 200, 100],
     [100, 100, 200], [60, 60, 0], [0, 60, 60], [60, 0, 60]], np.uint8)
MAX_OBJECTS = 6
NUM_CLASSES = 20


def _scene(out: Dict[str, np.ndarray], seed: int, index: int) -> None:
    rng = np.random.default_rng(seed * 1_000_003 + index)
    s = out["image"].shape[1]
    img = out["image"][index]
    img[...] = rng.integers(0, 80, (s, s, 3), dtype=np.uint8)
    n = int(rng.integers(1, MAX_OBJECTS + 1))
    for j in range(n):
        h = rng.uniform(0.15, 0.6)
        w = rng.uniform(0.15, 0.6)
        y0 = rng.uniform(0.0, 1.0 - h)
        x0 = rng.uniform(0.0, 1.0 - w)
        cls = int(rng.integers(0, NUM_CLASSES))
        py0, px0 = int(y0 * s), int(x0 * s)
        py1, px1 = int((y0 + h) * s), int((x0 + w) * s)
        img[py0:py1, px0:px1] = PALETTE[cls]
        out["boxes"][index, j] = (py0 / s, px0 / s, py1 / s, px1 / s)
        out["labels"][index, j] = cls + 1


def synthetic(n: int, size: int, seed: int, max_gt: int = 64,
              threads: int = 4) -> Dict[str, np.ndarray]:
    """n scenes: {'image' (n, size, size, 3) uint8, 'boxes' (n, max_gt, 4)
    float32 and 'labels' (n, max_gt) int32, zero rows after the objects}."""
    out = {"image": np.empty((n, size, size, 3), np.uint8),
           "boxes": np.zeros((n, max_gt, 4), np.float32),
           "labels": np.zeros((n, max_gt), np.int32)}
    with ThreadPoolExecutor(threads) as pool:
        for f in [pool.submit(_scene, out, seed, i) for i in range(n)]:
            f.result()
    return out


def epoch_indices(seed: int, epoch: int, n: int, steps: int,
                  batch: int) -> np.ndarray:
    """(steps, batch) rows of epoch `epoch`: fresh permutations of [0, n)
    concatenated until the epoch's steps are covered."""
    need = steps * batch
    rng = np.random.default_rng(seed * 10_000 + epoch)
    idx = np.concatenate([rng.permutation(n)
                          for _ in range(-(-need // n))])[:need]
    return idx.reshape(steps, batch)
