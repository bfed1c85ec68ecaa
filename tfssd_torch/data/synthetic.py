"""Synthetic detection dataset — colored rectangles on textured noise.

A numpy copy of the JAX package's data/synthetic.py: the same generator,
so a seed gives byte-equal images, boxes and labels in both packages.

Each scene: uniform-noise background, 1..max_objects axis-aligned filled
rectangles; the label is the rectangle's color bin (class == dominant
color), boxes are the exact rectangle extents. Rectangles are painted in
order without overlap handling, so a later one can overdraw an earlier
one whose gt box and label are kept (occlusion noise, deliberate).
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

_PALETTE = np.asarray(
    [
        [220, 30, 30], [30, 220, 30], [30, 30, 220], [220, 220, 30],
        [220, 30, 220], [30, 220, 220], [240, 140, 20], [140, 20, 240],
        [20, 240, 140], [120, 120, 120], [240, 240, 240], [90, 40, 10],
        [10, 90, 40], [40, 10, 90], [200, 100, 100], [100, 200, 100],
        [100, 100, 200], [60, 60, 0], [0, 60, 60], [60, 0, 60],
    ],
    np.uint8,
)


class SyntheticDataset:
    """Iterable with the VOCDataset example structure (20 classes)."""

    def __init__(self, num_examples: int = 256, image_size: int = 300,
                 max_objects: int = 6, seed: int = 0,
                 num_classes: int = 20):
        assert num_classes <= len(_PALETTE)
        self.num_examples = num_examples
        self.image_size = image_size
        self.max_objects = max_objects
        self.seed = seed
        self.num_classes = num_classes
        self._cache = {}

    def __len__(self) -> int:
        return self.num_examples

    def example(self, index: int) -> Dict:
        # Examples are deterministic in (seed, index); cache them so the
        # host never regenerates scenes epoch over epoch.
        if index in self._cache:
            return self._cache[index]
        rng = np.random.default_rng(self.seed * 1_000_003 + index)
        s = self.image_size
        img = rng.integers(0, 80, (s, s, 3), dtype=np.uint8)
        n = int(rng.integers(1, self.max_objects + 1))
        boxes, labels = [], []
        for _ in range(n):
            h = rng.uniform(0.15, 0.6)
            w = rng.uniform(0.15, 0.6)
            y0 = rng.uniform(0.0, 1.0 - h)
            x0 = rng.uniform(0.0, 1.0 - w)
            cls = int(rng.integers(0, self.num_classes))  # 0-based color bin
            py0, px0 = int(y0 * s), int(x0 * s)
            py1, px1 = int((y0 + h) * s), int((x0 + w) * s)
            img[py0:py1, px0:px1] = _PALETTE[cls]
            boxes.append([py0 / s, px0 / s, py1 / s, px1 / s])
            labels.append(cls + 1)  # 1-based, 0 = background
        ex = {
            "image": img,
            "boxes": np.asarray(boxes, np.float32),
            "labels": np.asarray(labels, np.int32),
            "difficult": np.zeros(n, bool),
            "id": f"synthetic-{index:06d}",
        }
        self._cache[index] = ex
        return ex

    def __iter__(self) -> Iterator[Dict]:
        for i in range(self.num_examples):
            yield self.example(i)
