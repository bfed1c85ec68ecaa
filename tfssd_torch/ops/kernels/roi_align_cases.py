"""Boxes on which RoIAlign (ops/kernels/roi_align.py) could part from
torchvision's definition, or its kernel from its plain version: each case
is (B, K, 4) pixel boxes [x0, y0, x1, y1] over a frame of (H, W) pixels.
The CPU tests hold the plain version against the benchmark's reference on
every case; chip_smoke.py holds the kernel against the plain version on
the card, bit for bit, on the same cases.

  random       boxes of sides 1-60% of the frame anywhere in it
  tiny         boxes of sides under 1 / scale pixels (under one cell of
               P2 to P5, so the extent is raised to 1), zero-size boxes
               (the padding rows) among them
  frame_edges  boxes touching the frame's right and bottom edges, where
               the last row and column of a level are read, and boxes
               whose samples pass the map's border (y > H reads 0)
  outside      boxes partly or wholly beyond the map on every side,
               samples below -1 and past the size
  level_edges  square boxes of side 224 * 2^(k - 4) and one float32 ulp
               either side, at the edges between the pyramid's levels
"""

from __future__ import annotations

from typing import List, Tuple

import torch

Case = Tuple[str, torch.Tensor]

NAMES = ("random", "tiny", "frame_edges", "outside", "level_edges")


def crafted_boxes(b: int, k: int, height: int, width: int, seed: int
                  ) -> List[Case]:
    """Every case of the module docstring, in NAMES' order, as (name,
    (b, k, 4) float32 boxes) on the CPU."""
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.rand(*shape, generator=gen)

    side = torch.tensor([width, height], dtype=torch.float32)
    size = (rand(b, k, 2) * 0.59 + 0.01) * side
    corner = rand(b, k, 2) * (side - size)
    cases = [("random", torch.cat([corner, corner + size], dim=-1))]

    tiny = rand(b, k, 2) * 7.0          # under 8 px: under a P3 cell
    tiny[:, ::4] = 0.0                  # zero-size boxes
    at = rand(b, k, 2) * (side - 8.0)
    cases.append(("tiny", torch.cat([at, at + tiny], dim=-1)))

    size = (rand(b, k, 2) * 0.3 + 0.001) * side
    far = side - size
    edge = torch.cat([far, far + size], dim=-1)
    # a quarter end one pixel past the frame, where a level's map ends
    edge[:, ::4, 2:] = side + 1.0
    cases.append(("frame_edges", edge))

    size = (rand(b, k, 2) * 0.5 + 0.01) * side
    corner = rand(b, k, 2) * side * 1.6 - side * 0.3
    cases.append(("outside", torch.cat([corner, corner + size], dim=-1)))

    sides = torch.tensor([224.0 * 2.0 ** (j - 4) for j in range(2, 7)])
    below = torch.nextafter(sides, torch.zeros_like(sides))
    above = torch.nextafter(sides, torch.full_like(sides, float("inf")))
    ring = torch.cat([sides, below, above]).repeat(-(-k // 15))[:k]
    ring = ring.expand(b, k).clone()
    at = rand(b, k, 2) * 0.5 * side
    cases.append(("level_edges", torch.cat(
        [at, at + ring[..., None]], dim=-1)))
    return cases
