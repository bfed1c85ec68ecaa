"""Splits of one batch of candidates over the classes: the ways the
class-wise keep (ops/kernels/classwise_keep.py) could part from greedy NMS
per class, or its kernel from its plain version.

Each case lays the same (B, T, 4) boxes, (B, T) scores and (B, T) classes
in 0..C-1 over the classes another way, or changes the scores; T stays.
The CPU tests hold classwise_nms against a greedy loop per class on every
case; chip_smoke.py holds the kernel against the plain version on the
card, bit for bit, on the same cases made from a served request.

  as_given      the batch itself
  one_class     every candidate in the last class: one class walks
                ceil(T / 256) rows, every other class is empty
  singletons    the first min(T, C) candidates one a class, the rest at the
                score threshold (so no class holds two valid candidates)
  few_classes   every candidate in one of three classes, the rest empty
  equal_scores  every score the same, above the threshold: the order
                within a class is the candidates' index order
  at_threshold  a third of the scores exactly at the score threshold (as
                float32: invalid), a third one float32 ulp above it (valid)
  mixed         image i split as the i-th case above but the first,
                cycling: each image of the batch a different split
"""

from __future__ import annotations

from typing import List, Tuple

import torch

Case = Tuple[str, torch.Tensor, torch.Tensor, torch.Tensor]

NAMES = ("as_given", "one_class", "singletons", "few_classes",
         "equal_scores", "at_threshold", "mixed")


def random_candidates(b: int, t: int, num_classes: int, seed: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, T, 4) boxes of sides 0.05-0.15 centred in [0.25, 0.75]^2 (dense
    enough that greedy NMS keeps some and suppresses others), (B, T)
    scores in [0.06, 0.96) and (B, T) classes drawn from `seed`."""
    gen = torch.Generator().manual_seed(seed)
    centre = torch.rand(b, t, 2, generator=gen) * 0.5 + 0.25
    size = torch.rand(b, t, 2, generator=gen) * 0.1 + 0.05
    boxes = torch.cat([centre - size / 2, centre + size / 2], dim=-1)
    scores = torch.rand(b, t, generator=gen) * 0.9 + 0.06
    classes = torch.randint(0, num_classes, (b, t), generator=gen)
    return boxes, scores, classes


def split_cases(boxes: torch.Tensor, scores: torch.Tensor,
                classes: torch.Tensor, num_classes: int,
                score_threshold: float) -> List[Case]:
    """Every case of the module docstring, in NAMES' order, as (name,
    boxes, scores, classes) on the inputs' device."""
    b, t = scores.shape
    dev = scores.device
    idx = torch.arange(t, device=dev).expand(b, t)
    at = torch.tensor(score_threshold, dtype=torch.float32)
    above = torch.nextafter(at, torch.tensor(float("inf"))).item()
    at = at.item()
    few = min(3, num_classes)
    singles = min(t, num_classes)
    cases = [
        ("one_class", boxes, scores,
         torch.full_like(classes, num_classes - 1)),
        ("singletons", boxes,
         torch.where(idx < singles, scores, at),
         torch.where(idx < singles, idx, classes)),
        ("few_classes", boxes, scores,
         classes % few * (num_classes // few)),
        ("equal_scores", boxes,
         torch.full_like(scores, max(score_threshold, 0.0) + 0.5), classes),
        ("at_threshold", boxes,
         torch.where(idx % 3 == 0, at,
                     torch.where(idx % 3 == 1, above, scores)), classes),
    ]
    rows = torch.arange(b, device=dev)

    def pick(part: int) -> torch.Tensor:
        return torch.stack([case[part] for case in cases])[
            rows % len(cases), rows]

    return ([("as_given", boxes, scores, classes)] + cases
            + [("mixed", pick(1), pick(2), pick(3))])
