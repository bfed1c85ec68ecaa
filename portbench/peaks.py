"""The yardstick of the device: the published peaks of one NVIDIA H100 SXM
(NVIDIA's data sheet; dense rates, at the full 700 W power limit) and the
operation and byte counts of the program's two hand-written kernels,
copied from the arithmetic that chip_smoke.py's timing phase uses
(keep_bound, match_bound), so that the roofline shares here cannot move
with a later change to that script.
"""

from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
# float32 outside the tensor cores: the precision the configurations state
# (TF32 off).
F32_FLOP_PER_S = 67e12

# Operations of one IoU and its comparison in nms_keep: 4 max/min, 2
# subtractions, 2 clamps, 1 multiply (intersection), 2 add/sub (union),
# 1 clamp, 1 divide, 1 compare; the areas and the greedy scan are O(K)
# per instance and left out.
OPS_PER_IOU = 15
# Operations of one anchor-gt pair in match_encode: 4 max/min, 2
# subtractions, 2 clamps, a multiply (intersection), an add and a subtract
# (union), a clamp, a divide, the padding mask, the compare and the argmax
# update; the encode is O(1) per anchor and left out.
OPS_PER_MATCH = 16


def keep_bound_s(r: int, k: int) -> Tuple[float, str]:
    """(least seconds, what bounds it) of one nms_keep call over r
    instances of k candidates: the inputs (boxes, scores) read once and
    the keep mask written once, against one IoU for each pair i < j."""
    t_bytes = r * k * (16 + 4 + 1) / HBM_BYTES_PER_S
    t_ops = r * (k * (k - 1) // 2) * OPS_PER_IOU / F32_FLOP_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def match_bound_s(n: int, b: int, g: int, real_gts: int
                  ) -> Tuple[float, str]:
    """(least seconds, what bounds it) of one match_encode call: n anchors
    and the (b, g) padded gts read once, the (b, n) deltas and labels
    written once, against one IoU and compare for each pair of an anchor
    and a real gt (label > 0)."""
    t_bytes = (n * 16 + b * g * (16 + 4) + b * n * (16 + 4)) / HBM_BYTES_PER_S
    t_ops = n * real_gts * OPS_PER_MATCH / F32_FLOP_PER_S
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")
