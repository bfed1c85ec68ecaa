"""SSD multibox loss: masked smooth-L1 + hard-negative-mined cross entropy
(port of the JAX package's ops/losses.py; reference: ssd_loss.py).

  * localization: Huber(actual - pred) summed over the 4 coordinates,
    positives only, per image over max(1, #pos), times loc_loss_alpha;
  * confidence: cross entropy of log-softmax logits per anchor; positives
    kept, and of the negatives the `neg_pos_ratio * #pos` with the largest
    loss, per image over max(1, #pos).

Hard negatives are a rank threshold, rank(loss) < 3 * #pos, from one
descending STABLE sort (ties by index, as jnp.argsort), with positives
sent to the end.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def huber(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """Elementwise smooth-L1 (Huber) on residuals."""
    absx = x.abs()
    quad = 0.5 * x * x
    lin = delta * (absx - 0.5 * delta)
    return torch.where(absx <= delta, quad, lin)


def localization_loss(actual_deltas: torch.Tensor, pred_deltas: torch.Tensor,
                      positive_mask: torch.Tensor,
                      loc_loss_alpha: float = 1.0) -> torch.Tensor:
    """Per-batch scalar loc loss."""
    per_coord = huber(pred_deltas - actual_deltas.to(pred_deltas.dtype))
    per_anchor = per_coord.sum(dim=-1)                          # (B, N)
    per_anchor = torch.where(positive_mask, per_anchor,
                             torch.zeros_like(per_anchor))
    pos = positive_mask.sum(dim=-1).to(per_anchor.dtype)        # (B,)
    per_image = per_anchor.sum(dim=-1) / pos.clamp_min(1.0)
    return loc_loss_alpha * per_image.mean()


def rank_descending(values: torch.Tensor) -> torch.Tensor:
    """Rank of each element under a descending sort along the last axis
    (0 = largest; ties broken by index)."""
    order = torch.argsort(-values, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def confidence_loss(actual_labels: torch.Tensor, pred_logits: torch.Tensor,
                    neg_pos_ratio: int = 3,
                    positive: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-batch scalar conf loss with hard-negative mining."""
    logp = torch.log_softmax(pred_logits.float(), dim=-1)
    ce = -(actual_labels * logp).sum(dim=-1)                    # (B, N)
    if positive is None:
        positive = actual_labels[..., 1:].sum(dim=-1) > 0.5
    pos_count = positive.sum(dim=-1)                            # (B,)
    with torch.no_grad():
        neg_ce = torch.where(positive, torch.full_like(ce, -float("inf")),
                             ce)
        neg_rank = rank_descending(neg_ce)
    num_neg = neg_pos_ratio * pos_count
    hard_negative = (~positive) & (neg_rank < num_neg[:, None])
    selected = torch.where(positive | hard_negative, ce,
                           torch.zeros_like(ce))
    per_image = selected.sum(dim=-1) / pos_count.to(ce.dtype).clamp_min(1.0)
    return per_image.mean()


def ssd_losses(actual_deltas: torch.Tensor, actual_labels: torch.Tensor,
               pred_deltas: torch.Tensor, pred_logits: torch.Tensor,
               neg_pos_ratio: int = 3, loc_loss_alpha: float = 1.0
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total SSD loss and a metrics dict (loss, loc_loss, conf_loss,
    num_pos), every metric detached."""
    positive = actual_labels[..., 1:].sum(dim=-1) > 0.5
    loc = localization_loss(actual_deltas, pred_deltas, positive,
                            loc_loss_alpha)
    conf = confidence_loss(actual_labels, pred_logits, neg_pos_ratio,
                           positive=positive)
    total = loc + conf
    return total, {
        "loss": total.detach(),
        "loc_loss": loc.detach(),
        "conf_loss": conf.detach(),
        "num_pos": positive.sum().to(torch.float32),
    }
