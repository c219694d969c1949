"""Eval-time Dice (counterpart of stf_unet_tpu/metrics/dice.py;
ref:train_utils/train_and_eval.py:72-142).

The reference's semantics, quirks included: ignored pixels become class 0
in BOTH prediction and target (ref:87-90) rather than being excluded, and
an empty union scores 1 (ref:104-107). Dice is per image and summed, so a
batched evaluation equals the reference's batch-1 accumulation.
"""

from __future__ import annotations

from typing import Tuple

import torch


def eval_dice_update(cumulative: torch.Tensor, count: int,
                     logits: torch.Tensor, target: torch.Tensor,
                     ignore_index: int = 255) -> Tuple[torch.Tensor, int]:
    """One batch: logits [B, H, W, C], target [B, H, W] -> (cumulative
    per-class dice sums [C] float32, image count)."""
    num_classes = logits.shape[-1]
    b = logits.shape[0]
    pred = torch.argmax(logits, dim=-1)
    keep = target != ignore_index
    pred = torch.where(keep, pred, torch.zeros_like(pred)).reshape(b, -1)
    tgt = torch.where(keep, target, torch.zeros_like(target)).reshape(b, -1)
    per_class = []
    for c in range(num_classes):
        p = (pred == c).to(torch.float32)
        t = (tgt == c).to(torch.float32)
        inter = torch.sum(p * t, dim=1)
        union = torch.sum(p, dim=1) + torch.sum(t, dim=1)
        dice = torch.where(union > 0, 2.0 * inter / union,
                           torch.ones_like(union))
        per_class.append(torch.sum(dice))
    return cumulative + torch.stack(per_class), count + b


def eval_dice_value(cumulative: torch.Tensor, count: int) -> float:
    """Mean over classes of the running mean (ref:120-138)."""
    if count <= 0:
        return 0.0
    return float(torch.mean(cumulative / count))
