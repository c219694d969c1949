"""Combined CE + dice training loss (counterpart of
stf_unet_tpu/losses/criterion.py; ref:train_utils/train_and_eval.py:
299-313).

Under data parallelism the JAX loss is the global batch's: CE divides by
the global valid (or weighted) pixel count. DistributedDataParallel
averages the ranks' gradients, so a rank's CE here is its pixel sum over
the global count times the world size: the mean over ranks is then the
global CE. Dice is a per-image mean, which equal local batches keep.

Under spatial parallelism (a 2-D group of n_data x n_space ranks, each
holding rows of its data shard's images) the same CE holds over the
whole world, and each image's dice sums are summed over the space group
before the ratio (losses/dice.py): every rank of a space group then
holds its data shard's whole dice, n_space copies of which the world
average of DDP weighs as one data shard's share."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from stf_unet_tpu_torch.losses.dice import build_target, dice_loss


def cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                  ignore_index: int = -100,
                  weight: Optional[torch.Tensor] = None,
                  group=None) -> torch.Tensor:
    """F.cross_entropy semantics on channels-last logits [B, H, W, C] and
    labels [B, H, W]: softmax CE averaged over the pixels that are not
    ignored (and in range); with class weights the average is normalized
    by the weights. Under a data-parallel `group` (core/mesh.DataGroup)
    the normalizer is all-reduced (see above)."""
    num_classes = logits.shape[-1]
    valid = (target != ignore_index) & (target >= 0) & (target < num_classes)
    safe = torch.where(valid, target, torch.zeros_like(target)).long()
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, safe.unsqueeze(-1)).squeeze(-1)
    if weight is not None:
        w = weight.to(logp)[safe] * valid
        total, norm, floor = torch.sum(nll * w), torch.sum(w), 1e-12
    else:
        valid_f = valid.to(torch.float32)
        total, norm, floor = (torch.sum(nll * valid_f), torch.sum(valid_f),
                              1.0)
    if group is not None and dist.is_initialized():
        norm = norm.detach().clone()
        dist.all_reduce(norm)
        total = total * group.world
    return total / torch.clamp(norm, min=floor)


def criterion(outputs: Dict[str, torch.Tensor], target: torch.Tensor,
              loss_weight: Optional[torch.Tensor] = None,
              num_classes: int = 2, dice: bool = True,
              ignore_index: int = -100, group=None) -> torch.Tensor:
    """Per-head CE (+ dice); an auxiliary head weighs 0.5."""
    losses = {}
    for name, logits in outputs.items():
        loss = cross_entropy(logits, target, ignore_index=ignore_index,
                             weight=loss_weight, group=group)
        if dice:
            dice_target = build_target(target, num_classes, ignore_index)
            loss = loss + dice_loss(logits, dice_target, multiclass=True,
                                    ignore_index=ignore_index, group=group)
        losses[name] = loss
    if len(losses) == 1:
        return losses["out"]
    return losses["out"] + 0.5 * losses["aux"]
