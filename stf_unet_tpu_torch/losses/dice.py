"""Dice loss with the reference's semantics (counterpart of
stf_unet_tpu/losses/dice.py; ref:train_utils/dice_coefficient_loss.py).

The reference's boolean-index filtering of ignored pixels becomes
multiplicative masking, which is identical for dice (ignored pixels add 0
to both the intersection and the sums). Layout is the JAX package's:
logits / one-hot targets channels-last [B, H, W, C], labels [B, H, W].
"""

from __future__ import annotations

import torch

from stf_unet_tpu_torch.parallel.spatial import space_sum


def build_target(target: torch.Tensor, num_classes: int = 2,
                 ignore_index: int = -100) -> torch.Tensor:
    """One-hot float32 [B, H, W, C]; ignored pixels hold `ignore_index` in
    every channel. A label outside [0, num_classes) one-hots to zeros, as
    jax.nn.one_hot does."""
    classes = torch.arange(num_classes, device=target.device)
    if ignore_index >= 0:
        ignore = target == ignore_index
        cleaned = torch.where(ignore, torch.zeros_like(target), target)
        one_hot = (cleaned.unsqueeze(-1) == classes).to(torch.float32)
        return torch.where(ignore.unsqueeze(-1),
                           torch.full_like(one_hot, float(ignore_index)),
                           one_hot)
    return (target.unsqueeze(-1) == classes).to(torch.float32)


def dice_coeff(x: torch.Tensor, target: torch.Tensor,
               ignore_index: int = -100,
               epsilon: float = 1e-6, group=None) -> torch.Tensor:
    """Per-image dice of one class channel averaged over the batch; x,
    target [B, H, W]. An empty image (sets_sum == 0) scores 2*inter.
    Under spatial parallelism (`group` a 2-D core/mesh.DataGroup, x and
    target this rank's rows) each image's intersection and sums are
    summed over the space group first, so every rank of it holds the
    whole images' dice."""
    x = x.reshape(x.shape[0], -1)
    target = target.reshape(target.shape[0], -1)
    if ignore_index >= 0:
        ignore = target == ignore_index
        x = x * (~ignore).to(x.dtype)
        target = torch.where(ignore, torch.zeros_like(target), target)
    inter = torch.sum(x * target, dim=1)
    sets_sum = torch.sum(x, dim=1) + torch.sum(target, dim=1)
    if group is not None and group.n_space > 1:
        inter, sets_sum = space_sum(torch.stack([inter, sets_sum]), group)
    sets_sum = torch.where(sets_sum == 0, 2 * inter, sets_sum)
    return torch.mean((2 * inter + epsilon) / (sets_sum + epsilon))


def multiclass_dice_coeff(x: torch.Tensor, target: torch.Tensor,
                          ignore_index: int = -100,
                          epsilon: float = 1e-6, group=None) -> torch.Tensor:
    """Mean dice over the class channels of [B, H, W, C] tensors."""
    num_classes = x.shape[-1]
    total = 0.0
    for c in range(num_classes):
        total = total + dice_coeff(x[..., c], target[..., c], ignore_index,
                                   epsilon, group)
    return total / num_classes


def dice_loss(logits: torch.Tensor, dice_target: torch.Tensor,
              multiclass: bool = True,
              ignore_index: int = -100, group=None) -> torch.Tensor:
    """1 - dice(softmax(logits)); `group` as dice_coeff's."""
    probs = torch.softmax(logits, dim=-1)
    fn = multiclass_dice_coeff if multiclass else dice_coeff
    return 1.0 - fn(probs, dice_target, ignore_index=ignore_index,
                    group=group)
