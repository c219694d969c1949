"""Train state: model + AdamW + step (counterpart of
stf_unet_tpu/train/state.py).

AdamW lr=1e-3, betas (0.9, 0.999), wd 1e-4, eps 1e-8 over every parameter
(ref:train.py:227-237), as optax.adamw computes it: decoupled weight decay
and eps outside the square root. The warmup-poly schedule sets the lr of
each step (train/loop.py). EMA and gradient accumulation are not ported
yet (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn

from stf_unet_tpu_torch.core.config import OptimConfig


def make_optimizer(cfg: OptimConfig, model: nn.Module,
                   device: torch.device) -> torch.optim.AdamW:
    """torch.optim.AdamW over the model's parameters: fused=True on CUDA
    (one multi-tensor kernel per step), fused=False on the CPU."""
    return torch.optim.AdamW(
        model.parameters(), lr=cfg.lr, betas=(cfg.beta1, cfg.beta2),
        eps=cfg.eps, weight_decay=cfg.weight_decay,
        fused=device.type == "cuda")


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
