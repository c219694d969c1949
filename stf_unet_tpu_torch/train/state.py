"""Train state: model + AdamW + step, with the optional EMA copy of the
parameters and gradient accumulation (counterpart of
stf_unet_tpu/train/state.py).

AdamW lr=1e-3, betas (0.9, 0.999), wd 1e-4, eps 1e-8 over every parameter
(ref:train.py:227-237), as optax.adamw computes it: decoupled weight decay
and eps outside the square root. The warmup-poly schedule sets the lr of
each step (train/loop.py).

Gradient accumulation (grad_accum = k > 1) is optax.MultiSteps' function:
`step` counts micro-steps, the gradients of k consecutive micro-steps sum
in the parameters' .grad and AdamW applies their mean once per k (one
weight decay, one moment update). The window runs on the global
micro-step count, so it carries across an epoch boundary. BN and the
dice term see each microbatch on its own.

On CUDA, train_one_epoch's steps replay one captured CUDA graph
(train/step_graph.py, `step_graph`): the fused AdamW's groups are then
marked capturable and read the lr from a device tensor.

EMA (`ema`, parameter name -> tensor; None = off) covers the parameters
only: ema = d * ema + (1 - d) * param after each apply, with the warmup
ramp d = min(decay, (1 + n) / (10 + n)) over the apply index n. The BN
running statistics of an EMA evaluation are the live model's, as the JAX
package's TrainState.with_ema_weights has it.

Data parallelism (`data_parallel`): the model's BNs take the global
batch's statistics and a DistributedDataParallel wrapper (`ddp`) runs the
train-mode forward and all-reduces the gradients; `model` stays the
inner module, so the state_dict, the EMA and the checkpoints keep the
reference key layout (no `module.` prefix). Every rank holds the same
parameters, optimizer state and EMA after each apply. A 2-D (data x
space) group is the same: DDP and the synced BN span the whole world,
each rank's loss is its share (losses/criterion.py), so DDP's world
mean is one process's gradient.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from stf_unet_tpu_torch.core.config import OptimConfig
from stf_unet_tpu_torch.models.blocks import (check_k7_dtypes,
                                              convert_sync_batchnorm)


def make_optimizer(cfg: OptimConfig, model: nn.Module,
                   device: torch.device) -> torch.optim.AdamW:
    """torch.optim.AdamW over the model's parameters: fused=True on CUDA
    (one multi-tensor kernel per step), fused=False on the CPU."""
    return torch.optim.AdamW(
        model.parameters(), lr=cfg.lr, betas=(cfg.beta1, cfg.beta2),
        eps=cfg.eps, weight_decay=cfg.weight_decay,
        fused=device.type == "cuda")


def data_parallel(model: nn.Module, group) -> nn.Module:
    """The DistributedDataParallel wrapper of `model` over `group`
    (core/mesh.DataGroup), its BNs synced first. DDP starts every rank
    from rank 0's parameters and buffers; broadcast_buffers is off
    because the synced BN keeps the running statistics equal. Every
    parameter takes part in each forward (the PK branch exists only when
    it runs), so unused-parameter detection stays off."""
    from torch.nn.parallel import DistributedDataParallel

    convert_sync_batchnorm(model, group)
    dev = group.device
    return DistributedDataParallel(
        model, device_ids=[dev.index] if dev.type == "cuda" else None,
        broadcast_buffers=False)


def ema_copy(model: nn.Module) -> Dict[str, torch.Tensor]:
    """A fresh copy of the model's parameters: the EMA's start."""
    return {n: p.detach().clone() for n, p in model.named_parameters()}


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0  # micro-steps taken (= applies when grad_accum == 1)
    grad_accum: int = 1
    ema: Optional[Dict[str, torch.Tensor]] = None
    ema_decay: float = 0.0
    ema_warmup: bool = True
    # the data-parallel group (core/mesh.DataGroup) and the DDP wrapper of
    # `model` (data_parallel), or None for one process
    group: Any = None
    ddp: Optional[nn.Module] = None
    # utils/profiling.NanCheck under --nan-check, else None
    nan_check: Any = None
    # the captured training step (train/step_graph.StepGraph) and the
    # signature of train_one_epoch's previous step (train/loop)
    step_graph: Any = None
    last_signature: Optional[tuple] = None

    def __post_init__(self) -> None:
        check_k7_dtypes(self.model)

    def update_ema(self) -> None:
        """Advance the EMA after an apply (the JAX train step's update)."""
        if self.ema is None:
            return
        # the decay and its complement in float32, as the JAX step has them
        d = np.float32(self.ema_decay)
        if self.ema_warmup:
            n = np.float32(self.step // self.grad_accum - 1)  # this apply
            d = min(d, (np.float32(1.0) + n) / (np.float32(10.0) + n))
        d, keep = float(d), float(np.float32(1.0) - d)
        named = list(self.model.named_parameters())
        params = [p.detach() for _, p in named]
        ema = [self.ema[n] for n, _ in named]
        with torch.no_grad():
            torch._foreach_mul_(ema, d)
            torch._foreach_add_(ema, params, alpha=keep)

    def accumulated_grads(self) -> Optional[Dict[str, torch.Tensor]]:
        """The summed gradients of an unfinished accumulation window (what
        a step-exact checkpoint must carry), or None between windows."""
        if self.grad_accum <= 1 or self.step % self.grad_accum == 0:
            return None
        return {n: p.grad.detach().cpu()
                for n, p in self.model.named_parameters()
                if p.grad is not None}

    def load_accumulated_grads(self, grads: Dict[str, torch.Tensor]) -> None:
        for n, p in self.model.named_parameters():
            if n in grads:
                p.grad = grads[n].to(p.device, p.dtype).clone()

    @contextlib.contextmanager
    def ema_weights(self):
        """Within the block the model's parameters are the EMA weights
        (identity when EMA is off); the live ones come back after."""
        if self.ema is None:
            yield self.model
            return
        params = dict(self.model.named_parameters())
        live = {n: p.detach().clone() for n, p in params.items()}
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(self.ema[n])
        try:
            yield self.model
        finally:
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(live[n])
