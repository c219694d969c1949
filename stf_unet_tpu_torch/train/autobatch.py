"""Automatic batch sizing from a measured train step (counterpart of
stf_unet_tpu/train/autobatch.py).

`--batch-size auto` on the train CLI. The JAX package reads the XLA
compiler's memory analysis of the train step; here one REAL step of the
run's exact configuration (warp, forward, backward, AdamW; the EMA copy
and the accumulation window included) runs at each of two probe batches
on the card, and the CUDA caching allocator's peak
(`torch.cuda.reset_peak_memory_stats` / `max_memory_allocated`) gives its
memory. The step's memory grows linearly in the batch while the state
(parameters, AdamW moments, EMA) is fixed, so the two points give bytes
per sample and the largest batch under the budget (`torch.cuda.
mem_get_info`'s free bytes, or --auto-batch-budget-gb). The pick is the
JAX package's arithmetic unchanged: the largest power of two under
frac = 0.9 of the budget, probes (2, 4), at most 1024.

On the CPU the allocator reports nothing, so `auto` raises there.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

DEFAULT_BUDGET_FRAC = 0.9  # headroom for fragmentation and the loader

_MEASURE_MEMO: dict = {}


def device_budget_bytes(device="cuda") -> Optional[int]:
    """The card's free memory once the allocator's cache is released, or
    None off CUDA (then an explicit budget is needed, and auto still
    cannot measure)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info(dev)
    return int(free)


def measure_step_memory(cfg, t_total: int, batch: int,
                        canvas: Optional[Tuple[int, int]] = None,
                        device="cuda") -> Tuple[int, int]:
    """-> (step_bytes, state_bytes) of cli/train's step at `batch` on the
    card: state_bytes the model, AdamW moments and EMA copy after a first
    step (its gradients freed); step_bytes the allocator's peak above that
    state and the batch's uint8 inputs during one more step (one
    accumulation window under --grad-accum), gradients, activations and
    workspaces included. The inputs sit on the loader's fixed `canvas`
    (default base_size square), as the step reads them. Memoized per
    process."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError(
            "--batch-size auto measures a train step on the card; the CPU "
            "allocator reports no memory: set an explicit --batch-size")
    from stf_unet_tpu_torch.core.config import config_to_json

    ch, cw = canvas if canvas is not None else (cfg.data.base_size,
                                                cfg.data.base_size)
    memo_key = (config_to_json(cfg), t_total, batch, (ch, cw), str(dev))
    if memo_key in _MEASURE_MEMO:
        return _MEASURE_MEMO[memo_key]
    from stf_unet_tpu_torch.data.transforms import TrainAugment
    from stf_unet_tpu_torch.models.registry import create_model
    from stf_unet_tpu_torch.train.loop import DeviceBatch, train_step
    from stf_unet_tpu_torch.train.state import (TrainState, ema_copy,
                                                make_optimizer)

    pk_ch = cfg.model.pk_channels if cfg.data.use_pk_maps else 0
    model_cfg = dataclasses.replace(cfg.model, time_steps=t_total - pk_ch,
                                    use_pk_maps=pk_ch > 0)
    k = max(int(cfg.grad_accum), 1)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    m0 = torch.cuda.memory_allocated(dev)
    model = create_model(model_cfg, dtype=torch.bfloat16 if cfg.amp
                         else torch.float32).to(dev)
    state = TrainState(model, make_optimizer(cfg.optim, model, dev),
                       grad_accum=k,
                       ema=ema_copy(model) if cfg.optim.ema_decay > 0
                       else None, ema_decay=cfg.optim.ema_decay)
    augment = TrainAugment(cfg.data)
    gen = torch.Generator().manual_seed(0)
    u8 = dict(dtype=torch.uint8, device=dev)
    inputs = DeviceBatch(
        frames=torch.zeros((batch, t_total - pk_ch, ch, cw), **u8),
        masks=torch.zeros((batch, ch, cw), **u8),
        pk=torch.zeros((batch, pk_ch, ch, cw), **u8) if pk_ch else None,
        sizes=np.full((batch, 2), min(ch, cw), np.int32))
    input_bytes = batch * t_total * ch * cw + batch * ch * cw

    def window():
        for _ in range(k):
            train_step(state, augment, inputs, gen, lambda s: cfg.optim.lr,
                       model_cfg.total_classes, dev)

    window()  # allocates the AdamW moments
    state.optimizer.zero_grad(set_to_none=True)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    state_bytes = base - m0 - input_bytes
    torch.cuda.reset_peak_memory_stats(dev)
    window()
    torch.cuda.synchronize(dev)
    step_bytes = torch.cuda.max_memory_allocated(dev) - base
    del state, model, inputs
    torch.cuda.empty_cache()
    result = (int(step_bytes), int(state_bytes))
    _MEASURE_MEMO[memo_key] = result
    return result


def pick_batch_size(cfg, t_total: int,
                    budget_bytes: Optional[int] = None,
                    frac: float = DEFAULT_BUDGET_FRAC,
                    probes: Tuple[int, int] = (2, 4),
                    cap: int = 1024,
                    canvas: Optional[Tuple[int, int]] = None,
                    device="cuda",
                    measure: Optional[Callable[[int],
                                               Tuple[int, int]]] = None
                    ) -> int:
    """The largest power-of-two batch whose train step fits `frac *
    budget` (default: the card's free memory; raises where none is
    reported). `measure(batch) -> (step_bytes, state_bytes)` defaults to
    measure_step_memory on `device`."""
    if budget_bytes is None:
        budget_bytes = device_budget_bytes(device)
        if budget_bytes is None:
            raise RuntimeError(
                "--batch-size auto: the CPU reports no device memory; set "
                "an explicit --batch-size")
    if measure is None:
        def measure(batch):
            return measure_step_memory(cfg, t_total, batch, canvas=canvas,
                                       device=device)
    b0, b1 = probes
    t0, state_bytes = measure(b0)
    t1, _ = measure(b1)
    per_sample = (t1 - t0) / (b1 - b0)
    fixed = t0 - per_sample * b0
    usable = frac * budget_bytes - state_bytes - fixed
    if per_sample <= 0:
        raise RuntimeError(
            f"memory measurement degenerate (per-sample {per_sample} B) — "
            "set an explicit --batch-size")
    max_batch = int(usable // per_sample)
    if max_batch < 1:
        raise RuntimeError(
            f"--batch-size auto: even batch 1 does not fit "
            f"({(state_bytes + fixed + per_sample) / 2**30:.2f} GiB needed, "
            f"budget {frac * budget_bytes / 2**30:.2f} GiB) — try a "
            "smaller --data-crop-size")
    batch = 1
    while batch * 2 <= min(max_batch, cap):
        batch *= 2
    print(f"auto batch: {per_sample / 2**20:.1f} MiB/sample + "
          f"{(state_bytes + fixed) / 2**30:.2f} GiB fixed against "
          f"{frac * budget_bytes / 2**30:.2f} GiB budget -> {batch}")
    return batch
