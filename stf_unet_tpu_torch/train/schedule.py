"""Per-step warmup + poly-decay learning-rate schedule (counterpart of
stf_unet_tpu/train/schedule.py; ref:train_utils/train_and_eval.py:
414-438)."""

from __future__ import annotations

from typing import Callable


def warmup_poly_schedule(base_lr: float, num_step: int, epochs: int,
                         warmup: bool = True, warmup_epochs: int = 1,
                         warmup_factor: float = 1e-3,
                         power: float = 0.9) -> Callable[[int], float]:
    """step -> lr. Linear warmup from warmup_factor to 1 over
    `warmup_epochs` epochs, then (1 - progress)^power decay to 0 at the
    last step (deeplab style). LambdaLR semantics: the lr used at step x
    is f(x)."""
    if num_step <= 0 or epochs <= 0:
        raise ValueError(f"num_step and epochs must be positive, got "
                         f"{num_step}, {epochs}")
    if not warmup:
        warmup_epochs = 0
    warmup_steps = warmup_epochs * num_step
    total_decay = (epochs - warmup_epochs) * num_step

    def schedule(step: int) -> float:
        x = float(step)
        if warmup_steps > 0 and x <= warmup_steps:
            alpha = x / warmup_steps
            return base_lr * (warmup_factor * (1 - alpha) + alpha)
        progress = (x - warmup_steps) / max(total_decay, 1)
        return base_lr * max(1.0 - progress, 0.0) ** power

    return schedule
