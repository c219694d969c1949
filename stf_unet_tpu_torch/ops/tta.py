"""Flip test-time augmentation (counterpart of stf_unet_tpu/ops/tta.py).

The logits are averaged over {identity, hflip, vflip, hvflip} of the
input, each logit map flipped back before the mean: k forwards for k
orientations. Every model's preprocessed layout puts (H, W) at axes
(-3, -2) (UNet flat channels [B, H, W, T], STF-LSTM-UNet's time sequence
[B, T, H, W, 1]) and the logits come back [B, H, W, C], so one rule flips
both.

    model = FlipTTAModel(model)   # cli/test --tta does this
    evaluate(model, ...)          # or the engine / TiledPredictor
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

_MODES: Tuple[str, ...] = ("h", "v", "hv")


def _flip(a: torch.Tensor, mode: str) -> torch.Tensor:
    dims = []
    if "v" in mode:
        dims.append(a.ndim - 3)  # H
    if "h" in mode:
        dims.append(a.ndim - 2)  # W
    return torch.flip(a, dims) if dims else a


class FlipTTAModel(nn.Module):
    """Wraps a model: forward returns {"out": the flip-ensembled float32
    logits}; `input_format` and `num_classes` are the wrapped model's."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model
        self.input_format = getattr(model, "input_format", "time_sequence")
        self.num_classes = model.num_classes

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        def one(mode: str) -> torch.Tensor:
            return _flip(self.model(_flip(x, mode))["out"], mode)

        acc = one("")
        for mode in _MODES:
            acc = acc + one(mode)
        return {"out": acc / (1 + len(_MODES))}
