"""Model factory + input adaptation (counterpart of
stf_unet_tpu/models/registry.py)."""

from __future__ import annotations

import torch
import torch.nn as nn

from stf_unet_tpu_torch.core.config import ModelConfig
from stf_unet_tpu_torch.models.stf_lstm_unet import STFLSTMUNet


def create_model(cfg: ModelConfig,
                 dtype: torch.dtype = torch.float32) -> nn.Module:
    """Build the configured model with float32 parameters computing in
    `dtype`."""
    if cfg.model == "stflstm":
        return STFLSTMUNet(num_classes=cfg.total_classes,
                           time_steps=cfg.time_steps,
                           use_pk_maps=cfg.use_pk_maps,
                           lstm_backend=cfg.lstm_backend, dtype=dtype)
    if cfg.model == "unet":
        raise NotImplementedError(
            "the vanilla UNet is not ported yet (ROADMAP.md, 'Slices', "
            "slice 3: vanilla UNet)")
    raise ValueError(f"Unknown model type: {cfg.model}")


def preprocess_input(inputs: torch.Tensor, model: nn.Module) -> torch.Tensor:
    """Adapt the batched [B, T, H, W, C] sequence to the model's declared
    input contract. Only the time-sequence contract is ported."""
    input_format = getattr(model, "input_format", "time_sequence")
    if input_format == "time_sequence":
        return inputs
    raise ValueError(f"Unsupported input_format: {input_format}")
