"""Model factory + input adaptation (counterpart of
stf_unet_tpu/models/registry.py)."""

from __future__ import annotations

import torch
import torch.nn as nn

from stf_unet_tpu_torch.core.config import ModelConfig
from stf_unet_tpu_torch.models.stf_lstm_unet import STFLSTMUNet
from stf_unet_tpu_torch.models.swin_unet import SwinUNet
from stf_unet_tpu_torch.models.unet import UNet


def create_model(cfg: ModelConfig,
                 dtype: torch.dtype = torch.float32) -> nn.Module:
    """Build the configured model with float32 parameters computing in
    `dtype`. The vanilla UNet and Swin-UNet take the T frames as stacked
    channels, + the pk_channels maps when they ride along
    (ref:train.py:85-90); Swin-UNet at its published widths, with
    `drop_path_rate`. Only the STF model takes `remat`, as in the JAX
    package; the others ignore it."""
    if cfg.model == "stflstm":
        return STFLSTMUNet(num_classes=cfg.total_classes,
                           time_steps=cfg.time_steps,
                           use_pk_maps=cfg.use_pk_maps,
                           pk_channels=cfg.pk_channels,
                           lstm_backend=cfg.lstm_backend, dtype=dtype,
                           remat=cfg.remat)
    in_channels = cfg.time_steps + (cfg.pk_channels if cfg.use_pk_maps
                                    else 0)
    if cfg.model == "unet":
        return UNet(in_channels=in_channels, num_classes=cfg.total_classes,
                    base_c=cfg.base_c, dtype=dtype)
    if cfg.model == "swinunet":
        return SwinUNet(in_chans=in_channels, num_classes=cfg.total_classes,
                        drop_path_rate=cfg.drop_path_rate, dtype=dtype)
    raise ValueError(f"Unknown model type: {cfg.model}")


def preprocess_input(inputs: torch.Tensor, model: nn.Module) -> torch.Tensor:
    """Adapt the batched [B, T, H, W, C] sequence to the model's declared
    input contract (ref:train_utils/train_and_eval.py:9-22)."""
    input_format = getattr(model, "input_format", "time_sequence")
    if input_format == "flat_channels":
        b, t, h, w, c = inputs.shape
        return inputs.permute(0, 2, 3, 1, 4).reshape(b, h, w, t * c)
    if input_format == "average_frame":
        return inputs.mean(dim=1)
    if input_format == "time_sequence":
        return inputs
    raise ValueError(f"Unsupported input_format: {input_format}")
