"""Configuration for the serving path: the fields of the JAX package's
`DataConfig` and `ModelConfig` (stf_unet_tpu/core/config.py) that serving
reads, with the same defaults (the reference's presets)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch


@dataclass
class DataConfig:
    """Eval-transform settings: PIL short-edge resize to `crop_size`, then
    (x/255 - mean)/std with the BreaDM statistics."""

    use_subtraction: bool = False
    sequence_types: Optional[Sequence[str]] = None
    use_pk_maps: bool = False
    base_size: int = 256
    crop_size: int = 224
    mean: float = 0.709
    std: float = 0.127

    @property
    def resolved_sequence_types(self) -> Sequence[str]:
        if self.sequence_types is not None:
            return tuple(self.sequence_types)
        if self.use_subtraction:
            return tuple(f"SUB{i}" for i in range(1, 9))
        return tuple(f"VIBRANT+C{i}" for i in range(1, 9))


@dataclass
class ModelConfig:
    """Model selection. `num_classes` counts foreground classes; the
    network predicts `total_classes` = num_classes + 1 (background)."""

    model: str = "stflstm"
    num_classes: int = 1
    time_steps: int = 8
    use_pk_maps: bool = False
    # {"auto", "scan", "fused", "last"}: see ops/lstm.pixel_lstm.
    lstm_backend: str = "auto"

    @property
    def total_classes(self) -> int:
        return self.num_classes + 1


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. CUDA unless the caller asks for
    the CPU; a CUDA request without a visible GPU raises (no fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev
