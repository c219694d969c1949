"""Shared CLI plumbing: restore a model for inference from a reference-
layout checkpoint (counterpart of stf_unet_tpu/cli/common.py).

The checkpoint is the reference's pickle, {"model": state_dict, "epoch": N}
(a bare state_dict also loads). `python -m stf_unet_tpu.cli.migrate
--reverse` writes exactly this from a JAX checkpoint, so a model trained
with the JAX package moves here through that tool.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from stf_unet_tpu_torch.core.config import (DataConfig, ModelConfig,
                                            resolve_device)
from stf_unet_tpu_torch.models.registry import create_model

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def load_reference_checkpoint(path: str
                              ) -> Tuple[Dict[str, torch.Tensor], dict]:
    """(state_dict, metadata) from a reference .pth; a DataParallel
    'module.' prefix is stripped."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "model" in raw:
        sd, meta = raw["model"], {k: v for k, v in raw.items()
                                  if k != "model"}
    else:
        sd, meta = raw, {}
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in sd.items()}
    return sd, meta


def set_precision_policy() -> None:
    """float32 serving computes in full float32, as the JAX reference does
    on the CPU: TF32 off for cuBLAS matmuls and for cuDNN convolutions
    (cuDNN's default is on). The flags touch only float32 products, so
    bfloat16 serving runs the same under them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def restore_for_inference(model_name: str, weights: str, *,
                          crop_size: Optional[int] = None,
                          dtype: str = "bf16", device="cuda"
                          ) -> Tuple[nn.Module, DataConfig, ModelConfig,
                                     dict]:
    """Build the model around a checkpoint's weights, in eval mode on
    `device`. The class count comes from the checkpoint's head."""
    dev = resolve_device(device)
    sd, meta = load_reference_checkpoint(weights)
    data_cfg = DataConfig(crop_size=crop_size or DataConfig.crop_size)
    model_cfg = ModelConfig(
        model=model_name, num_classes=int(sd["final.weight"].shape[0]) - 1,
        time_steps=len(data_cfg.resolved_sequence_types),
        use_pk_maps=any(k.startswith("pk_fusion") for k in sd))
    set_precision_policy()
    model = create_model(model_cfg, dtype=DTYPES[dtype])
    model.load_state_dict(sd, strict=True)
    return model.eval().to(dev), data_cfg, model_cfg, meta
