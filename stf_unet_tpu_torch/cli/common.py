"""Shared CLI plumbing: restore a model for inference from a reference-
layout checkpoint (counterpart of stf_unet_tpu/cli/common.py).

The checkpoint is the reference's pickle, {"model": state_dict, "epoch": N}
(a bare state_dict also loads). `python -m stf_unet_tpu.cli.migrate
--reverse` writes exactly this from a JAX checkpoint, so a model trained
with the JAX package moves here through that tool. A checkpoint written
by the port's cli/train also carries its run's config (JSON under
"config"): inference then crops and normalizes as that run trained.
"""

from __future__ import annotations

import json
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


def saved_data_settings(meta: dict) -> dict:
    """crop_size, base_size, mean and std of the training run that wrote
    the checkpoint, from the config JSON cli/train stores in it (as the
    JAX package's cli/common reads its checkpoint's config). {} when the
    checkpoint has none (one from `stf_unet_tpu.cli.migrate --reverse`);
    {} with a note when it cannot be read."""
    raw = meta.get("config")
    if not raw:
        return {}
    try:
        data = json.loads(raw)["data"]
        return {"crop_size": int(data["crop_size"]),
                "base_size": int(data["base_size"]),
                "mean": float(data["mean"]), "std": float(data["std"])}
    except (ValueError, KeyError, TypeError) as e:
        print(f"note: unreadable checkpoint config ({e!r}); serving with "
              f"the default data settings")
        return {}


def restore_for_inference(model_name: str, weights: str, *,
                          crop_size: Optional[int] = None,
                          dtype: str = "bf16", device="cuda"
                          ) -> Tuple[nn.Module, DataConfig, ModelConfig,
                                     dict]:
    """Build the model around a checkpoint's weights, in eval mode on
    `device`. The class count comes from the checkpoint's head; a PK
    checkpoint (pk_fusion convs) is recognised, its map count read from
    conv1's input channels. Crop size, base size, mean and std come from
    the checkpoint's training config where it has one (defaults
    otherwise); an explicit `crop_size` wins."""
    dev = resolve_device(device)
    sd, meta = load_reference_checkpoint(weights)
    settings = saved_data_settings(meta)
    if crop_size is not None:
        settings["crop_size"] = crop_size
    data_cfg = DataConfig(**settings)
    use_pk = any(k.startswith("pk_fusion") for k in sd)
    model_cfg = ModelConfig(
        model=model_name, num_classes=int(sd["final.weight"].shape[0]) - 1,
        time_steps=len(data_cfg.resolved_sequence_types),
        use_pk_maps=use_pk,
        pk_channels=int(sd["conv1.weight"].shape[1]) - 1 if use_pk
        else ModelConfig.pk_channels)
    set_precision_policy()
    model = create_model(model_cfg, dtype=DTYPES[dtype])
    model.load_state_dict(sd, strict=True)
    return model.eval().to(dev), data_cfg, model_cfg, meta
