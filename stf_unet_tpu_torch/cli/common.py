"""Shared CLI plumbing: restore a model for inference from a reference-
layout checkpoint (counterpart of stf_unet_tpu/cli/common.py).

The checkpoint is the reference's pickle, {"model": state_dict, "epoch": N}
(a bare state_dict also loads). `python -m stf_unet_tpu.cli.migrate
--reverse` writes exactly this from a JAX checkpoint, so a model trained
with the JAX package moves here through that tool. A checkpoint written
by the port's cli/train also carries its run's config (JSON under
"config"): inference then crops, normalizes and reads masks as that run
trained. Both models restore: STF-LSTM-UNet and the vanilla UNet.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from stf_unet_tpu_torch.core.config import (DataConfig, ModelConfig,
                                            resolve_device)
from stf_unet_tpu_torch.models.registry import create_model
from stf_unet_tpu_torch.train.checkpoint import checkpoint_file

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def load_reference_checkpoint(path: str
                              ) -> Tuple[Dict[str, torch.Tensor], dict]:
    """(state_dict, metadata) from a reference .pth; a DataParallel
    'module.' prefix is stripped. A cli/train checkpoint that carries EMA
    weights gives them as the parameters (the BN statistics stay the live
    model's), as the JAX package's inference restore does, and says so."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "model" in raw:
        sd, meta = raw["model"], {k: v for k, v in raw.items()
                                  if k not in ("model", "ema",
                                               "accum_grads")}
        if "ema" in raw:
            sd = {**sd, **raw["ema"]}
            print("using EMA weights (checkpoint carries an EMA copy)")
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


# Data settings of the training run read where its config holds them.
_OPTIONAL_SETTINGS = ("mask_format", "use_subtraction", "use_pk_maps")


def saved_data_settings(meta: dict) -> dict:
    """crop_size, base_size, mean and std of the training run that wrote
    the checkpoint, and its mask_format, use_subtraction and use_pk_maps
    where the config has them, from the config JSON cli/train stores in it
    (as the JAX package's cli/common reads its checkpoint's config). {}
    when the checkpoint has none (one from `stf_unet_tpu.cli.migrate
    --reverse`); {} with a note when it cannot be read."""
    raw = meta.get("config")
    if not raw:
        return {}
    try:
        data = json.loads(raw)["data"]
        settings = {"crop_size": int(data["crop_size"]),
                    "base_size": int(data["base_size"]),
                    "mean": float(data["mean"]), "std": float(data["std"])}
        settings.update({k: data[k] for k in _OPTIONAL_SETTINGS
                         if k in data})
        return settings
    except (ValueError, KeyError, TypeError) as e:
        print(f"note: unreadable checkpoint config ({e!r}); serving with "
              f"the default data settings")
        return {}


def checkpoint_path(model_dir: str, model_name: str,
                    use_pk_maps: bool = False) -> str:
    """The best, else the latest checkpoint of a cli/train save directory
    (`<model>_{best,latest}_model<_pk>.pth`)."""
    suffix = "_pk" if use_pk_maps else ""
    for kind in ("best", "latest"):
        path = checkpoint_file(model_dir, model_name, kind, suffix)
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(f"{model_name}_best_model{suffix}.pth not found "
                            f"in {model_dir}")


# The classifier head of each model: its output channels are the class
# count.
_HEADS = {"stflstm": "final.weight", "unet": "out_conv.weight"}


def restore_for_inference(model_name: str, weights: str, *,
                          use_subtraction: bool = False,
                          use_pk_maps: Optional[bool] = None,
                          num_classes: Optional[int] = None,
                          base_c: Optional[int] = None,
                          crop_size: Optional[int] = None,
                          mask_format: Optional[str] = None,
                          dtype: str = "bf16", device="cuda"
                          ) -> Tuple[nn.Module, DataConfig, ModelConfig,
                                     dict]:
    """Build the model around a checkpoint's weights, in eval mode on
    `device`.

    The architecture comes from the weights: the class count from the
    head (`final` / `out_conv`), the UNet's width from enc1's output
    channels, the PK maps from the pk_fusion convs (STF-LSTM-UNet) or
    from enc1's input channels, T + 3 (UNet). Crop size, base size, mean,
    std and mask format come from the checkpoint's training config where
    it has one (defaults otherwise). Explicit arguments win. The sequence
    selection (`use_subtraction`) and `use_pk_maps` pick the inputs (and,
    in cli/test, the checkpoint file), so they do not default from the
    config; a mismatch with it prints a warning, as the JAX package's
    cli/common does."""
    dev = resolve_device(device)
    sd, meta = load_reference_checkpoint(weights)
    head = _HEADS[model_name]
    if head not in sd:
        raise ValueError(f"{weights} holds no {head!r}: not a {model_name} "
                         f"checkpoint (pass the model it was trained as)")
    settings = saved_data_settings(meta)
    saved = {k: settings.pop(k, None)
             for k in ("use_subtraction", "use_pk_maps")}
    for key, value in (("crop_size", crop_size),
                       ("mask_format", mask_format)):
        if value is not None:
            settings[key] = value
    time_steps = len(DataConfig(
        use_subtraction=use_subtraction).resolved_sequence_types)
    if model_name == "unet":
        width, in_ch = (int(n) for n in sd["enc1.0.weight"].shape[:2])
        pk_channels = in_ch - time_steps
        weights_pk = pk_channels > 0
        base_c = width if base_c is None else base_c
    else:
        weights_pk = any(k.startswith("pk_fusion") for k in sd)
        pk_channels = int(sd["conv1.weight"].shape[1]) - 1
    for flag, ours, theirs in (
            ("--use-subtraction", use_subtraction,
             saved["use_subtraction"]),
            ("--use-pk-maps", weights_pk if use_pk_maps is None
             else use_pk_maps, saved["use_pk_maps"])):
        if theirs is not None and bool(ours) != bool(theirs):
            print(f"WARNING: checkpoint was trained with {flag}="
                  f"{bool(theirs)} but this run uses {flag}={bool(ours)} "
                  f"— inference will see different input sequences/"
                  f"channels than training did")
    data_cfg = DataConfig(use_subtraction=use_subtraction,
                          use_pk_maps=weights_pk, **settings)
    model_cfg = ModelConfig(
        model=model_name,
        num_classes=(int(sd[head].shape[0]) if num_classes is None
                     else num_classes) - 1,
        time_steps=time_steps, use_pk_maps=weights_pk,
        pk_channels=pk_channels if weights_pk else ModelConfig.pk_channels,
        base_c=ModelConfig.base_c if base_c is None else base_c)
    set_precision_policy()
    model = create_model(model_cfg, dtype=DTYPES[dtype])
    model.load_state_dict(sd, strict=True)
    return model.eval().to(dev), data_cfg, model_cfg, meta
