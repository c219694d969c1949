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

import argparse
import json
import os
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from stf_unet_tpu_torch.core.config import (MATMUL_PRECISIONS, DataConfig,
                                            ModelConfig, resolve_device)
from stf_unet_tpu_torch.models.registry import create_model
from stf_unet_tpu_torch.train.checkpoint import checkpoint_file

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def load_reference_checkpoint(path: str
                              ) -> Tuple[Dict[str, torch.Tensor], dict]:
    """(state_dict, metadata) from a reference .pth ({"model": ...},
    {"state_dict": ...} or a bare state_dict, read with weights_only; the
    reference's saved `args` Namespace is allowed); a DataParallel
    'module.' prefix is stripped. A cli/train checkpoint that carries EMA
    weights gives them as the parameters (the BN statistics stay the live
    model's), as the JAX package's inference restore does, and says so."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        raw = torch.load(path, map_location="cpu", weights_only=True)
    key = next((k for k in ("model", "state_dict")
                if isinstance(raw, dict) and k in raw), None)
    if key is not None:
        sd, meta = raw[key], {k: v for k, v in raw.items()
                              if k not in (key, "ema", "accum_grads")}
        if "ema" in raw:
            sd = {**sd, **raw["ema"]}
            print("using EMA weights (checkpoint carries an EMA copy)")
    else:
        sd, meta = raw, {}
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in sd.items()}
    return sd, meta


def set_precision_policy(matmul_precision: str = "default") -> bool:
    """float32 serving computes in full float32, as the JAX reference does
    on the CPU: TF32 off for cuBLAS matmuls and for cuDNN convolutions
    (cuDNN's default is on). cli/train's --matmul-precision picks the
    policy by JAX's names (core/config.MATMUL_PRECISIONS): "default",
    "highest" and "float32" are this one, "high" and "tensorfloat32"
    turn TF32 on for both; another name raises ValueError. The flags touch
    only float32 products of cuBLAS and cuDNN, so bfloat16 runs the same
    under them, and the hand-written kernels never read them. Returns
    whether TF32 is on."""
    if matmul_precision not in MATMUL_PRECISIONS:
        raise ValueError(f"matmul precision {matmul_precision!r}: expected "
                         f"one of {sorted(MATMUL_PRECISIONS)}")
    tf32 = MATMUL_PRECISIONS[matmul_precision]
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    return tf32


# Data settings of the training run read where its config holds them.
_OPTIONAL_SETTINGS = ("mask_format", "use_subtraction", "use_pk_maps")


def saved_data_settings(meta: dict) -> dict:
    """crop_size, base_size, mean and std of the training run that wrote
    the checkpoint, and its mask_format, use_subtraction and use_pk_maps
    where the config has them, from the config JSON cli/train stores in it
    (as the JAX package's cli/common reads its checkpoint's config). {}
    when the checkpoint has none (one from `stf_unet_tpu.cli.migrate
    --reverse`) or its config holds no "data" (cli/migrate's
    {"migrated_from": ...}); {} with a note when it cannot be read."""
    raw = meta.get("config")
    if not raw:
        return {}
    try:
        data = json.loads(raw).get("data")
        if data is None:  # a cli/migrate or cli/average provenance note
            return {}
        settings = {"crop_size": int(data["crop_size"]),
                    "base_size": int(data["base_size"]),
                    "mean": float(data["mean"]), "std": float(data["std"])}
        settings.update({k: data[k] for k in _OPTIONAL_SETTINGS
                         if k in data})
        return settings
    except (ValueError, KeyError, TypeError, AttributeError) as e:
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
_HEADS = {"stflstm": "final.weight", "unet": "out_conv.weight",
          "swinunet": "output.weight"}
# The first layer of each model that takes the T frames (+ PK maps) as
# input channels.
_STEMS = {"unet": "enc1.0.weight", "swinunet": "patch_embed.proj.weight"}


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
    head (`final` / `out_conv` / `output`), the UNet's width from enc1's
    output channels, the PK maps from the pk_fusion convs
    (STF-LSTM-UNet) or from the first layer's input channels, T + 3
    (UNet's enc1, Swin-UNet's patch embedding). Crop size, base size, mean,
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
    if model_name in _STEMS:
        width, in_ch = (int(n) for n in sd[_STEMS[model_name]].shape[:2])
        pk_channels = in_ch - time_steps
        weights_pk = pk_channels > 0
        if model_name == "unet" and base_c is None:
            base_c = width
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
