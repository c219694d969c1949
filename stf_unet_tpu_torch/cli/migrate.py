"""Move checkpoints between the reference's .pth and the port's
cli/train checkpoint (counterpart of stf_unet_tpu/cli/migrate.py).

Usage: python -m stf_unet_tpu_torch.cli.migrate <ckpt.pth> --model unet
       --save-dir ./save_weights [--kind best] [--num-classes 2]
       [--base-c 64] [--time-steps 8] [--use-pk-maps]
       python -m stf_unet_tpu_torch.cli.migrate <out.pth> --reverse
       --model unet --save-dir ./save_weights [--kind best]

The port's checkpoint already has the reference's layout
(train/checkpoint.py), so neither direction converts a tensor.

Forward: the reference .pth (read by cli/common.load_reference_checkpoint:
{"model": state_dict, ...}, {"state_dict": ...} or a bare state_dict, a
DataParallel `module.` prefix stripped, the reference's `args` Namespace
read as data) is loaded into the configured model with strict=True,
which validates every key and shape, and written as `<save-dir>/<model>_<kind>_model<_pk>.pth`
with its epoch, best_dice 0.0, a fresh AdamW state and the config
{"migrated_from": <path>}. Only the weights migrate: the optimizer state
restarts, as in the JAX package.

--reverse: the port checkpoint `<model>_<kind>_model<_pk>.pth` of
--save-dir becomes {"model": state_dict, "epoch": N[, "best_dice"]}, the
reference's loaders' format (ref:test.py:142-146), with the EMA weights
where the checkpoint carries them (they are what inference serves).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Sequence

import torch

from stf_unet_tpu_torch.cli.common import load_reference_checkpoint
from stf_unet_tpu_torch.core.config import ModelConfig, OptimConfig
from stf_unet_tpu_torch.models.registry import create_model
from stf_unet_tpu_torch.train.checkpoint import (CheckpointManager,
                                                 checkpoint_file)
from stf_unet_tpu_torch.train.state import TrainState, make_optimizer


def migrate(path: str, model: str, save_dir: str, kind: str = "best",
            num_classes: int = 2, base_c: int = 64, time_steps: int = 8,
            use_pk_maps: bool = False) -> str:
    state_dict, meta = load_reference_checkpoint(path)
    cfg = ModelConfig(model=model, num_classes=num_classes - 1,
                      base_c=base_c, time_steps=time_steps,
                      use_pk_maps=use_pk_maps)
    net = create_model(cfg)
    net.load_state_dict(state_dict, strict=True)
    state = TrainState(net, make_optimizer(OptimConfig(), net,
                                           torch.device("cpu")))
    epoch = int(meta.get("epoch", 0))
    ckpt = CheckpointManager(save_dir, model, "_pk" if use_pk_maps else "")
    out = ckpt.save(kind, state, epoch=epoch, best_dice=0.0,
                    config_json=json.dumps({"migrated_from": path}))
    print(f"migrated {path} -> {out}")
    return out


def export_to_torch(output: str, model: str, save_dir: str,
                    kind: str = "best", use_pk_maps: bool = False) -> str:
    """The port checkpoint of `save_dir` as the reference's pickle at
    `output`: {"model": state_dict, "epoch": N[, "best_dice"]}, the EMA
    weights where the checkpoint has them."""
    path = checkpoint_file(save_dir, model, kind,
                           "_pk" if use_pk_maps else "")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{model}_{kind}_model not found in "
                                f"{save_dir}")
    sd, meta = load_reference_checkpoint(path)
    payload: Dict = {"model": sd, "epoch": int(meta.get("epoch", 0))}
    if "best_dice" in meta:
        payload["best_dice"] = float(meta["best_dice"])
    d = os.path.dirname(os.path.abspath(output))
    os.makedirs(d, exist_ok=True)
    torch.save(payload, output)
    print(f"exported {path} -> {output} ({len(sd)} tensors, reference "
          "torch layout)")
    return output


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint",
                    help="source .pth (forward) or OUTPUT .pth (--reverse)")
    ap.add_argument("--model", required=True, choices=["unet", "stflstm"])
    ap.add_argument("--save-dir", default="./save_weights")
    ap.add_argument("--kind", default="best")
    ap.add_argument("--num-classes", type=int, default=2)
    ap.add_argument("--base-c", type=int, default=64)
    ap.add_argument("--time-steps", type=int, default=8)
    ap.add_argument("--use-pk-maps", action="store_true")
    ap.add_argument("--reverse", action="store_true",
                    help="write the port checkpoint in --save-dir as a "
                         "reference-layout .pth at CHECKPOINT")
    a = ap.parse_args(argv)
    if a.reverse:
        return export_to_torch(a.checkpoint, a.model, a.save_dir, a.kind,
                               a.use_pk_maps)
    return migrate(a.checkpoint, a.model, a.save_dir, a.kind, a.num_classes,
                   a.base_c, a.time_steps, a.use_pk_maps)


if __name__ == "__main__":
    main()
