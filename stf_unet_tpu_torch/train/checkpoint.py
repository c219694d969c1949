"""Checkpoints with the reference's latest/best policy (counterpart of
stf_unet_tpu/train/checkpoint.py; ref:train.py:304-329, resume 249-256).

`<save_dir>/<model>_{latest,best}_model<suffix>.pth` (or `_epoch<N>_`
without --save-best) holds one torch pickle:

    {"model": state_dict in the reference layout, "optimizer": AdamW
     state_dict, "epoch", "step", "best_dice", "config" (JSON), "seed"}

which is the reference's own format: cli/serve (`--weights`) and the JAX
package's `cli/migrate.py` read it as it is. With EMA on it also holds
"ema" (parameter name -> the EMA weights; the inference restores pick
them, cli/common.restore_for_inference); a step-exact preemption save
holds "step_in_epoch" (train/preempt.py), and under --grad-accum, when it
falls inside an accumulation window, "accum_grads" (the window's summed
gradients, as the JAX save carries optax.MultiSteps' state). Every value
is a tensor or a plain Python value, so it loads with
torch.load(weights_only=True).

Under data parallelism (the state's group) every rank calls save at the
same point: rank 0 alone writes, then all wait at a barrier, so no rank
reads a checkpoint before it exists; every rank restores the same file.
The ranks' parameters, optimizer state and EMA are equal; a window's
summed gradients are each rank's own (its micro-steps run under
no_sync), so "accum_grads" then holds one dict per rank, in rank order.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from stf_unet_tpu_torch.core import mesh as mesh_lib
from stf_unet_tpu_torch.train.state import TrainState


def checkpoint_file(save_dir: str, model_name: str, kind: str,
                    tag_suffix: str = "") -> str:
    """`<save_dir>/<model>_<kind>_model<suffix>.pth`."""
    return os.path.join(save_dir, f"{model_name.lower()}_{kind}_model"
                                  f"{tag_suffix}.pth")


class CheckpointManager:
    def __init__(self, save_dir: str, model_name: str, tag_suffix: str = ""):
        self.save_dir = os.path.abspath(save_dir)
        self.model_name = model_name.lower()
        self.tag_suffix = tag_suffix
        os.makedirs(self.save_dir, exist_ok=True)

    def path(self, kind: str) -> str:
        """kind: "latest", "best" or "epoch<N>"; an existing file path is
        returned as it is."""
        if os.path.isfile(kind):
            return kind
        return checkpoint_file(self.save_dir, self.model_name, kind,
                               self.tag_suffix)

    def exists(self, kind: str) -> bool:
        return os.path.isfile(self.path(kind))

    def save(self, kind: str, state: TrainState, *, epoch: int,
             best_dice: float, config_json: str = "", seed: int = 0,
             step_in_epoch: Optional[int] = None) -> str:
        """Write atomically (a temporary file, then a rename), so a run
        killed mid-write leaves the previous checkpoint intact.
        step_in_epoch marks a mid-epoch (preemption) save: resume
        re-enters `epoch` at that step."""
        path = self.path(kind)
        group = state.group
        grads = state.accumulated_grads()
        if group is not None and group.world > 1:
            ranks = mesh_lib.gather_objects(group, grads)
            grads = None if ranks[0] is None else ranks
        if group is not None and not group.is_main:
            mesh_lib.barrier(group)
            return path
        payload = {
            "model": {k: v.detach().cpu()
                      for k, v in state.model.state_dict().items()},
            "optimizer": state.optimizer.state_dict(),
            "epoch": int(epoch), "step": int(state.step),
            "best_dice": float(best_dice), "config": config_json,
            "seed": int(seed),
        }
        if state.ema is not None:
            payload["ema"] = {k: v.detach().cpu()
                              for k, v in state.ema.items()}
        if grads is not None:
            payload["accum_grads"] = grads
        if step_in_epoch is not None:
            payload["step_in_epoch"] = int(step_in_epoch)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        mesh_lib.barrier(group)
        return path

    def load(self, kind: str) -> Dict[str, Any]:
        return torch.load(self.path(kind), map_location="cpu",
                          weights_only=True)

    def restore(self, kind: str, state: TrainState) -> Dict[str, Any]:
        """Load model, optimizer, EMA and any partly accumulated gradients
        into `state` (in place) and set its step; returns the checkpoint's
        metadata."""
        ckpt = self.load(kind)
        state.model.load_state_dict(ckpt["model"], strict=True)
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = int(ckpt["step"])
        if state.ema is not None:
            dev = next(state.model.parameters()).device
            state.ema = {k: v.to(dev) for k, v in ckpt["ema"].items()}
        if "accum_grads" in ckpt:
            grads = ckpt["accum_grads"]
            world = state.group.world if state.group is not None else 1
            ranks = len(grads) if isinstance(grads, list) else 1
            if ranks != world:
                raise ValueError(
                    f"checkpoint stopped inside an accumulation window of "
                    f"{ranks} rank(s); resume it with {ranks} rank(s), not "
                    f"{world}")
            if isinstance(grads, list):
                grads = grads[state.group.rank]
            state.load_accumulated_grads(grads)
        return {k: v for k, v in ckpt.items()
                if k not in ("model", "optimizer", "ema", "accum_grads")}
