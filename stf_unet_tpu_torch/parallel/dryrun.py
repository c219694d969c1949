"""A dry run of the data-parallel training step (counterpart of the JAX
package's `__graft_entry__.dryrun_multichip`).

    python -m stf_unet_tpu_torch.parallel.dryrun [N] [--device cuda|cpu]

spawns N ranks (default 2), rank r on cuda:r joined over NCCL (N beyond
the visible GPUs raises), or N gloo ranks on the CPU with --device cpu,
and runs the FULL step once at tiny shapes on each: the global batch's
draws warped for the rank's rows, the STF-LSTM-UNet forward and backward
through DDP with synced BN, the AdamW apply and the EMA update; then an
evaluation of each rank's rows with the metrics summed over the ranks.
Rank 0's numbers come back (and print): the global loss, the lr, the
confusion matrix and dice, which every rank agrees on.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from stf_unet_tpu_torch.core import distributed
from stf_unet_tpu_torch.core import mesh as mesh_lib


def dryrun_multichip(n_devices: int = 2, device: str = "cuda") -> dict:
    """One full training step and one sharded evaluation over `n_devices`
    spawned ranks (one GPU each, or gloo ranks on the CPU for
    device="cpu"); rank 0's {"loss", "lr", "dice", "confusion", "world"}.
    Raises if there are fewer GPUs than ranks, a rank fails or a number
    is not finite."""
    world = mesh_lib.data_world(n_devices, device)
    return distributed.spawn_group(_dryrun_rank, world, device)


def _dryrun_rank(group) -> dict:
    from stf_unet_tpu_torch.core.config import (DataConfig, ModelConfig,
                                                OptimConfig)
    from stf_unet_tpu_torch.core.prng import augment_generator
    from stf_unet_tpu_torch.data.transforms import TrainAugment
    from stf_unet_tpu_torch.models.registry import create_model
    from stf_unet_tpu_torch.train.loop import (DeviceBatch, evaluate,
                                               train_step)
    from stf_unet_tpu_torch.train.schedule import warmup_poly_schedule
    from stf_unet_tpu_torch.train.state import (TrainState, data_parallel,
                                                ema_copy, make_optimizer)

    dev = group.device
    t_steps, canvas = 4, 40
    data_cfg = DataConfig(base_size=canvas, crop_size=32)
    model_cfg = ModelConfig(model="stflstm", num_classes=1,
                            time_steps=t_steps)
    torch.manual_seed(0)
    model = create_model(model_cfg).to(dev)
    ddp = data_parallel(model, group)
    state = TrainState(model, make_optimizer(OptimConfig(), model, dev),
                       ema=ema_copy(model), ema_decay=0.99, group=group,
                       ddp=ddp)

    rng = np.random.default_rng(0)  # the global batch, one sample a rank
    batch = group.world
    frames = rng.integers(0, 256, (batch, t_steps, canvas, canvas),
                          dtype=np.uint8)
    masks = (rng.random((batch, canvas, canvas)) > 0.7).astype(np.uint8)
    mine = slice(group.rank, group.rank + 1)
    inputs = DeviceBatch(torch.from_numpy(frames[mine]).to(dev),
                         torch.from_numpy(masks[mine]).to(dev), None,
                         np.full((1, 2), canvas, np.int32))
    loss, lr = train_step(state, TrainAugment(data_cfg, group.rank,
                                              group.world),
                          inputs, augment_generator(0, 0, 0),
                          warmup_poly_schedule(1e-3, 4, 2),
                          model_cfg.total_classes, dev)
    loss = float(loss)
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss: {loss}")
    images = frames[mine, :, 4:36, 4:36, None]
    targets = masks[mine, 4:36, 4:36]
    with state.ema_weights():
        metrics = evaluate(model, [(images, targets)],
                           model_cfg.total_classes, data_cfg=data_cfg,
                           device=dev, reduce_across_processes=True)
    return {"loss": loss, "lr": lr, "dice": metrics["dice"],
            "confusion": metrics["confusion_matrix"].tolist(),
            "world": group.world}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="one data-parallel training "
                                 "step over N ranks at tiny shapes")
    ap.add_argument("n", type=int, nargs="?", default=2,
                    help="ranks (0 = every visible GPU)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (rank r on cuda:r, NCCL) or cpu (gloo); "
                         "the CPU only when asked for")
    args = ap.parse_args()
    print(json.dumps(dryrun_multichip(args.n, args.device)))
