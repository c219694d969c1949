"""Checkpoint averaging (counterpart of stf_unet_tpu/cli/average.py):
leafwise-average N saved checkpoints into one inference checkpoint
(stochastic weight averaging over the snapshots `--save-best false`
writes, `<model>_epoch<N>_model.pth`, ref:train.py:317-328).

Usage: python -m stf_unet_tpu_torch.cli.average --model unet
           --save-dir ./save_weights --kinds epoch7,epoch8,epoch9
           [--out-dir ./save_weights/averaged] [--use-pk-maps]

The average is written as the out dir's `best` checkpoint
(`{"model", "epoch", "best_dice", "config"}`), so every inference CLI
(cli/test, cli/serve, cli/quantize, cli/export, cli/val) takes it by
pointing --model-dir at it: the newest epoch, the highest best_dice and
the first config among the inputs. Parameters and the BN running
statistics are averaged leafwise in float32 (averaged running variances
are an approximation: SWA recomputes them with a data pass; run cli/test
on the average before deploying it). Where checkpoints carry EMA
weights, the EMA copy is what is averaged (cli/common.
load_reference_checkpoint swaps it in; it is what inference serves).
Integer buffers (BN's num_batches_tracked, which the JAX package's
checkpoints do not hold) are not averaged: the newest checkpoint's are
kept.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import torch

from stf_unet_tpu_torch.cli.common import load_reference_checkpoint
from stf_unet_tpu_torch.train.checkpoint import checkpoint_file


def average_checkpoints(model: str, save_dir: str, kinds: Sequence[str],
                        out_dir: str, *, use_pk_maps: bool = False) -> str:
    if len(kinds) < 1:
        raise ValueError("need at least one checkpoint kind to average")
    tag = "_pk" if use_pk_maps else ""
    acc, ints, metas, newest = None, None, [], -1
    for kind in kinds:
        path = checkpoint_file(save_dir, model, kind, tag)
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"{model}_{kind}_model{tag} not found in {save_dir}")
        sd, meta = load_reference_checkpoint(path)
        metas.append(meta)
        floats = {k: v.to(torch.float32) for k, v in sd.items()
                  if v.is_floating_point()}
        if acc is None:
            acc = floats
        else:
            if set(floats) != set(acc):
                raise ValueError(f"{path} holds other tensors than "
                                 f"{kinds[0]}'s checkpoint")
            for k, v in floats.items():
                acc[k] += v
        epoch = int(meta.get("epoch", 0))
        if epoch >= newest:  # the newest checkpoint's integer buffers
            newest = epoch
            ints = {k: v for k, v in sd.items() if not v.is_floating_point()}
        print(f"  + {kind} (epoch {meta.get('epoch', '?')})")

    n = float(len(kinds))
    avg = {k: v / n for k, v in acc.items()}
    config = next((m["config"] for m in metas if m.get("config")),
                  json.dumps({"averaged_from": list(kinds)}))
    os.makedirs(out_dir, exist_ok=True)
    path = checkpoint_file(out_dir, model, "best", tag)
    payload = {"model": {**avg, **ints}, "epoch": newest,
               "best_dice": max(float(m.get("best_dice", 0.0))
                                for m in metas),
               "config": config}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    print(f"averaged {len(kinds)} checkpoints -> {path}")
    return path


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", required=True, choices=["unet", "stflstm"])
    ap.add_argument("--save-dir", default="./save_weights")
    ap.add_argument("--kinds", required=True,
                    help="comma-separated checkpoint kinds, e.g. "
                         "'epoch7,epoch8,epoch9' or 'latest,best'")
    ap.add_argument("--out-dir", default=None,
                    help="default: <save-dir>/averaged")
    ap.add_argument("--use-pk-maps", action="store_true")
    a = ap.parse_args(argv)
    out_dir = a.out_dir or os.path.join(a.save_dir, "averaged")
    kinds = [k.strip() for k in a.kinds.split(",") if k.strip()]
    return average_checkpoints(a.model, a.save_dir, kinds, out_dir,
                               use_pk_maps=a.use_pk_maps)


if __name__ == "__main__":
    main()
