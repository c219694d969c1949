"""Serving export: the trained model's inference forward as one portable
artifact, weights included (counterpart of stf_unet_tpu/cli/export.py,
which writes StableHLO through jax.export).

Usage: python -m stf_unet_tpu_torch.cli.export --model stflstm
       --model-dir ./save_weights --output model.pt2
       [--crop-size 224] [--batch 0 (symbolic)] [--check]
       [--device cuda|cpu] [--allow-random-weights]

The artifact is a torch.export ExportedProgram saved with
torch.export.save: x [B, T(+3), H, W, 1] float32 -> logits [B, H, W,
num_classes] float32, the JAX export's contract, loadable with
`torch.export.load(path).module()(x)` without this package. `--batch 0`
makes B symbolic (torch.export.Dim "b"). The weights are the best (else
latest) checkpoint of --model-dir (its EMA copy where it has one), on
--device; an artifact exported on the GPU runs there.

The pixel LSTMs run their plain PyTorch version ("scan",
set_lstm_backend), as the JAX export runs its scan backend: the port's
kernels are ctypes launches that an exported graph cannot hold, and the
artifact must run where this package is not installed. This is the
exporter's choice, recorded as "lstm_backend" in the `<output>.json`
sidecar (the JAX sidecar's keys), not a fallback. ops/conv's int8
intercept and spatial row plan are context variables read while the
forward is traced (non-strict export), so outside those contexts every
convolution exports as its aten op.

--check reloads the artifact and holds it to the eager model (the same
plain path) on seeded inputs: max |difference| < 1e-5.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from stf_unet_tpu_torch.cli.common import (checkpoint_path,
                                           restore_for_inference,
                                           set_precision_policy)
from stf_unet_tpu_torch.core.config import (DataConfig, ModelConfig,
                                            resolve_device)
from stf_unet_tpu_torch.models.registry import (create_model,
                                                preprocess_input)

CHECK_TOL = 1e-5
MAX_GRID = 65535


class InferenceForward(nn.Module):
    """x [B, T(+pk), H, W, 1] float32 -> logits [B, H, W, classes]."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(preprocess_input(x, self.model))["out"]


def build_inference_fn(model: nn.Module) -> InferenceForward:
    """The exported forward of `model`, in eval mode, its pixel LSTMs on
    the plain path."""
    if hasattr(model, "set_lstm_backend"):
        model.set_lstm_backend("scan")
    return InferenceForward(model).eval()


def export_model(args: argparse.Namespace) -> str:
    device = resolve_device(args.device)
    data_cfg = DataConfig(use_subtraction=args.use_subtraction,
                          use_pk_maps=args.use_pk_maps)
    seqs = data_cfg.resolved_sequence_types
    t_total = len(seqs) + (3 if args.use_pk_maps else 0)
    s = args.crop_size
    try:
        path = checkpoint_path(args.model_dir, args.model, args.use_pk_maps)
    except FileNotFoundError:
        if not args.allow_random_weights:
            raise FileNotFoundError(
                f"no checkpoint in {args.model_dir}; pass "
                f"--allow-random-weights to export an untrained model")
        print("warning: exporting RANDOM weights (no checkpoint found)")
        set_precision_policy()
        torch.manual_seed(0)
        model = create_model(ModelConfig(
            model=args.model, num_classes=args.num_classes - 1,
            time_steps=len(seqs), use_pk_maps=args.use_pk_maps,
            base_c=args.base_c)).eval().to(device)
    else:
        model, _, _, _ = restore_for_inference(
            args.model, path, use_subtraction=args.use_subtraction,
            use_pk_maps=args.use_pk_maps, num_classes=args.num_classes,
            base_c=args.base_c, dtype="f32", device=device)
        print(f"exporting weights from {path}")
    forward = build_inference_fn(model)

    example = torch.zeros((args.batch if args.batch > 0 else 2, t_total, s,
                           s, 1), dtype=torch.float32, device=device)
    # CUDA's 65,535-block grid dimension bounds ops of the folded B*T
    # frames: the symbolic batch goes up to 65535 // T
    dynamic = ({"x": {0: torch.export.Dim("b", min=1,
                                          max=MAX_GRID // t_total)}}
               if args.batch <= 0 else None)
    with torch.no_grad():
        exported = torch.export.export(forward, (example,),
                                       dynamic_shapes=dynamic, strict=False)
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    torch.export.save(exported, args.output)
    size = os.path.getsize(args.output)
    meta = {
        "model": args.model,
        "input": f"[{'b' if args.batch <= 0 else args.batch}, {t_total}, "
                 f"{s}, {s}, 1] float32",
        "output_classes": args.num_classes,
        "platforms": [device.type],
        "use_pk_maps": args.use_pk_maps,
        "lstm_backend": "scan",
        "bytes": size,
    }
    with open(args.output + ".json", "w") as f:
        json.dump(meta, f, indent=2)
    print(f"wrote {args.output} ({size / 1e6:.1f} MB) for {device.type}")

    if args.check:
        restored = torch.export.load(args.output).module()
        rng = np.random.default_rng(0)
        check_b = args.batch if args.batch > 0 else 2
        x = torch.from_numpy(rng.normal(size=(check_b, t_total, s, s, 1))
                             .astype(np.float32)).to(device)
        with torch.no_grad():
            got = restored(x)
            want = forward(x)
        err = float((got - want).abs().max())
        print(f"roundtrip max|diff| = {err:.2e}")
        if not err < CHECK_TOL:
            raise AssertionError("exported artifact diverges from the live "
                                 f"model: max|diff| {err:.2e}")
    return args.output


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", type=str, default="stflstm",
                    choices=["stflstm", "unet"])
    ap.add_argument("--model-dir", type=str, default="./save_weights")
    ap.add_argument("--output", type=str, default="./model.pt2")
    ap.add_argument("--crop-size", type=int, default=224)
    ap.add_argument("--batch", type=int, default=0,
                    help="fixed batch size; 0 = symbolic (any batch)")
    ap.add_argument("--num-classes", type=int, default=2)
    ap.add_argument("--base-c", type=int, default=64)
    ap.add_argument("--use-subtraction", action="store_true")
    ap.add_argument("--use-pk-maps", action="store_true")
    ap.add_argument("--allow-random-weights", action="store_true")
    ap.add_argument("--check", action="store_true",
                    help="reload the artifact and verify it against the "
                         "live model")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device; 'cpu' only when asked for")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> str:
    return export_model(parse_args(argv))


if __name__ == "__main__":
    main()
