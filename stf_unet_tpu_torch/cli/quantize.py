"""Post-training int8 quantization command (counterpart of
stf_unet_tpu/cli/quantize.py).

Usage: python -m stf_unet_tpu_torch.cli.quantize --model unet
           --model-dir ./save_weights --root <BreaDM root>
           [--use-subtraction] [--use-pk-maps]
           [--calib-split train] [--calib-samples 32] [--batch-size 4]
           [--eval-split val] [--no-eval] [--threshold-sweep]
           [--exclude name1,name2] [--dtype bf16|f32] [--device cuda]

Calibrates static per-conv activation scales on `--calib-samples` images
from `--calib-split` (the exact normalized inputs the serving forward
sees), writes the scales sidecar next to the checkpoint it restored (the
best, else the latest of `--model-dir`: `<model>_best_model<_pk>.
quant_scales.json`, ops/quant.scales_path_for), then - unless --no-eval -
runs the eval split through BOTH the float and the int8 forwards and
reports the dice / mIoU delta, so the accuracy cost of int8 serving is a
printed number, not a guess. `--exclude` names convs (the port's module
names, e.g. `final`) that stay float; it is applied before saving.

`cli/serve.py --dtype int8` consumes the scales file.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from stf_unet_tpu_torch.cli.common import (DTYPES, checkpoint_path,
                                           restore_for_inference)
from stf_unet_tpu_torch.data.index import DatasetIndex
from stf_unet_tpu_torch.data.transforms import normalize
from stf_unet_tpu_torch.models.registry import preprocess_input
from stf_unet_tpu_torch.ops import quant
from stf_unet_tpu_torch.train.loop import eval_batches_from_index, evaluate


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="STF-UNet int8 post-training quantization (PyTorch "
                    "port)")
    p.add_argument("--model", type=str, default="unet",
                   choices=["unet", "stflstm", "swinunet"])
    p.add_argument("--model-dir", type=str, default="./save_weights")
    p.add_argument("--root", type=str, default="./BreaDM")
    p.add_argument("--use-subtraction", action="store_true")
    p.add_argument("--use-pk-maps", action="store_true")
    p.add_argument("--calib-split", type=str, default="train",
                   choices=["train", "val", "test"],
                   help="split providing calibration images (default "
                        "train)")
    p.add_argument("--calib-samples", type=int, default=32,
                   help="number of calibration images (default 32)")
    p.add_argument("--batch-size", type=int, default=4,
                   help="calibration and evaluation batch size")
    p.add_argument("--eval-split", type=str, default="val",
                   choices=["train", "val", "test"],
                   help="split for the float-vs-int8 accuracy report")
    p.add_argument("--no-eval", action="store_true",
                   help="skip the accuracy report (calibrate + save only)")
    p.add_argument("--threshold-sweep", action="store_true",
                   help="also sweep the foreground-probability operating "
                        "point for BOTH forwards and report the int8 "
                        "shift of the best threshold / best dice "
                        "(binary models only)")
    p.add_argument("--exclude", type=str, default="",
                   help="comma-separated conv module names to keep in "
                        "float (e.g. final; default: quantize all)")
    p.add_argument("--dtype", type=str, default="bf16",
                   choices=sorted(DTYPES),
                   help="compute dtype for calibration AND the accuracy "
                        "report (default bf16 - cli/serve's default, so "
                        "the printed delta is serve-bf16 vs serve-int8)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' only when asked for")
    args = p.parse_args(argv)
    try:
        quant.require_int8_model(args.model)
    except ValueError as e:
        p.error(str(e))
    return args


def _best_point(metrics: dict) -> dict:
    """The max-dice operating point of a binary model's collected
    outputs."""
    from stf_unet_tpu_torch.metrics.binary import ThresholdSweep

    sweep = ThresholdSweep()
    for logits, (_, target) in zip(metrics["outputs"], metrics["batches"]):
        z = np.asarray(logits, np.float64)
        sweep.update(1.0 / (1.0 + np.exp(z[..., 0] - z[..., 1])),
                     np.asarray(target))
    return sweep.report()["best"]


def quantize(args: argparse.Namespace) -> dict:
    path = checkpoint_path(args.model_dir, args.model, args.use_pk_maps)
    model, data_cfg, model_cfg, meta = restore_for_inference(
        args.model, path, use_subtraction=args.use_subtraction,
        use_pk_maps=args.use_pk_maps, dtype=args.dtype, device=args.device)
    device = torch.device(args.device)
    num_classes = model_cfg.total_classes
    use_pk = model_cfg.use_pk_maps
    seq_types = data_cfg.resolved_sequence_types
    print(f"model_path: {path}")

    calib_index = DatasetIndex(args.root, args.calib_split, seq_types,
                               use_pk_maps=use_pk)

    def calib_inputs():
        taken = 0
        for img_u8, _ in eval_batches_from_index(
                calib_index, data_cfg, use_pk_maps=use_pk,
                batch_size=args.batch_size):
            x = normalize(torch.from_numpy(img_u8).to(device),
                          data_cfg.mean, data_cfg.std)
            yield preprocess_input(x, model)
            taken += img_u8.shape[0]
            if taken >= args.calib_samples:
                return

    print(f"calibrating on up to {args.calib_samples} images from "
          f"'{args.calib_split}'...")
    scales = quant.calibrate(model, calib_inputs())
    print(f"calibrated {len(scales)} convs "
          f"(activation absmax {min(scales.values()):.3g}"
          f"..{max(scales.values()):.3g})")

    # --exclude goes before saving: the saved file is exactly what
    # cli/serve --dtype int8 quantizes, so the delta printed below
    # describes the network that will serve.
    exclude = tuple(p for p in args.exclude.split(",") if p)
    unknown = [p for p in exclude if p not in scales]
    if unknown:
        raise SystemExit(f"error: --exclude names not found among "
                         f"calibrated convs: {unknown}; known names: "
                         f"{sorted(scales)}")
    scales = {k: v for k, v in scales.items() if k not in exclude}
    if exclude:
        print(f"excluded {len(exclude)} convs from quantization (kept "
              "float): " + ", ".join(exclude))

    scales_path = quant.scales_path_for(path)
    quant.save_scales(scales_path, scales, checkpoint_meta=meta)
    print(f"scales -> {scales_path}")

    result = {"scales_path": scales_path, "num_convs": len(scales)}
    if args.no_eval:
        return result

    qmodel = quant.QuantizedModel(model, scales)
    eval_index = DatasetIndex(args.root, args.eval_split, seq_types,
                              use_pk_maps=use_pk)
    sweep_wanted = args.threshold_sweep
    if sweep_wanted and num_classes != 2:
        print("note: --threshold-sweep needs a binary model (2 total "
              "classes); skipping the operating-point shift")
        sweep_wanted = False

    def run(m):
        return evaluate(m, eval_batches_from_index(
            eval_index, data_cfg, use_pk_maps=use_pk,
            batch_size=args.batch_size), num_classes, data_cfg=data_cfg,
            device=device, collect_outputs=sweep_wanted)

    print(f"evaluating float model on '{args.eval_split}'...")
    ref = run(model)
    print(f"evaluating int8 model on '{args.eval_split}'...")
    q = run(qmodel)

    d_dice = q["dice"] - ref["dice"]
    d_miou = q["mean_metrics"]["miou"] - ref["mean_metrics"]["miou"]
    print(f"float dice {ref['dice']:.4f}  int8 dice {q['dice']:.4f}  "
          f"delta {d_dice:+.4f}")
    print(f"float mIoU {ref['mean_metrics']['miou']:.4f}  "
          f"int8 mIoU {q['mean_metrics']['miou']:.4f}  delta {d_miou:+.4f}")
    result.update(dice_float=ref["dice"], dice_int8=q["dice"],
                  dice_delta=d_dice, miou_delta=d_miou)

    if sweep_wanted:
        # The argmax dice above is the threshold-0.5 point; quantization
        # can move the optimal threshold, which a single delta hides.
        bf, bq = _best_point(ref), _best_point(q)
        print(f"operating point: float best dice {bf['dice']:.4f} @ "
              f"{bf['threshold']:.2f}  int8 best dice {bq['dice']:.4f} @ "
              f"{bq['threshold']:.2f}  (threshold shift "
              f"{bq['threshold'] - bf['threshold']:+.2f}, best-dice delta "
              f"{bq['dice'] - bf['dice']:+.4f})")
        result.update(best_float=bf, best_int8=bq)
    return result


def main(argv: Optional[Sequence[str]] = None) -> dict:
    return quantize(parse_args(argv))


if __name__ == "__main__":
    main()
