"""Standalone inference entry point (counterpart of stf_unet_tpu/cli/test.py;
ref:test.py:137-196).

Usage: python -m stf_unet_tpu_torch.cli.test --model unet
       --model-dir ./save_weights --root <BreaDM root>
       [--output-dir ./output/test_results] [--use-subtraction]
       [--use-pk-maps] [--num-classes 2] [--base-c 64] [--crop-size 224]
       [--pred-mode argmax|sigmoid] [--tiled [--tile-overlap 0.5]]
       [--tta] [--per-patient] [--surface-metrics] [--threshold-sweep]
       [--data-pack <pack root>] [--dtype f32|bf16] [--device cuda|cpu]
       [--data-parallel N]

Loads the best (else latest) checkpoint of `--model-dir`
(`<model>_{best,latest}_model<_pk>.pth`, as cli/train writes them), runs
test-set inference with overlay renders, then prints the eval metrics.
Prediction is argmax; `--pred-mode sigmoid` renders the reference's
binary path (sigmoid > 0.5 on channel 0, ref:test.py:161-172). The eval
metrics are argmax-based in both modes, as the reference's evaluate() is
(ref:train_and_eval.py:331). Architecture and data settings come from the
checkpoint (cli/common.restore_for_inference); explicit flags win.

`--data-parallel N` (0 = every visible GPU) spawns N processes joined by
a process group (core/distributed.spawn_group), one device each: every
rank restores the checkpoint and evaluates its shard of the test records
(records[rank::N]) at any batch size, the metrics are summed over the
ranks, and rank 0 gathers the outputs in record order
(train/loop.gather_eval_outputs) and writes the renders and reports.
With --tiled the same: each rank runs the tiled predictor over its
records, the confusion and dice are summed over the ranks, and rank 0
gathers every record's mask and writes the renders and the per-patient
report in record order.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from stf_unet_tpu_torch.cli.common import (DTYPES, checkpoint_path,
                                           restore_for_inference)
from stf_unet_tpu_torch.core import distributed
from stf_unet_tpu_torch.core import mesh as mesh_lib
from stf_unet_tpu_torch.core.config import resolve_device
from stf_unet_tpu_torch.data.index import DatasetIndex
from stf_unet_tpu_torch.train.loop import (eval_batches_from_index,
                                           evaluate, gather_eval_outputs)
from stf_unet_tpu_torch.viz.overlay import save_overlay


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="STF-UNet inference (PyTorch "
                                "port)")
    p.add_argument("--model", type=str, default="unet",
                   choices=["unet", "stflstm", "swinunet"])
    p.add_argument("--model-dir", type=str, default="./save_weights")
    p.add_argument("--root", type=str, default="./BreaDM")
    p.add_argument("--output-dir", type=str, default="./output/test_results")
    p.add_argument("--use-subtraction", action="store_true")
    p.add_argument("--use-pk-maps", action="store_true")
    # None = from the checkpoint (its weights and training config), else
    # the reference defaults.
    p.add_argument("--num-classes", type=int, default=None,
                   help="TOTAL classes incl. background; default: from the "
                        "checkpoint's head")
    p.add_argument("--base-c", type=int, default=None,
                   help="UNet width; default: from the checkpoint")
    p.add_argument("--crop-size", type=int, default=None,
                   help="eval short-edge size; default: from the "
                        "checkpoint's config")
    p.add_argument("--mask-format", type=str, default=None,
                   choices=["binary", "index"],
                   help="mask pixel encoding: binary (//255) or index; "
                        "default: from the checkpoint's config")
    p.add_argument("--pred-mode", type=str, default="argmax",
                   choices=["argmax", "sigmoid"],
                   help="prediction for the saved overlays: argmax, or the "
                        "reference's sigmoid(logits[..., 0]) > 0.5")
    p.add_argument("--tiled", action="store_true",
                   help="segment at native resolution with sliding-window "
                        "tiles at the trained crop (serve/tiled); metrics "
                        "against the native-resolution masks")
    p.add_argument("--tile-overlap", type=float, default=0.5,
                   help="tile overlap fraction for --tiled (default 0.5)")
    p.add_argument("--batch-size", type=int, default=1,
                   help="eval batch size (same-shape samples grouped; the "
                        "reference evaluates at 1)")
    p.add_argument("--data-parallel", type=int, default=1,
                   help="shard the test records over N processes, one "
                        "device each (0 = every visible GPU; identical "
                        "metrics and reports)")
    p.add_argument("--tta", action="store_true",
                   help="flip test-time augmentation: average logits over "
                        "{id, hflip, vflip, hvflip} (ops/tta.py; composes "
                        "with --tiled)")
    p.add_argument("--data-pack", type=str, default="",
                   help="dataset pack root (cli/pack): serve pre-decoded "
                        "samples by memmap instead of decoding images")
    p.add_argument("--per-patient", action="store_true",
                   help="aggregate metrics per patient (mean/std/median "
                        "dice across patients). Requires --batch-size 1.")
    p.add_argument("--surface-metrics", action="store_true",
                   help="HD95 + ASSD per patient, pixel units; implies "
                        "--per-patient")
    p.add_argument("--threshold-sweep", action="store_true",
                   help="binary only: dice/IoU/precision/recall at "
                        "foreground-probability thresholds 0.05..0.95 plus "
                        "ROC/PR AUC")
    p.add_argument("--dtype", type=str, default="f32",
                   choices=sorted(DTYPES),
                   help="compute dtype (parameters stay float32)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' only when asked for")
    return p.parse_args(argv)


def predict_mask(logits: np.ndarray, mode: str = "argmax") -> np.ndarray:
    """[H, W, C] logits -> [H, W] int mask: argmax, or the reference's
    binary path sigmoid(logits) > 0.5 on channel 0 (ref:test.py:161-172)."""
    if mode == "sigmoid":
        probs = 1.0 / (1.0 + np.exp(-np.asarray(logits, np.float32)))
        return (probs[..., 0] > 0.5).astype(np.int32)
    return np.argmax(logits, axis=-1)


def test(args: argparse.Namespace, group=None) -> dict:
    """The test pass, in this process or (--data-parallel) as one rank
    of `group`; a spawned group returns rank 0's metrics. They carry
    "seconds": {"restore": checkpoint to model on the device, "test": the
    pass itself}."""
    if group is None and args.data_parallel != 1:
        world = mesh_lib.data_world(args.data_parallel,
                                    resolve_device(args.device))
        if world > 1:
            return distributed.spawn_group(test, world, args.device, args)
    is_main = group is None or group.is_main
    device = group.device if group is not None else torch.device(
        args.device)
    t0 = time.perf_counter()
    path = checkpoint_path(args.model_dir, args.model, args.use_pk_maps)
    model, data_cfg, model_cfg, _ = restore_for_inference(
        args.model, path, use_subtraction=args.use_subtraction,
        use_pk_maps=args.use_pk_maps, num_classes=args.num_classes,
        base_c=args.base_c, crop_size=args.crop_size,
        mask_format=args.mask_format, dtype=args.dtype, device=device)
    num_classes = model_cfg.total_classes
    use_pk = model_cfg.use_pk_maps
    print(f"model_path: {path}")
    restore_s = time.perf_counter() - t0

    test_index = DatasetIndex(args.root, "test",
                              data_cfg.resolved_sequence_types,
                              use_pk_maps=use_pk)
    pack = None
    if args.data_pack:
        from stf_unet_tpu_torch.data.pack import open_split_pack
        pack = open_split_pack(args.data_pack, "test")
        pack.validate(test_index, mask_format=data_cfg.mask_format,
                      use_pk_maps=use_pk)
        print(f"dataset pack [test]: {len(pack)} samples (decode-free)")
    if args.tta:
        from stf_unet_tpu_torch.ops.tta import FlipTTAModel
        model = FlipTTAModel(model).eval()
        print("flip TTA: logits averaged over 4 orientations")

    per_patient = args.per_patient or args.surface_metrics
    if per_patient and not args.tiled and args.batch_size != 1:
        raise SystemExit("--per-patient/--surface-metrics need "
                         "--batch-size 1 (shape-bucketed batching reorders "
                         "samples relative to the dataset records)")
    if args.threshold_sweep and (num_classes != 2 or args.tiled):
        raise SystemExit("--threshold-sweep needs the binary (2-class) "
                         "non-tiled path: it sweeps the foreground "
                         "probability, and the tiled predictor emits "
                         "argmax masks only")

    if group is not None:
        print(f"test records sharded over {group.world} ranks"
              + (" (tiled)" if args.tiled else ""))
    if args.tiled:
        metrics = _test_tiled(args, model, data_cfg, num_classes,
                              test_index, device, pack, group)
        if is_main:
            metrics["seconds"] = {
                "restore": restore_s,
                "test": time.perf_counter() - t0 - restore_s}
        return metrics

    print("Running inference on test set...")
    shard = ({"host_index": group.rank, "num_hosts": group.world}
             if group is not None else {})
    metrics = evaluate(
        model, eval_batches_from_index(test_index, data_cfg,
                                       use_pk_maps=use_pk,
                                       batch_size=args.batch_size,
                                       pack=pack, **shard),
        num_classes, data_cfg=data_cfg, device=device, collect_outputs=True,
        reduce_across_processes=group is not None)
    if group is not None:
        metrics = gather_eval_outputs(group, metrics)
    if not is_main:  # rank 0 writes the renders and reports
        return metrics

    os.makedirs(args.output_dir, exist_ok=True)
    idx = 0
    for logits, (image, _) in zip(metrics["outputs"], metrics["batches"]):
        for j in range(logits.shape[0]):
            pred = predict_mask(logits[j], args.pred_mode)
            save_overlay(pred, image[j, 0, :, :, 0], args.output_dir, idx,
                         prefix=args.model)
            idx += 1

    if per_patient:
        metrics["patient_report"] = _per_patient_report(
            test_index, metrics["outputs"], metrics["batches"], num_classes,
            surface=args.surface_metrics)
        _dump_json(metrics["patient_report"],
                   os.path.join(args.output_dir, "patient_report.json"))

    if args.threshold_sweep:
        from stf_unet_tpu_torch.metrics.binary import (
            ThresholdSweep, format_threshold_sweep)
        sweep = ThresholdSweep()
        for logits, (_, target) in zip(metrics["outputs"],
                                       metrics["batches"]):
            z = np.asarray(logits, np.float64)
            # stable 2-class softmax foreground probability
            prob_fg = 1.0 / (1.0 + np.exp(z[..., 0] - z[..., 1]))
            sweep.update(prob_fg, np.asarray(target))
        metrics["threshold_sweep"] = sweep.report()
        print("Foreground-probability threshold sweep:")
        print(format_threshold_sweep(metrics["threshold_sweep"]))
        _dump_json(metrics["threshold_sweep"],
                   os.path.join(args.output_dir, "threshold_sweep.json"))

    print("Test Set Metrics:")
    print(metrics["confusion_str"])
    print(f"Dice: {metrics['dice']:.4f}")
    print(f"mIoU: {metrics['mean_metrics']['miou']:.4f}")
    metrics["seconds"] = {"restore": restore_s,
                          "test": time.perf_counter() - t0 - restore_s}
    return metrics


def _dump_json(obj, path: str) -> None:
    """Write a report dict next to the renders (nan -> null, numpy ->
    Python), so the console tables survive as machine-readable files."""

    def clean(x):
        if isinstance(x, dict):
            return {str(k): clean(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [clean(v) for v in x]
        if isinstance(x, (np.floating, float)):
            return None if math.isnan(x) else float(x)
        if isinstance(x, np.integer):
            return int(x)
        return x

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(clean(obj), f, indent=2)
    print(f"wrote {path}")


def _per_patient_report(test_index: DatasetIndex, outputs, batches,
                        num_classes: int, *, surface: bool) -> dict:
    """Per-patient aggregation over the batch-1 eval stream (record order
    is batch order at batch 1; checked). Argmax predictions, as
    evaluate()'s confusion and dice."""
    from stf_unet_tpu_torch.metrics.patient import (PatientAggregator,
                                                    format_patient_report)
    if len(outputs) != len(test_index.records):
        raise RuntimeError(
            f"eval stream yielded {len(outputs)} samples for "
            f"{len(test_index.records)} records — cannot map to patients")
    agg = PatientAggregator(num_classes, surface=surface)
    for rec, logits, (_, target) in zip(test_index.records, outputs,
                                        batches):
        agg.update(rec.patient_id, np.asarray(target[0], np.int32),
                   np.argmax(logits[0], axis=-1))
    report = agg.report()
    print("Per-patient metrics"
          + (" (hd95/assd in pixel units)" if surface else "") + ":")
    print(format_patient_report(report))
    return report


def _test_tiled(args: argparse.Namespace, model, data_cfg,
                num_classes: int, test_index: DatasetIndex,
                device: torch.device, pack=None, group=None) -> dict:
    """Native-resolution test pass: sliding-window tiles at the trained
    crop (serve/tiled.TiledPredictor), metrics against the
    native-resolution masks with evaluate()'s confusion and dice. The
    samples come from the dataset `pack` when one is given. In a group
    each rank predicts records[rank::world]; the sums are reduced over
    the ranks and rank 0 renders and aggregates every record in record
    order (the other ranks return {})."""
    from stf_unet_tpu_torch.data.loader import load_sample_raw_native
    from stf_unet_tpu_torch.metrics.confusion import (confusion_init,
                                                      confusion_report,
                                                      confusion_update,
                                                      format_confusion)
    from stf_unet_tpu_torch.metrics.dice import (eval_dice_update,
                                                 eval_dice_value)
    from stf_unet_tpu_torch.serve.tiled import TiledPredictor

    predictor = TiledPredictor(model, data_cfg.mean, data_cfg.std,
                               tile=data_cfg.crop_size,
                               overlap=args.tile_overlap, device=device)
    conf = confusion_init(num_classes, device)
    dice_cum = torch.zeros((num_classes,), dtype=torch.float32,
                           device=device)
    dice_count = 0
    agg = None
    if args.per_patient or args.surface_metrics:
        from stf_unet_tpu_torch.metrics.patient import PatientAggregator
        agg = PatientAggregator(num_classes, surface=args.surface_metrics)
    print(f"Running tiled native-resolution inference on test set "
          f"(tile={predictor.tile}, stride={predictor.stride})...")
    os.makedirs(args.output_dir, exist_ok=True)

    def emit(idx, mask, pred, frame0):
        raw0 = (frame0.astype(np.float32) / 255.0
                - data_cfg.mean) / data_cfg.std
        save_overlay(pred, raw0, args.output_dir, idx, prefix=args.model)
        if agg is not None:
            agg.update(test_index.records[idx].patient_id,
                       mask.astype(np.int32), pred)

    rank, world = (group.rank, group.world) if group is not None else (0, 1)
    rows = []  # a group's (record index, mask, prediction, frame 0)
    for idx in range(len(test_index.records))[rank::world]:
        rec = test_index.records[idx]
        if pack is not None:  # decode-free native-resolution frames
            frames, mask, pk, _ = pack.sample(
                idx, use_pk_maps=data_cfg.use_pk_maps)
        else:
            frames, mask, pk = load_sample_raw_native(
                rec, use_pk_maps=data_cfg.use_pk_maps,
                mask_format=data_cfg.mask_format)
        img = frames if pk is None else np.concatenate([frames, pk], axis=0)
        pred = predictor.predict(img[..., None])
        pred_t = torch.from_numpy(pred).to(device)[None].long()
        target = torch.from_numpy(mask.astype(np.int64)).to(device)[None]
        conf = confusion_update(conf, target, pred_t)
        # eval_dice_update argmaxes its logits, and argmax(one_hot(pred))
        # is pred, so the mask-level dice is evaluate()'s.
        dice_cum, dice_count = eval_dice_update(
            dice_cum, dice_count,
            F.one_hot(pred_t, num_classes).to(torch.float32), target,
            ignore_index=255)
        if group is None:
            emit(idx, mask, pred, frames[0])
        else:
            rows.append((idx, mask, pred, frames[0]))
    if group is not None:
        sums = torch.tensor([dice_count], dtype=torch.int64, device=device)
        for t in (conf, dice_cum, sums):
            mesh_lib.all_sum(group, t)
        dice_count = int(sums.item())
        parts = mesh_lib.gather_to_main(group, rows)
        if parts is None:
            return {}
        for row in sorted((row for part in parts for row in part),
                          key=lambda row: row[0]):
            emit(*row)

    patient_report = None
    if agg is not None:
        from stf_unet_tpu_torch.metrics.patient import format_patient_report
        patient_report = agg.report()
        print("Per-patient metrics (tiled, native resolution"
              + ("; hd95/assd in pixel units" if args.surface_metrics
                 else "") + "):")
        print(format_patient_report(patient_report))
        _dump_json(patient_report,
                   os.path.join(args.output_dir, "patient_report.json"))

    mat = conf.cpu().numpy()
    report = confusion_report(mat)
    dice = eval_dice_value(dice_cum, dice_count)
    print("Test Set Metrics (tiled, native resolution):")
    print(format_confusion(mat))
    print(f"Dice: {dice:.4f}")
    print(f"mIoU: {report['mean_metrics']['miou']:.4f}")
    return {
        **({"patient_report": patient_report}
           if patient_report is not None else {}),
        "dice": dice,
        "confusion_matrix": mat,
        "confusion_str": format_confusion(mat),
        "global_accuracy": report["global_accuracy"],
        "class_metrics": report["class_metrics"],
        "mean_metrics": report["mean_metrics"],
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    return test(parse_args(argv))


if __name__ == "__main__":
    main()
