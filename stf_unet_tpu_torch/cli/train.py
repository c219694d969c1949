"""Training entry point (counterpart of stf_unet_tpu/cli/train.py;
ref:train.py:124-401).

    python -m stf_unet_tpu_torch.cli.train --data-path <BreaDM root> \\
        [--model stflstm|unet [--model-base-c 64]] [--amp true] \\
        [--batch-size 16] [--epochs 100] \\
        [--use-subtraction --use-pk-maps [--generate-pk-maps]] \\
        [--device cuda|cpu] [--resume latest [--test-only]] ...

Optional PK map fitting (--generate-pk-maps, pk/maps.py) -> dataset
index -> model, AdamW and the warmup-poly schedule -> optional
resume -> epochs of (train, evaluate, results file, latest/best
checkpoints, early stop; none with --test-only) -> a test-set pass with
the best weights that prints its metrics and writes one
original / ground truth / prediction render per test slice to
<output_dir>/test_results<_pk>. One device; CUDA unless --device cpu.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from stf_unet_tpu_torch.core import config as config_lib
from stf_unet_tpu_torch.core.config import TrainConfig, resolve_device
from stf_unet_tpu_torch.core.prng import STREAM_INIT, stream_seed
from stf_unet_tpu_torch.cli.common import set_precision_policy
from stf_unet_tpu_torch.data.index import DatasetIndex
from stf_unet_tpu_torch.data.loader import HostLoader
from stf_unet_tpu_torch.data.transforms import TrainAugment
from stf_unet_tpu_torch.metrics.binary import compute_metrics
from stf_unet_tpu_torch.models.registry import create_model
from stf_unet_tpu_torch.train.checkpoint import CheckpointManager
from stf_unet_tpu_torch.train.early_stop import EarlyStopping
from stf_unet_tpu_torch.train.loop import (eval_batches_from_index,
                                           evaluate, train_one_epoch)
from stf_unet_tpu_torch.train.schedule import warmup_poly_schedule
from stf_unet_tpu_torch.train.state import TrainState, make_optimizer
from stf_unet_tpu_torch.viz.comparison import save_comparison


def _print_metrics(metrics: dict) -> None:
    print(metrics["confusion_str"])
    print(f"Dice coefficient: {metrics['dice']:.4f}")
    print(f"Global accuracy: {metrics['global_accuracy']:.4f}")
    print(f"Mean IoU: {metrics['mean_metrics']['miou']:.4f}")
    print(f"Mean precision: {metrics['mean_metrics']['mprecision']:.4f}")
    print(f"Mean recall: {metrics['mean_metrics']['mrecall']:.4f}")


def _loss_weight(cfg: TrainConfig, num_classes: int, device):
    if not cfg.loss_class_weights:
        return None
    try:
        weights = [float(v) for v in cfg.loss_class_weights.split(",")]
    except ValueError:
        raise SystemExit(f"--loss-class-weights must be comma-separated "
                         f"floats (e.g. 1.0,4.0), got "
                         f"{cfg.loss_class_weights!r}")
    if len(weights) != num_classes:
        raise SystemExit(f"--loss-class-weights needs {num_classes} values "
                         f"(total classes incl. background), got "
                         f"{len(weights)}")
    print(f"class-weighted CE: {weights}")
    return torch.tensor(weights, dtype=torch.float32, device=device)


def main(cfg: TrainConfig) -> dict:
    device = resolve_device(cfg.device)
    set_precision_policy()
    print(f"PyTorch {torch.__version__} | device: "
          + (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu"))
    num_classes = cfg.model.total_classes  # +1 background (ref:train.py:144)
    tag_suffix = cfg.tag_suffix

    results_file: Optional[str] = None
    if not cfg.silent:
        os.makedirs(cfg.output_dir, exist_ok=True)
        stamp = datetime.datetime.now().strftime("%m%d-%H%M")
        results_file = os.path.join(
            cfg.output_dir,
            f"{cfg.model.model}_results_{stamp}{tag_suffix}.txt")

    if cfg.generate_pk_maps:
        print("Generating PK parameter maps...")
        from stf_unet_tpu_torch.pk.maps import generate_pk_maps_for_dataset
        generate_pk_maps_for_dataset(cfg.data.data_path, device=device)
        print("PK parameter maps generation completed")

    seq_types = cfg.data.resolved_sequence_types
    print(f"Using sequence types: {list(seq_types)}")
    train_index = DatasetIndex(cfg.data.data_path, "train", seq_types,
                               use_pk_maps=cfg.data.use_pk_maps)
    val_index = DatasetIndex(cfg.data.data_path, "val", seq_types,
                             use_pk_maps=cfg.data.use_pk_maps)
    if len(train_index) == 0 and not cfg.test_only:
        raise SystemExit("error: the training index is empty after "
                         "warn-and-skip; check the warnings above (dataset "
                         "layout / --use-pk-maps without generated pk_maps)")

    loader = HostLoader(train_index, cfg.batch_size, shuffle=True,
                        seed=cfg.seed, use_pk_maps=cfg.data.use_pk_maps,
                        prefetch=cfg.data.prefetch,
                        mask_format=cfg.data.mask_format)
    augment = TrainAugment(cfg.data)
    model_cfg = dataclasses.replace(cfg.model, time_steps=len(seq_types))
    torch.manual_seed(stream_seed(cfg.seed, STREAM_INIT))
    dtype = torch.bfloat16 if cfg.amp else torch.float32
    if cfg.amp:
        print("bf16 compute, float32 parameters")
    model = create_model(model_cfg, dtype=dtype).to(device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Model {cfg.model.model}: {n_params / 1e6:.1f}M params")

    num_step = max(len(loader), 1)
    schedule = warmup_poly_schedule(
        cfg.optim.lr, num_step, cfg.epochs, warmup=cfg.optim.warmup,
        warmup_epochs=cfg.optim.warmup_epochs,
        warmup_factor=cfg.optim.warmup_factor, power=cfg.optim.poly_power)
    state = TrainState(model, make_optimizer(cfg.optim, model, device))
    loss_weight = _loss_weight(cfg, num_classes, device)

    ckpt = CheckpointManager(cfg.save_dir, cfg.model.model, tag_suffix)
    start_epoch = cfg.start_epoch
    best_dice = 0.0
    if cfg.resume:
        meta = ckpt.restore(cfg.resume, state)
        start_epoch = int(meta.get("epoch", -1)) + 1
        best_dice = float(meta.get("best_dice", 0.0) or 0.0)
        if ckpt.exists("best"):  # the best checkpoint's own score wins
            best_dice = max(best_dice,
                            float(ckpt.load("best").get("best_dice", 0.0)))
        print(f"Resumed from {cfg.resume} at epoch {start_epoch} (best dice "
              f"so far {best_dice:.4f})")

    early_stopper = EarlyStopping(patience=cfg.early_stop_patience,
                                  verbose=True)
    cfg_json = config_lib.config_to_json(cfg)
    epochs_run = []
    start_time = time.time()
    for epoch in range(start_epoch,
                       start_epoch if cfg.test_only else cfg.epochs):
        mean_loss, lr, _ = train_one_epoch(
            state, loader, augment, cfg.seed, epoch, schedule, num_classes,
            device, print_freq=cfg.print_freq, loss_weight=loss_weight)
        metrics = evaluate(
            state.model,
            eval_batches_from_index(val_index, cfg.data,
                                    use_pk_maps=cfg.data.use_pk_maps,
                                    batch_size=cfg.eval_batch_size),
            num_classes, data_cfg=cfg.data, device=device)
        dice = metrics["dice"]
        _print_metrics(metrics)
        epochs_run.append({"epoch": epoch, "train_loss": mean_loss,
                           "lr": lr, "dice": dice})
        if results_file:
            # ref:train.py:288-301 format
            with open(results_file, "a") as f:
                f.write(f"[epoch: {epoch}]\n"
                        f"train_loss: {mean_loss:.4f}\n"
                        f"lr: {lr:.6f}\n"
                        f"dice: {dice:.4f}\n"
                        f"global_acc: {metrics['global_accuracy']:.4f}\n"
                        f"mean_iou: {metrics['mean_metrics']['miou']:.4f}\n"
                        f"mean_precision: "
                        f"{metrics['mean_metrics']['mprecision']:.4f}\n"
                        f"mean_recall: "
                        f"{metrics['mean_metrics']['mrecall']:.4f}\n"
                        f"{metrics['confusion_str']}\n\n")
        if cfg.save_best:
            ckpt.save("latest", state, epoch=epoch, best_dice=best_dice,
                      config_json=cfg_json, seed=cfg.seed)
            if best_dice < dice:
                best_dice = dice
                ckpt.save("best", state, epoch=epoch, best_dice=dice,
                          config_json=cfg_json, seed=cfg.seed)
                print(f"New best model saved at epoch {epoch}, "
                      f"Dice = {dice:.4f}")
        else:
            ckpt.save(f"epoch{epoch}", state, epoch=epoch,
                      best_dice=best_dice, config_json=cfg_json,
                      seed=cfg.seed)
        if early_stopper.step(dice):
            print(f"Early stopping at epoch {epoch + 1}")
            break
    total_time = time.time() - start_time
    print(f"Training time {datetime.timedelta(seconds=int(total_time))}")

    # ---- best-model test-set evaluation (ref:train.py:341-400) ----------
    print("Start evaluating best model on test set...")
    best_kind = "best" if ckpt.exists("best") else "latest"
    if ckpt.exists(best_kind):
        state.model.load_state_dict(ckpt.load(best_kind)["model"])
    test_index = DatasetIndex(cfg.data.data_path, "test", seq_types,
                              use_pk_maps=cfg.data.use_pk_maps)
    test_save_dir = os.path.join(cfg.output_dir, f"test_results{tag_suffix}")
    print("Running inference on test set...")
    test_metrics = evaluate(
        state.model,
        eval_batches_from_index(test_index, cfg.data,
                                use_pk_maps=cfg.data.use_pk_maps,
                                batch_size=cfg.eval_batch_size),
        num_classes, data_cfg=cfg.data, device=device, collect_outputs=True)
    idx = 0
    for logits, (image, target) in zip(test_metrics.pop("outputs"),
                                       test_metrics.pop("batches")):
        for j in range(logits.shape[0]):
            # argmax prediction (foreground = class 1), ignore label as 0
            pred = np.argmax(logits[j], axis=-1).astype(np.float32)
            tgt = np.where(target[j] == 255, 0, target[j]).astype(np.float32)
            dice_val, iou_val = compute_metrics(pred, tgt)
            save_comparison(pred, tgt, image[j, 0, :, :, 0], test_save_dir,
                            base_name=cfg.model.model, idx=idx,
                            dice_score=dice_val, iou_score=iou_val)
            idx += 1
    print("Test Set Metrics:")
    print(test_metrics["confusion_str"])
    print(f"Dice: {test_metrics['dice']:.4f}")
    print(f"mIoU: {test_metrics['mean_metrics']['miou']:.4f}")
    return {"best_dice": best_dice, "epochs": epochs_run,
            "steps": state.step, "test": test_metrics,
            "results_file": results_file, "test_renders": idx}


def run(argv: Optional[Sequence[str]] = None) -> dict:
    return main(config_lib.parse_config(argv))


if __name__ == "__main__":
    run()
