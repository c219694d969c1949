"""Training entry point (counterpart of stf_unet_tpu/cli/train.py;
ref:train.py:124-401).

    python -m stf_unet_tpu_torch.cli.train --data-path <BreaDM root> \\
        [--model stflstm|unet [--model-base-c 64]] [--amp true] \\
        [--batch-size 16|auto [--auto-batch-budget-gb G]] [--epochs 100] \\
        [--use-subtraction --use-pk-maps [--generate-pk-maps]] \\
        [--grad-accum K] [--optim-ema-decay D [--optim-ema-warmup B]] \\
        [--data-pack <pack root>] [--data-cache-ram] \\
        [--data-device-prefetch N] [--stop-after-steps N] \\
        [--data-elastic-alpha A --data-brightness B ...] \\
        [--device cuda|cpu] [--resume latest [--test-only]] ...

Optional PK map fitting (--generate-pk-maps, pk/maps.py) -> dataset
index (and packs) -> batch size (auto: train/autobatch) -> model, AdamW
(accumulated over --grad-accum micro-steps, with an EMA copy under
--optim-ema-decay) and the warmup-poly schedule in apply units ->
optional resume (step-exact after a preemption) -> epochs of (train,
evaluate the EMA copy, results file, latest/best checkpoints, early
stop; none with --test-only) -> a test-set pass with the best weights
that prints its metrics and writes one original / ground truth /
prediction render per test slice to <output_dir>/test_results<_pk>.
SIGTERM, a first SIGINT or --stop-after-steps end the run at the next
step with a resumable checkpoint (train/preempt.py). One device; CUDA
unless --device cpu.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from stf_unet_tpu_torch.core import config as config_lib
from stf_unet_tpu_torch.core.config import TrainConfig, resolve_device
from stf_unet_tpu_torch.core.prng import STREAM_INIT, stream_seed
from stf_unet_tpu_torch.cli.common import (load_reference_checkpoint,
                                           set_precision_policy)
from stf_unet_tpu_torch.data.index import DatasetIndex
from stf_unet_tpu_torch.data.loader import HostLoader
from stf_unet_tpu_torch.data.transforms import TrainAugment
from stf_unet_tpu_torch.metrics.binary import compute_metrics
from stf_unet_tpu_torch.models.registry import create_model
from stf_unet_tpu_torch.train.checkpoint import CheckpointManager
from stf_unet_tpu_torch.train.early_stop import EarlyStopping
from stf_unet_tpu_torch.train.loop import (CachedEvalBatches,
                                           eval_batches_from_index,
                                           evaluate, train_one_epoch)
from stf_unet_tpu_torch.train.preempt import PreemptionGuard
from stf_unet_tpu_torch.train.schedule import warmup_poly_schedule
from stf_unet_tpu_torch.train.state import (TrainState, ema_copy,
                                            make_optimizer)
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


def _open_pack(cfg: TrainConfig, mode: str, required: bool = False):
    """The split's dataset pack under --data-pack, or None. The training
    split's must exist; a missing val / test pack falls back to decoding
    that split, with a note (the JAX CLI's rule)."""
    if not cfg.data.pack_dir:
        return None
    from stf_unet_tpu_torch.data.pack import open_split_pack
    try:
        pack = open_split_pack(cfg.data.pack_dir, mode)
    except FileNotFoundError:
        if required:
            raise
        print(f"note: no '{mode}' pack under {cfg.data.pack_dir}; "
              "decoding that split from the image tree")
        return None
    print(f"dataset pack [{mode}]: {len(pack)} samples, "
          f"canvas {pack.canvas} (decode-free)")
    return pack


def _check_resume(meta_cfg: str, k: int, use_ema: bool) -> None:
    """Refuse a resume whose --grad-accum or EMA on/off differs from the
    checkpoint's run (the JAX CLI's errors: the state structure
    differs)."""
    if not meta_cfg:
        return
    saved = json.loads(meta_cfg)
    saved_accum = int(saved.get("grad_accum", k) or k)
    if saved_accum != k:
        raise ValueError(
            f"checkpoint was trained with --grad-accum {saved_accum} "
            f"but this run uses --grad-accum {k}; resume with the same "
            f"value (the optimizer state structure differs)")
    saved_ema = float(saved.get("optim", {}).get("ema_decay", 0.0)
                      or 0.0) > 0.0
    if saved_ema != use_ema:
        raise ValueError(
            "checkpoint was trained with --optim-ema-decay "
            f"{'on' if saved_ema else 'off'} but this run has it "
            f"{'on' if use_ema else 'off'}; resume with a matching "
            "setting (the state structure differs)")


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

    model_cfg = dataclasses.replace(cfg.model, time_steps=len(seq_types))
    batch_size = cfg.batch_size
    if batch_size == 0:  # --batch-size auto
        from stf_unet_tpu_torch.train.autobatch import pick_batch_size
        t_total = len(seq_types) + (cfg.model.pk_channels
                                    if cfg.data.use_pk_maps else 0)
        # probe at the loader's fixed canvas, the inputs the step reads
        probe_canvas = HostLoader(train_index, 1, shuffle=False,
                                  prefetch=0, verbose=False).canvas
        batch_size = pick_batch_size(
            cfg, t_total, canvas=probe_canvas, device=device,
            budget_bytes=int(cfg.auto_batch_budget_gb * 2**30) or None)
    if cfg.data.rotation_split:
        print("note: --data-rotation-split changes nothing here: K2 warps "
              "every sample, rotated or not, in one launch")

    train_pack = _open_pack(cfg, "train", required=True)
    loader = HostLoader(train_index, batch_size, shuffle=True,
                        seed=cfg.seed, use_pk_maps=cfg.data.use_pk_maps,
                        prefetch=cfg.data.prefetch,
                        mask_format=cfg.data.mask_format,
                        cache_ram=cfg.data.cache_ram, pack=train_pack)
    augment = TrainAugment(cfg.data)
    torch.manual_seed(stream_seed(cfg.seed, STREAM_INIT))
    dtype = torch.bfloat16 if cfg.amp else torch.float32
    if cfg.amp:
        print("bf16 compute, float32 parameters")
    model = create_model(model_cfg, dtype=dtype).to(device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Model {cfg.model.model}: {n_params / 1e6:.1f}M params")

    # Under accumulation the schedule advances once per optimizer apply,
    # so it is sized and indexed in apply units.
    k = max(int(cfg.grad_accum), 1)
    num_step = max(-(-len(loader) // k), 1)
    schedule = warmup_poly_schedule(
        cfg.optim.lr, num_step, cfg.epochs, warmup=cfg.optim.warmup,
        warmup_epochs=cfg.optim.warmup_epochs,
        warmup_factor=cfg.optim.warmup_factor, power=cfg.optim.poly_power)
    if k > 1:
        print(f"gradient accumulation x{k}: effective batch "
              f"{batch_size * k}")
    use_ema = cfg.optim.ema_decay > 0.0
    state = TrainState(model, make_optimizer(cfg.optim, model, device),
                       grad_accum=k, ema=ema_copy(model) if use_ema else None,
                       ema_decay=cfg.optim.ema_decay,
                       ema_warmup=cfg.optim.ema_warmup)
    if use_ema:
        print(f"EMA weights: decay {cfg.optim.ema_decay}"
              f"{' (warmup ramp)' if cfg.optim.ema_warmup else ''} "
              "(val/test evaluate the EMA copy)")
    loss_weight = _loss_weight(cfg, num_classes, device)

    ckpt = CheckpointManager(cfg.save_dir, cfg.model.model, tag_suffix)
    start_epoch = cfg.start_epoch
    best_dice = 0.0
    resume_step = None  # set on a mid-epoch (preemption) resume
    if cfg.resume:
        _check_resume(ckpt.load(cfg.resume).get("config"), k, use_ema)
        meta = ckpt.restore(cfg.resume, state)
        resume_step = meta.get("step_in_epoch")
        if resume_step is not None:  # re-enter the interrupted epoch
            start_epoch = int(meta["epoch"])
            resume_step = int(resume_step)
        else:
            start_epoch = int(meta.get("epoch", -1)) + 1
        best_dice = float(meta.get("best_dice", 0.0) or 0.0)
        if ckpt.exists("best"):  # the best checkpoint's own score wins
            best_dice = max(best_dice,
                            float(ckpt.load("best").get("best_dice", 0.0)))
        print(f"Resumed from {cfg.resume} at epoch {start_epoch}"
              + (f" step {resume_step}" if resume_step else "")
              + f" (best dice so far {best_dice:.4f})")

    val_pack = _open_pack(cfg, "val")
    test_pack = _open_pack(cfg, "test")
    test_index = DatasetIndex(cfg.data.data_path, "test", seq_types,
                              use_pk_maps=cfg.data.use_pk_maps)
    for pack, index in ((val_pack, val_index), (test_pack, test_index)):
        if pack is not None:  # a stale pack fails now, not after training
            pack.validate(index, mask_format=cfg.data.mask_format,
                          use_pk_maps=cfg.data.use_pk_maps)

    def val_batches():
        return eval_batches_from_index(val_index, cfg.data,
                                       use_pk_maps=cfg.data.use_pk_maps,
                                       batch_size=cfg.eval_batch_size,
                                       pack=val_pack)

    # with the RAM cache the val set decodes once, then replays its bytes
    cached_val = CachedEvalBatches(val_batches) if cfg.data.cache_ram \
        else None

    early_stopper = EarlyStopping(patience=cfg.early_stop_patience,
                                  verbose=True)
    cfg_json = config_lib.config_to_json(cfg)
    epochs_run = []
    start_time = time.time()
    guard = PreemptionGuard(1, cfg.stop_after_steps)
    preempted = False
    try:
        for epoch in range(start_epoch,
                           start_epoch if cfg.test_only else cfg.epochs):
            start_step = (resume_step or 0) if epoch == start_epoch else 0
            mean_loss, lr, steps_done = train_one_epoch(
                state, loader, augment, cfg.seed, epoch, schedule,
                num_classes, device, print_freq=cfg.print_freq,
                loss_weight=loss_weight,
                device_prefetch=cfg.data.device_prefetch,
                start_step=start_step, should_stop=guard.should_stop)
            if guard.triggered:
                # stopped mid-epoch: no evaluation, a step-exact "latest"
                partial = steps_done < len(loader)
                ckpt.save("latest", state, epoch=epoch, best_dice=best_dice,
                          config_json=cfg_json, seed=cfg.seed,
                          step_in_epoch=steps_done if partial else None)
                epochs_run.append({"epoch": epoch, "train_loss": mean_loss,
                                   "lr": lr, "steps": steps_done,
                                   "partial": partial})
                preempted, resume_kind = True, "latest"
                break
            with state.ema_weights():
                metrics = evaluate(
                    state.model,
                    cached_val if cached_val is not None else val_batches(),
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
                            f"mean_iou: "
                            f"{metrics['mean_metrics']['miou']:.4f}\n"
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
            # a signal during evaluation or the saves: this epoch's save
            # is whole, so resume starts at the next epoch
            if guard.should_stop(increment=False):
                preempted = True
                resume_kind = "latest" if cfg.save_best else f"epoch{epoch}"
                break
    finally:
        guard.uninstall()

    if preempted:
        print(f"Preemption/stop honored: resumable checkpoint saved "
              f"({ckpt.path(resume_kind)}); continue with --resume "
              f"{resume_kind}")
        return {"preempted": True, "best_dice": best_dice,
                "epochs": epochs_run, "steps": state.step,
                "batch_size": batch_size, "results_file": results_file}
    total_time = time.time() - start_time
    print(f"Training time {datetime.timedelta(seconds=int(total_time))}")

    # ---- best-model test-set evaluation (ref:train.py:341-400) ----------
    print("Start evaluating best model on test set...")
    best_kind = "best" if ckpt.exists("best") else "latest"
    if ckpt.exists(best_kind):
        # the EMA weights where the checkpoint carries them
        state.model.load_state_dict(
            load_reference_checkpoint(ckpt.path(best_kind))[0])
    elif state.ema is not None:
        state.model.load_state_dict({**state.model.state_dict(),
                                     **state.ema})
    test_save_dir = os.path.join(cfg.output_dir, f"test_results{tag_suffix}")
    print("Running inference on test set...")
    test_metrics = evaluate(
        state.model,
        eval_batches_from_index(test_index, cfg.data,
                                use_pk_maps=cfg.data.use_pk_maps,
                                batch_size=cfg.eval_batch_size,
                                pack=test_pack),
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
            "batch_size": batch_size, "results_file": results_file,
            "test_renders": idx}


def run(argv: Optional[Sequence[str]] = None) -> dict:
    return main(config_lib.parse_config(argv))


if __name__ == "__main__":
    run()
