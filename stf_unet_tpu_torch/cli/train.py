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
        [--data-parallel N | --multihost] \\
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
step with a resumable checkpoint (train/preempt.py). CUDA unless
--device cpu.

Devices: one process on one device, unless data parallelism is asked
for. `--data-parallel N > 1` spawns N local processes joined by a
process group on a free localhost port, one device each (cuda:r, or the
CPU with --device cpu, gloo); `--data-parallel 0` (the default) takes
every visible GPU, so one visible GPU runs as one process; N beyond the
visible GPUs raises. `--multihost` joins the group that torchrun
describes in the environment (NCCL on cuda:LOCAL_RANK). In a group the
batch is global (padded to a multiple of the world; each rank loads its
B / world rows of a host-sharded loader, drop_last), the BNs take the
global statistics and DistributedDataParallel all-reduces the
gradients; every rank evaluates its shard of the val set and all get the
same summed metrics, so the early-stop and best-checkpoint decisions
agree; only rank 0 writes results files, checkpoints and the test
pass's renders. --generate-pk-maps fits the maps before the ranks spawn
(--data-parallel), or on rank 0 while the others wait up to
PK_MAPS_WAIT (--multihost). The group is left at the end and on error; a
rank that raises takes the others down with a non-zero exit.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from stf_unet_tpu_torch.core import config as config_lib
from stf_unet_tpu_torch.core import distributed
from stf_unet_tpu_torch.core import mesh as mesh_lib
from stf_unet_tpu_torch.core.config import TrainConfig, resolve_device
from stf_unet_tpu_torch.core.prng import STREAM_INIT, stream_seed
from stf_unet_tpu_torch.cli.common import (load_reference_checkpoint,
                                           set_precision_policy)
from stf_unet_tpu_torch.data.index import DatasetIndex
from stf_unet_tpu_torch.data.loader import HostLoader
from stf_unet_tpu_torch.data.transforms import TrainAugment
from stf_unet_tpu_torch.metrics.binary import compute_metrics
from stf_unet_tpu_torch.metrics.meters import device_peak_memory_mb
from stf_unet_tpu_torch.models.registry import create_model
from stf_unet_tpu_torch.train.checkpoint import CheckpointManager
from stf_unet_tpu_torch.train.early_stop import EarlyStopping
from stf_unet_tpu_torch.train.loop import (CachedEvalBatches,
                                           eval_batches_from_index,
                                           evaluate, train_one_epoch)
from stf_unet_tpu_torch.train.preempt import PreemptionGuard
from stf_unet_tpu_torch.train.schedule import warmup_poly_schedule
from stf_unet_tpu_torch.train.state import (TrainState, data_parallel,
                                            ema_copy, make_optimizer)
from stf_unet_tpu_torch.utils.profiling import JsonlLogger
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


def _writers(cfg: TrainConfig, is_main: bool
             ) -> Tuple[Optional[str], Optional[JsonlLogger]]:
    """The results .txt path and the JSONL metrics writer of this
    process: both on the one writer (rank 0) unless --silent, the JSONL
    unless --jsonl-metrics false; None where there is none."""
    if cfg.silent or not is_main:
        return None, None
    os.makedirs(cfg.output_dir, exist_ok=True)
    stamp = datetime.datetime.now().strftime("%m%d-%H%M")
    name = f"{cfg.model.model}_{{}}_{stamp}{cfg.tag_suffix}"
    jsonl = (JsonlLogger(os.path.join(cfg.output_dir,
                                      name.format("metrics") + ".jsonl"))
             if cfg.jsonl_metrics else None)
    return os.path.join(cfg.output_dir,
                        name.format("results") + ".txt"), jsonl


def main(cfg: TrainConfig) -> dict:
    """Train as the flags say: in this process, in a spawned group of
    --data-parallel N local processes (returning rank 0's result), or as
    one rank of torchrun's group under --multihost."""
    device = resolve_device(cfg.device)
    if cfg.spatial_parallel > 1:
        return _spatial_main(cfg, device)
    if cfg.multihost:
        distributed.initialize(device=device)  # raises: no silent fallback
        try:
            return _train(cfg, group=mesh_lib.create_mesh(
                cfg.data_parallel, device))
        finally:
            distributed.shutdown()
    world = mesh_lib.data_world(cfg.data_parallel, device)
    if world > 1:
        # the maps first, in this process, so no rank waits on a collective
        # while they are fitted
        if cfg.generate_pk_maps:
            _generate_pk_maps(cfg, device)
        return distributed.spawn_group(_train, world, device, cfg, True)
    return _train(cfg, group=None)


def _spatial_main(cfg: TrainConfig, device) -> dict:
    """--spatial-parallel N: the JAX trainer's rules (single process
    group on this host, n_data = --data-parallel if > 1 else the GPUs
    over N, an explicit batch), then n_data x N spawned ranks."""
    if cfg.multihost:
        raise SystemExit("error: --spatial-parallel is single-process "
                         "only (use --data-parallel across hosts)")
    if cfg.batch_size == 0:
        # The probe measures the single-device step; H-sharding divides
        # the activations by n_space, which the linear-in-batch model
        # cannot see.
        raise SystemExit("error: --batch-size auto does not model "
                         "--spatial-parallel; set --batch-size "
                         "explicitly")
    n_data, n_space = mesh_lib.mesh_2d_shape(
        cfg.spatial_parallel, cfg.data_parallel, device)
    print(f"2-D mesh: {n_data} data x {n_space} spatial shards (image "
          "rows shard over 'space'; hand-written halo exchanges)")
    if cfg.generate_pk_maps:
        _generate_pk_maps(cfg, device)
    return distributed.spawn_group(_train, n_data * n_space, device, cfg,
                                   True, n_space=n_space)


# How long the other ranks of a --multihost group wait for rank 0 to fit
# the PK maps (about half a second a slice on an H100), in place of the
# group's collective timeout.
PK_MAPS_WAIT = datetime.timedelta(hours=24)


def _generate_pk_maps(cfg: TrainConfig, device) -> None:
    print("Generating PK parameter maps...")
    from stf_unet_tpu_torch.pk.maps import generate_pk_maps_for_dataset
    generate_pk_maps_for_dataset(cfg.data.data_path, device=device)
    print("PK parameter maps generation completed")


def _train(cfg: TrainConfig, maps_done: bool = False,
           group: Optional[mesh_lib.DataGroup] = None) -> dict:
    """The run, in one process (group None) or as one rank of `group`;
    `maps_done` when the PK maps were fitted before the group started."""
    device = group.device if group is not None else resolve_device(
        cfg.device)
    # the batch shards over the data index (the ranks of a space group
    # load the same records and keep their rows of them)
    host_index, num_hosts = ((group.data_index, group.n_data)
                             if group is not None else (0, 1))
    is_main = group is None or group.is_main
    set_precision_policy()
    print(f"PyTorch {torch.__version__} | device: "
          + (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
          + (f" | rank {group.rank} of {group.world} "
             f"({torch.distributed.get_backend()})" if group is not None
             else "")
          + (f" | data {host_index} of {num_hosts}, space "
             f"{group.space_index} of {group.n_space}"
             if group is not None and group.n_space > 1 else ""))
    num_classes = cfg.model.total_classes  # +1 background (ref:train.py:144)
    tag_suffix = cfg.tag_suffix

    results_file, jsonl = _writers(cfg, is_main)

    if cfg.generate_pk_maps and not maps_done:
        if is_main:
            _generate_pk_maps(cfg, device)
        # the maps exist before any rank indexes them
        mesh_lib.barrier(group, timeout=PK_MAPS_WAIT)

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
    batch_size = cfg.batch_size  # the GLOBAL batch
    if batch_size == 0:  # --batch-size auto
        from stf_unet_tpu_torch.train.autobatch import pick_batch_size
        t_total = len(seq_types) + (cfg.model.pk_channels
                                    if cfg.data.use_pk_maps else 0)
        # probe at the loader's fixed canvas, the inputs the step reads
        probe_canvas = HostLoader(train_index, 1, shuffle=False,
                                  prefetch=0, verbose=False).canvas
        batch_size = pick_batch_size(
            cfg, t_total, n_shards=num_hosts, canvas=probe_canvas,
            device=device,
            budget_bytes=int(cfg.auto_batch_budget_gb * 2**30) or None)
        # every rank measured its own device: all take the smallest pick
        batch_size = mesh_lib.agree_min(group, batch_size)
    if cfg.data.rotation_split:
        print("note: --data-rotation-split changes nothing here: K2 warps "
              "every sample, rotated or not, in one launch"
              + (" (and the JAX package keeps it single-device)"
                 if group is not None else ""))
    if group is not None:
        batch_size = mesh_lib.pad_batch_to_multiple(batch_size, num_hosts)
        print(f"data parallelism: global batch {batch_size} = {num_hosts} "
              f"data shards x {batch_size // num_hosts}"
              + (f", rows over {group.n_space} space ranks"
                 if group.n_space > 1 else ""))
    local_batch = max(1, batch_size // num_hosts)

    train_pack = _open_pack(cfg, "train", required=True)
    loader = HostLoader(train_index, local_batch, shuffle=True,
                        seed=cfg.seed, use_pk_maps=cfg.data.use_pk_maps,
                        drop_last=group is not None,
                        prefetch=cfg.data.prefetch,
                        mask_format=cfg.data.mask_format,
                        cache_ram=cfg.data.cache_ram, pack=train_pack,
                        host_index=host_index, num_hosts=num_hosts)
    augment = TrainAugment(cfg.data, host_index, num_hosts)
    torch.manual_seed(stream_seed(cfg.seed, STREAM_INIT))
    dtype = torch.bfloat16 if cfg.amp else torch.float32
    if cfg.amp:
        print("bf16 compute, float32 parameters")
    model = create_model(model_cfg, dtype=dtype).to(device)
    # synced BN and DDP (rank 0's weights on every rank) before the
    # optimizer and the EMA copy see the parameters
    ddp = data_parallel(model, group) if group is not None else None
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
                       ema_warmup=cfg.optim.ema_warmup, group=group, ddp=ddp)
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

    def val_batches():  # each rank its shard of the val set
        return eval_batches_from_index(val_index, cfg.data,
                                       use_pk_maps=cfg.data.use_pk_maps,
                                       batch_size=cfg.eval_batch_size,
                                       pack=val_pack, host_index=host_index,
                                       num_hosts=num_hosts)

    # with the RAM cache the val set decodes once, then replays its bytes
    cached_val = CachedEvalBatches(val_batches) if cfg.data.cache_ram \
        else None

    early_stopper = EarlyStopping(patience=cfg.early_stop_patience,
                                  verbose=True)
    cfg_json = config_lib.config_to_json(cfg)
    epochs_run = []
    start_time = time.time()
    guard = PreemptionGuard(group.world if group is not None else 1,
                            cfg.stop_after_steps, group=group)
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
                    num_classes, data_cfg=cfg.data, device=device,
                    reduce_across_processes=group is not None, group=group)
            dice = metrics["dice"]
            _print_metrics(metrics)
            epochs_run.append({"epoch": epoch, "train_loss": mean_loss,
                               "lr": lr, "dice": dice})
            if jsonl is not None:
                jsonl.log({"epoch": epoch, "train_loss": mean_loss, "lr": lr,
                           "dice": dice,
                           "global_acc": metrics["global_accuracy"],
                           **metrics["mean_metrics"]})
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
                    if is_main:
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
        if is_main:
            print(f"Preemption/stop honored: resumable checkpoint saved "
                  f"({ckpt.path(resume_kind)}); continue with --resume "
                  f"{resume_kind}")
        return {"preempted": True, "best_dice": best_dice,
                "epochs": epochs_run, "steps": state.step,
                "batch_size": batch_size, "results_file": results_file,
                "metrics_file": jsonl and jsonl.path}
    total_time = time.time() - start_time
    print(f"Training time {datetime.timedelta(seconds=int(total_time))}")
    # every rank's peak device memory (MB; None on the CPU), on rank 0
    peak_mb = mesh_lib.gather_objects(group, device_peak_memory_mb())
    if not is_main:  # rank 0 alone runs the test pass and its renders
        return {"best_dice": best_dice, "epochs": epochs_run,
                "steps": state.step, "batch_size": batch_size}

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
            "metrics_file": jsonl and jsonl.path, "test_renders": idx,
            "peak_memory_mb_by_rank": peak_mb}


def run(argv: Optional[Sequence[str]] = None) -> dict:
    return main(config_lib.parse_config(argv))


if __name__ == "__main__":
    run()
