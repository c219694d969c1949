"""Train and eval loops (counterpart of stf_unet_tpu/train/loop.py;
ref:train_utils/train_and_eval.py:316-411).

A step: the host loader's raw uint8 batch (frames, mask and, with PK
maps, the three maps) moves to the device, the augmentation warps it there
(kernel K2), the model runs in train mode
(pixel LSTMs through K1 / K1b at C <= 128 on CUDA), then the CE + dice
criterion, backward, and one AdamW step at the schedule's lr. The loss of
step s is read on the host while step s+1 runs, so the host does not wait
for the card every step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from stf_unet_tpu_torch.core.prng import augment_generator
from stf_unet_tpu_torch.data.loader import (Batch, HostLoader,
                                            load_sample_raw,
                                            prefetch_iterator)
from stf_unet_tpu_torch.data.transforms import (TrainAugment,
                                                eval_preprocess, normalize)
from stf_unet_tpu_torch.losses.criterion import criterion
from stf_unet_tpu_torch.metrics.confusion import (confusion_init,
                                                  confusion_report,
                                                  confusion_update,
                                                  format_confusion)
from stf_unet_tpu_torch.metrics.dice import (eval_dice_update,
                                             eval_dice_value)
from stf_unet_tpu_torch.metrics.meters import MetricLogger, SmoothedValue
from stf_unet_tpu_torch.models.registry import preprocess_input
from stf_unet_tpu_torch.train.state import TrainState


def loss_and_grads(model, images: torch.Tensor, targets: torch.Tensor,
                   num_classes: int, ignore_index: int = -100,
                   loss_weight: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Train-mode forward, criterion and backward: leaves the gradients
    in the parameters' .grad and returns the loss (a device scalar)."""
    model.train()
    outputs = model(preprocess_input(images, model))
    loss = criterion(outputs, targets, loss_weight=loss_weight,
                     num_classes=num_classes, ignore_index=ignore_index)
    loss.backward()
    return loss


def train_step(state: TrainState, augment: TrainAugment, batch: Batch,
               gen: torch.Generator, schedule: Callable[[int], float],
               num_classes: int, device: torch.device,
               loss_weight: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, float]:
    """One optimizer step on a raw host batch. Returns (loss on the
    device, lr used)."""
    frames = torch.from_numpy(batch.frames).to(device, non_blocking=True)
    masks = torch.from_numpy(batch.masks).to(device, non_blocking=True)
    pk = (None if batch.pk is None
          else torch.from_numpy(batch.pk).to(device, non_blocking=True))
    images, targets = augment(gen, frames, masks, batch.sizes, pk)
    lr = schedule(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.zero_grad(set_to_none=True)
    loss = loss_and_grads(state.model, images, targets, num_classes,
                          loss_weight=loss_weight)
    state.optimizer.step()
    state.step += 1
    return loss.detach(), lr


def train_one_epoch(state: TrainState, loader: HostLoader,
                    augment: TrainAugment, seed: int, epoch: int,
                    schedule: Callable[[int], float], num_classes: int,
                    device: torch.device, *, print_freq: int = 10,
                    loss_weight: Optional[torch.Tensor] = None
                    ) -> Tuple[float, float, int]:
    """One epoch (ref:train_and_eval.py:377-411): (mean loss, last lr,
    steps). The augmentation draws of step s come from
    augment_generator(seed, epoch, s)."""
    logger = MetricLogger(delimiter="  ")
    logger.add_meter("lr", SmoothedValue(window_size=1, fmt="{value:.6f}"))
    pending = None  # the previous step's (loss, lr), read one step late
    steps = 0
    for batch in logger.log_every(loader.epoch(epoch), print_freq,
                                  f"Epoch: [{epoch}]", total=len(loader)):
        loss, lr = train_step(state, augment, batch,
                              augment_generator(seed, epoch, steps),
                              schedule, num_classes, device, loss_weight)
        if pending is not None:
            logger.update(loss=pending[0].item(), lr=pending[1])
        pending = (loss, lr)
        steps += 1
    if pending is not None:
        logger.update(loss=pending[0].item(), lr=pending[1])
    last_lr = logger.meters["lr"].value if steps else 0.0
    return logger.meters["loss"].global_avg, float(last_lr), steps


@torch.inference_mode()
def evaluate(model, eval_batches: Iterable, num_classes: int, *,
             data_cfg, device: torch.device,
             print_freq: int = 100) -> Dict[str, Any]:
    """Validation/test pass (ref:train_and_eval.py:316-374) over
    (image [B, T, h, w, 1] uint8, target [B, h, w] uint8) batches, which
    are normalized on the device. Returns {dice, confusion_matrix,
    confusion_str, global_accuracy, class_metrics, mean_metrics}."""
    model.eval()
    conf = confusion_init(num_classes, device)
    dice_cum = torch.zeros((num_classes,), dtype=torch.float32,
                           device=device)
    count = 0
    logger = MetricLogger(delimiter="  ")
    for image, target in logger.log_every(eval_batches, print_freq, "Test:"):
        image = torch.from_numpy(image).to(device, non_blocking=True)
        target = torch.from_numpy(target).to(device, non_blocking=True)
        x = normalize(image, data_cfg.mean, data_cfg.std)
        logits = model(preprocess_input(x, model))["out"]
        target = target.long()
        conf = confusion_update(conf, target, torch.argmax(logits, dim=-1))
        dice_cum, count = eval_dice_update(dice_cum, count, logits, target,
                                           ignore_index=255)
    mat = conf.cpu().numpy()
    report = confusion_report(mat)
    return {
        "dice": eval_dice_value(dice_cum, count),
        "confusion_matrix": mat,
        "confusion_str": format_confusion(mat),
        "global_accuracy": report["global_accuracy"],
        "class_metrics": report["class_metrics"],
        "mean_metrics": report["mean_metrics"],
    }


def eval_batches_from_index(index, cfg, *, use_pk_maps: bool = False,
                            batch_size: int = 1, prefetch: int = 2):
    """Eval-preprocessed uint8 (image, target) batches from a DatasetIndex:
    the PIL-parity resize runs on a background thread, normalization on
    the device (evaluate). batch_size > 1 groups same-shape samples, so a
    batched evaluation equals the per-sample one. With PK maps each image
    carries the three maps after its frames."""

    def sample_iter():
        for rec in index.records:
            frames, mask, pk = load_sample_raw(rec, use_pk_maps,
                                               cfg.mask_format)
            yield eval_preprocess(frames, mask, cfg, pk, raw=True)

    def batch_iter():
        buckets: Dict[Tuple[int, ...], Tuple[list, list]] = {}
        for img, tgt in sample_iter():
            imgs, tgts = buckets.setdefault(img.shape, ([], []))
            imgs.append(img)
            tgts.append(tgt)
            if len(imgs) == batch_size:
                yield _collate_eval(imgs, tgts)
                del buckets[img.shape]
        for imgs, tgts in buckets.values():  # same-shape leftovers
            yield _collate_eval(imgs, tgts)

    return prefetch_iterator(batch_iter(), prefetch)


def _collate_eval(imgs, tgts):
    """Stack same-shape samples (the bucketing guarantees the shape)."""
    return np.stack(imgs), np.stack(tgts)
