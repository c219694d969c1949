"""Train and eval loops (counterpart of stf_unet_tpu/train/loop.py;
ref:train_utils/train_and_eval.py:316-411).

A step: the host loader's raw uint8 batch (frames, mask and, with PK
maps, the three maps) moves to the device (pinned and copied ahead on a
side stream with device prefetch), the augmentation warps it there
(kernel K2), the model runs in train mode
(pixel LSTMs through K1 / K1b at C <= 128 on CUDA), then the CE + dice
criterion, backward, and the AdamW apply at the schedule's lr (once per
accumulation window, then the EMA update; train/state.py). The loss of
step s is read on the host while step s+1 runs, so the host does not wait
for the card every step.

Under data parallelism (state.group) each rank runs this step on its
rows of the global batch through the DDP wrapper (the non-final
micro-steps of an accumulation window under no_sync), and the loss it
returns is the global mean, all-reduced on the device. Under spatial
parallelism (a 2-D group) the ranks of a space group augment the same
data shard's whole images (K2), each keeps its block of the image rows,
and the forward runs row-sharded (parallel/spatial.row_sharded).

Profiler ranges (utils/profiling.annotate) split a traced epoch's host
time: "train_step" (augment, forward, backward, apply), "data_wait" (the
wait for the next device batch), "loss_read" (the previous step's loss
brought to the host) and "eval_batch"; cli/train adds "eval" and
"checkpoint". With the NaN check on (state.nan_check) a NaN in the loss
raises before the backward, which runs in anomaly mode.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import (Any, Callable, Dict, Iterable, Iterator, Optional,
                    Tuple, Union)

import numpy as np
import torch
import torch.distributed as dist

from stf_unet_tpu_torch.core import mesh as mesh_lib
from stf_unet_tpu_torch.core.prng import augment_generator
from stf_unet_tpu_torch.data.loader import (Batch, HostLoader,
                                            load_sample_raw_native,
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
from stf_unet_tpu_torch.parallel import spatial
from stf_unet_tpu_torch.train.state import TrainState
from stf_unet_tpu_torch.utils.profiling import annotate


def loss_and_grads(model, images: torch.Tensor, targets: torch.Tensor,
                   num_classes: int, ignore_index: int = -100,
                   loss_weight: Optional[torch.Tensor] = None,
                   forward=None, group=None, nan_check=None
                   ) -> torch.Tensor:
    """Train-mode forward, criterion and backward: leaves the gradients
    in the parameters' .grad and returns the loss (a device scalar).
    `forward` runs the model (its DDP wrapper under data parallelism,
    with `group` for the criterion's global normalizer); `nan_check`
    (utils/profiling.NanCheck) checks the loss and the backward."""
    model.train()
    checked = (nan_check.backward_checked() if nan_check is not None
               else contextlib.nullcontext())
    with checked:
        outputs = (forward or model)(preprocess_input(images, model))
        loss = criterion(outputs, targets, loss_weight=loss_weight,
                         num_classes=num_classes, ignore_index=ignore_index,
                         group=group)
        if nan_check is not None:
            nan_check.check_loss(loss)
        loss.backward()
    return loss


@dataclass
class DeviceBatch:
    """A host batch's tensors on the device; `ready` (CUDA only) is the
    event after their copy on the prefetch stream, None when copied on
    the current stream."""

    frames: torch.Tensor
    masks: torch.Tensor
    pk: Optional[torch.Tensor]
    sizes: np.ndarray
    ready: Optional[torch.cuda.Event] = None

    def tensors(self) -> Tuple[torch.Tensor, torch.Tensor,
                               Optional[torch.Tensor]]:
        """(frames, masks, pk), safe to use on the current stream."""
        if self.ready is not None:
            stream = torch.cuda.current_stream(self.frames.device)
            stream.wait_event(self.ready)
            for t in (self.frames, self.masks, self.pk):
                if t is not None:  # not reused before this stream is done
                    t.record_stream(stream)
        return self.frames, self.masks, self.pk


def batch_to_device(batch: Batch, device: torch.device,
                    stream: Optional[torch.cuda.Stream] = None
                    ) -> DeviceBatch:
    """Copy a host batch to `device`: with `stream` (CUDA), from pinned
    host memory on that stream, ending in an event the consumer waits
    for; else on the current stream."""
    arrays = (batch.frames, batch.masks, batch.pk)
    if stream is None:
        moved = [None if a is None else
                 torch.from_numpy(a).to(device, non_blocking=True)
                 for a in arrays]
        return DeviceBatch(*moved, sizes=batch.sizes)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        moved = [None if a is None else
                 torch.from_numpy(a).pin_memory().to(device,
                                                     non_blocking=True)
                 for a in arrays]
        ready = torch.cuda.Event()
        ready.record(stream)
    return DeviceBatch(*moved, sizes=batch.sizes, ready=ready)


def device_batches(batches: Iterable[Batch], device: torch.device,
                   depth: int) -> Iterator[DeviceBatch]:
    """The batches on the device, `depth` ahead of the consumer: a thread
    pins each and copies it on a side stream (the CPU copies there too).
    depth 0 copies each inline when it is consumed."""
    if depth <= 0:
        return (batch_to_device(b, device) for b in batches)
    stream = (torch.cuda.Stream(device) if device.type == "cuda"
              else None)
    return prefetch_iterator(
        (batch_to_device(b, device, stream) for b in batches), depth)


def train_step(state: TrainState, augment: TrainAugment,
               batch: Union[Batch, DeviceBatch], gen: torch.Generator,
               schedule: Callable[[int], float], num_classes: int,
               device: torch.device,
               loss_weight: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, float]:
    """One micro-step on a host (or already copied) batch: augment,
    forward, backward into the accumulated gradients; on the last
    micro-step of each accumulation window the AdamW apply at the
    window's lr, on the mean gradient, then the EMA update. Returns (loss
    on the device, the window's lr)."""
    if not isinstance(batch, DeviceBatch):
        batch = batch_to_device(batch, device)
    frames, masks, pk = batch.tensors()
    images, targets = augment(gen, frames, masks, batch.sizes, pk)
    k = state.grad_accum
    lr = schedule(state.step // k)
    if state.step % k == 0:
        state.optimizer.zero_grad(set_to_none=True)
    # the window's last micro-step all-reduces the summed gradients
    local = (state.ddp.no_sync() if state.ddp is not None
             and (state.step + 1) % k else contextlib.nullcontext())
    rows = contextlib.nullcontext()
    if state.group is not None and state.group.n_space > 1:
        rows = spatial.row_sharded(state.group, *images.shape[2:4])
        images = spatial.cut_rows(state.group, images, 2)
        targets = spatial.cut_rows(state.group, targets, 1)
    with local, rows:
        loss = loss_and_grads(state.model, images, targets, num_classes,
                              loss_weight=loss_weight,
                              forward=state.ddp, group=state.group,
                              nan_check=state.nan_check)
    if state.group is not None:
        loss = mesh_lib.all_sum(state.group, loss.detach().clone()) \
            / state.group.world
    state.step += 1
    if state.step % k == 0:
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        if k > 1:
            torch._foreach_div_([p.grad for p in state.model.parameters()
                                 if p.grad is not None], float(k))
        state.optimizer.step()
        state.update_ema()
    return loss.detach(), lr


def train_one_epoch(state: TrainState, loader: HostLoader,
                    augment: TrainAugment, seed: int, epoch: int,
                    schedule: Callable[[int], float], num_classes: int,
                    device: torch.device, *, print_freq: int = 10,
                    loss_weight: Optional[torch.Tensor] = None,
                    device_prefetch: int = 0, start_step: int = 0,
                    should_stop: Optional[Callable[[], bool]] = None
                    ) -> Tuple[float, float, int]:
    """One epoch (ref:train_and_eval.py:377-411): (mean loss, last lr,
    the step index reached in the epoch). The augmentation draws of step
    s come from augment_generator(seed, epoch, s). start_step re-enters
    the epoch after a preemption: its first batches are skipped
    undecoded and the draws continue from that index, as if never
    interrupted. should_stop (train/preempt.py) is polled after every
    step; device_prefetch batches are copied ahead (device_batches)."""
    logger = MetricLogger(delimiter="  ")
    logger.add_meter("lr", SmoothedValue(window_size=1, fmt="{value:.6f}"))
    pending = None  # the previous step's (loss, lr), read one step late
    step = start_step
    batches = device_batches(loader.epoch(epoch, skip_batches=start_step),
                             device, device_prefetch)
    for batch in _annotated(logger.log_every(
            batches, print_freq, f"Epoch: [{epoch}]",
            total=len(loader) - start_step), "data_wait"):
        with annotate("train_step"):
            loss, lr = train_step(state, augment, batch,
                                  augment_generator(seed, epoch, step),
                                  schedule, num_classes, device, loss_weight)
        if pending is not None:
            with annotate("loss_read"):
                logger.update(loss=pending[0].item(), lr=pending[1])
        pending = (loss, lr)
        step += 1
        if should_stop is not None and should_stop():
            break
    if pending is not None:
        logger.update(loss=pending[0].item(), lr=pending[1])
    last_lr = logger.meters["lr"].value if step > start_step else 0.0
    return logger.meters["loss"].global_avg, float(last_lr), step


def _annotated(items: Iterable, name: str) -> Iterator:
    """`items`, each wait for the next one inside a profiler range."""
    it = iter(items)
    while True:
        with annotate(name):
            try:
                item = next(it)
            except StopIteration:
                return
        yield item


@torch.inference_mode()
def evaluate(model, eval_batches: Iterable, num_classes: int, *,
             data_cfg, device: torch.device, print_freq: int = 100,
             collect_outputs: bool = False,
             reduce_across_processes: bool = False,
             group=None) -> Dict[str, Any]:
    """Validation/test pass (ref:train_and_eval.py:316-374) over
    (image [B, T, h, w, 1] uint8, target [B, h, w] uint8) batches, which
    are normalized on the device. Returns {dice, confusion_matrix,
    confusion_str, global_accuracy, class_metrics, mean_metrics}; with
    collect_outputs also "outputs" (host float32 logits [B, h, w, C] per
    batch) and "batches" (the consumed host (image, target) pairs, raw
    uint8: both viz helpers min-max normalize the image), for callers
    that render or aggregate per sample.

    Data parallelism: with reduce_across_processes=True each rank
    evaluated its own shard (eval_batches_from_index(host_index=,
    num_hosts=)); the confusion matrix, dice sums and image count are
    summed over the ranks, and every rank returns the same global
    metrics. The outputs stay the rank's own (gather_eval_outputs brings
    them to rank 0 in record order).

    Spatial parallelism (`group` a 2-D core/mesh.DataGroup; the ranks of
    a space group read the same batches): each rank runs the forward on
    its block of the image rows (row-sharded) and the logits' rows are
    gathered; a batch whose rows do not split over the space group runs
    whole on every rank. The space group's first rank alone counts the
    batch, so the sums cover each data shard once; its outputs are the
    only ones collected."""
    model.eval()
    space = group is not None and group.n_space > 1
    conf = confusion_init(num_classes, device)
    dice_cum = torch.zeros((num_classes,), dtype=torch.float32,
                           device=device)
    count = 0
    outputs, batches = [], []
    logger = MetricLogger(delimiter="  ")
    for host_image, host_target in logger.log_every(eval_batches,
                                                    print_freq, "Test:"):
        with annotate("eval_batch"):
            image = torch.from_numpy(host_image).to(device,
                                                    non_blocking=True)
            target = torch.from_numpy(host_target).to(device,
                                                      non_blocking=True)
            x = normalize(image, data_cfg.mean, data_cfg.std)
            if space and spatial.splits(x.shape[2], group.n_space):
                with spatial.row_sharded(group, *x.shape[2:4]):
                    logits = model(preprocess_input(
                        spatial.cut_rows(group, x, 2), model))["out"]
                logits = spatial.gather_rows(logits, group, dim=1)
            else:
                logits = model(preprocess_input(x, model))["out"]
            if space and group.space_index:
                continue
            target = target.long()
            conf = confusion_update(conf, target,
                                    torch.argmax(logits, dim=-1))
            dice_cum, count = eval_dice_update(dice_cum, count, logits,
                                               target, ignore_index=255)
            if collect_outputs:
                outputs.append(logits.cpu().numpy())
                batches.append((host_image, host_target))
    if reduce_across_processes and dist.is_initialized():
        sums = torch.tensor([count], dtype=torch.int64, device=device)
        for t in (conf, dice_cum, sums):
            dist.all_reduce(t)
        count = int(sums.item())
    mat = conf.cpu().numpy()
    report = confusion_report(mat)
    return {
        "dice": eval_dice_value(dice_cum, count),
        "confusion_matrix": mat,
        "confusion_str": format_confusion(mat),
        "global_accuracy": report["global_accuracy"],
        "class_metrics": report["class_metrics"],
        "mean_metrics": report["mean_metrics"],
        **({"outputs": outputs, "batches": batches} if collect_outputs
           else {}),
    }


def gather_eval_outputs(group, metrics: Dict[str, Any]) -> Dict[str, Any]:
    """Every rank's evaluate(collect_outputs=True) "outputs" and "batches"
    on rank 0, in the order of one process's pass: the ranks evaluated
    records[rank::world] (eval_batches_from_index's shards), so taking
    their batches in turn restores the record order at batch 1. Rank 0's
    metrics come back with them; the other ranks' without."""
    mine = (metrics.pop("outputs"), metrics.pop("batches"))
    parts = mesh_lib.gather_to_main(group, mine)
    if parts is None:
        return metrics
    for key, i in (("outputs", 0), ("batches", 1)):
        lists = [part[i] for part in parts]
        metrics[key] = [lst[k] for k in range(max(map(len, lists)))
                        for lst in lists if k < len(lst)]
    return metrics


class CachedEvalBatches:
    """Replayable eval batches: the first whole pass decodes and resizes
    (through `factory()`) and keeps every uint8 (image, target) batch;
    later passes replay them byte for byte (--data-cache-ram's val set).
    A pass cut short caches nothing."""

    def __init__(self, factory: Callable):
        self._factory = factory
        self._items: list = []
        self._complete = False

    def __iter__(self):
        if self._complete:
            yield from self._items
            return
        self._items = []
        for batch in self._factory():
            self._items.append(batch)
            yield batch
        self._complete = True


def eval_batches_from_index(index, cfg, *, use_pk_maps: bool = False,
                            batch_size: int = 1, prefetch: int = 2,
                            pack=None, host_index: int = 0,
                            num_hosts: int = 1):
    """Eval-preprocessed uint8 (image, target) batches from a DatasetIndex:
    the PIL-parity resize runs on a background thread, normalization on
    the device (evaluate). batch_size > 1 groups same-shape samples, so a
    batched evaluation equals the per-sample one. With PK maps each image
    carries the three maps after its frames. Samples are decoded by the
    native decoder when it builds (data/native_loader), else PIL; with a
    dataset `pack` (data/pack.py, validated against the index now, not
    at the first batch) they come from its eval store when that matches
    the crop and PK selection, else from its decoded samples. Under data
    parallelism rank host_index of num_hosts takes records[host::n] (a
    disjoint cover; evaluate(reduce_across_processes=True) sums the
    ranks' metrics)."""
    mask_format = cfg.mask_format
    mine = range(len(index))[host_index::num_hosts]
    if pack is not None:
        pack.validate(index, mask_format=mask_format,
                      use_pk_maps=use_pk_maps)

    def sample_iter():
        if pack is not None and pack.serves_eval(cfg.crop_size, use_pk_maps):
            for i in mine:
                yield pack.eval_sample(i)
            return
        if pack is not None:
            for i in mine:
                frames, mask, pk, _ = pack.sample(i, use_pk_maps=use_pk_maps)
                yield eval_preprocess(frames, mask, cfg, pk, raw=True)
            return
        for rec in (index.records[i] for i in mine):
            frames, mask, pk = load_sample_raw_native(rec, use_pk_maps,
                                                      mask_format)
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
