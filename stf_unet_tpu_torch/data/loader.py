"""Host-side data loading: decode + batch assembly + prefetch (counterpart
of stf_unet_tpu/data/loader.py, PIL decode path).

The host only decodes and batches raw uint8 frames; the augmentation runs
on the device (data/transforms.TrainAugment, kernel K2). A background
thread decodes the next batches while the device computes. The JAX
package's native C++ decoder, its RAM cache and dataset packs are not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from stf_unet_tpu_torch.data.index import DatasetIndex, SampleRecord


def prefetch_iterator(iterable, prefetch: int):
    """Drain `iterable` on a background thread, `prefetch` items deep.
    prefetch <= 0 degrades to plain iteration. Producer exceptions are
    re-raised in the consumer (never a silently truncated epoch). A
    consumer that abandons the generator early cancels the producer
    instead of leaving it blocked on a full queue."""
    if prefetch <= 0:
        yield from iterable
        return

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = object()
    cancelled = threading.Event()

    def put(item) -> bool:
        while not cancelled.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterable:
                if not put((None, item)):
                    return
            put(stop)
        except BaseException as e:  # noqa: BLE001 - surfaced in the consumer
            put((e, None))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                break
            err, value = item
            if err is not None:
                raise RuntimeError("data prefetch thread failed") from err
            yield value
    finally:
        cancelled.set()
        t.join()


def _decode_grayscale(path: str) -> np.ndarray:
    """uint8 [H, W]; PIL decodes any path encoding."""
    with Image.open(path) as img:
        return np.asarray(img.convert("L"), dtype=np.uint8)


def decode_stack(paths: Sequence[str]) -> np.ndarray:
    """uint8 [N, H, W] stack of same-size grayscale images."""
    return np.stack([_decode_grayscale(p) for p in paths])


def load_sample_raw(rec: SampleRecord, use_pk_maps: bool = False,
                    mask_format: str = "binary"
                    ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """-> (frames uint8 [T, H, W], mask uint8 [H, W], None).

    mask_format="binary": //255-binarized like the reference; "index":
    mask pixels already hold class indices."""
    if use_pk_maps:
        raise NotImplementedError(
            "PK maps are not ported yet (ROADMAP.md §1, 'PK')")
    frames = decode_stack(rec.image_paths)
    with Image.open(rec.mask_path) as m:
        mask = np.asarray(m.convert("L"), dtype=np.uint16)
        if mask_format == "binary":
            mask = mask // 255
        mask = mask.astype(np.uint8)
    return frames, mask, None


@dataclass
class Batch:
    """Raw uint8 host batch; the device transforms consume it directly."""

    frames: np.ndarray          # [B, T, H, W] uint8
    masks: np.ndarray           # [B, H, W] uint8 (255 = canvas padding)
    sizes: np.ndarray           # [B, 2] valid (h, w) before padding


def _pad_canvas(arrs: Sequence[np.ndarray], canvas: Tuple[int, int],
                fill: int = 0) -> np.ndarray:
    """Stack variable-size [..., H, W] arrays onto a fixed canvas,
    top-left anchored, like the reference's cat_list."""
    out_shape = (len(arrs),) + arrs[0].shape[:-2] + canvas
    out = np.full(out_shape, fill, dtype=arrs[0].dtype)
    for i, a in enumerate(arrs):
        out[i, ..., :a.shape[-2], :a.shape[-1]] = a
    return out


class HostLoader:
    """Epoch iterator of shuffled batches of raw uint8 samples.

    Every batch shares one dataset-wide canvas (the largest slice, rounded
    up to `canvas_multiple`): image fill 0, mask fill 255, the
    ignore/padding label. The shuffle of epoch e is
    numpy.default_rng(seed + e), as in the JAX package, so both packages
    visit the same samples in the same order."""

    def __init__(self, index: DatasetIndex, batch_size: int, *,
                 shuffle: bool, seed: int = 0, drop_last: bool = False,
                 canvas_multiple: int = 32, prefetch: int = 2,
                 mask_format: str = "binary"):
        self.index = index
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.mask_format = mask_format
        self.drop_last = drop_last
        self.canvas_multiple = canvas_multiple
        self.prefetch = prefetch
        self.canvas: Optional[Tuple[int, int]] = (
            self._probe_canvas() if len(index) > 0 else None)

    def _probe_canvas(self) -> Tuple[int, int]:
        max_h = max_w = 1
        for rec in self.index.records:
            with Image.open(rec.image_paths[0]) as im:  # header only
                max_h = max(max_h, im.height)
                max_w = max(max_w, im.width)
        cm = self.canvas_multiple
        return (-(-max_h // cm) * cm, -(-max_w // cm) * cm)

    def __len__(self) -> int:
        n = len(self.index)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _make_batch(self, recs: List[SampleRecord]) -> Batch:
        samples = [load_sample_raw(r, mask_format=self.mask_format)
                   for r in recs]
        sizes = np.asarray([s[0].shape[1:] for s in samples], dtype=np.int32)
        frames = _pad_canvas([s[0] for s in samples], self.canvas, fill=0)
        masks = _pad_canvas([s[1] for s in samples], self.canvas, fill=255)
        return Batch(frames=frames, masks=masks, sizes=sizes)

    def epoch(self, epoch_num: int = 0,
              skip_batches: int = 0) -> Iterator[Batch]:
        """One seeded epoch. skip_batches drops the first N batches
        without decoding them."""
        order = np.arange(len(self.index))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch_num)
            rng.shuffle(order)
        if self.drop_last:
            order = order[: len(self) * self.batch_size]
        chunks = [order[i:i + self.batch_size]
                  for i in range(0, len(order), self.batch_size)]
        batches = (self._make_batch([self.index[int(i)] for i in chunk])
                   for chunk in chunks[skip_batches:])
        yield from prefetch_iterator(batches, self.prefetch)
