"""Host-side data loading: decode + batch assembly + prefetch (counterpart
of stf_unet_tpu/data/loader.py).

The host only decodes and batches raw uint8 frames; the augmentation runs
on the device (data/transforms.TrainAugment, kernel K2). A background
thread decodes the next batches while the device computes. Decoding goes
through the native C++ decoder (data/native_loader) when it builds, else
PIL, to the same bytes. A RAM cache keeps the decoded samples after the
first epoch; a dataset pack (data/pack.py) serves them decode-free.
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


PK_PARAM_NAMES = ("ktrans", "ve", "vp")  # ref:my_dataset.py:203


def load_pk_stack(pk_dir: str, h: int, w: int,
                  warn: bool = False) -> np.ndarray:
    """[3, H, W] uint8 ktrans/ve/vp stack from `pk_dir/{name}.png`.
    Off-resolution maps NEAREST-resize to (h, w) (PIL, as
    ref:my_dataset.py:214); missing or unreadable maps zero-fill
    (ref:206-224), printing a warning when asked."""
    maps = []
    for name in PK_PARAM_NAMES:
        path = f"{pk_dir}/{name}.png"
        try:
            arr = _decode_grayscale(path)
            if arr.shape != (h, w):
                arr = np.asarray(
                    Image.fromarray(arr).resize((w, h), Image.NEAREST))
        except OSError:  # missing or unreadable: zero-fill, as the reference
            if warn:
                print(f"Warning: PK map {path} unreadable — zero-filling")
            arr = np.zeros((h, w), dtype=np.uint8)
        maps.append(arr)
    return np.stack(maps)


def load_sample_raw(rec: SampleRecord, use_pk_maps: bool = False,
                    mask_format: str = "binary"
                    ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """-> (frames uint8 [T, H, W], mask uint8 [H, W], pk uint8 [3, H, W]
    or None).

    mask_format="binary": //255-binarized like the reference; "index":
    mask pixels already hold class indices. The PK maps come from the
    record's pk_maps directory at the frames' size."""
    frames = decode_stack(rec.image_paths)
    with Image.open(rec.mask_path) as m:
        mask = np.asarray(m.convert("L"), dtype=np.uint16)
        if mask_format == "binary":
            mask = mask // 255
        mask = mask.astype(np.uint8)
    pk = None
    if use_pk_maps:
        pk = load_pk_stack(rec.pk_maps_path, *frames.shape[1:])
    return frames, mask, pk


def load_sample_raw_native(rec: SampleRecord, use_pk_maps: bool = False,
                           mask_format: str = "binary"
                           ) -> Tuple[np.ndarray, np.ndarray,
                                      Optional[np.ndarray]]:
    """load_sample_raw through the native decoder (the same contract and
    bytes): frames and mask in one threaded call at the first frame's
    size, the maps in another; the PIL path when the library is missing
    or any file fails to decode there (a sample is never zeroed)."""
    from stf_unet_tpu_torch.data import native_loader

    if not native_loader.native_available():
        return load_sample_raw(rec, use_pk_maps, mask_format)
    size = native_loader.image_size(rec.image_paths[0])
    if size is None:
        return load_sample_raw(rec, use_pk_maps, mask_format)
    h, w = size
    canvas, sizes = native_loader.decode_batch(
        list(rec.image_paths) + [rec.mask_path], h, w)
    if not all(tuple(sz) == (h, w) for sz in sizes):
        return load_sample_raw(rec, use_pk_maps, mask_format)
    frames, mask = canvas[:-1], canvas[-1]
    if mask_format == "binary":
        mask = mask // 255
    mask = mask.astype(np.uint8)
    pk = None
    if use_pk_maps:
        paths = [f"{rec.pk_maps_path}/{n}.png" for n in PK_PARAM_NAMES]
        pk_canvas, pk_sizes = native_loader.decode_batch(paths, h, w)
        if all(tuple(sz) == (h, w) for sz in pk_sizes):
            pk = pk_canvas
        else:  # off-size or unreadable maps: the PIL rules
            pk = load_pk_stack(rec.pk_maps_path, h, w)
    return frames, mask, pk


@dataclass
class Batch:
    """Raw uint8 host batch; the device transforms consume it directly."""

    frames: np.ndarray          # [B, T, H, W] uint8
    masks: np.ndarray           # [B, H, W] uint8 (255 = canvas padding)
    sizes: np.ndarray           # [B, 2] valid (h, w) before padding
    pk: Optional[np.ndarray] = None  # [B, 3, H, W] uint8 (0 = padding)


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
    visit the same samples in the same order.

    Samples decode through the native decoder when `use_native` (default:
    when it builds), else PIL, to the same bytes; the loader prints which
    on a line of its own. cache_ram keeps each decoded sample after its
    first batch, so later epochs only stack; a `pack` (data/pack.py)
    serves every batch from its memory maps (its canvas wins, and the
    cache is moot).

    Under data parallelism each of `num_hosts` ranks loads its own shard:
    every rank draws the same seeded permutation and takes
    order[host_index::num_hosts], cut to the common floor so that every
    rank yields the same number of batches (`batch_size` is then the
    rank's local batch)."""

    def __init__(self, index: DatasetIndex, batch_size: int, *,
                 shuffle: bool, seed: int = 0, use_pk_maps: bool = False,
                 drop_last: bool = False,
                 canvas_multiple: int = 32, prefetch: int = 2,
                 mask_format: str = "binary",
                 use_native: Optional[bool] = None, cache_ram: bool = False,
                 pack=None, verbose: bool = True, host_index: int = 0,
                 num_hosts: int = 1):
        self.index = index
        self.batch_size = batch_size
        self.host_index = host_index
        self.num_hosts = num_hosts
        self.shuffle = shuffle
        self.seed = seed
        self.use_pk_maps = use_pk_maps
        self.mask_format = mask_format
        self.drop_last = drop_last
        self.canvas_multiple = canvas_multiple
        self.prefetch = prefetch
        self.pack = pack
        if pack is not None:
            pack.validate(index, mask_format=mask_format,
                          use_pk_maps=use_pk_maps)
            if cache_ram:
                print("note: --data-cache-ram ignored — the dataset pack "
                      "already serves decoded bytes")
                cache_ram = False
            use_native = False
        elif use_native is None:
            from stf_unet_tpu_torch.data import native_loader
            use_native = native_loader.native_available()
        self.use_native = bool(use_native)
        if verbose:
            print("host decoder: " + (
                "none (dataset pack)" if pack is not None else
                "native C++ (libjpeg / libpng)" if self.use_native
                else "PIL"))
        self.canvas: Optional[Tuple[int, int]] = (
            pack.canvas if pack is not None
            else self._probe_canvas() if len(index) > 0 else None)
        self._cache: dict = {}
        self.cache_ram = bool(cache_ram) and self.canvas is not None
        if self.cache_ram and verbose:
            ch, cw = self.canvas
            t = len(index.records[0].image_paths)
            per = (t + 1 + (3 if use_pk_maps else 0)) * ch * cw
            n = len(index) // num_hosts
            print(f"RAM cache: ~{n * per / 2**30:.2f} GiB of "
                  f"decoded uint8 samples after the first epoch")

    def _probe_canvas(self) -> Tuple[int, int]:
        from stf_unet_tpu_torch.data import native_loader

        max_h = max_w = 1
        for rec in self.index.records:
            size = (native_loader.image_size(rec.image_paths[0])
                    if self.use_native else None)
            if size is None:
                with Image.open(rec.image_paths[0]) as im:  # header only
                    size = (im.height, im.width)
            max_h = max(max_h, size[0])
            max_w = max(max_w, size[1])
        cm = self.canvas_multiple
        return (-(-max_h // cm) * cm, -(-max_w // cm) * cm)

    def __len__(self) -> int:
        n = len(self.index) // self.num_hosts
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _make_batch(self, recs: List[SampleRecord]) -> Batch:
        if self.use_native:
            return self._make_batch_native(recs)
        samples = [load_sample_raw(r, self.use_pk_maps, self.mask_format)
                   for r in recs]
        sizes = np.asarray([s[0].shape[1:] for s in samples], dtype=np.int32)
        frames = _pad_canvas([s[0] for s in samples], self.canvas, fill=0)
        masks = _pad_canvas([s[1] for s in samples], self.canvas, fill=255)
        pk = None
        if self.use_pk_maps:
            pk = _pad_canvas([s[2] for s in samples], self.canvas, fill=0)
        return Batch(frames=frames, masks=masks, sizes=sizes, pk=pk)

    def _make_batch_native(self, recs: List[SampleRecord]) -> Batch:
        """One threaded native decode call per tensor kind onto the
        canvas (the JAX package's native batch path), the same bytes as
        _make_batch's PIL path."""
        from stf_unet_tpu_torch.data import native_loader

        b, t = len(recs), len(recs[0].image_paths)
        ch, cw = self.canvas
        canvas, fsizes = native_loader.decode_batch(
            [p for r in recs for p in r.image_paths], ch, cw, fill=0)
        frames = canvas.reshape(b, t, ch, cw)
        sizes = fsizes.reshape(b, t, 2)[:, 0, :].copy()
        mask_canvas, msizes = native_loader.decode_batch(
            [r.mask_path for r in recs], ch, cw, fill=0)
        masks = np.full((b, ch, cw), 255, dtype=np.uint8)
        for i in range(b):
            h, w = msizes[i]
            # "binary": //255 as the PIL path; "index": class indices;
            # the padding stays 255
            m = mask_canvas[i, :h, :w]
            masks[i, :h, :w] = m // 255 if self.mask_format == "binary" \
                else m
        pk = None
        if self.use_pk_maps:
            pk_canvas, pk_sizes = native_loader.decode_batch(
                [f"{r.pk_maps_path}/{n}.png" for r in recs
                 for n in PK_PARAM_NAMES], ch, cw, fill=0)
            pk = pk_canvas.reshape(b, 3, ch, cw)
            pk_sizes = pk_sizes.reshape(b, 3, 2)
            for i, r in enumerate(recs):
                if (pk_sizes[i] != sizes[i]).any():
                    # off-size or unreadable maps: the PIL rules (NEAREST
                    # resize, zero-fill), where the JAX package's native
                    # batch path would leave an off-size map unresized
                    h, w = sizes[i]
                    pk[i] = 0
                    pk[i, :, :h, :w] = load_pk_stack(r.pk_maps_path, h, w)
        return Batch(frames=frames, masks=masks, sizes=sizes, pk=pk)

    def _cached_batch(self, idxs: List[int]) -> Batch:
        """A batch from the RAM cache, decoding (and keeping) the samples
        it lacks through the normal batch path first."""
        missing = [i for i in idxs if i not in self._cache]
        if missing:
            fresh = self._make_batch([self.index[i] for i in missing])
            for j, i in enumerate(missing):
                self._cache[i] = (fresh.frames[j], fresh.masks[j],
                                  None if fresh.pk is None else fresh.pk[j],
                                  fresh.sizes[j])
        samples = [self._cache[i] for i in idxs]
        return Batch(
            frames=np.stack([s[0] for s in samples]),
            masks=np.stack([s[1] for s in samples]),
            sizes=np.stack([s[3] for s in samples]),
            pk=(np.stack([s[2] for s in samples])
                if samples[0][2] is not None else None))

    def epoch(self, epoch_num: int = 0,
              skip_batches: int = 0) -> Iterator[Batch]:
        """One seeded epoch. skip_batches drops the first N batches
        without decoding them (a mid-epoch resume replays exactly the
        rest)."""
        order = np.arange(len(self.index))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch_num)
            rng.shuffle(order)
        if self.num_hosts > 1:
            per_host = len(order) // self.num_hosts
            order = order[self.host_index::self.num_hosts][:per_host]
        if self.drop_last:
            order = order[: len(self) * self.batch_size]
        chunks = [[int(i) for i in order[i:i + self.batch_size]]
                  for i in range(0, len(order), self.batch_size)]
        chunks = chunks[skip_batches:]
        if self.pack is not None:
            batches = (self.pack.batch(c, use_pk_maps=self.use_pk_maps)
                       for c in chunks)
        elif self.cache_ram:
            batches = (self._cached_batch(c) for c in chunks)
        else:
            batches = (self._make_batch([self.index[i] for i in c])
                       for c in chunks)
        yield from prefetch_iterator(batches, self.prefetch)
