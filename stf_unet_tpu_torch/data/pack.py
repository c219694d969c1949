"""Packed dataset format: one-time decode into memmappable uint8 blobs
(counterpart of stf_unet_tpu/data/pack.py, byte-compatible with it: a
pack written by either package reads in the other).

The reference re-decodes every JPEG/PNG in DataLoader workers each epoch
(ref:my_dataset.py:143-179); in the port's cli/train the PNG decode on
one loader thread sets the pace of an epoch (PERF.md §5).
``--data-cache-ram`` fixes epochs >= 1 but still decodes epoch 0 and holds
the whole dataset in RAM. A pack decodes ONCE (``python -m
stf_unet_tpu_torch.cli.pack``), then every run memory-maps canvas-packed
uint8 samples straight off the page cache — zero decode at train time,
zero RAM requirement, identical bytes.

Layout of a pack directory (one per split):

    meta.json   version, canvas, T, N, mask_format, has_pk, record keys
    frames.u8   [N, T, H, W] uint8 (canvas-padded, fill 0)
    masks.u8    [N, H, W]    uint8 (processed labels; pad/ignore 255)
    sizes.i32   [N, 2]       int32 original (h, w) per sample
    pk.u8       [N, 3, H, W] uint8 (only when packed with PK maps)

and, when built with ``eval_size`` (the val/test default in cli/pack), the
EVAL-GEOMETRY store — the exact eval_preprocess(raw=True) output (PIL-parity
short-edge resize to eval_size, ref:train.py:70-74) materialized at pack
time so val/test epochs skip the host resize too:

    eval_frames.u8  [N, TC, EH, EW] uint8 (TC = T (+3 with PK); eval-canvas
                    padded, fill 0 — per-sample extents in eval_sizes)
    eval_masks.u8   [N, EH, EW]     uint8 (nearest-resized labels)
    eval_sizes.i32  [N, 2]          int32 resized (h', w') per sample

Masks are stored POST label decode (binary //255 like ref:my_dataset.py:
166-168, or raw class indices for ``mask_format="index"``), exactly the
form HostLoader batches hold — so pack-fed batches are byte-identical to
decode-fed ones (pinned by tests/test_torch_pack.py).

The writer drives the normal HostLoader decode path (native C++ decoder
when available), so a pack inherits every decode-parity guarantee the
loader has.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from stf_unet_tpu_torch.data.index import DatasetIndex
from stf_unet_tpu_torch.data.loader import Batch, HostLoader

PACK_VERSION = 1
_META = "meta.json"
_FRAMES = "frames.u8"
_MASKS = "masks.u8"
_SIZES = "sizes.i32"
_PK = "pk.u8"
_EVAL_FRAMES = "eval_frames.u8"
_EVAL_MASKS = "eval_masks.u8"
_EVAL_SIZES = "eval_sizes.i32"


def record_key(rec) -> str:
    """Stable, root-independent identity of a sample: patient id, the
    first frame's sequence directory (so VIBRANT vs SUB packs can never be
    confused — both have 8 frames and identical slice filenames), and the
    slice filename. Used to detect a pack built from a different (or
    since-modified) dataset."""
    seq_dir = os.path.basename(os.path.dirname(rec.image_paths[0]))
    return (f"{rec.patient_id}/{seq_dir}/"
            f"{os.path.basename(rec.image_paths[0])}")


def write_pack(index: DatasetIndex, out_dir: str, *,
               use_pk_maps: bool = False, mask_format: str = "binary",
               canvas_multiple: int = 32, batch_size: int = 16,
               use_native: Optional[bool] = None,
               eval_size: Optional[int] = None,
               progress=None) -> dict:
    """Decode every sample of `index` once and write the pack to `out_dir`.

    Returns the meta dict. Decoding reuses HostLoader's batch path
    (threaded native decode when available) in index order with a
    dataset-wide fixed canvas, so packed bytes match what the live loader
    would produce.

    eval_size additionally materializes the EVAL-GEOMETRY store: each
    sample run through eval_preprocess(raw=True) (PIL-parity short-edge
    resize to eval_size) at pack time, so val/test epochs become pure
    page-cache reads — no decode AND no host resize
    (eval_batches_from_index uses it automatically when the run's
    crop_size matches).
    """
    if len(index) == 0:
        raise ValueError("refusing to pack an empty dataset index")
    os.makedirs(out_dir, exist_ok=True)

    loader = HostLoader(index, batch_size, shuffle=False,
                        use_pk_maps=use_pk_maps, mask_format=mask_format,
                        canvas_multiple=canvas_multiple, prefetch=2,
                        use_native=use_native)
    assert loader.canvas is not None
    ch, cw = loader.canvas
    n = len(index)
    t = len(index.records[0].image_paths)

    frames = np.lib.format.open_memmap(
        os.path.join(out_dir, _FRAMES), mode="w+", dtype=np.uint8,
        shape=(n, t, ch, cw))
    masks = np.lib.format.open_memmap(
        os.path.join(out_dir, _MASKS), mode="w+", dtype=np.uint8,
        shape=(n, ch, cw))
    sizes = np.lib.format.open_memmap(
        os.path.join(out_dir, _SIZES), mode="w+", dtype=np.int32,
        shape=(n, 2))
    pk = None
    if use_pk_maps:
        pk = np.lib.format.open_memmap(
            os.path.join(out_dir, _PK), mode="w+", dtype=np.uint8,
            shape=(n, 3, ch, cw))

    i = 0
    for batch in loader.epoch(0):
        b = batch.frames.shape[0]
        frames[i:i + b] = batch.frames
        masks[i:i + b] = batch.masks
        sizes[i:i + b] = batch.sizes
        if pk is not None:
            pk[i:i + b] = batch.pk
        i += b
        if progress is not None:
            progress(i, n)
    assert i == n, f"pack wrote {i} of {n} samples"
    for mm in (frames, masks, sizes) + ((pk,) if pk is not None else ()):
        mm.flush()

    meta = {
        "version": PACK_VERSION,
        "n": n,
        "t": t,
        "canvas": [ch, cw],
        "mask_format": mask_format,
        "has_pk": bool(use_pk_maps),
        "mode": index.mode,
        "record_keys": [record_key(r) for r in index.records],
    }
    if eval_size is not None and eval_size > 0:
        meta.update(_write_eval_store(out_dir, frames, masks, sizes, pk,
                                      eval_size))
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump(meta, f)
    return meta


def _write_eval_store(out_dir: str, frames, masks, sizes, pk,
                      eval_size: int) -> dict:
    """Run every (unpadded) sample through the EXACT live eval transform
    (data/transforms.eval_preprocess raw=True) and store the results on an
    eval canvas. Byte-identity with the live path is by construction —
    same function, same inputs."""
    from stf_unet_tpu_torch.core.config import DataConfig
    from stf_unet_tpu_torch.data.transforms import eval_preprocess
    from stf_unet_tpu_torch.ops.resize import short_edge_size

    cfg = DataConfig(crop_size=eval_size)
    n = frames.shape[0]
    # The eval canvas is derivable from the original sizes alone (the
    # resize geometry is pure arithmetic), so samples stream one at a time
    # into the memmaps — the store is never resident in RAM.
    eh = ew = 0
    for i in range(n):
        h, w = (int(x) for x in sizes[i])
        rh, rw = short_edge_size(h, w, eval_size)
        eh, ew = max(eh, rh), max(ew, rw)
    tc = frames.shape[1] + (3 if pk is not None else 0)

    ef = np.lib.format.open_memmap(
        os.path.join(out_dir, _EVAL_FRAMES), mode="w+", dtype=np.uint8,
        shape=(n, tc, eh, ew))
    em = np.lib.format.open_memmap(
        os.path.join(out_dir, _EVAL_MASKS), mode="w+", dtype=np.uint8,
        shape=(n, eh, ew))
    es = np.lib.format.open_memmap(
        os.path.join(out_dir, _EVAL_SIZES), mode="w+", dtype=np.int32,
        shape=(n, 2))
    ef[:] = 0
    em[:] = 0
    for i in range(n):
        h, w = (int(x) for x in sizes[i])
        imgs, mask_r = eval_preprocess(
            np.asarray(frames[i, :, :h, :w]), np.asarray(masks[i, :h, :w]),
            cfg, None if pk is None else np.asarray(pk[i, :, :h, :w]),
            raw=True)
        imgs = imgs[..., 0]  # [TC, h', w'] uint8
        _, sh, sw = imgs.shape
        assert sh <= eh and sw <= ew and imgs.shape[0] == tc
        ef[i, :, :sh, :sw] = imgs
        em[i, :sh, :sw] = mask_r
        es[i] = (sh, sw)
    for mm in (ef, em, es):
        mm.flush()
    return {"eval_size": int(eval_size), "eval_canvas": [eh, ew],
            "eval_has_pk": pk is not None}


class DatasetPack:
    """Read side: memory-mapped access to a pack written by write_pack.

    ``batch(idxs)`` returns a loader-compatible Batch; ``sample(i)``
    returns the unpadded (frames, mask, pk, (h, w)) of one sample for the
    eval path. Both are plain page-cache reads — no decode, no RAM pin.
    """

    def __init__(self, pack_dir: str):
        meta_path = os.path.join(pack_dir, _META)
        if not os.path.exists(meta_path):
            raise FileNotFoundError(
                f"no pack at '{pack_dir}' (missing {_META}); build one "
                f"with: python -m stf_unet_tpu_torch.cli.pack")
        with open(meta_path) as f:
            self.meta = json.load(f)
        if self.meta.get("version") != PACK_VERSION:
            raise ValueError(
                f"pack version {self.meta.get('version')} != "
                f"{PACK_VERSION}; rebuild with cli/pack")
        self.pack_dir = pack_dir
        self.n = int(self.meta["n"])
        self.t = int(self.meta["t"])
        self.canvas: Tuple[int, int] = tuple(self.meta["canvas"])
        self.mask_format: str = self.meta["mask_format"]
        self.has_pk: bool = bool(self.meta["has_pk"])
        mm = lambda name: np.load(os.path.join(pack_dir, name),  # noqa: E731
                                  mmap_mode="r")
        self._frames = mm(_FRAMES)
        self._masks = mm(_MASKS)
        self._sizes = mm(_SIZES)
        self._pk = mm(_PK) if self.has_pk else None
        # Eval-geometry store (optional; packs written before it existed —
        # or with --eval-size 0 — simply fall back to the live resize).
        self.eval_size: Optional[int] = self.meta.get("eval_size")
        self.eval_has_pk: bool = bool(self.meta.get("eval_has_pk", False))
        if self.eval_size:
            self._eval_frames = mm(_EVAL_FRAMES)
            self._eval_masks = mm(_EVAL_MASKS)
            self._eval_sizes = mm(_EVAL_SIZES)

    def __len__(self) -> int:
        return self.n

    def validate(self, index: DatasetIndex, *, mask_format: str,
                 use_pk_maps: bool) -> None:
        """Refuse to serve a pack that doesn't match the live dataset /
        run configuration — a stale pack must fail loudly, not train on
        wrong bytes."""
        if mask_format != self.mask_format:
            raise ValueError(
                f"pack was built with mask_format='{self.mask_format}' "
                f"but the run wants '{mask_format}'; rebuild the pack")
        if use_pk_maps and not self.has_pk:
            raise ValueError(
                "run wants PK maps but the pack was built without "
                "--use-pk-maps; rebuild the pack")
        if index.mode != self.meta.get("mode"):
            raise ValueError(
                f"pack was built from the '{self.meta.get('mode')}' split "
                f"but is being served to '{index.mode}'")
        if len(index) != self.n:
            raise ValueError(
                f"pack holds {self.n} samples but the dataset index has "
                f"{len(index)}; the dataset changed — rebuild the pack")
        keys = self.meta["record_keys"]
        for i, rec in enumerate(index.records):  # every key — string
            live = record_key(rec)               # compares are cheap
            if keys[i] != live:
                raise ValueError(
                    f"pack record {i} is '{keys[i]}' but the dataset has "
                    f"'{live}'; the dataset (or sequence selection) "
                    "changed — rebuild the pack")

    def batch(self, idxs: Sequence[int], *, use_pk_maps: bool) -> Batch:
        idxs = np.asarray(idxs, dtype=np.int64)
        return Batch(
            frames=np.asarray(self._frames[idxs]),
            masks=np.asarray(self._masks[idxs]),
            pk=(np.asarray(self._pk[idxs]) if use_pk_maps else None),
            sizes=np.asarray(self._sizes[idxs]))

    def sample(self, i: int, *, use_pk_maps: bool
               ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray],
                          Tuple[int, int]]:
        h, w = (int(x) for x in self._sizes[i])
        frames = np.asarray(self._frames[i, :, :h, :w])
        mask = np.asarray(self._masks[i, :h, :w])
        pk = np.asarray(self._pk[i, :, :h, :w]) if use_pk_maps else None
        return frames, mask, pk, (h, w)

    def serves_eval(self, crop_size: int, use_pk_maps: bool) -> bool:
        """True when the pre-materialized eval store matches this run's
        eval geometry and PK selection (else callers fall back to the
        live eval_preprocess over `sample`)."""
        return (self.eval_size == crop_size
                and self.eval_has_pk == use_pk_maps)

    def eval_sample(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """The stored eval_preprocess(raw=True) output of sample i:
        (uint8 [TC, h', w', 1], uint8 [h', w'])."""
        if not self.eval_size:
            raise ValueError("pack has no eval store; rebuild with "
                             "cli/pack --eval-size")
        sh, sw = (int(x) for x in self._eval_sizes[i])
        imgs = np.asarray(self._eval_frames[i, :, :sh, :sw])
        mask = np.asarray(self._eval_masks[i, :sh, :sw])
        return imgs[..., None], mask


def open_split_pack(pack_root: str, mode: str) -> "DatasetPack":
    """Open `<pack_root>/<mode>` (the layout cli/pack writes: one
    subdirectory per split named by its mode key: train/val/test)."""
    return DatasetPack(os.path.join(pack_root, mode))
