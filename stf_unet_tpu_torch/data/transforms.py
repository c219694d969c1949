"""Eval-path preprocessing (the serving subset of
stf_unet_tpu/data/transforms.py): exact PIL short-edge resize of uint8
frames on the host, and the (x/255 - mean)/std normalization that the
engine runs on the device."""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from stf_unet_tpu_torch.core.config import DataConfig
from stf_unet_tpu_torch.ops.resize import (_nearest_indices,
                                           pil_resize_weights,
                                           short_edge_size)


@functools.lru_cache(maxsize=64)
def _banded_resize_taps(in_size: int, out_size: int):
    """PIL's resize matrix (ops/resize.pil_resize_weights) is banded: each
    output row draws from a short contiguous run of input rows. Return
    (idx [out, K], wgt [out, K]) so the resample is a gather + K-tap
    weighted sum instead of a dense [out, in] matmul."""
    wm = pil_resize_weights(in_size, out_size)
    nz = wm != 0.0
    k = max(1, int(nz.sum(axis=1).max()))
    idx = np.zeros((out_size, k), np.intp)
    wgt = np.zeros((out_size, k), np.float64)
    for o in range(out_size):
        cols = np.nonzero(nz[o])[0]
        idx[o, :len(cols)] = cols
        wgt[o, :len(cols)] = wm[o, cols]
    return idx, wgt


def banded_resize_u8(x: np.ndarray, out_h: int, out_w: int,
                     idx_h: np.ndarray, wgt_h: np.ndarray,
                     idx_w: np.ndarray, wgt_w: np.ndarray) -> np.ndarray:
    """Apply banded PIL-parity resize taps to uint8 planes [N, H, W] ->
    [N, out_h, out_w]: f64 vertical then horizontal passes in ascending-k
    order, round-half-even, clip. This is the JAX package's numpy path,
    which it keeps bit-identical to its native C++ resize."""
    xf = x.astype(np.float64)
    y = np.zeros((x.shape[0], out_h, x.shape[2]), np.float64)
    for k in range(idx_h.shape[1]):
        y += wgt_h[None, :, k, None] * xf[:, idx_h[:, k], :]
    z = np.zeros((x.shape[0], out_h, out_w), np.float64)
    for k in range(idx_w.shape[1]):
        z += wgt_w[None, None, :, k] * y[:, :, idx_w[:, k]]
    return np.clip(np.round(z), 0, 255).astype(np.uint8)


def normalize(img: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    """uint8/float [0,255] -> normalized float32 (ToTensor + Normalize)."""
    return (img.to(torch.float32) / 255.0 - mean) / std


def eval_preprocess(frames: np.ndarray, mask: np.ndarray, cfg: DataConfig,
                    pk: np.ndarray = None, *,
                    raw: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Eval transform for ONE sample: PIL-parity short-edge resize to
    crop_size + normalize.

    frames uint8 [T, H, W] -> ([T(+3), h', w', 1] float32, [h', w'] int32).
    raw=True keeps the same resize, skips normalization and returns uint8
    images + uint8 mask: the engine normalizes on the device, so the host
    ships 4x fewer bytes.
    """
    t, h, w = frames.shape
    out_h, out_w = short_edge_size(h, w, cfg.crop_size)
    idx_h, wgt_h = _banded_resize_taps(h, out_h)
    idx_w, wgt_w = _banded_resize_taps(w, out_w)

    def pil_resize_u8(x):
        return banded_resize_u8(x, out_h, out_w, idx_h, wgt_h, idx_w, wgt_w)

    frames_r = pil_resize_u8(frames)
    mask_r = mask[_nearest_indices(h, out_h)][:, _nearest_indices(w, out_w)]
    pk_r = pil_resize_u8(pk) if pk is not None else None
    if raw:
        imgs = (frames_r if pk_r is None
                else np.concatenate([frames_r, pk_r], axis=0))
        return imgs[..., None], mask_r.astype(np.uint8)

    imgs = (frames_r.astype(np.float32) / 255.0 - cfg.mean) / cfg.std
    if pk_r is not None:
        pk_n = (pk_r.astype(np.float32) / 255.0 - cfg.mean) / cfg.std
        imgs = np.concatenate([imgs, pk_n], axis=0)
    return imgs[..., None], mask_r.astype(np.int32)
