"""Preprocessing (counterpart of stf_unet_tpu/data/transforms.py).

Evaluation and serving: exact PIL short-edge resize of uint8 frames on the
host, and the (x/255 - mean)/std normalization, which runs on the device.

Training: ONE affine warp per sample instead of the reference's chain of
PIL resamplings (RandomResize -> HFlip -> VFlip -> RandomRotation ->
RandomCrop, ref:train.py:56-67). The five steps compose into one output
pixel -> source pixel map, evaluated once (bilinear frames, nearest mask)
at a fixed crop x crop output by kernel K2 (ops/kernels/warp), with the
normalization folded into its epilogue. As in the JAX package, one draw is
shared by a sample's T frames. The draws come from a torch.Generator on
the host (core/prng.augment_generator); the grids are built on the device.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from stf_unet_tpu_torch.core.config import DataConfig
from stf_unet_tpu_torch.ops.kernels.warp import warp
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


# ---------------------------------------------------------------------------
# Training augmentation: one fused affine warp per sample
# ---------------------------------------------------------------------------

def _sample_params(gen: torch.Generator, min_size: int, max_size: int,
                   hflip_prob: float, vflip_prob: float, rotate_prob: float,
                   rotate_deg: float, crop: int, src_h: torch.Tensor,
                   src_w: torch.Tensor):
    """Draw the augmentation parameters of a batch of samples: src_h /
    src_w are [B] CPU tensors; every result is a [B] float32 (flips: bool)
    CPU tensor. The distributions are the JAX package's (transforms.py:
    115-153): the short edge resizes to an integer r uniform in [min, max];
    flips and the rotate decision are Bernoulli; the angle is uniform in
    [-deg, deg]; the crop offset is floor(u * (max_offset + 1))."""
    bsz = src_h.shape[0]
    f32 = torch.float32
    r = torch.randint(min_size, max_size + 1, (bsz,), generator=gen)
    u_hflip, u_vflip, u_rot, u_angle = torch.rand((4, bsz), generator=gen)
    u_crop = torch.rand((2, bsz), generator=gen)
    src_h, src_w = src_h.to(f32), src_w.to(f32)
    scale = r.to(f32) / torch.minimum(src_h, src_w)
    res_h = torch.round(src_h * scale)
    res_w = torch.round(src_w * scale)
    hflip = u_hflip < hflip_prob
    vflip = u_vflip < vflip_prob
    angle = torch.where(u_rot < rotate_prob,
                        -rotate_deg + 2.0 * rotate_deg * u_angle,
                        torch.zeros_like(u_angle)) * (math.pi / 180.0)
    max_y0 = torch.clamp(res_h - crop, min=0.0)
    max_x0 = torch.clamp(res_w - crop, min=0.0)
    y0 = torch.minimum(torch.floor(u_crop[0] * (max_y0 + 1.0)), max_y0)
    x0 = torch.minimum(torch.floor(u_crop[1] * (max_x0 + 1.0)), max_x0)
    return scale, res_h, res_w, hflip, vflip, angle, y0, x0


def _build_affine(scale, res_h, res_w, hflip, vflip, angle, y0, x0):
    """A function mapping output pixel-centre coordinates (py, px) to
    source coordinates (gy, gx): the inverse of resize(scale) -> hflip ->
    vflip -> rotate(angle, about the resized image's centre) -> crop at
    (y0, x0), as the JAX package builds it (transforms.py:156-201).
    Parameters are float32 tensors (flips bool) that broadcast against
    the coordinates; everything is computed in float32."""
    f32 = torch.float32
    scale, res_h, res_w, angle, y0, x0 = (
        torch.as_tensor(v, dtype=f32)
        for v in (scale, res_h, res_w, angle, y0, x0))
    hflip = torch.as_tensor(hflip, dtype=torch.bool)
    vflip = torch.as_tensor(vflip, dtype=torch.bool)
    cy = (res_h - 1.0) / 2.0
    cx = (res_w - 1.0) / 2.0
    cos_a = torch.cos(angle)
    sin_a = torch.sin(angle)
    m00, m01, m10, m11 = cos_a, sin_a, -sin_a, cos_a
    one = torch.ones_like(res_h)
    sy = torch.where(vflip, -one, one)
    oy = torch.where(vflip, res_h - 1.0, torch.zeros_like(res_h))
    sx = torch.where(hflip, -one, one)
    ox = torch.where(hflip, res_w - 1.0, torch.zeros_like(res_w))
    inv = 1.0 / scale

    def compose(py, px):
        ry = py + y0
        rx = px + x0
        fy = m00 * (ry - cy) + m01 * (rx - cx) + cy
        fx = m10 * (ry - cy) + m11 * (rx - cx) + cx
        uy = sy * fy + oy
        ux = sx * fx + ox
        gy = (uy + 0.5) * inv - 0.5
        gx = (ux + 0.5) * inv - 0.5
        return gy, gx

    return compose


class TrainAugment:
    """Batched fused augmentation of a raw uint8 host batch."""

    def __init__(self, cfg: DataConfig):
        if not cfg.shared_frame_augmentation:
            raise NotImplementedError(
                "the per-frame re-roll mode (shared_frame_augmentation="
                "False) is not ported yet (ROADMAP.md §1, 'augmentation "
                "extras')")
        self.cfg = cfg
        self.min_size = int(0.5 * cfg.base_size)   # ref:train.py:59
        self.max_size = int(1.2 * cfg.base_size)
        self.crop = cfg.crop_size
        # /255, then (x - mean)/std, folded into the warp's epilogue
        self.alpha = 1.0 / (255.0 * cfg.std)
        self.beta = -cfg.mean / cfg.std

    def grids(self, gen: torch.Generator, sizes: torch.Tensor,
              device) -> Tuple[torch.Tensor, torch.Tensor]:
        """Draw a batch's parameters on the host and build its source
        coordinates on `device`: (gy, gx) [B, crop, crop] float32."""
        sizes = torch.as_tensor(sizes).cpu()
        params = _sample_params(
            gen, self.min_size, self.max_size, self.cfg.hflip_prob,
            self.cfg.vflip_prob, self.cfg.rotate_prob,
            self.cfg.rotate_degrees, self.crop, sizes[:, 0], sizes[:, 1])
        params = [p.to(device).view(-1, 1, 1) for p in params]
        line = torch.arange(self.crop, dtype=torch.float32, device=device)
        return _build_affine(*params)(line.view(-1, 1), line.view(1, -1))

    def __call__(self, gen: torch.Generator, frames: torch.Tensor,
                 masks: torch.Tensor, sizes
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """frames [B, T, H, W] uint8, masks [B, H, W] uint8, sizes [B, 2]
        (valid h, w) -> (images [B, T, crop, crop, 1] float32 normalized,
        targets [B, crop, crop] int64)."""
        gy, gx = self.grids(gen, sizes, frames.device)
        stacked = torch.cat([frames, masks.unsqueeze(1)], dim=1)
        valid = torch.as_tensor(sizes).to(frames.device, torch.float32)
        bil, near = warp(stacked, gy, gx, valid, alpha=self.alpha,
                         beta=self.beta)
        return bil.unsqueeze(-1), near.to(torch.int64)
