"""Preprocessing (counterpart of stf_unet_tpu/data/transforms.py).

Evaluation and serving: exact PIL short-edge resize of uint8 frames on the
host, and the (x/255 - mean)/std normalization, which runs on the device.

Training: ONE affine warp per sample instead of the reference's chain of
PIL resamplings (RandomResize -> HFlip -> VFlip -> RandomRotation ->
RandomCrop, ref:train.py:56-67). The five steps compose into one output
pixel -> source pixel map, evaluated once (bilinear frames, nearest mask)
at a fixed crop x crop output by kernel K2 (ops/kernels/warp), with the
normalization folded into its epilogue. As in the JAX package, one draw is
shared by a sample's T frames; the per-frame mode re-rolls every plane
(K2 then warps [B*P, 2, H, W] stacks, one grid per plane). The draws come
from a torch.Generator on the host (core/prng.augment_generator); the
grids are built on the device.

The extras beyond the reference, off by default: an elastic field added
to the warp coordinates (frames and mask alike), and photometric jitter
of the [0, 1] frames (K2's epilogue then only divides by 255; the jitter
and the normalization follow as tensor ops). Their draws follow the
geometry's in the step's generator, so with every extra off the draws
are the ones the plain augmentation makes; the noise is drawn on the
device from a generator seeded by the step's.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

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
                     idx_w: np.ndarray, wgt_w: np.ndarray,
                     force_numpy: bool = False) -> np.ndarray:
    """Apply banded PIL-parity resize taps to uint8 planes [N, H, W] ->
    [N, out_h, out_w]: f64 vertical then horizontal passes in ascending-k
    order, round-half-even, clip. The native C++ resize
    (data/native_loader) runs it when the library is there; this numpy
    path, bit-identical to it (the JAX package's pair), otherwise."""
    if not force_numpy:
        from stf_unet_tpu_torch.data import native_loader
        if native_loader.native_available():
            return native_loader.banded_resize(x, out_h, out_w, idx_h,
                                               wgt_h, idx_w, wgt_w)
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
                   src_w: torch.Tensor,
                   rows: Optional[Tuple[int, int]] = None):
    """Draw the augmentation parameters of a batch of samples: src_h /
    src_w are [B] CPU tensors; every result is a [B] float32 (flips: bool)
    CPU tensor. The distributions are the JAX package's (transforms.py:
    115-153): the short edge resizes to an integer r uniform in [min, max];
    flips and the rotate decision are Bernoulli; the angle is uniform in
    [-deg, deg]; the crop offset is floor(u * (max_offset + 1)).
    rows = (first, total): these B samples are rows [first, first + B) of
    a global batch of `total`, whose draws are made and cut to them."""
    bsz = src_h.shape[0]
    first, total = rows or (0, bsz)
    mine = slice(first, first + bsz)
    f32 = torch.float32
    r = torch.randint(min_size, max_size + 1, (total,), generator=gen)[mine]
    u_hflip, u_vflip, u_rot, u_angle = torch.rand(
        (4, total), generator=gen)[:, mine]
    u_crop = torch.rand((2, total), generator=gen)[:, mine]
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


def elastic_offsets(field: torch.Tensor, on: torch.Tensor, crop: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The elastic displacement (dy, dx) [B, crop, crop] from control
    fields [B, 2, grid, grid] (normal draws times alpha, source pixels)
    and on [B] (0 or 1): each field upsampled bilinearly with half-pixel
    centres and edge clamping, as jax.image.resize(method="linear") does
    when it upsamples (the JAX package's _elastic_offsets)."""
    up = torch.nn.functional.interpolate(
        field, size=(crop, crop), mode="bilinear", align_corners=False)
    up = up * on.view(-1, 1, 1, 1)
    return up[:, 0], up[:, 1]


def photometric(v: torch.Tensor, factors: torch.Tensor, cfg: DataConfig,
                noise_gen: Optional[torch.Generator] = None,
                rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Photometric jitter of [0, 1] frames v [B, T, H, W] (the JAX
    package's _photometric): factors [3, B] of brightness, contrast and
    gamma (each used only where its knob is on), one per sample shared by
    its frames; then additive N(0, noise_std) noise from `noise_gen` on
    v's device (rows: drawn for the global batch and cut, as in
    _sample_params), and a clip to [0, 1]."""
    def per_sample(f):
        return f.to(v.device, v.dtype).view(-1, 1, 1, 1)

    if cfg.brightness > 0.0:
        v = v * per_sample(factors[0])
    if cfg.contrast > 0.0:
        m = v.mean(dim=(1, 2, 3), keepdim=True)
        v = (v - m) * per_sample(factors[1]) + m
    if cfg.gamma_jitter > 0.0:
        v = torch.clamp(v, 1e-6, 1.0) ** per_sample(factors[2])
    if cfg.noise_std > 0.0:
        first, total = rows or (0, v.shape[0])
        noise = torch.randn((total,) + tuple(v.shape[1:]),
                            generator=noise_gen, device=v.device,
                            dtype=v.dtype)[first:first + v.shape[0]]
        v = v + noise * cfg.noise_std
    return torch.clamp(v, 0.0, 1.0)


class TrainAugment:
    """Batched fused augmentation of a raw uint8 host batch.

    Under data parallelism rank `shard_index` of `num_shards` holds rows
    [rank * b, (rank + 1) * b) of the global batch; every draw (geometry,
    elastic field, photometric factors, noise) is made for the global
    batch and cut to those rows, as the JAX step draws over the
    assembled global batch, so the ranks' slices are a one-process
    run's rows."""

    def __init__(self, cfg: DataConfig, shard_index: int = 0,
                 num_shards: int = 1):
        self.cfg = cfg
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.min_size = int(0.5 * cfg.base_size)   # ref:train.py:59
        self.max_size = int(1.2 * cfg.base_size)
        self.crop = cfg.crop_size
        self.photometric = (cfg.brightness > 0.0 or cfg.contrast > 0.0
                            or cfg.gamma_jitter > 0.0 or cfg.noise_std > 0.0)
        self.elastic = cfg.elastic_alpha > 0.0
        if self.elastic and not cfg.shared_frame_augmentation:
            print("note: elastic deformation requires shared-frame "
                  "augmentation; ignoring --data-elastic-alpha in the "
                  "per-frame re-roll quirk mode")
            self.elastic = False
        if self.photometric:
            # K2 leaves [0, 1] frames; the jitter, then (x - mean)/std
            self.alpha, self.beta = 1.0 / 255.0, 0.0
        else:
            # /255, then (x - mean)/std, folded into the warp's epilogue
            self.alpha = 1.0 / (255.0 * cfg.std)
            self.beta = -cfg.mean / cfg.std

    def _rows(self, n: int) -> Tuple[int, int]:
        """(first, total): a rank's n rows within the global draw."""
        return self.shard_index * n, self.num_shards * n

    def _params(self, gen: torch.Generator, sizes: torch.Tensor):
        return _sample_params(
            gen, self.min_size, self.max_size, self.cfg.hflip_prob,
            self.cfg.vflip_prob, self.cfg.rotate_prob,
            self.cfg.rotate_degrees, self.crop, sizes[:, 0], sizes[:, 1],
            rows=self._rows(sizes.shape[0]))

    def _affine(self, params, device) -> Tuple[torch.Tensor, torch.Tensor]:
        params = [p.to(device).view(-1, 1, 1) for p in params]
        line = torch.arange(self.crop, dtype=torch.float32, device=device)
        return _build_affine(*params)(line.view(-1, 1), line.view(1, -1))

    def grids(self, gen: torch.Generator, sizes: torch.Tensor, device,
              planes: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        """Draw a batch's geometry on the host and build its source
        coordinates on `device`: (gy, gx) [B, crop, crop] float32, or,
        with planes = P > 1 (the per-frame mode), [B * P, crop, crop],
        one draw per plane, sample-major; the elastic field (when on)
        added to the shared-frame grids, drawn after the geometry."""
        sizes = torch.as_tensor(sizes).cpu()
        if planes > 1:
            sizes = sizes.repeat_interleave(planes, dim=0)
        gy, gx = self._affine(self._params(gen, sizes), device)
        if self.elastic:
            grid = self.cfg.elastic_grid
            first, total = self._rows(sizes.shape[0])
            mine = slice(first, first + sizes.shape[0])
            field = torch.randn((total, 2, grid, grid),
                                generator=gen)[mine] * self.cfg.elastic_alpha
            on = (torch.rand((total,), generator=gen)[mine]
                  < self.cfg.elastic_prob).to(torch.float32)
            dy, dx = elastic_offsets(field.to(device), on.to(device),
                                     self.crop)
            gy, gx = gy + dy, gx + dx
        return gy, gx

    def _photometric_draws(self, gen: torch.Generator, bsz: int, device):
        """The jitter's factors [3, B] (each U(1-k, 1+k) for brightness,
        contrast, gamma) and, with noise, a generator on `device` seeded
        from `gen`."""
        first, total = self._rows(bsz)
        u = torch.rand((3, total), generator=gen)[:, first:first + bsz]
        k = torch.tensor([self.cfg.brightness, self.cfg.contrast,
                          self.cfg.gamma_jitter]).view(3, 1)
        factors = 1.0 - k + 2.0 * k * u
        noise_gen = None
        if self.cfg.noise_std > 0.0:
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
            noise_gen = torch.Generator(device=device).manual_seed(seed)
        return factors, noise_gen

    def __call__(self, gen: torch.Generator, frames: torch.Tensor,
                 masks: torch.Tensor, sizes, pk: torch.Tensor = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """frames [B, T, H, W] uint8, masks [B, H, W] uint8, sizes [B, 2]
        (valid h, w), pk [B, 3, H, W] uint8 or None -> (images [B, T(+3),
        crop, crop, 1] float32 normalized, targets [B, crop, crop] int64).
        The PK maps ride as extra planes after the frames
        (ref:my_dataset.py:226-227) and are normalized like the frames.
        Shared-frame mode: one warp call takes frames, maps and mask under
        one draw per sample. Per-frame mode: one call warps every plane
        under its own draw, beside the sample's mask, whose target is the
        one of frame 0."""
        bsz, t = frames.shape[:2]
        planes = [frames] if pk is None else [frames, pk]
        valid = torch.as_tensor(sizes).to(frames.device, torch.float32)
        if self.cfg.shared_frame_augmentation:
            gy, gx = self.grids(gen, sizes, frames.device)
            stacked = torch.cat(planes + [masks.unsqueeze(1)], dim=1)
            bil, near = warp(stacked, gy, gx, valid, alpha=self.alpha,
                             beta=self.beta)
        else:
            raw = torch.cat(planes, dim=1)
            p = raw.shape[1]
            gy, gx = self.grids(gen, sizes, frames.device, planes=p)
            stacked = torch.stack(
                [raw, masks.unsqueeze(1).expand(-1, p, -1, -1)], dim=2)
            bil, near = warp(stacked.reshape(bsz * p, 2, *raw.shape[2:]),
                             gy, gx, valid.repeat_interleave(p, dim=0),
                             alpha=self.alpha, beta=self.beta)
            bil = bil.view(bsz, p, *bil.shape[2:])
            near = near.view(bsz, p, *near.shape[1:])[:, 0]
        if self.photometric:
            factors, noise_gen = self._photometric_draws(gen, bsz,
                                                         frames.device)
            v = photometric(bil[:, :t], factors, self.cfg, noise_gen,
                            rows=self._rows(bsz))
            bil = (torch.cat([v, bil[:, t:]], dim=1) - self.cfg.mean) \
                / self.cfg.std
        return bil.unsqueeze(-1), near.to(torch.int64)
