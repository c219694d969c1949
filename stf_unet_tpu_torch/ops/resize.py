"""Resize weights and index maps with exact reference parity (copied from
stf_unet_tpu/ops/resize.py, which builds them in numpy).

  * align_corners=True bilinear (torch F.interpolate), used in the model's
    decoders and full-resolution head;
  * PIL/torchvision nearest with PIL's accumulated-scale quirk, for masks;
  * PIL's antialiased bilinear (triangle filter) as a dense weight matrix,
    the source of the eval path's banded uint8 resize.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from stf_unet_tpu_torch.ops.conv import row_handler


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int,
                                  out_w: int) -> torch.Tensor:
    """Bilinear resize of NCHW `x` with align_corners=True semantics (the
    JAX package applies `_align_corners_weights` as two matmuls; this is
    the same interpolation). Under a row-sharding plan (ops/conv.rows)
    x holds this rank's rows and (out_h, out_w) is the target level's
    local shape."""
    plan = row_handler()
    if plan is not None:
        return plan.resize(x, out_h, out_w)
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=True)


@lru_cache(maxsize=256)
def _align_corners_weights(in_size: int, out_size: int) -> np.ndarray:
    """W[out,in] for 1-D linear interpolation with align_corners=True."""
    w = np.zeros((out_size, in_size), dtype=np.float32)
    if out_size == 1:
        w[0, 0] = 1.0
        return w
    scale = (in_size - 1) / (out_size - 1)
    for o in range(out_size):
        src = o * scale
        lo = int(np.floor(src))
        hi = min(lo + 1, in_size - 1)
        frac = src - lo
        w[o, lo] += 1.0 - frac
        w[o, hi] += frac
    return w


@lru_cache(maxsize=256)
def _nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    # Exact PIL parity: PIL's nearest affine path ACCUMULATES the scale step
    # (`xo += a[0]` in libImaging/Geometry.c ImagingScaleAffine), so results
    # at integer boundaries follow float64 accumulation drift, not
    # (o + 0.5) * scale. Replicate with sequential accumulation.
    scale = in_size / out_size
    steps = np.concatenate([[0.5 * scale], np.full(out_size - 1, scale)])
    xo = np.add.accumulate(steps)
    return np.clip(xo.astype(np.int64), 0, in_size - 1)


@lru_cache(maxsize=256)
def pil_resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """W[out,in] replicating PIL's bilinear (triangle filter) resampling:
    support widened by the downscale factor (antialiasing), weights
    normalized per output pixel, clamped at the borders."""
    w = np.zeros((out_size, in_size), dtype=np.float64)
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale  # triangle filter support
    for o in range(out_size):
        center = (o + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        idx = np.arange(lo, hi)
        arg = (idx + 0.5 - center) / filterscale
        k = np.where(np.abs(arg) < 1.0, 1.0 - np.abs(arg), 0.0)
        s = k.sum()
        if s > 0:
            k /= s
        w[o, lo:hi] = k
    return w.astype(np.float32)


def short_edge_size(h: int, w: int, size: int) -> Tuple[int, int]:
    """torchvision F.resize(int) semantics: scale the short edge to `size`
    preserving aspect ratio, TRUNCATING the long edge."""
    if h <= w:
        return size, max(1, int(size * w / h))
    return max(1, int(size * h / w)), size
