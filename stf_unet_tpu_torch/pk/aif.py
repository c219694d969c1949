"""Arterial input function models (counterpart of stf_unet_tpu/pk/aif.py;
ref:pk_fitting.py:28-129).

  * population - Parker biexponential with dose scaling (ref:28-46),
  * modified   - the same biexponential without the dose (ref:48-56),
  * auto       - the voxel with the steepest single-step rise inside the
    tissue mask supplies the curve, resampled by linear interpolation with
    linear extrapolation past both ends (scipy interp1d's 'extrapolate',
    as the JAX package completes the reference's unfinished auto path).

Each AIF is a callable t -> Cp(t) on float32 torch tensors, computed in
float32 as the JAX package computes it.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

# Parker model parameters (ref:pk_fitting.py:40-42).
_A1, _A2 = 3.99, 4.78
_M1, _M2 = 0.144, 0.0111


def population_aif(t: torch.Tensor, dose: float = 0.1) -> torch.Tensor:
    """dose * (a1*exp(-m1 t) + a2*exp(-m2 t)) (ref:28-46)."""
    return dose * (_A1 * torch.exp(-_M1 * t) + _A2 * torch.exp(-_M2 * t))


def modified_aif(t: torch.Tensor) -> torch.Tensor:
    """Biexponential without the dose factor (ref:48-56)."""
    return _A1 * torch.exp(-_M1 * t) + _A2 * torch.exp(-_M2 * t)


def _interp(x: torch.Tensor, xp: torch.Tensor,
            fp: torch.Tensor) -> torch.Tensor:
    """Linear interpolation inside [xp[0], xp[-1]] with the end segments
    extended: jnp.interp's formula (search right, clip to [1, n-1],
    fp[i-1] + (delta / dx) * df), with every x off either end taken on
    the end segment's line, as `_interp_aif` below asks."""
    i = torch.searchsorted(xp, x, right=True).clamp(1, xp.numel() - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    tiny = float(np.spacing(np.finfo(np.float32).eps))
    flat = dx.abs() <= tiny
    return torch.where(flat, fp[i - 1],
                       fp[i - 1] + (delta / torch.where(flat, 1.0, dx)) * df)


def _interp_aif(sample_times: np.ndarray, curve: np.ndarray) -> Callable:
    """Linear-interp resampler with extrapolation (ref:75-84 uses scipy
    interp1d(fill_value='extrapolate')); the end slopes are float32 as in
    the JAX package."""
    st = np.asarray(sample_times, dtype=np.float32)
    cv = np.asarray(curve, dtype=np.float32)
    lo_slope = float((cv[1] - cv[0]) / (st[1] - st[0]))
    hi_slope = float((cv[-1] - cv[-2]) / (st[-1] - st[-2]))

    def aif(t: torch.Tensor) -> torch.Tensor:
        t = torch.as_tensor(t, dtype=torch.float32)
        xp = torch.from_numpy(st).to(t.device)
        fp = torch.from_numpy(cv).to(t.device)
        inner = _interp(t, xp, fp)
        lo = float(cv[0]) + (t - float(st[0])) * lo_slope
        hi = float(cv[-1]) + (t - float(st[-1])) * hi_slope
        return torch.where(t < float(st[0]), lo,
                           torch.where(t > float(st[-1]), hi, inner))

    return aif


def auto_detect_aif(images: np.ndarray, tissue_mask: np.ndarray,
                    sample_times: np.ndarray
                    ) -> Tuple[Callable, Tuple[int, int]]:
    """Pick the masked voxel with the largest single-step temporal increase
    and use its curve as the AIF (ref:96-129). images [T, H, W] numpy."""
    diff = np.diff(images, axis=0)
    peak = diff.max(axis=0) * np.asarray(tissue_mask, dtype=images.dtype)
    pos = np.unravel_index(int(np.argmax(peak)), peak.shape)
    curve = images[:, pos[0], pos[1]]
    return _interp_aif(sample_times, curve), (int(pos[0]), int(pos[1]))


def make_aif(method: str, dose: float = 0.1,
             auto_curve: Optional[Callable] = None) -> Callable:
    """Resolve aif_method to a t -> Cp(t) callable (ref:58-94). 'auto'
    falls back to `modified` when no detected curve is supplied
    (ref:85-87)."""
    if method == "population":
        return lambda t: population_aif(t, dose)
    if method == "modified":
        return modified_aif
    if method == "auto":
        return auto_curve if auto_curve is not None else modified_aif
    raise ValueError(f"Unsupported AIF method: {method}")
