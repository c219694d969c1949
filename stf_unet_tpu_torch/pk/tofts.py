"""Extended Tofts forward model on a precomputed quadrature grid
(counterpart of stf_unet_tpu/pk/tofts.py).

C(t) = vp*Cp(t) + Ktrans * ∫₀ᵗ Cp(τ) exp(-Ktrans (t-τ)/ve) dτ

on the reference's grid τ = arange(0, t_max, dt) (ref:pk_fitting.py:
193-231), precomputed once:
  * the masked quadrature weights  W[T, Q] = dt * Cp(τ_q) * [τ_q < t_i]
  * the lag matrix                 Δ[T, Q] = max(t_i − τ_q, 0)
so a batch of voxels needs S = Σ_q W exp(−(K/ve) Δ) and, for the
analytic Jacobian, S_Δ = Σ_q WΔ exp(−(K/ve) Δ): `dual_sums`, which on a
CUDA tensor is kernel K4 (ops/kernels/tofts.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np
import torch

from stf_unet_tpu_torch.ops.kernels.tofts import tofts_sums, tofts_sums_plain


@dataclass(frozen=True)
class ToftsQuadrature:
    """Grid tensors shared by every voxel batch, float32, on one device."""

    time_points: torch.Tensor   # [T]
    aif_at_t: torch.Tensor      # [T]  Cp(t_i)
    weights: torch.Tensor       # [T, Q]  dt * Cp(tau_q) * [tau_q < t_i]
    lags: torch.Tensor          # [T, Q]  max(t_i - tau_q, 0)
    wlags: torch.Tensor         # [T, Q]  weights * lags

    @staticmethod
    def build(time_points, aif: Callable, dt: float = 0.01,
              device="cpu") -> "ToftsQuadrature":
        """The grid is built on the CPU and moved to `device`, so every
        device fits against the same tables. tau comes from numpy's
        float32 arange, which equals jnp.arange's grid bit for bit
        (torch.arange's differs by up to 4.8e-7 and moves the mask)."""
        t = torch.as_tensor(np.asarray(time_points, np.float32))
        max_time = float(np.asarray(time_points)[-1])
        tau = torch.from_numpy(np.arange(0.0, max_time, dt,
                                         dtype=np.float32))
        aif_tau = aif(tau)                                     # [Q]
        mask = tau[None, :] < t[:, None]                       # [T, Q]
        weights = dt * aif_tau[None, :] * mask.to(torch.float32)
        lags = torch.clamp(t[:, None] - tau[None, :], min=0.0)
        quad = ToftsQuadrature(time_points=t, aif_at_t=aif(t),
                               weights=weights, lags=lags,
                               wlags=weights * lags)
        return quad.to(device)

    def to(self, device) -> "ToftsQuadrature":
        return ToftsQuadrature(*(v.to(device).contiguous() for v in (
            self.time_points, self.aif_at_t, self.weights, self.lags,
            self.wlags)))

    @property
    def device(self) -> torch.device:
        return self.lags.device


def extended_tofts_batch(quad: ToftsQuadrature, ktrans: torch.Tensor,
                         ve: torch.Tensor, vp: torch.Tensor) -> torch.Tensor:
    """[N] params -> [N, T] concentration curves (the plain form, which
    autograd differentiates for the Adam solver)."""
    rate = (ktrans / ve)[:, None, None]                        # [N,1,1]
    decay = torch.exp(-rate * quad.lags[None, :, :])           # [N,T,Q]
    conv = torch.einsum("ntq,tq->nt", decay, quad.weights)     # [N,T]
    return vp[:, None] * quad.aif_at_t[None, :] + ktrans[:, None] * conv


def dual_sums(quad: ToftsQuadrature, rate: torch.Tensor,
              backend: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """S = Σ_q w E and S_Δ = Σ_q w Δ E where E = exp(-rate Δ).

    "auto": kernel K4 (`tofts_sums`): on a CUDA tensor it launches the
    kernel or raises; on a CPU tensor it is the plain version. "plain":
    the plain version on any device, for comparing the two."""
    if backend == "auto":
        return tofts_sums(rate, quad.lags, quad.weights, quad.wlags)
    if backend == "plain":
        return tofts_sums_plain(rate, quad.lags, quad.weights, quad.wlags)
    raise ValueError(f"unknown dual_sums backend {backend!r}")


def extended_tofts_from_sums(quad: ToftsQuadrature, ktrans: torch.Tensor,
                             vp: torch.Tensor,
                             s: torch.Tensor) -> torch.Tensor:
    """C = vp Cp(t) + K S, the forward model given a precomputed S."""
    return vp[:, None] * quad.aif_at_t[None, :] + ktrans[:, None] * s


def extended_tofts_with_jacobian(quad: ToftsQuadrature, ktrans: torch.Tensor,
                                 ve: torch.Tensor, vp: torch.Tensor,
                                 backend: str = "auto"):
    """-> (C [N, T], J [N, T, 3]) with the analytic parameter Jacobian:
        C        = vp Cp(t) + K S
        ∂C/∂K    = S - (K/ve) S_Δ
        ∂C/∂ve   = (K²/ve²) S_Δ
        ∂C/∂vp   = Cp(t)
    """
    s, s_lag = dual_sums(quad, ktrans / ve, backend)
    c = extended_tofts_from_sums(quad, ktrans, vp, s)
    d_k = s - (ktrans / ve)[:, None] * s_lag
    d_ve = ((ktrans ** 2) / (ve ** 2))[:, None] * s_lag
    d_vp = quad.aif_at_t[None, :].expand_as(c)
    return c, torch.stack([d_k, d_ve, d_vp], dim=-1)
