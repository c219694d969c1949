"""K4: the extended-Tofts quadrature sums of the PK fit.

Replaces the TPU kernel `stf_unet_tpu/ops/pallas/tofts_kernel.py:
tofts_sums` (body `_tofts_kernel`) with the hand-written CUDA kernel
`csrc/tofts_sums.cu`.

rate [N] f32 (= K/ve), lags / weights / wlags [T, Q] f32 (wlags =
weights * lags) -> (S [N, T], S_Δ [N, T]) f32 with
    S[n, t]   = Σ_q weights[t, q] * exp(-rate[n] * lags[t, q])
    S_Δ[n, t] = Σ_q wlags[t, q]   * exp(-rate[n] * lags[t, q])
without materialising the [N, T, Q] decay tensor (367 MB at N = 16384,
T = 8, Q = 700).

The kernel sums each row t only over its active terms, q below
`active_lengths(...)[t]` (one past the last q where lags, weights or
wlags is non-zero); the terms after it are 0 * exp(0) = 0 for a finite
rate. The PK fit's masked tables are half zeros (row t has 100*t active
points of 700), so half the full grid's terms. A voxel whose rate is not
finite (inf, NaN) is summed over the whole row, as the TPU kernel and the
plain sums do, so it gets their NaN where a dropped term is 0 * exp(NaN).

Bound on the H100: operations, counted over the active terms. At
N = 16384 with the fit's tables (45.9 M active elements, ~6 f32
operations each) the least time is 4.1 us at 67 TFLOP/s, against 0.35 us
for its ~1.2 MB of traffic; the exponentials alone need the SFU, 16 a
clock per SM, 11 us at 1.98 GHz (8.2 and 22 us on the full grid). The
kernel takes one MUFU op per term (ex2 of a rate pre-scaled by log2(e)),
vector loads of the staged tables, and balances a block's work by
pairing rows t and T-1-t. Its measured times are in PERF.md.

On a CPU tensor the wrapper runs `tofts_sums_plain`; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from stf_unet_tpu_torch.ops.kernels import build

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
# The kernel stages its block's two rows of the three tables in shared
# memory, 24 * Q bytes, opting in above the 48 KB default (Q > 2048); the
# .cu's kMaxQ.
MAX_Q = 4096


def _check(rate: torch.Tensor, lags: torch.Tensor, weights: torch.Tensor,
           wlags: torch.Tensor) -> None:
    if rate.dim() != 1:
        raise ValueError(f"tofts_sums: rate must be [N]; got "
                         f"{tuple(rate.shape)}")
    if lags.dim() != 2:
        raise ValueError(f"tofts_sums: lags must be [T, Q]; got "
                         f"{tuple(lags.shape)}")
    for name, v in (("weights", weights), ("wlags", wlags)):
        if v.shape != lags.shape:
            raise ValueError(f"tofts_sums: {name} is {tuple(v.shape)}, lags "
                             f"{tuple(lags.shape)}")


def active_lengths(lags: torch.Tensor, weights: torch.Tensor,
                   wlags: torch.Tensor) -> torch.Tensor:
    """[T] int64: per row, one past the last q where lags, weights or
    wlags is non-zero (0 for an all-zero row), the kernel's rule for the
    terms it sums. Every term past it is 0 * exp(-rate * 0)."""
    nonzero = (lags != 0) | (weights != 0) | (wlags != 0)     # [T, Q]
    q = torch.arange(lags.shape[1] + 1, device=lags.device)   # 0 = none
    return (torch.nn.functional.pad(nonzero, (1, 0)) * q).amax(dim=1)


def tofts_sums_plain(rate: torch.Tensor, lags: torch.Tensor,
                     weights: torch.Tensor, wlags: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, as the JAX package's XLA
    branch of `_dual_sums` writes it: the [N, T, Q] decay, then two
    contractions over q."""
    _check(rate, lags, weights, wlags)
    decay = torch.exp(-rate[:, None, None] * lags[None, :, :])  # [N,T,Q]
    s = torch.einsum("ntq,tq->nt", decay, weights)
    s_lag = torch.einsum("ntq,tq->nt", decay, wlags)
    return s, s_lag


def tofts_sums(rate: torch.Tensor, lags: torch.Tensor, weights: torch.Tensor,
               wlags: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S [N, T], S_Δ [N, T]), see module docstring."""
    if rate.device.type == "cpu":
        return tofts_sums_plain(rate, lags, weights, wlags)
    if rate.device.type != "cuda":
        raise ValueError(f"tofts_sums runs on CUDA or CPU, not "
                         f"{rate.device}")
    _check(rate, lags, weights, wlags)
    for name, v in (("rate", rate), ("lags", lags), ("weights", weights),
                    ("wlags", wlags)):
        if v.device != rate.device:
            raise ValueError(f"tofts_sums: {name} is on {v.device}, rate on "
                             f"{rate.device}")
        if v.dtype != torch.float32:
            raise TypeError(f"the tofts_sums kernel takes float32; {name} "
                            f"is {v.dtype}")
    n = rate.shape[0]
    t_steps, q = lags.shape
    if q > MAX_Q:
        raise ValueError(f"tofts_sums: Q={q} grid points exceed the "
                         f"kernel's shared-memory staging ({MAX_Q})")
    s = torch.empty((n, t_steps), dtype=torch.float32, device=rate.device)
    s_lag = torch.empty_like(s)
    if n == 0 or t_steps == 0:
        return s, s_lag
    lib = build.load("tofts_sums", _ARGTYPES)
    rate, lags, weights, wlags = (v.contiguous()
                                  for v in (rate, lags, weights, wlags))
    with torch.cuda.device(rate.device):
        status = lib.stf_tofts_sums(
            rate.data_ptr(), lags.data_ptr(), weights.data_ptr(),
            wlags.data_ptr(), s.data_ptr(), s_lag.data_ptr(), n, t_steps, q,
            torch.cuda.current_stream(rate.device).cuda_stream)
    build.check_status("tofts_sums", status)
    tofts_sums.launches += 1
    return s, s_lag


tofts_sums.launches = 0
