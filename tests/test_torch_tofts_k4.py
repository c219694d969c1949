"""The arithmetic of kernel K4 (`stf_unet_tpu_torch/csrc/tofts_sums.cu`),
emulated in plain PyTorch f32 and held against the JAX package's TPU
kernel (`tofts_sums`, Pallas interpret mode) and the port's plain sums.

The kernel runs only on the card (chip_smoke.py holds it to its plain
version there); what it computes can be checked on the CPU:
  * each row t is summed only over q < L_t, the active length: one past
    the last q where lags, weights or wlags is non-zero
    (`ops/kernels/tofts.active_lengths`), rounded up to a multiple of 4
    over tables zero-padded past Q;
  * each term is ex2(fl(-rate * log2(e)) * lag): the rate is scaled once,
    the argument rounded twice;
  * four partial sums per output, partial j over q = j mod 4, each an FMA
    chain in q order, added as (a0 + a1) + (a2 + a3);
  * a voxel whose rate is not finite sums its whole row instead: the
    vector loop up to the last multiple of 4 below Q, then the last
    terms one by one into partial 0 (a dropped term would be
    0 * exp(NaN) = NaN in the plain sums and the TPU kernel).
The emulation takes torch.exp2 (correctly rounded here) where the card
takes ex2.approx (2 ulp), and forms each FMA in float64 before rounding
to f32.

Tolerance: chip_smoke.py's TOFTS_RTOL / TOFTS_ATOL, max |difference| <=
1e-6 + 1e-5 * max |plain value| per output: the same f32 terms summed in
another order, and the argument's extra rounding (|x| * 2^-23 relative
on a term of size e^-|x|).
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from stf_unet_tpu.ops.pallas.tofts_kernel import tofts_sums as jax_tofts_sums
from stf_unet_tpu.pk import aif as jaif
from stf_unet_tpu.pk import tofts as jtofts
from stf_unet_tpu_torch.ops.kernels.build import CSRC
from stf_unet_tpu_torch.ops.kernels.tofts import (MAX_Q, active_lengths,
                                                  tofts_sums,
                                                  tofts_sums_plain)

RTOL, ATOL = 1e-5, 1e-6
LOG2E = math.log2(math.e)
T_POINTS = np.arange(8, dtype=np.float32)


def _rates(n, seed):
    """Rates K/ve over [0, 1000] as chip_smoke.py draws them: log-uniform
    over [1e-3, 1e3] and uniform halves, one 0."""
    rng = np.random.default_rng(seed)
    rate = np.concatenate([10.0 ** rng.uniform(-3, 3, n // 2),
                           rng.uniform(0, 1000, n - n // 2)])
    rate[0] = 0.0
    return rng.permutation(rate).astype(np.float32)


def _fit_tables():
    """The PK fit's tables (T=8, Q=700, population AIF), from the JAX
    package: row t has 100*t active points, row 0 none."""
    jq = jtofts.ToftsQuadrature.build(T_POINTS, jaif.make_aif("population"))
    lags, weights = (np.array(a) for a in (jq.lags, jq.weights))
    return lags, weights, weights * lags


def _dense_tables(t=5, q=37, seed=3):
    """Tables with no zero tail: every entry non-zero, Q not a multiple of
    4, T odd (the middle row has no partner)."""
    rng = np.random.default_rng(seed)
    lags = rng.uniform(0.01, 7.0, (t, q)).astype(np.float32)
    weights = rng.uniform(-0.02, 0.05, (t, q)).astype(np.float32)
    weights[weights == 0] = 0.01
    return lags, weights, weights * lags


def _fma(e, w, acc):
    """fmaf(e, w, acc): the product and sum in float64, rounded once."""
    f64 = torch.float64
    return (e.to(f64) * w.to(f64) + acc.to(f64)).float()


def _k4(rate, lags, weights, wlags):
    """K4's arithmetic on the CPU: (S [N, T], S_D [N, T]) in f32."""
    n, (t_steps, q) = rate.shape[0], lags.shape
    lens = active_lengths(lags, weights, wlags)
    qp = (q + 3) // 4 * 4
    pad = [torch.nn.functional.pad(v, (0, qp - q)) for v in
           (lags, weights, wlags)]
    finite = torch.isfinite(rate)
    rate2 = -rate * torch.tensor(LOG2E, dtype=torch.float32)     # f32
    s = torch.zeros((n, t_steps), dtype=torch.float32)
    s_lag = torch.zeros_like(s)
    for t in range(t_steps):
        vec_end = torch.where(finite, (int(lens[t]) + 3) // 4 * 4, q // 4 * 4)
        end = torch.where(finite, vec_end, q)
        a = torch.zeros((n, 4), dtype=torch.float32)
        b = torch.zeros_like(a)
        for k in range(0, int(vec_end.max()), 4):
            l, w, wl = (v[t, k:k + 4] for v in pad)
            e = torch.exp2(rate2[:, None] * l[None, :])          # f32
            on = (k < vec_end)[:, None]
            a = torch.where(on, _fma(e, w, a), a)
            b = torch.where(on, _fma(e, wl, b), b)
        for k in range(int(vec_end.min()), q):
            e = torch.exp2(rate2 * lags[t, k])
            on = (vec_end <= k) & (k < end)
            a[:, 0] = torch.where(on, _fma(e, weights[t, k], a[:, 0]),
                                  a[:, 0])
            b[:, 0] = torch.where(on, _fma(e, wlags[t, k], b[:, 0]),
                                  b[:, 0])
        s[:, t] = (a[:, 0] + a[:, 1]) + (a[:, 2] + a[:, 3])
        s_lag[:, t] = (b[:, 0] + b[:, 1]) + (b[:, 2] + b[:, 3])
    return s, s_lag


def _assert_close(got, want, finite=True):
    """Within ATOL + RTOL * max |want| per output; with finite=False the
    outputs may hold NaN and inf, which must sit where want has them."""
    for g, w in zip(got, want):
        w = torch.as_tensor(np.array(w))
        assert g.shape == w.shape and g.dtype == torch.float32
        if finite:
            assert bool(torch.isfinite(g).all())
        ok = torch.isfinite(w)
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        assert torch.equal(g[torch.isinf(w)], w[torch.isinf(w)])
        err = float((g[ok] - w[ok]).abs().max())
        assert err <= ATOL + RTOL * float(w[ok].abs().max()), err


TABLES = {"fit": _fit_tables, "dense": _dense_tables}


@pytest.mark.parametrize("tables", sorted(TABLES))
@pytest.mark.parametrize("n", [37, 300])
def test_k4_arithmetic_matches_the_tpu_kernel(tables, n):
    """N = 37 and 300 are ragged against the kernel's 256-voxel blocks
    and the TPU kernel's 512-voxel tiles."""
    arrays = TABLES[tables]()
    rate = _rates(n, seed=n)
    want = jax_tofts_sums(jnp.asarray(rate),
                          *(jnp.asarray(a) for a in arrays), interpret=True)
    got = _k4(torch.from_numpy(rate), *(torch.from_numpy(a) for a in arrays))
    _assert_close(got, want)


@pytest.mark.parametrize("tables", sorted(TABLES))
@pytest.mark.parametrize("n", [37, 300])
def test_k4_arithmetic_matches_the_plain_sums(tables, n):
    """chip_smoke.py holds the kernel to tofts_sums_plain on the card; on
    a CPU tensor the wrapper is that plain version."""
    args = (torch.from_numpy(_rates(n, seed=n + 1)),
            *(torch.from_numpy(a) for a in TABLES[tables]()))
    want = tofts_sums_plain(*args)
    _assert_close(_k4(*args), want)
    before = tofts_sums.launches
    for g, w in zip(tofts_sums(*args), want):
        assert torch.equal(g, w)
    assert tofts_sums.launches == before


def test_fit_tables_are_half_active_and_pair_evenly():
    """The fit's row t has 100*t active points; pairing rows t and T-1-t,
    as the kernel's blocks do, gives every block 700 terms."""
    lens = active_lengths(*(torch.from_numpy(a) for a in _fit_tables()))
    assert lens.tolist() == [100 * t for t in range(8)]
    assert float(lens.sum()) / (8 * 700) == 0.5
    assert {int(lens[t] + lens[7 - t]) for t in range(4)} == {700}


@pytest.mark.parametrize("tables", sorted(TABLES))
def test_active_length_drops_only_all_zero_terms(tables):
    lags, weights, wlags = (torch.from_numpy(a) for a in TABLES[tables]())
    lens = active_lengths(lags, weights, wlags)
    for t, length in enumerate(lens.tolist()):
        for v in (lags, weights, wlags):
            assert not bool(v[t, length:].any())
        if length:
            assert bool(lags[t, length - 1] != 0 or weights[t, length - 1]
                        != 0 or wlags[t, length - 1] != 0)
    if tables == "dense":
        assert lens.tolist() == [lags.shape[1]] * lags.shape[0]


def test_active_length_keeps_interior_zeros_and_lone_entries():
    """Zeros before the last non-zero entry stay in the sum; a lag alone
    (weight and wlag 0) still counts as non-zero, as does a NaN."""
    z = torch.zeros((4, 10))
    lags, weights, wlags = z.clone(), z.clone(), z.clone()
    weights[0, 7] = 1.0                 # interior zeros 0..6
    lags[1, 3] = 2.0                    # a lag alone
    wlags[2, 9] = float("nan")          # the last point
    assert active_lengths(lags, weights, wlags).tolist() == [8, 4, 10, 0]


def test_k4_sums_an_all_zero_row_to_zero():
    """Row 0 of the fit's tables is all zeros: the kernel sums nothing and
    writes 0, which is the plain value (sum of 0 * exp(0))."""
    args = (torch.from_numpy(_rates(16, seed=2)),
            *(torch.from_numpy(a) for a in _fit_tables()))
    for got, want in zip(_k4(*args), tofts_sums_plain(*args)):
        assert not bool(got[:, 0].any()) and not bool(want[:, 0].any())


def _rates_with_non_finite(n, seed):
    rate = _rates(n, seed)
    rate[1:4] = [np.inf, np.nan, -np.inf]
    return rate


@pytest.mark.parametrize("tables", sorted(TABLES))
def test_k4_non_finite_rates_match_the_tpu_kernel(tables):
    """A rate of inf, NaN or -inf: the kernel sums that voxel's whole row,
    so an all-zero row or a zero tail gives the TPU kernel's NaN
    (0 * exp(NaN)) and not 0."""
    arrays = TABLES[tables]()
    rate = _rates_with_non_finite(37, seed=5)
    want = jax_tofts_sums(jnp.asarray(rate),
                          *(jnp.asarray(a) for a in arrays), interpret=True)
    got = _k4(torch.from_numpy(rate), *(torch.from_numpy(a) for a in arrays))
    _assert_close(got, want, finite=False)
    if tables == "fit":   # row 0 is all zeros
        assert bool(torch.isnan(got[0][1:4, 0]).all())


@pytest.mark.parametrize("tables", sorted(TABLES))
def test_k4_non_finite_rates_match_the_plain_sums(tables):
    args = (torch.from_numpy(_rates_with_non_finite(37, seed=6)),
            *(torch.from_numpy(a) for a in TABLES[tables]()))
    _assert_close(_k4(*args), tofts_sums_plain(*args), finite=False)


def test_max_q_keeps_the_first_kernels_range():
    """Two staged rows of the three tables take 24 * Q bytes: the fit's
    Q = 700 stays in the 48 KB a block gets by default, and the kernel
    opts into more up to Q = 4096 (the range of the first K4, which
    staged one row), within the 227 KB a block may have on the card."""
    src = (CSRC / "tofts_sums.cu").read_text()
    assert f"constexpr int kMaxQ = {MAX_Q};" in src
    assert MAX_Q == 4096 and 2 * 3 * 4 * MAX_Q <= 227 * 1024
    assert 2 * 3 * 4 * 700 <= 48 * 1024
