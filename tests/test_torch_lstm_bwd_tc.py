"""The arithmetic of K1b's bf16 tensor-core instantiation
(`stf_unet_tpu_torch/csrc/lstm_last_x_bwd.cu`), emulated in plain PyTorch
here and held against the JAX package's two TPU backward kernels
(`_bwd_call_ti`, `_bwd_call`) in Pallas interpret mode, bf16.

The kernel itself runs only on the card (chip_smoke.py holds it to its
plain twin there); what it computes can be checked on the CPU:
  * gates: x_t and round(h_{t-1}) are exactly bf16, W is bf16, so a bf16
    product with f32 accumulation is the TPU's rounding point, unsplit;
  * dh_{t-1} = dgates W_hh^T and dx_t = dgates W_ih^T from the f32 dgates
    split into bf16 hi + lo (2 products each);
  * dW_ih = x^T (dg_hi + dg_lo), dW_hh = h_hi^T dg_hi + h_hi^T dg_lo +
    h_lo^T dg_hi from the unrounded f32 h (3 products), db = sum_rows dg
    in f32.
Every product of two bf16 values is exact in f32, so the emulation forms
them in f32 and sums in f32, as the tensor cores do (in another order).

Tolerances are chip_smoke.py's BWD_TOL["bf16"], the kernel's on the card:
dx 2^-6 of max |dx| (one flipped bf16 rounding of h moves dx by one bf16
step), dW_ih, dW_hh, db 2^-12 of their max (taking dW_hh from the rounded
h - the other rounding point - moves it by ~1e-3 of its max). The split
reproduces an f32 value to 2^-16 relative: hi and lo carry 8 significant
bits each, and v - hi is exact in f32. That holds while lo is a normal
number (|v| >= 2^-110); the kernel's operands (h, dgates) sit far above.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
import torch

from stf_unet_tpu.ops.pallas.lstm_train_kernel import _bwd_call, _bwd_call_ti
from stf_unet_tpu_torch.ops.kernels.lstm_last_x_bwd import (
    lstm_last_x_bwd_plain, tensor_core_tile)

BWD_TOL = {"dx": 2.0 ** -6, "dw_ih": 2.0 ** -12, "dw_hh": 2.0 ** -12,
           "db": 2.0 ** -12}
NAMES = ("dx", "dw_ih", "dw_hh", "db")
F32 = torch.float32
BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small CPU steps: the test
    workers share the host's cores, and torch's default of a thread per
    core makes each tiny op of one worker wait on the others'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(t, n, c, seed):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(c)
    x = rng.normal(size=(t, n, c)).astype(np.float32)
    w_ih = rng.uniform(-k, k, (c, 4 * c)).astype(np.float32)
    w_hh = rng.uniform(-k, k, (c, 4 * c)).astype(np.float32)
    b = rng.uniform(-k, k, (4 * c,)).astype(np.float32)
    dh = rng.normal(size=(n, c)).astype(np.float32)
    # bf16-exact, so JAX and the port start from the same values
    return [torch.from_numpy(a).to(BF16).float().numpy()
            for a in (x, w_ih, w_hh, b, dh)]


def _split(v: torch.Tensor):
    """f32 -> (hi, lo), both bf16 values held in f32: hi = bf16(v),
    lo = bf16(v - hi)."""
    hi = v.to(BF16).float()
    return hi, (v - hi).to(BF16).float()


def _tc_bwd(x, w_ih, w_hh, b, dh, split_dw=True):
    """K1b's bf16 tensor-core arithmetic on bf16 inputs. With split_dw
    False the lo terms of dW_ih and dW_hh are dropped."""
    t_steps, n, c = x.shape
    xf, wi, wh, bias = (v.float() for v in (x, w_ih, w_hh, b))
    zeros = torch.zeros((n, c), dtype=F32)

    def gates_at(t, h_prev):
        return xf[t] @ wi + h_prev.to(BF16).float() @ wh + bias

    def act(gates):
        i, f, g, o = gates.chunk(4, dim=1)
        return (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                torch.sigmoid(o))

    hs, cs = [], []
    h = cst = zeros
    for t in range(t_steps):
        i, f, g, o = act(gates_at(t, h))
        cst = f * cst + i * g
        h = o * torch.tanh(cst)
        hs.append(h)
        cs.append(cst)

    dh_t, dc_carry = dh.float(), zeros
    dx = torch.empty_like(x)
    dwi = torch.zeros((c, 4 * c), dtype=F32)
    dwh = torch.zeros_like(dwi)
    db = torch.zeros((4 * c,), dtype=F32)
    for t in range(t_steps - 1, -1, -1):
        h_prev = hs[t - 1] if t > 0 else zeros
        c_prev = cs[t - 1] if t > 0 else zeros
        i, f, g, o = act(gates_at(t, h_prev))
        tanh_c = torch.tanh(cs[t])
        do = dh_t * tanh_c
        dc = dc_carry + dh_t * o * (1.0 - tanh_c ** 2)
        dg = torch.cat([dc * g * i * (1.0 - i), dc * c_prev * f * (1.0 - f),
                        dc * i * (1.0 - g ** 2), do * o * (1.0 - o)], dim=1)
        dg_hi, dg_lo = _split(dg)
        dh_t = dg_hi @ wh.t() + dg_lo @ wh.t()
        dc_carry = dc * f
        dx[t] = (dg_hi @ wi.t() + dg_lo @ wi.t()).to(x.dtype)
        h_hi, h_lo = _split(h_prev)
        dwi += xf[t].t() @ dg_hi
        dwh += h_hi.t() @ dg_hi
        if split_dw:
            dwi += xf[t].t() @ dg_lo
            dwh += h_hi.t() @ dg_lo + h_lo.t() @ dg_hi
        db += dg.sum(dim=0)
    return dx, dwi, dwh, db


def _max_rel_errors(got, want):
    return {name: float((g.float() - torch.as_tensor(w).float()).abs().max()
                        / torch.as_tensor(w).float().abs().max())
            for name, g, w in zip(NAMES, got, want)}


@pytest.mark.parametrize("call", [_bwd_call_ti, _bwd_call],
                         ids=["ti", "2t"])
@pytest.mark.parametrize("t,n,c", [(8, 96, 64), (4, 200, 128)])
def test_tensor_core_arithmetic_matches_both_tpu_kernels_bf16(call, t, n, c):
    arrays = _inputs(t, n, c, seed=t * n + c)
    x, w_ih, w_hh, b, dh = (jnp.asarray(a).astype(jnp.bfloat16)
                            for a in arrays)
    jdx, jdwi, jdwh, jdb = call(x, w_ih, w_hh, b, dh, interpret=True)
    want = [np.array(jdx.astype(jnp.float32)), np.array(jdwi),
            np.array(jdwh), np.array(jdb).reshape(-1)]
    got = _tc_bwd(*(torch.from_numpy(a).to(BF16) for a in arrays))
    assert got[0].dtype == BF16
    errs = _max_rel_errors(got, want)
    for name in NAMES:
        assert errs[name] <= BWD_TOL[name], (name, errs)


def test_tensor_core_arithmetic_matches_the_plain_twin_bf16():
    """The kernel is held to lstm_last_x_bwd_plain on the card: the
    emulated arithmetic sits well inside that tolerance too."""
    arrays = [torch.from_numpy(a).to(BF16) for a in _inputs(8, 512, 64, 9)]
    errs = _max_rel_errors(_tc_bwd(*arrays), lstm_last_x_bwd_plain(*arrays))
    for name in NAMES:
        assert errs[name] <= BWD_TOL[name], (name, errs)
    assert max(errs["dw_ih"], errs["dw_hh"], errs["db"]) <= 1e-5, errs


_F32_NORMAL_LO = st.floats(width=32, allow_nan=False, allow_infinity=False,
                           min_value=-2.0 ** 127, max_value=2.0 ** 127).filter(
    lambda v: v == 0.0 or abs(v) >= 2.0 ** -100)


@settings(max_examples=300, deadline=None)
@given(st.lists(_F32_NORMAL_LO, min_size=1, max_size=64))
def test_split_reproduces_f32_values(values):
    v = torch.tensor(values, dtype=F32)
    hi, lo = _split(v)
    assert torch.equal(hi, hi.to(BF16).float())
    assert torch.equal(lo, lo.to(BF16).float())
    err = (hi.double() + lo.double() - v.double()).abs()
    assert bool((err <= 2.0 ** -16 * v.double().abs()).all())


def test_split_across_binades_and_zeros():
    rng = np.random.default_rng(0)
    mant = rng.uniform(1.0, 2.0, 4000)
    exps = rng.integers(-100, 120, 4000)
    signs = rng.choice([-1.0, 1.0], 4000)
    vals = np.concatenate([signs * np.ldexp(mant, exps), [0.0, -0.0]])
    v = torch.from_numpy(vals.astype(np.float32))
    hi, lo = _split(v)
    err = (hi.double() + lo.double() - v.double()).abs()
    assert bool((err <= 2.0 ** -16 * v.double().abs()).all())
    assert bool((hi[-2:] == 0).all()) and bool((lo[-2:] == 0).all())
    # the lo part carries real bits: without it the error is ~2^-9
    assert float(((hi.double() - v.double()).abs()
                  / v.double().abs().clamp_min(1e-300)).max()) > 2.0 ** -12


def test_unsplit_dw_misses_the_plain_twin():
    """Dropping the lo terms of dW_ih and dW_hh moves them by more than the
    2^-12 tolerance: the split operands are required, not a refinement."""
    arrays = [torch.from_numpy(a).to(BF16) for a in _inputs(8, 2048, 64, 3)]
    want = lstm_last_x_bwd_plain(*arrays)
    split = _max_rel_errors(_tc_bwd(*arrays), want)
    unsplit = _max_rel_errors(_tc_bwd(*arrays, split_dw=False), want)
    for name in ("dw_ih", "dw_hh"):
        assert split[name] <= BWD_TOL[name], (name, split)
        assert unsplit[name] > BWD_TOL[name], (name, unsplit)


@pytest.mark.parametrize("dtype,c,want", [
    (BF16, 32, False), (BF16, 64, True), (BF16, 128, True),
    (BF16, 96, False), (BF16, 256, False), (BF16, 512, False),
    (F32, 64, False), (F32, 128, False)])
def test_tensor_core_tile_rule(dtype, c, want):
    """The tile kernel takes tensor cores for bf16 at C = 64 and 128, the
    fused training widths; the rule is stated, not a fallback on failure."""
    assert tensor_core_tile(dtype, c) is want
