"""The arithmetic of K3's bf16 tensor-core kernel
(`stf_unet_tpu_torch/csrc/lstm_last.cu`, `lstm_last_tc_kernel`), emulated
in plain PyTorch here and held against the JAX package's TPU kernel
(`fused_lstm_last`, Pallas interpret mode) and the port's plain twin,
bf16.

The kernel itself runs only on the card (chip_smoke.py holds it to its
plain twin there); what it computes can be checked on the CPU:
  * h_{t-1} stays f32 in the product: it is split as h = hi + lo, both
    bf16 (hi = bf16(h), lo = bf16(h - hi)), and the step forms hi W_hh +
    lo W_hh. W_hh is bf16, so every product is exact in f32;
  * the sums are f32, per 16-deep k block as WMMA takes them, the hi and
    the lo product of a block added to the same accumulator, hi first;
    at t = 0 (h = 0) there are no products;
  * gates = (x_proj_t + acc) + b in f32, the TPU kernel's order; the cell
    runs in f32, c carried in f32, h_T rounded to bf16 once.
The split drops h - (hi + lo), at most 2^-16 of |h|; the units' split
over a cluster's blocks moves no sum.

Tolerance: chip_smoke.py's TOL["bf16"] = 2^-7, the kernel's on the card:
h_T (|h| < 1) is rounded to bf16, whose spacing is 2^-8 just below 1, so
a sum-order change may flip its rounding. Row counts are ragged (not
multiples of the kernel's 32-row tile): rows are independent, so the
tile's rows past N change nothing.
"""

import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from stf_unet_tpu.ops.pallas.lstm_kernel import fused_lstm_last
from stf_unet_tpu_torch.ops.kernels.build import CSRC
from stf_unet_tpu_torch.ops.kernels.lstm_last import (TC_LAST_C, lstm_last,
                                                      lstm_last_plain,
                                                      tensor_core_last)

TOL = 2.0 ** -7
K_BLOCK = 16  # WMMA's depth: bf16 16 x 16 x 16
F32 = torch.float32
BF16 = torch.bfloat16
SHAPES = [(8, 70, 256), (8, 49, 512), (8, 37, 512), (3, 20, 256)]


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
    """x_proj = x @ W_ih rounded to bf16 (as the serving path hands it to
    K3), W_hh and b: bf16-exact numpy arrays, so JAX and the port start
    from the same values."""
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(c)
    x = rng.normal(size=(t, n, c)).astype(np.float32)
    w_ih = rng.uniform(-k, k, (c, 4 * c)).astype(np.float32)
    w_hh = rng.uniform(-k, k, (c, 4 * c)).astype(np.float32)
    b = rng.uniform(-k, k, (4 * c,)).astype(np.float32)
    bf = [torch.from_numpy(a).to(BF16) for a in (x, w_ih, w_hh, b)]
    x_proj = bf[0] @ bf[1]
    return [v.float().numpy() for v in (x_proj, bf[2], bf[3])]


def _split(h):
    hi = h.to(BF16).float()
    return hi, (h - hi).to(BF16).float()


def _tc_last(x_proj, w_hh, b, split=True):
    """K3's bf16 tensor-core arithmetic on bf16 inputs -> h_T in bf16;
    with split=False the hi product alone (h rounded to bf16)."""
    t_steps, n, four_c = x_proj.shape
    c = four_c // 4
    xp, wh, bias = (v.float() for v in (x_proj, w_hh, b))
    h = torch.zeros((n, c), dtype=F32)
    cs = torch.zeros_like(h)
    for t in range(t_steps):
        acc = torch.zeros((n, 4 * c), dtype=F32)
        if t > 0:
            hi, lo = _split(h)
            for k0 in range(0, c, K_BLOCK):
                ks = slice(k0, k0 + K_BLOCK)
                acc = acc + hi[:, ks] @ wh[ks]
                if split:
                    acc = acc + lo[:, ks] @ wh[ks]
        i, f, g, o = ((xp[t] + acc) + bias).chunk(4, dim=1)
        cs = torch.sigmoid(f) * cs + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(cs)
    return h.to(BF16)


def _max_err(got, want) -> float:
    return float((got.float() - torch.as_tensor(want).float()).abs().max())


@pytest.mark.parametrize("t,n,c", SHAPES)
def test_tensor_core_arithmetic_matches_the_tpu_kernel_bf16(t, n, c):
    arrays = _inputs(t, n, c, seed=t * n + c)
    x_proj, w_hh, b = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrays)
    want = np.array(fused_lstm_last(x_proj, w_hh, b, interpret=True)
                    .astype(jnp.float32))
    got = _tc_last(*(torch.from_numpy(a).to(BF16) for a in arrays))
    assert got.dtype == BF16 and got.shape == (n, c)
    assert _max_err(got, want) <= TOL


@pytest.mark.parametrize("t,n,c", SHAPES)
def test_tensor_core_arithmetic_matches_the_plain_twin_bf16(t, n, c):
    """The kernel is held to lstm_last_plain on the card: the emulated
    arithmetic sits within that tolerance on the CPU, and the wrapper on a
    CPU tensor is the plain twin and launches nothing."""
    arrays = [torch.from_numpy(a).to(BF16)
              for a in _inputs(t, n, c, seed=7 * t + n)]
    want = lstm_last_plain(*arrays)
    assert _max_err(_tc_last(*arrays), want) <= TOL
    before = lstm_last.launches
    assert torch.equal(lstm_last(*arrays), want)
    assert lstm_last.launches == before


def test_split_keeps_h_to_2_pow_minus_16():
    """hi + lo equals an f32 h in (-1, 1) to 2^-16 of |h| (lo normal); hi
    alone is off by up to 2^-9, which the lo product restores."""
    h = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, 100_000).astype(np.float32))
    h = h[h.abs() > 1e-30]
    hi, lo = _split(h)
    assert float(((hi + lo - h).abs() / h.abs()).max()) <= 2.0 ** -16
    assert float(((hi - h).abs() / h.abs()).max()) > 2.0 ** -10


@pytest.mark.parametrize("t,n,c", [(8, 49, 512), (8, 70, 256)])
def test_split_is_ten_times_closer_than_h_rounded_to_bf16(t, n, c):
    """chip_smoke.py's split_control on the card: max |difference| cannot
    tell the split from h rounded to bf16 (both read one bf16 step of
    h_T), the mean |difference| from the plain twin can. The split's
    arithmetic sits at least 1 / K3_SPLIT_RATIO = 10 times closer than
    the hi product alone."""
    arrays = [torch.from_numpy(a).to(BF16)
              for a in _inputs(t, n, c, seed=11 * n + c)]
    want = lstm_last_plain(*arrays).float()
    err = {split: float((_tc_last(*arrays, split=split).float() - want)
                        .abs().mean()) for split in (True, False)}
    assert err[True] <= 0.1 * err[False], err


@pytest.mark.parametrize("dtype,c,want", [
    (BF16, 64, False), (BF16, 128, False), (BF16, 256, True),
    (BF16, 512, True), (BF16, 384, False), (F32, 256, False),
    (F32, 512, False)])
def test_tensor_core_last_rule(dtype, c, want):
    """K3 takes tensor cores for bf16 at C = 256 and 512 (512 is the
    serving width that reaches it, 256 the width the serving-routing
    measurement times it at); f32 keeps the CUDA-core kernel. The rule is
    stated, not a fallback."""
    assert tensor_core_last(dtype, c) is want


def test_cuda_source_launches_every_tensor_core_width():
    """The C entry's tensor-core dispatch (csrc/lstm_last.cu) covers
    exactly TC_LAST_C, so the wrapper's rule never sends a width the .cu
    refuses."""
    src = (CSRC / "lstm_last.cu").read_text()
    widths = {int(c) for c in re.findall(r"return launch_tc<(\d+)>\(", src)}
    assert widths == set(TC_LAST_C)
