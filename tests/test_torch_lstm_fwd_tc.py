"""The arithmetic of K1 forward's bf16 tensor-core kernel
(`stf_unet_tpu_torch/csrc/lstm_last_x.cu`, `lstm_tc.cuh`), emulated in
plain PyTorch here and held against the JAX package's TPU kernel
(`fused_lstm_last_x`, Pallas interpret mode) and the port's plain twin,
bf16.

The kernel itself runs only on the card (chip_smoke.py holds it to its
plain twin there); what it computes can be checked on the CPU:
  * gates = x_t W_ih + round(h_{t-1}) W_hh + b: x_t and round(h_{t-1}) are
    exactly bf16 and W is bf16, so every product is exact in f32 and no
    hi/lo split is needed (the TPU kernel's rounding point);
  * the sums are f32, taken per 16-deep k block as WMMA does, with the
    x_t and the h products of one block added to the same accumulator,
    x first; the bias is added to the finished sums;
  * the cell runs in f32, c carried in f32, h_T rounded to bf16 once.
Every product of two bf16 values is exact in f32, so the emulation forms
them in f32 and sums in f32, as the tensor cores do (in another order).

Tolerance: chip_smoke.py's TOL["bf16"] = 2^-7, the kernel's on the card:
h_T (|h| < 1) is rounded to bf16, whose spacing is 2^-8 just below 1, and
a sum-order change may flip one rounding of the recurrent h on the way.
Row counts are ragged (not multiples of the kernel's 16- or 32-row tile):
rows are independent, so the tile's zero rows past N change nothing.
"""

import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from stf_unet_tpu.ops.pallas.lstm_train_kernel import fused_lstm_last_x
from stf_unet_tpu_torch.ops.kernels.build import CSRC
from stf_unet_tpu_torch.ops.kernels.lstm_last_x import (TC_FWD_C,
                                                        lstm_last_x,
                                                        lstm_last_x_plain,
                                                        tensor_core_fwd)

TOL = 2.0 ** -7
K_BLOCK = 16  # WMMA's depth: bf16 16 x 16 x 16
F32 = torch.float32
BF16 = torch.bfloat16
SHAPES = [(3, 70, 16), (8, 200, 64), (5, 129, 64), (8, 129, 16)]


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
    # bf16-exact, so JAX and the port start from the same values
    return [torch.from_numpy(a).to(BF16).float().numpy()
            for a in (x, w_ih, w_hh, b)]


def _tc_fwd(x, w_ih, w_hh, b):
    """K1's bf16 tensor-core arithmetic on bf16 inputs -> h_T in bf16."""
    t_steps, n, c = x.shape
    xf, wi, wh, bias = (v.float() for v in (x, w_ih, w_hh, b))
    h = torch.zeros((n, c), dtype=F32)
    cs = torch.zeros_like(h)
    for t in range(t_steps):
        hb = h.to(BF16).float()  # round(h_{t-1}): an exactly-bf16 operand
        acc = torch.zeros((n, 4 * c), dtype=F32)
        for k0 in range(0, c, K_BLOCK):
            ks = slice(k0, k0 + K_BLOCK)
            acc = acc + xf[t][:, ks] @ wi[ks]
            acc = acc + hb[:, ks] @ wh[ks]
        i, f, g, o = (acc + bias).chunk(4, dim=1)
        cs = torch.sigmoid(f) * cs + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(cs)
    return h.to(BF16)


def _max_err(got, want) -> float:
    return float((got.float() - torch.as_tensor(want).float()).abs().max())


@pytest.mark.parametrize("t,n,c", SHAPES)
def test_tensor_core_arithmetic_matches_the_tpu_kernel_bf16(t, n, c):
    arrays = _inputs(t, n, c, seed=t * n + c)
    x, w_ih, w_hh, b = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrays)
    want = np.array(fused_lstm_last_x(x, w_ih, w_hh, b, True)
                    .astype(jnp.float32))
    got = _tc_fwd(*(torch.from_numpy(a).to(BF16) for a in arrays))
    assert got.dtype == BF16 and got.shape == (n, c)
    assert _max_err(got, want) <= TOL


@pytest.mark.parametrize("t,n,c", SHAPES)
def test_tensor_core_arithmetic_matches_the_plain_twin_bf16(t, n, c):
    """The kernel is held to lstm_last_x_plain on the card: the emulated
    arithmetic sits within that tolerance on the CPU, and the wrapper on a
    CPU tensor is the plain twin."""
    arrays = [torch.from_numpy(a).to(BF16)
              for a in _inputs(t, n, c, seed=7 * t + n)]
    want = lstm_last_x_plain(*arrays)
    assert _max_err(_tc_fwd(*arrays), want) <= TOL
    assert torch.equal(lstm_last_x(*arrays), want)


@pytest.mark.parametrize("dtype,c,want", [
    (BF16, 32, False), (BF16, 64, True), (BF16, 96, False),
    (BF16, 128, True), (BF16, 256, True), (BF16, 512, False),
    (F32, 64, False), (F32, 128, False), (F32, 256, False)])
def test_tensor_core_fwd_rule(dtype, c, want):
    """The forward takes tensor cores for bf16 at C = 64, 128 and 256, the
    serving and training widths; f32 keeps the CUDA-core kernel (TF32
    would break its 2e-5 tolerance). The rule is stated, not a fallback."""
    assert tensor_core_fwd(dtype, c) is want


def test_cuda_source_launches_every_tensor_core_width():
    """The C entry's tensor-core dispatch (csrc/lstm_last_x.cu) covers
    exactly TC_FWD_C, so the wrapper's rule never sends a width the .cu
    refuses."""
    src = (CSRC / "lstm_last_x.cu").read_text()
    widths = {int(c) for c in re.findall(r"return launch_tc<(\d+)>\(", src)}
    assert widths == set(TC_FWD_C)
