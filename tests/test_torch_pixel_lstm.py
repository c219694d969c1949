"""The port's pixel-LSTM and its two kernels' plain versions
(stf_unet_tpu_torch/ops/lstm.py, ops/kernels/) held against the JAX
package: the Pallas kernels in interpret mode and the XLA scan, on the CPU.

Tolerances: f32 atol 2e-5, the JAX package's own kernel-vs-scan bound
(tests/test_lstm_train_kernel.py) - the same arithmetic summed in another
order. bf16 atol 2^-7: the kernels round h_T (and K1 its recurrent h) to
bf16, whose spacing is 2^-8 just below 1, and a sum-order change may flip
a rounding.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from stf_unet_tpu.ops.lstm import lstm_scan as jax_lstm_scan
from stf_unet_tpu.ops.lstm import pixel_lstm as jax_pixel_lstm
from stf_unet_tpu.ops.pallas.lstm_kernel import fused_lstm_last
from stf_unet_tpu.ops.pallas.lstm_train_kernel import fused_lstm_last_x
from stf_unet_tpu_torch.ops import lstm as port_lstm
from stf_unet_tpu_torch.ops.kernels import build
from stf_unet_tpu_torch.ops.kernels.lstm_last import (lstm_last,
                                                      lstm_last_plain)
from stf_unet_tpu_torch.ops.kernels.lstm_last_x import (lstm_last_x,
                                                        lstm_last_x_plain)

F32_ATOL = 2e-5
BF16_ATOL = 2.0 ** -7


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
    return x, w_ih, w_hh, b


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


@pytest.mark.parametrize("t,n,c", [(8, 70, 16), (3, 200, 64), (5, 129, 16)])
def test_lstm_last_x_plain_matches_pallas_interpret(t, n, c):
    x, w_ih, w_hh, b = _inputs(t, n, c, seed=t * n + c)
    want = fused_lstm_last_x(jnp.asarray(x), jnp.asarray(w_ih),
                             jnp.asarray(w_hh), jnp.asarray(b), True)
    got = lstm_last_x_plain(_t(x), _t(w_ih), _t(w_hh), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("t,n,c", [(8, 70, 16), (4, 200, 64), (2, 97, 16)])
def test_lstm_last_plain_matches_pallas_interpret(t, n, c):
    x, w_ih, w_hh, b = _inputs(t, n, c, seed=7 * t + n + c)
    x_proj = np.einsum("tnc,cd->tnd", x, w_ih)
    want = fused_lstm_last(jnp.asarray(x_proj), jnp.asarray(w_hh),
                           jnp.asarray(b), tile_n=32, interpret=True)
    got = lstm_last_plain(_t(x_proj), _t(w_hh), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=F32_ATOL, rtol=0)


def _bf16(a):
    """numpy f32 -> (jnp bf16, torch bf16) holding the same values."""
    t = _t(a, torch.bfloat16)
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


def test_lstm_last_x_plain_bf16_rounding_points():
    """K1 casts h to bf16 before the recurrent product and keeps c in f32:
    the plain version reproduces the interpret-mode TPU kernel in bf16."""
    x, w_ih, w_hh, b = (_bf16(a) for a in _inputs(8, 96, 64, seed=11))
    want = fused_lstm_last_x(x[0], w_ih[0], w_hh[0], b[0], True)
    got = lstm_last_x_plain(x[1], w_ih[1], w_hh[1], b[1])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=BF16_ATOL, rtol=0)


def test_lstm_last_plain_bf16_rounding_points():
    """K3 takes a bf16 x_proj and keeps h in f32 for the product."""
    x, w_ih, w_hh, b = _inputs(8, 96, 64, seed=12)
    x_proj = _bf16(np.einsum("tnc,cd->tnd", x, w_ih))
    w_hh, b = _bf16(w_hh), _bf16(b)
    want = fused_lstm_last(x_proj[0], w_hh[0], b[0], tile_n=32,
                           interpret=True)
    got = lstm_last_plain(x_proj[1], w_hh[1], b[1])
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize("backend,jax_backend", [
    ("scan", "scan"),
    ("fused", "pallas_fused_interpret"),
    ("last", "pallas_last_interpret"),
])
@pytest.mark.parametrize("shape", [(2, 3, 5, 7, 16), (1, 4, 10, 10, 64)])
def test_pixel_lstm_backends_match_jax(backend, jax_backend, shape):
    rng = np.random.default_rng(sum(shape))
    c = shape[-1]
    feat = rng.normal(size=shape).astype(np.float32)
    _, w_ih, w_hh, b = _inputs(1, 1, c, seed=c)
    want = jax_pixel_lstm(jnp.asarray(feat), jnp.asarray(w_ih),
                          jnp.asarray(w_hh), jnp.asarray(b),
                          backend=jax_backend, train=False)
    got = port_lstm.pixel_lstm(_t(feat), _t(w_ih), _t(w_hh), _t(b),
                               backend=backend)
    assert tuple(got.shape) == shape[:1] + shape[2:]
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=F32_ATOL, rtol=0)


def test_lstm_scan_matches_jax_scan():
    x, w_ih, w_hh, b = _inputs(6, 80, 16, seed=3)
    want = jax_lstm_scan(jnp.asarray(x), jnp.asarray(w_ih),
                         jnp.asarray(w_hh), jnp.asarray(b))
    got = port_lstm.lstm_scan(_t(x), _t(w_ih), _t(w_hh), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=F32_ATOL, rtol=0)


def test_wrappers_take_the_plain_version_on_cpu():
    """On a CPU tensor each wrapper returns its plain version's result and
    launches nothing."""
    x, w_ih, w_hh, b = (_t(a) for a in _inputs(4, 50, 32, seed=5))
    before = (lstm_last_x.launches, lstm_last.launches)
    torch.testing.assert_close(lstm_last_x(x, w_ih, w_hh, b),
                               lstm_last_x_plain(x, w_ih, w_hh, b),
                               rtol=0, atol=0)
    xp = x @ w_ih
    torch.testing.assert_close(lstm_last(xp, w_hh, b),
                               lstm_last_plain(xp, w_hh, b), rtol=0, atol=0)
    assert (lstm_last_x.launches, lstm_last.launches) == before


def test_wrappers_refuse_other_devices():
    x, w_ih, w_hh, b = (_t(a).to("meta") for a in _inputs(2, 8, 32, seed=1))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        lstm_last_x(x, w_ih, w_hh, b)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        lstm_last(x @ w_ih, w_hh, b)


def test_auto_routing():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert port_lstm.lstm_backend_default(cpu, 64) == "scan"
    assert port_lstm.lstm_backend_default(cpu, 512) == "scan"
    for c in (64, 128, 256):
        assert port_lstm.lstm_backend_default(cuda, c) == "fused"
    assert port_lstm.lstm_backend_default(cuda, 512) == "last"
    with pytest.raises(ValueError, match="Unknown LSTM backend"):
        port_lstm.pixel_lstm(torch.zeros(1, 2, 2, 2, 16),
                             torch.zeros(16, 64), torch.zeros(16, 64),
                             None, backend="pallas_fused")


def test_pack_gates_layout():
    """The kernels read W [C, 4C] as [C, C, 4]: (k, j, g) = W[k, g*C + j]."""
    c = 32
    w = torch.arange(c * 4 * c, dtype=torch.float32).reshape(c, 4 * c)
    packed = build.pack_gates(w)
    assert packed.shape == (c, c, 4) and packed.is_contiguous()
    for k, j, g in [(0, 0, 0), (3, 5, 2), (31, 31, 3), (7, 0, 1)]:
        assert packed[k, j, g] == w[k, g * c + j]
    # a transposed view (the model's weight_ih_l0.t()) packs the same
    torch.testing.assert_close(build.pack_gates(w.t().contiguous().t()),
                               packed, rtol=0, atol=0)


def test_kernel_sources_and_build_names():
    """Each kernel has its CUDA source; the library name follows the
    sources' content, so an edited source is rebuilt."""
    for name in build.KERNELS:
        assert (build.CSRC / f"{name}.cu").is_file()
        path = build.library_path(name)
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
    assert build.library_path("lstm_last") != build.library_path(
        "lstm_last_x")
