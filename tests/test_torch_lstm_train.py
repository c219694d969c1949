"""The port's pixel-LSTM training path (kernel K1b's plain version, the
LstmLastX autograd Function, the training routing) held against the JAX
package on the CPU: both TPU backward kernels, `_bwd_call_ti` and
`_bwd_call`, in Pallas interpret mode, and jax.grad through
`fused_lstm_last_x(interpret=True)`.

Tolerances:
  * f32, plain backward vs each TPU backward kernel: atol 3e-5, rtol 2e-5,
    the JAX package's own bound between its two backward kernels
    (tests/test_lstm_train_kernel.py) - the same f32 arithmetic summed in
    another order.
  * bf16 inputs: the recompute rounds h to bf16 before the recurrent
    product and dx is rounded to bf16, at the same points on both sides;
    a sum-order change may flip one such rounding (2^-8 relative below 1),
    which then moves dx by one bf16 step and the f32 dW / db by a little.
    dx atol 2^-7 * max|dx|, dW / db atol 2^-8 * max|grad|.
  * plain dW_hh vs an autograd reference with the same rounding point:
    1e-5 * max (f32 sum order); vs one with the other rounding point (the
    rounded h): more than twice chip_smoke.py's bf16 dW tolerance 2^-12.
  * autograd through LstmLastX vs jax.grad through the interpret kernel:
    atol/rtol 3e-4, the JAX package's kernel-vs-autodiff bound.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stf_unet_tpu.ops.pallas.lstm_train_kernel import (_bwd_call,
                                                       _bwd_call_ti,
                                                       fused_lstm_last_x)
from stf_unet_tpu_torch.ops import lstm as port_lstm
from stf_unet_tpu_torch.ops.kernels.lstm_last import lstm_last
from stf_unet_tpu_torch.ops.kernels.lstm_last_x import (LstmLastX,
                                                        lstm_last_x,
                                                        lstm_last_x_plain)
from stf_unet_tpu_torch.ops.kernels.lstm_last_x_bwd import (
    dw_splits, lstm_last_x_bwd, lstm_last_x_bwd_plain)

SHAPES = [(8, 96, 64), (4, 200, 128), (8, 300, 64)]
NAMES = ("dx", "dw_ih", "dw_hh", "db")


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
    return x, w_ih, w_hh, b, dh


def _jax_bwd(call, arrays, dtype):
    x, w_ih, w_hh, b, dh = (jnp.asarray(a).astype(dtype) for a in arrays)
    dx, dwi, dwh, db = call(x, w_ih, w_hh, b, dh, interpret=True)
    return [np.asarray(dx.astype(jnp.float32)), np.asarray(dwi),
            np.asarray(dwh), np.asarray(db).reshape(-1)]


def _port_bwd(arrays, dtype):
    got = lstm_last_x_bwd(*(torch.from_numpy(a).to(dtype) for a in arrays))
    assert got[0].dtype == dtype
    assert all(g.dtype == torch.float32 for g in got[1:])
    return [g.float().numpy() for g in got]


@pytest.mark.parametrize("call", [_bwd_call_ti, _bwd_call],
                         ids=["ti", "2t"])
@pytest.mark.parametrize("t,n,c", SHAPES)
def test_plain_backward_matches_both_tpu_kernels_f32(call, t, n, c):
    arrays = _inputs(t, n, c, seed=t * n + c)
    want = _jax_bwd(call, arrays, jnp.float32)
    got = _port_bwd(arrays, torch.float32)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=3e-5, rtol=2e-5, err_msg=name)


@pytest.mark.parametrize("call", [_bwd_call_ti, _bwd_call],
                         ids=["ti", "2t"])
def test_plain_backward_bf16_rounding_points(call):
    """bf16 x / weights / dh: the recompute's round(h) and dx's rounding
    sit where the TPU kernel has them."""
    arrays = [torch.from_numpy(a).to(torch.bfloat16).float().numpy()
              for a in _inputs(8, 96, 64, seed=5)]
    want = _jax_bwd(call, arrays, jnp.bfloat16)
    got = _port_bwd(arrays, torch.bfloat16)
    for name, g, w in zip(NAMES, got, want):
        scale = np.abs(w).max()
        atol = (2.0 ** -7 if name == "dx" else 2.0 ** -8) * scale
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=name)
    # the rounding matters: an f32 backward of the same values differs
    f32 = _port_bwd(arrays, torch.float32)
    assert np.abs(f32[0] - got[0]).max() > 0


class _RecurrentProduct(torch.autograd.Function):
    """round(h) @ W_hh forward; backward takes dW_hh from the rounded h
    (`round_in_dw`) or from the unrounded f32 h (the TPU kernel's point)."""

    @staticmethod
    def forward(ctx, h, w_hh, dtype, round_in_dw):
        hr = h.to(dtype).float()
        ctx.save_for_backward(hr if round_in_dw else h, w_hh)
        return hr @ w_hh

    @staticmethod
    def backward(ctx, g):
        h, w_hh = ctx.saved_tensors
        return g @ w_hh.t(), h.t() @ g, None, None


def _dw_hh_by_autograd(arrays, dtype, round_in_dw):
    x, w_ih, w_hh, b, dh = (torch.from_numpy(a).to(dtype).float()
                            for a in arrays)
    w_hh.requires_grad_()
    h = cst = torch.zeros_like(dh)
    for t in range(x.shape[0]):
        gates = x[t] @ w_ih + _RecurrentProduct.apply(h, w_hh, dtype,
                                                      round_in_dw) + b
        i, f, g, o = gates.chunk(4, dim=1)
        cst = torch.sigmoid(f) * cst + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(cst)
    return torch.autograd.grad((h * dh).sum(), w_hh)[0].numpy()


@pytest.mark.parametrize("n,c", [(2048, 64), (1024, 128)])
def test_bf16_dw_tolerance_separates_the_rounding_points(n, c):
    """chip_smoke.py holds K1b's bf16 dW / db to 2^-12 of their max. The
    plain backward's dW_hh equals an autograd reference that takes it from
    the unrounded h (f32 sum order apart), and differs by more than that
    tolerance from one that takes it from the rounded h."""
    tol = 2.0 ** -12
    arrays = _inputs(8, n, c, seed=n + c)
    got = _port_bwd(arrays, torch.bfloat16)[2]
    same = _dw_hh_by_autograd(arrays, torch.bfloat16, round_in_dw=False)
    other = _dw_hh_by_autograd(arrays, torch.bfloat16, round_in_dw=True)
    scale = np.abs(got).max()
    assert np.abs(got - same).max() <= 1e-5 * scale
    assert np.abs(got - other).max() > 2 * tol * scale


def test_autograd_through_lstm_last_x_matches_jax_grad():
    t, n, c = 8, 96, 64
    x, w_ih, w_hh, b, cot = _inputs(t, n, c, seed=2)

    def loss(x, w_ih, w_hh, b):
        return jnp.sum(fused_lstm_last_x(x, w_ih, w_hh, b, True) * cot)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x, w_ih, w_hh, b)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w_ih, w_hh,
                                                            b)]
    out = lstm_last_x(*leaves)
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), leaves)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3e-4,
                                   rtol=3e-4, err_msg=name)


def test_pixel_lstm_fused_backend_grads_equal_autograd_of_plain():
    """Gradients through pixel_lstm(backend="fused") - LstmLastX with the
    plain backward on the CPU - equal autograd through the differentiable
    plain forward, f32. Before LstmLastX existed this path returned an
    output with no grad_fn."""
    rng = np.random.default_rng(4)
    c = 64
    feat = torch.from_numpy(rng.normal(size=(2, 4, 5, 6, c))
                            .astype(np.float32)).requires_grad_()
    _, w_ih, w_hh, b, _ = _inputs(4, 1, c, seed=4)
    params = [torch.from_numpy(a).requires_grad_() for a in (w_ih, w_hh, b)]
    out = port_lstm.pixel_lstm(feat, *params, backend="fused", train=True)
    assert out.grad_fn is not None
    cot = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
    got = torch.autograd.grad((out * cot).sum(), [feat, *params])

    lanes = feat.transpose(0, 1).reshape(4, -1, c)
    plain = lstm_last_x_plain(lanes, *params).reshape(out.shape)
    want = torch.autograd.grad((plain * cot).sum(), [feat, *params])
    for name, g, w in zip(("dfeat", "dw_ih", "dw_hh", "db"), got, want):
        torch.testing.assert_close(g, w, atol=3e-5, rtol=2e-5,
                                   msg=lambda m: f"{name}: {m}")


def test_lstm_last_x_function_casts_like_the_jax_vjp():
    """bf16 weights get bf16 gradients (dW, db accumulated in f32, then
    cast), dx comes back in x's dtype."""
    arrays = _inputs(3, 40, 32, seed=6)
    leaves = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
              for a in arrays[:4]]
    out = LstmLastX.apply(*leaves)
    assert out.dtype == torch.bfloat16
    grads = torch.autograd.grad(out.float().sum(), leaves)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 4
    _, dwi, _, db = lstm_last_x_bwd_plain(
        *(v.detach() for v in leaves), torch.ones_like(out))
    torch.testing.assert_close(grads[1], dwi.to(torch.bfloat16), rtol=0,
                               atol=0)
    torch.testing.assert_close(grads[3], db.to(torch.bfloat16), rtol=0,
                               atol=0)


@pytest.mark.parametrize("device,c,train,want", [
    ("cuda", 64, True, "fused"), ("cuda", 128, True, "fused"),
    ("cuda", 256, True, "scan"), ("cuda", 512, True, "scan"),
    ("cuda", 64, False, "fused"), ("cuda", 256, False, "fused"),
    ("cuda", 512, False, "last"), ("cpu", 64, True, "scan"),
    ("cpu", 512, False, "scan"),
])
def test_training_routing(device, c, train, want):
    assert port_lstm.FUSED_TRAIN_MAX_C == 128
    got = port_lstm.lstm_backend_default(torch.device(device), c, train)
    assert got == want


def test_model_routes_by_training_mode(monkeypatch):
    """PixelLSTM.forward passes train=self.training to pixel_lstm."""
    from stf_unet_tpu_torch.models.stf_lstm_unet import PixelLSTM

    seen = []

    def spy(*args, **kwargs):
        seen.append(kwargs["train"])
        return args[0][:, -1]

    monkeypatch.setattr("stf_unet_tpu_torch.models.stf_lstm_unet."
                        "pixel_lstm", spy)
    mod = PixelLSTM(32)
    feat = torch.zeros((1, 2, 3, 3, 32))
    mod.train()(feat)
    mod.eval()(feat)
    assert seen == [True, False]


def test_lstm_last_refuses_gradients():
    """K3 has no backward (as on the TPU): under grad it raises instead of
    returning an output cut from the graph."""
    _, w_ih, w_hh, b, _ = _inputs(2, 10, 32, seed=8)
    xp = torch.zeros((2, 10, 128), requires_grad=True)
    wh, bias = torch.from_numpy(w_hh), torch.from_numpy(b)
    with pytest.raises(RuntimeError, match="no backward"):
        lstm_last(xp, wh, bias)
    with pytest.raises(RuntimeError, match="no backward"):
        port_lstm.pixel_lstm(torch.zeros((1, 2, 2, 5, 32)),
                             torch.from_numpy(w_ih).requires_grad_(), wh,
                             bias, backend="last")
    with torch.no_grad():
        assert lstm_last(xp, wh, bias).shape == (10, 32)


def test_dw_splits_cover_the_rows():
    for t, n, c in [(8, 50176, 64), (8, 12544, 128), (8, 3136, 256),
                    (2, 7, 32), (8, 784, 512)]:
        for dtype in (torch.float32, torch.bfloat16):
            s = dw_splits(t, n, c, dtype)
            assert 1 <= s <= 65535
            per = -(-t * n // s)
            assert per * s >= t * n and per * (s - 1) < t * n
