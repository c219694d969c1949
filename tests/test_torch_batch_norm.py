"""K7, the train-mode batch normalization (ops/kernels/batch_norm.py,
csrc/batch_norm.cu), and TorchBatchNorm's routing through it.

On the CPU:
  * the plain twins against F.batch_norm with autograd in float32 and
    float64, NCHW and channels-last: the output, the saved mean and
    invstd, dx, grad_weight, grad_bias and the running statistics, at
    HW = 49, C = 32 and 1024 and row counts that no split divides;
    gradcheck of the autograd Function in float64;
  * TorchBatchNorm against the rule it followed before K7 (nn.BatchNorm2d
    and flax's running-variance correction), alone, under the model's
    hooks and in the frozen (remat) recompute;
  * the refusals: a 5-D input, a non-contiguous one, one row a channel,
    and (at a TrainState's construction) a float64 model whose BN would
    run K7 on a card;
  * the kernels' grid (`tiling`) at every BN shape of both benchmark
    cells (from the models on the meta device): at least two blocks on
    each of the H100's 132 SMs, and the tiling's invariants that
    csrc/batch_norm.cu checks; and the kernels' index arithmetic,
    emulated here, reading every element once in its own channel;
  * twin_excess, the card's check of the kernels, on the plain path
    (within bounds) and with one fault put in (found).

On a card (marked `chip`: `python -m pytest tests/test_torch_batch_norm.py
--noconftest -m chip`; skipped without CUDA): the kernels against the
plain twins (computed on the card in float64) at every BN shape of both
cells in bfloat16 and float32 and both layouts, two runs bit-identical,
a captured CUDA graph replaying equal to its eager rerun, and the
launches of a replayed training step: 3 forward and 3 backward for each
of the STF-LSTM-UNet's 44 BN layers and the UNet's 18.
"""

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from stf_unet_tpu_torch.core.config import ModelConfig
from stf_unet_tpu_torch.models import blocks
from stf_unet_tpu_torch.models.blocks import (TorchBatchNorm,
                                              batch_running_var_updates,
                                              frozen_running_stats)
from stf_unet_tpu_torch.models.registry import create_model
from stf_unet_tpu_torch.ops.kernels import batch_norm as bn


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small CPU ops: the test
    workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _input(shape, dtype, channels_last, seed=0, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=gen, dtype=torch.float64) * 2.5
         + torch.linspace(-3.0, 3.0, shape[1], dtype=torch.float64).view(
             1, -1, 1, 1))
    x = x.to(device=device, dtype=dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    return x


def _params(c, dtype, seed=1, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    w = torch.rand(c, generator=gen, dtype=torch.float64) + 0.5
    b = torch.randn(c, generator=gen, dtype=torch.float64)
    return w.to(device, dtype), b.to(device, dtype)


# ------------------------------------------------- the twins, on the CPU

SHAPES = [(4, 8, 7, 7), (3, 32, 5, 7), (2, 1024, 3, 3), (5, 3, 13, 11)]
# Against F.batch_norm in float64 on the same inputs: float32 results to
# 1e-5 relative and 1e-6 of the tensor's largest value (the sums over a
# channel's rows are float32's, as ATen's float32 path is: it reads up to
# 1.7e-4 off on a grad_bias of 2,300 here), float64 ones to 1e-12.
TOL = {torch.float32: (1e-5, 1e-6), torch.float64: (1e-12, 1e-12)}


@pytest.mark.parametrize("channels_last", [False, True],
                         ids=["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_twins_are_f_batch_norm(shape, dtype, channels_last):
    c = shape[1]
    x = _input(shape, dtype, channels_last)
    w, b = _params(c, dtype)
    dy = _input(shape, dtype, channels_last, seed=2)
    stats = [torch.rand(c, dtype=dtype), torch.rand(c, dtype=dtype) + 0.5]

    xr, wr, br = (v.to(torch.float64, copy=True).requires_grad_()
                  for v in (x, w, b))
    rm, rv = (s.to(torch.float64, copy=True) for s in stats)
    y_ref = F.batch_norm(xr, rm, rv, wr, br, True, 0.1, 1e-5)
    y_ref.backward(dy.double())
    _, save_mean, save_invstd = torch.ops.aten.native_batch_norm(
        *(v.double() for v in (x, w, b)), None, None, True, 0.1, 1e-5)

    xk, wk, bk = (v.clone().requires_grad_() for v in (x, w, b))
    rm_k, rv_k = (s.clone() for s in stats)
    y, mean, invstd = bn.batch_norm_forward(x, w, b, rm_k, rv_k, 0.1, 1e-5)
    y_fn = bn.batch_norm_train(xk, wk, bk, stats[0].clone(),
                               stats[1].clone(), 0.1, 1e-5)
    y_fn.backward(dy)
    dx, dw, db = bn.batch_norm_backward(dy, x, w, mean, invstd)

    rtol, scale = TOL[dtype]
    for got, want in ((y, y_ref), (y_fn, y_ref), (mean, save_mean),
                      (invstd, save_invstd), (rm_k, rm), (rv_k, rv),
                      (dx, xr.grad), (xk.grad, xr.grad), (dw, wr.grad),
                      (wk.grad, wr.grad), (db, br.grad), (bk.grad, br.grad)):
        want = want.detach()
        torch.testing.assert_close(got.detach().double(), want, rtol=rtol,
                                   atol=scale * want.abs().max().item())
    assert y.is_contiguous(memory_format=bn._format(x))
    assert y.dtype == dx.dtype == dtype
    assert bn.batch_norm_backward(dy, x, w, mean, invstd,
                                  input_grad=False)[0] is None


@pytest.mark.parametrize("channels_last", [False, True],
                         ids=["nchw", "channels_last"])
def test_gradcheck_float64(channels_last):
    x = _input((3, 4, 3, 5), torch.float64, channels_last).requires_grad_()
    w, b = (v.requires_grad_() for v in _params(4, torch.float64))
    assert torch.autograd.gradcheck(
        lambda x, w, b: bn.BatchNormTrain.apply(x, w, b, None, None, 0.1,
                                                1e-5), (x, w, b))


def test_bfloat16_on_the_cpu_is_f_batch_norm():
    x = _input((4, 16, 6, 6), torch.bfloat16, False)
    w, b = _params(16, torch.float32)
    y = bn.batch_norm_train(x, w, b)
    y_ref = F.batch_norm(x, None, None, w, b, True, 0.1, 1e-5)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=2 ** -7,
                               atol=2 ** -7)


# ------------------------------------------ TorchBatchNorm, on the CPU


def _before(layer: TorchBatchNorm, x: torch.Tensor, frozen=False):
    """What TorchBatchNorm did before K7: nn.BatchNorm2d's train forward
    and flax's correction of the running variance (none when frozen)."""
    ref = nn.BatchNorm2d(layer.num_features, eps=layer.eps,
                         momentum=layer.momentum).double()
    ref.load_state_dict(layer.state_dict())
    if frozen:
        return F.batch_norm(x, ref.running_mean.clone(),
                            ref.running_var.clone(), ref.weight, ref.bias,
                            True, ref.momentum, ref.eps), layer.state_dict()
    keep = ref.running_var * (1 - ref.momentum)
    y = ref(x)
    ref.running_var.data.lerp_(keep, 1.0 / (x.numel() // x.shape[1]))
    return y, ref.state_dict()


class _TwoBN(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.a, self.b = TorchBatchNorm(c), TorchBatchNorm(c)
        batch_running_var_updates(self)

    def forward(self, x):
        return self.b(torch.relu(self.a(x)))


@pytest.mark.parametrize("channels_last", [False, True],
                         ids=["nchw", "channels_last"])
@pytest.mark.parametrize("mode", ["alone", "hooks", "frozen"])
def test_torch_batch_norm_keeps_its_rule(mode, channels_last):
    torch.manual_seed(0)
    c = 6
    x = _input((3, c, 5, 4), torch.float64, channels_last)
    if mode == "hooks":
        model = _TwoBN(c).double().train()
        for layer in (model.a, model.b):
            layer.running_mean.uniform_(-1, 1)
            layer.running_var.uniform_(0.5, 2)
            layer.weight.data.uniform_(0.5, 1.5)
        y_a, sd_a = _before(model.a, x)
        y_want, sd_b = _before(model.b, torch.relu(y_a))
        y = model(x)
        got = {"a": model.a.state_dict(), "b": model.b.state_dict()}
        wants = {"a": sd_a, "b": sd_b}
    else:
        layer = TorchBatchNorm(c).double().train()
        layer.running_mean.uniform_(-1, 1)
        layer.running_var.uniform_(0.5, 2)
        y_want, sd = _before(layer, x, frozen=mode == "frozen")
        sd = {k: v.clone() for k, v in sd.items()}
        if mode == "frozen":
            with frozen_running_stats():
                y = layer(x)
        else:
            y = layer(x)
        got, wants = {"layer": layer.state_dict()}, {"layer": sd}
    torch.testing.assert_close(y, y_want, rtol=1e-12, atol=1e-12)
    for name, want in wants.items():
        for k, v in want.items():
            torch.testing.assert_close(got[name][k], v, rtol=1e-12,
                                       atol=1e-12, msg=f"{name}.{k}")


def test_torch_batch_norm_routes_training_through_k7(monkeypatch):
    calls = []
    real = blocks.batch_norm_train

    def spy(*args):
        calls.append(args[3] is not None)
        return real(*args)

    monkeypatch.setattr(blocks, "batch_norm_train", spy)
    layer = TorchBatchNorm(4).train()
    x = torch.randn(2, 4, 3, 3)
    layer(x)
    with frozen_running_stats():
        layer(x)
    layer.eval()
    layer(x)
    # a training forward updates the buffers, the frozen one does not,
    # eval mode is nn.BatchNorm2d's
    assert calls == [True, False]
    assert int(layer.num_batches_tracked) == 1


@pytest.mark.parametrize("bad", ["5d", "strided", "permuted"])
def test_the_op_refuses_what_the_kernels_do_not_read(bad):
    x = torch.randn(2, 4, 6, 6)
    w, b = _params(4, torch.float32)
    x = {"5d": x[:, :, None], "strided": x[:, :, ::2],
         "permuted": x.permute(0, 1, 3, 2)}[bad]
    with pytest.raises(ValueError):
        bn.batch_norm_train(x, w, b)
    with pytest.raises(ValueError):
        bn.batch_norm_forward(x, w, b)


def test_the_op_refuses_one_row_a_channel():
    w, b = _params(4, torch.float32)
    with pytest.raises(ValueError, match="more than one value"):
        bn.batch_norm_train(torch.randn(1, 4, 1, 1), w, b)


@pytest.mark.parametrize("case,refused", [
    ("float64 on cuda", True), ("bf16 on cuda", False),
    ("float32 on cuda", False), ("float64 on cpu", False),
    ("float64 synced on cuda", False), ("bf16 params on cuda", True)])
def test_a_train_state_refuses_what_k7_does_not_take(case, refused):
    """TrainState refuses at construction a model whose train-mode BN
    would reach K7 with float64 (or non-float32 parameters); the device
    is given to the check, as a CPU host has no CUDA tensor to make."""
    from stf_unet_tpu_torch.core.config import OptimConfig
    from stf_unet_tpu_torch.train.state import TrainState, make_optimizer

    model = _TwoBN(4)
    dtype = torch.float64 if "float64" in case else (
        torch.float32 if "float32" in case else torch.bfloat16)
    model.compute_dtype = dtype
    if "float64" in case:
        model.double()
    if "bf16 params" in case:
        model.to(torch.bfloat16)
    if "synced" in case:
        blocks.convert_sync_batchnorm(model, object())
    device = "cuda" if "cuda" in case else "cpu"
    if refused:
        with pytest.raises(TypeError, match="K7"):
            blocks.check_k7_dtypes(model, device)
    else:
        blocks.check_k7_dtypes(model, device)
    # on the CPU, where this model lies, a TrainState takes every case
    TrainState(model, make_optimizer(OptimConfig(), model,
                                     torch.device("cpu")))


# --------------------------------------------- the grid, on the CPU

H100 = 132


def test_bn_layers_and_elements_of_both_cells():
    stf, unet = bn.bn_input_shapes("stflstm"), bn.bn_input_shapes("unet")
    assert len(stf) == 44 and len(unet) == 18
    assert sum(int(np.prod(s)) for s in stf) == 502_562_816
    assert sum(int(np.prod(s)) for s in unet) == 391_774_208
    assert {s[1] for s in stf + unet} == {32, 64, 128, 256, 512, 1024}
    assert {s[2] * s[3] for s in stf + unet} == {
        49, 196, 784, 3136, 12544, 50176}


def _kernel_accepts(n, c, hw, itemsize, cl, t) -> bool:
    """csrc/batch_norm.cu's checks of a tiling (stf_batch_norm)."""
    inner, runs = (1, n * hw) if cl else (hw, n)
    rv = t.group * inner // t.vec
    return (t.vec in (1, 2, 4, 8) and t.vec * itemsize <= 16
            and c % t.group == 0
            and (c % t.vec == 0 and t.group % t.vec == 0 if cl
                 else hw % t.vec == 0)
            and (rv <= bn.THREADS or t.group == 1)
            and rv // t.splits_j >= min(rv, bn.THREADS)
            and 1 <= t.splits_n <= runs and c // t.group <= 65535
            and rv == t.rv)


CELL_SHAPES = sorted(set(bn.bn_input_shapes("stflstm")
                         + bn.bn_input_shapes("unet")))


@pytest.mark.parametrize("channels_last", [False, True],
                         ids=["nchw", "channels_last"])
@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
def test_the_grid_fills_the_card_at_every_bn_shape(itemsize, channels_last):
    for n, c, h, w in CELL_SHAPES:
        t = bn.tiling(n, c, h * w, itemsize, channels_last, 16)
        assert t.blocks >= 2 * H100, (n, c, h, w, t)
        assert _kernel_accepts(n, c, h * w, itemsize, channels_last, t)
        assert t.threads % 32 == 0 and t.threads <= bn.THREADS
        # 16-byte loads wherever the run holds a whole number of them
        span = c if channels_last else h * w
        if span * itemsize % 16 == 0:
            assert t.vec * itemsize == 16
        # small planes read several channels' planes as one run
        if not channels_last and h * w in (49, 196):
            assert t.group >= 4


def _emulate(n, c, hw, cl, t):
    """The kernels' walk (share_of, thread_of, Walk, lane_channel,
    reduce_channels, elems in csrc/batch_norm.cu) in Python: returns how
    often each element of x is read, after checking that every read is
    in the reading lane's channel and that each block's reduction takes
    exactly the threads and lanes of each channel, with the count the
    partial records."""
    inner, runs = (1, n * hw) if cl else (hw, n)
    stride = c if cl else c * hw
    seen = np.zeros(n * c * hw, np.int64)
    splits = t.splits_n * t.splits_j
    for gi in range(c // t.group):
        c0 = gi * t.group
        for s in range(splits):
            sn, sj = divmod(s, t.splits_j)
            n0, n1 = runs * sn // t.splits_n, runs * (sn + 1) // t.splits_n
            j0, j1 = t.rv * sj // t.splits_j, t.rv * (sj + 1) // t.splits_j
            lanes_of = {}   # (thread, k) -> channel, active threads
            reads = {}      # channel -> elements read in this block
            for tid in range(t.threads):
                p, jj = divmod(tid, t.per_run)
                jfirst = j0 + jj
                run, j = n0 + p, jfirst
                if not (p < t.lanes and jfirst < j1 and run < n1):
                    continue
                chans = [c0 + (jfirst * t.vec + k) // inner
                         for k in range(t.vec)]
                for k, ch in enumerate(chans):
                    lanes_of[(tid, k)] = ch
                while run < n1:
                    off = run * stride + c0 * inner + j * t.vec
                    for k in range(t.vec):
                        e = off + k
                        seen[e] += 1
                        assert (e % c if cl else e // hw % c) == chans[k]
                        reads[chans[k]] = reads.get(chans[k], 0) + 1
                    j += t.per_run
                    if j >= j1:
                        j -= j1 - j0
                        run += t.lanes
            for g in range(t.group):
                if cl:
                    taken = {(q * t.per_run + g // t.vec, g % t.vec)
                             for q in range(t.lanes)}
                else:
                    per = inner // t.vec
                    lo = max(g * per - j0, 0)
                    hi = min((g + 1) * per - j0, t.per_run)
                    taken = {(p * t.per_run + jj, k)
                             for p in range(t.lanes) for jj in range(lo, hi)
                             for k in range(t.vec)}
                own = {key for key, ch in lanes_of.items() if ch == c0 + g}
                assert own <= taken
                assert all(lanes_of.get(key, c0 + g) == c0 + g
                           for key in taken)
                elems = max(0, min(j1 * t.vec, (g + 1) * inner)
                            - max(j0 * t.vec, g * inner))
                assert reads.get(c0 + g, 0) == (n1 - n0) * elems
    return seen


@pytest.mark.parametrize("shape,itemsize,cl,align,sms", [
    ((3, 8, 7, 7), 2, False, 16, 4),        # HW = 49: scalars, 4 planes
    ((5, 12, 14, 14), 2, False, 16, 4),     # HW = 196: 8-byte loads
    ((3, 6, 14, 14), 4, False, 16, 2),      # f32, group of 2
    ((2, 3, 64, 80), 2, False, 16, 8),      # a wide plane, split in j
    ((3, 2, 48, 48), 4, False, 4, 8),       # wide, misaligned: scalars
    ((3, 24, 5, 7), 2, True, 16, 4),        # channels-last, 16-byte loads
    ((2, 40, 3, 5), 4, True, 8, 4),         # channels-last, 8 bytes
    ((2, 520, 2, 3), 2, True, 2, 2),        # channels-last, group < C
    ((7, 5, 3, 3), 4, False, 16, 4),        # odd C: a group of one
])
def test_the_walk_reads_every_element_once_in_its_channel(shape, itemsize,
                                                          cl, align, sms):
    n, c, h, w = shape
    t = bn.tiling(n, c, h * w, itemsize, cl, align, sms)
    assert _kernel_accepts(n, c, h * w, itemsize, cl, t)
    assert (_emulate(n, c, h * w, cl, t) == 1).all()


def test_the_emulated_cases_cover_each_branch():
    """The walk test's cases reach each branch of the grid: scalar and
    vector loads, channel groups, a wide plane split in j, channels-last
    with a group of all channels and of some."""
    cases = [bn.tiling(3, 8, 49, 2, False, 16, 4),
             bn.tiling(2, 3, 64 * 80, 2, False, 16, 8),
             bn.tiling(2, 520, 6, 2, True, 2, 2),
             bn.tiling(3, 24, 35, 2, True, 16, 4)]
    assert cases[0].vec == 1 and cases[0].group == 4
    assert cases[1].group == 1 and cases[1].splits_j > 1
    assert cases[1].rv > bn.THREADS
    assert cases[2].group < 520 and cases[2].vec == 1
    assert cases[3].group == 24 and cases[3].vec == 8


# ------------------------- the check the card runs, tried on the CPU

@pytest.mark.parametrize("channels_last", [False, True],
                         ids=["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", SHAPES[:3],
                         ids=lambda s: "x".join(map(str, s)))
def test_twin_excess_holds_the_plain_path(shape, dtype, channels_last):
    """On the CPU batch_norm_forward / _backward are the twins in x's
    dtype: twin_excess must find them within every bound."""
    excess = bn.twin_excess(shape, dtype, channels_last, "cpu")
    assert set(excess) == {"mean", "invstd", "running_mean", "running_var",
                           "y", "grad_bias", "grad_weight", "dx", "rerun",
                           "layout"}
    assert max(excess.values()) <= 0, excess


def _faulty(fault: str):
    """batch_norm_forward / _backward with one fault put in."""
    forward, backward = bn.batch_norm_forward, bn.batch_norm_backward
    calls = []

    def fwd(x, *args):
        y, mean, invstd = forward(x, *args)
        calls.append(1)
        if fault == "mean":
            mean = mean + 0.01
        if fault == "y":
            y = y * 1.01
        if fault == "rerun" and len(calls) == 2:
            y = y + 1e-3
        if fault == "layout":
            y = y.contiguous(memory_format=torch.channels_last)
        return y, mean, invstd

    def bwd(*args):
        dx, dw, db = backward(*args)
        if fault == "grad_weight":
            dw = dw + 0.1
        if fault == "dx":
            dx = dx * 1.01
        return dx, dw, db

    return fwd, bwd


@pytest.mark.parametrize("fault", ["mean", "y", "grad_weight", "dx",
                                   "rerun", "layout"])
def test_twin_excess_finds_a_fault(monkeypatch, fault):
    fwd, bwd = _faulty(fault)
    monkeypatch.setattr(bn, "batch_norm_forward", fwd)
    monkeypatch.setattr(bn, "batch_norm_backward", bwd)
    excess = bn.twin_excess((4, 8, 7, 7), torch.float32, False, "cpu")
    assert excess[fault] > 0, excess


# ------------------------------------------------------------ on the card

chip = pytest.mark.chip


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@chip
@pytest.mark.parametrize("channels_last", [False, True],
                         ids=["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_k7_is_its_twin_at_every_bn_shape(card, dtype, channels_last):
    """bn.twin_excess at every BN shape of both cells: each result within
    its bound of the twins in float64, a rerun bit-identical, y and dx
    in x's layout."""
    for shape in CELL_SHAPES:
        excess = bn.twin_excess(shape, dtype, channels_last, card)
        assert max(excess.values()) <= 0, (shape, excess)


@chip
def test_two_runs_are_bit_identical(card):
    for shape in [(128, 64, 112, 112), (128, 512, 7, 7), (16, 64, 224, 224)]:
        for cl in (False, True):
            x, dy, w, b, stats = bn.twin_case(shape, torch.bfloat16, cl, card)
            outs = []
            for _ in range(2):
                rm, rv = (s.clone() for s in stats)
                y, mean, invstd = bn.batch_norm_forward(x, w, b, rm, rv)
                outs.append((y, mean, invstd, rm, rv,
                             *bn.batch_norm_backward(dy, x, w, mean,
                                                     invstd)))
            for a, c in zip(*outs):
                assert torch.equal(a, c)


@chip
def test_a_captured_graph_replays_its_eager_rerun(card):
    shape = (16, 128, 56, 56)
    x, dy, w, b, stats = bn.twin_case(shape, torch.bfloat16, False,
                                       card)
    w, b = w.requires_grad_(), b.requires_grad_()
    xs = x.clone().requires_grad_()
    rm, rv = (s.clone() for s in stats)

    def step():
        y = bn.batch_norm_train(xs, w, b, rm, rv)
        y.backward(dy)
        return y

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    for v in (xs, w, b):
        v.grad = None
    rm.copy_(stats[0])
    rv.copy_(stats[1])
    launches = bn.batch_norm_forward.launches, bn.batch_norm_backward.launches
    with torch.cuda.graph(graph):
        y_g = step()
    assert (bn.batch_norm_forward.launches - launches[0],
            bn.batch_norm_backward.launches - launches[1]) == (3, 3)
    for v in (xs.grad, w.grad, b.grad, rm, rv):
        v.zero_()
    rm.copy_(stats[0])
    rv.copy_(stats[1])
    graph.replay()
    got = [t.clone() for t in (y_g, xs.grad, w.grad, b.grad, rm, rv)]
    xs.grad = w.grad = b.grad = None
    rm.copy_(stats[0])
    rv.copy_(stats[1])
    y_e = step()
    want = (y_e, xs.grad, w.grad, b.grad, rm, rv)
    for a, c in zip(got, want):
        assert torch.equal(a, c)


@chip
@pytest.mark.parametrize("model,layers", [("stflstm", 44), ("unet", 18)])
def test_a_replayed_step_launches_k7_for_every_bn(card, model, layers):
    from stf_unet_tpu_torch.core.config import DataConfig, OptimConfig
    from stf_unet_tpu_torch.core.prng import augment_generator
    from stf_unet_tpu_torch.data.transforms import TrainAugment
    from stf_unet_tpu_torch.train import loop
    from stf_unet_tpu_torch.train.state import TrainState, make_optimizer

    t_steps, src, crop, bsz = 8, 80, 64, 2
    torch.manual_seed(0)
    cfg = ModelConfig(model=model, num_classes=1, time_steps=t_steps)
    net = create_model(cfg, dtype=torch.bfloat16).to(card)
    state = TrainState(net, make_optimizer(OptimConfig(), net, card))
    assert sum(isinstance(m, TorchBatchNorm) for m in net.modules()) == \
        layers
    aug = TrainAugment(DataConfig(base_size=src, crop_size=crop))
    rng = np.random.default_rng(1)

    def step(i):
        frames = rng.integers(0, 256, (bsz, t_steps, src, src),
                              dtype=np.uint8)
        masks = (rng.random((bsz, src, src)) > 0.8).astype(np.uint8)
        batch = loop.DeviceBatch(torch.from_numpy(frames).to(card),
                                 torch.from_numpy(masks).to(card), None,
                                 np.full((bsz, 2), src, np.int32))
        return loop.train_step(state, aug, batch, augment_generator(0, 0, i),
                               lambda s: 1e-4, cfg.total_classes, card,
                               graph=True)[0]

    for i in range(3):  # warm, capture (which replays), replay
        step(i)
    replays = loop.train_step.replays
    f0, b0 = bn.batch_norm_forward.launches, bn.batch_norm_backward.launches
    losses = [step(i) for i in range(3, 6)]
    torch.cuda.synchronize(card)
    assert loop.train_step.replays - replays == 3
    assert bn.batch_norm_forward.launches - f0 == 3 * 3 * layers
    assert bn.batch_norm_backward.launches - b0 == 3 * 3 * layers
    assert all(np.isfinite(float(v)) for v in losses)
