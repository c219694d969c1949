"""The trainer's replayed step (train/step_graph.py) and its step boundary
without a stream drain (train/loop.py, data/transforms.py).

On the CPU:
  * the engagement rule, a function of the state and the batch, case by
    case: the CPU, a data-parallel group, an accumulation window, the
    NaN check, anomaly mode, a new signature, a ragged batch, a replaced
    optimizer state;
  * train_one_epoch reads each step's loss once and in order, as the
    `.item()` one step late did, the epoch's last read and one-step
    calls included, and asks train_step for the graph;
  * TrainAugment's draws and outputs are bit-equal to the pageable
    copies it made before (`_old_*` below), its generator left where
    they left it;
  * a capture's bookkeeping against a stub graph: the gradients unset,
    AdamW's groups capturable and reading the lr tensor only while it
    lasts, and the kernels' launch counters counting each replay as one
    eager step.

On a card (marked `chip`: `python -m pytest tests/test_torch_step_graph.py
--noconftest -m chip`; skipped without CUDA), at a small shape for the
STF-LSTM-UNet (with and without remat) and the UNet: the graph path
against the eager path over 6 steps from one seeded state, no
synchronizing call in the steps after the capture (sync debug mode
"error"), the step counters, the pixel-LSTM kernels' launches per
replay, and a checkpoint taken after graph steps resumed eagerly and
the reverse.
"""

import contextlib
import io
import types

import numpy as np
import pytest
import torch

from stf_unet_tpu_torch import ops
from stf_unet_tpu_torch.core.config import DataConfig, ModelConfig, OptimConfig
from stf_unet_tpu_torch.core.prng import augment_generator
from stf_unet_tpu_torch.data import transforms
from stf_unet_tpu_torch.data.loader import Batch
from stf_unet_tpu_torch.data.transforms import TrainAugment
from stf_unet_tpu_torch.ops.kernels.warp import warp_plain
from stf_unet_tpu_torch.train import loop, step_graph
from stf_unet_tpu_torch.train.state import TrainState, make_optimizer

CUDA = torch.device("cuda")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small CPU steps: the test
    workers share the host's cores, and torch's default of a thread per
    core makes each tiny op of one worker wait on the others'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------- the rule

def _state(**kw):
    fields = dict(group=None, grad_accum=1, nan_check=None, step_graph=None,
                  last_signature=None,
                  optimizer=types.SimpleNamespace(state={}))
    fields.update(kw)
    return types.SimpleNamespace(**fields)


def _sig(bsz=4, planes=8, crop=32, loss_weight=None):
    images = torch.zeros((bsz, planes, crop, crop, 1))
    targets = torch.zeros((bsz, crop, crop), dtype=torch.int64)
    return step_graph.signature(images, targets, 2, loss_weight)


def _held(state, sig):
    return types.SimpleNamespace(signature=sig,
                                 opt_state=state.optimizer.state)


@pytest.mark.parametrize("case", ["cpu", "group", "grad_accum", "nan_check",
                                  "anomaly"])
def test_the_eager_cases(case):
    sig = _sig()
    state = _state(last_signature=sig)
    state.step_graph = _held(state, sig)  # would replay on CUDA
    device, anomaly = CUDA, False
    if case == "cpu":
        device = torch.device("cpu")
    elif case == "group":
        state.group = object()
    elif case == "grad_accum":
        state.grad_accum = 2
    elif case == "nan_check":
        state.nan_check = object()
    else:
        anomaly = True
    with torch.autograd.set_detect_anomaly(anomaly):
        assert step_graph.mode(state, device, sig) == "eager"
    assert step_graph.mode(_state(), torch.device("cpu"), sig) == "eager"


def test_a_new_signature_warms_then_captures_then_replays():
    state, sig = _state(), _sig()
    assert step_graph.mode(state, CUDA, sig) == "warm"
    state.last_signature = sig
    assert step_graph.mode(state, CUDA, sig) == "capture"
    state.step_graph = _held(state, sig)
    assert step_graph.mode(state, CUDA, sig) == "replay"
    # the PK maps' planes, another crop, other loss weights: new signatures
    for other in (_sig(planes=11), _sig(crop=64),
                  _sig(loss_weight=torch.ones(2))):
        assert other != sig
        assert step_graph.mode(state, CUDA, other) == "warm"


def test_a_ragged_batch_runs_warm_beside_the_graph():
    state, sig = _state(), _sig()
    state.last_signature = sig
    state.step_graph = _held(state, sig)
    ragged = _sig(bsz=3)
    # every epoch's last batch: warm, and the full batches still replay
    for _ in range(3):
        assert step_graph.mode(state, CUDA, ragged) == "warm"
        state.last_signature = ragged
        assert step_graph.mode(state, CUDA, sig) == "replay"
        state.last_signature = sig
    # a ragged batch that follows one of its own is captured in its turn
    state.last_signature = ragged
    assert step_graph.mode(state, CUDA, ragged) == "capture"


def test_a_replaced_optimizer_state_is_captured_again():
    state, sig = _state(), _sig()
    state.last_signature = sig
    state.step_graph = _held(state, sig)
    state.optimizer.state = {}  # load_state_dict's new state
    assert step_graph.mode(state, CUDA, sig) == "capture"


# ------------------------------------------------------------ the loss read

class _Loader:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def epoch(self, epoch_num=0, skip_batches=0):
        for _ in range(skip_batches, self.n):
            yield Batch(frames=np.zeros((1, 1, 2, 2), np.uint8),
                        masks=np.zeros((1, 2, 2), np.uint8),
                        sizes=np.full((1, 2), 2, np.int32))


def test_each_loss_is_read_once_and_in_order(monkeypatch):
    losses = [1.5, 0.25, 2.0, 0.125, 3.0]
    events, graphs = [], []

    def fake_step(state, augment, batch, gen, schedule, num_classes, device,
                  loss_weight=None, *, graph=False):
        graphs.append(graph)
        events.append(("step", state.step))
        state.step += 1
        return torch.tensor(losses[state.step - 1]), 0.01 * state.step

    read = loop._read_loss

    def recorded(logger, pending):
        value = read(logger, pending)
        events.append(("read", pending.step[1], value))
        return value

    monkeypatch.setattr(loop, "train_step", fake_step)
    monkeypatch.setattr(loop, "_read_loss", recorded)
    state = types.SimpleNamespace(step=0)
    cpu = torch.device("cpu")

    def epoch(start, stop=None, prefetch=0):
        return loop.train_one_epoch(state, _Loader(len(losses)), None, 0, 0,
                                    None, 2, cpu, print_freq=100,
                                    device_prefetch=prefetch,
                                    start_step=start, should_stop=stop)

    mean, lr, reached = epoch(0)
    # step s's loss is read once step s + 1 is taken; the last at the end
    want = [("step", 0)]
    for i in range(1, len(losses)):
        want += [("step", i), ("read", i - 1, losses[i - 1])]
    want.append(("read", len(losses) - 1, losses[-1]))
    assert events == want
    assert reached == len(losses) and graphs == [True] * len(losses)
    assert mean == pytest.approx(np.mean(losses)) and lr == 0.05
    # one-step calls, as the benchmark's set-up makes them
    state.step, events[:] = 0, []
    for i in range(3):
        mean, _, reached = epoch(i, stop=lambda: True, prefetch=1)
        assert (mean, reached) == (losses[i], i + 1)
    assert events == [e for i in range(3)
                      for e in (("step", i), ("read", i, losses[i]))]


def test_a_cpu_loss_is_read_as_it_is():
    loss = torch.tensor(0.75)
    pending = loop.LossRead(loss, 0.5, (1, 2))
    assert pending.host is loss and pending.ready is None
    logger = loop.MetricLogger()
    assert loop._read_loss(logger, pending) == 0.75
    assert logger.meters["loss"].value == 0.75
    assert logger.meters["lr"].value == 0.5


# ------------------------------------------------------------ the draws

def _old_grids(aug, gen, sizes, device, planes=1):
    """TrainAugment.grids as it was, each draw a pageable .to(device)."""
    sizes = torch.as_tensor(sizes).cpu()
    if planes > 1:
        sizes = sizes.repeat_interleave(planes, dim=0)
    params = [p.to(device).view(-1, 1, 1) for p in aug._params(gen, sizes)]
    line = torch.arange(aug.crop, dtype=torch.float32, device=device)
    gy, gx = transforms._build_affine(*params)(line.view(-1, 1),
                                               line.view(1, -1))
    if aug.elastic:
        grid = aug.cfg.elastic_grid
        first, total = aug._rows(sizes.shape[0])
        mine = slice(first, first + sizes.shape[0])
        field = torch.randn((total, 2, grid, grid),
                            generator=gen)[mine] * aug.cfg.elastic_alpha
        on = (torch.rand((total,), generator=gen)[mine]
              < aug.cfg.elastic_prob).to(torch.float32)
        dy, dx = transforms.elastic_offsets(field.to(device), on.to(device),
                                            aug.crop)
        gy, gx = gy + dy, gx + dx
    return gy, gx


def _old_call(aug, gen, frames, masks, sizes):
    """TrainAugment.__call__ (shared-frame mode, no PK maps) as it was."""
    bsz, t = frames.shape[:2]
    valid = torch.as_tensor(sizes).to(frames.device, torch.float32)
    gy, gx = _old_grids(aug, gen, sizes, frames.device)
    stacked = torch.cat([frames, masks.unsqueeze(1)], dim=1)
    bil, near = warp_plain(stacked, gy, gx, valid, alpha=aug.alpha,
                           beta=aug.beta)
    if aug.photometric:
        first, total = aug._rows(bsz)
        u = torch.rand((3, total), generator=gen)[:, first:first + bsz]
        k = torch.tensor([aug.cfg.brightness, aug.cfg.contrast,
                          aug.cfg.gamma_jitter]).view(3, 1)
        noise_gen = None
        if aug.cfg.noise_std > 0.0:
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
            noise_gen = torch.Generator().manual_seed(seed)
        v = transforms.photometric(bil[:, :t], 1.0 - k + 2.0 * k * u,
                                   aug.cfg, noise_gen, rows=aug._rows(bsz))
        bil = (torch.cat([v, bil[:, t:]], dim=1) - aug.cfg.mean) \
            / aug.cfg.std
    return bil.unsqueeze(-1), near.to(torch.int64)


EXTRAS = {
    "plain": {},
    "extras": dict(elastic_alpha=3.0, elastic_prob=0.7, brightness=0.2,
                   contrast=0.2, gamma_jitter=0.2, noise_std=0.05,
                   rotate_prob=0.6),
}


@pytest.mark.parametrize("extras", sorted(EXTRAS))
def test_the_draws_are_bit_equal_to_the_pageable_copies(extras):
    cfg = DataConfig(base_size=40, crop_size=32, **EXTRAS[extras])
    aug = TrainAugment(cfg)
    rng = np.random.default_rng(3)
    frames = torch.from_numpy(rng.integers(0, 256, (3, 4, 40, 40),
                                           dtype=np.uint8))
    masks = torch.from_numpy((rng.random((3, 40, 40)) > 0.6)
                             .astype(np.uint8))
    sizes = np.array([[40, 40], [36, 40], [40, 33]], np.int32)
    cpu = torch.device("cpu")
    for planes in (1, 3):
        new_gen, old_gen = (augment_generator(9, 1, planes)
                            for _ in range(2))
        new = aug.grids(new_gen, sizes, cpu, planes=planes)
        old = _old_grids(aug, old_gen, sizes, cpu, planes=planes)
        for a, b in zip(new, old):
            assert torch.equal(a, b)
        assert torch.equal(new_gen.get_state(), old_gen.get_state())
    new_gen, old_gen = (augment_generator(9, 2, 0) for _ in range(2))
    new = aug(new_gen, frames, masks, sizes)
    old = _old_call(aug, old_gen, frames, masks, sizes)
    for a, b in zip(new, old):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(new_gen.get_state(), old_gen.get_state())


def test_to_device_keeps_a_cpu_tensor():
    t = torch.arange(4.0)
    assert transforms._to_device(t, "cpu") is t


# ------------------------------------------------- a capture's bookkeeping

def _kernel(name):
    def k():
        k.launches += 1
    k.__name__, k.launches = name, 0
    return k


class _StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_a_capture_against_a_stub_graph(monkeypatch):
    fwd, bwd, other = _kernel("fwd"), _kernel("bwd"), _kernel("other")
    fwd.launches, bwd.launches, other.launches = 10, 20, 30
    monkeypatch.setattr(ops, "counted_kernels", lambda: [fwd, bwd, other])
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(step_graph, "side_stream", lambda device: None)
    captured = []
    monkeypatch.setattr(torch.cuda, "graph", lambda graph, stream=None,
                        capture_error_mode="global": (
                            captured.append(capture_error_mode)
                            or contextlib.nullcontext()))
    model = torch.nn.Linear(3, 2)
    opt = make_optimizer(OptimConfig(), model, torch.device("cpu"))
    x, y = torch.ones(4, 3), torch.zeros(4, 2, dtype=torch.int64)
    model(x).sum().backward()
    assert all(p.grad is not None for p in model.parameters())
    sig = step_graph.signature(x, y, 2, None)
    held = step_graph.StepGraph(sig, x, y, None, opt.state)
    seen = {}

    def step(images, targets):
        # the graph's buffers, the gradients unset, the lr a tensor
        seen["inputs"] = (images is held.images, targets is held.targets)
        seen["grads"] = [p.grad for p in model.parameters()]
        seen["lr"] = [g["lr"] for g in opt.param_groups]
        seen["capturable"] = [g["capturable"] for g in opt.param_groups]
        fwd()
        fwd()
        bwd()
        return (images.sum() * 0.5).requires_grad_()

    held.capture(opt, step, 0.003)
    assert captured == ["thread_local"]
    assert seen["inputs"] == (True, True)
    assert seen["grads"] == [None, None]
    assert all(lr is held.lr for lr in seen["lr"])
    assert seen["capturable"] == [True]
    assert [g["lr"] for g in opt.param_groups] == [0.003]
    # nothing ran at the capture: the counters are where they were
    assert (fwd.launches, bwd.launches, other.launches) == (10, 20, 30)
    losses = []
    for i in range(4):
        batch = torch.full((4, 3), float(i))
        losses.append(held.replay(batch, y, 0.001 * i))
        assert held.lr.item() == pytest.approx(0.001 * i)
        assert torch.equal(held.images, batch)
    assert held.graph.replays == 4
    # each replay counts the eager step's launches
    assert (fwd.launches, bwd.launches, other.launches) == (18, 24, 30)
    # every replay returns a copy, not the graph's own loss
    assert all(loss is not held.loss for loss in losses)
    assert len({id(loss) for loss in losses}) == 4


def test_the_counters_are_the_port_kernels():
    names = {k.__name__ for k in ops.counted_kernels()}
    assert {"lstm_last_x", "lstm_last_x_bwd", "warp", "batch_norm_forward",
            "batch_norm_backward", "window_attention"} <= names
    assert all(isinstance(k.launches, int) for k in ops.counted_kernels())


# ------------------------------------------------------------ on the card

chip = pytest.mark.chip


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


T, SRC, CROP, B = 8, 80, 64, 2


def _card_state(model, device, remat=False, seed=0):
    from stf_unet_tpu_torch.models.registry import create_model

    torch.manual_seed(seed)
    cfg = ModelConfig(model=model, num_classes=1, time_steps=T, remat=remat)
    net = create_model(cfg, dtype=torch.bfloat16).to(device)
    return cfg, TrainState(net, make_optimizer(OptimConfig(), net, device))


def _batches(device, n, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        frames = rng.integers(0, 256, (B, T, SRC, SRC), dtype=np.uint8)
        masks = (rng.random((B, SRC, SRC)) > 0.8).astype(np.uint8)
        out.append(loop.DeviceBatch(torch.from_numpy(frames).to(device),
                                    torch.from_numpy(masks).to(device),
                                    None, np.full((B, 2), SRC, np.int32)))
    return out


def _lr(step):
    """A schedule whose every lr is exact in float32, the precision a
    replay reads it in: the two paths then apply the same lr."""
    return 2.0 ** -10 * (1.0 - step / 64)


def _run(state, cfg, batches, device, graph, first=0):
    aug = TrainAugment(DataConfig(base_size=SRC, crop_size=CROP))
    losses = []
    for i, batch in enumerate(batches, start=first):
        loss, _ = loop.train_step(state, aug, batch,
                                  augment_generator(0, 0, i), _lr,
                                  cfg.total_classes, device, graph=graph)
        losses.append(loss)
    torch.cuda.synchronize(device)
    return [float(x) for x in losses]


def _floats(state):
    return {k: v.detach().float().clone()
            for k, v in state.model.state_dict().items()
            if v.is_floating_point()}


CARD_MODELS = [("stflstm", False), ("stflstm", True), ("unet", False)]


@pytest.fixture
def deterministic_cudnn():
    """cuDNN's deterministic algorithms for both paths, so that the
    UNet's steps repeat bit for bit (its graph and eager paths read
    equal on an H100). AdamW turns a rounding left to chance into whole
    steps in the leaves whose gradient is mostly cancellation."""
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    yield
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        flags


@chip
@pytest.mark.parametrize("model,remat", CARD_MODELS)
def test_the_graph_path_is_the_eager_path(card, deterministic_cudnn, model,
                                          remat):
    """Six steps from one seeded state, graph path against eager path:
    the losses to within bf16's rounding (2^-8) of the first, each leaf
    to within 2^-8 of its change over the steps. An eager rerun is the
    control for the sums the card leaves in an order of chance: where
    two eager runs differ (the STF stem conv's weight by 28 % of its
    change on an H100, the STF losses by up to 0.4 % at the sixth step),
    the graph path may differ from the first by three times as much."""
    batches = _batches(card, 6)
    cfg, eager = _card_state(model, card, remat)
    start = _floats(eager)
    before = {k: getattr(loop.train_step, k)
              for k in ("eager_steps", "captures", "replays")}
    lost_e = _run(eager, cfg, batches, card, graph=False)
    _, again = _card_state(model, card, remat)
    lost_a = _run(again, cfg, batches, card, graph=False)
    _, graphed = _card_state(model, card, remat)
    lost_g = _run(graphed, cfg, batches, card, graph=True)
    counts = {k: getattr(loop.train_step, k) - before[k] for k in before}
    # 12 eager, then a warm step, the capture (which replays), 4 replays
    assert counts == {"eager_steps": 13, "captures": 1, "replays": 5}
    assert graphed.step == eager.step == 6
    own = np.abs(np.subtract(lost_a, lost_e)).max()
    gap = np.abs(np.subtract(lost_g, lost_e)).max()
    assert gap <= 3 * own + 2 ** -8 * lost_e[0], (lost_g, lost_e, lost_a)
    e, a, g = _floats(eager), _floats(again), _floats(graphed)
    worst = []
    for k in e:
        moved = (e[k] - start[k]).norm().item()
        own = (a[k] - e[k]).norm().item()
        gap = (g[k] - e[k]).norm().item()
        worst.append((gap / max(moved, 1e-12), k, gap, own, moved))
        assert gap <= 3 * own + 2 ** -8 * moved + 1e-6, (k, gap, own, moved)
    print("widest graph/eager gap over the change:", max(worst))


@chip
@pytest.mark.parametrize("model", ["stflstm", "unet"])
def test_no_step_after_the_capture_synchronizes(card, model):
    from stf_unet_tpu_torch.ops.kernels.lstm_last_x import lstm_last_x
    from stf_unet_tpu_torch.ops.kernels.lstm_last_x_bwd import \
        lstm_last_x_bwd

    batches = _batches(card, 6)
    cfg, state = _card_state(model, card)
    _run(state, cfg, batches[:1], card, graph=False)
    eager_launches = (lstm_last_x.launches, lstm_last_x_bwd.launches)
    _run(state, cfg, batches[1:3], card, graph=True, first=1)  # warm, capture
    n = (lstm_last_x.launches - eager_launches[0],
         lstm_last_x_bwd.launches - eager_launches[1])
    replays = loop.train_step.replays
    aug = TrainAugment(DataConfig(base_size=SRC, crop_size=CROP))
    f0, b0 = lstm_last_x.launches, lstm_last_x_bwd.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        reads = []
        for i, batch in enumerate(batches[3:], start=3):
            loss, lr = loop.train_step(state, aug, batch,
                                       augment_generator(0, 0, i),
                                       _lr, cfg.total_classes,
                                       card, graph=True)
            reads.append(loop.LossRead(loss, lr, (0, i)))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    values = [loop._read_loss(loop.MetricLogger(), r) for r in reads]
    assert all(np.isfinite(values))
    assert loop.train_step.replays - replays == 3
    # a replay launches what an eager step launches (two steps above:
    # the warm one and the capture's replay)
    per_step = (n[0] // 2, n[1] // 2)
    assert (lstm_last_x.launches - f0, lstm_last_x_bwd.launches - b0) == \
        (3 * per_step[0], 3 * per_step[1])
    if model == "stflstm":
        assert per_step[0] > 0 and per_step[1] > 0
        assert n == (2 * per_step[0], 2 * per_step[1])


def _saved(state):
    buf = io.BytesIO()
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step}, buf)
    buf.seek(0)
    return buf


def _restored(model, device, buf):
    cfg, state = _card_state(model, device, seed=5)
    ckpt = torch.load(buf, map_location=device, weights_only=False)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = ckpt["step"]
    return cfg, state


@chip
@pytest.mark.parametrize("model", ["stflstm", "unet"])
def test_a_checkpoint_crosses_between_the_paths(card, model):
    batches = _batches(card, 5)
    cfg, graphed = _card_state(model, card)
    _run(graphed, cfg, batches[:3], card, graph=True)  # warm, capture, replay
    buf = _saved(graphed)
    ahead = _run(graphed, cfg, batches[3:], card, graph=True, first=3)
    _, resumed = _restored(model, card, buf)
    eager = _run(resumed, cfg, batches[3:], card, graph=False, first=3)
    np.testing.assert_allclose(eager, ahead, rtol=2 ** -8)
    # and the reverse: eager steps, then the graph path from their state
    cfg, plain = _card_state(model, card)
    _run(plain, cfg, batches[:3], card, graph=False)
    buf = _saved(plain)
    ahead = _run(plain, cfg, batches[3:], card, graph=False, first=3)
    _, resumed = _restored(model, card, buf)
    replays = loop.train_step.replays
    graphed = _run(resumed, cfg, batches[3:], card, graph=True, first=3)
    assert loop.train_step.replays - replays == 1  # warm, then the capture
    np.testing.assert_allclose(graphed, ahead, rtol=2 ** -8)
