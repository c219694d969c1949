"""The port's gradient accumulation and EMA (train/state.py,
train/loop.train_step) held against the JAX package's make_train_step +
optax.MultiSteps on the CPU, on the vanilla UNet at base_c = 4 (its
variables drawn from numpy on the tree of jax.eval_shape, as in
tests/test_torch_unet.py), both packages in float64; the checkpoint's EMA
copy picked by the inference restore; the resume mismatch errors.

Tolerances (float64 on both sides, the same arithmetic in another
summation order):
  * parameters, EMA and BN running means and variances after 4
    micro-steps at k = 2 (two AdamW applies): within 1e-6 * max |change
    from the start| of each tensor (its atol floor 1e-12), the per-step
    loss within 1e-6 relative. AdamW runs with eps = 0.1 on both sides: at the default
    1e-8, Adam's m / sqrt(v) turns the round-off of a gradient that
    cancels to ~0 (the conv biases before BN, a mean of two microbatch
    gradients of opposite sign) into differences of up to 6e-5 of an
    update, which says nothing about the accumulation;
  * the running variances move toward the biased batch variance on
    both sides (the port's BatchNorm takes flax's update);
  * the parameters do not move on a micro-step that does not apply
    (bit-equal).
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stf_unet_tpu.core.config import OptimConfig as JaxOptimConfig
from stf_unet_tpu.models.unet import UNet as JaxUNet
from stf_unet_tpu.train.loop import make_train_step as jax_make_train_step
from stf_unet_tpu.train.schedule import \
    warmup_poly_schedule as jax_warmup_poly_schedule
from stf_unet_tpu.train.state import TrainState as JaxTrainState
from stf_unet_tpu.train.state import make_optimizer as jax_make_optimizer
from stf_unet_tpu_torch.cli import train as train_cli
from stf_unet_tpu_torch.cli.common import restore_for_inference
from stf_unet_tpu_torch.core.config import (ModelConfig, OptimConfig,
                                            config_to_json, parse_config)
from stf_unet_tpu_torch.models.registry import create_model
from stf_unet_tpu_torch.train.checkpoint import CheckpointManager
from stf_unet_tpu_torch.train.loop import DeviceBatch, train_step
from stf_unet_tpu_torch.train.schedule import warmup_poly_schedule
from stf_unet_tpu_torch.train.state import (TrainState, ema_copy,
                                            make_optimizer)
from stf_unet_tpu_torch.utils.weights import unet_state_dict_from_jax
from test_torch_unet import seeded_unet_variables

BASE_C = 4
T_STEPS = 8
K = 2
MICRO_STEPS = 4
DECAY = 0.9


class FixedBatches:
    """Stands in for TrainAugment: micro-step i gets batch i."""

    def __init__(self, batches):
        self.batches = list(batches)

    def __call__(self, gen, frames, masks, sizes, pk):
        return self.batches.pop(0)


def _batches(seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(2, T_STEPS, 16, 16, 1)),
             rng.integers(0, 2, (2, 16, 16))) for _ in range(MICRO_STEPS)]


def _sd(params, stats):
    return unet_state_dict_from_jax(jax.device_get(params),
                                    jax.device_get(stats))


@pytest.fixture(scope="module")
def runs():
    """(start, JAX (state, losses), port (state, losses, params after each
    micro-step))."""
    model = JaxUNet(num_classes=2, base_c=BASE_C)
    variables = seeded_unet_variables(model, T_STEPS, 11)
    batches = _batches(12)
    cfg = OptimConfig(warmup=False, eps=0.1)
    jcfg = JaxOptimConfig(warmup=False, eps=0.1)
    with jax.enable_x64(True):
        params, stats = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64),
            (variables["params"], variables["batch_stats"]))
        schedule = jax_warmup_poly_schedule(jcfg.lr, 2, 3, warmup=False)
        optim = jax_make_optimizer(jcfg, schedule, grad_accum=K)
        state = JaxTrainState(
            params=params, batch_stats=stats, opt_state=optim.init(params),
            step=jnp.zeros((), jnp.int32),
            ema_params=jax.tree_util.tree_map(jnp.copy, params))
        step = jax_make_train_step(model, optim, schedule, 2,
                                   ema_decay=DECAY, ema_every_k=K)
        jlosses = []
        for images, targets in batches:
            state, loss, _ = step(state, jnp.asarray(images),
                                  jnp.asarray(targets, jnp.int32))
            jlosses.append(float(loss))
        jstate = jax.device_get(state)

    start = _sd(variables["params"], variables["batch_stats"])
    port = create_model(ModelConfig(model="unet", base_c=BASE_C),
                        dtype=torch.float64).to(torch.float64)
    port.load_state_dict(start, strict=True)
    pstate = TrainState(port, make_optimizer(cfg, port, torch.device("cpu")),
                        grad_accum=K, ema=ema_copy(port), ema_decay=DECAY)
    augment = FixedBatches((torch.from_numpy(i), torch.from_numpy(t))
                           for i, t in batches)
    dummy = DeviceBatch(torch.zeros(1), torch.zeros(1), None, None)
    sched = warmup_poly_schedule(cfg.lr, 2, 3, warmup=False)
    losses, trail = [], []
    for _ in range(MICRO_STEPS):
        loss, _ = train_step(pstate, augment, dummy, None, sched, 2,
                             torch.device("cpu"))
        losses.append(loss.item())
        trail.append({n: p.detach().clone()
                      for n, p in port.named_parameters()})
    return start, (jstate, jlosses), (pstate, losses, trail)


def _close(got, want, start, name):
    delta = np.abs(want - start).max()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=max(1e-6 * delta, 1e-12), err_msg=name)


def test_accumulated_apply_matches_multisteps(runs):
    start, (jstate, jlosses), (pstate, losses, trail) = runs
    np.testing.assert_allclose(losses, jlosses, rtol=1e-6)
    want = _sd(jstate.params, jstate.batch_stats)
    got = pstate.model.state_dict()
    assert pstate.step == MICRO_STEPS and int(jstate.step) == MICRO_STEPS
    moved = 0
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        _close(got[name].numpy(), w.double().numpy(),
               start[name].double().numpy(), name)
        moved += bool((w != start[name]).any())
    assert moved > len(want) // 2


def test_no_apply_between_window_ends(runs):
    start, _, (_, _, trail) = runs
    for n, p in trail[0].items():  # micro-step 1 of 2: nothing applied
        assert torch.equal(p, start[n].double()), n
    assert any(not torch.equal(trail[1][n], trail[0][n]) for n in trail[0])
    for n, p in trail[2].items():
        assert torch.equal(p, trail[1][n]), n


def test_ema_ramp_matches_jax(runs):
    start, (jstate, _), (pstate, _, _) = runs
    want = _sd(jstate.ema_params, jstate.batch_stats)
    for name, e in pstate.ema.items():
        _close(e.numpy(), want[name].double().numpy(),
               start[name].double().numpy(), name)
    # the ramp, its decay in float32 as in JAX: apply 0 keeps 0.1 of the
    # start, apply 1 (2 / 11) of that
    p1 = runs[2][2][1]
    name = "out_conv.weight"
    f32 = np.float32
    d0, d1 = f32(0.1), min(f32(DECAY), f32(2) / f32(11))
    e0 = float(d0) * start[name].double() + float(f32(1) - d0) * p1[name]
    e1 = float(d1) * e0 + float(f32(1) - d1) * runs[2][2][3][name]
    np.testing.assert_allclose(pstate.ema[name].numpy(), e1.numpy(),
                               rtol=0, atol=1e-15)


def test_restore_for_inference_picks_the_ema_copy(runs, tmp_path, capsys):
    _, _, (pstate, _, _) = runs
    state = TrainState(pstate.model.float(), pstate.optimizer,
                       step=pstate.step, grad_accum=K,
                       ema={k: v.float() for k, v in pstate.ema.items()},
                       ema_decay=DECAY)
    ckpt = CheckpointManager(str(tmp_path), "unet")
    path = ckpt.save("best", state, epoch=0, best_dice=0.5)
    model, _, _, _ = restore_for_inference("unet", path, dtype="f32",
                                           device="cpu")
    assert "using EMA weights" in capsys.readouterr().out
    sd = model.state_dict()
    live = state.model.state_dict()
    for name, t in sd.items():
        want = state.ema.get(name, live[name])
        assert torch.equal(t, want), name
    assert not all(torch.equal(state.ema[n], live[n]) for n in state.ema)


@pytest.mark.parametrize("saved,now,match", [
    (["--grad-accum", "2"], (1, False), "--grad-accum 2"),
    ([], (4, False), "--grad-accum 1"),
    (["--optim-ema-decay", "0.99"], (1, False), "--optim-ema-decay on"),
    ([], (1, True), "--optim-ema-decay off"),
])
def test_resume_mismatch_errors(saved, now, match):
    meta = config_to_json(parse_config(saved))
    with pytest.raises(ValueError, match=match):
        train_cli._check_resume(meta, *now)
    assert json.loads(meta)["grad_accum"] in (1, 2)
    train_cli._check_resume(meta, int(json.loads(meta)["grad_accum"]),
                            "--optim-ema-decay" in saved)
