"""The trainer's diagnostics in the port (models/stf_lstm_unet.py remat,
utils/profiling.py trace / annotate / nan_check, cli/common's matmul
precision, core/config's flags) against the JAX package on the CPU.

Tolerances:
  * remat against no remat in the port, one f32 step: the recompute runs
    the same ops on the same inputs, so loss, gradients and the BN
    buffers after the step are bit-equal;
  * the port's remat STF against the JAX package's remat=True STF, one
    train-mode forward at T=2, 32^2 in float64 (the logits come out in
    float32 on both sides): logits within 1e-5 of max |logit| and the BN
    running statistics after the port's forward + backward within 1e-5
    of each tensor's max: updated once, as flax's remat updates
    batch_stats.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from stf_unet_tpu.core import config as jax_config
from stf_unet_tpu.models.stf_lstm_unet import STFLSTMUNet as JaxSTFLSTMUNet
from stf_unet_tpu_torch.cli import common
from stf_unet_tpu_torch.cli import train as train_cli
from stf_unet_tpu_torch.core.config import (MATMUL_PRECISIONS, ModelConfig,
                                            parse_config)
from stf_unet_tpu_torch.data.synthetic import make_synthetic_breadm
from stf_unet_tpu_torch.losses.criterion import criterion
from stf_unet_tpu_torch.models.blocks import convert_sync_batchnorm
from stf_unet_tpu_torch.models.registry import create_model
from stf_unet_tpu_torch.ops.kernels.lstm_last_x import lstm_last_x
from stf_unet_tpu_torch.train.loop import loss_and_grads
from stf_unet_tpu_torch.utils import profiling
from stf_unet_tpu_torch.utils.weights import stflstm_state_dict_from_jax

T_STEPS = 2
SIZE = 32
REL_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small CPU steps: the test
    workers share the host's cores, and torch's default of a thread per
    core makes each tiny op of one worker wait on the others'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, pk=False, b=2):
    rng = np.random.default_rng(seed)
    t = T_STEPS + (3 if pk else 0)
    x = torch.from_numpy(rng.normal(size=(b, t, SIZE, SIZE, 1))
                         .astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 2, (b, SIZE, SIZE)))
    return x, y


def _step(remat, pk, seed=0, synced=False):
    torch.manual_seed(seed)
    model = create_model(ModelConfig(time_steps=T_STEPS, use_pk_maps=pk,
                                     remat=remat))
    if synced:  # the data-parallel BN's path (one process: no all-reduce)
        convert_sync_batchnorm(model, object())
    x, y = _inputs(seed + 1, pk)
    loss = loss_and_grads(model, x, y, num_classes=2)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return loss.detach(), grads, dict(model.named_buffers())


@pytest.mark.parametrize("pk,synced", [(False, False), (True, False),
                                       (False, True)])
def test_remat_step_equals_plain_step(pk, synced):
    loss0, grads0, bufs0 = _step(False, pk, synced=synced)
    loss1, grads1, bufs1 = _step(True, pk, synced=synced)
    assert torch.equal(loss1, loss0)
    assert grads1.keys() == grads0.keys()
    for n in grads0:
        assert torch.equal(grads1[n], grads0[n]), n
    # the double-update trap: the recompute moves no running statistic
    for n in bufs0:
        assert torch.equal(bufs1[n], bufs0[n]), n


def test_remat_recomputes_the_encoder_once():
    """The encoder's 36 BNs run again in the backward (and only they)."""
    from stf_unet_tpu_torch.models.blocks import TorchBatchNorm

    counts = {}
    for remat in (False, True):
        torch.manual_seed(0)
        model = create_model(ModelConfig(time_steps=T_STEPS, remat=remat))
        calls = []
        for m in model.modules():
            if isinstance(m, TorchBatchNorm):
                m.register_forward_hook(lambda *a: calls.append(1))
        x, y = _inputs(1)
        loss_and_grads(model, x, y, num_classes=2)
        counts[remat] = len(calls)
    assert counts[True] - counts[False] == 36
    # eval mode and no_grad take no checkpoint
    model.eval()
    with torch.no_grad():
        model(_inputs(1)[0])


@pytest.fixture(scope="module")
def jax_remat():
    model = JaxSTFLSTMUNet(num_classes=2, time_steps=T_STEPS, remat=True)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.key(0), jnp.zeros((1, T_STEPS, SIZE, SIZE, 1)),
        train=False))
    rng = np.random.default_rng(3)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            a = rng.normal(0.0, 1.0 / np.sqrt(np.prod(leaf.shape[:-1])),
                           leaf.shape)
        elif name in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, leaf.shape)
        else:
            a = rng.normal(0.0, 0.1, leaf.shape)
        return jnp.asarray(a, leaf.dtype)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    return model, variables


def test_remat_forward_matches_jax_remat(jax_remat):
    """In float64 on both sides: train-mode BN over the folded B*T = 4
    frames normalizes layer4's 1 x 1 maps over 4 values, which lifts f32
    summation-order noise to ~1e-4 of the logits with or without remat."""
    jmodel, variables = jax_remat
    x, y = _inputs(5)
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     variables)
        fwd = jax.jit(lambda v, xx: jmodel.apply(v, xx, train=True,
                                                 mutable=["batch_stats"]))
        out, updates = fwd(v64, jnp.asarray(x.numpy(), jnp.float64))
        want = np.asarray(out["out"])
        want_sd = stflstm_state_dict_from_jax(
            jax.device_get(variables["params"]),
            jax.device_get(updates["batch_stats"]))

    model = create_model(ModelConfig(time_steps=T_STEPS, remat=True),
                         dtype=torch.float64)
    model.load_state_dict(stflstm_state_dict_from_jax(
        jax.device_get(variables["params"]),
        jax.device_get(variables["batch_stats"])), strict=True)
    model.double().train()
    logits = model(x.double())["out"]
    criterion({"out": logits}, y, num_classes=2).backward()
    got = logits.detach().numpy()
    assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max()
    bufs = dict(model.named_buffers())
    stats = [k for k in want_sd if k.endswith(("running_mean",
                                               "running_var"))]
    assert len(stats) == 2 * 44  # the encoder's 36 BNs and 8 more
    for k in stats:
        w = np.asarray(want_sd[k], np.float64)
        g = bufs[k].numpy()
        assert np.abs(g - w).max() <= REL_TOL * max(np.abs(w).max(), 1e-6), k


def test_nan_check_raises_in_the_forward():
    torch.manual_seed(0)
    model = create_model(ModelConfig(time_steps=T_STEPS))
    check = profiling.NanCheck(model)
    x, y = _inputs(2)
    loss_and_grads(model, x, y, num_classes=2, nan_check=check)  # clean
    with torch.no_grad():
        model.layer2[0].conv1.weight[0, 0, 0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="layer2.0.conv1"):
        loss_and_grads(model, x, y, num_classes=2, nan_check=check)
    with pytest.raises(FloatingPointError, match="input"):
        model(torch.full_like(x, float("nan")))
    check.remove()
    model(x)  # the hooks are gone
    # an inf passes, as with jax_debug_nans
    ident = nn.Sequential(nn.Identity())
    profiling.NanCheck(ident)
    ident(torch.tensor([float("inf")]))


def test_nan_check_raises_in_the_backward():
    """A finite forward whose backward makes a NaN (0 * inf), and K1b's
    plain twin (LstmLastX's backward) handed a NaN gradient."""
    w = nn.Parameter(torch.zeros(3))
    check = profiling.NanCheck(nn.Identity())
    with pytest.raises(FloatingPointError, match="backward"):
        with check.backward_checked():
            (torch.sqrt(torch.relu(w) * 0.0)).sum().backward()
    rng = np.random.default_rng(0)
    c = 4
    x = torch.from_numpy(rng.normal(size=(2, 6, c)).astype(np.float32))
    w_ih, w_hh = (nn.Parameter(torch.from_numpy(
        rng.normal(0, 0.3, (c, 4 * c)).astype(np.float32))) for _ in "ab")
    b = nn.Parameter(torch.zeros(4 * c))
    with pytest.raises(FloatingPointError, match="LstmLastX"):
        with check.backward_checked():
            h = lstm_last_x(x, w_ih, w_hh, b)
            h.backward(torch.full_like(h, float("nan")))


@pytest.mark.parametrize("value", sorted(MATMUL_PRECISIONS) + ["bfloat16"])
def test_matmul_precision_mapping(value):
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        if value not in MATMUL_PRECISIONS:
            with pytest.raises(ValueError):
                common.set_precision_policy(value)
            with pytest.raises(SystemExit):
                parse_config(["--matmul-precision", value])
            return
        tf32 = value in ("high", "tensorfloat32")
        assert common.set_precision_policy(value) is tf32
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
        assert torch.backends.cudnn.allow_tf32 is tf32
        assert parse_config(["--matmul-precision", value]).matmul_precision \
            == value
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]


def test_trace_writes_a_parseable_file(tmp_path):
    with profiling.trace(str(tmp_path), rank=3) as path:
        with profiling.annotate("region_x"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert path.endswith("trace_rank3.json")
    events = json.load(open(path))["traceEvents"]
    assert any(e.get("name") == "region_x" for e in events)


@pytest.mark.parametrize("argv", [
    ["--profile-dir", "/tmp/p"], ["--nan-check"],
    ["--nan-check", "false"], ["--matmul-precision", "highest"],
    ["--matmul-precision", "high"], ["--aux"],
    ["--compile-cache-dir", "/c"], ["--model-remat", "true"], [],
])
def test_flags_parse_to_jax_config_values(argv):
    got, want = parse_config(argv), jax_config.parse_config(argv)
    for name in ("profile_dir", "nan_check", "matmul_precision", "aux",
                 "compile_cache_dir"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.model.remat == want.model.remat


def test_tf32_flag():
    """--tf32 true: the JAX package stores "default" (the TPU's reduced
    pass is its default); the port stores TF32's name in JAX's
    vocabulary. false leaves the default."""
    assert jax_config.parse_config(["--tf32", "true"]).matmul_precision \
        == "default"
    assert parse_config(["--tf32"]).matmul_precision == "tensorfloat32"
    assert parse_config(["--tf32", "false"]).matmul_precision == "default"
    assert MATMUL_PRECISIONS["tensorfloat32"] is True


def test_train_cli_runs_the_diagnostics(tmp_path, capsys):
    root = make_synthetic_breadm(str(tmp_path / "data"), size=40,
                                 time_steps=2, patients_per_split=2,
                                 slices_per_patient=2, seed=0)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    result = train_cli.run([
        "--data-path", root, "--device", "cpu", "--data-base-size", "40",
        "--data-crop-size", "32", "--batch-size", "2", "--epochs", "2",
        "--data-sequence-types", "VIBRANT+C1,VIBRANT+C2",
        "--model-remat", "true", "--profile-dir", str(tmp_path / "prof"),
        "--nan-check", "--matmul-precision", "high", "--aux",
        "--compile-cache-dir", str(tmp_path / "c"),
        "--save-dir", str(tmp_path / "w"), "--output-dir",
        str(tmp_path / "o"), "--print-freq", "100"])
    torch.backends.cuda.matmul.allow_tf32 = saved[0]
    torch.backends.cudnn.allow_tf32 = saved[1]
    out = capsys.readouterr().out
    for note in ("remat:", "NaN sanitizer enabled", "matmul precision: high",
                 "--aux accepted", "--compile-cache-dir is accepted"):
        assert note in out, note
    assert all(math.isfinite(e["train_loss"]) for e in result["epochs"])
    assert result["trace_file"] == str(tmp_path / "prof" /
                                       "trace_rank0.json")
    names = {e.get("name") for e in json.load(open(
        result["trace_file"]))["traceEvents"]}
    # the first epoch only: its steps, batch waits, loss reads, eval and
    # saves
    for region in ("train_step", "data_wait", "loss_read", "eval",
                   "eval_batch", "checkpoint"):
        assert region in names, region
    cfg = parse_config(["--model-remat", "true"])
    assert dataclasses.replace(cfg.model).remat is True
