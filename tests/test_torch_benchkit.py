"""The port's utils/benchkit.py on the CPU, at a small size, against the
JAX package's module of the same name.

Both modules' sizes (_B, _T, _CROP, _SRC) are shrunk by monkeypatching,
as the JAX module's own consumers may (T stays 8: the val helpers' trees
hold the eight sequences the data config names). Checked:
  * each of the seven helpers on the UNet (base_c 8) returns the JAX
    helper's keys, nested the same way (per variant, per batch size),
    every value a finite number > 0; tflops / mfu_pct are None only under
    with_flops=False. The JAX helpers run at the same sizes on a
    stand-in model (one 1x1 conv and a BN, `_JaxStandIn`): their keys do
    not depend on the model, and the UNet's CPU compiles in the seven
    helpers take ~190 s;
  * the STF-LSTM-UNet's train step and bf16 / int8 serving run on the
    port alone under the card's LSTM routing, reaching the plain twins
    of K1f, K1b, K3, K5 and K6 (and K2's in the fused step);
  * the FLOP counter equals a hand sum over the layers' shapes, exactly,
    for the UNet and the STF-LSTM-UNet at a small size, and the
    full-size UNet step (B=16, 224^2, T=8, counted on the meta device)
    equals 3 x 16 x 74,051,747,840 within 1e-3;
  * the packed val epoch's pack-equals-decode assertion holds at batch 1
    and 2, and a pack reader that flips one byte makes it raise;
  * with `device` left at its default, every helper raises where no GPU
    is visible, with no CPU fallback.
"""

import dataclasses
import math
from typing import Any

import flax.linen as flax_nn
import jax.numpy as jnp
import pytest
import torch

from stf_unet_tpu.models import registry as jax_registry
from stf_unet_tpu.train import state as jax_state
from stf_unet_tpu.utils import benchkit as jax_bk
from stf_unet_tpu_torch.core import config as port_config
from stf_unet_tpu_torch.core.config import ModelConfig
from stf_unet_tpu_torch.utils import benchkit as bk

SIZES = {"_B": 1, "_T": 8, "_CROP": 32, "_SRC": 32}
UNET_BASE_C = 8
VAL_SAMPLES = 4
FULL_UNET_SAMPLE_FLOP = 74_051_747_840  # one 224^2, T=8 UNet forward

# (helper, kwargs of the call on both packages, port-only kwargs)
CALLS = {
    "measure_train_step": (("unet", True), {"iters": 1}, {"timed_reps": 1}),
    "measure_fused_train": ((), {"iters": 1, "model_name": "unet"},
                            {"timed_reps": 1}),
    "measure_fused_rotsplit": ((), {"iters": 1, "model_name": "unet",
                                    "timed_reps": 2}, {}),
    "measure_serving": (("unet",), {"iters": 1}, {"timed_reps": 1}),
    "measure_serving_both": (("unet",), {"iters": 1}, {"timed_reps": 1}),
    "measure_val_epoch_packed": (
        ("unet",), {"n_samples": VAL_SAMPLES, "batch_size": 1,
                    "timed_reps": 2}, {}),
    "measure_val_epoch_packed_multi": (
        ("unet",), {"n_samples": VAL_SAMPLES, "batch_sizes": (1, 2),
                    "timed_reps": 2}, {}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small CPU steps: the test
    workers share the host's cores, and torch's default of a thread per
    core makes each tiny op of one worker wait on the others'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@dataclasses.dataclass
class _NarrowModelConfig(ModelConfig):
    base_c: int = UNET_BASE_C


@pytest.fixture(scope="module")
def small():
    """SIZES in both modules; the port's helpers build the UNet at
    base_c UNET_BASE_C (the STF-LSTM-UNet has no width to narrow)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (bk, jax_bk):
            for name, value in SIZES.items():
                mp.setattr(mod, name, value)
        mp.setattr(port_config, "ModelConfig", _NarrowModelConfig)
        yield


class _JaxStandIn(flax_nn.Module):
    """The JAX helpers' model here: one 1x1 conv and a BN, taking the
    frames as channels as the UNet does."""

    num_classes: int = 2
    dtype: Any = None
    input_format = "flat_channels"

    @flax_nn.compact
    def __call__(self, x, train=False):
        x = flax_nn.Conv(self.num_classes, (1, 1), dtype=self.dtype)(x)
        x = flax_nn.BatchNorm(use_running_average=not train)(x)
        return {"out": x.astype(jnp.float32)}


@pytest.fixture(scope="module")
def jax_results(small):
    """Every JAX helper's result at SIZES, computed once."""
    def stand_in(cfg, dtype=None):
        return _JaxStandIn(cfg.total_classes, dtype)

    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_registry, jax_state):
            mp.setattr(mod, "create_model", stand_in)
        return {name: getattr(jax_bk, name)(*args, **kwargs)
                for name, (args, kwargs, _) in CALLS.items()}


def _structure(value):
    if isinstance(value, dict):
        return {k: _structure(v) for k, v in value.items()}
    return None


def _numbers(value):
    if isinstance(value, dict):
        for v in value.values():
            yield from _numbers(v)
    else:
        yield value


@pytest.mark.parametrize("name", sorted(CALLS))
def test_keys_equal_jax(name, small, jax_results):
    args, kwargs, port_kwargs = CALLS[name]
    got = getattr(bk, name)(*args, **kwargs, **port_kwargs, device="cpu")
    assert _structure(got) == _structure(jax_results[name])
    for v in _numbers(got):
        assert isinstance(v, (int, float)) and math.isfinite(v) and v > 0


def test_train_step_without_flops(small):
    got = bk.measure_train_step("unet", False, iters=1, with_flops=False,
                                timed_reps=1, device="cpu")
    assert got["tflops"] is None and got["mfu_pct"] is None
    assert got["ms_per_step"] > 0 and got["slices_per_sec"] > 0


@pytest.fixture
def card_routing(monkeypatch):
    """The card's "auto" LSTM routing on CPU tensors, and counters on the
    kernels' plain twins (the wrappers run them on CPU tensors)."""
    from stf_unet_tpu_torch.ops import lstm
    from stf_unet_tpu_torch.ops.kernels import (lstm_last, lstm_last_x,
                                                lstm_last_x_bwd, quant,
                                                warp)

    def routing(device, cdim, train=False):
        if train:
            return "fused" if cdim <= lstm.FUSED_TRAIN_MAX_C else "scan"
        return "fused" if cdim <= lstm.FUSED_MAX_C else "last"

    monkeypatch.setattr(lstm, "lstm_backend_default", routing)
    calls = {}
    for mod, name in ((lstm_last_x, "lstm_last_x_plain"),
                      (lstm_last_x_bwd, "lstm_last_x_bwd_plain"),
                      (lstm_last, "lstm_last_plain"),
                      (warp, "warp_plain"),
                      (quant, "quantize_patches_plain"),
                      (quant, "dequant_epilogue_plain")):
        def counted(*a, _fn=getattr(mod, name), _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    return calls


def test_stflstm_train_step_reaches_k1f_k1b(small, card_routing):
    got = bk.measure_train_step("stflstm", True, iters=1, timed_reps=1,
                                device="cpu")
    assert all(math.isfinite(v) and v > 0 for v in got.values())
    # C = 64 and 128 through K1f / K1b, 4 steps (3 warm + 1 timed)
    assert card_routing == {"lstm_last_x_plain": 8,
                            "lstm_last_x_bwd_plain": 8}


def test_stflstm_serving_reaches_k1f_k3_k5_k6(small, card_routing):
    got = bk.measure_serving_both("stflstm", iters=1, timed_reps=1,
                                  device="cpu")
    assert set(got) == {"bf16", "int8"}
    for v in _numbers(got):
        assert math.isfinite(v) and v > 0
    # 4 forwards of each variant + the calibration forward: K1f at C = 64,
    # 128, 256, K3 at C = 512; int8 forwards through K5 / K6
    assert card_routing["lstm_last_x_plain"] == 3 * 9
    assert card_routing["lstm_last_plain"] == 9
    assert card_routing["quantize_patches_plain"] == \
        card_routing["dequant_epilogue_plain"] > 0


def test_fused_train_reaches_k2(small, card_routing):
    bk.measure_fused_train(iters=1, model_name="unet", timed_reps=1,
                           device="cpu")
    assert card_routing == {"warp_plain": 4}


def _conv(k, cin, cout, pixels):
    return 2 * k * k * cin * cout * pixels


def unet_forward_flop(b, t, c, s):
    """The UNet (in_channels t, base_c c) at s x s, batch b."""
    total = 0
    widths = (t, c, 2 * c, 4 * c, 8 * c, 16 * c)
    for level in range(5):  # encoder and bottleneck: two 3x3 convs each
        px = (s >> level) ** 2
        total += _conv(3, widths[level], widths[level + 1], px)
        total += _conv(3, widths[level + 1], widths[level + 1], px)
    for level in (4, 3, 2, 1):  # ConvT k2 s2 from level, then dec
        w = widths[level]  # c * 2^(level - 1)
        total += _conv(2, 2 * w, w, (s >> level) ** 2)  # input pixels
        px = (s >> (level - 1)) ** 2
        total += _conv(3, 2 * w, w, px) + _conv(3, w, w, px)
    total += _conv(1, c, 2, s * s)
    return b * total


def stflstm_forward_flop(b, t, s):
    """The STF-LSTM-UNet (full widths, no PK maps) at s x s, batch b."""
    frames = b * t
    enc = _conv(7, 1, 64, (s // 2) ** 2)
    enc += 6 * _conv(3, 64, 64, (s // 4) ** 2)
    for cin, cout, blocks, div in ((64, 128, 4, 8), (128, 256, 6, 16),
                                   (256, 512, 3, 32)):
        px = (s // div) ** 2
        enc += (_conv(3, cin, cout, px) + (2 * blocks - 1)
                * _conv(3, cout, cout, px) + _conv(1, cin, cout, px))
    lstm = sum(16 * t * b * (s // div) ** 2 * c * c
               for c, div in ((64, 4), (128, 8), (256, 16), (512, 32)))
    dec = 0
    for cin, cout, div in ((512, 256, 32), (256, 128, 16), (128, 64, 8)):
        px = (s // (div // 2)) ** 2
        dec += _conv(3, cin, cout, (s // div) ** 2)  # ConvT, input pixels
        dec += _conv(1, 2 * cout, cout, px) + 2 * _conv(3, cout, cout, px)
    dec += _conv(3, 64, 32, (s // 4) ** 2)  # upconv1
    dec += 2 * _conv(3, 32, 32, (s // 2) ** 2) + _conv(1, 32, 2,
                                                       (s // 2) ** 2)
    return frames * enc + lstm + b * dec


@pytest.mark.parametrize("model,cfg,want", [
    ("unet", {"base_c": 8}, 3 * unet_forward_flop(2, 3, 8, 32)),
    ("stflstm", {}, 3 * stflstm_forward_flop(2, 3, 64)),
])
def test_step_flops_equal_hand_sum(model, cfg, want):
    size = 32 if model == "unet" else 64
    got = bk.step_flops(ModelConfig(model=model, time_steps=3, **cfg), 2,
                        size)
    assert got == want


def test_full_size_unet_step_flops():
    assert unet_forward_flop(1, 8, 64, 224) == FULL_UNET_SAMPLE_FLOP
    got = bk.step_flops(ModelConfig(model="unet", time_steps=8), 16, 224)
    want = 3 * 16 * FULL_UNET_SAMPLE_FLOP
    assert abs(got - want) <= 1e-3 * want


def test_forward_flops_counts_a_real_forward(small):
    """The same counter on weights and data (chip_smoke.py's UNet step
    phase counts this way) as on the meta device."""
    from stf_unet_tpu_torch.models.registry import (create_model,
                                                    preprocess_input)

    cfg = ModelConfig(model="stflstm", time_steps=2)
    torch.manual_seed(0)
    model = create_model(cfg).train()
    x = torch.zeros((1, 2, 32, 32, 1))
    assert bk.forward_flops(model, preprocess_input(x, model)) \
        == stflstm_forward_flop(1, 2, 32)
    assert model.training  # the counter's eval forward leaves the mode


def test_val_epoch_pack_must_equal_decode(small, monkeypatch):
    from stf_unet_tpu_torch.data.pack import DatasetPack

    bk.measure_val_epoch_packed_multi("unet", n_samples=VAL_SAMPLES,
                                      batch_sizes=(1, 2), timed_reps=1,
                                      device="cpu")
    read = DatasetPack.eval_sample

    def flipped(self, i):
        image, target = read(self, i)
        target = target.copy()
        target[0, 0] ^= 1  # one byte of the stored mask
        return image, target

    monkeypatch.setattr(DatasetPack, "eval_sample", flipped)
    with pytest.raises(AssertionError, match="diverged from the decode"):
        bk.measure_val_epoch_packed_multi(
            "unet", n_samples=VAL_SAMPLES, batch_sizes=(1, 2),
            timed_reps=1, device="cpu")


@pytest.mark.parametrize("name", sorted(CALLS))
def test_default_device_raises_without_a_gpu(name, small, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args, kwargs, port_kwargs = CALLS[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(bk, name)(*args, **kwargs, **port_kwargs)
