"""Shared measurement helpers of the port on the card (counterpart of
stf_unet_tpu/utils/benchkit.py).

Each helper measures ONE headline workload (batch 16 at crop 224, T=8,
from 256^2 sources) and returns a plain dict of numbers with the JAX
module's keys. They build their own model and state, so every consumer
reads the same code.

Every helper takes `device` ("cuda" by default) and raises when no GPU is
visible, unless the caller passes device="cpu"; there is no fallback. On
the card the paths run the port's kernels: the STF-LSTM-UNet train step
K1f / K1b (ops/kernels/lstm_last_x*), the fused step K2 (warp), the
serving forward K1f and K3 (lstm_last, C = 256 / 512 through
ops/lstm.py's routing), and the int8 forward K5 / K6 (ops/quant.py).

Timing convention: time.perf_counter over `iters` warm iterations after
explicit warmup, between torch.cuda.synchronize calls; where the JAX
module times one window this one takes the median of `timed_reps`.

FLOPs: XLA's cost analysis has no counterpart here, so `step_flops`
counts from the layers' shapes: 2 per multiply-add of every convolution,
transposed convolution and pixel-LSTM gate product of one forward, and a
step as 3 x the forward. That is the tensor-core work alone (no
normalization, activation, optimizer or augmentation arithmetic), so the
`mfu_pct` of this module is not comparable with the JAX module's, whose
count is everything XLA compiled.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

# Dense bf16 tensor-core peak of the H100 SXM (the card the port is
# measured on: NVIDIA H100 80GB HBM3, 700.00 W), TFLOP/s.
PEAK_BF16_TFLOPS = 989.0

_B, _T, _CROP, _SRC = 16, 8, 224, 256


def _device(device) -> torch.device:
    from stf_unet_tpu_torch.core.config import resolve_device
    return resolve_device(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _window_times(fn: Callable[[int, int], object], iters: int,
                   timed_reps: int, device: torch.device) -> List[float]:
    """Seconds per call of fn(rep, i) over `iters` calls, for each of
    `timed_reps` windows."""
    times = []
    for rep in range(max(1, timed_reps)):
        _sync(device)
        t0 = time.perf_counter()
        for i in range(iters):
            fn(rep, i)
        _sync(device)
        times.append((time.perf_counter() - t0) / iters)
    return times


def forward_flops(model: nn.Module, x: torch.Tensor) -> float:
    """FLOPs (2 per multiply-add) of one eval-mode forward of `model` on
    x that run on tensor cores: the convolutions and transposed
    convolutions, and each pixel LSTM's gate products (x @ W_ih and
    h @ W_hh, 16 T N C^2 over its N = B*H*W lanes), counted from the
    shapes each layer sees. x may live on the meta device."""
    from stf_unet_tpu_torch.models.stf_lstm_unet import PixelLSTM
    from stf_unet_tpu_torch.ops.conv import Conv2d, ConvTranspose2d

    total = [0.0]

    def conv_hook(mod, inp, out):
        kh, kw = mod.kernel_size
        per = 2.0 * kh * kw * mod.in_channels * mod.out_channels / mod.groups
        pixels = inp[0] if isinstance(mod, ConvTranspose2d) else out
        total[0] += per * pixels[:, 0].numel()

    def lstm_hook(mod, inp, out):
        bsz, t_steps, h, w, c = inp[0].shape
        total[0] += 16.0 * t_steps * bsz * h * w * c * c

    handles = [m.register_forward_hook(
        lstm_hook if isinstance(m, PixelLSTM) else conv_hook)
        for m in model.modules()
        if isinstance(m, (Conv2d, ConvTranspose2d, PixelLSTM))]
    was_training = model.training
    try:
        with torch.no_grad():
            model.eval()(x)
    finally:
        model.train(was_training)
        for h in handles:
            h.remove()
    return total[0]


def step_flops(cfg, batch: int, crop: int) -> float:
    """Tensor-core FLOPs of one train step (3 x the forward) of the model
    `cfg` (core/config.ModelConfig) on [batch, T, crop, crop, 1] inputs,
    counted on the meta device: no weights, no arithmetic (the pixel
    LSTMs take the plain loop there; the count is the routes' own)."""
    import dataclasses

    from stf_unet_tpu_torch.models.registry import (create_model,
                                                    preprocess_input)

    planes = cfg.time_steps + (cfg.pk_channels if cfg.use_pk_maps else 0)
    with torch.device("meta"):
        model = create_model(dataclasses.replace(cfg, lstm_backend="scan"))
        x = torch.empty((batch, planes, crop, crop, 1))
    return 3.0 * forward_flops(model, preprocess_input(x, model))


def _train_objects(model_name: str, dtype: torch.dtype, device,
                   lstm_backend: str = "auto"):
    from stf_unet_tpu_torch.core.config import ModelConfig, OptimConfig
    from stf_unet_tpu_torch.models.registry import create_model
    from stf_unet_tpu_torch.train.schedule import warmup_poly_schedule
    from stf_unet_tpu_torch.train.state import TrainState, make_optimizer

    cfg = ModelConfig(model=model_name, num_classes=1, time_steps=_T,
                      lstm_backend=lstm_backend)
    torch.manual_seed(0)
    model = create_model(cfg, dtype=dtype).to(device)
    state = TrainState(model, make_optimizer(OptimConfig(), model, device))
    return cfg, state, warmup_poly_schedule(1e-3, 100, 100)


def measure_train_step(model_name: str, amp: bool, iters: int = 20,
                       with_flops: bool = True,
                       lstm_backend: str = "auto", *, timed_reps: int = 3,
                       device="cuda") -> Dict[str, Optional[float]]:
    """Pure train step (no augmentation), batch 16 @ 224^2 T=8: forward,
    criterion, backward and the AdamW apply, in bf16 (`amp`) or f32.
    Returns ms_per_step, slices_per_sec, and with `with_flops` tflops and
    mfu_pct against PEAK_BF16_TFLOPS (module docstring: tensor-core work
    from the shapes), else None for both."""
    from stf_unet_tpu_torch.train.loop import loss_and_grads

    dev = _device(device)
    cfg, state, sched = _train_objects(
        model_name, torch.bfloat16 if amp else torch.float32, dev,
        lstm_backend)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(_B, _T, _CROP, _CROP, 1))
                         .astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, 2, (_B, _CROP, _CROP))).to(dev)

    def step(rep=0, i=0):
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_and_grads(state.model, x, y, cfg.total_classes)
        for group in state.optimizer.param_groups:
            group["lr"] = sched(state.step)
        state.optimizer.step()
        state.step += 1
        return loss

    for _ in range(3):
        step()
    step_s = statistics.median(_window_times(step, iters, timed_reps, dev))
    flops = step_flops(cfg, _B, _CROP) if with_flops else 0.0
    tflops = flops / step_s / 1e12 if flops else None
    return {
        "ms_per_step": step_s * 1e3,
        "slices_per_sec": _B / step_s,
        "tflops": tflops,
        "mfu_pct": (100.0 * tflops / PEAK_BF16_TFLOPS) if tflops else None,
    }


def _fused_step(model_name: str, lstm_backend: str, device):
    """cli/train's step on raw uint8 [B, T, 256, 256] batches already on
    the device: the port's TrainAugment (K2 on the card), forward,
    backward and apply. Returns step(rep, i) -> device loss."""
    from stf_unet_tpu_torch.core.config import DataConfig
    from stf_unet_tpu_torch.core.prng import augment_generator
    from stf_unet_tpu_torch.data.transforms import TrainAugment
    from stf_unet_tpu_torch.train.loop import DeviceBatch, train_step

    cfg, state, sched = _train_objects(model_name, torch.bfloat16, device,
                                       lstm_backend)
    rng = np.random.default_rng(0)
    batch = DeviceBatch(
        frames=torch.from_numpy(rng.integers(0, 255, (_B, _T, _SRC, _SRC))
                                .astype(np.uint8)).to(device),
        masks=torch.from_numpy(rng.integers(0, 2, (_B, _SRC, _SRC))
                               .astype(np.uint8)).to(device),
        pk=None, sizes=np.full((_B, 2), _SRC, np.int32))
    aug = TrainAugment(DataConfig(base_size=_SRC, crop_size=_CROP))

    def step(epoch: int, i: int):
        return train_step(state, aug, batch, augment_generator(0, epoch, i),
                          sched, cfg.total_classes, device)[0]

    for i in range(3):
        step(0, i)
    return step


def measure_fused_train(iters: int = 20,
                        model_name: str = "unet",
                        lstm_backend: str = "auto", *, timed_reps: int = 3,
                        device="cuda") -> Dict[str, float]:
    """Fused augment + train, the end-to-end step a user gets from
    cli/train: raw uint8 [B, T, 256, 256] batches on the device, the
    augmentation's warp (K2), forward, backward and apply."""
    dev = _device(device)
    step = _fused_step(model_name, lstm_backend, dev)
    step_s = statistics.median(_window_times(
        lambda rep, i: step(1 + rep, i), iters, timed_reps, dev))
    return {"ms_per_step": step_s * 1e3, "slices_per_sec": _B / step_s}


def measure_fused_rotsplit(iters: int = 20,
                           model_name: str = "unet",
                           timed_reps: int = 3, *,
                           device="cuda") -> Dict[str, float]:
    """The JAX module's rotation-split measurement, kept under its name.
    The port has no rotation split: K2 warps every sample, rotated or
    not, in one launch (cli/train accepts --data-rotation-split and
    changes nothing). So this measures the same fused step as
    measure_fused_train, and reports, as the JAX function does, the
    median over `timed_reps` windows with their max - min spread."""
    dev = _device(device)
    step = _fused_step(model_name, "auto", dev)
    times = _window_times(lambda rep, i: step(1 + rep, i), iters,
                           timed_reps, dev)
    step_s = statistics.median(times)
    return {"ms_per_step": step_s * 1e3, "slices_per_sec": _B / step_s,
            "spread_ms_per_step": (max(times) - min(times)) * 1e3}


def measure_serving(model_name: str = "stflstm", int8: bool = False,
                    iters: int = 20, *, timed_reps: int = 3,
                    device="cuda") -> Dict[str, float]:
    """The serving engine's forward (device normalize -> forward ->
    argmax) at batch 16 @ 224^2, bf16 or post-training int8."""
    variant = "int8" if int8 else "bf16"
    return measure_serving_both(model_name, iters=iters, variants=(variant,),
                                timed_reps=timed_reps,
                                device=device)[variant]


def measure_serving_both(model_name: str = "stflstm", iters: int = 20,
                         variants=("bf16", "int8"), *, timed_reps: int = 3,
                         device="cuda") -> Dict[str, Dict[str, float]]:
    """bf16 and post-training int8 serving forwards sharing one model
    build and one calibration batch (ops/quant.calibrate on the batch's
    normalized inputs). Each runs InferenceEngine.predict's device ops on
    a uint8 batch already on the device: normalize, the forward, the
    argmax to uint8 masks."""
    from stf_unet_tpu_torch.core.config import DataConfig, ModelConfig
    from stf_unet_tpu_torch.data.transforms import normalize
    from stf_unet_tpu_torch.models.registry import (create_model,
                                                    preprocess_input)

    dev = _device(device)
    data_cfg = DataConfig()
    cfg = ModelConfig(model=model_name, num_classes=1, time_steps=_T)
    torch.manual_seed(0)
    base_model = create_model(cfg, dtype=torch.bfloat16).to(dev).eval()
    rng = np.random.default_rng(0)
    x_u8 = torch.from_numpy(rng.integers(
        0, 256, (_B, _T, _CROP, _CROP, 1), dtype=np.uint8)).to(dev)

    out: Dict[str, Dict[str, float]] = {}
    for variant in variants:
        model = base_model
        if variant == "int8":
            from stf_unet_tpu_torch.ops import quant
            xin = preprocess_input(normalize(x_u8, data_cfg.mean,
                                             data_cfg.std), base_model)
            model = quant.QuantizedModel(
                base_model, quant.calibrate(base_model, [xin])).eval()

        @torch.inference_mode()
        def fwd(rep=0, i=0, model=model):
            x = normalize(x_u8, data_cfg.mean, data_cfg.std)
            logits = model(preprocess_input(x, model))["out"]
            return torch.argmax(logits, dim=-1).to(torch.uint8)

        for _ in range(3):
            fwd()
        dt = statistics.median(_window_times(fwd, iters, timed_reps, dev))
        out[variant] = {"ms_per_batch": dt * 1e3, "slices_per_sec": _B / dt}
    return out


def measure_val_epoch_packed(model_name: str = "stflstm",
                             n_samples: int = 64,
                             batch_size: int = 1,
                             timed_reps: int = 3, *,
                             device="cuda") -> Dict[str, float]:
    """Single-batch-size wrapper over measure_val_epoch_packed_multi."""
    return measure_val_epoch_packed_multi(
        model_name, n_samples, (batch_size,), timed_reps,
        device=device)[batch_size]


def measure_val_epoch_packed_multi(model_name: str = "stflstm",
                                   n_samples: int = 64,
                                   batch_sizes=(1, 8),
                                   timed_reps: int = 3, *,
                                   device="cuda",
                                   ) -> Dict[int, Dict[str, float]]:
    """Packed val epoch, end to end: a synthetic BreaDM val tree
    (data/synthetic) -> its eval-geometry pack (data/pack.write_pack
    eval_size) -> eval_batches_from_index over the pack -> evaluate(), the
    decode-free val path cli/train runs every epoch under --data-pack.

    All batch sizes share one tree, pack and model (bf16, seeded). At
    each batch size the pack path must equal the decode path at the same
    batch size (dice and confusion matrix; an AssertionError otherwise):
    the eval-geometry pack stores the decode path's bytes. Each size
    measures `timed_reps` warm epochs and reports the median ms/slice and
    the max - min spread."""
    import shutil
    import tempfile

    from stf_unet_tpu_torch.core.config import DataConfig, ModelConfig
    from stf_unet_tpu_torch.data.index import DatasetIndex
    from stf_unet_tpu_torch.data.pack import open_split_pack, write_pack
    from stf_unet_tpu_torch.data.synthetic import make_synthetic_breadm
    from stf_unet_tpu_torch.models.registry import create_model
    from stf_unet_tpu_torch.train.loop import (eval_batches_from_index,
                                               evaluate)

    dev = _device(device)
    work = tempfile.mkdtemp(prefix="stf_valbench_")
    try:
        slices = max(1, n_samples // 4)
        make_synthetic_breadm(work + "/tree", splits=("val",),
                              patients_per_split=4,
                              slices_per_patient=slices,
                              size=_SRC, time_steps=_T)
        data_cfg = DataConfig(base_size=_SRC, crop_size=_CROP)
        index = DatasetIndex(work + "/tree", "val",
                             data_cfg.resolved_sequence_types)
        write_pack(index, work + "/pack/val", eval_size=_CROP)
        pack = open_split_pack(work + "/pack", "val")

        cfg = ModelConfig(model=model_name, num_classes=1, time_steps=_T)
        torch.manual_seed(0)
        model = create_model(cfg, dtype=torch.bfloat16).to(dev)

        def run(pack_arg, bs):
            return evaluate(model, eval_batches_from_index(
                index, data_cfg, pack=pack_arg, batch_size=bs),
                2, data_cfg=data_cfg, device=dev, print_freq=10**9)

        n = len(index)
        out: Dict[int, Dict[str, float]] = {}
        for bs in batch_sizes:
            decoded = run(None, bs)  # decode-path oracle, same bs
            packed = run(pack, bs)   # warm (kernels, page cache)
            if not (packed["dice"] == decoded["dice"]
                    and (packed["confusion_matrix"]
                         == decoded["confusion_matrix"]).all()):
                raise AssertionError(
                    f"packed val metrics diverged from the decode path at "
                    f"batch {bs}: dice {packed['dice']} vs "
                    f"{decoded['dice']}")
            times = []
            for _ in range(max(1, timed_reps)):
                _sync(dev)
                t0 = time.perf_counter()
                run(pack, bs)
                times.append(time.perf_counter() - t0)
            dt = statistics.median(times)
            out[bs] = {"ms_per_slice": dt / n * 1e3,
                       "slices_per_sec": n / dt,
                       "spread_ms_per_slice": (max(times) - min(times))
                       / n * 1e3,
                       "n_samples": n, "timed_reps": len(times)}
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)
