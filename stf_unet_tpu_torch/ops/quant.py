"""Post-training int8 quantization for the serving / evaluation forward
(counterpart of stf_unet_tpu/ops/quant.py).

The JAX package's scheme, standard symmetric PTQ:
  * weights: per-output-channel symmetric int8, wq = round(w / sw),
    sw = max(absmax(w over in, kh, kw), 1e-8) / 127, computed once;
  * activations: per-tensor symmetric int8 with static scales from a
    calibration pass over representative inputs (`calibrate`): the
    input absmax sx of every convolution, xq = round(x / (sx / 127));
  * s8 x s8 -> s32 accumulation; then y * (sw * sx / 127) in float32,
    + bias, cast back to the compute dtype. BN, the transposed convs
    (nn.ConvTranspose in the JAX package) and the pixel LSTMs stay in
    the float compute dtype.

It claims no speedup, as the JAX module claims none; `cli/quantize.py`
prints the float-vs-int8 dice delta before anything serves, and
chip_smoke.py times the int8 forward against bf16 on the card.

The convolution: eager PyTorch has no int8 convolution on CUDA, so
`int8_conv2d` runs it as a GEMM in three launches (ops/kernels/quant.py).
Kernel K5 (csrc/quant_patches.cu) quantizes x, NCHW or channels-last as
it arrives, and gathers its patches into an int8 [M, Kp] matrix in one
pass, k = (dy*KW + dx)*C + c; `torch._int_mm` (cuBLASLt's int8
tensor-core product) multiplies it by the weights, packed once at
quantize time as int8 [Np, Kp] in the same k order (K and the output
channels padded with zeros to multiples of 8, the GEMM's shape rule on
CUDA, which also takes M > 16: a smaller M is padded with zero rows);
kernel K6 (csrc/quant_epilogue.cu) reads each int32 accumulator once and
writes the output in the JAX package's order of operations (`_int8_conv`,
quant.py:97-102). The accumulators are exact integers in any k order, so
the result equals XLA's int8 convolution bit for bit. The output is a
channels-last view, which the next quantized conv's K5 reads as it is.

Mechanics, as the JAX package's interceptor: no model code changes.
`QuantizedModel(model, scales)` keeps the float model, and for every
calibrated conv (ops/conv.Conv2d) a `QuantConv` holding its int8
weights, sw and sx as buffers; its forward runs the model under
ops/conv.intercept, which sends those convs to `int8_conv2d`. Excluded or
uncalibrated convs run the exact float path. `num_classes` and
`input_format`, which the engine and `evaluate` read, are the wrapped
model's. Keys are the port's module names (`enc1.0`,
`layer1.0.conv1`, `final`, ...); utils/weights.conv_scales_from_jax maps
the JAX package's flax paths onto them.

Flow:
  scales = calibrate(model, inputs)          # data pass
  qmodel = QuantizedModel(model, scales)     # int8 weights as buffers
  qmodel(x)                                  # int8 convs

The scales file. The JAX package keeps one checkpoint directory per kind
and writes `quant_scales.json` into it. The port keeps best and latest
as two .pth files in one directory (cli/common.checkpoint_path), so the
sidecar is named per checkpoint file: `scales_path_for(
".../stflstm_best_model.pth")` is `.../stflstm_best_model.quant_scales.
json`. Its JSON is the JAX package's: {"version": 1, "scales": {...},
"checkpoint": {"epoch", "best_dice"}}, the last naming the calibrated
checkpoint, so a load against a retrained one warns.
"""

from __future__ import annotations

import json
import os
from typing import (Any, Dict, Iterable, Mapping, Optional, Sequence,
                    Tuple)

import torch
import torch.nn as nn

from stf_unet_tpu_torch.ops import conv as conv_ops
from stf_unet_tpu_torch.ops.kernels.quant import (conv_out_size,
                                                  dequant_epilogue, padded,
                                                  quantize_patches)

SCALES_SUFFIX = ".quant_scales.json"
_EPS = 1e-8
# torch._int_mm on CUDA takes M > 16 rows: smaller patch matrices are
# padded with zero rows up to this.
_MIN_GEMM_ROWS = 32


def quantize_kernel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """OIHW float kernel -> (int8 OIHW kernel, per-out-channel float32
    scale), as the JAX package's `quantize_kernel` on the HWIO form."""
    w = w.to(torch.float32)
    sw = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)), _EPS) / 127.0
    wq = torch.clamp(torch.round(w / sw[:, None, None, None]), -127, 127)
    return wq.to(torch.int8), sw


def pack_weights(wq: torch.Tensor) -> torch.Tensor:
    """int8 OIHW -> contiguous int8 [Np, Kp]: row o is output channel o's
    weights in K5's patch order k = (dy*KW + dx)*C + c, K and O padded
    with zeros to multiples of 8. `.t()` of it is the GEMM's [Kp, Np]
    operand, K-contiguous. Built at every construction and reload from
    the float weights; no file holds it."""
    o = wq.shape[0]
    k = wq[0].numel()
    out = torch.zeros((padded(o), padded(k)), dtype=torch.int8,
                      device=wq.device)
    out[:o, :k] = wq.permute(0, 2, 3, 1).reshape(o, k)
    return out


def activation_scale(sx: torch.Tensor) -> torch.Tensor:
    """max(sx, 1e-8) / 127 in float32: the step of x's int8 grid."""
    return torch.clamp_min(sx.to(torch.float32), _EPS) / 127.0


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def int8_conv2d(x: torch.Tensor, wq_mat: torch.Tensor, sw: torch.Tensor,
                sx: torch.Tensor, bias: Optional[torch.Tensor],
                kernel_size, stride=1, padding=0,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The int8 convolution of x [N, C, H, W]: wq_mat int8 [Kp, Np] (the
    transposed `pack_weights`), sw float32 [O], sx the calibrated absmax
    (0-d float32). K5 quantizes and gathers x, `torch._int_mm` multiplies,
    K6 dequantizes (module docstring). x is NCHW-contiguous or
    channels-last, as the previous quantized conv returns it (K5 refuses
    any other layout). Returns [N, O, Ho, Wo] in out_dtype (default x's),
    a channels-last view of K6's [M, O] output."""
    kernel_size, stride, padding = (_pair(kernel_size), _pair(stride),
                                    _pair(padding))
    n, _, h, w = x.shape
    ho, wo = conv_out_size(h, w, kernel_size, stride, padding)
    m = n * ho * wo
    o = sw.shape[0]
    scale = activation_scale(sx)
    patches = quantize_patches(x, scale, kernel_size, stride, padding,
                               kp=wq_mat.shape[0],
                               rows=m if m > 16 else _MIN_GEMM_ROWS)
    y = dequant_epilogue(
        torch._int_mm(patches, wq_mat), m, sw.to(torch.float32), scale,
        None if bias is None else bias.to(torch.float32),
        x.dtype if out_dtype is None else out_dtype)
    return y.reshape(n, ho, wo, o).permute(0, 3, 1, 2)


def conv_modules(model: nn.Module) -> Dict[str, conv_ops.Conv2d]:
    """{module name: conv} of every ops/conv.Conv2d in `model`: the convs
    that calibrate and quantize (the transposed convs stay float)."""
    return {name: m for name, m in model.named_modules()
            if isinstance(m, conv_ops.Conv2d)}


@torch.inference_mode()
def calibrate(model: nn.Module, inputs: Iterable[torch.Tensor]
              ) -> Dict[str, float]:
    """Run the eval-mode model over representative `inputs` (each already
    in model input form: normalized, preprocess_input applied) and return
    {conv name: input absmax}, maxed over all inputs; the absmax is taken
    in the compute dtype, as the JAX package's interceptor takes it.
    Forward pre-hooks record it, so the convs run their float forward."""
    model.eval()
    stats: Dict[str, torch.Tensor] = {}

    def hook(name: str):
        def record(_mod, args):
            absmax = args[0].abs().amax().to(torch.float32)
            prev = stats.get(name)
            stats[name] = absmax if prev is None else torch.maximum(
                prev, absmax)
        return record

    handles = [m.register_forward_pre_hook(hook(name))
               for name, m in conv_modules(model).items()]
    n = 0
    try:
        for x in inputs:
            model(x)
            n += 1
    finally:
        for h in handles:
            h.remove()
    if n == 0:
        raise ValueError("calibrate() got no inputs")
    return {name: float(v) for name, v in stats.items()}


def _key(name: str) -> str:
    """Module name -> a ModuleDict key (no dots): `layer1.0.conv1` ->
    `layer1/0/conv1`, the JAX package's path separator."""
    return name.replace(".", "/")


class QuantConv(nn.Module):
    """One conv's int8 state: wq [Np, Kp] int8 (`pack_weights`), sw [O]
    and sx (0-d) float32, as buffers; called with the conv and its input,
    it runs `int8_conv2d` with the conv's geometry and float bias."""

    def __init__(self, conv: conv_ops.Conv2d, absmax: float):
        super().__init__()
        if conv.groups != 1 or tuple(conv.dilation) != (1, 1):
            raise ValueError(f"int8 convolution takes groups=1 and "
                             f"dilation=1, not groups={conv.groups}, "
                             f"dilation={tuple(conv.dilation)}")
        if isinstance(conv.padding, str):
            raise ValueError(f"int8 convolution takes numeric padding, not "
                             f"{conv.padding!r}")
        wq, sw = quantize_kernel(conv.weight.detach())
        self.register_buffer("wq", pack_weights(wq))
        self.register_buffer("sw", sw)
        self.register_buffer("sx", torch.tensor(
            absmax, dtype=torch.float32, device=sw.device))
        self.kernel_size = _pair(conv.kernel_size)
        self.stride = _pair(conv.stride)
        self.padding = _pair(conv.padding)

    def forward(self, conv: conv_ops.Conv2d, x: torch.Tensor
                ) -> torch.Tensor:
        return int8_conv2d(x, self.wq.t(), self.sw, self.sx, conv.bias,
                           self.kernel_size, self.stride, self.padding)


class QuantizedModel(nn.Module):
    """Drop-in model wrapper: forward runs the wrapped float model with
    its convs in `scales` (module name -> absmax) on the int8 path; names
    in `exclude` (exact match) keep the float path. `input_format` and
    `num_classes` are the wrapped model's."""

    def __init__(self, model: nn.Module, scales: Mapping[str, float],
                 exclude: Sequence[str] = ()):
        super().__init__()
        self.model = model
        self.input_format = getattr(model, "input_format", "time_sequence")
        self.num_classes = model.num_classes
        convs = conv_modules(model)
        unknown = sorted(set(scales) - set(convs))
        if unknown:
            raise ValueError(f"scales name no conv of the model: {unknown}")
        self.quant = nn.ModuleDict({
            _key(name): QuantConv(convs[name], absmax)
            for name, absmax in scales.items() if name not in exclude})
        self._table = {convs[name]: self.quant[_key(name)]
                       for name in self.paths}

    @property
    def paths(self) -> Tuple[str, ...]:
        """The quantized convs' module names."""
        return tuple(k.replace("/", ".") for k in self.quant.keys())

    def forward(self, *args, **kwargs):
        with conv_ops.intercept(self._table):
            return self.model(*args, **kwargs)

    def state_from(self, float_state: Mapping[str, torch.Tensor],
                   scales: Mapping[str, float]) -> Dict[str, torch.Tensor]:
        """This wrapper's state_dict for another checkpoint of the same
        model (`float_state`, a state_dict of the wrapped model) and its
        scales, quantized as at construction: what a server's reload
        loads. The scales must quantize the same convs."""
        if set(scales) != set(self.paths):
            raise ValueError(
                f"the scales quantize other convs than the served model "
                f"(served {len(self.paths)}, file {len(scales)}: "
                f"{sorted(set(scales) ^ set(self.paths))}) - restart the "
                f"server")
        out = {f"model.{k}": v for k, v in float_state.items()}
        for name in self.paths:
            wq, sw = quantize_kernel(float_state[f"{name}.weight"])
            prefix = f"quant.{_key(name)}."
            out[prefix + "wq"] = pack_weights(wq)
            out[prefix + "sw"] = sw
            out[prefix + "sx"] = torch.tensor(scales[name],
                                              dtype=torch.float32)
        return out


def save_scales(path: str, scales: Mapping[str, float],
                checkpoint_meta: Optional[Mapping[str, Any]] = None) -> None:
    """checkpoint_meta: identity of the calibrated checkpoint (its epoch
    and best_dice) - consumers warn when the checkpoint has been retrained
    since calibration (stale scales serve a different network than the
    one whose accuracy delta was printed)."""
    doc: Dict[str, Any] = {"version": 1, "scales": dict(scales)}
    if checkpoint_meta:
        doc["checkpoint"] = {k: checkpoint_meta.get(k)
                             for k in ("epoch", "best_dice")}
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)


def load_scales(path: str, checkpoint_meta: Optional[Mapping[str, Any]]
                = None) -> Dict[str, float]:
    """checkpoint_meta: pass the CURRENT checkpoint's metadata to get a
    loud warning when the scales were calibrated against a different save
    (re-run cli/quantize after retraining)."""
    with open(path) as f:
        doc = json.load(f)
    if "scales" not in doc:
        raise ValueError(f"{path} is not a quant_scales file")
    saved = doc.get("checkpoint")
    if checkpoint_meta is not None and saved:
        current = {k: checkpoint_meta.get(k) for k in ("epoch", "best_dice")}
        if current != saved:
            print(f"WARNING: {path} was calibrated against checkpoint "
                  f"{saved} but the current checkpoint is {current} — "
                  "the printed accuracy delta no longer applies; re-run "
                  "cli/quantize")
    return {k: float(v) for k, v in doc["scales"].items()}


def scales_path_for(checkpoint_file: str) -> str:
    """The scales sidecar of a checkpoint file: `<name>.pth` ->
    `<name>.quant_scales.json` (module docstring)."""
    return os.path.splitext(checkpoint_file)[0] + SCALES_SUFFIX
