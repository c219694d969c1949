"""K7: train-mode batch normalization, forward and backward.

No TPU kernel is replaced: the JAX package leaves BatchNorm to XLA. The
CUDA kernels (`csrc/batch_norm.cu`) split each channel's reduction over
as many blocks as the card needs, where ATen's train-mode kernels launch
one block a channel (64 blocks on 132 SMs at the STF-LSTM-UNet's stem).

x [N, C, H, W] (float32 or bfloat16, NCHW-contiguous or channels-last;
any other layout is refused, never copied), weight and bias float32 [C]:
  forward   y = (x - mean) * (weight * invstd) + bias, in x's dtype, with
            mean and the biased variance over the N*H*W rows of each
            channel (invstd = 1 / sqrt(var + eps), both float32); the
            running statistics, when given, move toward the batch's mean
            and biased variance by flax's BatchNorm rule (the JAX
            package's), (1 - m) * old + m * batch (`update_running_stats`);
  backward  grad_bias = sum(dy), grad_weight = sum(dy * xhat) (float32),
            dx = weight * invstd * (dy - sum(dy) / n - xhat * sum(dy *
            xhat) / n) in x's dtype, xhat = (x - mean) * invstd.
The sums are taken in float32 (float64 stays float64 in the plain twins).

Bound on the H100: bytes. The least a train-mode BN moves is 10 bytes an
element in bfloat16 (x read and y written forward, x and dy read and dx
written backward); this design moves 16 (the statistics, the normalize,
the backward's sums and its elementwise pass each read x). `tiling` picks
the split grid from the shape; the .cu's note has the design.

`batch_norm_forward` and `batch_norm_backward` run the plain twins
(`batch_norm_forward_plain`, `batch_norm_backward_plain`) on a CPU tensor
and launch the kernels (three launches each way) on a CUDA tensor, or
raise; each counts its launches. `batch_norm_train` is the differentiable
op (`BatchNormTrain`) that models/blocks.TorchBatchNorm calls in
training. `twin_excess` holds the kernels against the twins, one shape
at a time, for the card tests and chip_smoke.py; `bn_input_shapes`
gives a model's BN input shapes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from stf_unet_tpu_torch.ops.kernels import build

_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 12
             + [ctypes.c_int] * 8 + [ctypes.c_float] * 2
             + [ctypes.c_void_p])
# csrc/batch_norm.cu's block: at most THREADS threads, each on fixed
# channels; the grid aims at a block per BLOCK_BYTES of x (`tiling`).
THREADS = 256
BLOCK_BYTES = 16 * 1024
H100_SMS = 132


class Tiling(NamedTuple):
    """The kernels' grid for one shape: `vec` elements a load, `group`
    channels a block, `splits_n` x `splits_j` blocks a group (runs, then
    a wide plane's vectors); `rv` vectors of a group in a run, `per_run`
    threads on a run, `lanes` runs read at once, `threads` a block,
    `blocks` in all."""
    vec: int
    group: int
    splits_n: int
    splits_j: int
    rv: int
    per_run: int
    lanes: int
    threads: int
    blocks: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def tiling(n: int, c: int, hw: int, itemsize: int, channels_last: bool,
           align: int, sms: int = H100_SMS) -> Tiling:
    """The split grid for x [n, c, hw] of `itemsize` bytes an element, in
    the given layout, whose pointers are `align`-byte aligned (a power of
    two, at most 16), on a card of `sms` SMs.

    Loads are 16 bytes where the run a thread reads (the plane, or a
    channels-last row) holds a whole number of them and the pointers
    allow, else 8, 4 or one element. A wide NCHW plane (at least THREADS
    loads) is a group of one channel; smaller planes group the most
    consecutive channels (a power of two dividing c) whose planes fit one
    pass of the block; a channels-last group is the most channels of a
    row that THREADS loads cover. The blocks: a target of one per
    BLOCK_BYTES of x, between 2 and 16 an SM, split over the runs first
    (each share at least one pass of its lanes) and then, short of the
    target, over a wide plane's loads (each share at least THREADS of
    them); the rounding to whole splits may pass the target by up to
    twice."""
    inner, runs = (1, n * hw) if channels_last else (hw, n)
    span = c if channels_last else hw
    vec = 1
    for nbytes in (16, 8, 4):
        v = nbytes // itemsize
        if v > 1 and align % nbytes == 0 and span % v == 0:
            vec = v
            break
    if channels_last:
        d = c // vec
        group = vec * max(k for k in range(1, min(d, THREADS) + 1)
                          if d % k == 0)
    else:
        group = 1
        while 2 * group * hw // vec <= THREADS and c % (2 * group) == 0:
            group *= 2
    rv = group * inner // vec
    per_run = min(rv, THREADS)
    lanes = THREADS // per_run
    groups = c // group
    target = min(max(n * c * hw * itemsize // BLOCK_BYTES, 2 * sms),
                 16 * sms)
    want = _cdiv(target, groups)
    splits_n = min(want, max(1, runs // lanes))
    splits_j = 1
    if rv > THREADS and groups * splits_n < target:
        splits_j = max(1, min(_cdiv(want, splits_n), rv // THREADS))
    return Tiling(vec, group, splits_n, splits_j, rv, per_run, lanes,
                  _cdiv(per_run * lanes, 32) * 32,
                  groups * splits_n * splits_j)


def _channels_last(x: torch.Tensor) -> bool:
    """x's layout: False for NCHW-contiguous, True for channels-last
    (raises on anything else)."""
    if x.dim() != 4:
        raise ValueError(f"batch_norm takes x [N, C, H, W]; got "
                         f"{tuple(x.shape)}")
    if x.is_contiguous():
        return False
    if x.is_contiguous(memory_format=torch.channels_last):
        return True
    raise ValueError(f"batch_norm takes an NCHW-contiguous or channels-last "
                     f"x; got strides {x.stride()}")


def _format(x: torch.Tensor) -> torch.memory_format:
    return (torch.channels_last if _channels_last(x)
            else torch.contiguous_format)


def _check(x: torch.Tensor, **per_channel: Optional[torch.Tensor]) -> None:
    """x's shape and layout, and each given per-channel tensor's shape and
    device."""
    _channels_last(x)
    c = x.shape[1]
    if x.numel() // max(c, 1) < 2:
        raise ValueError(f"batch_norm in training needs more than one value "
                         f"a channel; got x {tuple(x.shape)}")
    for name, v in per_channel.items():
        if v is None:
            continue
        if tuple(v.shape) != (c,):
            raise ValueError(f"batch_norm: {name} must be [{c}]; got "
                             f"{tuple(v.shape)}")
        if v.device != x.device:
            raise ValueError(f"batch_norm: {name} is on {v.device}, x on "
                             f"{x.device}")


DIMS = (0, 2, 3)  # a channel's rows


def _col(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def batch_norm_forward_plain(x: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor,
                             running_mean: Optional[torch.Tensor] = None,
                             running_var: Optional[torch.Tensor] = None,
                             momentum: float = 0.1, eps: float = 1e-5
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The forward in plain PyTorch: (y, mean, invstd), the running
    statistics updated in place when given."""
    _check(x, weight=weight, bias=bias, running_mean=running_mean,
           running_var=running_var)
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    var, mean = torch.var_mean(xf, dim=DIMS, correction=0)
    invstd = torch.rsqrt(var + eps)
    scale = weight.to(acc) * invstd
    y = torch.addcmul(_col(bias.to(acc)), xf - _col(mean), _col(scale))
    if running_mean is not None:
        update_running_stats(running_mean, running_var, mean, var, momentum)
    return y.to(x.dtype), mean, invstd


def update_running_stats(running_mean: torch.Tensor,
                         running_var: torch.Tensor, mean: torch.Tensor,
                         var: torch.Tensor, momentum: float) -> None:
    """flax's BatchNorm update of the running statistics, in place:
    (1 - momentum) * old + momentum * batch, with the batch's biased
    variance (csrc/batch_norm.cu's finish kernel does the same)."""
    with torch.no_grad():
        running_mean.mul_(1.0 - momentum).add_(
            mean.to(running_mean.dtype), alpha=momentum)
        running_var.mul_(1.0 - momentum).add_(
            var.to(running_var.dtype), alpha=momentum)


def batch_norm_backward_plain(dy: torch.Tensor, x: torch.Tensor,
                              weight: torch.Tensor, mean: torch.Tensor,
                              invstd: torch.Tensor, input_grad: bool = True
                              ) -> Tuple[Optional[torch.Tensor],
                                         torch.Tensor, torch.Tensor]:
    """The backward in plain PyTorch: (dx or None, grad_weight,
    grad_bias)."""
    acc = mean.dtype
    xc = x.to(acc) - _col(mean)
    dyf = dy.to(acc)
    grad_b = dyf.sum(DIMS)
    grad_w = (dyf * xc).sum(DIMS) * invstd
    if not input_grad:
        return None, grad_w, grad_b
    inv_n = 1.0 / (x.numel() // x.shape[1])
    ka = weight.to(acc) * invstd
    kx = -ka * invstd * (grad_w * inv_n)
    k0 = -ka * (grad_b * inv_n)
    dx = torch.addcmul(torch.addcmul(_col(k0), xc, _col(kx)), dyf, _col(ka))
    return dx.to(x.dtype), grad_w, grad_b


def _align(*tensors: torch.Tensor) -> int:
    align = 16
    for t in tensors:
        while t.data_ptr() % align:
            align //= 2
    return align


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(backward: bool, x: torch.Tensor, dy, out, weight, bias, mean,
            invstd, grad_w, grad_b, running_mean, running_var,
            momentum: float, eps: float) -> int:
    """One direction's launches (returns how many ran)."""
    if x.dtype not in build.DTYPE_CODES:
        raise TypeError(f"the batch_norm kernels take float32 or bfloat16, "
                        f"not {x.dtype}")
    for name, v in (("weight", weight), ("bias", bias),
                    ("running_mean", running_mean),
                    ("running_var", running_var)):
        if v is not None and (v.dtype != torch.float32
                              or not v.is_contiguous()):
            raise TypeError(f"the batch_norm kernels take a contiguous "
                            f"float32 {name}; got {v.dtype}")
    n, c, h, w = x.shape
    cl = _channels_last(x)
    t = tiling(n, c, h * w, x.element_size(), cl,
               _align(*(v for v in (x, dy, out) if v is not None)),
               _sms(x.device))
    part = torch.empty(c * t.splits_n * t.splits_j * 3,
                       dtype=torch.float32, device=x.device)
    lib = build.load("batch_norm", _ARGTYPES)

    def ptr(v):
        return None if v is None else v.data_ptr()

    with torch.cuda.device(x.device):
        status = lib.stf_batch_norm(
            int(backward), build.DTYPE_CODES[x.dtype], x.data_ptr(), ptr(dy),
            ptr(out), ptr(weight), ptr(bias), mean.data_ptr(),
            invstd.data_ptr(), ptr(grad_w), ptr(grad_b), part.data_ptr(),
            ptr(running_mean), ptr(running_var), n, c, h * w, int(cl),
            t.vec, t.group, t.splits_n, t.splits_j, float(momentum),
            float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    build.check_status("batch_norm", status)
    return 2 if backward and out is None else 3


def batch_norm_forward(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor,
                       running_mean: Optional[torch.Tensor] = None,
                       running_var: Optional[torch.Tensor] = None,
                       momentum: float = 0.1, eps: float = 1e-5
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, mean, invstd), see module docstring."""
    if x.device.type == "cpu":
        return batch_norm_forward_plain(x, weight, bias, running_mean,
                                        running_var, momentum, eps)
    if x.device.type != "cuda":
        raise ValueError(f"batch_norm runs on CUDA or CPU, not {x.device}")
    _check(x, weight=weight, bias=bias, running_mean=running_mean,
           running_var=running_var)
    if weight is None or bias is None:
        raise ValueError("the batch_norm kernels take a weight and a bias")
    if (running_mean is None) != (running_var is None):
        raise ValueError("batch_norm: give both running statistics or "
                         "neither")
    c = x.shape[1]
    y = torch.empty_like(x)
    mean = torch.empty(c, dtype=torch.float32, device=x.device)
    invstd = torch.empty_like(mean)
    batch_norm_forward.launches += _launch(
        False, x, None, y, weight, bias, mean, invstd, None, None,
        running_mean, running_var, momentum, eps)
    return y, mean, invstd


def batch_norm_backward(dy: torch.Tensor, x: torch.Tensor,
                        weight: torch.Tensor, mean: torch.Tensor,
                        invstd: torch.Tensor, input_grad: bool = True
                        ) -> Tuple[Optional[torch.Tensor], torch.Tensor,
                                   torch.Tensor]:
    """(dx or None, grad_weight, grad_bias), see module docstring. dy is
    taken in x's layout."""
    if x.device.type == "cpu":
        return batch_norm_backward_plain(dy, x, weight, mean, invstd,
                                         input_grad)
    if x.device.type != "cuda":
        raise ValueError(f"batch_norm runs on CUDA or CPU, not {x.device}")
    _check(x, weight=weight, mean=mean, invstd=invstd)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"batch_norm: dy {tuple(dy.shape)} {dy.dtype} does "
                         f"not match x {tuple(x.shape)} {x.dtype}")
    if not dy.is_contiguous(memory_format=_format(x)):
        raise ValueError(f"batch_norm: dy (strides {dy.stride()}) is not in "
                         f"x's layout (strides {x.stride()})")
    dx = torch.empty_like(x) if input_grad else None
    grad_w = torch.empty_like(mean)
    grad_b = torch.empty_like(mean)
    batch_norm_backward.launches += _launch(
        True, x, dy, dx, weight, None, mean, invstd, grad_w, grad_b, None,
        None, 0.0, 0.0)
    return dx, grad_w, grad_b


batch_norm_forward.launches = 0
batch_norm_backward.launches = 0


class BatchNormTrain(torch.autograd.Function):
    """batch_norm_forward with batch_norm_backward as its gradient (x,
    weight, bias; the running statistics are state, not inputs)."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum,
                eps):
        y, mean, invstd = batch_norm_forward(x, weight, bias, running_mean,
                                             running_var, momentum, eps)
        ctx.save_for_backward(x, weight, mean, invstd)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, weight, mean, invstd = ctx.saved_tensors
        dy = dy.contiguous(memory_format=_format(x))
        dx, grad_w, grad_b = batch_norm_backward(
            dy, x, weight, mean, invstd, ctx.needs_input_grad[0])
        return dx, grad_w, grad_b, None, None, None, None


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor,
                     running_mean: Optional[torch.Tensor] = None,
                     running_var: Optional[torch.Tensor] = None,
                     momentum: float = 0.1, eps: float = 1e-5
                     ) -> torch.Tensor:
    """Train-mode batch normalization of x [N, C, H, W] with the batch's
    statistics (module docstring), differentiable in x, weight and
    bias."""
    return BatchNormTrain.apply(x, weight, bias, running_mean, running_var,
                                momentum, eps)


# ------------------------------------------- the kernels against the twins

def bn_input_shapes(model: str, batch: int = 16, crop: int = 224
                    ) -> List[Tuple[int, int, int, int]]:
    """[(N, C, H, W)] of `model`'s BatchNorm inputs in one training step
    at `batch` and `crop` (the benchmark cells': 16, 224), in call order,
    from a forward on the meta device."""
    from stf_unet_tpu_torch.core.config import ModelConfig
    from stf_unet_tpu_torch.models.blocks import TorchBatchNorm
    from stf_unet_tpu_torch.models.registry import create_model

    cfg = ModelConfig(model=model)
    with torch.device("meta"):
        net = create_model(cfg, dtype=torch.bfloat16)
    shapes = []
    for m in net.modules():
        if isinstance(m, TorchBatchNorm):
            m.register_forward_pre_hook(
                lambda mod, args: shapes.append(tuple(args[0].shape)))
    net.eval()
    x = torch.empty((batch, cfg.time_steps, crop, crop, 1)
                    if model == "stflstm"
                    else (batch, crop, crop, cfg.time_steps), device="meta")
    net(x)
    return shapes


def twin_case(shape: Tuple[int, int, int, int], dtype: torch.dtype,
              channels_last: bool, device, seed: int = 3):
    """(x, dy, weight, bias, (running_mean, running_var)) for one shape,
    drawn on `device` from `seed`: x of spread 2.5 about channel means
    from -3 to 3 and dy a tenth of such a tensor, in `dtype` and the
    layout asked for; float32 parameters and statistics."""
    gen = torch.Generator(device=device).manual_seed(seed)
    c = shape[1]
    means = torch.linspace(-3.0, 3.0, c, device=device).view(1, -1, 1, 1)
    fmt = (torch.channels_last if channels_last
           else torch.contiguous_format)

    def draw(scale):
        v = torch.randn(shape, generator=gen, device=device) * 2.5 + means
        return (v * scale).to(dtype).contiguous(memory_format=fmt)

    x, dy = draw(1.0), draw(0.1)
    weight = torch.rand(c, generator=gen, device=device) + 0.5
    bias = torch.randn(c, generator=gen, device=device)
    stats = (torch.rand(c, generator=gen, device=device),
             torch.rand(c, generator=gen, device=device) + 0.5)
    return x, dy, weight, bias, stats


def twin_excess(shape: Tuple[int, int, int, int], dtype: torch.dtype,
                channels_last: bool, device, seed: int = 3) -> dict:
    """batch_norm_forward (with the running statistics, momentum 0.1,
    eps 1e-5) and batch_norm_backward on twin_case's inputs, run twice,
    against the plain twins computed in float64 on the same device. For
    each result, max(|got - want| - bound): at most 0 is within bound.
    rtol is one rounding of x's dtype (2^-8 bfloat16, 2^-20 float32);
    the statistics and parameter gradients are held to 3e-5 of the sum
    of their terms' sizes (float32 sums of up to 1.6 M terms, a few
    hundred in sequence a thread), y to rtol plus 3e-5 of its terms, dx
    to rtol plus 1e-4 of its terms (it carries grad_weight's rounding).
    "rerun" is the largest difference of the second run from the first
    (bound 0: bit-identical), "layout" 1 where y or dx is not in x's
    layout, else 0."""
    x, dy, w, b, stats = twin_case(shape, dtype, channels_last, device, seed)
    runs = []
    for _ in range(2):
        rm, rv = (s.clone() for s in stats)
        y, mean, invstd = batch_norm_forward(x, w, b, rm, rv, 0.1, 1e-5)
        runs.append((y, mean, invstd, rm, rv,
                     *batch_norm_backward(dy, x, w, mean, invstd)))
    y, mean, invstd, rm, rv, dx, dw, db = runs[0]
    f64 = torch.float64
    xd, dyd, wd = x.to(f64), dy.to(f64), w.to(f64)
    rm_d, rv_d = (s.to(f64) for s in stats)
    y_d, mean_d, invstd_d = batch_norm_forward_plain(
        xd, wd, b.to(f64), rm_d, rv_d, 0.1, 1e-5)
    dx_d, dw_d, db_d = batch_norm_backward_plain(dyd, xd, wd, mean_d,
                                                 invstd_d)
    xhat = (xd - _col(mean_d)) * _col(invstd_d)
    rtol = 2 ** -8 if dtype == torch.bfloat16 else 2 ** -20

    def excess(got, want, rel, terms, k=3e-5):
        want = want.to(f64)
        return ((got.to(f64) - want).abs() - rel * want.abs()
                - k * terms).max().item()

    size_x = xd.abs().mean(DIMS)
    fmt = _format(x)
    return {
        "mean": excess(mean, mean_d, 0, size_x),
        "invstd": excess(invstd, invstd_d, 1e-5, 0),
        "running_mean": excess(rm, rm_d, 1e-6, size_x),
        "running_var": excess(rv, rv_d, 1e-5, 0),
        "y": excess(y, y_d, rtol, _col(wd.abs()) * (xhat.abs() + 1)),
        "grad_bias": excess(db, db_d, 0, dyd.abs().sum(DIMS)),
        "grad_weight": excess(dw, dw_d, 0, (dyd * xhat).abs().sum(DIMS)),
        "dx": excess(dx, dx_d, rtol, _col(wd * invstd_d) * (
            dyd.abs() + dyd.abs().mean(DIMS, keepdim=True)
            * (1 + xhat.abs())), k=1e-4),
        "rerun": max((p.to(f64) - q.to(f64)).abs().max().item()
                     for p, q in zip(*runs)),
        "layout": float(not (y.is_contiguous(memory_format=fmt)
                             and dx.is_contiguous(memory_format=fmt))),
    }
