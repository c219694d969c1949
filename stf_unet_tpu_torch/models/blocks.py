"""Shared conv building blocks (counterpart of stf_unet_tpu/models/blocks.py).

NCHW activations. Module and attribute names follow the reference PyTorch
layout (conv_block.{0,1,3,4}, shortcut.{0,1}, up / fusion / res_conv; the
UNet's DoubleConv at .0/.1/.3/.4), so a reference state_dict loads with
strict=True.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator

import torch
import torch.distributed as dist
import torch.nn as nn

from stf_unet_tpu_torch.ops.conv import Conv2d, ConvTranspose2d
from stf_unet_tpu_torch.ops.kernels.batch_norm import batch_norm_train
from stf_unet_tpu_torch.ops.resize import resize_bilinear_align_corners

# torch convention: running = (1 - momentum)*running + momentum*batch
# (the JAX package's flax momentum 0.9 is the same update).
BN_MOMENTUM = 0.1
BN_EPS = 1e-5


class TorchBatchNorm(nn.BatchNorm2d):
    """BatchNorm2d with torch default hyperparameters whose running
    variance moves toward the biased batch variance, as flax's BatchNorm
    (the JAX package's) does; nn.BatchNorm2d moves it toward the unbiased
    one, n / (n - 1) larger, n = the rows per channel. The normalized
    output, eval mode and the state_dict are nn.BatchNorm2d's. Its
    parameters stay float32; a bfloat16 input is normalized and returned
    in bfloat16.

    In training (no data group) the layer runs K7, ops/kernels/
    batch_norm.batch_norm_train: the hand-written kernels on a CUDA
    tensor, their plain twin on a CPU one. Its update is F.batch_norm's,
    new = (1 - m) * old + m * unbiased; a correction then gives flax's,
        (1 - m) * old + m * biased = new + ((1 - m) * old - new) / n,
    a lerp of new toward (1 - m) * old by 1 / n, made on `.data`. A layer
    corrects itself (two small launches) unless its model's forward hooks
    (`batch_running_var_updates`) hold it: then one foreach pass corrects
    every layer of the model after the forward.

    Under data parallelism (`convert_sync_batchnorm`) a train-mode layer
    takes its statistics over the global batch instead: flax's rule over
    every rank's rows (_SyncBatchNorm), its running variance updated to
    flax's rule directly, so the hooks leave it alone.

    Inside `frozen_running_stats()` (a rematerialized forward's recompute,
    models/stf_lstm_unet.py) a train-mode layer normalizes with the batch
    statistics as before, the synced one all-reducing them again, and
    leaves every buffer alone: flax's nn.remat updates batch_stats once."""

    def __init__(self, features: int):
        super().__init__(features, eps=BN_EPS, momentum=BN_MOMENTUM)
        # None: correct itself; 0: held by the model's hooks, not run yet
        # in this forward; > 0: held, ran over this many rows
        self.held_rows = None
        # the DataGroup (core/mesh.py) whose ranks share the statistics,
        # or None for this process's rows alone
        self.data_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        if _FROZEN_STATS.get():
            return self._frozen_forward(x)
        if self.data_group is not None:
            return self._synced_forward(x)
        self._check_input_dim(x)
        self.num_batches_tracked.add_(1)
        rows = x.numel() // x.shape[1]
        if self.held_rows == 0:
            self.held_rows = rows
            return self._train_forward(x, update=True)
        keep = self.running_var * (1.0 - self.momentum)
        y = self._train_forward(x, update=True)
        self.running_var.data.lerp_(keep, 1.0 / rows)
        return y

    def _train_forward(self, x: torch.Tensor, update: bool) -> torch.Tensor:
        return batch_norm_train(
            x, self.weight, self.bias,
            self.running_mean if update else None,
            self.running_var if update else None, self.momentum, self.eps)

    def _frozen_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The train-mode output without a buffer update, so the recompute
        saves for its backward what the first forward saved."""
        if self.data_group is not None:
            mean, var, n = global_batch_stats(x)
            return _SyncBatchNorm.apply(x, self.weight, self.bias, mean,
                                        var, n, self.eps)
        return self._train_forward(x, update=False)

    def _synced_forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var, n = global_batch_stats(x)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.to(
                self.running_mean.dtype), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.to(
                self.running_var.dtype), alpha=m)
            self.num_batches_tracked.add_(1)
        return _SyncBatchNorm.apply(x, self.weight, self.bias, mean, var, n,
                                    self.eps)


_FROZEN_STATS: contextvars.ContextVar = contextvars.ContextVar(
    "frozen_running_stats", default=False)


@contextlib.contextmanager
def frozen_running_stats() -> Iterator[None]:
    """Within the block train-mode TorchBatchNorms update no buffer (the
    context variable is this thread's: the recompute of a checkpointed
    forward runs in the backward's thread, inside this block)."""
    token = _FROZEN_STATS.set(True)
    try:
        yield
    finally:
        _FROZEN_STATS.reset(token)


def _channel_dims(x: torch.Tensor):
    return [0] + list(range(2, x.dim()))


def _per_channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return v.view([1, -1] + [1] * (x.dim() - 2))


def global_batch_stats(x: torch.Tensor):
    """(mean, biased variance, row count n) per channel of x [N, C, ...]
    over the rows of every rank, as flax's BatchNorm computes them
    (_compute_stats): the sums taken in float32 (float64 stays float64)
    as x is read, mean and E[x^2] reduced in one stacked all-reduce with
    the row count, var = max(0, E[x^2] - mean^2)."""
    with torch.no_grad():
        dt = torch.promote_types(x.dtype, torch.float32)
        dims = _channel_dims(x)
        c = x.shape[1]
        total = x.sum(dims, dtype=dt)
        buf = torch.cat([total, torch.linalg.vector_norm(
            x, dim=dims, dtype=dt).square(), total.new_full(
                (1,), x.numel() // c)])
        if dist.is_initialized():
            dist.all_reduce(buf)
        n = buf[-1]
        mean = buf[:c] / n
        var = torch.clamp(buf[c:2 * c] / n - mean * mean, min=0.0)
    return mean, var, n


class _SyncBatchNorm(torch.autograd.Function):
    """y = (x - mean) / sqrt(var + eps) * weight + bias with the global
    statistics (computed before, without a graph), as one eval-mode
    batch_norm pass; the backward takes this rank's two per-channel sums
    (Σ dy and Σ dy · xhat, the bias and weight gradients) in one
    reduction pass, all-reduces them, and forms dx from them, the
    derivative of the sum of every rank's loss, as nn.SyncBatchNorm's.
    The weight and bias gradients stay this rank's
    (DistributedDataParallel averages them with the others)."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, var, n, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, weight, mean, var, n)
        return torch.nn.functional.batch_norm(
            x, mean, var, weight, bias, training=False, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, var, n = ctx.saved_tensors
        invstd = torch.rsqrt(var + ctx.eps)
        # the weight and bias gradients of a train-mode BN at these
        # statistics are the two sums (its dx is not asked for)
        _, grad_w, grad_b = torch.ops.aten.native_batch_norm_backward(
            dy, x, weight, None, None, mean, invstd, True, ctx.eps,
            [False, True, True])
        sums = torch.stack([grad_b, grad_w]).to(mean.dtype)
        if dist.is_initialized():
            dist.all_reduce(sums)
        scale = weight.to(mean.dtype) * invstd  # dy's factor
        k2 = scale * invstd * sums[1] / n       # x's
        shift = mean * k2 - scale * sums[0] / n
        dx = torch.addcmul(_per_channel(shift, x), x, _per_channel(k2, x),
                           value=-1.0)
        dx.addcmul_(dy, _per_channel(scale, x))
        return dx.to(x.dtype), grad_w, grad_b, None, None, None, None


def convert_sync_batchnorm(model: nn.Module, group) -> nn.Module:
    """Make every TorchBatchNorm of `model` take its train-mode statistics
    over `group`'s global batch (in place; eval mode and the state_dict
    are unchanged). The ranks' local batches must have equal row counts,
    as the data-parallel loaders give them."""
    for m in model.modules():
        if isinstance(m, TorchBatchNorm):
            m.data_group = group
    return model


def check_k7_dtypes(model: nn.Module, device=None) -> None:
    """Raise before a step runs where a train-mode TorchBatchNorm of
    `model` would reach K7 (no data group, on a CUDA device: its weight's
    or `device`) with what K7 refuses: a compute dtype (the model's
    `compute_dtype`) other than bfloat16 or float32, or parameters other
    than float32."""
    dtype = getattr(model, "compute_dtype", None)
    for name, m in model.named_modules():
        if not isinstance(m, TorchBatchNorm) or m.data_group is not None:
            continue
        on = torch.device(device) if device is not None else m.weight.device
        if on.type != "cuda":
            continue
        if dtype not in (None, torch.bfloat16, torch.float32) or (
                m.weight.dtype != torch.float32):
            raise TypeError(
                f"train-mode BatchNorm on {on} runs K7, which takes "
                f"bfloat16 or float32 activations and float32 parameters; "
                f"{name} has compute dtype {dtype} and parameters "
                f"{m.weight.dtype} (train on the CPU for float64)")


def _hold_running_vars(model: nn.Module, args) -> None:
    layers = [m for m in model.modules() if isinstance(m, TorchBatchNorm)
              and m.training and m.track_running_stats
              and m.data_group is None]
    if not layers:
        return
    for m in layers:
        m.held_rows = 0
    with torch.no_grad():
        keep = torch._foreach_mul([m.running_var for m in layers],
                                  [1.0 - m.momentum for m in layers])
    model.__dict__["_held_running_vars"] = (layers, keep)


def _correct_running_vars(model: nn.Module, args, out) -> None:
    layers, keep = model.__dict__.pop("_held_running_vars", ((), ()))
    ran = [i for i, m in enumerate(layers) if m.held_rows]
    if ran:
        torch._foreach_lerp_([layers[i].running_var.data for i in ran],
                             [keep[i] for i in ran],
                             [1.0 / layers[i].held_rows for i in ran])
    for m in layers:
        m.held_rows = None


def batch_running_var_updates(model: nn.Module) -> None:
    """Register the forward hooks that take the running-variance
    correction of every TorchBatchNorm of `model` in one foreach pass per
    train-mode forward (a snapshot before it, the lerp after it) instead
    of two launches per layer. Each layer must run once per forward."""
    model.register_forward_pre_hook(_hold_running_vars)
    model.register_forward_hook(_correct_running_vars)


class DoubleConv(nn.Sequential):
    """2x(Conv3x3 with bias -> BN -> ReLU): the UNet conv_block
    (ref:src/unet.py:10-18), convs at .0 / .3 and BNs at .1 / .4."""

    def __init__(self, in_channels: int, features: int):
        super().__init__(
            Conv2d(in_channels, features, 3, padding=1),
            TorchBatchNorm(features),
            nn.ReLU(inplace=True),
            Conv2d(features, features, 3, padding=1),
            TorchBatchNorm(features),
            nn.ReLU(inplace=True),
        )


class ResidualConvBlock(nn.Module):
    """2x(Conv3x3 no-bias -> BN) + projection shortcut, then ReLU
    (ref:src/stf_lstm_unet.py:7-35)."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv_block = nn.Sequential(
            Conv2d(in_channels, features, 3, padding=1, bias=False),
            TorchBatchNorm(features),
            nn.ReLU(inplace=True),
            Conv2d(features, features, 3, padding=1, bias=False),
            TorchBatchNorm(features),
        )
        self.shortcut = None
        if in_channels != features:
            self.shortcut = nn.Sequential(
                Conv2d(in_channels, features, 1, bias=False),
                TorchBatchNorm(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.shortcut is None else self.shortcut(x)
        return torch.relu(self.conv_block(x) + residual)


def ConvTranspose(in_channels: int, features: int) -> ConvTranspose2d:
    """The decoder's x2 upsample: ConvTranspose2d(k3, s2, p1, op1)."""
    return ConvTranspose2d(in_channels, features, 3, stride=2, padding=1,
                           output_padding=1)


class DecoderBlock(nn.Module):
    """ConvT k3 s2 p1 op1 upsample -> (bilinear size-fix) -> skip concat ->
    1x1 fusion -> ResidualConvBlock (ref:src/stf_lstm_unet.py:38-68)."""

    def __init__(self, in_channels: int, skip_channels: int, features: int):
        super().__init__()
        self.up = ConvTranspose(in_channels, features)
        self.fusion = Conv2d(features + skip_channels, features, 1)
        self.res_conv = ResidualConvBlock(features, features)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = self.up(x)
        if x.shape[-2:] != skip.shape[-2:]:
            x = resize_bilinear_align_corners(x, skip.shape[-2],
                                              skip.shape[-1])
        return self.res_conv(self.fusion(torch.cat([x, skip], dim=1)))
