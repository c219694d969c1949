"""The reference training step, plain PyTorch in float32: the
augmentation, the model's train-mode forward, the CE + dice loss, the
gradients and the AdamW apply at the warmup-poly schedule's lr.

Everything the port derives from the run's inputs is worked out again
here from the same inputs (the raw uint8 batches, the initial weights,
the run seed): the augmentation's draws (a CPU torch.Generator per step,
seeded by the hash of (seed, stream 1, epoch, step), as the port's
augmentation stream is defined), the warp's source coordinates, the
bilinear frames and nearest masks, the lr of each step. Nothing the
port computed is read.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from portbench.reference import nn as rnn

STREAM_AUGMENT = 1


def stream_seed(seed: int, stream_id: int, *fold: int) -> int:
    """A 63-bit seed hashed from (seed, stream_id, *fold) through numpy's
    SeedSequence: the augmentation stream's definition."""
    words = [int(seed), int(stream_id), *(int(v) for v in fold)]
    state = np.random.SeedSequence([w & 0xFFFFFFFF for w in words]
                                   + [len(words)]).generate_state(2)
    return int(state[0]) << 31 ^ int(state[1])


def shuffle_order(seed: int, epoch: int, n: int) -> np.ndarray:
    """The sample order of an epoch: numpy default_rng(seed + epoch)."""
    order = np.arange(n)
    np.random.default_rng(seed + epoch).shuffle(order)
    return order


def lr_at(step: int, aug_steps_per_epoch: int, optim: dict) -> float:
    """Linear warmup from warmup_factor to 1 over warmup_epochs epochs,
    then (1 - progress)^power to 0 at the last step."""
    warm = optim["warmup_epochs"] * aug_steps_per_epoch
    total = (optim["epochs"] - optim["warmup_epochs"]) * aug_steps_per_epoch
    x = float(step)
    if warm > 0 and x <= warm:
        a = x / warm
        return optim["lr"] * (optim["warmup_factor"] * (1 - a) + a)
    return optim["lr"] * max(1.0 - (x - warm) / max(total, 1), 0.0) \
        ** optim["poly_power"]


def _draws(gen: torch.Generator, bsz: int, aug: dict, src_h, src_w):
    """One batch's geometry: a short edge resized to an integer in
    [0.5, 1.2] x base_size, horizontal and vertical flips, a rotation in
    [-deg, deg] taken with its probability, a crop offset."""
    f32 = torch.float32
    lo, hi = int(0.5 * aug["base_size"]), int(1.2 * aug["base_size"])
    crop = aug["crop_size"]
    r = torch.randint(lo, hi + 1, (bsz,), generator=gen)
    u_hflip, u_vflip, u_rot, u_angle = torch.rand((4, bsz), generator=gen)
    u_crop = torch.rand((2, bsz), generator=gen)
    src_h, src_w = src_h.to(f32), src_w.to(f32)
    scale = r.to(f32) / torch.minimum(src_h, src_w)
    res_h, res_w = torch.round(src_h * scale), torch.round(src_w * scale)
    deg = aug["rotate_degrees"]
    angle = torch.where(u_rot < aug["rotate_prob"],
                        -deg + 2.0 * deg * u_angle,
                        torch.zeros_like(u_angle)) * (math.pi / 180.0)
    max_y0 = torch.clamp(res_h - crop, min=0.0)
    max_x0 = torch.clamp(res_w - crop, min=0.0)
    y0 = torch.minimum(torch.floor(u_crop[0] * (max_y0 + 1.0)), max_y0)
    x0 = torch.minimum(torch.floor(u_crop[1] * (max_x0 + 1.0)), max_x0)
    return (scale, res_h, res_w, u_hflip < aug["hflip_prob"],
            u_vflip < aug["vflip_prob"], angle, y0, x0)


def source_coords(draws, crop: int, device):
    """Output pixel centres -> source coordinates (gy, gx) [B, crop,
    crop]: the inverse of resize -> hflip -> vflip -> rotate about the
    resized image's centre -> crop, in float32."""
    scale, res_h, res_w, hflip, vflip, angle, y0, x0 = (
        v.to(device).view(-1, 1, 1) for v in draws)
    line = torch.arange(crop, dtype=torch.float32, device=device)
    py, px = line.view(-1, 1), line.view(1, -1)
    cy, cx = (res_h - 1.0) / 2.0, (res_w - 1.0) / 2.0
    cos_a, sin_a = torch.cos(angle), torch.sin(angle)
    one = torch.ones_like(res_h)
    sy = torch.where(vflip, -one, one)
    oy = torch.where(vflip, res_h - 1.0, torch.zeros_like(res_h))
    sx = torch.where(hflip, -one, one)
    ox = torch.where(hflip, res_w - 1.0, torch.zeros_like(res_w))
    ry, rx = py + y0, px + x0
    fy = cos_a * (ry - cy) + sin_a * (rx - cx) + cy
    fx = -sin_a * (ry - cy) + cos_a * (rx - cx) + cx
    inv = 1.0 / scale
    return (sy * fy + oy + 0.5) * inv - 0.5, (sx * fx + ox + 0.5) * inv - 0.5


def warp(frames: torch.Tensor, masks: torch.Tensor, sizes: torch.Tensor,
         gy: torch.Tensor, gx: torch.Tensor, alpha: float, beta: float
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilinear frames (four taps, a tap outside the valid size adds 0)
    times alpha plus beta, and the mask at the half-to-even rounded
    coordinate (0 outside the valid size)."""
    bsz, t, h, w = frames.shape
    ho, wo = gy.shape[1:]
    flat = frames.reshape(bsz, t, h * w).float()
    vh = sizes[:, 0].float().view(bsz, 1, 1)
    vw = sizes[:, 1].float().view(bsz, 1, 1)

    def tap(yy, xx):
        inside = (yy >= 0) & (yy <= vh - 1) & (xx >= 0) & (xx <= vw - 1)
        idx = (yy.clamp(0, h - 1).long() * w + xx.clamp(0, w - 1).long())
        vals = flat.gather(2, idx.view(bsz, 1, ho * wo).expand(bsz, t, -1))
        return vals.view(bsz, t, ho, wo) * inside.unsqueeze(1).float()

    y0, x0 = torch.floor(gy), torch.floor(gx)
    wy, wx = (gy - y0).unsqueeze(1), (gx - x0).unsqueeze(1)
    bil = (tap(y0, x0) * (1 - wy) * (1 - wx) + tap(y0, x0 + 1) * (1 - wy) * wx
           + tap(y0 + 1, x0) * wy * (1 - wx) + tap(y0 + 1, x0 + 1) * wy * wx)
    ry, rx = torch.round(gy), torch.round(gx)
    inside = (ry >= 0) & (ry <= vh - 1) & (rx >= 0) & (rx <= vw - 1)
    idx = ry.clamp(0, h - 1).long() * w + rx.clamp(0, w - 1).long()
    near = masks.reshape(bsz, h * w).float().gather(
        1, idx.view(bsz, ho * wo)).view(bsz, ho, wo)
    near = torch.where(inside, near, torch.zeros_like(near))
    return bil * alpha + beta, near.long()


def augment(seed: int, epoch: int, step: int, frames, masks, sizes,
            aug: dict):
    """(images [B, T, crop, crop, 1], targets [B, crop, crop]) of one
    step's uint8 batch on its device."""
    gen = torch.Generator().manual_seed(
        stream_seed(seed, STREAM_AUGMENT, epoch, step))
    sizes_cpu = sizes.cpu()
    draws = _draws(gen, frames.shape[0], aug, sizes_cpu[:, 0],
                   sizes_cpu[:, 1])
    gy, gx = source_coords(draws, aug["crop_size"], frames.device)
    images, targets = warp(frames, masks, sizes.to(frames.device), gy, gx,
                           1.0 / (255.0 * aug["std"]),
                           -aug["mean"] / aug["std"])
    return images.unsqueeze(-1), targets


def loss_fn(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy averaged over the pixels, plus 1 - the mean
    over classes of the per-image soft dice averaged over the batch."""
    nc = logits.shape[-1]
    logp = torch.log_softmax(logits, -1)
    ce = -logp.gather(-1, targets.unsqueeze(-1)).mean()
    probs = logp.exp().reshape(logits.shape[0], -1, nc)
    onehot = torch.nn.functional.one_hot(targets, nc).float().reshape(
        logits.shape[0], -1, nc)
    inter = (probs * onehot).sum(1)
    sets = probs.sum(1) + onehot.sum(1)
    sets = torch.where(sets == 0, 2 * inter, sets)
    dice = ((2 * inter + 1e-6) / (sets + 1e-6)).mean(0).mean()
    return ce + 1.0 - dice


def adamw_(params: Dict[str, torch.Tensor], grads, m, v, t: int, lr: float,
           optim: dict) -> None:
    """torch.optim.AdamW's update, in place: decoupled weight decay, then
    the bias-corrected moments, eps outside the square root."""
    b1, b2 = optim["beta1"], optim["beta2"]
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k]
            p.mul_(1 - lr * optim["weight_decay"])
            m[k].lerp_(g, 1 - b1)
            v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v[k].sqrt() / math.sqrt(bc2)).add_(optim["eps"])
            p.addcdiv_(m[k], denom, value=-lr / bc1)


def train_steps(forward: Callable, arch: dict, weights: Dict[str, torch.Tensor],
                trainable: Sequence[str], batches: List[tuple],
                positions: Sequence[Tuple[int, int]], seed: int, aug: dict,
                optim: dict, steps_per_epoch: int, q: rnn.Quant = None,
                cast: torch.dtype = None, moments=None, t0: int = 0):
    """Run one step per batch from `weights` (parameters and BN buffers by
    name), batch i at positions[i] = (epoch, step in the epoch), which
    sets its augmentation draws and its lr. `moments` (m, v) and `t0`
    (AdamW's step count) resume an optimizer; by default it starts
    fresh. Returns (losses, the first step's gradients, the parameters
    after the last step), all float32. `cast` (a witness, not the
    reference) computes the forward in that dtype: the input and every
    weight but BatchNorm's cast to it, as the port computes."""
    params = {k: weights[k].detach().clone().float().requires_grad_(True)
              for k in trainable}
    fixed = {k: t for k, t in weights.items() if k not in params}
    if moments is None:
        m = {k: torch.zeros_like(p) for k, p in params.items()}
        v = {k: torch.zeros_like(p) for k, p in params.items()}
    else:
        m = {k: moments[0][k].detach().clone().float() for k in params}
        v = {k: moments[1][k].detach().clone().float() for k in params}
    losses, first = [], None
    with rnn.exact_float32():
        for i, ((frames, masks, sizes), (epoch, step)) in enumerate(
                zip(batches, positions)):
            images, targets = augment(seed, epoch, step, frames, masks,
                                      sizes, aug)
            p = {**fixed, **params}
            if cast is not None:
                bn = {k.rsplit(".", 1)[0] for k in p
                      if k.endswith(".running_mean")}
                p = {k: v if k.rsplit(".", 1)[0] in bn else v.to(cast)
                     for k, v in p.items()}
                images = images.to(cast)
            logits = forward(p, images, arch, True, q)
            loss = loss_fn(logits, targets)
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
            losses.append(float(loss.detach()))
            if first is None:
                first = {k: g.detach().clone() for k, g in grads.items()}
            adamw_(params, grads, m, v, t0 + i + 1,
                   lr_at(epoch * steps_per_epoch + step, steps_per_epoch,
                         optim), optim)
            del grads, logits, loss, images, targets
    return losses, first, {k: p.detach() for k, p in params.items()}
