"""Swin-Unet, plain PyTorch, from the published description (Cao et al.,
arXiv:2105.05537; github.com/HuCaoFighting/Swin-Unet networks/
swin_transformer_unet_skip_expand_decoder_sys.py, configs/
swin_tiny_patch4_window7_224_lite.yaml), over a dict of float32 tensors
named as the source's state_dict. The T frames enter as T channels.

Written out as the source computes it: explicit matrix products, the
softmax over q k^T * head_dim^-0.5 plus the relative-position bias
gathered from its table by the source's index, plus (shifted blocks) the
source's region mask, built from its slices, after torch.roll by
-window // 2; the windows partitioned and reversed by view / permute;
LayerNorm from its mean and biased variance (eps 1e-5); GELU (erf).
Patch merging, the 2x and 4x patch expands, the skip concatenations and
linears, the 1x1 head, as the source's SwinTransformerSys. Stochastic
depth is left out: the benchmark trains at drop_path_rate 0, where it is
the identity. An input whose side is not `img_size` is resized to it and
the logits back (bilinear, align_corners=True), as the source's test
resizes.

`q` (the precision under test, reference/nn) takes every product's
operands and result, each LayerNorm's output and the convolutions, as
the UNet reference applies it."""

from __future__ import annotations

import torch

from portbench.reference import nn as rnn

LN_EPS = 1e-5


def _q(q: rnn.Quant, x: torch.Tensor) -> torch.Tensor:
    return x if q is None else q(x)


def linear(x, p: dict, name: str, q: rnn.Quant = None):
    y = _q(q, x) @ _q(q, p[f"{name}.weight"]).t()
    bias = p.get(f"{name}.bias")
    return _q(q, y if bias is None else y + bias)


def layer_norm(x, p: dict, name: str, q: rnn.Quant = None):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    y = (x - mean) / torch.sqrt(var + LN_EPS)
    return _q(q, y * p[f"{name}.weight"] + p[f"{name}.bias"])


def relative_position_index(ws: int, device) -> torch.Tensor:
    """The source's WindowAttention.relative_position_index."""
    coords = torch.stack(torch.meshgrid([torch.arange(ws, device=device),
                                         torch.arange(ws, device=device)],
                                        indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).clone()
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def window_partition(x, ws: int):
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, c)


def window_reverse(windows, ws: int, h: int, w: int):
    b = int(windows.shape[0] / (h * w / ws / ws))
    x = windows.view(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def shift_mask(h: int, w: int, ws: int, shift: int, device):
    """The source's SwinTransformerBlock.attn_mask: [nW, N, N]."""
    img_mask = torch.zeros((1, h, w, 1), device=device)
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for wsl in slices:
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    mask_windows = window_partition(img_mask, ws).view(-1, ws * ws)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, -100.0).masked_fill(
        attn_mask == 0, 0.0)


def attention(x, p: dict, name: str, heads: int, ws: int, mask,
              q: rnn.Quant):
    """WindowAttention over windows x [B_, N, C]."""
    b_, n, c = x.shape
    qkv = linear(x, p, f"{name}.qkv", q).reshape(
        b_, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    qq, k, v = qkv[0], qkv[1], qkv[2]
    qq = qq * (c // heads) ** -0.5
    attn = _q(q, _q(q, qq) @ _q(q, k).transpose(-2, -1))
    index = relative_position_index(ws, x.device)
    bias = p[f"{name}.relative_position_bias_table"][index.view(-1)].view(
        n, n, -1).permute(2, 0, 1)
    attn = attn + bias.unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.view(b_ // nw, nw, heads, n, n) \
            + mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    out = _q(q, _q(q, attn) @ _q(q, v)).transpose(1, 2).reshape(b_, n, c)
    return linear(out, p, f"{name}.proj", q)


def block(x, p: dict, name: str, res: int, heads: int, ws: int,
          shift: int, q: rnn.Quant):
    """SwinTransformerBlock on x [B, H, W, C]."""
    if res <= ws:
        ws, shift = res, 0
    b, h, w, c = x.shape
    shortcut = x
    x = layer_norm(x, p, f"{name}.norm1", q)
    if shift > 0:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    windows = window_partition(x, ws).view(-1, ws * ws, c)
    mask = shift_mask(h, w, ws, shift, x.device).to(x.dtype) \
        if shift > 0 else None
    windows = attention(windows, p, f"{name}.attn", heads, ws, mask, q)
    x = window_reverse(windows.view(-1, ws, ws, c), ws, h, w)
    if shift > 0:
        x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
    x = shortcut + x
    y = layer_norm(x, p, f"{name}.norm2", q)
    y = linear(torch.nn.functional.gelu(linear(y, p, f"{name}.mlp.fc1", q)),
               p, f"{name}.mlp.fc2", q)
    return x + y


def blocks(x, p: dict, name: str, depth: int, res: int, heads: int, ws: int,
           q: rnn.Quant):
    for i in range(depth):
        x = block(x, p, f"{name}.blocks.{i}", res, heads, ws,
                  0 if i % 2 == 0 else ws // 2, q)
    return x


def patch_merging(x, p: dict, name: str, q: rnn.Quant):
    x0 = x[:, 0::2, 0::2, :]
    x1 = x[:, 1::2, 0::2, :]
    x2 = x[:, 0::2, 1::2, :]
    x3 = x[:, 1::2, 1::2, :]
    x = layer_norm(torch.cat([x0, x1, x2, x3], -1), p, f"{name}.norm", q)
    return linear(x, p, f"{name}.reduction", q)


def patch_expand(x, p: dict, name: str, scale: int, q: rnn.Quant):
    """'b h w (p1 p2 c) -> b (h p1) (w p2) c' after the expand Linear,
    then LayerNorm."""
    b, h, w, _ = x.shape
    x = linear(x, p, f"{name}.expand", q)
    c = x.shape[-1] // (scale * scale)
    x = x.view(b, h, w, scale, scale, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, h * scale, w * scale, c)
    return layer_norm(x, p, f"{name}.norm", q)


def forward(p: dict, x: torch.Tensor, arch: dict, train: bool,
            q: rnn.Quant = None) -> torch.Tensor:
    """x [B, T, H, W, 1] normalized frames -> float32 logits
    [B, H, W, num_classes]."""
    size, patch = arch["img_size"], arch["patch_size"]
    ws, depths, heads = (arch["window_size"], arch["depths"],
                         arch["num_heads"])
    stages = len(depths)
    height, width = x.shape[2:4]
    h = x[..., 0]  # [B, T, H, W]: the frames as channels
    resized = (height, width) != (size, size)
    if resized:
        h = rnn.resize_align_corners(h, size, size)
    h = rnn.conv(h, p["patch_embed.proj.weight"], p["patch_embed.proj.bias"],
                 patch, 0, q).permute(0, 2, 3, 1)
    h = layer_norm(h, p, "patch_embed.norm", q)
    res = [size // patch >> i for i in range(stages)]
    skips = []
    for i in range(stages):
        skips.append(h)
        h = blocks(h, p, f"layers.{i}", depths[i], res[i], heads[i], ws, q)
        if i < stages - 1:
            h = patch_merging(h, p, f"layers.{i}.downsample", q)
    h = layer_norm(h, p, "norm", q)
    h = patch_expand(h, p, "layers_up.0", 2, q)
    for j in range(1, stages):
        i = stages - 1 - j
        h = linear(torch.cat([h, skips[i]], -1), p, f"concat_back_dim.{j}", q)
        h = blocks(h, p, f"layers_up.{j}", depths[i], res[i], heads[i], ws,
                   q)
        if j < stages - 1:
            h = patch_expand(h, p, f"layers_up.{j}.upsample", 2, q)
    h = layer_norm(h, p, "norm_up", q)
    h = patch_expand(h, p, "up", patch, q)
    out = rnn.conv(h.permute(0, 3, 1, 2), p["output.weight"], None, 1, 0, q)
    if resized:
        out = rnn.resize_align_corners(out, height, width)
    return out.permute(0, 2, 3, 1).float()
