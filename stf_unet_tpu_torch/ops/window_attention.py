"""Shifted-window multi-head self-attention of a Swin block (Liu et al.,
arXiv:2103.14030; as Swin-Unet, arXiv:2105.05537, runs it).

`window_attention(x, ...)` is one block's whole attention: the LayerNorm's
output [B, H, W, C] in, the projected output [B, H, W, C] out.

  * a shifted block rolls the map by -shift on both axes first, and by
    +shift after;
  * the map is cut into (H/ws) x (W/ws) windows of N = ws^2 tokens, in
    row-major window order;
  * qkv is one Linear C -> 3C, heads of C / heads channels;
  * the windows are folded into the head axis, so that one SDPA call
    runs [B, nW * heads, N, head_dim] with one additive mask [1, nW *
    heads, N, N], broadcast over the batch: the relative-position bias,
    gathered from its table by the fixed index, plus (shifted blocks)
    the region mask, -100 between tokens that the roll brought from
    different regions of the map;
  * the heads are joined, projected (Linear C -> C) and put back in
    place.

Scale head_dim^-0.5 (SDPA's default). Parameters are float32 and cast to
x's dtype on use; the bias table's gradient flows back through the
mask. `window_attention.launches` counts the calls (train/step_graph
counts what a replay launches through it), and each call is an
`annotate("window_attention")` span.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from stf_unet_tpu_torch.utils.profiling import annotate

# the logit added between tokens of different regions of a shifted map
REGION_MASK = -100.0


def relative_position_index(window: int) -> torch.Tensor:
    """[N, N] int64, N = window^2: the bias table's row of each (query,
    key) pair, (dh + ws - 1) * (2 ws - 1) + (dw + ws - 1), with dh and dw
    the query's row and column minus the key's."""
    coords = torch.stack(torch.meshgrid(torch.arange(window),
                                        torch.arange(window),
                                        indexing="ij")).flatten(1)
    rel = coords[:, :, None] - coords[:, None, :] + (window - 1)
    return rel[0] * (2 * window - 1) + rel[1]


def region_mask(height: int, width: int, window: int,
                shift: int) -> torch.Tensor:
    """[nW, N, N] float32: 0 between two tokens of a window that came
    from the same region of the map rolled by -shift, REGION_MASK
    otherwise (the source's slices: the map split at -window and -shift
    on each axis)."""
    img = torch.zeros(height, width)
    cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    region = 0
    for hs in cuts:
        for ws in cuts:
            img[hs, ws] = region
            region += 1
    windows = partition(img[None, :, :, None], window).flatten(1)
    diff = windows[:, None, :] - windows[:, :, None]
    return torch.where(diff != 0, REGION_MASK, 0.0)


def partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * nW, N, C], windows in row-major order."""
    b, h, w, c = x.shape
    x = x.view(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def reverse(windows: torch.Tensor, window: int, height: int,
            width: int) -> torch.Tensor:
    """partition's inverse: [B * nW, N, C] -> [B, H, W, C]."""
    c = windows.shape[-1]
    x = windows.view(-1, height // window, width // window, window, window,
                     c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, height, width, c)


def attention_mask(bias_table: torch.Tensor, index: torch.Tensor,
                   shift_mask: Optional[torch.Tensor], n_windows: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """[1, nW * heads, N, N] in `dtype`: each head's relative-position
    bias, plus each window's region mask where the block is shifted."""
    n = index.shape[0]
    heads = bias_table.shape[1]
    bias = bias_table[index.reshape(-1)].view(n, n, heads).permute(2, 0, 1)
    if shift_mask is None:
        mask = bias.unsqueeze(0).expand(n_windows, heads, n, n)
    else:
        mask = bias.unsqueeze(0) + shift_mask.unsqueeze(1)
    return mask.reshape(1, n_windows * heads, n, n).to(dtype)


def window_attention(x: torch.Tensor, qkv_weight: torch.Tensor,
                     qkv_bias: Optional[torch.Tensor],
                     proj_weight: torch.Tensor,
                     proj_bias: Optional[torch.Tensor],
                     bias_table: torch.Tensor, index: torch.Tensor,
                     heads: int, window: int, shift: int = 0,
                     shift_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """x [B, H, W, C] (the block's LayerNorm output, in the compute
    dtype) -> the attention's projected output, [B, H, W, C]. `shift`
    > 0 needs its `shift_mask` (region_mask)."""
    with annotate("window_attention"):
        b, h, w, c = x.shape
        dt = x.dtype
        if shift:
            x = torch.roll(x, (-shift, -shift), (1, 2))
        n = window * window
        n_windows = (h // window) * (w // window)
        qkv = F.linear(partition(x, window), qkv_weight.to(dt),
                       None if qkv_bias is None else qkv_bias.to(dt))
        qkv = qkv.view(b, n_windows, n, 3, heads, c // heads)
        q, k, v = qkv.permute(3, 0, 1, 4, 2, 5).reshape(
            3, b, n_windows * heads, n, c // heads).unbind(0)
        mask = attention_mask(bias_table, index, shift_mask, n_windows, dt)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        out = out.view(b, n_windows, heads, n, c // heads).permute(
            0, 1, 3, 2, 4).reshape(b * n_windows, n, c)
        out = F.linear(out, proj_weight.to(dt),
                       None if proj_bias is None else proj_bias.to(dt))
        out = reverse(out, window, h, w)
        if shift:
            out = torch.roll(out, (shift, shift), (1, 2))
        window_attention.launches += 1
        return out


window_attention.launches = 0
