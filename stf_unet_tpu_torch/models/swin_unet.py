"""Swin-Unet (Cao et al., "Swin-Unet: Unet-like Pure Transformer for
Medical Image Segmentation", arXiv:2105.05537; github.com/HuCaoFighting/
Swin-Unet, configs/swin_tiny_patch4_window7_224_lite.yaml), with the T
frames (and, with PK maps, the maps after them) as input channels
(input_format="flat_channels": [B, H, W, T*C]).

  * Patch embedding: a 4x4 stride-4 conv in_chans -> C, then LayerNorm.
  * Encoder: four stages at img/4, /8, /16, /32 tokens a side, widths
    C * (1, 2, 4, 8), `depths` Swin blocks each, alternately unshifted
    and shifted by window // 2 (a stage no wider than the window takes
    the whole map as its window and never shifts). Patch merging after
    the first three: the 2x2 neighbours' concatenation (x[0::2, 0::2],
    x[1::2, 0::2], x[0::2, 1::2], x[1::2, 1::2]), LayerNorm(4C), a Linear
    4C -> 2C without bias. LayerNorm(8C) at the end.
  * Swin block: x += DropPath(WindowAttention(LN1(x))), then x +=
    DropPath(fc2(GELU(fc1(LN2(x))))) with an MLP ratio of 4
    (ops/window_attention: qkv with bias, the relative-position bias).
  * Decoder: a patch expand (Linear 8C -> 16C without bias, a 2x2
    rearrangement, LayerNorm(4C)), then three stages at img/16, /8, /4:
    the encoder's input to that stage concatenated, a Linear 2C -> C,
    `depths[stage]` Swin blocks (the source's BasicLayer_up takes the
    encoder stage's depth), a patch expand after the first two.
    LayerNorm(C), then the final 4x expand (Linear C -> 16C without bias,
    a 4x4 rearrangement, LayerNorm(C)) and a 1x1 conv head without bias.

Stochastic depth: `drop_path_rate` spreads linearly over the encoder's
blocks, the decoder's stages taking the rates of their encoder stage;
in train mode each residual branch is kept per sample with probability
1 - p, drawn on the device, and scaled by 1 / (1 - p). No absolute
position embedding, no dropout.

An input whose side is not `img_size` is resized to it (bilinear,
align_corners=True) and the logits are resized back, as the source's
test does.

Parameters and their names are the source's (`layers.0.blocks.1.attn.
qkv.weight`, ...); the relative-position index and the region masks are
non-persistent buffers. Dtype policy, as the port's other models:
parameters stay float32 and are cast on use to `dtype`, the compute
dtype; LayerNorm takes its statistics in float32 (PyTorch's kernels
accumulate a bfloat16 input's mean and variance in float32). The logits
come back float32 [B, H, W, num_classes].
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from stf_unet_tpu_torch.ops.conv import Conv2d
from stf_unet_tpu_torch.ops.resize import resize_bilinear_align_corners
from stf_unet_tpu_torch.ops.window_attention import (region_mask,
                                                     relative_position_index,
                                                     window_attention)


class Linear(nn.Linear):
    """nn.Linear computing in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype))


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm (eps 1e-5) over the last axis, in its input's
    dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape,
                            self.weight.to(x.dtype), self.bias.to(x.dtype),
                            self.eps)


def drop_path(x: torch.Tensor, p: float, training: bool) -> torch.Tensor:
    """Each sample's x kept with probability 1 - p (a device draw) and
    scaled by 1 / (1 - p); the identity out of training or at p = 0."""
    if p <= 0.0 or not training:
        return x
    keep = 1.0 - p
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = torch.empty(shape, device=x.device,
                       dtype=torch.float32).bernoulli_(keep)
    return x * (mask / keep).to(x.dtype)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window: int, heads: int):
        super().__init__()
        self.window, self.heads = window, heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer("relative_position_index",
                             relative_position_index(window),
                             persistent=False)
        self.qkv = Linear(dim, 3 * dim, bias=True)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor, shift: int,
                shift_mask: Optional[torch.Tensor]) -> torch.Tensor:
        return window_attention(
            x, self.qkv.weight, self.qkv.bias, self.proj.weight,
            self.proj.bias, self.relative_position_bias_table,
            self.relative_position_index, self.heads, self.window, shift,
            shift_mask)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, resolution: int, heads: int, window: int,
                 shift: int, mlp_ratio: float, drop_path_rate: float):
        super().__init__()
        if resolution <= window:
            window, shift = resolution, 0
        self.shift = shift
        self.drop_path_rate = drop_path_rate
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, window, heads)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.register_buffer(
            "shift_mask", region_mask(resolution, resolution, window, shift)
            if shift else None, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p, training = self.drop_path_rate, self.training
        x = x + drop_path(self.attn(self.norm1(x), self.shift,
                                    self.shift_mask), p, training)
        return x + drop_path(self.mlp(self.norm2(x)), p, training)


def _blocks(dim: int, resolution: int, depth: int, heads: int, window: int,
            mlp_ratio: float, rates: Sequence[float]) -> nn.ModuleList:
    return nn.ModuleList(
        SwinBlock(dim, resolution, heads, window,
                  0 if i % 2 == 0 else window // 2, mlp_ratio, rates[i])
        for i in range(depth))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x))


class PatchExpand(nn.Module):
    """Linear dim -> scale^2 * out_dim without bias, each token's
    features split into a scale x scale block of tokens of `out_dim`
    channels ('b h w (p1 p2 c) -> b (h p1) (w p2) c'), then
    LayerNorm(out_dim). The decoder's 2x expand has out_dim = dim / 2,
    the final 4x out_dim = dim."""

    def __init__(self, dim: int, scale: int, out_dim: int):
        super().__init__()
        self.scale = scale
        self.expand = Linear(dim, scale * scale * out_dim, bias=False)
        self.norm = LayerNorm(out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        s = self.scale
        x = self.expand(x).view(b, h, w, s, s, -1)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, h * s, w * s, -1)
        return self.norm(x)


class PatchEmbed(nn.Module):
    def __init__(self, in_chans: int, dim: int, patch: int):
        super().__init__()
        self.proj = Conv2d(in_chans, dim, patch, stride=patch)
        self.norm = LayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return self.norm(x)


class EncoderStage(nn.Module):
    def __init__(self, dim: int, resolution: int, depth: int, heads: int,
                 window: int, mlp_ratio: float, rates: Sequence[float],
                 merge: bool):
        super().__init__()
        self.blocks = _blocks(dim, resolution, depth, heads, window,
                              mlp_ratio, rates)
        self.downsample = PatchMerging(dim) if merge else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x if self.downsample is None else self.downsample(x)


class DecoderStage(nn.Module):
    def __init__(self, dim: int, resolution: int, depth: int, heads: int,
                 window: int, mlp_ratio: float, rates: Sequence[float],
                 expand: bool):
        super().__init__()
        self.blocks = _blocks(dim, resolution, depth, heads, window,
                              mlp_ratio, rates)
        self.upsample = PatchExpand(dim, 2, dim // 2) if expand else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x if self.upsample is None else self.upsample(x)


class SwinUNet(nn.Module):
    input_format = "flat_channels"

    def __init__(self, in_chans: int = 8, num_classes: int = 2,
                 img_size: int = 224, patch_size: int = 4,
                 embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.img_size = img_size
        self.compute_dtype = dtype
        stages = len(depths)
        grid = img_size // patch_size
        dims = [embed_dim * 2 ** i for i in range(stages)]
        res = [grid >> i for i in range(stages)]
        if grid % 2 ** (stages - 1) or any(
                r > window_size and r % window_size for r in res):
            raise ValueError(f"img_size {img_size} / patch {patch_size}: "
                             f"the stages' maps {res} must halve evenly "
                             f"and tile into {window_size}^2 windows")
        rates = torch.linspace(0, drop_path_rate, sum(depths)).tolist()
        spans = [rates[sum(depths[:i]):sum(depths[:i + 1])]
                 for i in range(stages)]
        self.patch_embed = PatchEmbed(in_chans, embed_dim, patch_size)
        self.layers = nn.ModuleList(
            EncoderStage(dims[i], res[i], depths[i], num_heads[i],
                         window_size, mlp_ratio, spans[i],
                         merge=i < stages - 1)
            for i in range(stages))
        self.norm = LayerNorm(dims[-1])
        up: List[nn.Module] = [PatchExpand(dims[-1], 2, dims[-1] // 2)]
        concat: List[nn.Module] = [nn.Identity()]
        for j in range(1, stages):
            i = stages - 1 - j
            up.append(DecoderStage(dims[i], res[i], depths[i], num_heads[i],
                                   window_size, mlp_ratio, spans[i],
                                   expand=j < stages - 1))
            concat.append(Linear(2 * dims[i], dims[i]))
        self.layers_up = nn.ModuleList(up)
        self.concat_back_dim = nn.ModuleList(concat)
        self.norm_up = LayerNorm(embed_dim)
        self.up = PatchExpand(embed_dim, patch_size, embed_dim)
        self.output = Conv2d(embed_dim, num_classes, 1, bias=False)
        self.apply(_init_weights)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: [B, H, W, Cin] -> {"out": float32 logits [B, H, W,
        num_classes]}."""
        x = x.to(self.compute_dtype)
        height, width = x.shape[1:3]
        size = self.img_size
        resized = (height, width) != (size, size)
        if resized:
            x = resize_bilinear_align_corners(
                x.permute(0, 3, 1, 2), size, size).permute(0, 2, 3, 1)
        x = self.patch_embed(x)
        skips = []
        for layer in self.layers:
            skips.append(x)
            x = layer(x)
        x = self.norm(x)
        stages = len(self.layers)
        for j, layer in enumerate(self.layers_up):
            if j > 0:
                x = self.concat_back_dim[j](
                    torch.cat([x, skips[stages - 1 - j]], -1))
            x = layer(x)
        x = self.up(self.norm_up(x))
        out = self.output(x.permute(0, 3, 1, 2)).float()
        if resized:
            out = resize_bilinear_align_corners(out, height, width)
        return {"out": out.permute(0, 2, 3, 1)}


def _init_weights(m: nn.Module) -> None:
    """The source's initialisation: truncated normal (std 0.02) Linear
    weights and bias tables, zero biases, LayerNorm weight 1, bias 0."""
    if isinstance(m, nn.Linear):
        nn.init.trunc_normal_(m.weight, std=0.02)
        if m.bias is not None:
            nn.init.zeros_(m.bias)
    elif isinstance(m, nn.LayerNorm):
        nn.init.ones_(m.weight)
        nn.init.zeros_(m.bias)
    elif isinstance(m, WindowAttention):
        nn.init.trunc_normal_(m.relative_position_bias_table, std=0.02)
