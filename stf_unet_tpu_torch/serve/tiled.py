"""Tiled (sliding-window) native-resolution inference (counterpart of
stf_unet_tpu/serve/tiled.py).

The reference segments only at the resized training geometry: its eval
path short-edge-resizes every volume to crop_size (ref:train.py:70-74).
This module segments at native resolution with the model still running at
its trained tile geometry:

  * the volume is normalized on the device and, where it is smaller than
    the tile, edge-padded; overlapping tiles are cut at static offsets
    (`plan_tiles`) and run through the model in chunks of MAX_TILE_BATCH;
  * tile logits are blended with a Gaussian importance window
    (sigma = 0.125 * tile, the nnU-Net recipe: conv zero-padding makes
    tile borders the least trustworthy) into a float32 accumulator, under
    any compute dtype; the per-pixel weight sum is positive and the same
    for every class, so argmax of the accumulator is the blended argmax and
    it is never divided;
  * the argmax comes back as an int32 [H, W] mask, cropped to the input.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from stf_unet_tpu_torch.core.config import resolve_device
from stf_unet_tpu_torch.data.transforms import normalize
from stf_unet_tpu_torch.models.registry import preprocess_input

# Tiles run through the model this many at a time.
MAX_TILE_BATCH = 16


def plan_tiles(size: int, tile: int, stride: int) -> Tuple[int, ...]:
    """1-D tile offsets covering [0, size): start every `stride` px, and
    keep the last tile flush with the edge. Requires size >= tile (pad
    smaller inputs first)."""
    if size < tile:
        raise ValueError(f"size {size} < tile {tile}; pad the input first")
    offs = list(range(0, size - tile + 1, max(int(stride), 1)))
    if offs[-1] != size - tile:
        offs.append(size - tile)
    return tuple(offs)


def gaussian_window(tile: int, sigma_frac: float = 0.125,
                    floor: float = 1e-4) -> np.ndarray:
    """[tile, tile] float32 separable Gaussian importance map, peak 1 at
    the center, floored away from exact zero so single-coverage corner
    pixels keep finite weight."""
    sigma = max(float(sigma_frac) * tile, 1e-6)
    d = (np.arange(tile, dtype=np.float64) - (tile - 1) / 2.0) / sigma
    g = np.exp(-0.5 * d * d)
    w = np.maximum(np.outer(g, g), floor)
    return w.astype(np.float32)


def _chunks(seq: Sequence, n: int):
    for i in range(0, len(seq), n):
        yield seq[i:i + n]


class TiledPredictor:
    """Native-resolution argmax segmentation via overlapping tiles.

    predict() takes one volume, uint8 [T(+pk), H, W, 1] (the per-sample
    layout of InferenceEngine.predict), and returns an int32 [H, W] mask.
    `model` is an eval-mode module on `device`.
    """

    def __init__(self, model, mean: float, std: float, tile: int = 224,
                 overlap: float = 0.5, device="cuda"):
        if not 0.0 <= float(overlap) < 1.0:
            raise ValueError(f"overlap must be in [0, 1), got {overlap}")
        self.model = model
        self.mean = float(mean)
        self.std = float(std)
        self.tile = int(tile)
        self.stride = max(int(round(self.tile * (1.0 - float(overlap)))), 1)
        self.device = resolve_device(device)
        self.window = torch.from_numpy(gaussian_window(self.tile)).to(
            self.device)[:, :, None]

    @torch.inference_mode()
    def predict(self, image: np.ndarray) -> np.ndarray:
        """uint8 [T(+pk), H, W, 1] -> int32 [H, W] native-resolution
        mask."""
        if image.ndim != 4 or image.shape[-1] != 1:
            raise ValueError(
                f"expected [T, H, W, 1], got shape {image.shape}")
        _, h, w, _ = image.shape
        tile = self.tile
        ph, pw = max(tile - h, 0), max(tile - w, 0)
        x = torch.from_numpy(np.ascontiguousarray(image)).to(self.device)
        x = normalize(x, self.mean, self.std)  # [T, H, W, 1] f32
        if ph or pw:  # edge-replicate: pad the [T, 1, H, W] view
            x = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph),
                      mode="replicate").permute(0, 2, 3, 1)
        offsets = [(y, xo) for y in plan_tiles(h + ph, tile, self.stride)
                   for xo in plan_tiles(w + pw, tile, self.stride)]
        acc = torch.zeros((h + ph, w + pw, int(self.model.num_classes)),
                          dtype=torch.float32, device=self.device)
        for group in _chunks(offsets, MAX_TILE_BATCH):
            tiles = torch.stack([x[:, y:y + tile, xo:xo + tile, :]
                                 for (y, xo) in group])  # [n, T, t, t, 1]
            logits = self.model(preprocess_input(
                tiles, self.model))["out"].to(torch.float32)
            for i, (y, xo) in enumerate(group):
                acc[y:y + tile, xo:xo + tile, :] += logits[i] * self.window
        mask = torch.argmax(acc[:h, :w, :], dim=-1)
        return mask.to(torch.int32).cpu().numpy()
