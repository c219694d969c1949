"""Mask-on-slice overlay rendering (counterpart of
stf_unet_tpu/viz/overlay.py; ref:train_utils/merge_tumor_images.py:94-180,
ref:test.py:52-82).

Alpha-blends a colored mask onto a grayscale slice with numpy and writes
it with PIL. The contour-only border needs cv2, which the port does not
use: `border_only=True` raises, as the JAX module does without cv2.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple, Union

import numpy as np


def _to_rgb(image: np.ndarray) -> np.ndarray:
    if image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        return np.repeat(image.reshape(*image.shape[:2], 1), 3, axis=2).copy()
    return image.copy()


def merge_images(image: np.ndarray, mask: np.ndarray,
                 color: Union[str, Sequence[int]] = (255, 0, 0),
                 alpha: float = 0.5, border_only: bool = False,
                 border_thickness: int = 2) -> np.ndarray:
    """Blend `mask` onto `image` (ref:merge_tumor_images.py:94-120).

    image: uint8 [H, W] or [H, W, 3]; mask: uint8 [H, W] (nonzero = tumor).
    """
    if border_only:
        raise RuntimeError("border_only overlay requires cv2")
    image = _to_rgb(np.asarray(image, dtype=np.uint8))
    mask = np.asarray(mask)
    if isinstance(color, str):
        color = tuple(int(c) for c in color.split(","))
    on = mask > 0
    merged = image.astype(np.float32)
    for c in range(3):
        merged[..., c] = np.where(
            on, image[..., c] * (1 - alpha) + color[c] * alpha,
            merged[..., c])
    return merged.astype(np.uint8)


def save_overlay(pred_mask: np.ndarray, raw_input: np.ndarray, save_dir: str,
                 tag: Union[int, str],
                 overlay_color: Tuple[int, int, int] = (0, 255, 0),
                 alpha: float = 0.5, prefix: str = "unet") -> str:
    """Overlay a predicted mask on the min-max normalized raw slice and
    save `<prefix>_<tag>.png` (ref:test.py:52-82; the reference's mask
    inversion at ref:test.py:76 is a bug not carried over: mask > 0.5 is
    tumor)."""
    from PIL import Image

    os.makedirs(save_dir, exist_ok=True)
    raw = np.asarray(raw_input, dtype=np.float32)
    if raw.ndim == 3:
        raw = raw[..., 0] if raw.shape[-1] == 1 else raw[0]
    raw = ((raw - raw.min()) / (raw.max() - raw.min() + 1e-8)
           * 255).astype(np.uint8)
    mask = (np.asarray(pred_mask) > 0.5).astype(np.uint8) * 255
    merged = merge_images(raw, mask, overlay_color, alpha=alpha)
    path = os.path.join(save_dir, f"{prefix}_{tag}.png")
    Image.fromarray(merged).save(path)
    return path
