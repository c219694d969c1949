"""Prediction dumps + original/GT/pred comparison strips (counterpart of
stf_unet_tpu/viz/comparison.py; ref:train_utils/visualize.py:53-143).
PIL only."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
from PIL import Image, ImageDraw, ImageFont


def save_predictions(predictions: np.ndarray, save_dir: str,
                     base_name: str = "pred", threshold: float = 0.5) -> None:
    """Thresholded mask PNGs per batch element (ref:visualize.py:53-67).
    predictions: [B, H, W] or [B, 1, H, W] float."""
    os.makedirs(save_dir, exist_ok=True)
    preds = np.asarray(predictions)
    if preds.ndim == 4:
        preds = preds[:, 0]
    for i, p in enumerate(preds):
        img = ((p > threshold) * 255).astype(np.uint8)
        Image.fromarray(img).save(
            os.path.join(save_dir, f"{base_name}_{i:03d}.png"))


def save_comparison(pred_mask, gt_mask, raw_input, save_dir: str,
                    base_name: str = "sample", idx: int = 0,
                    dice_score: Optional[float] = None,
                    iou_score: Optional[float] = None) -> str:
    """Original | GT | prediction triptych with titles and a dice/IoU footer
    (ref:visualize.py:69-143)."""
    os.makedirs(save_dir, exist_ok=True)
    idx_str = f"{idx:03d}"

    raw = np.asarray(raw_input, dtype=np.float32)
    if raw.ndim == 3:
        # [C,H,W] or [H,W,C]: average the channel axis (ref:86-92)
        ch_axis = 0 if raw.shape[0] < raw.shape[-1] else -1
        raw = raw.mean(axis=ch_axis) if raw.shape[ch_axis] > 1 else (
            raw[0] if ch_axis == 0 else raw[..., 0])
    raw = (raw - raw.min()) / (raw.max() - raw.min() + 1e-5) * 255
    img = Image.fromarray(raw.astype(np.uint8)).convert("L")

    if gt_mask is not None:
        gt = (np.asarray(gt_mask, dtype=np.float32) * 255).clip(0, 255)
        gt_img = Image.fromarray(gt.astype(np.uint8)).convert("L")
    else:
        gt_img = Image.new("L", img.size)

    pred = (np.asarray(pred_mask, dtype=np.float32) * 255).clip(0, 255)
    pred_img = Image.fromarray(pred.astype(np.uint8)).convert("L")

    header, footer, pad = 40, 30, 20
    canvas = Image.new(
        "RGB", (img.width * 3 + pad * 2, img.height + header + footer),
        color=(255, 255, 255))
    canvas.paste(img.convert("RGB"), (0, header))
    canvas.paste(gt_img.convert("RGB"), (img.width + pad, header))
    canvas.paste(pred_img.convert("RGB"), (img.width * 2 + pad * 2, header))

    draw = ImageDraw.Draw(canvas)
    try:
        font = ImageFont.truetype("arial.ttf", size=16)
    except OSError:
        font = ImageFont.load_default()
    for i, title in enumerate(["Original", "Ground Truth", "Prediction"]):
        draw.text(((img.width + pad) * i + 10, 10), title, fill=(0, 0, 0),
                  font=font)
    if dice_score is not None and iou_score is not None:
        draw.text((10, img.height + header + 5),
                  f"Dice: {dice_score:.4f} | IoU: {iou_score:.4f}",
                  fill=(255, 0, 0), font=font)

    path = os.path.join(save_dir, f"{base_name}_{idx_str}_compare.png")
    canvas.save(path)
    return path
