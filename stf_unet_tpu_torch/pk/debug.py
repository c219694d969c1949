"""PK fit diagnostics (counterpart of stf_unet_tpu/pk/debug.py;
ref:pk_fitting.py:271-287,357-366; ref:test_pk_fitting.py:204-231).

Artifact set, written into a debug output directory:
  * sample_time_curves.png  - 10 random tissue-voxel signal curves
  * training_loss.png       - the Adam fit's loss per epoch
  * detected_aif_curve.png  - the auto-detected AIF signal curve
  * aif_location.png        - the AIF voxel circled on the max image
  * max_time_derivative.png - the masked peak temporal-derivative map

Each render is split in two: a function that computes its numbers
(`sample_curve_indices`, `debug_fit`, `aif_debug_numbers`), which the
tests and chip_smoke.py check, and one that draws them. The plots need
matplotlib (imported when drawing, Agg backend); without it the drawing
functions raise an ImportError that names it, as the JAX module fails
without cv2. The AIF marker is drawn with PIL (a circle of radius 5 and
width 2, cv2.circle's in the JAX module).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
from PIL import Image, ImageDraw

from stf_unet_tpu_torch.core.config import PKConfig
from stf_unet_tpu_torch.pk.fit import fit_adam_debug, fit_lm
from stf_unet_tpu_torch.pk.tofts import ToftsQuadrature
from stf_unet_tpu_torch.viz.tic import pyplot


def sample_curve_indices(num_valid: int, num_samples: int = 10,
                         seed: int = 0) -> np.ndarray:
    """The tissue voxels whose curves sample_time_curves.png plots."""
    n = min(num_samples, num_valid)
    return np.random.default_rng(seed).permutation(num_valid)[:n]


def plot_sample_time_curves(valid_pixels: np.ndarray, time_points,
                            output_dir: str, num_samples: int = 10,
                            seed: int = 0) -> str:
    """Random tissue-voxel signal curves (ref:pk_fitting.py:271-287)."""
    plt = pyplot()
    os.makedirs(output_dir, exist_ok=True)
    idx = sample_curve_indices(valid_pixels.shape[0], num_samples, seed)
    t = np.asarray(time_points)
    plt.figure(figsize=(10, 6))
    for i, j in enumerate(idx):
        plt.plot(t, np.asarray(valid_pixels[j]), marker="o",
                 label=f"Pixel {i + 1}")
    plt.xlabel("Time (min)")
    plt.ylabel("Signal Intensity")
    plt.title("Sample Pixel Time Curves")
    plt.legend()
    plt.grid(True)
    path = os.path.join(output_dir, "sample_time_curves.png")
    plt.savefig(path)
    plt.close()
    return path


def plot_loss_curve(losses: np.ndarray, output_dir: str) -> str:
    """Fit loss vs epoch (ref:pk_fitting.py:357-366)."""
    plt = pyplot()
    os.makedirs(output_dir, exist_ok=True)
    plt.figure(figsize=(10, 6))
    plt.plot(np.asarray(losses))
    plt.xlabel("Epoch")
    plt.ylabel("Loss")
    plt.title("Training Loss")
    plt.grid(True)
    path = os.path.join(output_dir, "training_loss.png")
    plt.savefig(path)
    plt.close()
    return path


def debug_fit(valid: np.ndarray, quad: ToftsQuadrature, cfg: PKConfig
              ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(fitted [N, 3], the loss per epoch for Adam, None for LM)."""
    if cfg.solver == "adam":
        return fit_adam_debug(valid, quad, cfg)
    return fit_lm(valid, quad, cfg), None


def fit_with_debug(valid: np.ndarray, quad: ToftsQuadrature, cfg: PKConfig,
                   output_dir: str) -> np.ndarray:
    """The debug-mode fit of fit_volume and fit_volume_enhanced: the
    sample voxel curves always, Adam's loss curve too
    (ref:pk_fitting.py:271-287,357-366)."""
    plot_sample_time_curves(valid, cfg.time_points, output_dir)
    fitted, losses = debug_fit(valid, quad, cfg)
    if losses is not None:
        plot_loss_curve(losses, output_dir)
    return fitted


def aif_debug_numbers(images: np.ndarray, tissue_mask: np.ndarray,
                      position=None) -> dict:
    """The auto AIF's diagnostics: {"position": (row, col), "curve" [T],
    "derivative_map" [H, W] (the masked peak temporal derivative that
    auto_detect_aif maximizes), "marker" uint8 [H, W] (the max image with
    the voxel circled)}. `position` is the voxel auto_detect_aif picked;
    None takes the map's argmax."""
    imgs = np.asarray(images, np.float32)
    if imgs.max() > 1.5:
        imgs = imgs / 255.0
    mask = np.asarray(tissue_mask)
    peak = np.diff(imgs, axis=0).max(axis=0) * mask.astype(imgs.dtype)
    if position is None:
        position = np.unravel_index(int(np.argmax(peak)), peak.shape)
    x, y = int(position[0]), int(position[1])
    marker = Image.fromarray((imgs.max(axis=0) * 255).astype(np.uint8))
    ImageDraw.Draw(marker).ellipse((y - 5, x - 5, y + 5, x + 5),
                                   outline=255, width=2)
    return {"position": (x, y), "curve": imgs[:, x, y],
            "derivative_map": peak, "marker": np.asarray(marker)}


def render_aif_debug(images: np.ndarray, tissue_mask: np.ndarray,
                     time_points, output_dir: str, position=None) -> dict:
    """Auto-AIF diagnostics (ref:test_pk_fitting.py:204-231): the curve,
    the location marker and the derivative map of aif_debug_numbers,
    drawn; returns the position and the three paths."""
    plt = pyplot()
    os.makedirs(output_dir, exist_ok=True)
    nums = aif_debug_numbers(images, tissue_mask, position)

    plt.figure(figsize=(10, 6))
    plt.plot(np.asarray(time_points), nums["curve"], "ro-", linewidth=2)
    plt.xlabel("Time (min)")
    plt.ylabel("Signal Intensity")
    plt.title("Detected AIF Curve")
    plt.grid(True)
    curve_path = os.path.join(output_dir, "detected_aif_curve.png")
    plt.savefig(curve_path)
    plt.close()

    loc_path = os.path.join(output_dir, "aif_location.png")
    Image.fromarray(nums["marker"]).save(loc_path)

    plt.figure(figsize=(8, 6))
    plt.imshow(nums["derivative_map"], cmap="hot")
    plt.colorbar(label="Max Time Derivative")
    plt.title("Maximum Time Derivative Map")
    deriv_path = os.path.join(output_dir, "max_time_derivative.png")
    plt.savefig(deriv_path)
    plt.close()

    return {"position": nums["position"], "curve": curve_path,
            "location": loc_path, "derivative_map": deriv_path}
