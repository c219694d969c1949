"""Sequence grids and time-intensity-curve plots (counterpart of
stf_unet_tpu/viz/tic.py; ref:my_dataset.py:259-405).

The drawing code is the JAX module's. matplotlib is imported when a
function draws (Agg backend), not at import, so the package imports
where it is not installed; there each function raises an ImportError
that names matplotlib and itself. Inputs are numpy
arrays or torch tensors on any device, [B, T, H, W, 1] or [B, T, 1, H, W].
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def pyplot(flag: str = "--debug"):
    """matplotlib.pyplot on the Agg backend; an ImportError naming
    matplotlib and `flag` (the option or function that draws) where it is
    not installed. The port's every plot imports it through here."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(f"{flag} draws its plots with matplotlib, which "
                          f"is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):  # on any device; bf16 has no numpy form
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _frames(sequence, index: int) -> np.ndarray:
    seq = _numpy(sequence)[index]
    if seq.ndim == 4:  # drop channel (either layout, C==1)
        seq = seq[..., 0] if seq.shape[-1] == 1 else seq[:, 0]
    return seq


def visualize_sequence(sequence, index: int = 0, save_path: Optional[str] = None,
                       title: str = "DCE-MRI Sequence") -> None:
    """T-frame grid for one batch sample (ref:my_dataset.py:259-289).
    sequence: [B, T, H, W, C] or [B, T, C, H, W]-like array."""
    plt = pyplot("viz.tic.visualize_sequence")
    seq = _frames(sequence, index)
    t = seq.shape[0]
    fig, axs = plt.subplots(1, t, figsize=(t * 2, 2.5))
    if t == 1:
        axs = [axs]
    for i in range(t):
        axs[i].imshow(seq[i], cmap="gray")
        axs[i].set_title(f"T{i + 1}", fontsize=8)
        axs[i].axis("off")
    plt.suptitle(title, fontsize=12)
    plt.tight_layout()
    if save_path:
        plt.savefig(save_path, dpi=200)
    plt.close(fig)


def _tic_figure(plt, sequence: np.ndarray, y: int, x: int,
                time_interval: float, point_label: str, curve_title: str,
                save_path: Optional[str]) -> None:
    t = sequence.shape[0]
    curve = sequence[:, y, x]
    times = np.arange(t) * time_interval
    fig, axs = plt.subplots(1, 2, figsize=(8, 3.5))
    axs[0].imshow(sequence[0], cmap="gray")
    axs[0].scatter(x, y, c="red", s=2)
    axs[0].set_title(f"{point_label}: ({x}, {y})")
    axs[0].axis("off")
    axs[1].plot(times, curve, marker="o", color="blue")
    axs[1].set_title(curve_title)
    axs[1].set_xlabel("Time (min)")
    axs[1].set_ylabel("Intensity")
    axs[1].grid(True)
    plt.tight_layout()
    if save_path:
        plt.savefig(save_path, dpi=200)
    plt.close(fig)


def plot_mask_center_tic(sequence, mask, index: int = 0,
                         time_interval: float = 1.0,
                         save_path: Optional[str] = None) -> None:
    """TIC at the mask centroid (ref:my_dataset.py:291-345)."""
    plt = pyplot("viz.tic.plot_mask_center_tic")
    seq = _frames(sequence, index)
    m = (_numpy(mask)[index] > 0)
    if m.sum() == 0:
        print("Warning: empty mask, cannot locate center")
        return
    ys, xs = np.nonzero(m)
    y_c = int(round(ys.mean()))
    x_c = int(round(xs.mean()))
    _tic_figure(plt, seq, y_c, x_c, time_interval, "center point",
                "Time-Intensity Curve (Mask Center)", save_path)


def plot_masked_time_intensity_curve(sequence, mask, index: int = 0,
                                     time_interval: float = 1.0,
                                     save_path: Optional[str] = None) -> None:
    """TIC at the brightest masked voxel (ref:my_dataset.py:347-405)."""
    plt = pyplot("viz.tic.plot_masked_time_intensity_curve")
    seq = _frames(sequence, index)
    m = (_numpy(mask)[index] > 0).astype(seq.dtype)
    masked_peak = seq.max(axis=0) * m
    if masked_peak.max() == 0:
        print("Warning: no nonzero masked pixels, cannot extract curve")
        return
    ys, xs = np.nonzero(masked_peak == masked_peak.max())
    _tic_figure(plt, seq, int(ys[0]), int(xs[0]), time_interval, "point set",
                "Time-Intensity Curve (Mask)", save_path)
