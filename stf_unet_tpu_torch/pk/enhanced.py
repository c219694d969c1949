"""Enhanced PK preprocessing and postprocessing, and the AIF comparison
(counterpart of stf_unet_tpu/pk/enhanced.py; ref:test_pk_fitting.py, the
reference's enhanced fitter fork).

  * enhanced_preprocess - Otsu threshold of the Gaussian-blurred
    max-projection, close then open, a bilateral filter per frame, then
    mask and min-max normalization (ref:239-325);
  * postprocess_param_maps - Gaussian smoothing, per-parameter thresholds
    (Ktrans .01 / ve .05 / vp .005), tissue re-masking (ref:467-521);
  * fit_volume_enhanced - the two around the fit (pk/fit.fit_lm, kernel
    K4 on CUDA, or fit_adam);
  * compare_aif_methods - one volume fitted with each AIF method, its
    maps per method and the pairwise differences (ref:709-887).

The JAX module does the image steps with cv2. The port computes the same
steps with numpy and scipy (they run once per volume, on the host):
  * the 5x5 Gaussian blur of the uint8 max-projection (sigma 0: taps
    [1, 4, 6, 4, 1] / 16), the Otsu threshold and the morphology are
    cv2's bit for bit: the blur is its fixed-point sum rounded half up,
    the threshold its between-class-variance loop in float64 with its tie
    rule, and the morphology never erodes or dilates from outside the
    image, as cv2's default border;
  * the bilateral filter (d = 5: 12 taps of a radius-2 disk and the
    center; sigma 75 for color and space, the range weight read from a
    4,096-bin table with linear interpolation) and the float Gaussian
    blur of the maps (sigma 0.5, symmetric taps summed in pairs) take
    cv2's float32 operations in cv2's order; cv2's SIMD code may fuse a
    multiply-add, so they sit within a few float32 spacings of cv2's
    (tests/test_torch_pk_enhanced.py states the tolerances);
  * every border is cv2's default, BORDER_REFLECT_101 (numpy "reflect").
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
from PIL import Image

from stf_unet_tpu_torch.core.config import PKConfig, resolve_device
from stf_unet_tpu_torch.pk.aif import auto_detect_aif, make_aif
from stf_unet_tpu_torch.pk.debug import (fit_with_debug, pyplot,
                                         render_aif_debug)
from stf_unet_tpu_torch.pk.fit import dilate, erode, fit_adam, fit_lm
from stf_unet_tpu_torch.pk.maps import PARAM_NAMES, save_param_maps
from stf_unet_tpu_torch.pk.tofts import ToftsQuadrature

# Per-parameter low-value thresholds (ref:test_pk_fitting.py:477).
POSTPROCESS_THRESHOLDS = {"ktrans": 0.01, "ve": 0.05, "vp": 0.005}
AIF_METHODS = ("population", "modified", "auto")

_F32_EPS = float(np.finfo(np.float32).eps)


def gaussian_blur_u8(image: np.ndarray) -> np.ndarray:
    """cv2.GaussianBlur(image, (5, 5), 0) of a uint8 [H, W] image: the
    taps [1, 4, 6, 4, 1] / 16 in both directions, the exact sum rounded
    half up."""
    taps = (1, 4, 6, 4, 1)
    h, w = image.shape
    p = np.pad(image.astype(np.int64), 2, mode="reflect")
    rows = sum(k * p[:, i:i + w] for i, k in enumerate(taps))
    total = sum(k * rows[i:i + h, :] for i, k in enumerate(taps))
    return ((total + 128) >> 8).astype(np.uint8)


def otsu_threshold(image: np.ndarray) -> int:
    """cv2.threshold(..., THRESH_OTSU)'s level of a uint8 image: the
    first maximum of the between-class variance over the 256-bin
    histogram, in cv2's float64 operation order."""
    hist = np.bincount(image.ravel(), minlength=256).tolist()
    scale = 1.0 / image.size
    mu = 0.0
    for i, count in enumerate(hist):
        mu += i * float(count)
    mu *= scale
    mu1 = q1 = max_sigma = 0.0
    level = 0
    for i, count in enumerate(hist):
        p_i = count * scale
        mu1 *= q1
        q1 += p_i
        q2 = 1.0 - q1
        if min(q1, q2) < _F32_EPS or max(q1, q2) > 1.0 - _F32_EPS:
            continue
        mu1 = (mu1 + i * p_i) / q1
        mu2 = (mu - q1 * mu1) / q2
        sigma = q1 * q2 * (mu1 - mu2) * (mu1 - mu2)
        if sigma > max_sigma:
            max_sigma, level = sigma, i
    return level


def bilateral_filter(image: np.ndarray, d: int = 5,
                     sigma_color: float = 75.0,
                     sigma_space: float = 75.0) -> np.ndarray:
    """cv2.bilateralFilter of a float32 [H, W] image, in float32."""
    img = np.asarray(image, np.float32)
    radius = max(d // 2, 1)
    lo, hi = float(img.min()), float(img.max())
    if abs(lo - hi) < _F32_EPS:
        return img.copy()
    color_coeff = -0.5 / (sigma_color * sigma_color)
    space_coeff = -0.5 / (sigma_space * sigma_space)
    bins = 1 << 12
    scale_index = np.float32(bins / np.float32(hi - lo))
    lut = np.zeros(bins + 2, np.float32)
    for i in range(bins + 2):
        val = i / float(scale_index)
        lut[i] = np.float32(np.exp(val * val * color_coeff))
        if lut[i] <= 0:
            break
    h, w = img.shape
    pad = np.pad(img, radius, mode="reflect")
    total = np.zeros_like(img)
    weights = np.zeros_like(img)
    for i in range(-radius, radius + 1):
        for j in range(-radius, radius + 1):
            r = np.sqrt(float(i * i + j * j))
            if r > radius or (i == 0 and j == 0):
                continue
            space = np.float32(np.exp(r * r * space_coeff))
            val = pad[radius + i:radius + i + h, radius + j:radius + j + w]
            alpha = np.abs(val - img) * scale_index
            idx = np.floor(alpha).astype(np.int64)
            alpha = alpha - idx.astype(np.float32)
            wgt = space * (lut[idx] + alpha * (lut[idx + 1] - lut[idx]))
            weights = weights + wgt
            total = total + val * wgt
    # the center tap, weight 1
    return (total + img) / (weights + np.float32(1.0))


def gaussian_blur_f32(image: np.ndarray, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(image, (5, 5), sigma) of a float32 [H, W] image:
    getGaussianKernel's normalized taps, rows then columns, each pair of
    symmetric taps summed before its product."""
    x = np.arange(5) - 2.0
    t = np.exp(-0.5 / (sigma * sigma) * x * x)
    k = (t * (1.0 / t.sum())).astype(np.float32)
    img = np.asarray(image, np.float32)
    h, w = img.shape
    p = np.pad(img, 2, mode="reflect")

    def col(o):
        return p[:, 2 + o:2 + o + w]

    rows = k[2] * col(0) + k[1] * (col(-1) + col(1)) + k[0] * (col(-2)
                                                              + col(2))

    def row(o):
        return rows[2 + o:2 + o + h, :]

    return k[2] * row(0) + k[1] * (row(-1) + row(1)) + k[0] * (row(-2)
                                                               + row(2))


def normalize_minmax(x: np.ndarray) -> np.ndarray:
    """cv2.normalize(x, None, 0, 1, NORM_MINMAX) of a float64 image."""
    lo, hi = float(x.min()), float(x.max())
    scale = 1.0 / (hi - lo) if hi - lo > np.finfo(np.float64).eps else 0.0
    return x * scale + (0.0 - lo * scale)


def _save_u8(path: str, arr: np.ndarray) -> None:
    Image.fromarray(np.asarray(arr).astype(np.uint8)).save(path)


def tissue_mask_u8(images: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The enhanced tissue mask of [T, H, W] frames in [0, 1]: (the
    uint8 max-projection, the mask as uint8 0 / 255)."""
    max_u8 = (images.max(axis=0) * 255).astype(np.uint8)
    blurred = gaussian_blur_u8(max_u8)
    mask = np.where(blurred > otsu_threshold(blurred), 255,
                    0).astype(np.uint8)
    mask = erode(dilate(mask))    # close: fill holes (ref:270-273)
    mask = dilate(erode(mask))    # open: drop islands
    return max_u8, mask


def enhanced_preprocess(images: np.ndarray,
                        debug_output_dir: Optional[str] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """[T, H, W] (uint8 or [0, 1] float) -> (processed [T, H, W] float32,
    tissue mask [H, W] bool) (ref:239-325)."""
    imgs = np.asarray(images, np.float32)
    if imgs.max() > 1.5:
        imgs = imgs / 255.0
    max_u8, mask_u8 = tissue_mask_u8(imgs)
    processed = []
    for t in range(imgs.shape[0]):
        filtered = bilateral_filter(imgs[t])
        masked = filtered * (mask_u8 / 255.0)   # float64, as in JAX
        enhanced = normalize_minmax(masked)
        processed.append(enhanced.astype(np.float32))
        if debug_output_dir is not None:
            os.makedirs(debug_output_dir, exist_ok=True)
            for tag, arr in (("original", imgs[t]), ("filtered", filtered),
                             ("masked", masked), ("enhanced", enhanced)):
                _save_u8(os.path.join(debug_output_dir, f"{tag}_t{t}.png"),
                         arr * 255)
    if debug_output_dir is not None:
        _save_u8(os.path.join(debug_output_dir, "tissue_mask.png"), mask_u8)
        _save_u8(os.path.join(debug_output_dir, "max_image.png"), max_u8)
    return np.stack(processed), mask_u8 > 0


def postprocess_param_maps(param_maps: np.ndarray, tissue_mask: np.ndarray,
                           debug_output_dir: Optional[str] = None
                           ) -> np.ndarray:
    """Gaussian smoothing -> per-parameter threshold -> tissue re-mask
    (ref:467-521)."""
    plt = pyplot() if debug_output_dir is not None else None
    out = np.zeros_like(param_maps)
    for i, name in enumerate(PARAM_NAMES):
        smooth = gaussian_blur_f32(param_maps[i], 0.5)
        thresholded = np.where(smooth < POSTPROCESS_THRESHOLDS[name], 0,
                               smooth)
        out[i] = thresholded * tissue_mask
        if plt is not None:
            os.makedirs(debug_output_dir, exist_ok=True)
            for tag, arr in (("original", param_maps[i]), ("smooth", smooth),
                             ("threshold", thresholded), ("final", out[i])):
                plt.figure(figsize=(8, 6))
                plt.imshow(arr, cmap="hot")
                plt.colorbar()
                plt.title(f"{tag} {name} map")
                plt.savefig(os.path.join(debug_output_dir,
                                         f"param_{i}_{tag}.png"))
                plt.close()
    return out


def fit_volume_enhanced(images: np.ndarray, cfg: PKConfig,
                        output_dir: Optional[str] = None,
                        debug_output_dir: Optional[str] = None,
                        device="cuda") -> np.ndarray:
    """Enhanced preprocessing -> fit on `device` -> postprocessing (the
    fork's fit_volume_gpu): [T, H, W] frames -> [3, H, W] maps."""
    dev = resolve_device(device)
    t_steps, h, w = images.shape
    processed, tissue_mask = enhanced_preprocess(images, debug_output_dir)

    aif = make_aif(cfg.aif_method, cfg.aif_dose)
    pos = None
    if cfg.aif_method == "auto":
        aif, pos = auto_detect_aif(processed, tissue_mask,
                                   np.asarray(cfg.time_points))
    quad = ToftsQuadrature.build(cfg.time_points, aif, cfg.dt, device=dev)

    pixels = processed.transpose(1, 2, 0).reshape(-1, t_steps)
    flat_mask = tissue_mask.reshape(-1)
    valid = pixels[flat_mask]
    if debug_output_dir is not None:
        if pos is not None:
            render_aif_debug(processed, tissue_mask, cfg.time_points,
                             debug_output_dir, position=pos)
        fitted = fit_with_debug(valid, quad, cfg, debug_output_dir)
    else:
        solver = fit_lm if cfg.solver == "lm" else fit_adam
        fitted = solver(valid, quad, cfg)

    maps = np.zeros((3, h * w), np.float32)
    maps[:, flat_mask] = fitted.T
    maps = postprocess_param_maps(maps.reshape(3, h, w), tissue_mask,
                                  debug_output_dir)
    if output_dir is not None:
        save_param_maps(maps, output_dir)
    return maps


def aif_method_maps(images: np.ndarray, cfg: PKConfig, output_dir: str,
                    device="cuda") -> Dict[str, np.ndarray]:
    """The volume fitted (enhanced) with each AIF method, each method's
    maps saved under `output_dir/<method>/`: method -> [3, H, W]."""
    return {method: fit_volume_enhanced(
        images, dataclasses.replace(cfg, aif_method=method),
        output_dir=os.path.join(output_dir, method), device=device)
        for method in AIF_METHODS}


def draw_aif_comparison(results: Dict[str, np.ndarray],
                        output_dir: str) -> None:
    """compare_<param>.png (each method's map) and
    diff_<param>_<a>_<b>.png (each pair's difference)."""
    plt = pyplot("--compare-aif")
    os.makedirs(output_dir, exist_ok=True)
    methods = list(results)
    for i, name in enumerate(PARAM_NAMES):
        fig, axs = plt.subplots(1, len(methods),
                                figsize=(4 * len(methods), 4))
        for ax, m in zip(axs, methods):
            im = ax.imshow(results[m][i], cmap="hot")
            ax.set_title(f"{name} ({m})")
            ax.axis("off")
            fig.colorbar(im, ax=ax, fraction=0.046)
        fig.savefig(os.path.join(output_dir, f"compare_{name}.png"))
        plt.close(fig)
        for a in range(len(methods)):
            for b in range(a + 1, len(methods)):
                diff = results[methods[a]][i] - results[methods[b]][i]
                plt.figure(figsize=(5, 4))
                plt.imshow(diff, cmap="coolwarm")
                plt.colorbar()
                plt.title(f"{name}: {methods[a]} - {methods[b]}")
                plt.savefig(os.path.join(
                    output_dir, f"diff_{name}_{methods[a]}_{methods[b]}.png"))
                plt.close()


def compare_aif_methods(images: np.ndarray, cfg: PKConfig, output_dir: str,
                        device="cuda") -> Dict[str, np.ndarray]:
    """Fit the volume with all three AIF methods and render each method's
    maps and the pairwise differences (ref:709-887 test_aif_methods).
    Without matplotlib it stops before fitting, as the JAX module does."""
    pyplot("--compare-aif")
    results = aif_method_maps(images, cfg, output_dir, device=device)
    draw_aif_comparison(results, output_dir)
    return results


def test_single_patient(patient_path: str, output_dir: str,
                        cfg: Optional[PKConfig] = None,
                        device="cuda") -> Optional[np.ndarray]:
    """The fork's manual harness over one patient's SUB1..8 first slices
    (ref:658-706), with its debug renders."""
    from stf_unet_tpu_torch.pk.maps import _load_patient_frames

    frames = _load_patient_frames(patient_path)
    if frames is None:
        return None
    return fit_volume_enhanced(frames, cfg or PKConfig(), output_dir,
                               debug_output_dir=os.path.join(output_dir,
                                                             "debug"),
                               device=device)
