"""Per-voxel extended-Tofts fitting (counterpart of stf_unet_tpu/pk/fit.py;
ref:pk_fitting.py:157-420).

Two solvers over the same quadrature forward model (pk/tofts.py):
  * fit_lm - the fast path: projected Levenberg-Marquardt with the
    analytic 3-parameter Jacobian and a closed-form 3x3 solve. Each
    iteration takes the quadrature sums twice (the Jacobian's and the
    trial step's), through kernel K4 on CUDA.
  * fit_adam - the reference's solver (fit_adam_debug also returns the
    loss of every epoch): Adam(lr=0.005) over num_epochs
    full-batch updates with the parameters clamped into the physiological
    box after every step, its gradient taken by autograd through the plain
    forward (as the JAX package differentiates its XLA path), at the fixed
    1/1024 gradient scale of the reference's minibatch mean.

Both run voxel chunks of CHUNK curves on the quadrature's device. The JAX
package pads each chunk to a power-of-two bucket so that XLA compiles O(1)
programs; PyTorch compiles nothing, so a chunk here is exactly the voxels
it holds (the voxels are independent, so the fit is the same).

As in the JAX package the images are normalized once (/255), not twice as
the reference does.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from stf_unet_tpu_torch.core.config import PKConfig
from stf_unet_tpu_torch.pk.tofts import (ToftsQuadrature, dual_sums,
                                         extended_tofts_batch,
                                         extended_tofts_from_sums,
                                         extended_tofts_with_jacobian)

CHUNK = 16384


def erode(image: np.ndarray, kernel: int = 5) -> np.ndarray:
    """cv2.erode with a kernel x kernel window of ones and cv2's default
    border, which never erodes from outside the image (scipy's minimum
    filter padded with the dtype's maximum)."""
    from scipy import ndimage

    image = np.asarray(image)
    top = True if image.dtype == bool else np.iinfo(image.dtype).max
    return ndimage.minimum_filter(image, size=kernel, mode="constant",
                                  cval=top)


def dilate(image: np.ndarray, kernel: int = 5) -> np.ndarray:
    """cv2.dilate likewise: the border never dilates into the image."""
    from scipy import ndimage

    return ndimage.maximum_filter(np.asarray(image), size=kernel,
                                  mode="constant", cval=0)


def tissue_mask_morphology(mask, kernel: int = 5) -> np.ndarray:
    """Binary open then close with a kernel x kernel window
    (ref:pk_fitting.py:184-186), as cv2.morphologyEx computes them."""
    m = np.asarray(mask).astype(np.uint8)
    opened = dilate(erode(m, kernel), kernel)
    closed = erode(dilate(opened, kernel), kernel)
    return closed > 0


def preprocess_images(images: np.ndarray, cfg: PKConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (normalized [T, H, W] float32 in [0, 1], tissue mask [H, W]
    bool), CPU tensors.

    Tissue: first frame > tissue_threshold_factor * its mean, then the
    morphological open/close (ref:157-191). Takes uint8 [0, 255] or float
    already in [0, 1]."""
    imgs = np.asarray(images, dtype=np.float32)
    if imgs.max() > 1.5:
        imgs = imgs / 255.0
    first = imgs[0]
    threshold = float(first.mean()) * cfg.tissue_threshold_factor
    mask = tissue_mask_morphology(first > threshold)
    return torch.from_numpy(imgs), torch.from_numpy(mask)


def _bounds(cfg: PKConfig, device) -> Tuple[torch.Tensor, torch.Tensor]:
    lo = torch.tensor([cfg.ktrans_bounds[0], cfg.ve_bounds[0],
                       cfg.vp_bounds[0]], dtype=torch.float32, device=device)
    hi = torch.tensor([cfg.ktrans_bounds[1], cfg.ve_bounds[1],
                       cfg.vp_bounds[1]], dtype=torch.float32, device=device)
    return lo, hi


def _init_params(n: int, cfg: PKConfig, device) -> torch.Tensor:
    return torch.tensor([cfg.init_ktrans, cfg.init_ve, cfg.init_vp],
                        dtype=torch.float32, device=device).expand(n, 3)


def _solve3x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate (Cramer) solve of batched 3x3 systems
    a @ x = b ([N, 3, 3], [N, 3] -> [N, 3]), the JAX package's formula.
    The systems are damped JtJ (SPD, conditioned by the LM lambda); the
    step-acceptance test guards the rest."""
    a00, a01, a02 = a[:, 0, 0], a[:, 0, 1], a[:, 0, 2]
    a10, a11, a12 = a[:, 1, 0], a[:, 1, 1], a[:, 1, 2]
    a20, a21, a22 = a[:, 2, 0], a[:, 2, 1], a[:, 2, 2]
    c00 = a11 * a22 - a12 * a21
    c10 = -(a01 * a22 - a02 * a21)
    c20 = a01 * a12 - a02 * a11
    c01 = -(a10 * a22 - a12 * a20)
    c11 = a00 * a22 - a02 * a20
    c21 = -(a00 * a12 - a02 * a10)
    c02 = a10 * a21 - a11 * a20
    c12 = -(a00 * a21 - a01 * a20)
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c01 + a02 * c02
    b0, b1, b2 = b[:, 0], b[:, 1], b[:, 2]
    x0 = (c00 * b0 + c10 * b1 + c20 * b2) / det
    x1 = (c01 * b0 + c11 * b1 + c21 * b2) / det
    x2 = (c02 * b0 + c12 * b1 + c22 * b2) / det
    return torch.stack([x0, x1, x2], dim=-1)


@torch.no_grad()
def _lm_fit_chunk(curves: torch.Tensor, quad: ToftsQuadrature,
                  cfg: PKConfig, backend: str = "auto") -> torch.Tensor:
    """[n, T] curves on quad's device -> [n, 3] (Ktrans, ve, vp)."""
    n = curves.shape[0]
    dev = curves.device
    lo, hi = _bounds(cfg, dev)
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    p = _init_params(n, cfg, dev)
    lam = torch.full((n,), 1e-3, dtype=torch.float32, device=dev)
    for _ in range(cfg.lm_iters):
        pred, jac = extended_tofts_with_jacobian(quad, p[:, 0], p[:, 1],
                                                 p[:, 2], backend)
        r = pred - curves                                 # [n, T]
        cost_p = torch.sum(r * r, dim=1)
        jtj = torch.einsum("nti,ntj->nij", jac, jac)      # [n, 3, 3]
        jtr = torch.einsum("nti,nt->ni", jac, r)          # [n, 3]
        damped = jtj + (lam[:, None, None] + 1e-12) * eye[None]
        cand = torch.clamp(p + _solve3x3(damped, -jtr), lo, hi)
        s, _ = dual_sums(quad, cand[:, 0] / cand[:, 1], backend)
        r_cand = extended_tofts_from_sums(quad, cand[:, 0], cand[:, 2],
                                          s) - curves
        cost_cand = torch.sum(r_cand * r_cand, dim=1)
        # a NaN candidate cost is never an improvement
        improved = cost_cand < cost_p
        p = torch.where(improved[:, None], cand, p)
        lam = torch.clamp(torch.where(improved, lam * 0.5, lam * 4.0),
                          1e-8, 1e8)
    return p


def _adam_fit_chunk(curves: torch.Tensor, quad: ToftsQuadrature,
                    cfg: PKConfig, with_losses: bool = False):
    """Adam with torch defaults (betas 0.9/0.999, eps 1e-8; the reference's
    torch.optim.Adam(lr=0.005), ref:300), one full-batch update per epoch;
    the bias corrections are taken in float32 as in the JAX package.
    with_losses: also return each epoch's sum of row MSEs (before that
    epoch's update) over the chunk, [num_epochs], for the debug render."""
    n = curves.shape[0]
    dev = curves.device
    lo, hi = _bounds(cfg, dev)
    b1, b2, eps = 0.9, 0.999, 1e-8
    f32 = torch.float32
    params = _init_params(n, cfg, dev).clone()
    m = torch.zeros_like(params)
    v = torch.zeros_like(params)
    losses = []
    for i in range(cfg.num_epochs):
        p = params.detach().requires_grad_()
        pred = extended_tofts_batch(quad, p[:, 0], p[:, 1], p[:, 2])
        row_mse = torch.mean((pred - curves) ** 2, dim=1)
        # the reference's minibatch-mean scale, fixed (ref:316-330)
        (g,) = torch.autograd.grad(torch.sum(row_mse) * (1.0 / 1024.0), p)
        with torch.no_grad():
            if with_losses:
                losses.append(torch.sum(row_mse))
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            t = torch.tensor(float(i + 1), dtype=f32, device=dev)
            mhat = m / (1 - torch.tensor(b1, dtype=f32, device=dev) ** t)
            vhat = v / (1 - torch.tensor(b2, dtype=f32, device=dev) ** t)
            params = params - cfg.lr * mhat / (torch.sqrt(vhat) + eps)
            params = torch.clamp(params, lo, hi)
    if with_losses:
        return params, torch.stack(losses)
    return params


def _fit_chunked(curves: np.ndarray, quad: ToftsQuadrature, cfg: PKConfig,
                 chunk_fn: Callable) -> np.ndarray:
    """[N, T] numpy curves -> [N, 3] numpy, CHUNK voxels at a time on the
    quadrature's device."""
    n = curves.shape[0]
    if n == 0:
        return np.zeros((0, 3), np.float32)
    out = []
    for start in range(0, n, CHUNK):
        chunk = torch.from_numpy(np.array(
            curves[start:start + CHUNK], dtype=np.float32)).to(quad.device)
        out.append(chunk_fn(chunk, quad, cfg).cpu().numpy())
    return np.concatenate(out, axis=0)


def fit_lm(curves: np.ndarray, quad: ToftsQuadrature, cfg: PKConfig,
           backend: str = "auto") -> np.ndarray:
    """[N, T] signal curves -> [N, 3] (Ktrans, ve, vp), projected
    Levenberg-Marquardt on quad's device. backend "auto" takes the
    quadrature sums through K4 on CUDA; "plain" through its plain version
    (to compare the two)."""
    return _fit_chunked(curves, quad, cfg,
                        lambda c, q, k: _lm_fit_chunk(c, q, k, backend))


def fit_adam(curves: np.ndarray, quad: ToftsQuadrature,
             cfg: PKConfig) -> np.ndarray:
    """[N, T] signal curves -> [N, 3], the reference's Adam solver."""
    return _fit_chunked(curves, quad, cfg, _adam_fit_chunk)


def fit_adam_debug(curves: np.ndarray, quad: ToftsQuadrature,
                   cfg: PKConfig) -> Tuple[np.ndarray, np.ndarray]:
    """fit_adam plus the loss of every epoch, [num_epochs] float32: the
    sum of the row MSEs of every chunk divided by N, for the debug loss
    render (ref:pk_fitting.py:357-366)."""
    n = curves.shape[0]
    if n == 0:
        return (np.zeros((0, 3), np.float32),
                np.zeros((cfg.num_epochs,), np.float32))
    out, losses = [], []
    for start in range(0, n, CHUNK):
        chunk = torch.from_numpy(np.array(
            curves[start:start + CHUNK], dtype=np.float32)).to(quad.device)
        fitted, chunk_losses = _adam_fit_chunk(chunk, quad, cfg, True)
        out.append(fitted.cpu().numpy())
        losses.append(chunk_losses.cpu().numpy())
    return (np.concatenate(out, axis=0),
            (np.sum(losses, axis=0) / n).astype(np.float32))
