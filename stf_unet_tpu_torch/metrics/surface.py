"""Surface-distance metrics: HD95 and ASSD over final integer masks (the
port's numpy + scipy copy of stf_unet_tpu/metrics/surface.py).

Beyond the reference: the reference reports only overlap metrics
(dice / IoU / precision / recall, ref:train_utils/train_and_eval.py:338-366),
but boundary agreement is the standard complement in medical-segmentation
reporting (95th-percentile Hausdorff distance and average symmetric surface
distance, as used by the MSD/BraTS/KiTS challenge suites). A prediction can
score a high dice while its boundary wanders several pixels — exactly what a
surgeon tracing a tumor margin cares about.

These run on the HOST over final integer masks — report-level work on tiny
arrays, like the reference's cv2 contour rendering
(ref:train_utils/merge_tumor_images.py:62-92), not device compute. Distances
are in PIXEL units unless a physical `spacing` (row, col) is given; the
BreaDM-layout datasets are plain PNGs with no embedded spacing.

Conventions (matching common evaluation tools such as MedPy/seg-metrics):
  * both masks empty       -> 0.0 (perfect agreement on "nothing present")
  * exactly one mask empty -> nan (undefined; the aggregator excludes nans
                              from means and counts them separately)
  * pixels where the ground truth holds `ignore_index` are excluded from
    BOTH masks (the 255 padding label, ref:my_dataset.py:237-257)
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

__all__ = ["hd95_assd", "surface_metrics"]


def _boundary(mask: np.ndarray) -> np.ndarray:
    # scipy is imported where it is used, so importing the module never
    # requires it.
    from scipy import ndimage

    # 4-connected structuring element: the boundary is every mask pixel
    # with a background neighbor (or on the image edge, border_value=0).
    eroded = ndimage.binary_erosion(
        mask, structure=ndimage.generate_binary_structure(2, 1),
        border_value=0)
    return mask & ~eroded


def hd95_assd(pred: np.ndarray, gt: np.ndarray,
              spacing: Tuple[float, float] = (1.0, 1.0)
              ) -> Tuple[float, float]:
    """(HD95, ASSD) between two binary 2-D masks.

    HD95 = max over directions of the 95th percentile of boundary-to-boundary
    distances; ASSD = mean of all boundary distances, both directions pooled.
    Distance transforms give exact Euclidean distances to the NEAREST
    boundary pixel in O(H*W).
    """
    pred = np.asarray(pred).astype(bool)
    gt = np.asarray(gt).astype(bool)
    if pred.shape != gt.shape or pred.ndim != 2:
        raise ValueError(f"expected matching 2-D masks, got {pred.shape} "
                         f"vs {gt.shape}")
    p_any = bool(pred.any())
    g_any = bool(gt.any())
    if not p_any and not g_any:
        return 0.0, 0.0
    if p_any != g_any:
        return float("nan"), float("nan")
    from scipy import ndimage

    pb = _boundary(pred)
    gb = _boundary(gt)
    # distance_transform_edt(~gb) holds, at every pixel, the distance to the
    # nearest gt-boundary pixel; indexing it with pb reads off d(pred->gt).
    d_pg = ndimage.distance_transform_edt(~gb, sampling=spacing)[pb]
    d_gp = ndimage.distance_transform_edt(~pb, sampling=spacing)[gb]
    hd95 = max(float(np.percentile(d_pg, 95)), float(np.percentile(d_gp, 95)))
    assd = float((d_pg.sum() + d_gp.sum()) / (d_pg.size + d_gp.size))
    return hd95, assd


def surface_metrics(pred: np.ndarray, gt: np.ndarray, num_classes: int,
                    ignore_index: int = 255,
                    spacing: Tuple[float, float] = (1.0, 1.0)
                    ) -> Dict[int, Dict[str, float]]:
    """Per-foreground-class {class: {"hd95": .., "assd": ..}} for one
    [H, W] integer prediction/target pair. Background (class 0) has no
    meaningful boundary and is skipped; `ignore_index` pixels are excluded
    from both masks."""
    pred = np.asarray(pred)
    gt = np.asarray(gt)
    valid = gt != ignore_index
    out: Dict[int, Dict[str, float]] = {}
    for c in range(1, num_classes):
        hd95, assd = hd95_assd((pred == c) & valid, (gt == c) & valid,
                               spacing)
        out[c] = {"hd95": hd95, "assd": assd}
    return out
