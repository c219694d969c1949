"""Confusion-matrix metrics (counterpart of stf_unet_tpu/metrics/
confusion.py; ref:train_utils/train_and_eval.py:25-70, 338-374).

The running matrix is an [n, n] int64 tensor on the device, updated per
batch; only the final report moves to the host.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def confusion_init(num_classes: int, device="cpu") -> torch.Tensor:
    return torch.zeros((num_classes, num_classes), dtype=torch.int64,
                       device=device)


def confusion_update(mat: torch.Tensor, target: torch.Tensor,
                     pred: torch.Tensor) -> torch.Tensor:
    """mat + bincount(n*target + pred) over pixels with 0 <= target < n
    (the guard drops the 255 padding label)."""
    n = mat.shape[0]
    a = target.reshape(-1).long()
    b = pred.reshape(-1).long()
    keep = (a >= 0) & (a < n) & (b >= 0) & (b < n)
    counts = torch.bincount(n * a[keep] + b[keep], minlength=n * n)
    return mat + counts.reshape(n, n)


def confusion_report(mat: np.ndarray, eps: float = 1e-6) -> Dict:
    """Per-class precision/recall/IoU and their means (ref:338-366)."""
    total = mat.sum()
    global_accuracy = float(np.diag(mat).sum() / total) if total != 0 else 0.0
    class_metrics: List[Dict[str, float]] = []
    for c in range(mat.shape[0]):
        tp = mat[c, c]
        fp = mat[:, c].sum() - tp
        fn = mat[c, :].sum() - tp
        class_metrics.append({
            "precision": float(tp / (tp + fp + eps)),
            "recall": float(tp / (tp + fn + eps)),
            "iou": float(tp / (tp + fp + fn + eps)),
        })
    mean_metrics = {
        "mprecision": float(np.mean([m["precision"] for m in class_metrics])),
        "mrecall": float(np.mean([m["recall"] for m in class_metrics])),
        "miou": float(np.mean([m["iou"] for m in class_metrics])),
    }
    return {"global_accuracy": global_accuracy,
            "class_metrics": class_metrics, "mean_metrics": mean_metrics}


def format_confusion(mat: np.ndarray) -> str:
    """The reference ConfusionMatrix.__str__ (ref:59-70)."""
    h = mat.astype(np.float64)
    diag = np.diag(h)
    acc_global = diag.sum() / max(h.sum(), 1e-12)
    with np.errstate(divide="ignore", invalid="ignore"):
        acc = diag / h.sum(axis=1)
        iu = diag / (h.sum(axis=1) + h.sum(axis=0) - diag)
    return (
        "global correct: {:.1f}\n"
        "average row correct: {}\n"
        "IoU: {}\n"
        "mean IoU: {:.1f}"
    ).format(
        acc_global * 100,
        ["{:.1f}".format(i) for i in (acc * 100).tolist()],
        ["{:.1f}".format(i) for i in (iu * 100).tolist()],
        np.nanmean(iu) * 100,
    )
