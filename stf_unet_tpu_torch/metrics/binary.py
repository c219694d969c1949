"""Thresholded binary IoU/Dice (ref:metrics.py:7-40,
ref:train_utils/visualize.py:9-50), plus a probability-threshold sweep
with ROC/PR AUC (beyond the reference, which hardcodes 0.5 and never
evaluates the operating point, ref:test.py:168-172). The port's numpy copy
of stf_unet_tpu/metrics/binary.py."""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np


def iou_score(output, target, smooth: float = 1e-5) -> Tuple[float, float]:
    """sigmoid -> 0.5 threshold -> (IoU, Dice) (ref:metrics.py:7-40).

    Accepts numpy arrays or anything np.asarray can consume; if `output`
    looks like logits (outside [0,1]) a sigmoid is applied, matching the
    reference's torch.sigmoid on raw model output.
    """
    output = np.asarray(output, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    if output.min() < 0.0 or output.max() > 1.0:
        output = 1.0 / (1.0 + np.exp(-output))
    o = output > 0.5
    t = target > 0.5
    inter = np.logical_and(o, t).sum()
    union = np.logical_or(o, t).sum()
    iou = (inter + smooth) / (union + smooth)
    dice = (2.0 * inter + smooth) / (o.sum() + t.sum() + smooth)
    return float(iou), float(dice)


def compute_metrics(pred, target, smooth: float = 1e-5) -> Tuple[float, float]:
    """Per-sample (dice, iou) on already-thresholded masks
    (ref:train_utils/visualize.py:9-50). Returns (dice, iou) in the
    reference's order."""
    pred = np.asarray(pred, dtype=np.float64) > 0.5
    target = np.asarray(target, dtype=np.float64) > 0.5
    inter = np.logical_and(pred, target).sum()
    union = np.logical_or(pred, target).sum()
    iou = (inter + smooth) / (union + smooth)
    dice = (2.0 * inter + smooth) / (pred.sum() + target.sum() + smooth)
    return float(dice), float(iou)


_SWEEP_BINS = 1024  # probability-histogram resolution (exact to 1/1024)

# np.trapezoid is the NumPy>=2 spelling; fall back for 1.x installs.
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


class ThresholdSweep:
    """Streaming foreground-probability histograms -> threshold table +
    ROC/PR AUC, pooled over all valid pixels.

    update() consumes one slice at a time so the caller never holds the
    whole test set's probabilities; two fixed histograms (positive /
    negative pixels, _SWEEP_BINS bins) are sufficient statistics for
    EVERY threshold metric. Pixels whose target holds `ignore_index`
    (the 255 padding label) are dropped."""

    def __init__(self, ignore_index: int = 255):
        self.ignore_index = ignore_index
        self._pos = np.zeros(_SWEEP_BINS, np.int64)
        self._neg = np.zeros(_SWEEP_BINS, np.int64)

    def update(self, prob_fg: np.ndarray, target: np.ndarray) -> None:
        prob_fg = np.asarray(prob_fg, np.float64).reshape(-1)
        target = np.asarray(target).reshape(-1)
        valid = target != self.ignore_index
        bins = np.clip((prob_fg[valid] * _SWEEP_BINS).astype(np.int64),
                       0, _SWEEP_BINS - 1)
        pos = target[valid] > 0
        self._pos += np.bincount(bins[pos], minlength=_SWEEP_BINS)
        self._neg += np.bincount(bins[~pos], minlength=_SWEEP_BINS)

    def report(self, thresholds: Iterable[float] = None) -> Dict:
        """{"rows": [{threshold, dice, iou, precision, recall}...],
        "best": the max-dice row, "roc_auc": .., "pr_auc": ..}."""
        if thresholds is None:
            thresholds = np.round(np.arange(0.05, 0.96, 0.05), 2)
        # cum_pos[k] = positives with prob >= k/_SWEEP_BINS (predicted fg
        # at threshold k/_SWEEP_BINS) = TP; cum_neg likewise = FP.
        cum_pos = np.cumsum(self._pos[::-1])[::-1]
        cum_neg = np.cumsum(self._neg[::-1])[::-1]
        P = int(self._pos.sum())
        N = int(self._neg.sum())

        def row(t: float) -> Dict[str, float]:
            k = min(int(t * _SWEEP_BINS), _SWEEP_BINS - 1)
            tp, fp = int(cum_pos[k]), int(cum_neg[k])
            fn = P - tp
            eps = 1e-12
            return {
                "threshold": float(t),
                "dice": 2.0 * tp / max(2 * tp + fp + fn, eps),
                "iou": tp / max(tp + fp + fn, eps),
                "precision": tp / max(tp + fp, eps),
                "recall": tp / max(P, eps),
            }

        rows = [row(t) for t in thresholds]
        best = max(rows, key=lambda r: r["dice"])
        # Exact AUCs over the binned score distribution (trapezoid over
        # all _SWEEP_BINS operating points; ties within a bin contribute
        # the standard 1/2 credit via the trapezoid rule). k=0 gives the
        # (1, 1) corner; the (0, 0) / recall-0 corner is appended
        # (precision -> 1 there by the usual convention).
        tpr = np.concatenate([cum_pos / max(P, 1), [0.0]])
        fpr = np.concatenate([cum_neg / max(N, 1), [0.0]])
        roc_auc = float(-_trapezoid(tpr, fpr))  # fpr descends with k
        denom = cum_pos + cum_neg
        prec = np.concatenate(
            [np.where(denom > 0, cum_pos / np.maximum(denom, 1), 1.0),
             [1.0]])  # 0/0 -> 1: nothing predicted positive, no FPs
        pr_auc = float(-_trapezoid(prec, tpr))
        return {"rows": rows, "best": best,
                "roc_auc": roc_auc, "pr_auc": pr_auc,
                "positives": P, "negatives": N}


def format_threshold_sweep(report: Dict) -> str:
    lines = ["threshold    dice     iou  precision  recall"]
    for r in report["rows"]:
        mark = "  <-- best" if r is report["best"] else ""
        lines.append(f"   {r['threshold']:.2f}    {r['dice']:.4f}  "
                     f"{r['iou']:.4f}     {r['precision']:.4f}  "
                     f"{r['recall']:.4f}{mark}")
    lines.append(f"ROC AUC {report['roc_auc']:.4f} | PR AUC "
                 f"{report['pr_auc']:.4f} | {report['positives']} fg / "
                 f"{report['negatives']} bg pixels")
    return "\n".join(lines)
