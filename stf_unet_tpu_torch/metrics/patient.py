"""Per-patient metric aggregation (the port's numpy copy of
stf_unet_tpu/metrics/patient.py).

Beyond the reference: the reference reports only dataset-GLOBAL metrics
(one confusion matrix / dice over every test pixel pooled,
ref:train_utils/train_and_eval.py:316-374), which lets a few large lesions
dominate the score. Clinical reporting is per-patient: each patient's
slices aggregate into one confusion matrix, dice is computed per patient,
and the dataset summary is mean +/- std / median ACROSS patients — the
unit a reader actually varies over. Optionally folds in the boundary
metrics (HD95 / ASSD, metrics/surface.py) per slice.

Host-side numpy over final integer masks (report-level work; eval sets are
hundreds of slices).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from stf_unet_tpu_torch.metrics.surface import surface_metrics

__all__ = ["PatientAggregator", "format_patient_report"]


class PatientAggregator:
    """Accumulates per-slice (target, prediction) mask pairs under patient
    ids; report() summarizes per patient and across patients.

    Per-patient dice for class c is 2*TP_c / (gt_c + pred_c) over the
    patient's pooled pixels, with the reference's union==0 -> 1.0 quirk
    (a class absent from both masks counts as perfect,
    ref:train_and_eval.py:104-107); the patient's scalar dice averages the
    foreground classes. Pixels whose target is outside [0, num_classes)
    are dropped — the same 0 <= a < n guard the confusion matrix applies
    to the 255 padding label (ref:train_and_eval.py:37-38).
    """

    def __init__(self, num_classes: int, ignore_index: int = 255,
                 surface: bool = False,
                 spacing: Tuple[float, float] = (1.0, 1.0)):
        if num_classes < 2:
            raise ValueError("PatientAggregator needs num_classes >= 2")
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.surface = surface
        self.spacing = spacing
        self._conf: Dict[str, np.ndarray] = {}
        self._slices: Dict[str, int] = {}
        self._surf: Dict[str, list] = {}

    def update(self, patient_id: str, target: np.ndarray,
               pred: np.ndarray) -> None:
        """Add one slice: [H, W] integer target and prediction."""
        t = np.asarray(target).astype(np.int64)
        p = np.asarray(pred).astype(np.int64)
        if t.shape != p.shape or t.ndim != 2:
            raise ValueError(f"expected matching 2-D masks, got {t.shape} "
                             f"vs {p.shape}")
        n = self.num_classes
        tf = t.reshape(-1)
        pf = p.reshape(-1)
        valid = (tf >= 0) & (tf < n)
        conf = np.bincount(n * tf[valid] + pf[valid],
                           minlength=n * n).reshape(n, n)
        if patient_id in self._conf:
            self._conf[patient_id] += conf
        else:
            self._conf[patient_id] = conf
        self._slices[patient_id] = self._slices.get(patient_id, 0) + 1
        if self.surface:
            self._surf.setdefault(patient_id, []).append(
                surface_metrics(p, t, n, self.ignore_index, self.spacing))

    def report(self) -> Dict:
        """{"patients": {pid: {...}}, "summary": {...}}. Surface values are
        nan-skipped means over a patient's slices and classes; `undefined`
        counts (slice, class) pairs where exactly one mask was empty."""
        patients: Dict[str, Dict] = {}
        for pid in sorted(self._conf):
            conf = self._conf[pid]
            diag = np.diag(conf)
            row = conf.sum(axis=1)
            col = conf.sum(axis=0)
            class_dice = []
            for c in range(1, self.num_classes):
                denom = int(row[c] + col[c])
                class_dice.append(
                    1.0 if denom == 0 else 2.0 * float(diag[c]) / denom)
            entry: Dict = {
                "dice": float(np.mean(class_dice)),
                "class_dice": class_dice,
                "slices": self._slices[pid],
                "pixels": int(conf.sum()),
            }
            if self.surface:
                vals = {"hd95": [], "assd": []}
                undefined = 0
                for per_slice in self._surf[pid]:
                    for m in per_slice.values():
                        if np.isnan(m["hd95"]):
                            undefined += 1
                        else:
                            vals["hd95"].append(m["hd95"])
                            vals["assd"].append(m["assd"])
                entry["hd95"] = (float(np.mean(vals["hd95"]))
                                 if vals["hd95"] else float("nan"))
                entry["assd"] = (float(np.mean(vals["assd"]))
                                 if vals["assd"] else float("nan"))
                entry["surface_undefined"] = undefined
            patients[pid] = entry

        def _stats(key: str) -> Optional[Dict[str, float]]:
            xs = np.asarray([p[key] for p in patients.values()
                             if key in p], dtype=np.float64)
            xs = xs[~np.isnan(xs)]
            if xs.size == 0:
                return None
            return {"mean": float(xs.mean()),
                    "std": float(xs.std()),
                    "median": float(np.median(xs))}

        summary: Dict = {"num_patients": len(patients),
                         "dice": _stats("dice")}
        if self.surface:
            summary["hd95"] = _stats("hd95")
            summary["assd"] = _stats("assd")
            summary["surface_undefined"] = int(sum(
                p.get("surface_undefined", 0) for p in patients.values()))
        return {"patients": patients, "summary": summary}


def format_patient_report(report: Dict) -> str:
    """Fixed-width table + across-patient summary lines."""
    patients = report["patients"]
    summary = report["summary"]
    surface = any("hd95" in p for p in patients.values())
    width = max([len("patient")] + [len(pid) for pid in patients])
    head = f"{'patient':<{width}}  slices    dice"
    if surface:
        head += "     hd95     assd"
    lines = [head]
    for pid, p in patients.items():
        line = f"{pid:<{width}}  {p['slices']:>6}  {p['dice']:.4f}"
        if surface:
            line += f"  {p['hd95']:>7.2f}  {p['assd']:>7.2f}"
            if p.get("surface_undefined"):
                line += f"  ({p['surface_undefined']} undefined)"
        lines.append(line)

    def _fmt(key: str, digits: int) -> str:
        s = summary.get(key)
        if s is None:
            return f"{key} n/a"
        return (f"{key} {s['mean']:.{digits}f} +/- {s['std']:.{digits}f} "
                f"(median {s['median']:.{digits}f})")

    parts = [_fmt("dice", 4)]
    if surface:
        parts += [_fmt("hd95", 2), _fmt("assd", 2)]
        if summary.get("surface_undefined"):
            parts.append(f"{summary['surface_undefined']} undefined "
                         "slice-classes (one mask empty)")
    lines.append(f"over {summary['num_patients']} patients: "
                 + " | ".join(parts))
    return "\n".join(lines)
