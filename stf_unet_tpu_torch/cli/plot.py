"""Training-curve plots from a run's metrics (counterpart of
stf_unet_tpu/cli/plot.py).

    python -m stf_unet_tpu_torch.cli.plot out/unet_results_0101-1200.txt
    python -m stf_unet_tpu_torch.cli.plot runA_metrics.jsonl \
        runB_results.txt --output compare.png
    python -m stf_unet_tpu_torch.cli.plot out/patient_report.json

The reference writes per-epoch results to ``*_results_*.txt``
(ref:train.py:288-301) and plots nothing; this CLI renders the curves
from cli/train's results files, its ``*_metrics_*.jsonl`` logs or the
reference's own results files (the formats are line-compatible), and
cli/test's ``patient_report.json`` / ``threshold_sweep.json`` reports.

One input  -> a 2x2 dashboard (loss | dice+accuracy | lr | IoU/P/R).
Many inputs -> a comparison figure (loss, dice) with one color per run.

The palette, parsers and drawing code are the JAX module's. The parsers
need no matplotlib; the renders import it when they draw (Agg backend)
and, where it is not installed, raise an ImportError that names it,
which `main` turns into a non-zero exit.
"""

from __future__ import annotations

import argparse
import json
import os
import re
from typing import Dict, List, Optional, Sequence

from stf_unet_tpu_torch.viz.tic import pyplot

# Categorical palette (first three slots validate all-pairs, light mode)
# + text/surface tokens; assigned in fixed order, never cycled.
SERIES = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4",
          "#008300", "#4a3aa7", "#e34948"]
TEXT_PRIMARY = "#0b0b0b"
TEXT_SECONDARY = "#52514e"
SURFACE = "#fcfcfb"
GRID = "#e3e2de"

# results-.txt keys -> canonical series names (jsonl already uses the
# canonical right-hand names except mean_* spellings).
_KEYS = {
    "train_loss": "train_loss",
    "lr": "lr",
    "dice": "dice",
    "global_acc": "global_acc",
    "mean_iou": "miou",
    "mean_precision": "mprecision",
    "mean_recall": "mrecall",
    "miou": "miou",
    "mprecision": "mprecision",
    "mrecall": "mrecall",
}

_EPOCH_RE = re.compile(r"^\[epoch:\s*(\d+)\]")
_KV_RE = re.compile(r"^([a-z_]+):\s*(-?[0-9.eE+-]+)\s*$")


def parse_results_txt(path: str) -> Dict[str, List[float]]:
    """Parse the per-epoch block format both this framework and the
    reference write (``[epoch: N]`` then ``key: value`` lines; confusion
    matrix text and blank lines are skipped)."""
    series: Dict[str, List[float]] = {"epoch": []}
    with open(path) as f:
        for line in f:
            m = _EPOCH_RE.match(line.strip())
            if m:
                series["epoch"].append(int(m.group(1)))
                continue
            if not series["epoch"]:
                continue  # preamble (arg dump etc.)
            kv = _KV_RE.match(line.strip())
            if kv and kv.group(1) in _KEYS:
                series.setdefault(_KEYS[kv.group(1)], []).append(
                    float(kv.group(2)))
    return series


def parse_jsonl(path: str) -> Dict[str, List[float]]:
    series: Dict[str, List[float]] = {"epoch": []}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if "epoch" not in rec:
                continue
            series["epoch"].append(int(rec["epoch"]))
            for k, v in rec.items():
                if k != "epoch" and k in _KEYS and isinstance(v, (int, float)):
                    series.setdefault(_KEYS[k], []).append(float(v))
    return series


def parse_run(path: str) -> Dict[str, List[float]]:
    parsed = (parse_jsonl(path) if path.endswith(".jsonl")
              else parse_results_txt(path))
    if not parsed["epoch"]:
        raise ValueError(f"no per-epoch records found in {path} (expected "
                         "a *_results_*.txt block file or *_metrics_*.jsonl)")
    return parsed


def _style_axis(ax, title: str):
    ax.set_facecolor(SURFACE)
    ax.grid(True, color=GRID, linewidth=0.6)
    ax.set_axisbelow(True)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("left", "bottom"):
        ax.spines[side].set_color(GRID)
    ax.tick_params(colors=TEXT_SECONDARY, labelsize=8)
    ax.set_title(title, color=TEXT_PRIMARY, fontsize=10, loc="left")
    ax.set_xlabel("epoch", color=TEXT_SECONDARY, fontsize=8)


def _plot_lines(ax, epochs, named_series, title: str):
    """Lines in fixed palette order; legend only when >= 2 series (a single
    series is named by the axis title)."""
    _style_axis(ax, title)
    for i, (name, ys) in enumerate(named_series):
        if not ys:
            continue
        n = min(len(epochs), len(ys))
        # Short runs need visible point marks — a 1-2 point "line" is
        # otherwise invisible.
        marker = dict(marker="o", markersize=4) if n <= 30 else {}
        ax.plot(epochs[:n], ys[:n], color=SERIES[i], linewidth=1.8,
                label=name, **marker)
    if len([1 for _, ys in named_series if ys]) >= 2:
        leg = ax.legend(fontsize=8, frameon=False)
        for t in leg.get_texts():
            t.set_color(TEXT_SECONDARY)


def render_run(series: Dict[str, List[float]], out_png: str,
               title: Optional[str] = None) -> None:
    """2x2 dashboard for one run."""
    plt = pyplot("cli.plot.render_run")

    ep = series["epoch"]
    fig, axes = plt.subplots(2, 2, figsize=(10, 7))
    fig.patch.set_facecolor(SURFACE)
    _plot_lines(axes[0, 0], ep, [("train_loss", series.get("train_loss"))],
                "Training loss")
    _plot_lines(axes[0, 1], ep, [("dice", series.get("dice")),
                                 ("global accuracy",
                                  series.get("global_acc"))],
                "Validation dice / accuracy")
    _plot_lines(axes[1, 0], ep, [("lr", series.get("lr"))], "Learning rate")
    _plot_lines(axes[1, 1], ep, [("mean IoU", series.get("miou")),
                                 ("mean precision", series.get("mprecision")),
                                 ("mean recall", series.get("mrecall"))],
                "Validation mean IoU / precision / recall")
    if series.get("dice"):
        best = max(series["dice"])
        axes[0, 1].annotate(f"best {best:.4f}", color=TEXT_SECONDARY,
                            fontsize=8, xy=(0.98, 0.02),
                            xycoords="axes fraction", ha="right")
    if title:
        fig.suptitle(title, color=TEXT_PRIMARY, fontsize=12)
    fig.tight_layout()
    fig.savefig(out_png, dpi=140, facecolor=SURFACE)
    plt.close(fig)


def render_compare(runs: Dict[str, Dict[str, List[float]]],
                   out_png: str) -> None:
    """Loss + dice across runs, one color per run (the run is the entity;
    colors assigned in fixed order). More than 8 runs won't get readable
    hues — facet instead."""
    plt = pyplot("cli.plot.render_compare")

    if len(runs) > len(SERIES):
        raise ValueError(f"{len(runs)} runs > {len(SERIES)} palette slots; "
                         "plot them in groups instead")
    fig, axes = plt.subplots(1, 2, figsize=(11, 4.2))
    fig.patch.set_facecolor(SURFACE)
    for ax, key, title in ((axes[0], "train_loss", "Training loss"),
                           (axes[1], "dice", "Validation dice")):
        _style_axis(ax, title)
        for i, (name, s) in enumerate(runs.items()):
            ys = s.get(key)
            if not ys:
                continue
            n = min(len(s["epoch"]), len(ys))
            marker = dict(marker="o", markersize=4) if n <= 30 else {}
            ax.plot(s["epoch"][:n], ys[:n], color=SERIES[i],
                    linewidth=1.8, label=name, **marker)
        leg = ax.legend(fontsize=8, frameon=False)
        for t in leg.get_texts():
            t.set_color(TEXT_SECONDARY)
    fig.tight_layout()
    fig.savefig(out_png, dpi=140, facecolor=SURFACE)
    plt.close(fig)


def render_patient_report(report: Dict, out_png: str,
                          title: Optional[str] = None) -> None:
    """Per-patient dice bars (sorted, mean +/- std band across patients)
    from a cli/test --per-patient `patient_report.json`; a second panel
    shows HD95 when surface metrics were collected."""
    plt = pyplot("cli.plot.render_patient_report")

    patients = report["patients"]
    order = sorted(patients, key=lambda p: patients[p]["dice"])
    dice = [patients[p]["dice"] for p in order]
    surface = any(patients[p].get("hd95") is not None for p in patients)

    ncols = 2 if surface else 1
    fig, axes = plt.subplots(
        1, ncols, figsize=(4.6 * ncols, max(2.2, 0.32 * len(order) + 1.2)),
        squeeze=False)
    fig.patch.set_facecolor(SURFACE)

    ax = axes[0][0]
    _style_axis(ax, "dice per patient")
    ax.set_xlabel("dice", color=TEXT_SECONDARY, fontsize=8)
    ax.barh(order, dice, color=SERIES[0], height=0.62)
    s = report["summary"].get("dice")
    if s:
        ax.axvline(s["mean"], color=SERIES[1], linewidth=1.2)
        ax.axvspan(s["mean"] - s["std"], s["mean"] + s["std"],
                   color=SERIES[1], alpha=0.12, linewidth=0)
    ax.set_xlim(0.0, 1.0)

    if surface:
        ax2 = axes[0][1]
        _style_axis(ax2, "HD95 per patient (px)")
        ax2.set_xlabel("hd95", color=TEXT_SECONDARY, fontsize=8)
        hd = [patients[p].get("hd95") or 0.0 for p in order]
        ax2.barh(order, hd, color=SERIES[2], height=0.62)

    n = report["summary"]["num_patients"]
    fig.suptitle(title or f"per-patient metrics ({n} patients)",
                 color=TEXT_PRIMARY, fontsize=11, x=0.02, ha="left")
    fig.tight_layout(rect=(0, 0, 1, 0.94))
    fig.savefig(out_png, dpi=140)
    plt.close(fig)


def render_threshold_sweep(report: Dict, out_png: str,
                           title: Optional[str] = None) -> None:
    """Operating-point curves from a cli/test --threshold-sweep
    `threshold_sweep.json`: dice/IoU and precision/recall vs threshold,
    with the max-dice operating point marked and the pooled ROC/PR AUC in
    the header. (The reference hardcodes sigmoid>0.5 and never evaluates
    the operating point — this is the analysis view for choosing one.)"""
    plt = pyplot("cli.plot.render_threshold_sweep")

    rows = report["rows"]
    if not rows:
        raise SystemExit(
            "threshold_sweep report has an empty 'rows' list — nothing to "
            "plot (did the sweep see any samples?)")
    th = [r["threshold"] for r in rows]
    best = report.get("best") or max(rows, key=lambda r: r["dice"])

    fig, axes = plt.subplots(1, 2, figsize=(9.2, 3.6))
    fig.patch.set_facecolor(SURFACE)

    panels = (
        (axes[0], "dice / IoU vs threshold",
         [("dice", [r["dice"] for r in rows], SERIES[0]),
          ("IoU", [r["iou"] for r in rows], SERIES[2])]),
        (axes[1], "precision / recall vs threshold",
         [("precision", [r["precision"] for r in rows], SERIES[0]),
          ("recall", [r["recall"] for r in rows], SERIES[1])]),
    )
    for ax, ptitle, named in panels:
        _style_axis(ax, ptitle)
        ax.set_xlabel("threshold", color=TEXT_SECONDARY, fontsize=8)
        for name, ys, color in named:
            ax.plot(th, ys, color=color, linewidth=1.8, label=name,
                    marker="o", markersize=3)
        ax.axvline(best["threshold"], color=TEXT_SECONDARY, linewidth=0.9,
                   linestyle=":")
        ax.set_ylim(0.0, 1.02)
        leg = ax.legend(fontsize=8, frameon=False)
        for t in leg.get_texts():
            t.set_color(TEXT_SECONDARY)
    axes[0].annotate(f"best dice {best['dice']:.4f} @ {best['threshold']:.2f}",
                     color=TEXT_SECONDARY, fontsize=8, xy=(0.98, 0.02),
                     xycoords="axes fraction", ha="right")

    fig.suptitle(title or (f"threshold sweep — ROC AUC "
                           f"{report['roc_auc']:.4f}, PR AUC "
                           f"{report['pr_auc']:.4f}"),
                 color=TEXT_PRIMARY, fontsize=11, x=0.02, ha="left")
    fig.tight_layout(rect=(0, 0, 1, 0.92))
    fig.savefig(out_png, dpi=140)
    plt.close(fig)


def _run_label(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def _run_labels(paths: Sequence[str]) -> List[str]:
    """One label per input; basename collisions are disambiguated with the
    parent directory (two `expA/results.txt` vs `expB/results.txt` runs must
    not silently collapse into one dict entry)."""
    base = [_run_label(p) for p in paths]
    dupes = {lab for lab in base if base.count(lab) > 1}
    labels = []
    for p, lab in zip(paths, base):
        if lab in dupes:
            parent = os.path.basename(os.path.dirname(os.path.abspath(p)))
            lab = f"{parent}/{lab}"
        labels.append(lab)
    if len(set(labels)) != len(labels):
        raise ValueError(f"duplicate run inputs: {sorted(paths)}")
    return labels


def run(argv: Optional[Sequence[str]] = None) -> List[str]:
    p = argparse.ArgumentParser(
        description="Plot training curves from results .txt / metrics "
                    ".jsonl files (this framework's or the reference's)")
    p.add_argument("files", nargs="+",
                   help="*_results_*.txt or *_metrics_*.jsonl run logs")
    p.add_argument("--output", default=None,
                   help="output PNG (default: <run>_curves.png next to the "
                        "input; comparison default: compare_curves.png)")
    p.add_argument("--title", default=None)
    args = p.parse_args(argv)

    written: List[str] = []
    if len(args.files) == 1:
        path = args.files[0]
        if path.endswith(".json"):  # cli/test report artifacts
            with open(path) as f:
                report = json.load(f)
            out = args.output or os.path.splitext(path)[0] + ".png"
            if "patients" in report:
                render_patient_report(report, out, title=args.title)
            elif "rows" in report and "roc_auc" in report:
                render_threshold_sweep(report, out, title=args.title)
            else:
                raise SystemExit(
                    f"{path}: not a cli/test report artifact (expected a "
                    "patient_report.json with 'patients' or a "
                    "threshold_sweep.json with 'rows'+'roc_auc')")
            print(f"wrote {out}")
            return [out]
        out = args.output or os.path.splitext(path)[0] + "_curves.png"
        render_run(parse_run(path), out,
                   title=args.title or _run_label(path))
        written.append(out)
    else:
        labels = _run_labels(args.files)
        runs = {lab: parse_run(f) for lab, f in zip(labels, args.files)}
        out = args.output or "compare_curves.png"
        render_compare(runs, out)
        written.append(out)
    for w in written:
        print(f"wrote {w}")
    return written


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Command entry: returns an exit status, not the written-paths list;
    a render without matplotlib exits non-zero with a message naming
    it."""
    try:
        run(argv)
    except ImportError as e:
        raise SystemExit(f"error: {e}") from e
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
