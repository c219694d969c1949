"""Dataset diagnostics: explain a BreaDM tree's health (counterpart of
stf_unet_tpu/cli/doctor.py, on the port's data/index and DataConfig;
host only: numpy and PIL).

Usage: python -m stf_unet_tpu_torch.cli.doctor --data-path <BreaDM root>
       [--splits train,val,test] [--use-subtraction | --sequence-types ..]
       [--use-pk-maps] [--mask-format binary|index] [--num-classes 1]
       [--decode] [--class-stats] [--json]

The index scanner warn-and-skips incomplete patients/slices with one-line
notices (ref:my_dataset.py:69-126, data/index.py) — correct for training,
but a user whose sample count silently dropped needs the full picture.
This CLI walks the tree and reports every issue it can find, per split:

  * missing split / images / labels directories
  * patients missing sequence directories (ALL of them, not just the first)
  * slices present in the first sequence but missing from others
  * slices with no mask, and orphan masks with no image
  * empty (0-byte) files and files whose header magic is not JPEG/PNG
  * per-slice frame size mismatches across sequences (--decode)
  * mask pixel values outside the declared format (--decode)
  * missing PK maps (when --use-pk-maps)
  * cross-split patient LEAKAGE: identical image content under the same
    patient id in two splits (test-score memorization)
  * per-class pixel frequencies + suggested inverse-frequency
    --loss-class-weights (--class-stats)

Exit code: 0 = clean (possibly with skip warnings), 1 = damaged files or
an unusable split. --json emits the report as machine-readable JSON.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Sequence

from stf_unet_tpu_torch.core.config import DataConfig
from stf_unet_tpu_torch.data.index import IMG_EXTS, MODE_DIRS

_JPEG_MAGIC = b"\xff\xd8\xff"
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def _file_issue(path: str) -> Optional[str]:
    """Cheap integrity probe: size + header magic (full decode is --decode)."""
    try:
        size = os.path.getsize(path)
    except OSError as e:
        return f"unreadable ({e.__class__.__name__})"
    if size == 0:
        return "empty file (0 bytes)"
    with open(path, "rb") as f:
        head = f.read(8)
    if path.lower().endswith(".jpg") and not head.startswith(_JPEG_MAGIC):
        return "not a JPEG (bad header magic)"
    if path.lower().endswith(".png") and not head.startswith(_PNG_MAGIC):
        return "not a PNG (bad header magic)"
    return None


def _decode_shape(path: str):
    from PIL import Image
    try:
        with Image.open(path) as im:
            # Image.open only parses the header; load() forces the full
            # pixel decode, which is what catches truncated files.
            im.load()
            return im.size  # (w, h)
    except Exception as e:
        return f"decode failed ({e.__class__.__name__})"


def check_split(root: str, mode: str, sequence_types: Sequence[str], *,
                use_pk_maps: bool = False, mask_format: str = "binary",
                num_classes: int = 1, decode: bool = False) -> Dict:
    """Walk one split; returns {mode, usable, errors: [...], warnings: [...]}.

    `usable` counts exactly the samples DatasetIndex would serve (same
    skip rules, ref:my_dataset.py:69-126) — asserted equal in tests."""
    report: Dict = {"mode": mode, "usable": 0, "errors": [], "warnings": []}
    err, warn = report["errors"].append, report["warnings"].append

    if mode not in MODE_DIRS:
        err(f"unknown split {mode!r}: valid splits are "
            f"{sorted(MODE_DIRS)} (the on-disk dirs are "
            f"{sorted(set(MODE_DIRS.values()))})")
        return report
    data_root = os.path.join(root, "seg", MODE_DIRS[mode])
    img_dir = os.path.join(data_root, "images")
    mask_dir = os.path.join(data_root, "labels")
    missing_dirs = [p for p in (data_root, img_dir, mask_dir)
                    if not os.path.exists(p)]
    if missing_dirs:
        err(f"missing directories: {missing_dirs}")
        return report

    patients = sorted(os.listdir(img_dir))
    if not patients:
        err(f"no patients under {img_dir}")
    for patient in patients:
        patient_img = os.path.join(img_dir, patient)
        patient_mask = os.path.join(mask_dir, patient)
        if not os.path.isdir(patient_img):
            warn(f"{patient}: stray non-directory entry under images/")
            continue
        if not os.path.isdir(patient_mask):
            warn(f"{patient}: no labels/{patient} directory "
                 f"-> patient skipped")
            continue

        missing_seq = [s for s in sequence_types
                       if not os.path.isdir(os.path.join(patient_img, s))]
        if missing_seq:
            warn(f"{patient}: missing sequence dirs {missing_seq} "
                 f"-> patient skipped")
            continue

        if use_pk_maps and not os.path.exists(
                os.path.join(data_root, "pk_maps", patient)):
            warn(f"{patient}: no pk_maps/{patient} -> patient skipped "
                 "(generate with --generate-pk-maps or pk.maps)")
            continue

        first_seq_dir = os.path.join(patient_img, sequence_types[0])
        slices = sorted(f for f in os.listdir(first_seq_dir)
                        if f.endswith(IMG_EXTS))
        if not slices:
            warn(f"{patient}: no image slices in first sequence "
                 f"{sequence_types[0]}")

        # slices that exist in later sequences but not the first are
        # invisible to the scanner (it iterates the first sequence)
        for seq in sequence_types[1:]:
            extras = sorted(
                set(f for f in os.listdir(os.path.join(patient_img, seq))
                    if f.endswith(IMG_EXTS)) - set(slices))
            if extras:
                warn(f"{patient}/{seq}: slices not present in "
                     f"{sequence_types[0]} (never served): {extras}")

        mask_seq_dir = os.path.join(patient_mask, sequence_types[0])
        mask_files = (set(os.listdir(mask_seq_dir))
                      if os.path.isdir(mask_seq_dir) else set())

        for img_file in slices:
            base = os.path.splitext(img_file)[0]
            missing_in = [seq for seq in sequence_types
                          if not os.path.exists(
                              os.path.join(patient_img, seq, img_file))]
            if missing_in:
                warn(f"{patient}/{img_file}: missing from sequences "
                     f"{missing_in} -> slice skipped")
                # the slice HAS an image in the first sequence, so its mask
                # (if any) is not an orphan — don't report it as one below
                for ext in (".png", ".jpg"):
                    mask_files.discard(base + ext)
                continue
            mask_path = None
            for ext in (".png", ".jpg"):
                cand = os.path.join(mask_seq_dir, base + ext)
                if os.path.exists(cand):
                    mask_path = cand
                    mask_files.discard(base + ext)
                    break
            if mask_path is None:
                warn(f"{patient}/{img_file}: no mask -> slice skipped")
                continue

            damaged = False
            shapes = {}
            for seq in sequence_types:
                path = os.path.join(patient_img, seq, img_file)
                issue = _file_issue(path)
                if issue:
                    err(f"{patient}/{seq}/{img_file}: {issue}")
                    damaged = True
                elif decode:
                    shapes[seq] = _decode_shape(path)
            issue = _file_issue(mask_path)
            if issue:
                err(f"{patient}/mask {base}: {issue}")
                damaged = True

            if decode and not damaged:
                bad = {s: v for s, v in shapes.items() if isinstance(v, str)}
                for s, v in bad.items():
                    err(f"{patient}/{s}/{img_file}: {v}")
                sizes = {v for v in shapes.values() if not isinstance(v, str)}
                if len(sizes) > 1:
                    warn(f"{patient}/{img_file}: frame sizes differ across "
                         f"sequences {sorted(sizes)} (loader pads to the "
                         "canvas; the reference would mis-stack)")
                mask_issue = _check_mask_values(mask_path, mask_format,
                                                num_classes)
                if mask_issue:
                    is_damage, msg = mask_issue
                    # an undecodable mask is damage (exit 1), same as an
                    # undecodable frame; out-of-range values are advisory
                    (err if is_damage else warn)(f"{patient}/mask {base}: "
                                                 f"{msg}")
            # Damaged files still count: the scanner only checks existence
            # (decode failures surface later via loader failure isolation),
            # so `usable` stays == len(DatasetIndex) by construction.
            report["usable"] += 1
        if mask_files:
            warn(f"{patient}: orphan masks with no image slice: "
                 f"{sorted(mask_files)}")
    if report["usable"] == 0:
        err(f"split has NO usable samples (sequence types "
            f"{list(sequence_types)})")
    return report


def _check_mask_values(mask_path: str, mask_format: str,
                       num_classes: int):
    """Returns None, or (is_damage, message). is_damage=True means the mask
    cannot be decoded at all (an error); False = advisory value-range note."""
    import numpy as np
    from PIL import Image
    try:
        with Image.open(mask_path) as im:
            vals = np.unique(np.asarray(im.convert("L")))
    except Exception as e:
        return True, f"mask decode failed ({e.__class__.__name__})"
    if mask_format == "binary":
        odd = [int(v) for v in vals if v not in (0, 255)]
        if odd:
            return False, (f"binary mask has values {odd[:8]} besides 0/255 "
                           "— the //255 label decode "
                           "(ref:my_dataset.py:166-168) maps them ALL to 0; "
                           "use --mask-format index for multiclass labels")
    else:
        n = num_classes + 1
        odd = [int(v) for v in vals if v >= n and v != 255]
        if odd:
            return False, (f"index mask has values {odd[:8]} >= "
                           f"num_classes+1={n} (255 = ignore)")
    return None


def class_pixel_stats(root: str, mode: str, sequence_types: Sequence[str],
                      *, mask_format: str = "binary",
                      num_classes: int = 1) -> Optional[Dict]:
    """Per-class pixel counts over exactly the masks training would serve
    (DatasetIndex's records), decoded with the loader's label semantics:
    binary -> //255 (ref:my_dataset.py:166-168), index -> values are class
    ids with 255 = ignore. Returns {"counts": [per-class pixels],
    "ignored": n, "weights": suggested inverse-frequency
    --loss-class-weights (mean 1 over non-empty classes)} or None when the
    split cannot be indexed."""
    import contextlib
    import io

    import numpy as np
    from PIL import Image

    from stf_unet_tpu_torch.data.index import DatasetIndex

    try:
        with contextlib.redirect_stdout(io.StringIO()):
            index = DatasetIndex(root=root, mode=mode,
                                 sequence_types=tuple(sequence_types))
    except (FileNotFoundError, ValueError, RuntimeError):
        return None

    n = num_classes + 1
    counts = np.zeros(n, np.int64)
    ignored = 0
    skipped = 0
    for rec in index.records:
        try:
            with Image.open(rec.mask_path) as im:
                m = np.asarray(im.convert("L"))
        except Exception:
            # Damaged masks are diagnosed in detail by check_split --decode;
            # here the count is surfaced so --class-stats without --decode
            # never silently reports frequencies over a partial mask set.
            skipped += 1
            continue
        m = m.reshape(-1)
        if mask_format == "binary":
            m = m // 255
            valid = np.ones(m.shape, bool)
        else:
            # 255 = ignore; values >= num_classes+1 are out of range
            # (check_split --decode warns about them) — count both under
            # "ignored" rather than misattributing to a class.
            valid = m < n
            ignored += int((~valid).sum())
        counts += np.bincount(m[valid], minlength=n)[:n]
    total = int(counts.sum())
    if total <= 0:
        return None
    # Inverse-frequency weights, normalized to mean 1 over non-empty
    # classes so the loss scale stays comparable to the unweighted run.
    nonzero = counts > 0
    inv = np.zeros(n, np.float64)
    inv[nonzero] = 1.0 / counts[nonzero]
    inv *= nonzero.sum() / inv.sum()
    return {"counts": [int(c) for c in counts], "ignored": ignored,
            "skipped": skipped,
            "weights": [round(float(w), 4) if z else None
                        for w, z in zip(inv, nonzero)]}


def format_class_stats(mode: str, stats: Dict) -> List[str]:
    counts = stats["counts"]
    total = max(sum(counts), 1)
    pct = " | ".join(f"class {i}: {100.0 * c / total:.2f}%"
                     for i, c in enumerate(counts))
    lines = [f"  class pixels: {pct}"
             + (f" (+{stats['ignored']} ignore-255)"
                if stats["ignored"] else "")]
    if stats.get("skipped"):
        lines.append(f"  warning: {stats['skipped']} masks failed to decode "
                     "and are EXCLUDED from these stats — run --decode for "
                     "per-file diagnostics")
    has_empty = any(w is None for w in stats["weights"])
    if has_empty:
        empty = [i for i, w in enumerate(stats["weights"]) if w is None]
        lines.append(f"  classes with ZERO pixels: {empty} — check "
                     "--num-classes / --mask-format before weighting")
    if mode == "train":
        if has_empty:
            # No copy-pasteable vector with hard zeros: a class absent from
            # train but present in val/test would get its CE contribution
            # zeroed entirely if the user pasted a 0 weight.
            lines.append("  no --loss-class-weights suggestion: zero-pixel "
                         "classes make inverse-frequency weights undefined "
                         "(a 0 weight would silence that class's loss)")
        else:
            ws = ",".join(f"{w:g}" for w in stats["weights"])
            lines.append("  suggested inverse-frequency "
                         f"--loss-class-weights {ws}")
    return lines


def format_report(reports: List[Dict]) -> str:
    lines = []
    for r in reports:
        lines.append(f"[{r['mode']}] usable samples: {r['usable']}")
        for e in r["errors"]:
            lines.append(f"  ERROR   {e}")
        for w in r["warnings"]:
            lines.append(f"  warning {w}")
        if r.get("class_stats"):
            lines.extend(format_class_stats(r["mode"], r["class_stats"]))
    total_err = sum(len(r["errors"]) for r in reports)
    total_warn = sum(len(r["warnings"]) for r in reports)
    lines.append(f"summary: {sum(r['usable'] for r in reports)} usable "
                 f"samples, {total_err} errors, {total_warn} warnings")
    return "\n".join(lines)


def _leakage_errors(data_path: str, modes: Sequence[str]) -> List[str]:
    """Cross-split patient leakage: a patient whose image CONTENT appears
    in two splits means the test score is partly memorization — an ERROR.
    Same patient ID with different content is left alone (id schemes may
    restart per split; content is the evidence). Detection: for ids shared
    between two splits, hash every image file — any relative path with an
    identical digest in both splits is a duplicated slice."""
    import hashlib

    def patient_dirs(mode: str) -> Dict[str, str]:
        d = os.path.join(data_path, "seg", MODE_DIRS.get(mode, mode),
                         "images")
        if not os.path.isdir(d):
            return {}
        return {p: os.path.join(d, p) for p in os.listdir(d)
                if os.path.isdir(os.path.join(d, p))}

    def digests(pdir: str) -> Dict[str, str]:
        out = {}
        for base, _, files in os.walk(pdir):
            for f in files:
                path = os.path.join(base, f)
                try:
                    with open(path, "rb") as fh:
                        out[os.path.relpath(path, pdir)] = hashlib.sha1(
                            fh.read()).hexdigest()
                except OSError:
                    pass
        return out

    split_patients = {m: patient_dirs(m) for m in modes}
    errors = []
    seen = [m for m in modes if split_patients[m]]
    for i, a in enumerate(seen):
        for b in seen[i + 1:]:
            leaked = []
            for pid in sorted(set(split_patients[a]) & set(split_patients[b])):
                da = digests(split_patients[a][pid])
                db = digests(split_patients[b][pid])
                if any(da.get(rel) == dig for rel, dig in db.items()):
                    leaked.append(pid)
            if leaked:
                errors.append(
                    f"patient leakage between {a} and {b} (identical "
                    "image content): " + ", ".join(leaked[:8])
                    + (" ..." if len(leaked) > 8 else ""))
    return errors


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="Diagnose a BreaDM dataset tree (why samples skip)")
    p.add_argument("--data-path", default="./BreaDM")
    p.add_argument("--splits", default="train,val,test")
    p.add_argument("--use-subtraction", action="store_true")
    p.add_argument("--sequence-types", default=None)
    p.add_argument("--use-pk-maps", action="store_true")
    p.add_argument("--mask-format", default="binary",
                   choices=("binary", "index"))
    p.add_argument("--num-classes", type=int, default=1)
    p.add_argument("--decode", action="store_true",
                   help="fully decode every image: catches truncated "
                        "files, cross-sequence size mismatches, and "
                        "out-of-range mask values (slower)")
    p.add_argument("--class-stats", action="store_true",
                   help="decode every served mask and report per-class "
                        "pixel frequencies + a suggested inverse-frequency "
                        "--loss-class-weights (from the train split)")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    seq = (tuple(s.strip() for s in args.sequence_types.split(",")
                 if s.strip()) if args.sequence_types
           else DataConfig(
               use_subtraction=args.use_subtraction).resolved_sequence_types)
    reports = []
    modes = [m.strip() for m in args.splits.split(",") if m.strip()]
    for mode in modes:
        try:
            report = check_split(
                args.data_path, mode, seq, use_pk_maps=args.use_pk_maps,
                mask_format=args.mask_format, num_classes=args.num_classes,
                decode=args.decode)
            if args.class_stats:
                report["class_stats"] = class_pixel_stats(
                    args.data_path, mode, seq,
                    mask_format=args.mask_format,
                    num_classes=args.num_classes)
            reports.append(report)
        except FileNotFoundError as e:
            reports.append({"mode": mode, "usable": 0,
                            "errors": [str(e)], "warnings": []})

    leak_errors = _leakage_errors(args.data_path, modes)
    if leak_errors:
        reports.append({"mode": "cross-split", "usable": 0,
                        "errors": leak_errors, "warnings": []})
    if args.json:
        print(json.dumps(reports, indent=2))
    else:
        print(format_report(reports))
    return 1 if any(r["errors"] for r in reports) else 0


if __name__ == "__main__":
    raise SystemExit(main())
