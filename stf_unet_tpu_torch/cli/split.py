"""Patient-level dataset splitting (counterpart of
stf_unet_tpu/cli/split.py). Host only: no device, no model.

The reference assumes a pre-split tree (`seg/{training,val,test}/...`,
ref:my_dataset.py:22-26) and offers nothing to create one. Users with a
fresh dataset need a split that is (a) PATIENT-level — slices of one
patient must never straddle train/test (slice leakage inflates every
metric), (b) deterministic, (c) non-destructive. this CLI takes an
unsplit pool

    <src>/images/<patient>/<SEQ>/<slice>.png
    <src>/labels/<patient>/<SEQ1>/<slice>.png
    <src>/pk_maps/<patient>/...          (optional)

and materializes the BreaDM layout under `<dest>/seg/<split>/` as
per-patient SYMLINKS (or copies with `--mode copy`): the source pool is
never modified, re-running with a different seed or fold just rewrites
links. Two assignment modes:

  * `--ratios 0.7,0.15,0.15` (default): seeded shuffle, contiguous cut
    into training/val/test.
  * `--kfold K --fold i`: cross-validation — test = fold i, val = fold
    (i+1) % K, train = the rest; the K runs cover every patient exactly
    once as test.

Usage: python -m stf_unet_tpu_torch.cli.split <src> [--dest D] [--seed 0]
       [--ratios 0.7,0.15,0.15 | --kfold 5 --fold 0] [--mode symlink|copy]
"""

from __future__ import annotations

import argparse
import os
import shutil
from typing import Dict, List, Optional, Sequence

SPLITS = ("training", "val", "test")  # ref:my_dataset.py:22-26 dir names


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Patient-level train/val/test splitting into the "
                    "BreaDM seg/ layout")
    p.add_argument("src", type=str,
                   help="unsplit pool: <src>/images/<patient>/..., "
                        "<src>/labels/<patient>/... (+ optional pk_maps/)")
    p.add_argument("--dest", type=str, default="",
                   help="root to create seg/ under (default: <src>)")
    p.add_argument("--ratios", type=str, default="0.7,0.15,0.15",
                   help="training,val,test patient fractions (sum to 1)")
    p.add_argument("--kfold", type=int, default=0,
                   help="K-fold cross-validation instead of --ratios")
    p.add_argument("--fold", type=int, default=0,
                   help="which fold is the TEST set (0..K-1); val = the "
                        "next fold, train = the rest")
    p.add_argument("--seed", type=int, default=0,
                   help="patient-shuffle seed (same seed = same split)")
    p.add_argument("--mode", type=str, default="symlink",
                   choices=["symlink", "copy"],
                   help="materialize patient dirs as symlinks (default; "
                        "non-destructive, instant) or full copies")
    p.add_argument("--force", action="store_true",
                   help="replace an existing <dest>/seg tree")
    return p.parse_args(argv)


def assign_patients(patients: List[str], *, seed: int,
                    ratios: Optional[Sequence[float]] = None,
                    kfold: int = 0, fold: int = 0) -> Dict[str, List[str]]:
    """patient -> split assignment; pure + deterministic for tests."""
    import numpy as np

    order = list(patients)
    np.random.default_rng(seed).shuffle(order)
    n = len(order)
    if kfold:
        if not 3 <= kfold <= n:
            raise SystemExit(f"--kfold must be in [3, {n} patients] "
                             "(2 folds leave no training patients), "
                             f"got {kfold}")
        if not 0 <= fold < kfold:
            raise SystemExit(f"--fold must be in [0, {kfold}), got {fold}")
        folds = [order[i::kfold] for i in range(kfold)]
        test = folds[fold]
        val = folds[(fold + 1) % kfold]
        train = [p for i, f in enumerate(folds)
                 if i not in (fold, (fold + 1) % kfold) for p in f]
        return _check_nonempty({"training": sorted(train),
                                "val": sorted(val), "test": sorted(test)})
    if ratios is None or len(ratios) != 3:
        raise SystemExit("--ratios needs exactly 3 comma-separated values")
    if abs(sum(ratios) - 1.0) > 1e-6 or min(ratios) < 0:
        raise SystemExit(f"--ratios must be >= 0 and sum to 1, got {ratios}")
    n_train = round(n * ratios[0])
    n_val = round(n * ratios[1])
    if n_train + n_val > n:
        n_val = n - n_train
    return _check_nonempty({"training": sorted(order[:n_train]),
                            "val": sorted(order[n_train:n_train + n_val]),
                            "test": sorted(order[n_train + n_val:])})


def _check_nonempty(assignment: Dict[str, List[str]]) -> Dict[str, List[str]]:
    """An empty split is never usable (--kfold 2 leaves train empty;
    a 0 ratio empties its split): fail at assignment time, not when
    cli/train later finds no seg/training."""
    empty = [s for s, p in assignment.items() if not p]
    if empty:
        raise SystemExit(
            f"split(s) {empty} would be EMPTY with this configuration "
            f"({ {s: len(p) for s, p in assignment.items()} }) — use more "
            "patients, a larger --kfold, or nonzero ratios")
    return assignment


def split(args: argparse.Namespace) -> dict:
    src = os.path.abspath(args.src)
    img_root = os.path.join(src, "images")
    lbl_root = os.path.join(src, "labels")
    pk_root = os.path.join(src, "pk_maps")
    if not os.path.isdir(img_root) or not os.path.isdir(lbl_root):
        raise SystemExit(f"expected {src}/images and {src}/labels "
                         "patient pools (unsplit layout)")
    dest = os.path.abspath(args.dest) if args.dest else src
    seg = os.path.join(dest, "seg")
    if os.path.exists(seg):
        if not args.force:
            raise SystemExit(f"{seg} already exists — pass --force to "
                             "replace it")
        shutil.rmtree(seg)

    patients = []
    for p in sorted(os.listdir(img_root)):
        if not os.path.isdir(os.path.join(img_root, p)):
            continue
        if not os.path.isdir(os.path.join(lbl_root, p)):
            # warn-and-skip, the dataset scan's convention (ref:124-126)
            print(f"Warning: no labels for patient {p} — skipping")
            continue
        patients.append(p)
    if len(patients) < 3:
        raise SystemExit(f"need at least 3 labeled patients to split, "
                         f"found {len(patients)}")

    ratios = None
    if not args.kfold:
        try:
            ratios = [float(v) for v in args.ratios.split(",")]
        except ValueError:
            raise SystemExit(f"--ratios must be comma-separated floats, "
                             f"got {args.ratios!r}")
    assignment = assign_patients(patients, seed=args.seed, ratios=ratios,
                                 kfold=args.kfold, fold=args.fold)

    def materialize(split_name: str, kind_root: str, kind: str,
                    patient: str) -> None:
        src_dir = os.path.join(kind_root, patient)
        if not os.path.isdir(src_dir):
            return  # pk_maps are optional per patient
        dst_dir = os.path.join(seg, split_name, kind, patient)
        os.makedirs(os.path.dirname(dst_dir), exist_ok=True)
        if args.mode == "copy":
            shutil.copytree(src_dir, dst_dir)
        else:
            os.symlink(src_dir, dst_dir)

    has_pk = os.path.isdir(pk_root)
    for split_name, plist in assignment.items():
        for patient in plist:
            materialize(split_name, img_root, "images", patient)
            materialize(split_name, lbl_root, "labels", patient)
            if has_pk:
                materialize(split_name, pk_root, "pk_maps", patient)

    counts = {s: len(p) for s, p in assignment.items()}
    how = (f"kfold={args.kfold} fold={args.fold}" if args.kfold
           else f"ratios={args.ratios}")
    print(f"Split {len(patients)} patients ({how}, seed={args.seed}, "
          f"{args.mode}) under {seg}:")
    for s in SPLITS:
        print(f"  {s:<9} {counts[s]:>4} patients: "
              + ", ".join(assignment[s][:6])
              + (" ..." if counts[s] > 6 else ""))
    return {"dest": dest, "assignment": assignment, "counts": counts}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    return split(parse_args(argv))


if __name__ == "__main__":
    main()
