"""Dataset mean/std tool (counterpart of stf_unet_tpu/cli/stats.py;
ref:compute_mean_std.py). Host only: numpy and PIL.

The reference averages per-image mean and per-image std over a flat images
dir (and notably does NOT recurse into the per-patient/sequence layout its
own dataset uses — SURVEY §2.2 calls this vestigial). This version supports
both: a flat directory of images, or a BreaDM root (recursing through
seg/training/images/<patient>/<SEQ>/).

Usage: python -m stf_unet_tpu_torch.cli.stats <path> [--flat]
"""

from __future__ import annotations

import argparse
import os
from typing import List, Tuple

import numpy as np
from PIL import Image

IMG_EXTS = (".jpg", ".png", ".jpeg")


def collect_images(path: str, flat: bool = False) -> List[str]:
    if flat:
        return sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.lower().endswith(IMG_EXTS))
    breadm_images = os.path.join(path, "seg", "training", "images")
    base = breadm_images if os.path.isdir(breadm_images) else path
    out: List[str] = []
    for root, _, files in os.walk(base):
        out.extend(os.path.join(root, f) for f in sorted(files)
                   if f.lower().endswith(IMG_EXTS))
    return sorted(out)


def compute_mean_std(paths: List[str]) -> Tuple[float, float]:
    """Mean of per-image mean and per-image std, on [0,1] intensities
    (ref:compute_mean_std.py:24-55)."""
    if not paths:
        raise ValueError("no images found")
    means, stds = [], []
    for p in paths:
        with Image.open(p) as im:
            arr = np.asarray(im.convert("L"), dtype=np.float64) / 255.0
        means.append(arr.mean())
        stds.append(arr.std())
    return float(np.mean(means)), float(np.mean(stds))


def main(argv=None) -> Tuple[float, float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("path")
    ap.add_argument("--flat", action="store_true",
                    help="treat path as a flat images dir")
    args = ap.parse_args(argv)
    paths = collect_images(args.path, args.flat)
    mean, std = compute_mean_std(paths)
    print(f"images: {len(paths)}")
    print(f"mean: {mean:.4f}")
    print(f"std: {std:.4f}")
    return mean, std


if __name__ == "__main__":
    main()
