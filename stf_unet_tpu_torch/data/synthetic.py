"""Synthetic BreaDM-layout dataset factory (SURVEY.md §4 item 4).

Writes `<root>/seg/<split>/images/<patient>/<SEQ>/<slice>.png` + labels
(+ optional pk_maps) matching the directory contract the index scanner and
the reference dataset expect (ref:my_dataset.py:43-134). Slices contain a
bright ellipsoidal "tumor" whose intensity follows a plausible
contrast-enhancement curve over the T frames, so segmentation is learnable
and PK fitting produces nonzero maps.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
from PIL import Image


def make_synthetic_breadm(root: str, *, splits: Sequence[str] = ("training", "val", "test"),
                          patients_per_split: int = 2, slices_per_patient: int = 2,
                          size: int = 96, time_steps: int = 8,
                          sequence_prefix: str = "VIBRANT+C",
                          with_pk_maps: bool = False,
                          mask_classes: int = 1,
                          seed: int = 0) -> str:
    """mask_classes=1 writes reference-style binary masks (tumor=255,
    consumed via //255). mask_classes>1 writes INDEX masks: concentric
    radial bands of the tumor ellipse hold class indices 1..mask_classes
    (core = highest class), for driving the num_classes>1 flow end-to-end
    with DataConfig(mask_format="index")."""
    rng = np.random.default_rng(seed)
    seqs = [f"{sequence_prefix}{i}" for i in range(1, time_steps + 1)]
    for split in splits:
        base = os.path.join(root, "seg", split)
        for p in range(patients_per_split):
            patient = f"P{p:03d}"
            for s in range(slices_per_patient):
                name = f"slice_{s:03d}.png"
                h = w = size
                yy, xx = np.mgrid[0:h, 0:w]
                cy = rng.uniform(0.35, 0.65) * h
                cx = rng.uniform(0.35, 0.65) * w
                ry = rng.uniform(0.08, 0.18) * h
                rx = rng.uniform(0.08, 0.18) * w
                tumor = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) <= 1.0

                body = (((yy - h / 2) / (0.45 * h)) ** 2 +
                        ((xx - w / 2) / (0.45 * w)) ** 2) <= 1.0
                background = rng.normal(90, 8, (h, w)).clip(0, 255)
                background[~body] *= 0.1

                # Enhancement curve: tumor washes in fast then plateaus.
                t_axis = np.arange(time_steps, dtype=np.float64)
                enhance = 1.0 - np.exp(-t_axis / 1.5)
                for t in range(time_steps):
                    frame = background.copy()
                    frame[tumor] = np.clip(
                        120 + 110 * enhance[t] + rng.normal(0, 4, tumor.sum()),
                        0, 255)
                    img_dir = os.path.join(base, "images", patient, seqs[t])
                    os.makedirs(img_dir, exist_ok=True)
                    Image.fromarray(frame.astype(np.uint8)).save(
                        os.path.join(img_dir, name))

                mask_dir = os.path.join(base, "labels", patient, seqs[0])
                os.makedirs(mask_dir, exist_ok=True)
                if mask_classes > 1:
                    # Concentric class bands: normalized ellipse radius r in
                    # [0,1] maps outer->inner to classes 1..mask_classes.
                    r2 = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
                    band = np.ceil((1.0 - np.sqrt(np.clip(r2, 0.0, 1.0)))
                                   * mask_classes)
                    mask = np.where(tumor, np.clip(band, 1, mask_classes),
                                    0).astype(np.uint8)
                else:
                    mask = (tumor * 255).astype(np.uint8)
                Image.fromarray(mask).save(os.path.join(mask_dir, name))

            if with_pk_maps:
                pk_dir = os.path.join(base, "pk_maps", patient)
                os.makedirs(pk_dir, exist_ok=True)
                for pname in ("ktrans", "ve", "vp"):
                    arr = rng.integers(0, 255, (size, size), dtype=np.uint8)
                    Image.fromarray(arr).save(os.path.join(pk_dir, f"{pname}.png"))
    return root
