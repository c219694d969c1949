"""Synthetic BreaDM slices, the benchmark's frozen copy of the scheme of
stf_unet_tpu_torch/data/synthetic.py: a body ellipse of N(90, 8) noise,
a bright ellipsoidal tumour whose intensity follows a wash-in curve over
the T frames, and its binary mask.

`slices` yields the arrays in order from one numpy seed, so the training
tree written from them and the reference that regenerates them hold the
same bytes (PNG is lossless). `write_tree` lays them out as the BreaDM
directory contract the port's index scanner reads:
<root>/seg/training/images/<patient>/VIBRANT+C<t>/<slice>.png and
<root>/seg/training/labels/<patient>/VIBRANT+C1/<slice>.png (tumour 255).
"""

from __future__ import annotations

import os
from typing import Iterator, Tuple

import numpy as np

SEQUENCE_PREFIX = "VIBRANT+C"


def one_slice(rng: np.random.Generator, size: int, time_steps: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(frames uint8 [T, size, size], mask uint8 [size, size] in {0, 1})."""
    h = w = size
    yy, xx = np.mgrid[0:h, 0:w]
    cy = rng.uniform(0.35, 0.65) * h
    cx = rng.uniform(0.35, 0.65) * w
    ry = rng.uniform(0.08, 0.18) * h
    rx = rng.uniform(0.08, 0.18) * w
    tumor = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) <= 1.0
    body = (((yy - h / 2) / (0.45 * h)) ** 2
            + ((xx - w / 2) / (0.45 * w)) ** 2) <= 1.0
    background = rng.normal(90, 8, (h, w)).clip(0, 255)
    background[~body] *= 0.1
    enhance = 1.0 - np.exp(-np.arange(time_steps, dtype=np.float64) / 1.5)
    frames = np.empty((time_steps, h, w), np.uint8)
    n_tumor = int(tumor.sum())
    for t in range(time_steps):
        frame = background.copy()
        frame[tumor] = np.clip(
            120 + 110 * enhance[t] + rng.normal(0, 4, n_tumor), 0, 255)
        frames[t] = frame.astype(np.uint8)
    return frames, tumor.astype(np.uint8)


def slices(seed: int, count: int, size: int, time_steps: int
           ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(seed)
    for _ in range(count):
        yield one_slice(rng, size, time_steps)


def tree_names(patients: int, per_patient: int):
    """(patient, slice file name) of each slice, in the order `slices`
    yields them and the index scanner sorts them."""
    return [(f"P{p:03d}", f"slice_{s:03d}.png") for p in range(patients)
            for s in range(per_patient)]


def write_tree(root: str, seed: int, patients: int, per_patient: int,
               size: int, time_steps: int) -> None:
    from PIL import Image

    base = os.path.join(root, "seg", "training")
    names = tree_names(patients, per_patient)
    for (patient, name), (frames, mask) in zip(
            names, slices(seed, len(names), size, time_steps)):
        for t in range(time_steps):
            d = os.path.join(base, "images", patient,
                             f"{SEQUENCE_PREFIX}{t + 1}")
            os.makedirs(d, exist_ok=True)
            Image.fromarray(frames[t]).save(os.path.join(d, name),
                                            compress_level=1)
        d = os.path.join(base, "labels", patient, f"{SEQUENCE_PREFIX}1")
        os.makedirs(d, exist_ok=True)
        Image.fromarray(mask * 255).save(os.path.join(d, name),
                                         compress_level=1)
