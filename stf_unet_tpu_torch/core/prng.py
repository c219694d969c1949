"""Seeded random streams (counterpart of stf_unet_tpu/core/prng.py).

One root seed; per-purpose streams derived from stable integers. The
augmentation stream mixes in (epoch, step), so a run resumed at an epoch
replays the same draws. The JAX package folds these integers into
threefry keys; here they seed a CPU torch.Generator through numpy's
SeedSequence hash. The two give different numbers by design; the
augmentation distribution is the same.
"""

from __future__ import annotations

import numpy as np
import torch

# Stable stream ids, as in the JAX package (which also numbers dropout 2
# and PK 3).
STREAM_INIT = 0
STREAM_AUGMENT = 1


def stream_seed(seed: int, stream_id: int, *fold: int) -> int:
    """A 63-bit seed hashed from (seed, stream_id, *fold)."""
    words = [int(seed), int(stream_id), *(int(v) for v in fold)]
    state = np.random.SeedSequence([w & 0xFFFFFFFF for w in words]
                                   + [len(words)]).generate_state(2)
    return int(state[0]) << 31 ^ int(state[1])


def generator(seed: int, stream_id: int, *fold: int) -> torch.Generator:
    """A CPU torch.Generator for one stream (optionally folded further)."""
    return torch.Generator().manual_seed(stream_seed(seed, stream_id, *fold))


def augment_generator(seed: int, epoch: int, step: int) -> torch.Generator:
    """The augmentation draws of one training step."""
    return generator(seed, STREAM_AUGMENT, epoch, step)
