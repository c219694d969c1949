"""Faults planted under the timed path, each a context manager: a run
inside one must come out with `correct` false. Used by the tests
(portbench/tests/test_portbench_faults.py, on the CPU at a small size)
and by tools/readings.py, which reads each fault's numbers on the card.

  unchanged_state  the training step returns its state unchanged: AdamW
                   applies nothing;
  half_batch       the training step sees half of its batch, the loss
                   the mean over the rest.
(The training cells run on one card: no exchange between cards to leave
out.)
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, name, make):
    inner = getattr(owner, name)
    setattr(owner, name, make(inner))
    try:
        yield
    finally:
        setattr(owner, name, inner)


def unchanged_state():
    return _patched(torch.optim.AdamW, "step",
                    lambda inner: lambda self, closure=None: None)


def half_batch():
    from stf_unet_tpu_torch.train import loop

    def make(inner):
        def step(state, augment, batch, *args, **kwargs):
            if isinstance(batch, loop.DeviceBatch):
                n = batch.frames.shape[0] // 2
                batch = loop.DeviceBatch(
                    batch.frames[:n], batch.masks[:n],
                    None if batch.pk is None else batch.pk[:n],
                    batch.sizes[:n], batch.ready)
            else:
                n = batch.frames.shape[0] // 2
                batch = type(batch)(batch.frames[:n], batch.masks[:n],
                                    batch.sizes[:n],
                                    None if batch.pk is None
                                    else batch.pk[:n])
            return inner(state, augment, batch, *args, **kwargs)
        return step

    return _patched(loop, "train_step", make)


TRAINING = {"unchanged_state": unchanged_state, "half_batch": half_batch}
