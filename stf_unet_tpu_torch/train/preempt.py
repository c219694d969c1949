"""Graceful preemption and step-boxed training (counterpart of
stf_unet_tpu/train/preempt.py; no reference counterpart).

Spot and maintenance preemptions send SIGTERM with a short grace window;
the reference trainer (ref:train.py:124-401) would die mid-epoch and lose
everything since the last epoch-end save. `PreemptionGuard` turns the
signal (or a `--stop-after-steps` budget) into a stop at the next
train-step boundary, so cli/train writes a STEP-EXACT checkpoint (`epoch`
and `step_in_epoch`, and under --grad-accum the partly accumulated
gradients) and exits cleanly. `--resume` re-enters the same epoch at the
interrupted step: the seeded per-epoch shuffle reproduces the remaining
batches (HostLoader.epoch skip_batches) and the per-(epoch, step)
augmentation generator the draws, so a stopped-and-resumed run is
bit-identical to an uninterrupted one (tests/test_torch_preempt.py).

One process only: the JAX package's cross-host agreement on the stop
waits for the port's process group (ROADMAP.md §1, 'data parallelism').
"""

from __future__ import annotations

import signal
import threading

_SIGNALS = (signal.SIGTERM, signal.SIGINT)


class PreemptionGuard:
    """Stop flag raised by SIGTERM, the first SIGINT (a second one
    interrupts at once) or `stop_after_steps > 0` completed steps."""

    def __init__(self, num_hosts: int = 1, stop_after_steps: int = 0):
        if num_hosts > 1:
            raise NotImplementedError(
                "a stop agreed across hosts is not ported to the PyTorch "
                "package yet (ROADMAP.md §1, 'data parallelism')")
        self._event = threading.Event()
        self._stop_after = int(stop_after_steps)
        self._steps = 0
        self._agreed = False
        self._installed = []
        try:
            for sig in _SIGNALS:
                self._installed.append((sig, signal.signal(sig,
                                                           self._handle)))
        except ValueError:
            # signal.signal works on the main thread only; driven from
            # another thread, the step budget still works.
            self._installed = []

    def _handle(self, signum, frame):
        if self._event.is_set() and signum == signal.SIGINT:
            raise KeyboardInterrupt  # second Ctrl-C: abort immediately
        self._event.set()

    def uninstall(self) -> None:
        for sig, prev in self._installed:
            signal.signal(sig, prev)
        self._installed = []

    def should_stop(self, increment: bool = True) -> bool:
        """The stop decision. Call with increment=True once per completed
        train step (train_one_epoch does); increment=False polls between
        epochs."""
        if increment:
            self._steps += 1
        self._agreed = self._event.is_set() or (
            0 < self._stop_after <= self._steps)
        return self._agreed

    @property
    def triggered(self) -> bool:
        """True once should_stop() has returned a stop."""
        return self._agreed
