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

Several processes (data parallelism): a signal lands on ONE rank, but
the checkpoint save and every collective after it need all of them, so
a unilateral stop would hang the others. should_stop() therefore returns
the AGREED decision: every rank calls it at the same step index and the
local flags all-reduce with MAX on the host (gloo), so all ranks break at
the same boundary and reach the save together.
"""

from __future__ import annotations

import signal
import threading

import torch.distributed as dist

from stf_unet_tpu_torch.core import mesh as mesh_lib

_SIGNALS = (signal.SIGTERM, signal.SIGINT)


class PreemptionGuard:
    """Stop flag raised by SIGTERM, the first SIGINT (a second one
    interrupts at once) or `stop_after_steps > 0` completed steps, agreed
    across `num_hosts > 1` ranks of the process group (`group`, a
    core/mesh.DataGroup, names its host-side gloo group under NCCL)."""

    def __init__(self, num_hosts: int = 1, stop_after_steps: int = 0,
                 group=None):
        if num_hosts > 1 and not dist.is_initialized():
            raise RuntimeError(f"a stop agreed by {num_hosts} ranks needs "
                               "their process group (core/distributed)")
        self._num_hosts = int(num_hosts)
        self._group = group
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
        """The agreed stop decision. Call with increment=True once per
        completed train step, on every rank at the same step index
        (train_one_epoch does); increment=False polls at other points that
        every rank reaches (between epochs)."""
        if increment:
            self._steps += 1
        local = self._event.is_set() or (0 < self._stop_after <= self._steps)
        if self._num_hosts > 1:
            local = mesh_lib.agree_max(self._group, local)
        self._agreed = bool(local)
        return self._agreed

    @property
    def triggered(self) -> bool:
        """True once should_stop() has returned an agreed stop."""
        return self._agreed
