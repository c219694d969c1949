"""The training step replayed as one CUDA graph (train/loop.train_step
under train_one_epoch).

Where it engages (`mode`, a function of the state and the batch): a CUDA
device, one process (state.group None: no DDP, no row sharding), no
accumulation window (grad_accum 1), no NaN check and no anomaly mode.
Anything else runs the eager step. The step's device work, the
train-mode forward, the criterion, the backward and the fused AdamW
apply, is captured once per `signature` (the shapes and dtypes of the
augmented images and targets, the PK maps among the images' planes; the
class count and the loss weights), as PyTorch's whole-network recipe
has it:

- "warm": a signature's first step runs eagerly on a side stream, so
  that what is made lazily (AdamW's moments, the libraries' workspaces)
  exists before a capture;
- "capture": its next step, if it follows at once, unsets the gradients
  (the capture allocates them in the graph's private memory pool, and
  each replay overwrites them in place), captures the step on the side
  stream with AdamW's lr a one-element device tensor, and replays it;
- "replay": each later step copies its augmented batch into the graph's
  static buffers, fills the schedule's lr into that tensor and replays.

AdamW stays the fused one, its groups marked capturable; its arithmetic
is unchanged but for the lr, which a replay reads in float32. The EMA
update, when on, runs eagerly after the replay: its warmup decay changes
every step. A replay leaves the parameters, AdamW's moments and step
count and the BN statistics where the eager step would, so either path
can follow the other.

One graph is held (TrainState.step_graph): capturing another signature
drops it, a signature met in no two steps in a row (an epoch's ragged
last batch) runs warm beside it, and an optimizer whose state was
replaced (load_state_dict) is captured again. `LaunchDelta` keeps the
kernels' launch counters (`.launches`, ops/kernels and
ops/window_attention) counting what each replay launches.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import torch

_SIDE: Dict[torch.device, "torch.cuda.Stream"] = {}


def counted_kernels() -> List[Callable]:
    """The hand-written kernels' wrappers and the window-attention op,
    each counting its launches (the op: its calls)."""
    from stf_unet_tpu_torch.ops.kernels.batch_norm import (
        batch_norm_backward, batch_norm_forward)
    from stf_unet_tpu_torch.ops.kernels.lstm_last import lstm_last
    from stf_unet_tpu_torch.ops.kernels.lstm_last_x import lstm_last_x
    from stf_unet_tpu_torch.ops.kernels.lstm_last_x_bwd import \
        lstm_last_x_bwd
    from stf_unet_tpu_torch.ops.kernels.quant import (dequant_epilogue,
                                                      quantize_patches)
    from stf_unet_tpu_torch.ops.kernels.tofts import tofts_sums
    from stf_unet_tpu_torch.ops.kernels.warp import warp
    from stf_unet_tpu_torch.ops.window_attention import window_attention

    return [lstm_last_x, lstm_last_x_bwd, lstm_last, warp, tofts_sums,
            quantize_patches, dequant_epilogue, window_attention,
            batch_norm_forward, batch_norm_backward]


class LaunchDelta:
    """The launches a captured step makes: a capture runs the kernels'
    wrappers once and launches nothing, so its counts are taken back when
    it closes, and added again at every replay."""

    def __init__(self, kernels: Optional[Sequence[Callable]] = None):
        self.kernels = list(counted_kernels() if kernels is None
                            else kernels)
        self.delta = [0] * len(self.kernels)

    @contextlib.contextmanager
    def capturing(self) -> Iterator[None]:
        before = [k.launches for k in self.kernels]
        try:
            yield
        finally:
            self.delta = [k.launches - b
                          for k, b in zip(self.kernels, before)]
            for k, b in zip(self.kernels, before):
                k.launches = b

    def replayed(self) -> None:
        for k, d in zip(self.kernels, self.delta):
            k.launches += d


def signature(images: torch.Tensor, targets: torch.Tensor,
              num_classes: int,
              loss_weight: Optional[torch.Tensor]) -> tuple:
    """What a captured step is fixed to, besides its state: the batch's
    shapes and dtypes, the class count and the loss weights' tensor."""
    return (tuple(images.shape), images.dtype, tuple(targets.shape),
            targets.dtype, num_classes,
            None if loss_weight is None else id(loss_weight))


def mode(state, device: torch.device, sig: tuple) -> str:
    """How a step of train_one_epoch runs (module docstring): "eager",
    "warm", "capture" or "replay"."""
    if (device.type != "cuda" or state.group is not None
            or state.grad_accum != 1 or state.nan_check is not None
            or torch.is_anomaly_enabled()):
        return "eager"
    held = state.step_graph
    if (held is not None and held.signature == sig
            and held.opt_state is state.optimizer.state):
        return "replay"
    return "capture" if state.last_signature == sig else "warm"


def side_stream(device: torch.device) -> "torch.cuda.Stream":
    """The stream a signature's first step and its capture run on."""
    if device not in _SIDE:
        _SIDE[device] = torch.cuda.Stream(device)
    return _SIDE[device]


def warm(step: Callable[[], torch.Tensor],
         inputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """step() (the eager step on `inputs`, made on the current stream)
    run on the side stream, the current stream waiting for it; its
    loss."""
    device = inputs[0].device
    current = torch.cuda.current_stream(device)
    side = side_stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        loss = step()
    current.wait_stream(side)
    for t in inputs:  # freed when the step returns, read on the side
        t.record_stream(side)
    loss.record_stream(current)
    return loss


class StepGraph:
    """A captured training step: the graph and its memory pool, the
    static inputs (images, targets) and lr it reads, the loss it leaves,
    and the launches of a replay."""

    def __init__(self, sig: tuple, images: torch.Tensor,
                 targets: torch.Tensor,
                 loss_weight: Optional[torch.Tensor], opt_state):
        self.signature = sig
        self.images = torch.empty_like(images)
        self.targets = torch.empty_like(targets)
        self.lr = torch.zeros((), dtype=torch.float32, device=images.device)
        self.loss_weight = loss_weight  # held: its id is in the signature
        self.opt_state = opt_state
        self.graph = torch.cuda.CUDAGraph()
        self.launches = LaunchDelta()
        self.loss: Optional[torch.Tensor] = None

    def _load(self, images: torch.Tensor, targets: torch.Tensor,
              lr: float) -> None:
        self.images.copy_(images)
        self.targets.copy_(targets)
        self.lr.fill_(lr)

    def capture(self, optimizer: torch.optim.Optimizer,
                step: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                lr: float) -> None:
        """Capture step(images, targets) (forward, criterion, backward,
        optimizer.step(); returns the loss) on the static buffers."""
        optimizer.zero_grad(set_to_none=True)
        groups = optimizer.param_groups
        for group in groups:
            group["capturable"] = True
            group["lr"] = self.lr
        # thread_local: the device-prefetch thread pins and copies the
        # next batches meanwhile, on a stream of its own
        try:
            with self.launches.capturing(), torch.cuda.graph(
                    self.graph, stream=side_stream(self.images.device),
                    capture_error_mode="thread_local"):
                self.loss = step(self.images, self.targets).detach()
        finally:
            for group in groups:
                group["lr"] = lr

    def replay(self, images: torch.Tensor, targets: torch.Tensor,
               lr: float) -> torch.Tensor:
        """One step on this batch at this lr; a copy of its loss, which
        later replays leave alone."""
        self._load(images, targets, lr)
        self.graph.replay()
        self.launches.replayed()
        return self.loss.clone()
