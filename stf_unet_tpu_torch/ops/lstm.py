"""Per-pixel temporal LSTM (counterpart of stf_unet_tpu/ops/lstm.py).

The model fuses DCE-MRI temporal features with an LSTM applied to every
pixel's [T, C] feature sequence at each encoder scale, and keeps only the
last step. Time stays sequential; the B*H*W pixel axis is the batch.

Backends of `pixel_lstm`:
  * "scan"  - the plain version: a Python loop over T of `lstm_cell`,
              (h, c) in the activation dtype, as the JAX `lstm_scan`;
  * "fused" - kernel K1 (ops/kernels/lstm_last_x), the input projection
              inside the kernel;
  * "last"  - a `torch.matmul` input projection, then kernel K3
              (ops/kernels/lstm_last);
  * "auto"  - on CUDA, in inference "fused" for C <= FUSED_MAX_C and
              "last" above; in training "fused" for C <= FUSED_TRAIN_MAX_C
              and "scan" above (K3 has no backward); on the CPU, "scan".

Gate order and arithmetic match torch.nn.LSTM (i, f, g, o). Weights use
the JAX layout [C, 4C].
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from stf_unet_tpu_torch.ops.kernels.lstm_last import lstm_last
from stf_unet_tpu_torch.ops.kernels.lstm_last_x import lstm_last_x

# Widest C that "auto" sends to the fused kernel K1; wider goes to K3.
# This is the TPU's serving routing (K1's VMEM plan fits up to C=256 there,
# stf_unet_tpu/ops/pallas/lstm_kernel.py:lstm_backend_default), carried
# over as is: it has not yet been measured on the H100.
FUSED_MAX_C = 256
# Widest C that "auto" sends to K1 (forward + backward K1b) in training;
# wider goes to the scan. This is the TPU's roofline crossover (the
# kernel's gate-recompute FLOPs grow with C^2, the scan's residual traffic
# with C: stf_unet_tpu/ops/pallas/lstm_kernel.py:108-113), carried over as
# is: it has not been measured on the H100.
FUSED_TRAIN_MAX_C = 128

BACKENDS = ("auto", "scan", "fused", "last")


def lstm_cell(x_proj: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              w_hh: torch.Tensor, b: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step. x_proj [N, 4C] = x @ w_ih; h, c [N, C]; w_hh [C, 4C];
    b [4C]."""
    gates = x_proj + h @ w_hh
    if b is not None:
        gates = gates + b
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_scan(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
              b: Optional[torch.Tensor]) -> torch.Tensor:
    """x [T, N, C] -> h_T [N, C]: one matmul for the input projection of
    all T steps, then a loop over T carrying (h, c) in x's dtype."""
    t_steps, n, c = x.shape
    x_proj = x @ w_ih
    h = torch.zeros((n, c), dtype=x.dtype, device=x.device)
    cs = torch.zeros_like(h)
    for t in range(t_steps):
        h, cs = lstm_cell(x_proj[t], h, cs, w_hh, b)
    return h


def lstm_backend_default(device: torch.device, cdim: int,
                         train: bool = False) -> str:
    if device.type != "cuda":
        return "scan"
    if train:
        return "fused" if cdim <= FUSED_TRAIN_MAX_C else "scan"
    return "fused" if cdim <= FUSED_MAX_C else "last"


def pixel_lstm(feat_seq: torch.Tensor, w_ih: torch.Tensor,
               w_hh: torch.Tensor, b: Optional[torch.Tensor],
               backend: str = "auto", train: bool = False) -> torch.Tensor:
    """Temporal fusion of per-scale encoder features.

    feat_seq [B, T, H, W, C] -> [B, H, W, C], the last LSTM step per
    pixel. Lanes are feat_seq.transpose(1,0,2,3,4).reshape(T, B*H*W, C),
    as in the JAX package. `train` selects the training routing of "auto".
    """
    bsz, t_steps, h, w, c = feat_seq.shape
    lanes = feat_seq.transpose(0, 1).reshape(t_steps, bsz * h * w, c)
    if backend == "auto":
        backend = lstm_backend_default(lanes.device, c, train)
    if backend == "scan":
        out = lstm_scan(lanes, w_ih, w_hh, b)
    elif backend in ("fused", "last"):
        bias = b if b is not None else lanes.new_zeros(4 * c)
        if backend == "fused":
            out = lstm_last_x(lanes, w_ih, w_hh, bias)
        else:
            out = lstm_last(lanes @ w_ih, w_hh, bias)
    else:
        raise ValueError(f"Unknown LSTM backend {backend!r}; expected one "
                         f"of {BACKENDS}")
    return out.reshape(bsz, h, w, c)
