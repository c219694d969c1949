"""The port's ops: convolutions, resizes, the pixel LSTM, window
attention, int8 quantization and the hand-written kernels (`kernels`)."""

from __future__ import annotations

from typing import Callable, List


def counted_kernels() -> List[Callable]:
    """Every op that counts its launches in a `.launches` attribute: the
    hand-written kernels' wrappers and the window-attention op (its
    calls). A new counted op is listed here."""
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
