"""The window-attention kernels of a training step in the traced tail
(the scaled_dot_product_attention that ops/window_attention calls, by
the kernels' names): the least time of one step's calls, a forward and a
backward for each Swin block (portbench/arith/window_attention at each
block's shapes, portbench/arith/models), times the traced steps, over
those kernels' device time, in %. None where the program has no
window-attention op or never called it, or where no kernel matched."""

import re

from portbench.arith import peaks
from portbench.arith import window_attention as wa
from portbench.arith.models import swinunet
from portbench.harness import readers

# PyTorch's fused attention kernels: memory-efficient (CUTLASS fmha),
# flash, cuDNN
SDPA = re.compile(r"fmha_cutlass|flash_fwd|flash_bwd|cudnn\w*sdpa"
                  r"|\bsdpa\w*kernel|attention_kernel|AttentionKernel")


def _calls() -> int:
    try:
        from stf_unet_tpu_torch.ops.window_attention import window_attention
    except ImportError:
        return 0
    return window_attention.launches


def read(ctx):
    tail = ctx.get("tail")
    if not tail or _calls() == 0:
        return None
    seconds = readers.kernel_seconds(ctx, [SDPA])
    if seconds <= 0:
        return None
    run = ctx["run"]
    bsz = run.traffic["batch_size"]
    kind = ctx.get("device_kind", "")
    bound = 0.0
    for nw, heads, n, hd in swinunet.attention_blocks(
            run.config["architecture"]):
        for part in (wa.forward, wa.backward):
            b = peaks.bound_s(*part(bsz, nw, heads, n, hd), kind)
            if b is None:
                return None
            bound += b[0]
    return 100.0 * bound * tail["steps"] / seconds
