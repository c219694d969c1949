"""Counted tensor-core FLOPs of the untraced window's training steps
(3x the forward, portbench/arith/models) over the window's seconds, as a
share of the card's bf16 peak."""

from portbench.harness import readers


def read(ctx):
    bsz = ctx["run"].traffic["batch_size"]
    flops = 3.0 * readers.forward_flops(ctx, bsz) * ctx["steps"]
    return readers.mfu_pct(ctx, flops, ctx["window_s"])
