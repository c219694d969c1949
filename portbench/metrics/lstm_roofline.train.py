"""The pixel-LSTM kernels of a training step in the traced tail, K1f
(csrc/lstm_last_x.cu) and K1b (csrc/lstm_last_x_bwd.cu): the least time
their launches could take (portbench/arith/kernels at each routed
scale's shapes) over their device time, in %."""

from portbench.harness import readers


def read(ctx):
    tail = ctx.get("tail")
    seconds = readers.kernel_seconds(ctx, [readers.K1F, readers.K1B])
    if not tail or seconds <= 0:
        return None
    steps = tail["steps"]
    per_step = {"fwd": tail["counters"]["lstm_fwd"] // steps,
                "bwd": tail["counters"]["lstm_bwd"] // steps}
    bound = readers.lstm_bound_s(ctx, ctx["run"].traffic["batch_size"],
                                 per_step)
    if bound is None:
        return None
    return 100.0 * bound * steps / seconds
