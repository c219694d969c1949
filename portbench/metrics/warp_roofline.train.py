"""K2 (ops/kernels/warp, csrc/warp.cu) in the traced tail: its byte bound
(portbench/arith/kernels.warp, at the batch's shapes: B, the T frames and
the mask over the pack's canvas, warped to the crop) times its launches,
over its device time, in %."""

from portbench.arith import kernels, peaks
from portbench.harness import readers


def read(ctx):
    tail = ctx.get("tail")
    seconds = readers.kernel_seconds(ctx, [readers.K2])
    if not tail or seconds <= 0:
        return None
    tr = ctx["run"].traffic
    canvas = -(-tr["dataset"]["size"] // 32) * 32
    crop = tr["augment"]["crop_size"]
    planes = ctx["run"].config["architecture"]["time_steps"] + 1
    bound = peaks.bound_s(*kernels.warp(tr["batch_size"], planes, canvas,
                                        canvas, crop, crop),
                          ctx.get("device_kind", ""))
    if bound is None:
        return None
    return 100.0 * bound[0] * tail["counters"]["warp"] / seconds
