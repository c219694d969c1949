"""Train-mode BatchNorm in the traced tail, by the kernels' names (ATen's
native batch_norm_* kernels, cuDNN's bn_fw / bn_bw ones, the port's K7
bn_* kernels in csrc/batch_norm.cu), so that it reads the same work
whatever implements it: BN's byte floor a step (portbench/arith/
batch_norm at the traffic's batch and crop, in the configuration's
compute dtype) times the traced steps, over those kernels' device time,
in %. None where no kernel matched (a model without BatchNorm)."""

import re

from portbench.arith import batch_norm, peaks
from portbench.harness import readers

BN = re.compile(r"batch_norm_\w*kernel|\bbn_\w*kernel|\bbn_(fw|bw)\w*")
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def read(ctx):
    tail = ctx.get("tail")
    seconds = readers.kernel_seconds(ctx, [BN])
    if not tail or seconds <= 0:
        return None
    run = ctx["run"]
    floor = batch_norm.floor_bytes(
        run.config["model"], run.config["architecture"],
        run.traffic["batch_size"], run.traffic["augment"]["crop_size"],
        ITEMSIZE[run.config["precision"]["compute"]])
    bound = peaks.bound_s(0.0, floor, ctx.get("device_kind", ""))
    if not floor or bound is None:
        return None
    return 100.0 * bound[0] * tail["steps"] / seconds
