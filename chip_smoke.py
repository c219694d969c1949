#!/usr/bin/env python3
"""Drive the PyTorch port (stf_unet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each of which fails the run (non-zero exit, no result line):
  1. card: print the GPU's name and power limit; build the eight CUDA
     kernels from csrc/ with nvcc, in parallel, and print the build seconds.
  2. kernels: each kernel against its plain PyTorch version on the card.
     K1 forward and K3 at every row count the serving and training paths
     give them (serving batch buckets 1, 2, 4, 8 and the training /
     evaluation batch 16, at crop 224, T=8); K1b (the LSTM backward)
     at the training shapes (C=64/N=50176, C=128/N=12544, a ragged N, one
     C=256 shape), all in bf16 and f32, and twice to show it is
     deterministic, with the host time of a call and the design's byte
     floor at each timed training shape; K2 (the augmentation warp) at
     B=16, 256^2 -> 224^2, with the frames and mask (Cs=9) and with the
     PK maps too (Cs=12), on uniformly scattered coordinates and at a
     200^2 output with small valid regions, each line with its blocks by
     path (the training draws must all stage their source box in shared
     memory, the scattered case must take the direct gather), and at the
     augmentation extras' call shapes, bit-equal to the plain version:
     an elastic field (Cs=9, alpha 8) and the per-frame mode (128
     one-plane warps beside their masks), each with its blocks by path,
     byte bound and device time;
     K4 (the PK fit's quadrature sums) at N = 16384, 8951 and 256 voxels,
     T=8, Q=700, with its bound and SFU floor over the active (t, q)
     terms and over the full grid, and at Q=3500 with rates of inf, NaN
     and -inf; K3 also at C=256, B=8, and each bf16 tensor-core K3 line
     against a control that rounds h to bf16 in the product. Timings of
     kernel, plain version and a library yardstick (CUDA events), and
     host times. K1 forward's and K3's lines say whether they ran on
     tensor cores (K1: bf16 at C = 64/128/256; K3: bf16 at C = 256/512);
     K2's lines carry warp()'s host time. Then the training routing: one
     pixel LSTM's forward + backward through K1 + K1b and through the
     scan at each scale; and the serving routing at C = 256 and 512: K1,
     matmul + K3 and the scan, B=8, bf16. Then, once every event and host
     timing above is taken (a profiler session may slow the launches
     after it), the torch.profiler pass: K1 forward's and K3's device time
     on each of their lines, K1b's launches by name (tile kernel, dW
     pass, reductions) in one call at each timed shape, K2's and
     F.grid_sample's device time per call over 1,000 calls with rule 2's
     verdict, K4's over 500 calls, the serving routing's device times;
     and one K1 forward line's event times taken again after it
     (profiler_aftereffect). Then K5 (the int8 convolution's operand
     pass, ops/kernels/quant.py) at every conv call of one bf16 B=8,
     crop-224 forward of the full-width STF-LSTM-UNet, its PK-maps
     variant and the UNet, with each call's input NCHW-contiguous and
     channels-last, bit-equal to its plain twin in both, with the int32
     accumulators of torch._int_mm on its patches equal to an f64
     F.conv2d of the same integers; and K6 (the dequant epilogue) on
     those real accumulators of every call, bit-equal to its plain twin
     in bf16 and f32, with and without bias. Kernel, plain and (K5)
     library-route times and the byte bounds, summed per forward. Then
     K7 (train-mode BatchNorm, ops/kernels/batch_norm.py) forward and
     backward at every distinct BN input shape of the STF-LSTM-UNet and
     the UNet at B=16, crop 224 (14 shapes), bf16, NCHW and
     channels-last, against its plain twins in float64, bit-identical
     over two runs; and at the stem (128 x 64 x 112^2) and layer3 (128 x
     256 x 14^2) shapes one `bn` line each with its device ms
     (torch.profiler, the bn_ kernels), the byte floor (10 bytes an
     element) and the design's 16, the plain twin's ms and
     F.batch_norm's forward + backward ms (events).
  3. serving: a seeded full-width STF-LSTM-UNet (ResNet-34, pixel LSTMs at
     C=64..512, T=8, crop 224, bf16) written as a reference-layout .pth,
     served through cli/serve.build_server on 127.0.0.1, answering
     concurrent /v1/segment requests from the port's client. Every kernel
     on the path must have launched during this phase.
  4. breakdown: host preprocessing per request, engine.predict per batch
     bucket, and a torch.profiler view of one B=8 forward (kernel time by
     name, the port's kernels by name, the pixel-LSTM kernels' share, the
     device's idle share).
  5. kernel path against plain path: logits of one batch with the kernels
     ("auto") and with the plain LSTM loop ("scan").
  6. training: a synthetic BreaDM tree of subtraction (SUB) sequences at
     256^2 (64 training slices), cli/train at full width (bf16, batch 16,
     crop 224) for 3 epochs = 12 steps with evaluation and latest/best
     checkpoints; every loss finite and every training kernel launched
     during this phase, K7 3 + 3 times for each BN call of each step.
  7. steps: the loss of repeated steps on one fixed batch falls (K7
     launched 3 + 3 times a BN call a step); ms per
     step, samples/s, the device's idle share and a torch.profiler view of
     one step (with the port's kernels by name).
  8. training path against plain path: one f32 step through the kernels
     and through the scan + plain warp; loss and every gradient.
  9. UNet training: cli/train --model unet (the vanilla UNet at full
     width, base_c = 64, T = 8 frames as channels; bf16, batch 16, crop
     224, 3 epochs = 12 steps) on the same tree: every loss finite, K2
     launched (Cs = 9), K7 3 + 3 times a BN call a step, and one
     comparison render per test record.
 10. UNet steps: phase 7 on the UNet, with its step's convolution FLOPs
     (3.555 TFLOP at batch 16, counted from the layers' shapes by
     utils/benchkit.forward_flops) against the card's dense bf16 peak.
 11. UNet parity: the UNet's best checkpoint in f32 on the card and on the
     CPU, the logits of two test slices within 1e-4 of max |logit|.
 12. cli/test: `stf_unet_tpu_torch.cli.test.main` (bf16) on the best
     checkpoints of phases 6 and 9, with --per-patient --surface-metrics
     --threshold-sweep (dice within 1e-3 of cli/train's test pass), with
     --tta and with --tiled (finite dice); K1 and K3 launched in each run
     on the STF-LSTM-UNet; wall ms per test slice.
 13. PK maps: `python -m stf_unet_tpu_torch.pk.maps` (LM) over the tree's
     12 volumes; finite maps for each, K4 launched 2 x lm_iters times per
     voxel chunk, seconds per volume, a torch.profiler view of one chunk,
     and one volume's maps through K4 against the plain sums.
 14. PK training and serving: cli/train with --use-pk-maps (bf16, batch
     16, crop 224, 2 epochs = 8 steps), every loss finite and K1, K1b, K2
     and K3 launched; then the best checkpoint served through
     cli/serve.build_server, answering requests of 11 planes (8 frames
     and the three maps); then phase 7's fixed-batch steps on the
     PK-maps model.
 15. train_extras: the tree packed by cli.pack; cli/train (bf16, batch
     16, crop 224) from the packs with the elastic field, photometric
     jitter, EMA and --grad-accum 2, stopped by --stop-after-steps inside
     epoch 1 and an accumulation window, then --resume latest: the
     resume point, finite losses, and cli/test's restore giving the EMA
     weights; a second run with --data-cache-ram in the per-frame mode
     (2 epochs): the decoder it used and the `data:` seconds per
     iteration of both runs; host ms per batch of PIL, native decode,
     pack and RAM cache; --batch-size auto on the full-width config (per
     sample and fixed bytes, the pick) and one step at the pick, its
     peak memory against the budget. K1, K1b, K2 and K3 must launch.
 16. pk_enhanced: `pk.maps --enhanced` over the tree's 12 volumes (finite
     maps, zero outside the enhanced tissue mask, tissue share, s per
     volume; K4 launched 2 x lm_iters times per voxel chunk); one
     volume's enhanced maps through K4 against the plain sums (within
     1e-4 on 99 % of voxels, or else within the plain path's own spread
     under 1e-7 of curve noise); --compare-aif on the test split; --debug
     with LM and with Adam (the loss trace falls). Without matplotlib the
     compare and debug steps run their numbers, and the line says so.
 17. predict: `cli.predict.main` (bf16) on phase 6's best checkpoint at
     256^2 native, over a labels-free copy of the test images and the
     same slices as .npz with --pk-fit --pk-enhanced --save-probs
     --full-size, then --tta, then --tiled: K1, K3 (and K4 with --pk-fit)
     launched in each; the masks against cli/serve's answers for the
     same frames; ms per slice split into forward and fit; a profiler
     view of one --pk-fit slice.
 18. pipeline: `cli.pipeline.main --enhanced` (bf16) over the test split
     from phase 15's pack: avg fused seconds per sample; K1, K3, K4.
 19. serve_dir: cli/serve.build_server with --model-dir --tta --tiled
     --warmup-geometries 256x256 answering 224^2 and 256^2 requests (ms
     per request); POST /v1/reload after phase 15's checkpoint replaces
     the best (the next answer is the new weights'), and 409 for a
     checkpoint of another architecture; K1 and K3 launched.
 20. int8: `cli.quantize --threshold-sweep` (bf16) on the best
     checkpoints of phases 6 and 9 (48 and 19 convs quantized, float and
     int8 dice, the delta, the operating points; K5 and K6 launched) and
     `--no-eval` on phase 15's; bf16 and int8 forwards of both at B=8 and
     16 (CUDA events, bf16 / int8 / int8 / bf16) and a torch.profiler
     split of the int8 forward at B=8 (K5, the int8 GEMM, the dequant
     epilogue with K6 by name, the rest, the copy kernels that aten ops
     launch inside the conv ranges, which must be none) and its logits
     through K5 and K6 bit-equal to the same forward through their plain
     twins; a server with --model-dir --dtype int8 --tta --tiled
     answering 4 requests at 224^2 and 4 at 256^2, its masks equal to the
     direct quantized forward's and their share equal to a bf16 server's,
     reloaded with phase 15's checkpoint and its scales (200, the new
     weights' masks) and refused without scales (409); K1, K3, K5 and K6
     launched.
 21. data parallelism, in child processes that count their own
     launches (NCCL refuses two ranks on one device): (a) cli/train
     --multihost under torchrun's environment at world 1 (NCCL, DDP and
     44 synced BNs engaged; bf16, batch 16, crop 224, one epoch with
     evaluation): finite losses, a checkpoint, K1, K1b, K2 and K3
     launched; (b) two gloo ranks on the one card (batch 8 each) against
     one process (batch 16) on the same global batch, f32, two steps:
     the losses and the parameters within the tolerances stated at
     DP_LOSS_RTOL / DP_UPDATE_RTOL (cuDNN deterministic), ranks with
     local BN statistics outside them, the ranks' parameters equal, the
     sharded val pass's confusion matrix equal to the whole one's and
     dice within 1e-6, each rank's kernels launched; (c) ms per bf16
     batch-16 step with no group against NCCL world-1 DDP with synced BN
     (events, plain / DDP / DDP / plain).
 22. data-parallel inference, one process over a device list: (a) the
     CLIs with --data-parallel 0 (every visible GPU): a bf16 and an int8
     server with --tta --tiled answering 4 requests at 224^2 and 4 at
     256^2, cli.predict --tiled over the unlabeled test images, pk.maps
     over the 12 volumes (K4 2 x lm_iters times per chunk); K1f, K3, K4,
     K5 and K6 launched; (b) two replicas on the one card against one
     device (cuDNN deterministic): the masks of the engine at n = 1, 3,
     8, of a 256^2 tiled volume and of the int8 engine (each int8 replica
     launching K1f, K3, K5 and K6 over its own conv table) equal but
     where one device's top-two logit margin is within DPI_MARGIN_REL of
     max |logit|, probabilities within DPI_PROB_ATOL, fit_lm on one
     volume bit-equal; (c) B=8 predict and a two-chunk fit_lm on one replica
     against two (wall, events, the card's idle share); with several
     GPUs, over 1, 2 and all of them.
 23. spatial parallelism, image rows over a 2-D group's space axis
     (parallel/spatial.py), in child processes: (a) two gloo ranks on
     the one card (1 x 2) against one process, full-width STF at crop
     224, B=4: an f32 step within SP_LOSS_RTOL / SP_UPDATE_RTOL per
     parameter group (a control without halos outside), a bf16 step
     within its bounds with each rank's peak memory and the launches of
     K1f, K1b and K2 on each rank, ms per bf16 step, the share of a step
     in the space group's collectives, and the gathered bf16 eval
     logits against one process's (SP_LOGIT_REL, near-tie masks); (b)
     with 2+ GPUs, cli/train --spatial-parallel 2 under NCCL for one
     epoch (ms per step, each rank's peak memory), else a skip line.
 24. the trainer's diagnostics and the model tools: (a) one f32 step of
     the full-width STF model (B=4) with and without --model-remat from
     the same weights and batch, cuDNN deterministic: the loss within
     1e-5 and every gradient within 1e-4 of the tensor's max (atomics
     in two backwards), every BN buffer equal (the recompute updates none); bf16 B=16 steps with and without
     remat: peak memory (remat lower) and ms per step; K1f, K1b and K2
     launched; (b) cli/train --model-remat true --profile-dir
     --matmul-precision high --aux for one epoch: finite losses, the
     trace's K1f, K1b, K2 and K3 kernel events against the wrappers'
     launch counters over the same window, and the host time of each
     annotated region (train_step, data_wait, loss_read, eval,
     checkpoint); (c) a NaN weight under --nan-check raises
     FloatingPointError naming the module; (d) cli.val (--data-parallel
     0) on phase 6's best checkpoint against
     cli/test on the test split: IoU / Dice of cli/test's logits within
     1e-3, the confusion matrices, the device time per batch, K1f and K3
     launched; (e) cli.export --check at a symbolic batch on the card:
     the artifact at batch 1, 3 and 8 within 1e-4 of max |logit| of the
     kernel-path eager forward, launching no port kernel, and the ms of
     both at batch 8; (f) cli.migrate --reverse then forward (phase 6's
     checkpoint back bit for bit) and cli.average of its latest and best
     served once by cli/serve (200).
 25. benchkit and plots: (a) every utils/benchkit helper at its sizes
     (batch 16, crop 224, T=8, 256^2 sources; BENCH_ITERS iterations,
     the median of BENCH_REPS windows): the UNet and STF-LSTM-UNet bf16
     train steps, the fused augment + train step and its rotation-split
     twin on the UNet, the STF-LSTM-UNet's bf16 / int8 serving forwards
     (both, and each alone), the packed val epoch at batch 1 and 8 and
     at batch 1 alone; each dict printed beside the card's name and
     power limit, every number finite and > 0, the UNet step's counted
     FLOPs equal to UNET_STEP_FLOP within 1e-3; K1f, K1b, K2, K3, K5 and
     K6 launched; (b) cli.plot on phase 6's metrics JSONL and results
     text: parse_run gives the epochs the run logged; without
     matplotlib the CLI exits non-zero naming it, with it the PNGs are
     written.
Then a {"kernels": [...]} line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.

`--quick` stops after the kernel checks and prints no result line.

Exits non-zero without a CUDA device, and when the package is not beside
this script.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

T_STEPS = 8
CROP = 224
BUCKETS = (1, 2, 4, 8)
# Batches K1 forward and K3 are checked at: the serving buckets, and batch
# 16, which training (K1 at C=64, 128) and its evaluation (K1 at C=64..256,
# K3 at C=512) give them.
CHECK_BATCHES = BUCKETS + (16,)
# Row count N = B*h*w of each pixel LSTM at crop 224 (scales 1/4 .. 1/32).
SCALES = ((64, 56), (128, 28), (256, 14), (512, 7))
# H100 SXM published peaks (dense): bytes/s, bf16 tensor-core FLOP/s and
# f32 CUDA-core FLOP/s.
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
# Kernel vs plain version, max |difference| of h_T (|h| < 1):
#  f32  - the same f32 arithmetic summed in another order: 2e-5, the JAX
#         package's own kernel-vs-scan tolerance;
#  bf16 - the output (and K1's recurrent h) rounds to bf16, whose spacing
#         is 2^-8 just below 1; a sum-order change may flip a rounding, so
#         allow two such steps: 2^-7.
TOL = {"f32": 2e-5, "bf16": 2.0 ** -7}
# K3 is also checked and timed at this width, B=8: the serving routing
# times its "last" backend there, and its bf16 tensor-core kernel is
# instantiated for it.
K3_OFF_PATH_C = 256
# K3's tensor-core kernel splits the f32 h into bf16 hi + lo (2^-16 of
# |h|), so its h_T differs from the plain twin's only where a sum-order
# change flips a bf16 rounding (~0.04 % of elements in the CPU emulation,
# tests/test_torch_lstm_last_tc.py); h rounded to bf16 (2^-9) flips ~11 %.
# The kernel must sit this many times closer than that control by mean
# |difference| (split_control).
K3_SPLIT_RATIO = 0.1
N_REQUESTS = 32


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def dev_ms(e) -> float:
    """Device time of one torch.profiler key_averages() entry, in ms."""
    return (getattr(e, "device_time_total", 0.0)
            or getattr(e, "cuda_time_total", 0.0)) / 1e3


def profiled_ms(fn, calls: int, match: str = ""):
    """Device time per call of fn(): the CUDA kernels whose name contains
    `match` (every kernel with ""), summed over one torch.profiler window
    of `calls` back-to-back calls. None where the profiler shows no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(dev_ms(e) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and match in e.key)
    return total / calls if total else None


def host_us(fn, calls: int = 20) -> float:
    """Host time of one call of fn(), the wrapper's own work and its
    launches: the mean over back-to-back calls enqueued without a sync
    (20 calls stay far inside the launch queue, so the host never waits
    on the card)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    out = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return out


def port_kernels_by_name(kernels, per: int = 1) -> dict:
    """Device ms of the port's own kernels (stf::) among torch.profiler
    key_averages() entries, by kernel name, divided by `per`."""
    import re

    out = {}
    for e in kernels:
        name = re.search(r"stf::(\w+)", e.key)
        if name:
            out[name.group(1)] = out.get(name.group(1), 0.0) + dev_ms(e) / per
    return out


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BPS
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_cases(gen, device):
    """(kernel name, C, N, dtype, inputs, kernel fn, plain fn, on the
    serving path) for every row count the serving and training paths give
    each kernel, and K3 at C=256, B=8, the serving routing's "last"
    backend (off the path: "auto" sends C=256 to K1)."""
    import torch

    from stf_unet_tpu_torch.ops.kernels.lstm_last import (lstm_last,
                                                          lstm_last_plain)
    from stf_unet_tpu_torch.ops.kernels.lstm_last_x import (
        lstm_last_x, lstm_last_x_plain)
    from stf_unet_tpu_torch.ops.lstm import FUSED_MAX_C

    for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        for c, side in SCALES:
            k = 1.0 / c ** 0.5
            w_ih, w_hh = ((torch.rand((c, 4 * c), generator=gen) * 2 - 1) * k
                          for _ in range(2))
            b = (torch.rand((4 * c,), generator=gen) * 2 - 1) * k
            w_ih, w_hh, b = (v.to(device, dtype) for v in (w_ih, w_hh, b))
            for bsz in CHECK_BATCHES:
                n = bsz * side * side
                x = torch.randn((T_STEPS, n, c), generator=gen).to(device,
                                                                   dtype)
                if c <= FUSED_MAX_C:
                    yield ("lstm_last_x", c, n, dname, (x, w_ih, w_hh, b),
                           lstm_last_x, lstm_last_x_plain, True)
                if c > FUSED_MAX_C or (c == K3_OFF_PATH_C and bsz == 8):
                    xp = x @ w_ih  # the serving path's projection, rounded
                    yield ("lstm_last", c, n, dname, (xp, w_hh, b),
                           lstm_last, lstm_last_plain, c > FUSED_MAX_C)


def kernel_phase(device, quick: bool, jobs: list):
    """K1 forward and K3 vs their plain versions; timings at B=8 in both
    dtypes. Each line says whether the call ran on tensor cores (K3's
    also how far it sits from the plain twin against a control that
    rounds h to bf16, split_control) and carries its host time; its
    device time is queued on `jobs` (see profiled_pass).
    Returns per-kernel aggregates over one B=8 bf16
    serving forward (the kernels line's ms and bound for K1 forward and
    K3), and the aftereffect job of the C=64 line (None with `quick`)."""
    import torch

    from stf_unet_tpu_torch.ops.kernels.lstm_last import (TC_LAST_C,
                                                          tensor_core_last)
    from stf_unet_tpu_torch.ops.kernels.lstm_last_x import (TC_FWD_C,
                                                            tensor_core_fwd)

    rules = {"lstm_last_x": (tensor_core_fwd, TC_FWD_C),
             "lstm_last": (tensor_core_last, TC_LAST_C)}
    gen = torch.Generator().manual_seed(0)
    agg, recheck = {}, None
    for (name, c, n, dname, args, kern, plain,
         on_path) in kernel_cases(gen, device):
        got = kern(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        line = {"kernel": name, "C": c, "N": n, "dtype": dname,
                "max_abs_err": err, "tol": TOL[dname]}
        check(bool(torch.isfinite(got).all()),
              f"{name} C={c} N={n} {dname}: non-finite output")
        check(err <= TOL[dname], f"{name} C={c} N={n} {dname}: max abs "
                                 f"err {err} > tol {TOL[dname]}")
        a = agg.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0,
                                  "plain_ms": 0.0, "bound_ms": 0.0,
                                  "bound_by": None, "library_ms": None,
                                  "shapes": []})
        rule, widths = rules[name]
        line["tensor_cores"] = rule(args[0].dtype, c)
        a["tensor_cores"] = f"bf16, C in {list(widths)}"
        if name == "lstm_last" and line["tensor_cores"]:
            line["h_bf16_control"] = split_control(got, want, args)
        if dname == "bf16":
            a["max_abs_err"] = max(a["max_abs_err"], err)
        b8 = n == 8 * dict(SCALES)[c] ** 2
        serving_b8 = b8 and on_path
        if not quick:
            line["host_us"] = host_us(lambda: kern(*args))
            jobs.append(device_job(
                {"kernel": name, "C": c, "N": n, "dtype": dname},
                lambda kern=kern, args=args: kern(*args), f"stf::{name}", 20,
                a if serving_b8 and dname == "bf16" else None))
        if b8 and not quick:
            t_steps = args[0].shape[0]
            item = args[0].element_size()
            if name == "lstm_last_x":
                nbytes = item * (t_steps * n * c + 8 * c * c + 4 * c + n * c)
                flops = 16.0 * t_steps * n * c * c
            else:
                nbytes = item * (t_steps * n * 4 * c + 4 * c * c + 4 * c
                                 + n * c)
                flops = 8.0 * t_steps * n * c * c
            bms, by = bound_ms(nbytes, flops, dname)
            lib_ms = cudnn_lstm_ms(*args) if name == "lstm_last_x" else None
            line.update(kernel_ms=cuda_ms(lambda: kern(*args)),
                        plain_ms=cuda_ms(lambda: plain(*args), iters=5),
                        bound_us=bms * 1e3, bound_by=by, library_ms=lib_ms)
            if serving_b8 and dname == "bf16":  # one B=8 serving forward
                a["ms"] += line["kernel_ms"]
                a["plain_ms"] += line["plain_ms"]
                a["bound_ms"] += bms
                if lib_ms is not None:
                    a["library_ms"] = (a["library_ms"] or 0.0) + lib_ms
                a["bound_by"] = by
                a["shapes"].append({"C": c, "N": n, "T": t_steps})
            if name == "lstm_last_x" and dname == "bf16" and c == 64:
                recheck = aftereffect_job(line, args, kern, plain)
        print(json.dumps(line), flush=True)
    return agg, recheck


def lstm_last_h_bf16(x_proj, w_hh, b):
    """lstm_last_plain with h_{t-1} rounded to bf16 before the recurrent
    product: what K3's tensor-core kernel would give without the lo half
    of its split of h (hi W_hh alone)."""
    import torch

    f32 = torch.float32
    t_steps, n, four_c = x_proj.shape
    wh, bias = w_hh.to(f32), b.to(f32)
    h = torch.zeros((n, four_c // 4), dtype=f32, device=x_proj.device)
    cs = torch.zeros_like(h)
    for t in range(t_steps):
        gates = (x_proj[t].to(f32) + h.to(torch.bfloat16).to(f32) @ wh) + bias
        i, f, g, o = gates.chunk(4, dim=1)
        cs = torch.sigmoid(f) * cs + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(cs)
    return h.to(x_proj.dtype)


def split_control(got, want, args) -> dict:
    """K3's bf16 tensor-core output `got` and the control
    lstm_last_h_bf16 on the same inputs, each against the plain twin's
    `want` (h f32 in the product): mean |difference| and the share of
    elements that differ. Fails unless the kernel is K3_SPLIT_RATIO times
    closer than the control by mean |difference|: max |difference| alone
    cannot tell them apart (both read one bf16 step)."""
    import torch

    ctl = lstm_last_h_bf16(*args)
    out = {}
    for key, v in (("kernel", got), ("control", ctl)):
        d = (v.float() - want.float()).abs()
        out[key] = {"mean_abs_err": d.mean().item(),
                    "differ_share": (d > 0).float().mean().item()}
    check(out["kernel"]["mean_abs_err"]
          <= K3_SPLIT_RATIO * out["control"]["mean_abs_err"],
          f"lstm_last: the tensor-core kernel is not {1 / K3_SPLIT_RATIO:g}x "
          f"closer to the plain twin than h rounded to bf16: {out}")
    out["ratio"] = K3_SPLIT_RATIO
    return out


def device_job(ident: dict, fn, match: str, calls: int, agg=None):
    """A profiled_pass job: the device time per call of fn()'s kernels
    whose name contains `match`, over one torch.profiler window of `calls`
    calls, printed with `ident`; added to agg["device_ms"] where agg is
    given (for K1 forward and K3, the B=8 bf16 serving forward's sum)."""
    def job():
        ms = profiled_ms(fn, calls, match)
        print(json.dumps({**ident, "device_ms": ms}), flush=True)
        if agg is not None:
            agg["device_ms"] = (agg.get("device_ms") or 0.0) + (ms or 0.0)
    return job


def aftereffect_job(line: dict, args, kern, plain):
    """fn() printing the CUDA-event times of one K1 forward line (kernel,
    plain version, torch.nn.LSTM) taken again, beside the line's first
    figures. Run after profiled_pass, it shows whether a profiler session
    slows the launches after it."""
    def job():
        print(json.dumps({"profiler_aftereffect": {
            "C": line["C"], "N": line["N"], "dtype": line["dtype"],
            "before": {k: line[k] for k in ("kernel_ms", "plain_ms",
                                            "library_ms")},
            "after": {"kernel_ms": cuda_ms(lambda: kern(*args)),
                      "plain_ms": cuda_ms(lambda: plain(*args), iters=5),
                      "library_ms": cudnn_lstm_ms(*args)}}}), flush=True)
    return job


def profiled_pass(jobs: list) -> None:
    """Run the measurements the kernel phases queued on `jobs`: every
    torch.profiler window of those phases (device time per call, K1b's
    launches by name). They run after all of the phases' CUDA-event and
    host timings, because a profiler session may leave the launches after
    it slower (aftereffect_job measures that)."""
    for job in jobs:
        job()
    jobs.clear()


def cudnn_lstm_ms(x, w_ih, w_hh, b, dh=None):
    """One torch.nn.LSTM call computing the same h_T, and with `dh` its
    backward for that cotangent too (a yardstick only; the port never
    calls it). None where cuDNN refuses the dtype."""
    import torch

    c = x.shape[-1]
    lstm = torch.nn.LSTM(c, c).to(x.device, x.dtype)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(w_ih.t())
        lstm.weight_hh_l0.copy_(w_hh.t())
        lstm.bias_ih_l0.copy_(b)
        lstm.bias_hh_l0.zero_()
    lstm.flatten_parameters()
    if dh is None:
        with torch.inference_mode():
            return cuda_ms(lambda: lstm(x)[1][0])
    xg = x.detach().requires_grad_()

    def fwd_bwd():
        h_n = lstm(xg)[1][0][0]
        torch.autograd.grad(h_n, [xg, *lstm.parameters()], dh)

    try:
        return cuda_ms(fwd_bwd, iters=10)
    except RuntimeError as e:
        print(f"note: torch.nn.LSTM backward refused: {e}", flush=True)
        return None


# Training shapes of K1b (T=8, B=16 at crop 224): the two scales training
# routes to the fused kernel, one ragged row count, and one C=256 shape
# (the TPU sends such shapes to its 2T backward kernel).
BWD_SHAPES = ((64, 50176), (128, 12544), (64, 50176 - 37), (256, 3136))
# K1b kernel vs plain version, max |difference| over max |plain value|,
# per output (dx, dW_ih, dW_hh, db):
#  f32  - the same f32 arithmetic summed in another order; the dW sums run
#         over T*N = 401,408 rows: 1e-4;
#  bf16 - round(h) in the recompute and dx's rounding sit at the same
#         points on both sides; a sum-order change may flip one bf16
#         rounding (2^-8 relative), which moves dx by one bf16 step: 2^-6
#         for dx. The f32 sums dW / db barely move (a few 1e-6 of their
#         max on the H100), while taking dW_hh from the rounded h (the
#         other rounding point) moves it by about 1e-3 of its max
#         (tests/test_torch_lstm_train.py): 2^-12 for dW_ih, dW_hh, db.
BWD_TOL = {"f32": {"dx": 1e-4, "dw_ih": 1e-4, "dw_hh": 1e-4, "db": 1e-4},
           "bf16": {"dx": 2.0 ** -6, "dw_ih": 2.0 ** -12,
                    "dw_hh": 2.0 ** -12, "db": 2.0 ** -12}}
BWD_NAMES = ("dx", "dw_ih", "dw_hh", "db")
# K2 at the training shape: B=16, T=8 frames + the mask, 256^2 -> 224^2.
WARP_B, WARP_SRC = 16, 256
# K2 kernel vs plain version: the kernel rounds every product and sum as
# the plain version does (no FMA contraction), so nearest must be equal
# and bilinear within 1e-5 of the normalized value (|value| < 6).
WARP_TOL = 1e-5
# K2 and F.grid_sample: device time per call from one torch.profiler
# window over this many back-to-back calls (a 20-call CUDA-event window
# at ~13 us of bytes bound times the host's enqueue rate, not the kernel).
WARP_PROFILED_CALLS = 1000
# The elastic field of the K2 extras line and of the train_extras phase.
WARP_ELASTIC = {"elastic_alpha": 8.0, "elastic_grid": 4, "elastic_prob": 1.0}


def lstm_bwd_inputs(gen, c, n, dtype, device):
    import torch

    k = 1.0 / c ** 0.5
    w_ih, w_hh = ((torch.rand((c, 4 * c), generator=gen) * 2 - 1) * k
                  for _ in range(2))
    b = (torch.rand((4 * c,), generator=gen) * 2 - 1) * k
    x = torch.randn((T_STEPS, n, c), generator=gen)
    dh = torch.randn((n, c), generator=gen)
    return tuple(v.to(device, dtype) for v in (x, w_ih, w_hh, b, dh))


def lstm_bwd_phase(device, quick: bool, jobs: list):
    """K1b against its plain version at the training shapes, in bf16 and
    f32; determinism (two launches, bitwise); timings at the two training
    shapes in bf16, the training dtype, with the device time of each of
    its launches queued on `jobs` (profiled_pass). Returns the
    kernels-line entry."""
    import torch

    from stf_unet_tpu_torch.ops.kernels.lstm_last_x_bwd import (
        TC_TILE_C, lstm_last_x_bwd, lstm_last_x_bwd_plain)

    gen = torch.Generator().manual_seed(1)
    agg = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
           "bound_by": None, "library_ms": None, "shapes": [],
           "tensor_cores": {"dw_pass": "bf16",
                            "tile_kernel": f"bf16, C in {list(TC_TILE_C)}"}}
    for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        for c, n in BWD_SHAPES:
            args = lstm_bwd_inputs(gen, c, n, dtype, device)
            got = lstm_last_x_bwd(*args)
            want = lstm_last_x_bwd_plain(*args)
            again = lstm_last_x_bwd(*args)
            torch.cuda.synchronize()
            line = {"kernel": "lstm_last_x_bwd", "C": c, "N": n,
                    "dtype": dname, "tol_rel": BWD_TOL[dname]}
            for name, g, w, g2 in zip(BWD_NAMES, got, want, again):
                check(g.shape == w.shape and g.dtype == w.dtype,
                      f"lstm_last_x_bwd {name}: {g.shape} {g.dtype} vs "
                      f"{w.shape} {w.dtype}")
                check(bool(torch.isfinite(g).all()),
                      f"lstm_last_x_bwd C={c} N={n} {dname}: non-finite "
                      f"{name}")
                err = (g.float() - w.float()).abs().max().item()
                scale = w.float().abs().max().item()
                line[f"{name}_max_abs_err"] = err
                line[f"{name}_max_abs"] = scale
                tol = BWD_TOL[dname][name]
                check(err <= tol * scale,
                      f"lstm_last_x_bwd C={c} N={n} {dname} {name}: max abs "
                      f"err {err} > {tol} * {scale}")
                check(torch.equal(g, g2), f"lstm_last_x_bwd C={c} N={n} "
                                          f"{dname} {name}: two launches "
                                          f"differ")
                if dname == "bf16":
                    agg["max_abs_err"] = max(agg["max_abs_err"], err)
            if dname == "bf16" and (c, n) in BWD_SHAPES[:2] and not quick:
                bms, by = bound_ms(lstm_bwd_bytes(args),
                                   48.0 * T_STEPS * n * c * c, dname)
                lib_ms = cudnn_lstm_ms(*args[:4], dh=args[4])
                line.update(kernel_ms=cuda_ms(lambda: lstm_last_x_bwd(*args)),
                            plain_ms=cuda_ms(
                                lambda: lstm_last_x_bwd_plain(*args),
                                iters=5),
                            bound_us=bms * 1e3, bound_by=by,
                            library_ms=lib_ms)
                line["host_us"] = host_us(lambda: lstm_last_x_bwd(*args))
                jobs.append(lstm_bwd_launch_job(
                    {"kernel": "lstm_last_x_bwd", "C": c, "N": n,
                     "dtype": dname}, args))
                line["design_floor_us"] = (lstm_bwd_design_bytes(args)
                                           / HBM_BPS * 1e6)
                agg["ms"] += line["kernel_ms"]
                agg["plain_ms"] += line["plain_ms"]
                agg["bound_ms"] += bms
                if lib_ms is not None:
                    agg["library_ms"] = (agg["library_ms"] or 0.0) + lib_ms
                agg["bound_by"] = by
                agg["shapes"].append({"C": c, "N": n, "T": T_STEPS})
            print(json.dumps(line), flush=True)
            del args, got, want, again
    return agg


# Training routing (ops/lstm.FUSED_TRAIN_MAX_C): one pixel LSTM's forward
# and backward through K1 + K1b and through the scan's autograd, bf16, at
# each scale's training row count (B=16, crop 224).
ROUTE_SHAPES = ((64, 50176), (128, 12544), (256, 3136), (512, 784))


def routing_phase(device, jobs: list):
    """Time pixel_lstm's two training backends at every scale: the
    measurement behind FUSED_TRAIN_MAX_C (printed, not checked); then the
    serving routing (serve_routing_phase)."""
    import torch

    from stf_unet_tpu_torch.ops.kernels.lstm_last_x import lstm_last_x
    from stf_unet_tpu_torch.ops.lstm import FUSED_TRAIN_MAX_C, lstm_scan

    gen = torch.Generator().manual_seed(3)
    rows = []
    for c, n in ROUTE_SHAPES:
        *leaves, dh = lstm_bwd_inputs(gen, c, n, torch.bfloat16, device)
        leaves = [v.requires_grad_() for v in leaves]

        def fwd_bwd(fn):
            return lambda: torch.autograd.grad(fn(*leaves), leaves, dh)

        rows.append({"C": c, "N": n,
                     "fused_ms": cuda_ms(fwd_bwd(lstm_last_x), iters=5),
                     "scan_ms": cuda_ms(fwd_bwd(lstm_scan), iters=5),
                     "routed_to": "fused" if c <= FUSED_TRAIN_MAX_C
                     else "scan"})
    print(json.dumps({"train_routing_bf16": rows}), flush=True)
    serve_routing_phase(device, jobs)


# Serving routing (ops/lstm.FUSED_MAX_C): one pixel LSTM's inference
# forward at the two widest scales of a B=8 serving forward (crop 224).
SERVE_ROUTE_SHAPES = ((256, 8 * 14 * 14), (512, 8 * 7 * 7))


def serve_routing_phase(device, jobs: list):
    """Time pixel_lstm's three inference backends, bf16, at C = 256 and
    512 (B=8): "fused" (K1), "last" (a matmul input projection + K3) and
    the scan, by CUDA events (20 calls), with their device time
    (torch.profiler) queued on `jobs`: the measurement behind FUSED_MAX_C
    (printed, not checked)."""
    import torch

    from stf_unet_tpu_torch.ops.kernels.lstm_last import (lstm_last,
                                                          tensor_core_last)
    from stf_unet_tpu_torch.ops.kernels.lstm_last_x import (lstm_last_x,
                                                            tensor_core_fwd)
    from stf_unet_tpu_torch.ops.lstm import FUSED_MAX_C, lstm_scan

    gen = torch.Generator().manual_seed(5)
    rows, timed = [], []
    for c, n in SERVE_ROUTE_SHAPES:
        x, w_ih, w_hh, b, _ = lstm_bwd_inputs(gen, c, n, torch.bfloat16,
                                              device)
        backends = {
            "fused": lambda x=x, w_ih=w_ih, w_hh=w_hh, b=b:
                lstm_last_x(x, w_ih, w_hh, b),
            "last": lambda x=x, w_ih=w_ih, w_hh=w_hh, b=b:
                lstm_last(x @ w_ih, w_hh, b),
            "scan": lambda x=x, w_ih=w_ih, w_hh=w_hh, b=b:
                lstm_scan(x, w_ih, w_hh, b)}
        row = {"C": c, "N": n, "fused_tensor_cores":
               tensor_core_fwd(torch.bfloat16, c),
               "last_tensor_cores": tensor_core_last(torch.bfloat16, c),
               "routed_to": "fused" if c <= FUSED_MAX_C else "last"}
        with torch.inference_mode():
            for label, fn in backends.items():
                row[f"{label}_ms"] = cuda_ms(fn)
        rows.append(row)
        timed.append(backends)
    print(json.dumps({"serve_routing_bf16": rows}), flush=True)

    def job():
        with torch.inference_mode():
            device_rows = [
                {"C": row["C"], "N": row["N"],
                 **{f"{label}_device_ms": profiled_ms(fn, 20)
                    for label, fn in backends.items()}}
                for row, backends in zip(rows, timed)]
        print(json.dumps({"serve_routing_bf16_device": device_rows}),
              flush=True)
    jobs.append(job)


def lstm_bwd_launch_job(ident: dict, args):
    """A profiled_pass job: the device time of each of K1b's own launches
    in one call on `args`, by kernel name (torch.profiler): the tile
    kernel, the dW pass, the reductions; printed with `ident` as
    launch_ms."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    from stf_unet_tpu_torch.ops.kernels.lstm_last_x_bwd import \
        lstm_last_x_bwd

    def job():
        lstm_last_x_bwd(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            lstm_last_x_bwd(*args)
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            name = re.search(r"stf::(\w+)", e.key)
            if e.device_type == torch.autograd.DeviceType.CUDA and name:
                out[name.group(1)] = {"calls": e.count, "ms": dev_ms(e)}
        print(json.dumps({**ident, "launch_ms": out or {
            "device_time": "not measured"}}), flush=True)
    return job


def lstm_bwd_design_bytes(args) -> float:
    """Bytes this design of K1b moves through device memory in one call,
    its own floor beside the function's bound: x read three times (replay,
    reverse walk, dW pass); the f32 scratch h written once and read twice,
    c written and read once, dg [T, N, 4C] written and read once; dh read,
    dx written; the dW partials written and read once; the weights."""
    from stf_unet_tpu_torch.ops.kernels.lstm_last_x_bwd import dw_splits

    x = args[0]
    t_steps, n, c = x.shape
    item = x.element_size()
    tnc = t_steps * n * c
    splits = dw_splits(t_steps, n, c, x.dtype)
    return (item * (3 * tnc + tnc + n * c + 8 * c * c + 4 * c)
            + 4 * (3 * tnc + 2 * tnc + 2 * 4 * tnc)
            + 4 * 2 * splits * (8 * c * c + 4 * c) + 4 * (8 * c * c + 4 * c))


def lstm_bwd_bytes(args) -> float:
    """Each input read once, each output written once: x, W_ih, W_hh, b, dh
    in their dtype; dx in x's dtype; dW_ih, dW_hh, db in f32."""
    x, w_ih, w_hh, b, dh = args
    t_steps, n, c = x.shape
    item = x.element_size()
    return (item * (2 * t_steps * n * c + 8 * c * c + 4 * c + n * c)
            + 4 * (8 * c * c + 4 * c))


def warp_inputs(device, pk_maps: bool, cfg=None):
    """A training batch's warp inputs: random uint8 frames (and, with
    pk_maps, three PK maps) and a binary mask on a 256^2 canvas (some
    samples padded), and the source grids TrainAugment draws for them
    (under `cfg`, default DataConfig())."""
    import torch

    from stf_unet_tpu_torch.core.config import DataConfig
    from stf_unet_tpu_torch.core.prng import augment_generator
    from stf_unet_tpu_torch.data.transforms import TrainAugment

    gen = torch.Generator().manual_seed(2)
    aug = TrainAugment(cfg or DataConfig())
    planes = T_STEPS + (3 if pk_maps else 0)
    frames = torch.randint(0, 256, (WARP_B, planes, WARP_SRC, WARP_SRC),
                           generator=gen, dtype=torch.uint8)
    masks = torch.randint(0, 2, (WARP_B, WARP_SRC, WARP_SRC), generator=gen,
                          dtype=torch.uint8)
    sizes = torch.full((WARP_B, 2), WARP_SRC, dtype=torch.int32)
    sizes[::4] = torch.tensor([240, 224], dtype=torch.int32)
    gy, gx = aug.grids(augment_generator(0, 0, 0), sizes, device)
    stacked = torch.cat([frames, masks.unsqueeze(1)], 1).to(device)
    valid = sizes.to(device, torch.float32)
    return aug, stacked, gy, gx, valid


def warp_case(label: str, args, path, exact: bool = False) -> dict:
    """K2 once on `args` with its path counters, against warp_plain: the
    nearest values equal, bilinear within WARP_TOL (bit-equal when
    `exact`), all finite, and the blocks by path as the box rule's
    emulation (warp_boxes) has them, every one on `path` ("staged" or
    "direct") unless path is None. Returns the case's line."""
    import torch

    from stf_unet_tpu_torch.ops.kernels.warp import (warp, warp_boxes,
                                                     warp_plain)

    stacked, gy, gx = args[:3]
    staged = warp_boxes(gy, gx, *stacked.shape[2:], stacked.shape[1])[
        "staged"]
    want = {"staged": int(staged.sum()), "direct": int((~staged).sum())}
    paths = torch.zeros(2, dtype=torch.int64, device=stacked.device)
    bil, near = warp(*args, paths=paths)
    bil_p, near_p = warp_plain(*args)
    torch.cuda.synchronize()
    err = (bil - bil_p).abs().max().item()
    near_diff = int((near != near_p).sum().item())
    blocks = dict(zip(("staged", "direct"), paths.tolist()))
    check(bool(torch.isfinite(bil).all() and torch.isfinite(near).all()),
          f"warp {label}: non-finite output")
    check(near_diff == 0, f"warp {label}: {near_diff} nearest (label) "
                          f"values differ from the plain version")
    tol = 0.0 if exact else WARP_TOL
    check(err <= tol, f"warp {label}: bilinear max abs err {err} > {tol}")
    check(blocks == want and (path is None
                              or blocks[path] == staged.numel()),
          f"warp {label}: blocks by path {blocks}, the box rule's {want}; "
          f"expected all {path}")
    return {"kernel": "warp", "case": label, "B": stacked.shape[0],
            "Cs": stacked.shape[1], "src": list(stacked.shape[2:]),
            "out": gy.shape[-1], "max_abs_err": err,
            "nearest_mismatches": near_diff, "tol": WARP_TOL,
            "blocks": blocks}


def warp_edge_cases(device) -> None:
    """K2 off the timed shapes, checked against warp_plain: uniformly
    scattered coordinates (every tile's box spans the canvas: the direct
    path), and TrainAugment's draws at Ho = Wo = 200 (not a multiple of
    the tile) with valid regions well below a canvas 250 wide (not a
    multiple of 8: the staged path's byte copies)."""
    import torch

    from stf_unet_tpu_torch.core.config import DataConfig
    from stf_unet_tpu_torch.core.prng import augment_generator
    from stf_unet_tpu_torch.data.transforms import TrainAugment

    aug, stacked, gy, gx, valid = warp_inputs(device, False)
    gen = torch.Generator().manual_seed(3)
    gy, gx = (torch.rand(gy.shape, generator=gen).mul_(WARP_SRC + 8)
              .sub_(4).to(device) for _ in range(2))
    print(json.dumps(warp_case("scattered", (stacked, gy, gx, valid,
                                             aug.alpha, aug.beta),
                               "direct")), flush=True)
    aug = TrainAugment(DataConfig(crop_size=200))
    sizes = torch.tensor([[96, 128], [160, 112], [200, 200], [64, 72]],
                         dtype=torch.int32).repeat(WARP_B // 4, 1)
    gy, gx = aug.grids(augment_generator(0, 0, 1), sizes, device)
    valid = sizes.to(device, torch.float32)
    narrow = stacked[..., :250].contiguous()
    print(json.dumps(warp_case("out200_small_valid_w250", (
        narrow, gy, gx, valid, aug.alpha, aug.beta), "staged")),
        flush=True)


def warp_bound(args):
    """K2's byte bound for one call: the source, coordinates and valid
    sizes read once, the bilinear planes and the nearest plane written
    once."""
    stacked, gy, gx, valid = args[:4]
    bil_n = stacked.shape[0] * (stacked.shape[1] - 1) * gy[0].numel()
    nbytes = (stacked.numel() + 4 * (gy.numel() + gx.numel()
                                     + valid.numel())
              + 4 * (bil_n + gy.numel()))
    return bound_ms(nbytes, 0.0, "f32")


def warp_extras_cases(device, quick: bool, jobs: list) -> list:
    """K2 at the call shapes the augmentation extras give it: the elastic
    field's non-affine coordinates (B=16, Cs=9, alpha 8, grid 4, prob 1)
    and the per-frame mode's one grid per plane ([B*T, 2, H, W] stacks of
    a frame beside its sample's mask, B=16, T=8), each bit-equal to
    warp_plain, with its blocks by path (whatever the box rule says), its
    event time, byte bound and, queued on `jobs`, its device time per call
    over WARP_PROFILED_CALLS calls. Returns the lines for the kernels
    line's warp entry."""
    import torch

    from stf_unet_tpu_torch.core.config import DataConfig
    from stf_unet_tpu_torch.core.prng import augment_generator
    from stf_unet_tpu_torch.data.transforms import TrainAugment
    from stf_unet_tpu_torch.ops.kernels.warp import warp, warp_plain

    aug, stacked, gy, gx, valid = warp_inputs(device, False,
                                              DataConfig(**WARP_ELASTIC))
    cases = [("elastic Cs=9", (stacked, gy, gx, valid, aug.alpha,
                               aug.beta))]
    aug = TrainAugment(DataConfig(shared_frame_augmentation=False))
    sizes = valid.to("cpu", torch.int32)
    gy, gx = aug.grids(augment_generator(0, 0, 0), sizes, device,
                       planes=T_STEPS)
    frames, mask = stacked[:, :T_STEPS], stacked[:, T_STEPS:]
    per_frame = torch.stack([frames, mask.expand(-1, T_STEPS, -1, -1)],
                            2).reshape(WARP_B * T_STEPS, 2, WARP_SRC,
                                       WARP_SRC)
    cases.append((f"per-frame B={WARP_B} T={T_STEPS}", (
        per_frame, gy, gx, valid.repeat_interleave(T_STEPS, 0), aug.alpha,
        aug.beta)))
    out = []
    for label, args in cases:
        line = warp_case(label, args, None, exact=True)
        bms, by = warp_bound(args)
        line.update(bound_ms=bms, bound_by=by)
        entry = {"case": label, "max_abs_err": line["max_abs_err"],
                 "blocks": line["blocks"], "bound_ms": bms, "bound_by": by,
                 "B": line["B"], "Cs": line["Cs"]}
        if not quick:
            line.update(kernel_ms=cuda_ms(lambda: warp(*args)),
                        plain_ms=cuda_ms(lambda: warp_plain(*args),
                                         iters=5))
            entry.update(ms=line["kernel_ms"], plain_ms=line["plain_ms"])
            jobs.append(warp_extras_job(label, args, entry))
        print(json.dumps(line), flush=True)
        out.append(entry)
    return out


def warp_extras_job(label: str, args, entry: dict):
    """A profiled_pass job: K2's device time per call on an extras case,
    printed beside its bound and blocks."""
    from stf_unet_tpu_torch.ops.kernels.warp import warp

    def job():
        dev = profiled_ms(lambda: warp(*args), WARP_PROFILED_CALLS,
                          "stf::warp_kernel")
        entry["device_ms"] = dev
        print(json.dumps({"kernel": "warp", "case": label,
                          "device_ms": dev, "bound_ms": entry["bound_ms"],
                          "blocks": entry["blocks"],
                          "profiled_calls": WARP_PROFILED_CALLS}),
              flush=True)
    return job


def warp_phase(device, quick: bool, jobs: list):
    """K2 against its plain version at the training shape, without PK maps
    (Cs=9) and with them (Cs=12), each line with its blocks by path (the
    training draws must all take the staged path), then warp_edge_cases;
    timings of kernel, plain version and F.grid_sample at the training
    shapes (CUDA events over 20 calls; the host time of one warp() call),
    and queued on `jobs` (profiled_pass) the device time per call over
    WARP_PROFILED_CALLS calls of K2 and of F.grid_sample, and rule 2's
    test: K2 is left alone where its device time is within 2x its bound
    and no slower than F.grid_sample's. Returns the kernels-line entry
    (Cs=9, with the Cs=12 figures under "pk_shape")."""
    from stf_unet_tpu_torch.ops.kernels.warp import warp, warp_plain

    entries = []
    for pk_maps in (False, True):
        aug, stacked, gy, gx, valid = warp_inputs(device, pk_maps)
        args = (stacked, gy, gx, valid, aug.alpha, aug.beta)
        cs = stacked.shape[1]
        line = warp_case(f"train Cs={cs}", args, "staged")
        entry = {"max_abs_err": line["max_abs_err"], "ms": None,
                 "plain_ms": None, "bound_ms": None, "bound_by": None,
                 "library_ms": None,
                 "shapes": [{"B": WARP_B, "Cs": cs, "H": WARP_SRC,
                             "W": WARP_SRC, "Ho": gy.shape[1],
                             "Wo": gy.shape[2]}]}
        if not quick:
            bms, by = warp_bound(args)
            library = grid_sample_fn(stacked, gy, gx)
            entry.update(ms=cuda_ms(lambda: warp(*args)),
                         plain_ms=cuda_ms(lambda: warp_plain(*args),
                                          iters=5),
                         bound_ms=bms, bound_by=by,
                         library_ms=cuda_ms(library),
                         host_us=host_us(lambda: warp(*args)))
            line.update(kernel_ms=entry["ms"], plain_ms=entry["plain_ms"],
                        bound_us=bms * 1e3, bound_by=by,
                        library_ms=entry["library_ms"],
                        host_us=entry["host_us"])
            jobs.append(warp_device_job(
                {"kernel": "warp", "B": WARP_B, "Cs": cs}, args, library,
                entry))
        print(json.dumps(line), flush=True)
        entries.append(entry)
    warp_edge_cases(device)
    extras = warp_extras_cases(device, quick, jobs)
    entry, pk_entry = entries
    entry["max_abs_err"] = max(entry["max_abs_err"], pk_entry["max_abs_err"])
    entry["pk_shape"] = pk_entry
    entry["extras"] = extras
    entry["max_abs_err"] = max([entry["max_abs_err"]]
                               + [e["max_abs_err"] for e in extras])
    return entry


def warp_device_job(ident: dict, args, library, entry: dict):
    """A profiled_pass job: K2's and F.grid_sample's device time per call
    over WARP_PROFILED_CALLS calls each, and rule 2's verdict, into
    `entry` and printed with `ident`."""
    from stf_unet_tpu_torch.ops.kernels.warp import warp

    def job():
        dev = profiled_ms(lambda: warp(*args), WARP_PROFILED_CALLS,
                          "stf::warp_kernel")
        lib_dev = profiled_ms(library, WARP_PROFILED_CALLS)
        bms = entry["bound_ms"]
        entry.update(device_ms=dev, library_device_ms=lib_dev,
                     rule2_leave_alone=(
                         dev <= 2 * bms and dev <= lib_dev
                         if dev is not None and lib_dev is not None
                         else "not measured"))
        print(json.dumps({**ident, "device_ms": dev,
                          "library_device_ms": lib_dev,
                          "profiled_calls": WARP_PROFILED_CALLS,
                          "bound_us": bms * 1e3,
                          "rule2_leave_alone": entry["rule2_leave_alone"]}),
              flush=True)
    return job


def grid_sample_fn(stacked, gy, gx):
    """fn() running F.grid_sample bilinear over the frames plus nearest
    over the mask at the same coordinates (a yardstick only; the port
    never calls it). The float source is made outside fn."""
    import torch
    import torch.nn.functional as F

    h, w = stacked.shape[-2:]
    grid = torch.stack([gx / (w - 1) * 2 - 1, gy / (h - 1) * 2 - 1], -1)
    src = stacked.float()
    frames, mask = src[:, :-1], src[:, -1:]

    def both():
        F.grid_sample(frames, grid, mode="bilinear", padding_mode="zeros",
                      align_corners=True)
        F.grid_sample(mask, grid, mode="nearest", padding_mode="zeros",
                      align_corners=True)

    return both


# K4 at the PK fit's shapes (T=8 time points, Q=700 grid points): a full
# voxel chunk, the last chunk of a 256^2 synthetic volume (41,719 tissue
# voxels = 2 x 16384 + 8951) and a small one. Kernel vs plain version, per
# output: max |difference| <= TOFTS_ATOL + TOFTS_RTOL * max |plain value|
# (the same f32 terms summed over 700 grid points in another order, and
# expf's last bit; the JAX package holds its interpret-mode kernel to the
# XLA pair at these limits, tests/test_pk.py).
TOFTS_N = (16384, 8951, 256)
TOFTS_RTOL, TOFTS_ATOL = 1e-5, 1e-6
# The SFU's exponential rate on compute capability 9.0, per SM and clock.
SFU_EXP_PER_CLOCK = 16
# K4's device time per call: one torch.profiler window over this many
# back-to-back calls (a call's ~0.01-0.05 ms is near the host's enqueue
# time, so CUDA events over 50 calls may time the host).
TOFTS_PROFILED_CALLS = 500
# K4 is also checked on a finer quadrature grid than the fit's (Q = 3,500
# of the kernel's 4,096 at dt = 0.002) with non-finite rates, at a ragged
# N (tofts_edge_check).
TOFTS_WIDE_DT = 0.002
TOFTS_EDGE_N = 300


def sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def tofts_rates(gen, n: int, device):
    """Rates K/ve spread over [0, 1000] (the clamp box allows K <= 1, ve >=
    0.001): half log-uniform over [1e-3, 1e3], half uniform, one 0."""
    import torch

    half = n // 2
    log_part = 10.0 ** (torch.rand((half,), generator=gen) * 6 - 3)
    lin_part = torch.rand((n - half,), generator=gen) * 1000
    rate = torch.cat([log_part, lin_part])[torch.randperm(n, generator=gen)]
    rate[0] = 0.0
    return rate.to(device)


def tofts_phase(device, quick: bool, jobs: list):
    """K4 against its plain version at the PK fit's voxel counts; timings
    of kernel and plain version at a full chunk, the host time of a call,
    its bound and the SFU floor over the active (t, q) terms (the kernel's
    rule, ops/kernels/tofts.active_lengths) and over the full grid, and
    its device time per call queued on `jobs` (profiled_pass). Returns
    the kernels-line entry."""
    import torch

    from stf_unet_tpu_torch.core.config import PKConfig
    from stf_unet_tpu_torch.ops.kernels.tofts import (active_lengths,
                                                      tofts_sums,
                                                      tofts_sums_plain)
    from stf_unet_tpu_torch.pk.aif import make_aif
    from stf_unet_tpu_torch.pk.tofts import ToftsQuadrature

    cfg = PKConfig()
    quad = ToftsQuadrature.build(cfg.time_points, make_aif(cfg.aif_method),
                                 cfg.dt, device=device)
    t_steps, q = quad.lags.shape
    active_terms = int(active_lengths(quad.lags, quad.weights,
                                      quad.wlags).sum())
    gen = torch.Generator().manual_seed(4)
    entry = {"max_abs_err": 0.0, "ms": None, "plain_ms": None,
             "bound_ms": None, "bound_by": None, "library_ms": None,
             "shapes": [{"N": TOFTS_N[0], "T": t_steps, "Q": q}]}
    for n in TOFTS_N:
        rate = tofts_rates(gen, n, device)
        args = (rate, quad.lags, quad.weights, quad.wlags)
        got = tofts_sums(*args)
        want = tofts_sums_plain(*args)
        torch.cuda.synchronize()
        line = {"kernel": "tofts_sums", "N": n, "T": t_steps, "Q": q,
                "rtol": TOFTS_RTOL, "atol": TOFTS_ATOL}
        for name, g, w in zip(("s", "s_lag"), got, want):
            check(g.shape == w.shape == (n, t_steps),
                  f"tofts_sums N={n} {name}: shape {tuple(g.shape)}")
            check(bool(torch.isfinite(g).all()),
                  f"tofts_sums N={n}: non-finite {name}")
            err = (g - w).abs().max().item()
            scale = w.abs().max().item()
            line[f"{name}_max_abs_err"] = err
            line[f"{name}_max_abs"] = scale
            check(err <= TOFTS_ATOL + TOFTS_RTOL * scale,
                  f"tofts_sums N={n} {name}: max abs err {err} > "
                  f"{TOFTS_ATOL} + {TOFTS_RTOL} * {scale}")
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if n == TOFTS_N[0] and not quick:
            nbytes = 4 * (n + 3 * t_steps * q + 2 * n * t_steps)
            sms = torch.cuda.get_device_properties(device).multi_processor_count
            clock = sm_clock_hz()
            active, full = n * active_terms, n * t_steps * q
            bms, by = bound_ms(nbytes, 6.0 * active, "f32")
            bms_full, _ = bound_ms(nbytes, 6.0 * full, "f32")

            def sfu_ms(elems):
                return elems / (SFU_EXP_PER_CLOCK * sms * clock) * 1e3

            entry.update(ms=cuda_ms(lambda: tofts_sums(*args), iters=50),
                         plain_ms=cuda_ms(lambda: tofts_sums_plain(*args),
                                          iters=5),
                         host_us=host_us(lambda: tofts_sums(*args)),
                         bound_ms=bms, bound_by=by)
            line.update(kernel_ms=entry["ms"], plain_ms=entry["plain_ms"],
                        host_us=entry["host_us"], library_ms=None,
                        bound_us=bms * 1e3, bound_by=by,
                        sfu_floor_us=sfu_ms(active) * 1e3,
                        sfu_floor_clock_mhz=clock / 1e6,
                        active_share=active_terms / (t_steps * q),
                        bound_us_full_grid=bms_full * 1e3,
                        sfu_floor_us_full_grid=sfu_ms(full) * 1e3)
            jobs.append(device_job(
                {"kernel": "tofts_sums", "N": n}, lambda a=args:
                tofts_sums(*a), "stf::tofts_sums", TOFTS_PROFILED_CALLS,
                entry))
        print(json.dumps(line), flush=True)
    tofts_edge_check(device)
    return entry


def tofts_edge_check(device) -> None:
    """K4 off the fit's defaults, against its plain version: a finer grid
    (TOFTS_WIDE_DT, Q above the 2,048 points whose two staged rows fit the
    48 KB a block gets by default, so the launch opts into more shared
    memory) and rates of inf, NaN and -inf beside finite ones. NaN and inf
    must sit where the plain sums have them (an all-zero row gives NaN
    for such a rate, 0 * exp(NaN)); the finite values within
    TOFTS_ATOL + TOFTS_RTOL * max."""
    import torch

    from stf_unet_tpu_torch.core.config import PKConfig
    from stf_unet_tpu_torch.ops.kernels.tofts import (tofts_sums,
                                                      tofts_sums_plain)
    from stf_unet_tpu_torch.pk.aif import make_aif
    from stf_unet_tpu_torch.pk.tofts import ToftsQuadrature

    cfg = PKConfig()
    quad = ToftsQuadrature.build(cfg.time_points, make_aif(cfg.aif_method),
                                 TOFTS_WIDE_DT, device=device)
    rate = tofts_rates(torch.Generator().manual_seed(6), TOFTS_EDGE_N,
                       device)
    rate[1:4] = torch.tensor([float("inf"), float("nan"), -float("inf")])
    args = (rate, quad.lags, quad.weights, quad.wlags)
    got = tofts_sums(*args)
    want = tofts_sums_plain(*args)
    torch.cuda.synchronize()
    line = {"kernel": "tofts_sums", "check": "wide grid, non-finite rates",
            "N": TOFTS_EDGE_N, "T": quad.lags.shape[0],
            "Q": quad.lags.shape[1], "rtol": TOFTS_RTOL, "atol": TOFTS_ATOL}
    for name, g, w in zip(("s", "s_lag"), got, want):
        ok = torch.isfinite(w)
        check(torch.equal(torch.isnan(g), torch.isnan(w))
              and torch.equal(g[torch.isinf(w)], w[torch.isinf(w)]),
              f"tofts_sums {line['check']} {name}: NaN / inf where the "
              f"plain sums have none ({int(torch.isnan(g).sum())} NaN, "
              f"{int(torch.isnan(w).sum())} in the plain sums)")
        err = (g[ok] - w[ok]).abs().max().item()
        scale = w[ok].abs().max().item()
        line[f"{name}_max_abs_err"] = err
        line[f"{name}_nan"] = int(torch.isnan(w).sum())
        check(err <= TOFTS_ATOL + TOFTS_RTOL * scale,
              f"tofts_sums {line['check']} {name}: max abs err {err} > "
              f"{TOFTS_ATOL} + {TOFTS_RTOL} * {scale}")
    check(line["Q"] > 2048, f"tofts_sums: the wide grid has Q={line['Q']}")
    print(json.dumps(line), flush=True)


# K7 is timed at the STF-LSTM-UNet's stem and layer3 BNs (B*T = 128
# frames at crop 224): the widest plane and a small one.
BN_TIMED = {"stem": (128, 64, 112, 112), "layer3": (128, 256, 14, 14)}


def bn_phase(device, quick: bool) -> dict:
    """K7 forward + backward at every distinct BN input shape of both CNN
    cells (B = 16, crop 224; ops/kernels/batch_norm.bn_input_shapes), in
    bf16, NCHW and channels-last, against its plain twins computed in
    float64 on the card, a rerun bit-identical (batch_norm.twin_excess,
    which the card tests run too): one `bn` line each with its tiling.
    Then, unless quick, at the BN_TIMED shapes in both layouts: K7's
    device ms by torch.profiler (its bn_ kernels over 20 calls), its
    events ms, the byte floor (x read and y written forward, x and dy
    read and dx written backward: 10 bytes an element in bf16) and the
    design's count (16), the plain twin's ms and F.batch_norm's train
    forward + backward ms (events). Returns the kernel's summary."""
    import torch
    import torch.nn.functional as F

    from stf_unet_tpu_torch.ops.kernels import batch_norm as bn

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    shapes = sorted(set(bn.bn_input_shapes("stflstm")
                        + bn.bn_input_shapes("unet")))
    worst = {}
    for shape in shapes:
        for cl in (False, True):
            excess = bn.twin_excess(shape, torch.bfloat16, cl, device)
            t = bn.tiling(*shape[:2], shape[2] * shape[3], 2, cl, 16, sms)
            print(json.dumps({"bn": {
                "kernel": "batch_norm", "dims": list(shape),
                "channels_last": cl, "tiling": t._asdict(),
                "excess": excess}}), flush=True)
            bad = {k: v for k, v in excess.items() if v > 0}
            check(not bad, f"K7 at {shape} (channels_last={cl}) against "
                           f"its plain twins: {bad}")
            for k, v in excess.items():
                worst[k] = max(worst.get(k, v), v)
    summary = {"checked": {"shapes": len(shapes), "layouts": 2,
                           "dtype": "bf16"}, "worst_excess": worst}
    if quick:
        return summary
    timed = {}
    for label, shape in BN_TIMED.items():
        for cl in (False, True):
            x, dy, w, b, (rm, rv) = bn.twin_case(shape, torch.bfloat16, cl,
                                                 device)

            def k7():
                yy, mm, ii = bn.batch_norm_forward(x, w, b, rm, rv)
                bn.batch_norm_backward(dy, x, w, mm, ii)

            def plain():
                yy, mm, ii = bn.batch_norm_forward_plain(x, w, b, rm, rv)
                bn.batch_norm_backward_plain(dy, x, w, mm, ii)

            xs, ws, bs = (v.detach().clone().requires_grad_()
                          for v in (x, w, b))

            def library():
                F.batch_norm(xs, rm, rv, ws, bs, True).backward(dy)

            line = {"kernel": "batch_norm", "shape": label,
                    "dims": list(shape), "channels_last": cl,
                    "device_ms": profiled_ms(k7, 20, "bn_"),
                    "library_device_ms": profiled_ms(library, 20,
                                                     "batch_norm"),
                    "ms": cuda_ms(k7), "plain_ms": cuda_ms(plain, iters=5),
                    "library_ms": cuda_ms(library),
                    "floor_ms": bound_ms(10 * x.numel(), 0, "bf16")[0],
                    "design_ms": bound_ms(16 * x.numel(), 0, "bf16")[0]}
            print(json.dumps({"bn": line}), flush=True)
            timed[f"{label}{'_channels_last' if cl else ''}"] = line
    return {**summary, "timed": timed}


def serving_phase(tmpdir: str):
    import torch

    from stf_unet_tpu_torch.cli.serve import build_server, parse_args
    from stf_unet_tpu_torch.core.config import ModelConfig
    from stf_unet_tpu_torch.models.registry import create_model
    from stf_unet_tpu_torch.serve.client import SegmentationClient

    torch.manual_seed(0)
    weights = os.path.join(tmpdir, "stflstm_seed0.pth")
    torch.save({"model": create_model(ModelConfig()).state_dict(),
                "epoch": 0}, weights)
    t0 = time.perf_counter()
    server = build_server(parse_args(
        ["--weights", weights, "--port", "0", "--dtype", "bf16",
         "--max-batch", "8", "--batch-window-ms", "20"]))
    print(f"server built and warmed in {time.perf_counter() - t0:.3f} s",
          flush=True)
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (T_STEPS, 256, 256), dtype=np.uint8)
              for _ in range(N_REQUESTS)]
    server.start()
    try:
        client = SegmentationClient(
            "http://%s:%d" % server.address, timeout=300)

        def one(i):
            t = time.perf_counter()
            mask = client.segment(frames[i], full_size=i % 4 == 3)
            return mask, (time.perf_counter() - t) * 1e3

        kernels = reset_counts()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(N_REQUESTS) as ex:
            results = list(ex.map(one, range(N_REQUESTS)))
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in kernels.items()}
        metrics = client.metrics()
        for i, (mask, _) in enumerate(results):
            want = (256, 256) if i % 4 == 3 else (CROP, CROP)
            check(mask.shape == want,
                  f"request {i}: mask {mask.shape}, expected {want}")
            check(int(mask.max()) <= 1, f"request {i}: class out of range")
        lat = sorted(ms for _, ms in results)
        for name in ("lstm_last_x", "lstm_last"):
            check(launches[name] > 0, f"kernel {name} never launched while "
                                      f"serving")
        print(json.dumps({
            "serving": {"requests": N_REQUESTS, "wall_s": wall,
                        "requests_per_s": N_REQUESTS / wall,
                        "client_p50_ms": lat[len(lat) // 2],
                        "client_p99_ms": lat[min(len(lat) - 1,
                                                 int(0.99 * len(lat)))],
                        "server_latency_ms": metrics["latency_ms"],
                        "batches": metrics["batches"],
                        "mean_batch": metrics["mean_batch"],
                        "launches": launches}}), flush=True)
        return server, frames, launches
    finally:
        server.stop()


def breakdown_phase(server, frames):
    """Where one request's time goes with the server otherwise idle: host
    preprocessing, engine.predict per bucket (host clock: copy in,
    forward, copy out), and the device kernels of a B=8 forward by
    torch.profiler, with the device's idle share over that window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stf_unet_tpu_torch.data.transforms import normalize

    eng = server.engine
    t0 = time.perf_counter()
    images = np.stack([server.preprocess(f)[0] for f in frames[:8]])
    preprocess_ms = (time.perf_counter() - t0) * 1e3 / 8
    predict_ms = {}
    for b in BUCKETS:
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            eng.predict(images[:b])
            runs.append((time.perf_counter() - t0) * 1e3)
        predict_ms[b] = sorted(runs)[2]
    x = normalize(torch.from_numpy(images).cuda(), eng.mean, eng.std)
    with torch.inference_mode():
        forward_ms = cuda_ms(lambda: eng.model(x), iters=5, warmup=2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                eng.model(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]

    busy_ms = sum(dev_ms(e) for e in kernels)
    lstm_ms = sum(dev_ms(e) for e in kernels if "stf::lstm_last" in e.key)
    top = sorted(kernels, key=dev_ms, reverse=True)[:10]

    def idle(window_ms):  # kernel time per forward against a window
        return 1 - busy_ms / 3 / window_ms if busy_ms else "not measured"

    print(json.dumps({"breakdown": {
        "preprocess_ms_per_request": preprocess_ms,
        "predict_ms_by_bucket": predict_ms,
        "forward_event_ms_b8": forward_ms,
        "profiled_forwards": 3, "profiled_wall_ms": wall_ms,
        "kernel_busy_ms": busy_ms if busy_ms else "not measured",
        # idle share of the device over: the profiled window; back-to-back
        # unprofiled forwards (CUDA events); one unprofiled predict call
        "device_idle_share_profiled": idle(wall_ms / 3),
        "device_idle_share_forwards": idle(forward_ms),
        "device_idle_share_predict_b8": idle(predict_ms[8]),
        "lstm_kernels_share": (lstm_ms / busy_ms) if busy_ms
        else "not measured",
        "port_kernels_ms_per_forward": port_kernels_by_name(kernels, 3),
        "top_kernels": [{"name": e.key[:90], "calls": e.count,
                         "ms": dev_ms(e)} for e in top]}}), flush=True)


def path_phase(server, frames, weights_sd):
    """Kernels ("auto") against the plain LSTM loop ("scan") on one batch:
    the serving model in bf16 (printed) and an f32 copy (checked)."""
    import torch

    from stf_unet_tpu_torch.core.config import ModelConfig
    from stf_unet_tpu_torch.data.transforms import normalize
    from stf_unet_tpu_torch.models.registry import create_model

    images = np.stack([server.preprocess(f)[0] for f in frames[:2]])
    x = normalize(torch.from_numpy(images).cuda(), server.data_cfg.mean,
                  server.data_cfg.std)
    f32_model = create_model(ModelConfig())
    f32_model.load_state_dict(weights_sd, strict=True)
    f32_model = f32_model.eval().cuda()
    for label, model in (("bf16", server.engine.model), ("f32", f32_model)):
        with torch.inference_mode():
            model.set_lstm_backend("auto")
            kern = model(x)["out"]
            model.set_lstm_backend("scan")
            plain = model(x)["out"]
            model.set_lstm_backend("auto")
        check(bool(torch.isfinite(kern).all()), f"{label}: non-finite logits")
        diff = (kern - plain).abs().max().item()
        scale = max(1.0, plain.abs().max().item())
        agree = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
        print(json.dumps({"path_check": label, "logits_max_abs_diff": diff,
                          "logits_max_abs": plain.abs().max().item(),
                          "mask_agreement": agree}), flush=True)
        if label == "f32":
            # same f32 arithmetic in another summation order
            check(diff <= 1e-4 * scale, f"f32 kernel path vs scan: logits "
                                        f"differ by {diff}")
            check(agree >= 0.999, f"f32 mask agreement {agree}")
        else:
            # scan keeps (h, c) in bf16, the kernels in f32: masks move
            # only where the two classes' logits nearly tie
            check(agree >= 0.9, f"bf16 mask agreement {agree}")


# Training phase: a synthetic BreaDM tree at 256^2 (64 training slices, 16
# each for val and test), trained at full width in bf16, batch 16, crop 224
# for 3 epochs = 12 optimizer steps, with evaluation and checkpoints.
TRAIN_SRC = 256
TRAIN_CROP = 224
TRAIN_PATIENTS, TRAIN_SLICES = 8, 8   # 64 training slices
EVAL_PATIENTS = 2                     # x TRAIN_SLICES val / test slices
TRAIN_BATCH, TRAIN_EPOCHS = 16, 3
TRAIN_KERNELS = ("lstm_last_x", "lstm_last_x_bwd", "warp", "lstm_last")
# K7's wrappers: a train-mode BN without a data group launches 3 of each
# a training forward and backward (a synced BN launches none)
BN_KERNELS = ("batch_norm_forward", "batch_norm_backward")
FIXED_STEPS = 8      # repeated steps on one fixed batch: the loss must fall
TIMED_STEPS = 10     # back-to-back steps for ms/step and the idle share
# Kernel path against plain path, one training step at full width, B=4:
# the kernel path in f32 (K1 / K1b at C <= 128, the warp kernel) and the
# plain path (scan, plain warp) in f32 and in float64, on the same images
# (the warp kernel and its plain version give them bit for bit). f32
# gradients of this network are noisy by themselves: through ~40 layers of
# train-mode BN a change of summation order alone moves a tensor's gradient
# by several 1e-3 of its max (the two f32 paths differed by up to 3.1e-3
# and 8.8e-3 of a tensor's max in two runs). So both f32 paths are held to
# the float64 one, and the kernels must add no error of their own:
#  * loss within 1e-5 relative of the float64 loss (f32 rounding of a mean
#    over 4*224^2 pixels);
#  * the gradient error over all parameters (L2 norm of the difference
#    over the norm of the float64 gradient) at most PATH_ERR_RATIO times
#    the plain f32 path's;
#  * tensor by tensor, the error (max |difference| over its max |float64
#    gradient|) at most PATH_ERR_RATIO times the plain f32 path's error of
#    the same tensor plus PATH_ERR_FLOOR: the floor covers the two f32
#    paths' own difference (up to 8.8e-3, above) where the plain error is
#    small. A K1 / K1b fault of 1.5e-2 of an LSTM tensor's max fails it.
PATH_BATCH = 4
PATH_LOSS_RTOL = 1e-5
PATH_ERR_RATIO = 2.0
PATH_ERR_FLOOR = 1e-2


# the kernel table's names for the wrappers not named so
COUNTER_NAMES = {"quantize_patches": "quant_patches",
                 "dequant_epilogue": "quant_epilogue"}


def counters():
    from stf_unet_tpu_torch.ops import counted_kernels

    return {COUNTER_NAMES.get(k.__name__, k.__name__): k
            for k in counted_kernels()}


def check_bn_launches(label: str, launches: dict, model: str,
                      steps: int) -> None:
    """K7's launches over `steps` training steps of `model` at any batch
    (each a forward and a backward): 3 forward and 3 backward for each of
    its BN calls a forward."""
    from stf_unet_tpu_torch.ops.kernels.batch_norm import bn_input_shapes

    want = 3 * len(bn_input_shapes(model)) * steps
    got = tuple(launches[name] for name in BN_KERNELS)
    check(got == (want, want), f"{label}: K7 launched {got} (forward, "
                               f"backward) in {steps} steps, expected "
                               f"{want} each")


def reset_counts() -> dict:
    kernels = counters()
    for fn in kernels.values():
        fn.launches = 0
    return kernels


def write_tree(tmpdir: str) -> str:
    from stf_unet_tpu_torch.data.synthetic import make_synthetic_breadm

    data = os.path.join(tmpdir, "breadm")
    t0 = time.perf_counter()
    make_synthetic_breadm(data, splits=("training",),
                          patients_per_split=TRAIN_PATIENTS,
                          slices_per_patient=TRAIN_SLICES, size=TRAIN_SRC,
                          sequence_prefix="SUB", seed=0)
    make_synthetic_breadm(data, splits=("val", "test"),
                          patients_per_split=EVAL_PATIENTS,
                          slices_per_patient=TRAIN_SLICES, size=TRAIN_SRC,
                          sequence_prefix="SUB", seed=1)
    print(f"synthetic tree written in {time.perf_counter() - t0:.3f} s",
          flush=True)
    return data


def training_phase(tmpdir: str, data: str, device: str = "cuda"):
    """cli/train.run at full width, bf16: every loss finite, >= 10 steps
    over >= 2 epochs, latest/best written, every training kernel launched.
    Returns (launch counts, the run's result)."""
    import math

    from stf_unet_tpu_torch.cli import train as train_cli

    kernels = reset_counts()
    weights = os.path.join(tmpdir, "weights")
    t0 = time.perf_counter()
    result = train_cli.run([
        "--data-path", data, "--model", "stflstm", "--amp", "true",
        "--use-subtraction",
        "--batch-size", str(TRAIN_BATCH), "--epochs", str(TRAIN_EPOCHS),
        "--eval-batch-size", str(TRAIN_BATCH), "--seed", "0",
        "--data-base-size", str(TRAIN_SRC),
        "--data-crop-size", str(TRAIN_CROP),
        "--save-dir", weights, "--output-dir", os.path.join(tmpdir, "out"),
        "--print-freq", "1", "--device", device])
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    losses = [e["train_loss"] for e in result["epochs"]]
    check(len(result["epochs"]) >= 2, f"trained {len(result['epochs'])} "
                                      f"epochs, expected >= 2")
    check(result["steps"] >= 10, f"trained {result['steps']} steps, "
                                 f"expected >= 10")
    check(all(math.isfinite(v) for v in losses),
          f"non-finite training loss: {losses}")
    for kind in ("latest", "best"):
        path = os.path.join(weights, f"stflstm_{kind}_model.pth")
        check(os.path.isfile(path), f"no {kind} checkpoint at {path}")
    for name in TRAIN_KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched while "
                                  f"training")
    check_bn_launches("cli/train (STF)", launches, "stflstm",
                      result["steps"])
    print(json.dumps({"training": {
        "wall_s": wall, "epochs": result["epochs"],
        "steps": result["steps"], "best_dice": result["best_dice"],
        "test_dice": result["test"]["dice"],
        "launches": launches}}), flush=True)
    return launches, result


def train_objects(data: str, dtype, device, batch: int, pk: bool = False,
                  model_name: str = "stflstm"):
    """Model (seeded, full width), optimizer, augmentation and one host
    batch of the synthetic tree, as cli/train builds them; with pk, the
    PK-maps model and batches that carry the maps; model_name "unet", the
    vanilla UNet at base_c = 64."""
    import torch

    from stf_unet_tpu_torch.core.config import (DataConfig, ModelConfig,
                                                OptimConfig)
    from stf_unet_tpu_torch.data.index import DatasetIndex
    from stf_unet_tpu_torch.data.loader import HostLoader
    from stf_unet_tpu_torch.data.transforms import TrainAugment
    from stf_unet_tpu_torch.models.registry import create_model
    from stf_unet_tpu_torch.train.state import TrainState, make_optimizer

    cfg = DataConfig(data_path=data, use_subtraction=True, use_pk_maps=pk,
                     base_size=TRAIN_SRC, crop_size=TRAIN_CROP)
    index = DatasetIndex(data, "train", cfg.resolved_sequence_types,
                         use_pk_maps=pk)
    host = next(iter(HostLoader(index, batch, shuffle=False, use_pk_maps=pk,
                                prefetch=0).epoch(0)))
    torch.manual_seed(0)
    model = create_model(ModelConfig(model=model_name, use_pk_maps=pk),
                         dtype=dtype).to(device)
    state = TrainState(model, make_optimizer(OptimConfig(), model,
                                             torch.device(device)))
    return state, TrainAugment(cfg), host


def step_phase(data: str, device: str = "cuda", pk: bool = False,
               model_name: str = "stflstm"):
    """bf16 training steps at batch 16 on one fixed batch: the loss of
    repeated steps must fall; ms per step and samples/s over back-to-back
    steps; a torch.profiler view of one step (kernel time by name, the
    device's idle share). pk: the PK-maps model on batches with maps.
    model_name "unet": the vanilla UNet, with its step's convolution FLOPs
    (3 x one forward's) against the card's dense bf16 peak."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stf_unet_tpu_torch.core.prng import augment_generator
    from stf_unet_tpu_torch.models.registry import preprocess_input
    from stf_unet_tpu_torch.train.loop import train_step
    from stf_unet_tpu_torch.utils import benchkit

    state, augment, host = train_objects(data, torch.bfloat16, device,
                                         TRAIN_BATCH, pk=pk,
                                         model_name=model_name)
    dev = torch.device(device)
    counted = reset_counts()

    def step():
        return train_step(state, augment, host,
                          augment_generator(0, 0, 0), lambda s: 1e-3,
                          2, dev)[0]

    losses = [step().item() for _ in range(FIXED_STEPS)]
    check(all(np.isfinite(losses)), f"non-finite fixed-batch loss {losses}")
    check(losses[-1] < losses[0], f"the loss of repeated steps on one "
                                  f"batch did not fall: {losses}")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    if dev.type == "cuda":  # the timed steps' own peak, not the process's
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        loss = step()
    loss.item()
    step_ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        step().item()
        prof_ms = (time.perf_counter() - t0) * 1e3
    check_bn_launches(f"train steps ({model_name}{', PK' if pk else ''})",
                      _launches(counted), model_name,
                      FIXED_STEPS + TIMED_STEPS + 1)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]

    busy = sum(dev_ms(e) for e in kernels)
    ours = sum(dev_ms(e) for e in kernels if "stf::" in e.key)
    top = sorted(kernels, key=dev_ms, reverse=True)[:12]
    flops = {}
    if model_name == "unet":
        images, _ = augment(augment_generator(0, 0, 0),
                            torch.from_numpy(host.frames).to(dev),
                            torch.from_numpy(host.masks).to(dev), host.sizes)
        step_flop = 3 * benchkit.forward_flops(
            state.model, preprocess_input(images, state.model))
        flops = {"step_tflop": step_flop / 1e12,
                 "bound_ms": step_flop / PEAK_FLOPS["bf16"] * 1e3,
                 "share_of_bf16_peak": step_flop / PEAK_FLOPS["bf16"]
                 / (step_ms * 1e-3),
                 "kernel_share_of_bf16_peak": (
                     step_flop / PEAK_FLOPS["bf16"] / (busy * 1e-3))
                 if busy else "not measured"}
        check(abs(step_flop - UNET_STEP_FLOP) <= 1e-3 * UNET_STEP_FLOP,
              f"UNet step FLOPs {step_flop:.4g}, expected "
              f"{UNET_STEP_FLOP:.4g}")
    print(json.dumps({"train_steps": {
        "model": model_name, "pk_maps": pk, "batch": TRAIN_BATCH,
        "fixed_batch_losses": losses, **flops,
        "ms_per_step": step_ms,
        "samples_per_s": TRAIN_BATCH * 1e3 / step_ms,
        "profiled_step_wall_ms": prof_ms,
        "kernel_busy_ms": busy if busy else "not measured",
        # idle share of the device: over back-to-back unprofiled steps
        # (kernel time from the profiled step), and over the profiled step
        "device_idle_share_steps": (1 - busy / step_ms) if busy
        else "not measured",
        "device_idle_share_profiled": (1 - busy / prof_ms) if busy
        else "not measured",
        "port_kernels_ms": ours, "port_kernels_share": (ours / busy)
        if busy else "not measured",
        "port_kernels_by_name": port_kernels_by_name(kernels),
        "peak_memory_gb_timed_steps": (
            torch.cuda.max_memory_allocated(dev) / 2**30)
        if dev.type == "cuda" else "not measured",
        "top_kernels": [{"name": e.key[:90], "calls": e.count,
                         "ms": dev_ms(e)} for e in top]}}), flush=True)


def train_path_phase(data: str, device: str = "cuda"):
    """One training step at full width through the kernels (f32) and
    through the plain path (f32, and float64 on the CPU: the card's
    train-mode BatchNorm, K7, takes bfloat16 and float32): same images;
    loss and gradients of both f32 paths against float64, with the
    kernels adding no error of their own (see PATH_ERR_RATIO)."""
    import torch

    from stf_unet_tpu_torch.core.config import ModelConfig
    from stf_unet_tpu_torch.core.prng import augment_generator
    from stf_unet_tpu_torch.models.registry import create_model
    from stf_unet_tpu_torch.ops.kernels.warp import warp_plain
    from stf_unet_tpu_torch.train.loop import loss_and_grads

    state, augment, host = train_objects(data, torch.float32, device,
                                         PATH_BATCH)
    f64 = create_model(ModelConfig(), dtype=torch.float64).to(
        "cpu", torch.float64)
    f64.load_state_dict(state.model.state_dict())
    frames = torch.from_numpy(host.frames).to(device)
    masks = torch.from_numpy(host.masks).to(device)
    gy, gx = augment.grids(augment_generator(0, 0, 0), host.sizes, device)
    bil, near = warp_plain(
        torch.cat([frames, masks.unsqueeze(1)], dim=1), gy, gx,
        torch.as_tensor(host.sizes).to(device, torch.float32),
        alpha=augment.alpha, beta=augment.beta)
    plain_batch = (bil.unsqueeze(-1), near.to(torch.int64))
    runs = {}
    for label, model, backend, plain in (
            ("kernels", state.model, "auto", False),
            ("plain", state.model, "scan", True),
            ("float64", f64, "scan", True)):
        model.set_lstm_backend(backend)
        images, targets = plain_batch if plain else augment(
            augment_generator(0, 0, 0), frames, masks, host.sizes)
        model.zero_grad(set_to_none=True)
        x, y = images, targets
        if model is f64:
            x, y = images.to("cpu", torch.float64), targets.cpu()
        loss = loss_and_grads(model, x, y, 2).item()
        grads = {n: p.grad.detach().to(device, torch.float64)
                 for n, p in model.named_parameters()}
        runs[label] = (images, targets, loss, grads)
    state.model.set_lstm_backend("auto")
    im_k, tg_k, loss_k, g_k = runs["kernels"]
    im_p, tg_p, loss_p, g_p = runs["plain"]
    _, _, loss_ref, g_ref = runs["float64"]
    check(torch.equal(im_k, im_p) and torch.equal(tg_k, tg_p),
          "warp kernel and plain warp gave different training images")
    check(np.isfinite(loss_k), f"non-finite kernel-path loss {loss_k}")

    def errors(grads):
        per = {n: ((grads[n] - g).abs().max()
                   / g.abs().max().clamp_min(1e-300)).item()
               for n, g in g_ref.items()}
        num = sum(((grads[n] - g) ** 2).sum() for n, g in g_ref.items())
        den = sum((g ** 2).sum() for g in g_ref.values())
        return (num / den).sqrt().item(), per

    norm_k, per_k = errors(g_k)
    norm_p, per_p = errors(g_p)
    worst_k = max(per_k, key=per_k.get)
    worst_p = max(per_p, key=per_p.get)
    loss_err = {lab: abs(v - loss_ref) / abs(loss_ref)
                for lab, v in (("kernels", loss_k), ("plain", loss_p))}
    lstm = {n: {"kernels": per_k[n], "plain": per_p[n]} for n in per_k
            if n.startswith(("lstm1.", "lstm2."))}
    # the tensors where the kernel path's error most exceeds the plain's
    excess = sorted(per_k, key=lambda n: per_p[n] - per_k[n])[:5]
    print(json.dumps({"train_path_check": {
        "batch": PATH_BATCH, "loss_kernels": loss_k, "loss_plain": loss_p,
        "loss_float64": loss_ref, "loss_rel_err": loss_err,
        "grad_norm_rel_err": {"kernels": norm_k, "plain": norm_p},
        "grad_worst_tensor_err": {"kernels": [worst_k, per_k[worst_k]],
                                  "plain": [worst_p, per_p[worst_p]]},
        "fused_lstm_grad_err": lstm,
        "largest_excess": [[n, per_k[n], per_p[n]] for n in excess],
        "loss_rtol": PATH_LOSS_RTOL, "err_ratio": PATH_ERR_RATIO,
        "err_floor": PATH_ERR_FLOOR}}), flush=True)
    for lab, err in loss_err.items():
        check(err <= PATH_LOSS_RTOL, f"f32 {lab} path: loss {err} from the "
                                     f"float64 loss")
    check(norm_k <= PATH_ERR_RATIO * norm_p,
          f"kernel path gradient error {norm_k} > {PATH_ERR_RATIO} x the "
          f"plain f32 path's {norm_p} (L2, against float64)")
    for n, err in per_k.items():
        check(err <= PATH_ERR_RATIO * per_p[n] + PATH_ERR_FLOOR,
              f"kernel path: {n} gradient error {err} > {PATH_ERR_RATIO} x "
              f"the plain f32 path's {per_p[n]} + {PATH_ERR_FLOOR}")


# The vanilla UNet at full width (base_c = 64, T = 8 stacked frames, 2
# classes): one forward at 224^2 is 74,051,747,840 FLOPs of convolutions
# (2 per multiply-add), a bf16 training step at batch 16 three forwards'
# worth: 3.555 TFLOP, 3.59 ms at the dense bf16 peak. Its training runs
# through cli/train like the STF model's (TRAIN_BATCH, TRAIN_EPOCHS, K2
# with Cs = T + 1); its f32 eval logits on the card are held to the port's
# CPU logits within UNET_PARITY_RTOL * max |logit| (cuDNN and oneDNN sum the
# same f32 products in other orders, TF32 off), on UNET_PARITY_BATCH test
# slices.
UNET_STEP_FLOP = 3 * TRAIN_BATCH * 74_051_747_840
UNET_PARITY_BATCH = 2
UNET_PARITY_RTOL = 1e-4
# cli/test on the STF-LSTM-UNet's and the UNet's best checkpoint (bf16, as
# cli/train's test pass ran them): its dice within CLI_TEST_DICE_TOL of that
# test pass's (batch 1 against batch 16: cuDNN may take other algorithms,
# whose bf16 roundings flip a few near-tie pixels).
CLI_TEST_DICE_TOL = 1e-3
CLI_TEST_MODES = {"reports": ["--per-patient", "--surface-metrics",
                              "--threshold-sweep"],
                  "tta": ["--tta"], "tiled": ["--tiled"]}


def unet_training_phase(tmpdir: str, data: str, device: str = "cuda"):
    """cli/train --model unet at full width, bf16: every loss finite,
    >= 10 steps over >= 2 epochs, K2 launched, latest/best written, and
    one comparison render per test record. Returns (launch counts, the
    run's result, its save directory)."""
    import math

    from stf_unet_tpu_torch.cli import train as train_cli
    from stf_unet_tpu_torch.data.index import DatasetIndex

    kernels = reset_counts()
    weights = os.path.join(tmpdir, "weights_unet")
    out = os.path.join(tmpdir, "out_unet")
    t0 = time.perf_counter()
    result = train_cli.run([
        "--data-path", data, "--model", "unet", "--amp", "true",
        "--use-subtraction",
        "--batch-size", str(TRAIN_BATCH), "--epochs", str(TRAIN_EPOCHS),
        "--eval-batch-size", str(TRAIN_BATCH), "--seed", "0",
        "--data-base-size", str(TRAIN_SRC),
        "--data-crop-size", str(TRAIN_CROP),
        "--save-dir", weights, "--output-dir", out,
        "--print-freq", "1", "--device", device])
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    losses = [e["train_loss"] for e in result["epochs"]]
    check(len(result["epochs"]) >= 2 and result["steps"] >= 10,
          f"UNet: trained {len(result['epochs'])} epochs, "
          f"{result['steps']} steps, expected >= 2 and >= 10")
    check(all(math.isfinite(v) for v in losses),
          f"UNet: non-finite training loss: {losses}")
    check(launches["warp"] > 0, "kernel warp never launched while training "
                                "the UNet")
    check_bn_launches("cli/train (UNet)", launches, "unet", result["steps"])
    for kind in ("latest", "best"):
        path = os.path.join(weights, f"unet_{kind}_model.pth")
        check(os.path.isfile(path), f"no UNet {kind} checkpoint at {path}")
    records = len(DatasetIndex(data, "test", tuple(
        f"SUB{i}" for i in range(1, T_STEPS + 1))))
    renders = sorted(os.listdir(os.path.join(out, "test_results")))
    check(renders == [f"unet_{i:03d}_compare.png" for i in range(records)],
          f"UNet test pass: {len(renders)} comparison renders for "
          f"{records} test records")
    print(json.dumps({"unet_training": {
        "wall_s": wall, "epochs": result["epochs"],
        "steps": result["steps"], "best_dice": result["best_dice"],
        "test_dice": result["test"]["dice"], "test_renders": len(renders),
        "launches": launches}}), flush=True)
    return launches, result, weights


def unet_parity_phase(weights: str, data: str, device: str = "cuda"):
    """The UNet's best checkpoint in f32 on the card and on the CPU: the
    logits of UNET_PARITY_BATCH test slices within UNET_PARITY_RTOL * max
    |logit|, argmax equal wherever the two classes differ by more."""
    import torch

    from stf_unet_tpu_torch.cli.common import restore_for_inference
    from stf_unet_tpu_torch.data.index import DatasetIndex
    from stf_unet_tpu_torch.data.transforms import normalize
    from stf_unet_tpu_torch.models.registry import preprocess_input
    from stf_unet_tpu_torch.train.loop import eval_batches_from_index

    path = os.path.join(weights, "unet_best_model.pth")
    logits, secs = {}, {}
    for label, dev in (("card", device), ("cpu", "cpu")):
        model, cfg, _, _ = restore_for_inference(
            "unet", path, use_subtraction=True, dtype="f32", device=dev)
        index = DatasetIndex(data, "test", cfg.resolved_sequence_types)
        image, _ = next(iter(eval_batches_from_index(
            index, cfg, batch_size=UNET_PARITY_BATCH, prefetch=0)))
        x = normalize(torch.from_numpy(image).to(dev), cfg.mean, cfg.std)
        t0 = time.perf_counter()
        with torch.no_grad():
            logits[label] = model(preprocess_input(x, model))["out"].cpu()
        secs[label] = time.perf_counter() - t0
    want, got = logits["cpu"], logits["card"]
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    margin = (want[..., 1] - want[..., 0]).abs()
    decided = margin > 2 * UNET_PARITY_RTOL * scale
    agree = (got.argmax(-1) == want.argmax(-1))[decided].float().mean()
    print(json.dumps({"unet_parity": {
        "batch": list(want.shape), "max_abs_err": err, "max_abs_logit": scale,
        "rtol": UNET_PARITY_RTOL, "decided_share": decided.float().mean()
        .item(), "argmax_agree_decided": agree.item(),
        "card_s": secs["card"], "cpu_s": secs["cpu"]}}), flush=True)
    check(torch.isfinite(got).all().item(), "UNet: non-finite card logits")
    check(err <= UNET_PARITY_RTOL * scale,
          f"UNet f32 logits on the card: max abs err {err} > "
          f"{UNET_PARITY_RTOL} x {scale}")
    check(agree.item() == 1.0, "UNet: argmax differs where decided")


def cli_test_phase(tmpdir: str, data: str, runs, device: str = "cuda"):
    """stf_unet_tpu_torch.cli.test.main on each (model, save directory,
    cli/train test-pass dice) of `runs`, bf16: with the report flags (dice
    within CLI_TEST_DICE_TOL of the test pass's), with --tta and with
    --tiled (finite dice); on the STF-LSTM-UNet every run launches K1 and
    K3. Wall ms per test slice, and without the checkpoint's restore.
    Returns the launch counts, summed."""
    import math

    from stf_unet_tpu_torch.cli import test as cli_test
    from stf_unet_tpu_torch.data.index import DatasetIndex

    slices = len(DatasetIndex(data, "test", tuple(
        f"SUB{i}" for i in range(1, T_STEPS + 1))))
    total = {name: 0 for name in counters()}
    for model, weights, train_dice in runs:
        for mode, flags in CLI_TEST_MODES.items():
            kernels = reset_counts()
            t0 = time.perf_counter()
            metrics = cli_test.main([
                "--model", model, "--model-dir", weights, "--root", data,
                "--use-subtraction", "--dtype", "bf16", "--device", device,
                "--output-dir", os.path.join(tmpdir, f"cli_{model}_{mode}"),
                *flags])
            wall = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in kernels.items()}
            for name, n in launches.items():
                total[name] += n
            dice = metrics["dice"]
            line = {"model": model, "mode": mode, "slices": slices,
                    "dice": dice, "train_test_dice": train_dice,
                    "ms_per_slice": wall * 1e3 / slices,
                    "restore_s": metrics["seconds"]["restore"],
                    "ms_per_slice_after_restore":
                        metrics["seconds"]["test"] * 1e3 / slices,
                    "launches": launches}
            if mode == "reports":
                line["patients"] = metrics["patient_report"]["summary"]
                line["roc_auc"] = metrics["threshold_sweep"]["roc_auc"]
            print(json.dumps({"cli_test": line}), flush=True)
            check(math.isfinite(dice), f"cli/test {model} {mode}: dice "
                                       f"{dice}")
            if mode == "reports":
                check(abs(dice - train_dice) <= CLI_TEST_DICE_TOL,
                      f"cli/test {model}: dice {dice}, cli/train's test "
                      f"pass {train_dice}")
            if model == "stflstm":
                for name in ("lstm_last_x", "lstm_last"):
                    check(launches[name] > 0, f"kernel {name} never "
                                              f"launched in cli/test {mode}")
    return total


# PK maps phase: the tree's 12 volumes (8 training, 2 val, 2 test
# patients) through `python -m stf_unet_tpu_torch.pk.maps` (LM, 50
# iterations); one volume's maps through K4 against the plain sums: within
# PK_MAP_TOL on at least PK_MAP_SHARE of its tissue voxels (two correct LM
# runs may part where a step's two costs nearly tie; the JAX package's
# solver branches on the same `cost_cand < cost_p`).
PK_VOLUMES = TRAIN_PATIENTS + 2 * EVAL_PATIENTS
PK_MAP_TOL, PK_MAP_SHARE = 1e-3, 0.99
# PK training: cli/train with --use-pk-maps, 2 epochs = 8 steps; then
# PK_REQUESTS requests of T + 3 planes to the best checkpoint.
PK_EPOCHS = 2
PK_REQUESTS = 8


def pk_volumes(data: str):
    """(split, patient, frames, tissue voxel count) of every volume the PK
    map generation fits."""
    from stf_unet_tpu_torch.core.config import PKConfig
    from stf_unet_tpu_torch.pk.fit import preprocess_images
    from stf_unet_tpu_torch.pk.maps import _load_patient_frames

    out = []
    for split in ("training", "val", "test"):
        images = os.path.join(data, "seg", split, "images")
        for patient in sorted(os.listdir(images)):
            frames = _load_patient_frames(os.path.join(images, patient))
            mask = preprocess_images(frames, PKConfig())[1]
            out.append((split, patient, frames, int(mask.sum())))
    return out


def pk_maps_phase(data: str):
    """pk.maps.main (LM) over the tree: finite maps for every volume, K4
    launched 2 x lm_iters times per voxel chunk; then, outside the counted
    run, a profiler view of one chunk and one volume through K4 against
    the plain sums. Returns the launch counts of the run."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    from stf_unet_tpu_torch.core.config import PKConfig
    from stf_unet_tpu_torch.pk import maps as pk_maps
    from stf_unet_tpu_torch.pk.aif import make_aif
    from stf_unet_tpu_torch.pk.fit import CHUNK, fit_lm, preprocess_images
    from stf_unet_tpu_torch.pk.tofts import ToftsQuadrature

    cfg = PKConfig()
    volumes = pk_volumes(data)
    check(len(volumes) == PK_VOLUMES, f"{len(volumes)} PK volumes, "
                                      f"expected {PK_VOLUMES}")
    chunks = sum(math.ceil(n / CHUNK) for *_, n in volumes)
    kernels = reset_counts()
    t0 = time.perf_counter()
    pk_maps.main([data, "--solver", "lm", "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    check(launches["tofts_sums"] == chunks * 2 * cfg.lm_iters,
          f"K4 launched {launches['tofts_sums']} times, expected "
          f"{chunks} chunks x 2 x {cfg.lm_iters}")
    for split, patient, _, _ in volumes:
        out = os.path.join(data, "seg", split, "pk_maps", patient)
        for name in pk_maps.PARAM_NAMES:
            check(os.path.isfile(os.path.join(out, f"{name}.png")),
                  f"{split}/{patient}: no {name}.png")
            raw = np.load(os.path.join(out, f"{name}_raw.npy"))
            check(raw.shape == (TRAIN_SRC, TRAIN_SRC)
                  and bool(np.isfinite(raw).all()),
                  f"{split}/{patient}: {name} map {raw.shape}, finite "
                  f"{bool(np.isfinite(raw).all())}")
        check(os.path.isfile(os.path.join(out, "combined_map.png")),
              f"{split}/{patient}: no combined_map.png")

    # one full chunk of the first volume, profiled (not counted)
    _, _, frames, _ = volumes[0]
    imgs, mask = preprocess_images(frames, cfg)
    curves = imgs.numpy().transpose(1, 2, 0)[mask.numpy()]  # [voxels, T]
    chunk = curves[:CHUNK]
    quad = ToftsQuadrature.build(cfg.time_points, make_aif(cfg.aif_method),
                                 cfg.dt, device="cuda")
    fit_lm(chunk, quad, cfg)
    t0 = time.perf_counter()
    fit_lm(chunk, quad, cfg)  # ends in a copy to the host
    chunk_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit_lm(chunk, quad, cfg)
        prof_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(dev_ms(e) for e in kern)
    k4 = sum(dev_ms(e) for e in kern if "tofts_sums_kernel" in e.key)
    top = sorted(kern, key=dev_ms, reverse=True)[:8]

    # the first volume's tissue voxels through K4 and the plain sums
    maps_k = fit_lm(curves, quad, cfg, backend="auto")    # [voxels, 3]
    maps_p = fit_lm(curves, quad, cfg, backend="plain")
    diff = np.abs(maps_k - maps_p).T                      # [3, voxels]
    share = float((diff <= PK_MAP_TOL).all(axis=0).mean())
    print(json.dumps({"pk_maps": {
        "volumes": len(volumes), "tissue_voxels": [n for *_, n in volumes],
        "chunks": chunks, "lm_iters": cfg.lm_iters, "wall_s": wall,
        "s_per_volume": wall / len(volumes), "launches": launches,
        "chunk_voxels": int(chunk.shape[0]), "chunk_ms": chunk_ms,
        "chunk_ms_per_lm_iter": chunk_ms / cfg.lm_iters,
        "profiled_chunk_wall_ms": prof_ms,
        "kernel_busy_ms": busy if busy else "not measured",
        "k4_ms": k4, "k4_share_of_device_time": (k4 / busy) if busy
        else "not measured",
        "device_idle_share_profiled": (1 - busy / prof_ms) if busy
        else "not measured",
        "device_idle_share_chunk": (1 - busy / chunk_ms) if busy
        else "not measured",
        "top_kernels": [{"name": e.key[:90], "calls": e.count,
                         "ms": dev_ms(e)} for e in top],
        "kernel_vs_plain_maps": {
            "tissue_voxels": len(curves), "tol": PK_MAP_TOL,
            "share_within_tol": share,
            "max_abs_diff": [float(d.max()) for d in diff]}}}), flush=True)
    check(bool(np.isfinite(maps_k).all()), "K4-path maps not finite")
    check(share >= PK_MAP_SHARE, f"K4-path maps within {PK_MAP_TOL} of the "
                                 f"plain path's on {share} of tissue voxels "
                                 f"< {PK_MAP_SHARE}")
    return launches


def pk_training_phase(tmpdir: str, data: str):
    """cli/train with --use-pk-maps at full width, bf16: finite losses,
    >= 8 steps over >= 2 epochs, K1, K1b, K2 and K3 launched. Returns
    (launch counts, path of the best checkpoint)."""
    import math

    from stf_unet_tpu_torch.cli import train as train_cli

    kernels = reset_counts()
    weights = os.path.join(tmpdir, "weights_pk")
    t0 = time.perf_counter()
    result = train_cli.run([
        "--data-path", data, "--model", "stflstm", "--amp", "true",
        "--use-subtraction", "--use-pk-maps",
        "--batch-size", str(TRAIN_BATCH), "--epochs", str(PK_EPOCHS),
        "--eval-batch-size", str(TRAIN_BATCH), "--seed", "0",
        "--data-base-size", str(TRAIN_SRC),
        "--data-crop-size", str(TRAIN_CROP),
        "--save-dir", weights, "--output-dir", os.path.join(tmpdir, "out_pk"),
        "--print-freq", "1", "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    losses = [e["train_loss"] for e in result["epochs"]]
    check(len(result["epochs"]) >= 2, f"PK: trained {len(result['epochs'])} "
                                      f"epochs, expected >= 2")
    check(result["steps"] >= 8, f"PK: trained {result['steps']} steps, "
                                f"expected >= 8")
    check(all(math.isfinite(v) for v in losses),
          f"PK: non-finite training loss: {losses}")
    for name in TRAIN_KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched while "
                                  f"training on PK maps")
    check_bn_launches("cli/train --use-pk-maps", launches, "stflstm",
                      result["steps"])
    best = os.path.join(weights, "stflstm_best_model_pk.pth")
    check(os.path.isfile(best), f"no PK best checkpoint at {best}")
    print(json.dumps({"pk_training": {
        "wall_s": wall, "epochs": result["epochs"],
        "steps": result["steps"], "best_dice": result["best_dice"],
        "test_dice": result["test"]["dice"],
        "launches": launches}}), flush=True)
    return launches, best


def pk_serving_phase(weights: str):
    """The PK checkpoint through cli/serve.build_server: PK_REQUESTS
    concurrent requests of T + 3 planes, each answered with a mask of the
    expected shape; K1 and K3 launched. Returns the launch counts."""
    import torch

    from stf_unet_tpu_torch.cli.serve import build_server, parse_args
    from stf_unet_tpu_torch.serve.client import SegmentationClient

    server = build_server(parse_args(
        ["--weights", weights, "--port", "0", "--dtype", "bf16",
         "--max-batch", "8", "--batch-window-ms", "20",
         "--crop-size", str(CROP), "--device", "cuda"]))
    check(server.engine.model.use_pk_maps, "the PK checkpoint did not load "
                                           "as a PK model")
    rng = np.random.default_rng(1)
    planes = [rng.integers(0, 256, (T_STEPS + 3, TRAIN_SRC, TRAIN_SRC),
                           dtype=np.uint8) for _ in range(PK_REQUESTS)]
    server.start()
    try:
        client = SegmentationClient("http://%s:%d" % server.address,
                                    timeout=300)
        kernels = reset_counts()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(PK_REQUESTS) as ex:
            masks = list(ex.map(
                lambda i: client.segment(planes[i], full_size=i % 2 == 1),
                range(PK_REQUESTS)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in kernels.items()}
        metrics = client.metrics()
    finally:
        server.stop()
    for i, mask in enumerate(masks):
        want = (TRAIN_SRC, TRAIN_SRC) if i % 2 == 1 else (CROP, CROP)
        check(mask.shape == want, f"PK request {i}: mask {mask.shape}, "
                                  f"expected {want}")
        check(int(mask.max()) <= 1, f"PK request {i}: class out of range")
    for name in ("lstm_last_x", "lstm_last"):
        check(launches[name] > 0, f"kernel {name} never launched while "
                                  f"serving the PK model")
    print(json.dumps({"pk_serving": {
        "requests": PK_REQUESTS, "planes": T_STEPS + 3, "wall_s": wall,
        "server_latency_ms": metrics["latency_ms"],
        "errors": metrics["errors"], "batches": metrics["batches"],
        "seen_shapes": metrics["seen_shapes"],
        "launches": launches}}), flush=True)
    check(metrics["errors"] == 0, f"PK serving: {metrics['errors']} errors")
    return launches


# The train_extras phase: STF-LSTM-UNet at full width through the
# training leftovers (dataset packs, the augmentation extras, EMA, --grad-
# accum 2), stopped by --stop-after-steps and resumed; EXTRAS_STOP steps
# of 4 per epoch stop inside epoch 1, mid-window.
EXTRAS_FLAGS = ["--data-elastic-alpha", "8", "--data-elastic-prob", "1",
                "--data-brightness", "0.1", "--data-contrast", "0.1",
                "--data-gamma-jitter", "0.1", "--data-noise-std", "0.01",
                "--optim-ema-decay", "0.99", "--grad-accum", "2"]
EXTRAS_EPOCHS, EXTRAS_STOP = 2, 5


class Tee:
    """stdout that is also kept, to read cli/train's log lines."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, text):
        self.out.write(text)
        self.lines.append(text)
        return len(text)

    def flush(self):
        self.out.flush()

    def text(self) -> str:
        return "".join(self.lines)


def logged_run(argv):
    """cli/train.run(argv) with its printed lines kept: (result, text)."""
    import contextlib

    from stf_unet_tpu_torch.cli import train as train_cli

    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        result = train_cli.run(argv)
    return result, tee.text()


def data_seconds(text: str) -> dict:
    """epoch -> the `data:` seconds per iteration of its last Epoch log
    line (the epoch's mean host wait for a batch)."""
    import re

    out = {}
    for m in re.finditer(r"Epoch: \[(\d+)\].*?data: ([0-9.]+)", text):
        out[int(m.group(1))] = float(m.group(2))
    return out


def loader_sources_ms(data: str, pack_root: str) -> dict:
    """Host ms per B=16 training batch of each source of the 64-slice
    tree, one epoch each, no prefetch: PIL decode, native decode ("not
    available" where the decoder does not build), the dataset pack, and
    the RAM cache's second epoch."""
    from stf_unet_tpu_torch.data import native_loader
    from stf_unet_tpu_torch.data.index import DatasetIndex
    from stf_unet_tpu_torch.data.loader import HostLoader
    from stf_unet_tpu_torch.data.pack import open_split_pack

    seq = tuple(f"SUB{i}" for i in range(1, 9))
    index = DatasetIndex(data, "train", seq)
    kw = dict(shuffle=True, seed=0, prefetch=0, verbose=False)
    loaders = {"pil": HostLoader(index, TRAIN_BATCH, use_native=False, **kw),
               "pack": HostLoader(index, TRAIN_BATCH,
                                  pack=open_split_pack(pack_root, "train"),
                                  **kw),
               "ram_cache": HostLoader(index, TRAIN_BATCH, cache_ram=True,
                                       **kw)}
    if native_loader.native_available():
        loaders["native"] = HostLoader(index, TRAIN_BATCH, use_native=True,
                                       **kw)
    for _ in loaders["ram_cache"].epoch(0):  # fills the cache
        pass
    out = {"native": "not available"}
    for name, loader in loaders.items():
        t0 = time.perf_counter()
        n = sum(1 for _ in loader.epoch(1))
        out[name] = (time.perf_counter() - t0) * 1e3 / n
    return out


def train_extras_phase(tmpdir: str, data: str, device: str = "cuda"):
    """The training leftovers at full width, bf16, B=16, crop 224, on the
    synthetic tree: cli.pack packs train / val / test; cli/train with the
    packs, the augmentation extras, EMA and --grad-accum 2 stops after
    EXTRAS_STOP steps and --resume latest finishes it (the resume point,
    finite losses, and the EMA weights are what cli/test's restore gives);
    a second run with --data-cache-ram and the per-frame mode, 2 epochs
    (its decoder and data seconds beside the first run's); the host ms
    per batch of each loader source; pick_batch_size on the full-width
    config and one real step at its pick, peak memory against the budget.
    Returns the launch counts of the phase."""
    import math

    import numpy as np
    import torch

    from stf_unet_tpu_torch.cli import pack as pack_cli
    from stf_unet_tpu_torch.cli.common import restore_for_inference
    from stf_unet_tpu_torch.core.config import parse_config
    from stf_unet_tpu_torch.data.loader import Batch
    from stf_unet_tpu_torch.data.transforms import TrainAugment
    from stf_unet_tpu_torch.models.registry import create_model
    from stf_unet_tpu_torch.train import autobatch
    from stf_unet_tpu_torch.train.loop import train_step
    from stf_unet_tpu_torch.train.state import TrainState, make_optimizer

    kernels = reset_counts()
    t_phase = time.perf_counter()
    pack_root = os.path.join(tmpdir, "pack")
    t0 = time.perf_counter()
    pack_cli.main(["--data-path", data, "--output", pack_root,
                   "--use-subtraction"])
    pack_s = time.perf_counter() - t0
    weights = os.path.join(tmpdir, "weights_extras")
    base = ["--data-path", data, "--model", "stflstm", "--amp", "true",
            "--use-subtraction", "--batch-size", str(TRAIN_BATCH),
            "--epochs", str(EXTRAS_EPOCHS), "--eval-batch-size",
            str(TRAIN_BATCH), "--seed", "0", "--data-base-size",
            str(TRAIN_SRC), "--data-crop-size", str(TRAIN_CROP),
            "--output-dir", os.path.join(tmpdir, "out_extras"),
            "--print-freq", "1", "--device", device]
    first = base + ["--save-dir", weights, "--data-pack", pack_root,
                    *EXTRAS_FLAGS]
    t0 = time.perf_counter()
    stopped, log1 = logged_run(first + ["--stop-after-steps",
                                        str(EXTRAS_STOP)])
    cut = torch.load(os.path.join(weights, "stflstm_latest_model.pth"),
                     map_location="cpu", weights_only=True)
    steps_per_epoch = TRAIN_PATIENTS * TRAIN_SLICES // TRAIN_BATCH
    want = divmod(EXTRAS_STOP, steps_per_epoch)
    check(stopped.get("preempted") is True, "--stop-after-steps did not stop")
    check((cut["epoch"], cut.get("step_in_epoch")) == want,
          f"stopped at (epoch, step_in_epoch) = ({cut['epoch']}, "
          f"{cut.get('step_in_epoch')}), expected {want}")
    check("accum_grads" in cut and "ema" in cut,
          "the mid-window save lacks its accumulated gradients or EMA")
    resumed, log2 = logged_run(first + ["--resume", "latest"])
    run1_s = time.perf_counter() - t0
    losses = ([e["train_loss"] for e in stopped["epochs"]]
              + [e["train_loss"] for e in resumed["epochs"]])
    check(resumed["epochs"][0]["epoch"] == want[0]
          and f"at epoch {want[0]} step {want[1]}" in log2,
          f"resume did not re-enter epoch {want[0]} at step {want[1]}")
    check(resumed["steps"] == EXTRAS_EPOCHS * steps_per_epoch,
          f"resumed run ended at micro-step {resumed['steps']}")
    check(all(math.isfinite(v) for v in losses),
          f"non-finite training loss: {losses}")
    best = os.path.join(weights, "stflstm_best_model.pth")
    ckpt = torch.load(best, map_location="cpu", weights_only=True)
    model, _, _, _ = restore_for_inference("stflstm", best, dtype="f32",
                                           use_subtraction=True,
                                           device=device)
    restored = {n: p.detach().cpu() for n, p in model.named_parameters()}
    check(set(restored) == set(ckpt["ema"]) and all(
        torch.equal(restored[n], ckpt["ema"][n]) for n in restored),
        "cli/test's restore did not give the checkpoint's EMA weights")
    check(not all(torch.equal(ckpt["ema"][n], ckpt["model"][n])
                  for n in restored), "the EMA weights equal the live ones")
    del model

    t0 = time.perf_counter()
    second, log3 = logged_run(base + [
        "--save-dir", os.path.join(tmpdir, "weights_extras2"),
        "--data-cache-ram", "--data-shared-frame-augmentation", "false"])
    run2_s = time.perf_counter() - t0
    decoder = [ln for ln in log3.splitlines()
               if ln.startswith("host decoder:")]
    check(len(second["epochs"]) == EXTRAS_EPOCHS and all(
        math.isfinite(e["train_loss"]) for e in second["epochs"]),
        f"cache / per-frame run: {second['epochs']}")
    sources = loader_sources_ms(data, pack_root)

    # autobatch on the full-width config, then one real step at its pick
    cfg = parse_config(base + ["--batch-size", "auto"])
    canvas = (TRAIN_SRC, TRAIN_SRC)
    budget = autobatch.device_budget_bytes()
    step_b0, state_bytes = autobatch.measure_step_memory(cfg, T_STEPS, 2,
                                                         canvas)
    step_b1, _ = autobatch.measure_step_memory(cfg, T_STEPS, 4, canvas)
    pick = autobatch.pick_batch_size(cfg, T_STEPS, budget_bytes=budget,
                                     canvas=canvas)
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)  # the run's, before the step's
    torch.manual_seed(0)
    model = create_model(cfg.model, dtype=torch.bfloat16).to(dev)
    state = TrainState(model, make_optimizer(cfg.optim, model, dev))
    rng = np.random.default_rng(0)
    host = Batch(frames=rng.integers(0, 256, (pick, T_STEPS) + canvas,
                                     dtype=np.uint8),
                 masks=rng.integers(0, 2, (pick,) + canvas, dtype=np.uint8),
                 sizes=np.full((pick, 2), TRAIN_SRC, np.int32))
    t0 = time.perf_counter()
    loss, _ = train_step(state, TrainAugment(cfg.data), host,
                         torch.Generator().manual_seed(0),
                         lambda s: cfg.optim.lr, 2, dev)
    loss = loss.item()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - held
    check(math.isfinite(loss), f"autobatch step at {pick}: loss {loss}")
    check(peak <= budget, f"autobatch step at {pick}: peak {peak} B over "
                          f"the budget {budget} B")
    del state, model, host
    torch.cuda.empty_cache()

    launches = {name: fn.launches for name, fn in kernels.items()}
    for name in TRAIN_KERNELS + BN_KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched in "
                                  f"train_extras")
    per_sample = (step_b1 - step_b0) / 2
    print(json.dumps({"train_extras": {
        "phase_wall_s": time.perf_counter() - t_phase, "pack_s": pack_s,
        "run1_wall_s": run1_s, "run2_wall_s": run2_s,
        "resume_point": {"epoch": cut["epoch"],
                         "step_in_epoch": cut["step_in_epoch"]},
        "losses": losses, "best_dice": resumed["best_dice"],
        "test_dice": resumed["test"]["dice"],
        "second_run": {"epochs": second["epochs"],
                       "test_dice": second["test"]["dice"]},
        "decoder": decoder,
        "data_s_per_iter": {"pack_stopped": data_seconds(log1),
                            "pack_resumed": data_seconds(log2),
                            "cache_ram_per_frame": data_seconds(log3)},
        "loader_ms_per_batch": sources,
        "autobatch": {"per_sample_bytes": per_sample,
                      "fixed_bytes": step_b0 - 2 * per_sample + state_bytes,
                      "state_bytes": state_bytes, "budget_bytes": budget,
                      "pick": pick, "step_peak_bytes": peak,
                      "step_s": step_s, "loss": loss},
        "launches": launches}}), flush=True)
    return launches


# The labels-free deployment path (phases 16-19): phase 6's full-width
# best STF-LSTM-UNet checkpoint and the synthetic tree. The enhanced fits
# are ill-conditioned (each frame min-max normalized on its own; ve at
# its floor on many voxels): K4's maps are held to the plain sums' within
# FIT_TOL on FIT_SHARE where they can be, and otherwise to the plain
# path's own spread: at each SPREAD_TOLS, K4 against plain keeps at least
# the share of voxels that the plain path keeps against itself on curves
# with 1e-7 of noise, less SPREAD_SLACK (tests/test_torch_pk_enhanced.py
# holds the port to the JAX package on the same terms).
FIT_TOL, FIT_SHARE = 1e-4, 0.99
SPREAD_TOLS, SPREAD_SLACK = (1e-4, 1e-2, 1e-1), 0.05
# predict's masks against the server's for the same frames (bf16; batches
# of other sizes may flip a near-tie).
PREDICT_SERVE_SHARE = 0.999
SERVE_DIR_REQUESTS = 4


def _launches(kernels) -> dict:
    return {name: fn.launches for name, fn in kernels.items()}


def _share_within(got, want, tol):
    return float((np.abs(got - want) <= tol).all(axis=1).mean())


def _have_matplotlib() -> bool:
    import importlib.util

    return importlib.util.find_spec("matplotlib") is not None


def pk_enhanced_phase(tmpdir: str, data: str):
    """16. pk.maps --enhanced over the tree's volumes (finite maps, tissue
    share, s per volume; K4 launched 2 x lm_iters times per chunk of
    every volume); one volume's enhanced maps through K4 against the
    plain sums; --compare-aif over the test split's patients; --debug
    with LM and with Adam (the Adam loss trace falls). The renders need
    matplotlib: where it does not import, the compare and debug steps run
    their numbers (pk/enhanced.aif_method_maps, pk/debug.debug_fit and
    aif_debug_numbers) and the line says so. Returns the launch counts."""
    import math

    import torch

    from stf_unet_tpu_torch.core.config import PKConfig
    from stf_unet_tpu_torch.pk import debug as pk_debug
    from stf_unet_tpu_torch.pk import enhanced
    from stf_unet_tpu_torch.pk import maps as pk_maps
    from stf_unet_tpu_torch.pk.aif import auto_detect_aif, make_aif
    from stf_unet_tpu_torch.pk.fit import CHUNK, fit_lm
    from stf_unet_tpu_torch.pk.tofts import ToftsQuadrature

    t_phase = time.perf_counter()
    cfg = PKConfig()
    volumes = pk_volumes(data)
    masks = [enhanced.tissue_mask_u8(frames.astype(np.float32) / 255.0)[1]
             > 0 for _, _, frames, _ in volumes]
    chunks = sum(math.ceil(int(m.sum()) / CHUNK) for m in masks)
    kernels = reset_counts()
    t0 = time.perf_counter()
    pk_maps.main([data, "--solver", "lm", "--enhanced", "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches(kernels)
    check(launches["tofts_sums"] == chunks * 2 * cfg.lm_iters,
          f"enhanced: K4 launched {launches['tofts_sums']} times, expected "
          f"{chunks} chunks x 2 x {cfg.lm_iters}")
    for (split, patient, _, _), mask in zip(volumes, masks):
        out = os.path.join(data, "seg", split, "pk_maps", patient)
        for name in pk_maps.PARAM_NAMES:
            raw = np.load(os.path.join(out, f"{name}_raw.npy"))
            check(raw.shape == mask.shape and bool(np.isfinite(raw).all()),
                  f"enhanced {split}/{patient}: {name} map {raw.shape}")
            check(not raw[~mask].any(), f"enhanced {split}/{patient}: "
                                        f"{name} outside the tissue")

    # one volume through K4 and through the plain sums (not counted)
    _, _, frames, _ = volumes[0]
    imgs, tissue = enhanced.enhanced_preprocess(frames)
    curves = imgs.transpose(1, 2, 0)[tissue]
    quad = ToftsQuadrature.build(cfg.time_points, make_aif(cfg.aif_method),
                                 cfg.dt, device="cuda")
    kern = fit_lm(curves, quad, cfg, backend="auto")
    plain = fit_lm(curves, quad, cfg, backend="plain")
    noise = np.random.default_rng(0).normal(0, 1e-7, curves.shape)
    noisy = fit_lm((curves + noise * (curves > 0)).astype(np.float32), quad,
                   cfg, backend="plain")
    shares = {tol: {"k4_vs_plain": _share_within(kern, plain, tol),
                    "plain_noisy_vs_plain": _share_within(noisy, plain,
                                                          tol)}
              for tol in SPREAD_TOLS}
    held_exact = shares[FIT_TOL]["k4_vs_plain"] >= FIT_SHARE
    check(bool(np.isfinite(kern).all()), "enhanced K4 maps not finite")
    if not held_exact:
        for tol, s in shares.items():
            check(s["k4_vs_plain"] >= s["plain_noisy_vs_plain"]
                  - SPREAD_SLACK, f"enhanced K4 maps against plain at "
                                  f"{tol}: {s}")

    drawn = _have_matplotlib()
    test_dir = os.path.join(data, "seg", "test", "images")
    test_patients = sorted(os.listdir(test_dir))
    t0 = time.perf_counter()
    if drawn:
        pk_maps.main([data, "--splits", "test", "--compare-aif",
                      "--device", "cuda"])
        out = os.path.join(data, "seg", "test", "pk_aif_comparison")
        compare = {p: sorted(os.listdir(os.path.join(out, p)))
                   for p in test_patients}
    else:
        compare = {}
        for patient in test_patients:
            got = enhanced.aif_method_maps(
                pk_maps._load_patient_frames(os.path.join(test_dir,
                                                          patient)),
                cfg, os.path.join(tmpdir, "aif_compare", patient),
                device="cuda")
            compare[patient] = {m: float(np.median(v[0][v[0] > 0]))
                                if (v[0] > 0).any() else 0.0
                                for m, v in got.items()}
    compare_s = time.perf_counter() - t0

    debug = {}
    for solver in ("lm", "adam"):
        t0 = time.perf_counter()
        if drawn:
            pk_maps.main([data, "--splits", "test", "--solver", solver,
                          "--aif-method", "auto", "--debug", "--device",
                          "cuda"])
        _, losses = pk_debug.debug_fit(curves, quad,
                                       PKConfig(solver=solver))
        nums = pk_debug.aif_debug_numbers(
            imgs, tissue, auto_detect_aif(imgs, tissue,
                                          np.asarray(cfg.time_points))[1])
        debug[solver] = {"s": time.perf_counter() - t0,
                         "aif_position": nums["position"]}
        if losses is not None:
            debug[solver].update(loss_first=float(losses[0]),
                                 loss_last=float(losses[-1]))
            check(bool(losses[-1] < losses[0]),
                  f"--debug adam: the loss did not fall {losses[[0, -1]]}")
    print(json.dumps({"pk_enhanced": {
        "volumes": len(volumes), "wall_s": wall,
        "s_per_volume": wall / len(volumes),
        "tissue_share": [float(m.mean()) for m in masks],
        "chunks": chunks, "launches": launches,
        "k4_vs_plain": {"tissue_voxels": len(curves),
                        "held_within_fit_tol": held_exact,
                        "shares": {str(k): v for k, v in shares.items()},
                        "max_abs_diff": float(np.abs(kern - plain).max())},
        "matplotlib": drawn, "compare_aif": compare,
        "compare_aif_s": compare_s, "debug": debug,
        "phase_wall_s": time.perf_counter() - t_phase}}), flush=True)
    return launches


def predict_phase(tmpdir: str, data: str, weights: str):
    """17. cli.predict.main (bf16) with the phase-6 checkpoint at 256^2
    native: a labels-free copy of the test images and the same slices as
    .npz, with --pk-fit --pk-enhanced --save-probs --full-size; then
    --tta, then --tiled. K1f, K3 (and, with --pk-fit, K4) launched in
    each run; the masks against cli/serve's answers for the same frames;
    ms per slice with the split between forward and fit; a profiler view
    of one --pk-fit slice (the card's idle share). Returns the launch
    counts, summed."""
    import shutil

    import torch
    from PIL import Image
    from torch.profiler import ProfilerActivity, profile

    from stf_unet_tpu_torch.cli import predict
    from stf_unet_tpu_torch.cli.serve import build_server, parse_args
    from stf_unet_tpu_torch.data.loader import decode_stack

    t_phase = time.perf_counter()
    seqs = [f"SUB{i}" for i in range(1, T_STEPS + 1)]
    unlabeled = os.path.join(tmpdir, "unlabeled")
    shutil.copytree(os.path.join(data, "seg", "test", "images"), unlabeled)
    npz_dir = os.path.join(tmpdir, "unlabeled_npz")
    os.makedirs(npz_dir)
    stacks = {}
    for patient in sorted(os.listdir(unlabeled)):
        for name in sorted(os.listdir(os.path.join(unlabeled, patient,
                                                   seqs[0]))):
            stem = os.path.splitext(name)[0]
            frames = decode_stack([os.path.join(unlabeled, patient, s, name)
                                   for s in seqs])
            stacks[(patient, stem)] = frames
            np.savez(os.path.join(npz_dir, f"{patient}_{stem}.npz"),
                     frames=frames)
    base = ["--model", "stflstm", "--model-dir", weights,
            "--use-subtraction", "--dtype", "bf16", "--device", "cuda"]
    runs = {"pk_fit": ["--pk-fit", "--pk-enhanced", "--save-probs",
                       "--full-size"],
            "tta": ["--tta", "--full-size"], "tiled": ["--tiled"]}
    total = {name: 0 for name in counters()}
    lines, outs = {}, {}
    for mode, flags in runs.items():
        for kind, path in (("images", unlabeled), ("npz", npz_dir)):
            if mode != "pk_fit" and kind == "npz":
                continue
            out = os.path.join(tmpdir, f"predict_{mode}_{kind}")
            kernels = reset_counts()
            result = predict.main(base + ["--input", path, "--output-dir",
                                          out, *flags])
            launches = _launches(kernels)
            for name, n in launches.items():
                total[name] += n
            want = ["lstm_last_x", "lstm_last"] + (
                ["tofts_sums"] if mode == "pk_fit" else [])
            for name in want:
                check(launches[name] > 0, f"kernel {name} never launched "
                                          f"in predict {mode} {kind}")
            n = result["slices"]
            check(n == len(stacks), f"predict {mode}: {n} slices, expected "
                                    f"{len(stacks)}")
            sec = result["seconds"]
            lines[f"{mode}_{kind}"] = {
                "slices": n,
                "ms_per_slice": sec["total"] * 1e3 / n,
                "ms_per_slice_after_restore":
                    (sec["total"] - sec["restore"]) * 1e3 / n,
                "forward_ms_per_slice": sec["forward"] * 1e3 / n,
                "pk_fit_ms_per_slice": sec["pk_fit"] * 1e3 / n,
                "restore_s": sec["restore"], "launches": launches}
            outs[(mode, kind)] = out

    # the masks against the server's answers for the same frames
    server = build_server(parse_args(
        ["--model", "stflstm", "--model-dir", weights, "--use-subtraction",
         "--port", "0", "--dtype", "bf16", "--max-batch", "8",
         "--device", "cuda"]))
    agree = []
    for (patient, stem), frames in stacks.items():
        served = server.segment(frames, full_size=True)
        for kind, name in (("images", os.path.join(patient, stem)),
                           ("npz", os.path.join(f"{patient}_{stem}",
                                                f"{patient}_{stem}"))):
            mask = np.asarray(Image.open(os.path.join(
                outs[("pk_fit", kind)], f"{name}_mask.png"))) // 255
            check(mask.shape == served.shape, f"predict mask {mask.shape}, "
                                              f"served {served.shape}")
            agree.append(float((mask == served).mean()))
            pk = np.load(os.path.join(outs[("pk_fit", kind)],
                                      f"{name}_pk.npz"))
            check(all(np.isfinite(pk[k]).all() for k in ("ktrans", "ve",
                                                         "vp")),
                  f"predict {kind} {name}: non-finite PK maps")
    server.batcher.close()
    server.httpd.server_close()
    check(min(agree) >= PREDICT_SERVE_SHARE, f"predict masks against the "
                                             f"server's: {min(agree)}")

    # one --pk-fit slice under the profiler
    one = os.path.join(npz_dir, sorted(os.listdir(npz_dir))[0])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        result = predict.main(base + ["--input", one, "--output-dir",
                                      os.path.join(tmpdir, "predict_one"),
                                      *runs["pk_fit"]])
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(dev_ms(e) for e in kern)
    sec = result["seconds"]
    work_ms = (sec["forward"] + sec["pk_fit"]) * 1e3
    print(json.dumps({"predict": {
        **lines, "masks_equal_to_served_min_share": min(agree),
        "masks_equal_to_served_mean_share": float(np.mean(agree)),
        "one_pk_fit_slice": {
            "forward_ms": sec["forward"] * 1e3,
            "pk_fit_ms": sec["pk_fit"] * 1e3,
            "total_ms": sec["total"] * 1e3,
            "kernel_busy_ms": busy if busy else "not measured",
            "device_idle_share_forward_and_fit": (1 - busy / work_ms)
            if busy else "not measured",
            "top_kernels": [{"name": e.key[:90], "calls": e.count,
                             "ms": dev_ms(e)} for e in
                            sorted(kern, key=dev_ms, reverse=True)[:6]]},
        "phase_wall_s": time.perf_counter() - t_phase}}), flush=True)
    return total


def pipeline_phase(tmpdir: str, data: str, weights: str):
    """18. cli.pipeline.main --enhanced (bf16) over the test split from
    the phase-15 pack: a render per sample, the mean seconds of forward
    + fit per sample; K1f, K3 and K4 launched. Returns the launch
    counts."""
    from stf_unet_tpu_torch.cli import pipeline

    out = os.path.join(tmpdir, "pipeline")
    kernels = reset_counts()
    t0 = time.perf_counter()
    result = pipeline.main([
        "--root", data, "--model", "stflstm", "--model-dir", weights,
        "--use-subtraction", "--enhanced", "--data-pack",
        os.path.join(tmpdir, "pack"), "--output-dir", out, "--dtype",
        "bf16", "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = _launches(kernels)
    for name in ("lstm_last_x", "lstm_last", "tofts_sums"):
        check(launches[name] > 0, f"kernel {name} never launched in "
                                  f"cli.pipeline")
    n = result["samples"]
    check(n == EVAL_PATIENTS * TRAIN_SLICES and len(os.listdir(out)) == n,
          f"pipeline: {n} samples, {len(os.listdir(out))} renders")
    print(json.dumps({"pipeline": {
        "samples": n, "wall_s": wall,
        "avg_fused_s_per_sample": result["avg_seconds"],
        "seconds": result["seconds"], "launches": launches}}), flush=True)
    return launches


def serve_dir_phase(weights: str, newer: str, pk_best: str):
    """19. cli/serve.build_server with --model-dir --tta --tiled
    --warmup-geometries 256x256 (bf16): requests at 224^2 (the batched
    path) and 256^2 (the tiles), ms per request; then POST /v1/reload
    after `newer` (another run's checkpoint of the same model) replaces
    the best: the next answer is the new weights'; a checkpoint of
    another architecture (the PK model's) is refused with 409 and the
    served weights stay. K1f and K3 launched. Returns the launch
    counts."""
    import shutil

    import torch

    from stf_unet_tpu_torch.cli.common import load_reference_checkpoint
    from stf_unet_tpu_torch.cli.serve import build_server, parse_args
    from stf_unet_tpu_torch.serve.client import (SegmentationClient,
                                                 ServerError)

    t_phase = time.perf_counter()
    best = os.path.join(weights, "stflstm_best_model.pth")
    kept = best + ".kept"
    shutil.copy(best, kept)
    server = build_server(parse_args(
        ["--model", "stflstm", "--model-dir", weights, "--use-subtraction",
         "--tta", "--tiled", "--warmup-geometries", "256x256", "--port",
         "0", "--dtype", "bf16", "--max-batch", "8", "--device", "cuda"]))
    build_s = time.perf_counter() - t_phase
    rng = np.random.default_rng(3)
    frames = {size: [rng.integers(0, 256, (T_STEPS, size, size),
                                  dtype=np.uint8)
                     for _ in range(SERVE_DIR_REQUESTS)]
              for size in (CROP, TRAIN_SRC)}
    server.start()
    try:
        client = SegmentationClient("http://%s:%d" % server.address,
                                    timeout=300)
        kernels = reset_counts()
        ms = {}
        for size, stack in frames.items():
            t0 = time.perf_counter()
            masks = [client.segment(f) for f in stack]
            ms[size] = (time.perf_counter() - t0) * 1e3 / len(stack)
            for m in masks:
                check(m.shape == (size, size), f"serve_dir {size}: mask "
                                               f"{m.shape}")
        torch.cuda.synchronize()
        launches = _launches(kernels)
        probe = frames[TRAIN_SRC][0]
        before = client.segment(probe)
        shutil.copy(newer, best)
        info = client.reload()
        after = client.segment(probe)
        new = load_reference_checkpoint(newer)[0]
        swapped = all(torch.equal(v.cpu(), new[k]) for k, v in
                      server.weights.state_dict().items())
        direct = server.engine.predict(probe[None, ..., None])[0]
        check(swapped, "reload did not load the new checkpoint")
        check(bool(np.array_equal(after, direct)),
              "the answer after reload is not the new weights' mask")
        shutil.copy(pk_best, best)
        try:
            client.reload()
            refused = None
        except ServerError as e:
            refused = e.code
        check(refused == 409, f"reload of another architecture: {refused}")
        check(bool(np.array_equal(client.segment(probe), after)),
              "the served weights moved after a refused reload")
        metrics = client.metrics()
    finally:
        server.stop()
        shutil.move(kept, best)
    for name in ("lstm_last_x", "lstm_last"):
        check(launches[name] > 0, f"kernel {name} never launched in "
                                  f"serve_dir")
    print(json.dumps({"serve_dir": {
        "build_and_warmup_s": build_s,
        "ms_per_request_tta": ms[CROP],
        "ms_per_request_tta_tiled_256": ms[TRAIN_SRC],
        "reload": {"info": info, "mask_changed":
                   bool(not np.array_equal(before, after)),
                   "refused_other_architecture": refused},
        "errors": metrics["errors"], "launches": launches,
        "phase_wall_s": time.perf_counter() - t_phase}}), flush=True)
    return launches


# K5, the int8 convolution's operand pass, and K6, its dequant epilogue
# (ops/kernels/quant.py), at every conv call of one bf16 B=8, crop-224
# forward of each full-width model: STF-LSTM-UNet, its PK-maps variant (the
# 4-channel stem, pk_fusion) and the UNet (base_c 64). K5 bit-equal to its
# plain twin with the call's input NCHW-contiguous and channels-last (the
# layout the int8 path hands it), and the int32 accumulators of the same
# patches (torch._int_mm against random int8 weights) equal to an f64
# F.conv2d of the same integers on the first sample, rounded (exact: |acc|
# < 2^53). K6 bit-equal to its plain twin on those accumulators of the
# whole batch, with random sw and bias, in bf16 and f32, with and without
# bias; timed in bf16 with the call's own bias or none.
QUANT_BATCH = 8
QUANT_MODELS = ("stflstm", "stflstm_pk", "unet")


def conv_calls(device):
    """{model: [(x, (kernel, stride, padding, out channels, bias), calls)]}:
    the input of each distinct conv call (input shape and geometry) of one
    bf16 B=8 forward of each full-width model (seeded weights), with the
    number of calls that share it."""
    import torch

    from stf_unet_tpu_torch.core.config import ModelConfig
    from stf_unet_tpu_torch.models.registry import (create_model,
                                                     preprocess_input)
    from stf_unet_tpu_torch.ops import quant

    out = {}
    for label in QUANT_MODELS:
        cfg = ModelConfig(model=label.split("_")[0], time_steps=T_STEPS,
                          use_pk_maps=label.endswith("_pk"))
        torch.manual_seed(0)
        model = create_model(cfg, dtype=torch.bfloat16).eval().to(device)
        planes = T_STEPS + (cfg.pk_channels if cfg.use_pk_maps else 0)
        gen = torch.Generator(device=device).manual_seed(1)
        x = torch.randn((QUANT_BATCH, planes, CROP, CROP, 1), generator=gen,
                        device=device)
        seen = {}

        def record(mod, args):
            geom = (tuple(mod.kernel_size), tuple(mod.stride),
                    tuple(mod.padding), mod.out_channels,
                    mod.bias is not None)
            key = (tuple(args[0].shape), geom)
            if key in seen:
                seen[key][2] += 1
            else:
                seen[key] = [args[0].clone(), geom, 1]

        handles = [m.register_forward_pre_hook(record)
                   for m in quant.conv_modules(model).values()]
        with torch.inference_mode():
            model(preprocess_input(x, model))
        for h in handles:
            h.remove()
        out[label] = [tuple(v) for v in seen.values()]
        del model
    torch.cuda.empty_cache()
    return out


def library_patches(x, scale, kernel, stride, padding, kp):
    """The nearest library route to K5: quantize, F.unfold on the
    quantized bf16 tensor (integers up to 127, exact in bf16), the
    columns to K5's (dy, dx, c) order, .to(torch.int8) and the K pad."""
    import torch
    import torch.nn.functional as F

    from stf_unet_tpu_torch.ops.kernels.quant import quantize_activation

    n, c = x.shape[:2]
    cols = F.unfold(quantize_activation(x, scale).to(torch.bfloat16),
                    kernel, padding=padding, stride=stride)
    mat = cols.reshape(n, c, kernel[0] * kernel[1], -1).permute(
        0, 3, 2, 1).reshape(-1, cols.shape[1]).to(torch.int8)
    return F.pad(mat, (0, kp - mat.shape[1]))


def _bits_equal(a, b) -> bool:
    import torch

    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def epilogue_check(acc, m, cout, scale, gen, device):
    """K6 on the GEMM's real accumulators `acc` against its plain twin, in
    bf16 and f32, with and without bias (random sw in [1e-4, 1e-2], bias
    N(0, 1)); returns (max abs err, bit-equal in all four, sw, bias)."""
    import torch

    from stf_unet_tpu_torch.ops.kernels.quant import (dequant_epilogue,
                                                      dequant_epilogue_plain)

    sw = torch.rand((cout,), generator=gen, device=device) * 9.9e-3 + 1e-4
    bias = torch.randn((cout,), generator=gen, device=device)
    err, equal = 0.0, True
    for dtype in (torch.bfloat16, torch.float32):
        for b in (bias, None):
            args = (acc, m, sw, scale, b, dtype)
            got = dequant_epilogue(*args)
            want = dequant_epilogue_plain(*args)
            equal &= _bits_equal(got, want)
            err = max(err, (got.float() - want.float()).abs().max().item())
    return err, equal, sw, bias


def quant_phase(device, quick: bool):
    """K5 against its plain twin in both layouts, the GEMM's accumulators
    against f64, and K6 against its plain twin on the GEMM's accumulators,
    at every conv call of the three models (conv_calls); with timings of
    each kernel and its plain twin (and K5's library route) by CUDA events
    and the byte bounds per distinct call, summed over each model's
    forward. Returns the kernels-line entries of K5 and K6 (one
    STF-LSTM-UNet B=8 forward's sums)."""
    import torch
    import torch.nn.functional as F

    from stf_unet_tpu_torch.ops import quant
    from stf_unet_tpu_torch.ops.kernels.quant import (conv_out_size,
                                                      dequant_epilogue,
                                                      dequant_epilogue_plain,
                                                      padded,
                                                      quantize_activation,
                                                      quantize_patches,
                                                      quantize_patches_plain)

    gen = torch.Generator(device=device).manual_seed(2)
    forwards = {"quant_patches": {}, "quant_epilogue": {}}
    for label, calls in conv_calls(device).items():
        k5 = forwards["quant_patches"].setdefault(label, {
            "convs": 0, "distinct": len(calls), "ms": 0.0, "ms_nchw": 0.0,
            "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0})
        k6 = forwards["quant_epilogue"].setdefault(label, {
            "convs": 0, "distinct": len(calls), "ms": 0.0, "plain_ms": 0.0,
            "bound_ms": 0.0})
        for x, (kernel, stride, padding, cout, has_bias), count in calls:
            n, c, h, w = x.shape
            ho, wo = conv_out_size(h, w, kernel, stride, padding)
            kp = padded(c * kernel[0] * kernel[1])
            m = n * ho * wo
            layouts = {"nchw": x.contiguous(),
                       "channels_last": x.contiguous(
                           memory_format=torch.channels_last)}
            with torch.inference_mode():
                scale = quant.activation_scale(x.abs().amax())
                geom = (scale, kernel, stride, padding, kp)
                want = quantize_patches_plain(layouts["nchw"], *geom)
                errs = {}
                for name, xl in layouts.items():
                    got = quantize_patches(xl, *geom)
                    torch.cuda.synchronize()
                    errs[name] = (got.int() - want.int()).abs().max().item()
                # `got` is the channels-last patches, the int8 path's
                wq = torch.randint(-127, 128, (cout, c, *kernel),
                                   generator=gen, device=device,
                                   dtype=torch.int8)
                wq_mat = quant.pack_weights(wq).t()
                # the accumulators on the first sample (its T frames in
                # the STF models' folded batch)
                first = x[:T_STEPS if label.startswith("stflstm") else 1]
                acc1 = torch._int_mm(quantize_patches(
                    first.contiguous(memory_format=torch.channels_last),
                    *geom), wq_mat)[:, :cout]
                ref = F.conv2d(quantize_activation(first, scale).double(),
                               wq.double(), stride=stride, padding=padding)
                acc_equal = torch.equal(
                    acc1.double(), ref.permute(0, 2, 3, 1).reshape(
                        -1, cout).round())
                acc = torch._int_mm(got, wq_mat)
                e_err, e_equal, sw, bias = epilogue_check(
                    acc, m, cout, scale, gen, device)
                torch.cuda.synchronize()
            line = {"kernel": "quant_patches", "model": label,
                    "x": list(x.shape), "dtype": "bf16", "kernel_size":
                    list(kernel), "stride": list(stride), "padding":
                    list(padding), "calls": count, "M": m, "Kp": kp,
                    "max_abs_err": max(errs.values()),
                    "max_abs_err_by_layout": errs,
                    "acc_equal_f64": acc_equal}
            epi = {"kernel": "quant_epilogue", "model": label,
                   "acc": list(acc.shape), "M": m, "O": cout,
                   "bias": has_bias, "calls": count, "max_abs_err": e_err,
                   "bit_equal": e_equal}
            check(line["max_abs_err"] == 0,
                  f"quant_patches {label} {line['x']} {kernel} s{stride}: "
                  f"differs from the plain twin by {errs}")
            check(acc_equal, f"int8 GEMM {label} {line['x']} {kernel}: "
                             f"accumulators differ from the f64 conv")
            check(e_equal, f"quant_epilogue {label} {epi['acc']}: differs "
                           f"from the plain twin by {e_err}")
            k5["convs"] += count
            k6["convs"] += count
            if not quick:
                nbytes = x.numel() * x.element_size() + m * kp
                bms, by = bound_ms(nbytes, 0.0, "bf16")
                x_cl = layouts["channels_last"]
                b = bias if has_bias else None
                ebytes = m * cout * (4 + 2) + cout * 4 * (1 + has_bias)
                ebms, eby = bound_ms(ebytes, 0.0, "bf16")
                eargs = (acc, m, sw, scale, b, torch.bfloat16)
                with torch.inference_mode():
                    line.update(
                        kernel_ms=cuda_ms(lambda: quantize_patches(
                            x_cl, *geom), iters=10),
                        kernel_ms_nchw=cuda_ms(lambda: quantize_patches(
                            layouts["nchw"], *geom), iters=10),
                        plain_ms=cuda_ms(
                            lambda: quantize_patches_plain(x_cl, *geom),
                            iters=3),
                        library_ms=cuda_ms(
                            lambda: library_patches(x_cl, *geom), iters=3),
                        bound_us=bms * 1e3, bound_by=by)
                    epi.update(
                        kernel_ms=cuda_ms(lambda: dequant_epilogue(*eargs),
                                          iters=10),
                        plain_ms=cuda_ms(
                            lambda: dequant_epilogue_plain(*eargs), iters=3),
                        bound_us=ebms * 1e3, bound_by=eby)
                for key in ("plain_ms", "library_ms"):
                    k5[key] += count * line[key]
                k5["ms"] += count * line["kernel_ms"]
                k5["ms_nchw"] += count * line["kernel_ms_nchw"]
                k5["bound_ms"] += count * bms
                k6["ms"] += count * epi["kernel_ms"]
                k6["plain_ms"] += count * epi["plain_ms"]
                k6["bound_ms"] += count * ebms
            print(json.dumps(line), flush=True)
            print(json.dumps(epi), flush=True)
            del got, want, acc, acc1, layouts
        torch.cuda.empty_cache()
    print(json.dumps({"quant_per_forward": {
        "batch": QUANT_BATCH, "crop": CROP, "forwards": forwards}}),
        flush=True)
    entries = {}
    for name, per in forwards.items():
        stf = per["stflstm"]
        entries[name] = {
            "max_abs_err": 0, "ms": stf["ms"] if not quick else None,
            "plain_ms": stf["plain_ms"], "bound_ms": stf["bound_ms"],
            "bound_by": "bytes", "library_ms": stf.get("library_ms"),
            "shapes": [{"model": label, "B": QUANT_BATCH, "crop": CROP,
                        "convs": f["convs"], "distinct": f["distinct"]}
                       for label, f in per.items()],
            "per_forward": per}
    return entries


# Phase 20, int8: cli.quantize on phase 6's and phase 9's best checkpoints;
# bf16 and int8 forwards of both at INT8_BATCHES with the int8 forward's
# device split; a server with --dtype int8 --tta --tiled answering
# INT8_REQUESTS requests at 224^2 and at 256^2 (masks equal to the direct
# quantized forward's; their share equal to a bf16 server's), reloaded
# with a checkpoint that has scales and refused one without.
INT8_CALIB_SAMPLES = 16
INT8_BATCHES = (8, 16)
INT8_REQUESTS = 4
INT8_CONVS = {"stflstm": 48, "unet": 19}


def int8_split(qmodel, x) -> dict:
    """torch.profiler view of 3 int8 forwards qmodel(x), with each
    quantized conv's call in a record_function range "int8_conv" (forward
    pre-hooks / hooks on the convs): per forward, K5's and K6's device ms
    (by kernel name), the int8 GEMM's (aten::_int_mm), the dequant
    epilogue's (K6 and whatever else runs in the conv ranges: the scale's
    two small kernels), the rest of the forward, and the copy kernels that
    aten ops launch inside the conv ranges (count, ms per forward and the
    ops; none expected); and per conv call of the last forward, in order,
    its input shape and K5's and K6's device us."""
    import torch
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    names = set(qmodel.paths)
    convs = [m for name, m in qmodel.model.named_modules() if name in names]
    stack, shapes = [], []

    def enter(_mod, args):
        shapes.append(list(args[0].shape))
        rf = record_function("int8_conv")
        rf.__enter__()
        stack.append(rf)

    def leave(_mod, _args, _out):
        stack.pop().__exit__(None, None, None)

    handles = ([m.register_forward_pre_hook(enter) for m in convs]
               + [m.register_forward_hook(leave) for m in convs])
    try:
        qmodel(x)
        torch.cuda.synchronize()
        shapes.clear()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                qmodel(x)
            torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    cpu, cuda = (torch.autograd.DeviceType.CPU,
                 torch.autograd.DeviceType.CUDA)
    # the device-side copy of each range (a GPU annotation) is no kernel
    kernels = [e for e in prof.key_averages()
               if e.device_type == cuda and e.key != "int8_conv"]
    busy = sum(dev_ms(e) for e in kernels) / 3
    # the port's kernels launch through ctypes, under no operator: count
    # them by name whether or not the profiler put them inside a range
    ours = ("quant_patches", "quant_epilogue")
    k5, k6 = (sum(dev_ms(e) for e in kernels if name in e.key) / 3
              for name in ours)

    def under(evt, op=None):
        """(kernel name, us, innermost aten op or None) of the kernels in
        evt's subtree."""
        out = [(k.name, k.duration, op) for k in getattr(evt, "kernels", [])]
        for child in evt.cpu_children:
            out += under(child, child.name if child.name.startswith("aten::")
                         else op)
        return out

    events = [e for e in prof.events() if e.device_type == cpu]
    in_ranges = [k for e in events if e.name == "int8_conv"
                 for k in under(e)]
    gemm = sum(d for e in events if e.name == "aten::_int_mm"
               for _, d, _ in under(e)) / 3e3
    others = sum(d for name, d, _ in in_ranges
                 if not any(o in name for o in ours)) / 3e3 - gemm
    # a copy the conv path makes comes from an aten op (copy_, contiguous,
    # to); a copy-named kernel with none above it in the range is one the
    # profiler tied to a bare runtime call there, reported apart
    copies = [(d, op) for name, d, op in in_ranges
              if "copy" in name.lower() and op is not None]
    unattributed = sorted({name[:60] for name, _, op in in_ranges
                           if "copy" in name.lower() and op is None})
    epilogue = k6 + others
    top = sorted(kernels, key=dev_ms, reverse=True)[:8]
    measured = bool(busy and in_ranges)
    launches = sorted((e for e in prof.events() if e.device_type == cuda),
                      key=lambda e: e.time_range.start)
    per = {name: [e.time_range.elapsed_us() for e in launches
                  if name in e.name] for name in ours}
    # the last forward's: the window may miss its first launch
    calls = len(shapes) // 3
    per_conv = ([{"x": shapes[i - calls], **{
        f"{name}_us": per[name][i - calls] for name in ours}}
        for i in range(calls)]
        if all(len(v) >= calls for v in per.values())
        else {"not measured: launches seen": {
            "convs": len(shapes), **{k: len(v) for k, v in per.items()}}})
    return {"kernel_ms": busy or "not measured",
            "quant_patches_ms": k5, "int_mm_ms": gemm,
            "quant_epilogue_ms": k6,
            "epilogue_ms": epilogue if measured else "not measured",
            "rest_ms": (busy - k5 - gemm - epilogue) if measured
            else "not measured",
            "copies_in_conv_ranges": len(copies) / 3 if measured
            else "not measured",
            "copies_in_conv_ranges_ms": sum(d for d, _ in copies) / 3e3,
            "copies_in_conv_ranges_ops": sorted({op for _, op in copies}),
            "copy_kernels_without_an_op_in_conv_ranges": unattributed,
            "per_conv": per_conv,
            "top_kernels": [{"name": e.key[:90], "calls": e.count / 3,
                             "ms": dev_ms(e) / 3} for e in top]}


def int8_path_check(qmodel, x) -> dict:
    """The int8 forward qmodel(x) through K5 and K6 against the same
    forward with ops/quant's two passes swapped for their plain twins (on
    the card): the logits bit-equal and every argmax pixel equal (cuDNN
    deterministic in both, so only the two passes can differ)."""
    import torch

    from stf_unet_tpu_torch.ops import quant
    from stf_unet_tpu_torch.ops.kernels import quant as kq

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        got = qmodel(x)["out"].float()
        quant.quantize_patches = kq.quantize_patches_plain
        quant.dequant_epilogue = kq.dequant_epilogue_plain
        want = qmodel(x)["out"].float()
    finally:
        quant.quantize_patches = kq.quantize_patches
        quant.dequant_epilogue = kq.dequant_epilogue
        torch.backends.cudnn.deterministic = deterministic
    return {"bit_equal": torch.equal(got, want),
            "max_abs_err": (got - want).abs().max().item(),
            "argmax_equal": (got.argmax(-1) == want.argmax(-1)).float()
            .mean().item()}


def int8_forward_phase(runs, device: str = "cuda") -> dict:
    """bf16 and int8 forwards of each (model, save directory) of `runs`
    (the best checkpoint and its scales), CUDA-event ms per batch in the
    order bf16, int8, int8, bf16 at each of INT8_BATCHES; then, after
    every event timing (profiled_pass), the bf16 forward's kernel time,
    the int8 forward's device split at B=8 (int8_split) and its logits
    through the kernels against the plain twins' (int8_path_check)."""
    import torch

    from stf_unet_tpu_torch.cli.common import (checkpoint_path,
                                               restore_for_inference)
    from stf_unet_tpu_torch.data.transforms import normalize
    from stf_unet_tpu_torch.models.registry import preprocess_input
    from stf_unet_tpu_torch.ops import quant

    out, profiled = {}, []
    for model_name, weights in runs:
        path = checkpoint_path(weights, model_name)
        model, data_cfg, _, _ = restore_for_inference(
            model_name, path, use_subtraction=True, dtype="bf16",
            device=device)
        qmodel = quant.QuantizedModel(model, quant.load_scales(
            quant.scales_path_for(path)))
        line = out[model_name] = {}
        for b in INT8_BATCHES:
            gen = torch.Generator(device=device).manual_seed(b)
            raw = torch.randint(0, 256, (b, T_STEPS, CROP, CROP, 1),
                                generator=gen, device=device)
            x = preprocess_input(normalize(raw, data_cfg.mean,
                                           data_cfg.std), model)
            with torch.inference_mode():
                times = [cuda_ms(lambda m=m: m(x), iters=10, warmup=2)
                         for m in (model, qmodel, qmodel, model)]
            line[f"B{b}"] = {"bf16_ms": [times[0], times[3]],
                             "int8_ms": [times[1], times[2]],
                             "int8_over_bf16": (times[1] + times[2])
                             / (times[0] + times[3])}
            if b == 8:
                profiled.append((line, model, qmodel, x))
    for line, model, qmodel, x in profiled:
        with torch.inference_mode():
            line["bf16_kernel_ms_b8"] = profiled_ms(lambda: model(x), 3)
            split = line["int8_split_b8"] = int8_split(qmodel, x)
            path = line["kernels_vs_plain_b8"] = int8_path_check(qmodel, x)
        check(split["copies_in_conv_ranges"] in (0, "not measured"),
              f"int8 forward: {split['copies_in_conv_ranges']} copy "
              f"kernels a forward inside the quantized convs")
        check(path["bit_equal"], f"int8 forward through K5 and K6 differs "
                                 f"from the plain twins' by {path}")
    del profiled
    torch.cuda.empty_cache()
    print(json.dumps({"int8_forward": out}), flush=True)
    return out


def int8_serve(stf_weights: str, newer: str, device: str = "cuda"):
    """cli/serve.build_server with --model-dir --dtype int8 --tta --tiled
    --warmup-geometries 256x256: INT8_REQUESTS requests at 224^2 (the
    batched path) and at 256^2 (the tiles), each answer equal to the
    engine's direct quantized forward on the same frames, and its share of
    pixels equal to a bf16 server's (same flags); then POST /v1/reload
    after `newer` (another checkpoint with its scales) replaces the best:
    200 and the new weights' masks; without its scales: 409 and the
    served weights stay. Returns (launch counts of the requests, the
    result line)."""
    import shutil

    import torch

    from stf_unet_tpu_torch.cli.common import load_reference_checkpoint
    from stf_unet_tpu_torch.cli.serve import build_server, parse_args
    from stf_unet_tpu_torch.ops import quant
    from stf_unet_tpu_torch.serve.client import (SegmentationClient,
                                                 ServerError)

    flags = ["--model", "stflstm", "--model-dir", stf_weights,
             "--use-subtraction", "--tta", "--tiled", "--warmup-geometries",
             "256x256", "--port", "0", "--max-batch", "8", "--device",
             device]
    best = os.path.join(stf_weights, "stflstm_best_model.pth")
    scales = quant.scales_path_for(best)
    for path in (best, scales):
        shutil.copy(path, path + ".kept")
    t0 = time.perf_counter()
    server = build_server(parse_args(flags + ["--dtype", "int8"]))
    build_s = time.perf_counter() - t0
    bf16 = build_server(parse_args(flags + ["--dtype", "bf16",
                                            "--no-warmup"]))
    bf16.batcher.close()
    bf16.httpd.server_close()
    rng = np.random.default_rng(5)
    frames = {size: [rng.integers(0, 256, (T_STEPS, size, size),
                                  dtype=np.uint8)
                     for _ in range(INT8_REQUESTS)]
              for size in (CROP, TRAIN_SRC)}

    def direct(srv, f):
        image, (h, w) = srv.preprocess(f)
        return srv.engine.predict(image[None])[0][:h, :w]

    server.start()
    try:
        client = SegmentationClient("http://%s:%d" % server.address,
                                    timeout=300)
        kernels = reset_counts()
        ms, answers = {}, {}
        for size, stack in frames.items():
            t1 = time.perf_counter()
            answers[size] = [client.segment(f) for f in stack]
            ms[size] = (time.perf_counter() - t1) * 1e3 / len(stack)
        torch.cuda.synchronize()
        launches = _launches(kernels)
        equal, share = {}, {}
        for size, stack in frames.items():
            equal[size] = all(np.array_equal(a, direct(server, f))
                              for a, f in zip(answers[size], stack))
            share[size] = float(np.mean([np.mean(a == direct(bf16, f))
                                         for a, f in zip(answers[size],
                                                         stack)]))
            check(all(a.shape == (size, size) for a in answers[size]),
                  f"int8 serve {size}: mask shapes")
            check(equal[size], f"int8 serve {size}: an answer differs from "
                               f"the direct quantized forward")
        probe = frames[TRAIN_SRC][0]
        before = client.segment(probe)
        newer_scales = quant.scales_path_for(newer)
        shutil.copy(newer, best)
        shutil.copy(newer_scales, scales)
        info = client.reload()
        after = client.segment(probe)
        new = load_reference_checkpoint(newer)[0]
        swapped = all(torch.equal(v.cpu(), new[k]) for k, v in
                      server.weights.model.state_dict().items())
        check(swapped, "int8 reload did not load the new checkpoint")
        check(bool(np.array_equal(after, direct(server, probe))),
              "int8: the answer after reload is not the new weights' mask")
        os.remove(scales)
        try:
            client.reload()
            refused = None
        except ServerError as e:
            refused = e.code
        check(refused == 409, f"int8 reload without scales: {refused}")
        check(bool(np.array_equal(client.segment(probe), after)),
              "int8: the served weights moved after a refused reload")
        metrics = client.metrics()
    finally:
        server.stop()
        for path in (best, scales):
            shutil.move(path + ".kept", path)
    for name in ("lstm_last_x", "lstm_last", "quant_patches",
                 "quant_epilogue"):
        check(launches[name] > 0, f"kernel {name} never launched by the "
                                  f"int8 server")
    return launches, {
        "build_and_warmup_s": build_s,
        "ms_per_request_tta": ms[CROP],
        "ms_per_request_tta_tiled_256": ms[TRAIN_SRC],
        "equal_to_direct_int8": {str(k): v for k, v in equal.items()},
        "share_equal_to_bf16_server": {str(k): v for k, v in share.items()},
        "reload": {"info": info, "mask_changed":
                   bool(not np.array_equal(before, after)),
                   "refused_without_scales": refused},
        "errors": metrics["errors"], "launches": launches}


def int8_phase(data: str, stf_weights: str, unet_weights: str,
               extras_weights: str, device: str = "cuda"):
    """20. int8: `cli.quantize --threshold-sweep` (bf16) on the best
    checkpoints of phases 6 and 9 (convs quantized, float / int8 dice,
    the delta, the operating points; K5 launched), and `--no-eval` on
    phase 15's; int8_forward_phase on both models; int8_serve. Returns the
    launch counts of the quantize runs and the server's requests,
    summed."""
    import math

    from stf_unet_tpu_torch.cli import quantize as quantize_cli

    t_phase = time.perf_counter()
    total = {name: 0 for name in counters()}
    runs = {}
    for model, weights, extra in (
            ("stflstm", stf_weights, ["--threshold-sweep"]),
            ("unet", unet_weights, ["--threshold-sweep"]),
            ("stflstm", extras_weights, ["--no-eval"])):
        kernels = reset_counts()
        t0 = time.perf_counter()
        res = quantize_cli.main([
            "--model", model, "--model-dir", weights, "--root", data,
            "--use-subtraction", "--calib-samples", str(INT8_CALIB_SAMPLES),
            "--batch-size", "8", "--dtype", "bf16", "--device", device,
            *extra])
        wall = time.perf_counter() - t0
        launches = _launches(kernels)
        for name, n in launches.items():
            total[name] += n
        check(res["num_convs"] == INT8_CONVS[model],
              f"cli.quantize {model}: {res['num_convs']} convs quantized")
        if "--no-eval" not in extra:
            for name in ("quant_patches", "quant_epilogue"):
                check(launches[name] > 0, f"kernel {name} never launched "
                                          f"in cli.quantize {model}")
            check(all(math.isfinite(res[k]) for k in ("dice_float",
                                                      "dice_int8")),
                  f"cli.quantize {model}: dice {res}")
            runs[model] = weights
        print(json.dumps({"int8_quantize": {
            "model": model, "weights": os.path.basename(weights),
            "wall_s": wall, **{k: v for k, v in res.items()
                               if k != "scales_path"},
            "launches": launches}}), flush=True)
    forwards = int8_forward_phase(list(runs.items()), device)
    from stf_unet_tpu_torch.cli.common import checkpoint_path

    launches, line = int8_serve(stf_weights, checkpoint_path(
        extras_weights, "stflstm"), device)
    for name, n in launches.items():
        total[name] += n
    print(json.dumps({"int8_serve": {
        **line, "phase_wall_s": time.perf_counter() - t_phase}}),
        flush=True)
    return total, forwards


# Phase 21, data parallelism. The card's machine has one GPU and NCCL
# refuses two ranks on one device, so: (a) cli/train --multihost under
# torchrun's environment at world 1 (NCCL, DDP, synced BN), full width,
# bf16, B=16, one epoch with evaluation; (b) two gloo ranks on the one
# card (B=8 each) against one process (B=16) over the same global batch,
# f32, two steps, and the sharded val pass against the whole one on the
# seeded weights; (c) ms per bf16 B=16 step with no group against NCCL
# world-1 DDP with synced BN. Each part runs in child processes that
# count their own kernel launches; a child that fails fails the run.
DP_EPS = 0.1     # AdamW eps of (b): the update stays linear in the
                 # gradient, so f32 round-off of near-zero gradients (the
                 # conv biases before BN) is not normalized up to an lr
DP_LR = 1e-3
DP_STEPS = 2
# (b)'s tolerances, written before its first run: f32 on both sides, the
# BN statistics summed across ranks (E[x^2] - mean^2) against cuDNN's
# one-process BN and B=8 convolutions against B=16 ones.
DP_LOSS_RTOL = (1e-4, 1e-3)      # step 1, step 2
# ||theta_dp - theta_1p|| / ||theta_1p - theta_0|| over all parameters
# after steps 1 and 2. Step 2's 5e-2 was written before the first run;
# step 1's after: with cuDNN deterministic (one process then repeats
# itself exactly) the ranks read 0.0057 / 0.0253, in the encoder's early
# conv weights; ranks with local BN statistics read 0.87 / 0.75, and the
# phase checks that they fail both bounds.
DP_UPDATE_RTOL = (2e-2, 5e-2)
DP_DICE_ATOL = 1e-6
DP_TIMED_STEPS = 10
DP_CHILD_TIMEOUT = 600

DP_TRAIN_CHILD = r"""
import json, sys
import torch
import chip_smoke as cs
from stf_unet_tpu_torch.cli import train as train_cli

out, argv = sys.argv[1], sys.argv[2:]
seen = {}
wrapped = train_cli.data_parallel


def data_parallel(model, group):
    ddp = wrapped(model, group)
    seen.update(backend=torch.distributed.get_backend(), world=group.world,
                synced_bn=sum(getattr(m, "data_group", None) is not None
                              for m in model.modules()),
                wrapper=type(ddp).__name__)
    return ddp


train_cli.data_parallel = data_parallel
kernels = cs.reset_counts()
result = train_cli.run(argv)
json.dump({"epochs": result["epochs"], "steps": result["steps"],
           "test_dice": result["test"]["dice"], "group": seen,
           "launches": {n: f.launches for n, f in kernels.items()}},
          open(out, "w"))
"""

DP_RANK_CHILD = r"""
import json, sys
import torch
import chip_smoke as cs
from stf_unet_tpu_torch.core import distributed, mesh as mesh_lib

data, out, rank, world, port, variant = (
    sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
    sys.argv[5], sys.argv[6])
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
distributed.initialize(f"localhost:{port}", world, rank, device=dev,
                       backend="gloo" if world > 1 else "nccl")
group = mesh_lib.create_mesh(world, dev)
result = {}
if world == 1:  # the solo child: (c), then (b)'s one-process side
    if variant == "synced":
        result["step_ms"] = cs.dp_step_times(data, group)
    if variant != "synced_bn":  # that one keeps the group's BN at world 1
        group = None
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
torch.use_deterministic_algorithms(True, warn_only=True)
kernels = cs.reset_counts()
result.update(cs.dp_fixed_steps(data, group, out,
                                local_bn=variant == "local_bn"))
result["launches"] = {n: f.launches for n, f in kernels.items()}
json.dump(result, open(out + ".json", "w"))
distributed.shutdown()
"""


def dp_fixed_steps(data: str, group, out: str, device="cuda",
                   local_bn: bool = False) -> dict:
    """(b) on one side: the seeded full-width STF-LSTM-UNet (f32) evaluated
    on the val split (sharded over the ranks, at batch 1), then DP_STEPS
    steps on the tree's first batch of TRAIN_BATCH (this rank's rows of
    it); the losses, the metrics, and rank 0's parameters at the start
    and after every step saved to `out`. `local_bn` (the control) leaves
    each rank's BNs on its own rows."""
    import torch

    from stf_unet_tpu_torch.core import mesh as mesh_lib
    from stf_unet_tpu_torch.core.config import (DataConfig, ModelConfig,
                                                OptimConfig)
    from stf_unet_tpu_torch.core.prng import augment_generator
    from stf_unet_tpu_torch.data.index import DatasetIndex
    from stf_unet_tpu_torch.data.loader import Batch, HostLoader
    from stf_unet_tpu_torch.data.transforms import TrainAugment
    from stf_unet_tpu_torch.models.registry import create_model
    from stf_unet_tpu_torch.train.loop import (eval_batches_from_index,
                                               evaluate, train_step)
    from stf_unet_tpu_torch.train.state import (TrainState, data_parallel,
                                                make_optimizer)

    rank, world = (group.rank, group.world) if group else (0, 1)
    dev = group.device if group else torch.device(device)
    cfg = DataConfig(data_path=data, use_subtraction=True,
                     base_size=TRAIN_SRC, crop_size=TRAIN_CROP)
    seqs = cfg.resolved_sequence_types
    host = next(iter(HostLoader(DatasetIndex(data, "train", seqs),
                                TRAIN_BATCH, shuffle=False, prefetch=0,
                                verbose=False).epoch(0)))
    if group is not None:
        host = Batch(*mesh_lib.shard_batch(
            group, (host.frames, host.masks, host.sizes)))
    torch.manual_seed(0)
    model = create_model(ModelConfig(model="stflstm")).to(dev)
    ddp = data_parallel(model, group) if group is not None else None
    if local_bn:
        for m in model.modules():
            if getattr(m, "data_group", None) is not None:
                m.data_group = None
    t0 = time.perf_counter()
    metrics = evaluate(model, eval_batches_from_index(
        DatasetIndex(data, "val", seqs), cfg, host_index=rank,
        num_hosts=world), 2, data_cfg=cfg, device=dev,
        reduce_across_processes=group is not None)
    eval_s = time.perf_counter() - t0
    start = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    state = TrainState(model, make_optimizer(OptimConfig(eps=DP_EPS), model,
                                             dev), group=group, ddp=ddp)
    augment = TrainAugment(cfg, rank, world)
    losses, params = [], [start]
    t0 = time.perf_counter()
    for s in range(DP_STEPS):
        loss, _ = train_step(state, augment, host, augment_generator(0, 0, s),
                             lambda _: DP_LR, 2, dev)
        losses.append(loss.item())
        params.append({n: p.detach().cpu().clone()
                       for n, p in model.named_parameters()})
    steps_s = time.perf_counter() - t0
    final = params[-1]
    checksum = float(sum(p.double().abs().sum() for p in final.values()))
    if rank == 0:
        torch.save(params, out + ".pt")
    return {"losses": losses, "confusion": metrics["confusion_matrix"]
            .tolist(), "dice": metrics["dice"], "checksum": checksum,
            "eval_s": eval_s, "steps_s": steps_s}


def dp_step_times(data: str, group) -> dict:
    """(c): ms per bf16 TRAIN_BATCH step on one fixed batch (CUDA events
    over DP_TIMED_STEPS back-to-back steps) of a model with no group and
    of one under DDP with synced BN in `group`, in the order plain, DDP,
    DDP, plain; then one torch.profiler step of each: kernel time, the
    wall, and the kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stf_unet_tpu_torch.core.prng import augment_generator
    from stf_unet_tpu_torch.train.loop import train_step
    from stf_unet_tpu_torch.train.state import data_parallel

    dev = group.device
    runs = {}
    for kind in ("plain", "ddp"):
        state, augment, host = train_objects(data, torch.bfloat16, dev,
                                             TRAIN_BATCH)
        if kind == "ddp":
            state.group = group
            state.ddp = data_parallel(state.model, group)
        runs[kind] = (state, augment, host)

    def step(kind):
        state, augment, host = runs[kind]
        return lambda: train_step(state, augment, host,
                                  augment_generator(0, 0, 0),
                                  lambda _: DP_LR, 2, dev)

    times = {"plain": [], "ddp": []}
    for kind in ("plain", "ddp", "ddp", "plain"):
        times[kind].append(cuda_ms(step(kind), iters=DP_TIMED_STEPS))
    views = {}
    for kind in ("plain", "ddp"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(kind)()[0].item()
            wall = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(dev_ms(e) for e in kernels)
        views[kind] = {
            "wall_ms": wall, "kernel_ms": busy if busy else "not measured",
            "launches": sum(e.count for e in kernels),
            "top_kernels": [{"name": e.key[:80], "calls": e.count,
                             "ms": dev_ms(e)}
                            for e in sorted(kernels, key=dev_ms,
                                            reverse=True)[:10]]}
    return {**times, "ddp_over_plain": (sum(times["ddp"])
                                        / sum(times["plain"])),
            "profiled": views}


def _run_children(cmds, cwd: str, env=None) -> None:
    """Start the commands together, wait for all (DP_CHILD_TIMEOUT s; on
    expiry every one is killed), and fail on any non-zero exit."""
    import signal

    procs = [subprocess.Popen(c, cwd=cwd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              start_new_session=True) for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DP_CHILD_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    for p, out in zip(procs, outs):
        print(out[-3000:], flush=True)
        check(p.returncode == 0, f"data-parallel child failed "
                                 f"(exit {p.returncode}): {out[-3000:]}")


def data_parallel_phase(tmpdir: str, data: str) -> dict:
    """21. (a), (b) and (c) above, each in child processes of this one.
    Returns the launch counts of (a) and of (b)'s two ranks."""
    import math

    import torch

    from stf_unet_tpu_torch.core.distributed import free_port

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.empty_cache()
    # (a) cli/train --multihost at world 1, torchrun's environment
    out_a = os.path.join(tmpdir, "dp_train.json")
    weights = os.path.join(tmpdir, "weights_dp")
    env = {**os.environ, "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(free_port()), "RANK": "0", "WORLD_SIZE": "1",
           "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"}
    _run_children([[sys.executable, "-c", DP_TRAIN_CHILD, out_a,
                    "--data-path", data, "--model", "stflstm",
                    "--amp", "true", "--use-subtraction", "--multihost",
                    "--batch-size", str(TRAIN_BATCH), "--epochs", "1",
                    "--eval-batch-size", str(TRAIN_BATCH),
                    "--data-base-size", str(TRAIN_SRC),
                    "--data-crop-size", str(TRAIN_CROP),
                    "--save-dir", weights,
                    "--output-dir", os.path.join(tmpdir, "out_dp"),
                    "--print-freq", "1"]], here, env)
    with open(out_a) as f:
        a = json.load(f)
    losses = [e["train_loss"] for e in a["epochs"]]
    check(all(math.isfinite(v) for v in losses) and a["steps"] >= 4,
          f"--multihost run: losses {losses}, steps {a['steps']}")
    check(a["group"] == {"backend": "nccl", "world": 1, "synced_bn": 44,
                         "wrapper": "DistributedDataParallel"},
          f"--multihost run engaged {a['group']}")
    check(os.path.isfile(os.path.join(weights, "stflstm_latest_model.pth")),
          "--multihost run wrote no checkpoint")
    for name in TRAIN_KERNELS:
        check(a["launches"][name] > 0, f"{name} never launched in the "
                                       f"--multihost child")
    for name in BN_KERNELS:  # the synced BN normalizes without K7
        check(a["launches"][name] == 0, f"{name} launched in the "
                                        f"--multihost child")
    print(json.dumps({"data_parallel_multihost": {
        **a, "losses": losses}}), flush=True)

    # (b) two gloo ranks on the card, the same with local BN statistics
    # (the control the bound must catch), then (c) with the one-process
    # side, and that side again (the card's run-to-run spread)
    def two_ranks(variant):
        port = str(free_port())
        outs = [os.path.join(tmpdir, f"dp_{variant}{r}") for r in range(2)]
        _run_children([[sys.executable, "-c", DP_RANK_CHILD, data, outs[r],
                        str(r), "2", port, variant] for r in range(2)], here)
        return outs

    def one_process(variant):
        out = os.path.join(tmpdir, f"dp_solo_{variant}")
        _run_children([[sys.executable, "-c", DP_RANK_CHILD, data, out, "0",
                        "1", str(free_port()), variant]], here)
        return out

    outs, local = two_ranks("synced"), two_ranks("local_bn")
    solo = one_process("synced")
    ranks = dp_compare(outs, solo, {
        "local_bn": local[0], "repeat": one_process("repeat"),
        "synced_bn_1proc": one_process("synced_bn")})
    with open(solo + ".json") as f:
        step_ms = json.load(f)["step_ms"]
    print(json.dumps({"data_parallel_step_ms": {
        **step_ms, "batch": TRAIN_BATCH, "dtype": "bf16",
        "steps": DP_TIMED_STEPS, "order": "plain, ddp, ddp, plain",
        "phase_wall_s": time.perf_counter() - t_phase}}), flush=True)
    return {name: a["launches"][name] + sum(r["launches"][name]
                                            for r in ranks)
            for name in counters()}


def dp_gaps(got: list, ref: list) -> dict:
    """The distance of parameter lists `got` from `ref` (each: the start,
    then after every step) after each step, relative to ref's update
    from the start, and the leaves that carry the most of the last
    step's squared distance."""
    def sq(a, b):
        return float((a.double() - b.double()).pow(2).sum())

    by_step = [(sum(sq(got[k][n], w) for n, w in ref[k].items())
                / sum(sq(w, ref[0][n]) for n, w in ref[k].items())) ** 0.5
               for k in range(1, len(ref))]
    diff = {n: sq(got[-1][n], w) for n, w in ref[-1].items()}
    total = sum(diff.values())
    top = sorted(diff, key=diff.get, reverse=True)[:8]
    return {"by_step": by_step, "leaves": [
        {"name": n, "share": diff[n] / total if total else 0.0,
         "rel": (diff[n] / max(sq(ref[-1][n], ref[0][n]), 1e-300)) ** 0.5,
         "update_l2": sq(ref[-1][n], ref[0][n]) ** 0.5} for n in top]}


def dp_compare(outs, solo: str, controls: dict) -> list:
    """(b)'s checks: the two ranks' results (files `outs`) against the
    one process's (`solo`), and the controls' (`controls`: name -> file):
    "local_bn", ranks with local BN statistics, which the bound must
    catch; "repeat", the one process again; "synced_bn_1proc", one
    process B=16 through the synced BN at world 1, which parts the BN's
    arithmetic from the batch split. Prints the line; returns the
    ranks'."""
    import torch

    ranks = []
    for o in outs:
        with open(o + ".json") as f:
            ranks.append(json.load(f))
    with open(solo + ".json") as f:
        one = json.load(f)
    ref = torch.load(solo + ".pt", weights_only=True)

    def params(path):
        return torch.load(path + ".pt", weights_only=True)

    dp = params(outs[0])
    gaps = dp_gaps(dp, ref)
    split_only = dp_gaps(dp, params(controls["synced_bn_1proc"]))
    controls = {name: dp_gaps(params(path), ref)
                for name, path in controls.items()}
    controls["2ranks_vs_synced_bn_1proc"] = split_only
    rel = gaps["by_step"][-1]
    update = sum(float((w.double() - ref[0][n].double()).pow(2).sum())
                 for n, w in ref[-1].items()) ** 0.5
    start_equal = all(torch.equal(dp[0][n], w) for n, w in ref[0].items())
    loss_rel = [abs(g - w) / abs(w)
                for g, w in zip(ranks[0]["losses"], one["losses"])]
    line = {"losses_2ranks": ranks[0]["losses"], "losses_1proc":
            one["losses"], "loss_rel": loss_rel,
            "update_rel_l2": rel, "update_rel_l2_by_step": gaps["by_step"],
            "update_l2": update, "leaves": gaps["leaves"],
            "controls": controls, "start_equal": start_equal,
            "rank_checksums": [r["checksum"] for r in ranks],
            "confusion_2ranks": ranks[0]["confusion"],
            "confusion_1proc": one["confusion"],
            "dice_2ranks": ranks[0]["dice"], "dice_1proc": one["dice"],
            "steps_s": [r["steps_s"] for r in ranks] + [one["steps_s"]],
            "tolerance": {"loss_rtol": DP_LOSS_RTOL,
                          "update_rtol": DP_UPDATE_RTOL,
                          "dice_atol": DP_DICE_ATOL},
            "launches_by_rank": [r["launches"] for r in ranks]}
    print(json.dumps({"data_parallel_gloo_world2": line}), flush=True)
    check(start_equal, "the ranks started from other weights")
    check(ranks[0]["checksum"] == ranks[1]["checksum"],
          "the two ranks hold different parameters")
    for i, (rel, tol) in enumerate(zip(loss_rel, DP_LOSS_RTOL)):
        check(rel <= tol, f"step {i + 1} loss {rel:.3g} relative from one "
                          f"process (tolerance {tol})")
    for i, tol in enumerate(DP_UPDATE_RTOL):
        got, control = gaps["by_step"][i], controls["local_bn"]["by_step"][i]
        check(got <= tol, f"step {i + 1}: parameters {got:.3g} of the "
                          f"update from one process (tolerance {tol})")
        check(control > tol, f"step {i + 1}: ranks with local BN "
                             f"statistics came {control:.3g} of the update "
                             f"from one process, within the bound {tol}")
    for r in ranks:
        check(r["confusion"] == one["confusion"],
              f"val confusion {r['confusion']} != {one['confusion']}")
        check(abs(r["dice"] - one["dice"]) <= DP_DICE_ATOL,
              f"val dice {r['dice']} vs {one['dice']}")
        for name in TRAIN_KERNELS:
            check(r["launches"][name] > 0, f"{name} never launched in a "
                                           f"gloo rank")
        for name in BN_KERNELS:
            check(r["launches"][name] == 0, f"{name} launched in a gloo "
                                            f"rank (synced BN)")
    return ranks


# Phase 22, data-parallel inference: one process over a device list
# (core/mesh.inference_devices), a model replica on each device. (a) the
# CLIs with --data-parallel 0, every visible GPU: a bf16 server with --tta
# --tiled and an int8 server (--dtype int8 --tta --tiled), each answering
# DPI_REQUESTS requests at 224^2 and at 256^2, cli/predict --tiled over
# the unlabeled test images, pk.maps (LM) over the tree's 12 volumes; K1f,
# K3, K4, K5 and K6 launched. (b) two replicas on the one card through the
# APIs (devices=[cuda:0, cuda:0], the counterpart of the JAX tests'
# simulated mesh), cuDNN deterministic and benchmark off, against one
# device: the engine at n = 1, 3, 8 with return_probs, a 256^2 tiled
# volume, the int8 engine (each replica's kernels counted), fit_lm over
# one volume's tissue curves (3 chunks: two in the first dispatch). (c)
# B=8 engine.predict and a two-chunk fit_lm on one replica against two
# (wall and events, one, two, two, one) and a profiler view of the
# two-replica predict; where several GPUs are visible, the same over 1, 2
# and all of them (`cards`).
DPI_REQUESTS = 4
DPI_ENGINE_BATCHES = (1, 3, 8)
DPI_TIMED = 10
# (b)'s tolerances, written before the first run. The engines run bf16,
# and two replicas give each convolution half the rows one device gives
# it, so cuDNN may take another algorithm and round otherwise. A mask
# pixel may differ from one device's only where one device's top-two
# logit margin is at most DPI_MARGIN_REL of its max |logit| (four of the
# bf16 steps TOL["bf16"] allows a kernel): the engine's, the int8
# engine's and (on the blended scores) the tiles'; the float16
# probabilities within DPI_PROB_ATOL; fit_lm bit-equal (each device fits
# exactly the chunk one device fits in that place). The tiled and int8
# masks take the margin rule too, not a share of equal pixels: on phase
# 6's trained checkpoint the tiles keep ~0.998 of one device's pixels on
# an H100 (NVIDIA H100 80GB HBM3, 700 W), all near-ties, and only a
# margin tells a near-tie from a fault.
DPI_MARGIN_REL = 4 * TOL["bf16"]
DPI_PROB_ATOL = 2.0 ** -5
# (c) on a machine with several GPUs: fit_lm timed over this many chunks.
DPI_CARD_CHUNKS = 4


def _sync(device: str) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _dpi_cli_runs(tmpdir: str, data: str, weights: str,
                  device: str = "cuda") -> tuple:
    """(a). Returns (launch counts summed over the runs, the line)."""
    import math

    import torch

    from stf_unet_tpu_torch.cli import predict
    from stf_unet_tpu_torch.cli.serve import build_server, parse_args
    from stf_unet_tpu_torch.core.config import PKConfig
    from stf_unet_tpu_torch.pk import maps as pk_maps
    from stf_unet_tpu_torch.pk.fit import CHUNK
    from stf_unet_tpu_torch.serve.client import SegmentationClient

    cuda = torch.device(device).type == "cuda"  # kernels launch there
    n_dev = torch.cuda.device_count() if cuda else 1
    total = {name: 0 for name in counters()}
    line = {}

    def counted(name, fn, want):
        kernels = reset_counts()
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        wall = time.perf_counter() - t0
        launches = _launches(kernels)
        for k in want if cuda else ():
            check(launches[k] > 0, f"{k} never launched by {name} under "
                                   f"--data-parallel 0")
        for k, n in launches.items():
            total[k] += n
        line[name] = {"wall_s": wall, "launches": launches}
        return out

    rng = np.random.default_rng(22)
    frames = {size: [rng.integers(0, 256, (T_STEPS, size, size),
                                  dtype=np.uint8)
                     for _ in range(DPI_REQUESTS)]
              for size in (CROP, TRAIN_SRC)}
    for dtype, want in (("bf16", ("lstm_last_x", "lstm_last")),
                        ("int8", ("lstm_last_x", "lstm_last",
                                  "quant_patches", "quant_epilogue"))):
        server = build_server(parse_args(
            ["--model", "stflstm", "--model-dir", weights,
             "--use-subtraction", "--tta", "--tiled", "--warmup-geometries",
             f"{TRAIN_SRC}x{TRAIN_SRC}", "--port", "0", "--max-batch", "8",
             "--device", device, "--dtype", dtype, "--data-parallel", "0"]))
        check(len(server.engine.replicas) == n_dev
              and server.tiled.replicas is server.engine.replicas,
              f"{dtype} server: {len(server.engine.replicas)} replicas for "
              f"{n_dev} GPUs")
        server.start()
        try:
            client = SegmentationClient("http://%s:%d" % server.address,
                                        timeout=300)
            answers = counted(f"serve_{dtype}", lambda: {
                size: [client.segment(f) for f in stack]
                for size, stack in frames.items()}, want)
            errors = client.metrics()["errors"]
        finally:
            server.stop()
        for size, masks in answers.items():
            check(all(m.shape == (size, size) for m in masks),
                  f"{dtype} server {size}: mask shapes")
        check(errors == 0, f"{dtype} server: {errors} errors")
        line[f"serve_{dtype}"]["ms_per_request"] = (
            line[f"serve_{dtype}"]["wall_s"] * 1e3
            / sum(len(s) for s in frames.values()))

    unlabeled = os.path.join(tmpdir, "unlabeled")
    result = counted("predict_tiled", lambda: predict.main(
        ["--model", "stflstm", "--model-dir", weights, "--use-subtraction",
         "--dtype", "bf16", "--device", device, "--input", unlabeled,
         "--output-dir", os.path.join(tmpdir, "predict_dp"), "--tiled",
         "--data-parallel", "0"]), ("lstm_last_x", "lstm_last"))
    check(result["slices"] == EVAL_PATIENTS * TRAIN_SLICES,
          f"predict --data-parallel 0: {result['slices']} slices")
    line["predict_tiled"]["ms_per_slice"] = (
        result["seconds"]["total"] * 1e3 / result["slices"])

    cfg = PKConfig()
    chunks = sum(math.ceil(n / CHUNK) for *_, n in pk_volumes(data))
    counted("pk_maps", lambda: pk_maps.main(
        [data, "--solver", "lm", "--device", device, "--data-parallel",
         "0"]), ("tofts_sums",))
    got = line["pk_maps"]["launches"]["tofts_sums"]
    check(got == chunks * 2 * cfg.lm_iters or not cuda,
          f"pk.maps --data-parallel 0: "
                                            f"K4 launched {got} times, "
                                            f"expected {chunks} chunks x 2 "
                                            f"x {cfg.lm_iters}")
    for split, patient, _, _ in pk_volumes(data):
        raw = np.load(os.path.join(data, "seg", split, "pk_maps", patient,
                                   "ktrans_raw.npy"))
        check(bool(np.isfinite(raw).all()), f"{split}/{patient}: "
                                            f"non-finite Ktrans")
    line["pk_maps"]["s_per_volume"] = line["pk_maps"]["wall_s"] / PK_VOLUMES
    line["devices"] = n_dev
    return total, line


def _replica_counts(replicas):
    """Per replica, the launches made inside its forwards: a pre-hook
    snapshots the counters, a hook adds the difference. Returns (the
    counts, the hook handles)."""
    kernels = counters()
    counts = [{name: 0 for name in kernels} for _ in replicas]
    handles = []
    for i, r in enumerate(replicas):
        start = {}

        def pre(_m, _args, start=start):
            start.update(_launches(kernels))

        def post(_m, _args, _out, i=i, start=start):
            for name, fn in kernels.items():
                counts[i][name] += fn.launches - start[name]
        handles += [r.register_forward_pre_hook(pre),
                    r.register_forward_hook(post)]
    return counts, handles


def _margin_check(label, logits, one, two) -> dict:
    """one / two: the masks of one device and of replicas; logits: one
    device's [..., C]. A differing pixel must be a near-tie (the
    tolerances above)."""
    top = logits.float().topk(2, dim=-1).values
    margin = (top[..., 0] - top[..., 1]).cpu().numpy()
    bound = DPI_MARGIN_REL * float(logits.float().abs().max())
    differ = one != two
    out = {"pixels_differing": int(differ.sum()),
           "share_equal": float(1 - differ.mean()),
           "max_margin_where_differing":
               float(margin[differ].max()) if differ.any() else 0.0,
           "margin_bound": bound}
    check(bool((margin[differ] <= bound).all()),
          f"{label}: a mask differs from one device's where the top-two "
          f"margin exceeds {bound}: {out}")
    return out


def _engine_logits(eng, images):
    """The logits of an engine's own padded batch on its first replica
    (the first n rows): one device's, for _margin_check."""
    import torch

    from stf_unet_tpu_torch.data.transforms import normalize
    from stf_unet_tpu_torch.models.registry import preprocess_input

    n = len(images)
    padded = np.concatenate([images] + [images[:1]] * (eng._bucket(n) - n))
    with torch.inference_mode():
        x = normalize(torch.from_numpy(padded).to(eng.device), eng.mean,
                      eng.std)
        return eng.model(preprocess_input(x, eng.model))["out"][:n]


def _dpi_two_replicas(data: str, weights: str, device: str = "cuda") -> dict:
    """(b) and (c). Returns the line."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stf_unet_tpu_torch.cli.common import (checkpoint_path,
                                               restore_for_inference)
    from stf_unet_tpu_torch.core.config import PKConfig
    from stf_unet_tpu_torch.ops import quant
    from stf_unet_tpu_torch.pk.aif import make_aif
    from stf_unet_tpu_torch.pk.fit import CHUNK, fit_lm, preprocess_images
    from stf_unet_tpu_torch.pk.tofts import ToftsQuadrature
    from stf_unet_tpu_torch.serve.engine import InferenceEngine
    from stf_unet_tpu_torch.serve.tiled import TiledPredictor

    cuda = torch.device(device).type == "cuda"
    dev = torch.device("cuda", 0) if cuda else torch.device(device)
    two = [dev, dev]
    path = checkpoint_path(weights, "stflstm")
    model, data_cfg, _, meta = restore_for_inference(
        "stflstm", path, use_subtraction=True, dtype="bf16", device=dev)
    mean, std = data_cfg.mean, data_cfg.std
    rng = np.random.default_rng(23)
    line = {"tolerance": {"margin_rel": DPI_MARGIN_REL,
                          "prob_atol": DPI_PROB_ATOL}}
    settings = (torch.backends.cudnn.deterministic,
                torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        one_eng = InferenceEngine(model, mean, std, max_batch=8, device=dev)
        two_eng = InferenceEngine(model, mean, std, max_batch=8,
                                  devices=two)
        engine = {}
        for n in DPI_ENGINE_BATCHES:
            images = rng.integers(0, 256, (n, T_STEPS, CROP, CROP, 1),
                                  dtype=np.uint8)
            m1, p1 = one_eng.predict(images, return_probs=True)
            m2, p2 = two_eng.predict(images, return_probs=True)
            check(np.array_equal(m2, two_eng.predict(images)),
                  f"two replicas n={n}: masks with and without probs")
            prob_err = float(np.abs(p1.astype(np.float32)
                                    - p2.astype(np.float32)).max())
            engine[str(n)] = {**_margin_check(
                f"two replicas n={n}", _engine_logits(one_eng, images), m1,
                m2), "max_prob_diff": prob_err}
            check(prob_err <= DPI_PROB_ATOL, f"two replicas n={n}: probs "
                                             f"{prob_err} from one device's")
        line["engine"] = engine

        volume = rng.integers(0, 256, (T_STEPS, TRAIN_SRC, TRAIN_SRC, 1),
                              dtype=np.uint8)
        kw = dict(mean=mean, std=std, tile=CROP, overlap=0.5)
        scores = TiledPredictor(model, device=dev, **kw).scores(volume)
        line["tiled_256"] = _margin_check(
            "tiled over two replicas", scores,
            scores.argmax(-1).cpu().numpy(),
            TiledPredictor(model, devices=two, **kw).predict(volume))

        scales = quant.load_scales(quant.scales_path_for(path),
                                   checkpoint_meta=meta)
        qmodel = quant.QuantizedModel(model, scales).eval()
        q_one = InferenceEngine(qmodel, mean, std, max_batch=8, device=dev)
        q_two = InferenceEngine(qmodel, mean, std, max_batch=8, devices=two)
        images = rng.integers(0, 256, (8, T_STEPS, CROP, CROP, 1),
                              dtype=np.uint8)
        counts, handles = _replica_counts(q_two.replicas)
        try:
            qm2 = q_two.predict(images)
        finally:
            for h in handles:
                h.remove()
        tables = [set(r._table) for r in q_two.replicas]
        check(not tables[0] & tables[1] and all(
            t == {r.model.get_submodule(name) for name in r.paths}
            and len(t) == len(scales)
            for t, r in zip(tables, q_two.replicas)),
            "an int8 replica's conv table holds another replica's convs")
        line["int8"] = {**_margin_check(
            "int8 over two replicas", _engine_logits(q_one, images),
            q_one.predict(images), qm2), "launches_by_replica": counts}
        for i, c in enumerate(counts if cuda else ()):
            for name in ("lstm_last_x", "lstm_last", "quant_patches",
                         "quant_epilogue"):
                check(c[name] > 0, f"{name} never launched by int8 "
                                   f"replica {i}")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = settings

    cfg = PKConfig()
    volumes = []
    for _, _, frames, _ in pk_volumes(data)[:2]:
        imgs, mask = preprocess_images(frames, cfg)
        volumes.append(imgs.numpy().transpose(1, 2, 0)[mask.numpy()])
    curves = volumes[0]  # one volume's tissue curves, ~2.5 chunks
    quad = ToftsQuadrature.build(cfg.time_points, make_aif(cfg.aif_method),
                                 cfg.dt, device=dev)
    fits = {}
    for label, devices in (("one", None), ("two", two)):
        kernels = reset_counts()
        fits[label] = fit_lm(curves, quad, cfg, devices=devices)
        fits[label + "_k4"] = _launches(kernels)["tofts_sums"]
    chunks = -(-len(curves) // CHUNK)
    line["fit_lm"] = {"voxels": len(curves), "chunks": chunks,
                      "bit_equal": bool(np.array_equal(fits["one"],
                                                       fits["two"])),
                      "k4_launches": [fits["one_k4"], fits["two_k4"]]}
    check(chunks >= 2, f"fit_lm check: {chunks} chunk(s), the second "
                       f"replica would sit idle")
    check(line["fit_lm"]["bit_equal"], "fit_lm over two replicas is not "
                                       "bit-equal to one device")
    check(fits["one_k4"] == fits["two_k4"] == chunks * 2 * cfg.lm_iters
          or not cuda,
          f"fit_lm K4 launches {fits['one_k4']} / {fits['two_k4']}")

    # (c) one replica against two on the one card: one, two, two, one
    images = rng.integers(0, 256, (8, T_STEPS, CROP, CROP, 1),
                          dtype=np.uint8)
    engines = {"one": one_eng, "two": two_eng}
    for eng in engines.values():
        eng.predict(images)

    def predict_ms(eng):
        """(wall ms, event ms) per call; events only on the card."""
        _sync(device)
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(DPI_TIMED):
            eng.predict(images)
        wall = (time.perf_counter() - t0) * 1e3 / DPI_TIMED
        if not cuda:
            return wall, "not measured"
        end.record()
        end.synchronize()
        return wall, start.elapsed_time(end) / DPI_TIMED

    timed = {"one": [], "two": []}
    for label in ("one", "two", "two", "one"):
        timed[label].append(predict_ms(engines[label]))
    chunk2 = curves[:2 * CHUNK]
    fit_s = {"one": [], "two": []}
    fit_lm(chunk2, quad, cfg, devices=two)
    for label in ("one", "two", "two", "one"):
        t0 = time.perf_counter()
        fit_lm(chunk2, quad, cfg, devices=two if label == "two" else None)
        fit_s[label].append((time.perf_counter() - t0) * 1e3)
    if cuda and torch.cuda.device_count() > 1:
        line["cards"] = _dpi_cards(model, mean, std, images,
                                   np.concatenate(volumes), quad, cfg,
                                   predict_ms)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        two_eng.predict(images)
        prof_ms = (time.perf_counter() - t0) * 1e3
    busy = sum(dev_ms(e) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    idle = (1 - busy / prof_ms) if busy else None
    line["timing"] = {
        "engine_b8_wall_ms": {k: [w for w, _ in v]
                              for k, v in timed.items()},
        "engine_b8_event_ms": {k: [e for _, e in v]
                               for k, v in timed.items()},
        "fit_lm_2chunks_wall_ms": fit_s, "chunk_voxels": CHUNK,
        "order": "one, two, two, one",
        "two_replica_predict_kernel_ms": busy if busy else "not measured",
        "two_replica_predict_idle_share": idle if busy else "not measured",
        "paced_by": ("host" if idle is not None and idle > 0.3
                     else "device" if idle is not None
                     else "not measured")}
    return line


def _dpi_cards(model, mean, std, images, curves, quad, cfg, predict_ms):
    """(c) over k = 1, 2 and every visible GPU, where there are several:
    B=8 engine.predict and a DPI_CARD_CHUNKS-chunk fit_lm, wall ms (one
    host thread feeds every card); the masks against one card's by
    _margin_check, the fit bit-equal."""
    import torch

    from stf_unet_tpu_torch.pk.fit import CHUNK, fit_lm
    from stf_unet_tpu_torch.serve.engine import InferenceEngine

    n = torch.cuda.device_count()
    curves = curves[:DPI_CARD_CHUNKS * CHUNK]
    out, ref = {}, None
    for k in sorted({1, 2, n}):
        devices = [torch.device("cuda", i) for i in range(k)]
        eng = InferenceEngine(model, mean, std, max_batch=8, devices=devices)
        masks = eng.predict(images)
        fit_lm(curves, quad, cfg, devices=devices)
        t0 = time.perf_counter()
        fitted = fit_lm(curves, quad, cfg, devices=devices)
        fit_ms = (time.perf_counter() - t0) * 1e3
        if ref is None:
            ref = (masks, fitted, _engine_logits(eng, images))
        out[str(k)] = {"engine_b8_wall_ms": predict_ms(eng)[0],
                       "fit_lm_wall_ms": fit_ms,
                       "fit_voxels": len(curves),
                       "masks_against_one_card": _margin_check(
                           f"engine over {k} cards", ref[2], ref[0], masks),
                       "fit_bit_equal_to_one_card":
                           bool(np.array_equal(fitted, ref[1]))}
        check(out[str(k)]["fit_bit_equal_to_one_card"],
              f"fit_lm over {k} cards is not bit-equal to one card")
        del eng
    return out


def dp_inference_phase(tmpdir: str, data: str, weights: str,
                       device: str = "cuda") -> dict:
    """22. (a), (b) and (c) above, on phase 6's best checkpoint (bf16) and
    its phase-20 scales; `tmpdir` holds phase 17's unlabeled copy of the
    test images. Returns the launch counts of (a)."""
    t_phase = time.perf_counter()
    launches, cli_line = _dpi_cli_runs(tmpdir, data, weights, device)
    line = _dpi_two_replicas(data, weights, device)
    print(json.dumps({"data_parallel_inference": {
        "cli": cli_line, "two_replicas": line,
        "phase_wall_s": time.perf_counter() - t_phase}}), flush=True)
    return launches


# Phase 23, spatial parallelism (parallel/spatial.py): image rows sharded
# over the space axis of a 2-D group. (a) two gloo ranks on the one card
# (a 1 x 2 mesh, both on cuda:0 as phase 21's ranks) against one process,
# the full-width STF-LSTM-UNet at crop 224, B = SP_BATCH, from the seeded
# weights and the tree's first batch, cuDNN deterministic: one f32 step
# (the tight check, with a control whose halos are replaced by the edge
# padding, which the bound must catch), one bf16 step (its per-rank peak
# memory and the launches of K1f, K1b and K2 on each rank), SP_TIMED bf16
# steps (ms per step, the two ranks sharing the card), one bf16 step with
# the space group's collectives timed (the halo share), and a bf16 eval
# forward of the val split's first SP_BATCH images, gathered, against the
# unsharded logits. (b) where 2+ GPUs are visible, cli/train
# --spatial-parallel 2 (--data-parallel 2 with 4) under NCCL, one short
# epoch with evaluation: ms per step and each rank's peak memory.
SP_BATCH = 4
SP_TIMED = 5
SP_EPS = 0.1     # AdamW eps: the update stays linear in the gradient
SP_LR = 1e-3
# Tolerances, written before the first run. f32: the one-process step
# against itself re-sharded reorders f32 sums (BN statistics over two
# ranks' rows, convs on halo-padded blocks): phase 21's step-1 bounds
# (loss 1e-4 relative; ||theta_sp - theta_1p|| / ||theta_1p - theta_0||
# 2e-2 per parameter group). bf16: the loss within 1e-2 relative, and
# each group's update distance within twice the bf16 step's own distance
# from the f32 step (sharding may add no more than bf16 rounding does)
# or SP_BF16_FLOOR. Eval logits: max |diff| within SP_LOGIT_REL of max
# |logit|, and a mask pixel may differ only where one process's top-two
# margin is within 1/32 of max |logit| (phase 22's near-tie bound).
SP_LOSS_RTOL = {"f32": 1e-4, "bf16": 1e-2}
SP_UPDATE_RTOL = 2e-2
SP_BF16_FLOOR = 5e-2
SP_LOGIT_REL = 2.0 ** -5
SP_GROUPS = {"encoder": ("conv1.", "bn1.", "layer"), "lstm": ("lstm",),
             "decoder": ("decoder", "upconv1.", "final")}

SP_CHILD = r"""
import json, sys
import torch
import chip_smoke as cs
from stf_unet_tpu_torch.core import distributed, mesh as mesh_lib

data, out, rank, world, port = (sys.argv[1], sys.argv[2], int(sys.argv[3]),
                                int(sys.argv[4]), sys.argv[5])
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
group = None
if world > 1:
    distributed.initialize(f"localhost:{port}", world, rank, device=dev,
                           backend="gloo")
    group = mesh_lib.create_2d_mesh(1, world, dev)
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
torch.use_deterministic_algorithms(True, warn_only=True)
json.dump(cs.sp_side(data, group, out), open(out + ".json", "w"))
if group is not None:
    distributed.shutdown()
"""

SP_CLI_CHILD = r"""
import json, sys
from stf_unet_tpu_torch.cli import train as train_cli

out, argv = sys.argv[1], sys.argv[2:]
result = train_cli.run(argv)
json.dump({"epochs": result["epochs"], "steps": result["steps"],
           "test_dice": result["test"]["dice"],
           "peak_memory_mb_by_rank": result["peak_memory_mb_by_rank"]},
          open(out, "w"))
"""


def sp_side(data: str, group, out: str, device: str = "cuda") -> dict:
    """(a) on one side (`group` the 1 x 2 mesh, or None for one process):
    the steps and the eval forward; the parameters after each step (and
    the start), and the gathered eval logits, saved to `out`.pt by rank
    0."""
    import torch

    from stf_unet_tpu_torch.core.config import (DataConfig, ModelConfig,
                                                OptimConfig)
    from stf_unet_tpu_torch.core.prng import augment_generator
    from stf_unet_tpu_torch.data.index import DatasetIndex
    from stf_unet_tpu_torch.data.loader import HostLoader
    from stf_unet_tpu_torch.data.transforms import TrainAugment, normalize
    from stf_unet_tpu_torch.models.registry import (create_model,
                                                    preprocess_input)
    from stf_unet_tpu_torch.parallel import spatial
    from stf_unet_tpu_torch.train.loop import (eval_batches_from_index,
                                               train_step)
    from stf_unet_tpu_torch.train.state import (TrainState, data_parallel,
                                                make_optimizer)

    dev = group.device if group is not None else torch.device(device)
    cfg = DataConfig(data_path=data, use_subtraction=True,
                     base_size=TRAIN_SRC, crop_size=TRAIN_CROP)
    seqs = cfg.resolved_sequence_types
    host = next(iter(HostLoader(DatasetIndex(data, "train", seqs), SP_BATCH,
                                shuffle=False, prefetch=0,
                                verbose=False).epoch(0)))
    image, _ = next(iter(eval_batches_from_index(
        DatasetIndex(data, "val", seqs), cfg, batch_size=SP_BATCH)))

    def fresh(dtype, ddp=True):
        torch.manual_seed(0)
        model = create_model(ModelConfig(model="stflstm"),
                             dtype=dtype).to(dev)
        ddp = (data_parallel(model, group) if group is not None and ddp
               else None)
        return TrainState(model, make_optimizer(OptimConfig(eps=SP_EPS),
                                                model, dev),
                          group=group, ddp=ddp)

    def step(state, s=0):
        return train_step(state, TrainAugment(cfg), host,
                          augment_generator(0, 0, s), lambda _: SP_LR, 2,
                          dev)[0].item()

    def params(model):
        return {n: p.detach().cpu().clone()
                for n, p in model.named_parameters()}

    def edge_padding(x, above, below, group, fill=0.0):
        edge = list(x.shape[:-2])
        return (x.new_full(edge + [above, x.shape[-1]], fill),
                x.new_full(edge + [below, x.shape[-1]], fill))

    saved, res = {}, {}
    kinds = ["f32"] + (["no_halo"] if group is not None else []) + ["bf16"]
    for kind in kinds:
        state = fresh(torch.bfloat16 if kind == "bf16" else torch.float32)
        if kind == "f32":
            saved["start"] = params(state.model)
        kernels = reset_counts()
        halo = spatial.halo_rows
        if kind == "no_halo":
            spatial.halo_rows = edge_padding
        try:
            loss = step(state)
        finally:
            spatial.halo_rows = halo
        res[kind] = {"loss": loss,
                     "launches": {n: f.launches for n, f in kernels.items()}}
        saved[kind] = params(state.model)
    # the bf16 state's second step: its peak over what the parameters,
    # gradients and AdamW moments already hold is the step's activations
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    step(state, 1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    res["bf16"].update(peak_mb=peak / 2**20, before_mb=before / 2**20,
                       activation_mb=(peak - before) / 2**20)
    # bf16 ms per step, then one step with the space group's collectives
    # timed on a synchronized host clock
    res["step_ms"] = cuda_ms(lambda: step(state, 2), iters=SP_TIMED,
                             warmup=1)
    comm = {"all_gather": 0.0, "all_reduce": 0.0, "calls": 0}
    wrapped = {}
    if group is not None:
        for name in ("all_gather", "all_reduce"):
            wrapped[name] = getattr(spatial._Space, name)

            def timed(self, x, _fn=wrapped[name], _name=name):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                y = _fn(self, x)
                torch.cuda.synchronize()
                comm[_name] += time.perf_counter() - t0
                comm["calls"] += 1
                return y

            setattr(spatial._Space, name, timed)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, 3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for name, fn in wrapped.items():
            setattr(spatial._Space, name, fn)
    res["comm"] = {**comm, "step_s": wall, "share": (
        (comm["all_gather"] + comm["all_reduce"]) / wall)}
    # the eval forward (bf16) of the seeded weights, gathered on every
    # rank
    model = fresh(torch.bfloat16, ddp=False).model.eval()
    x = normalize(torch.from_numpy(image).to(dev), cfg.mean, cfg.std)
    with torch.no_grad():
        if group is None:
            logits = model(preprocess_input(x, model))["out"]
        else:
            with spatial.row_sharded(group, *x.shape[2:4]):
                logits = model(preprocess_input(
                    spatial.cut_rows(group, x, 2), model))["out"]
            logits = spatial.gather_rows(logits, group, dim=1)
    saved["logits"] = logits.float().cpu()
    if group is None or group.is_main:
        torch.save(saved, out + ".pt")
    return res


def sp_gaps(got: dict, ref: dict, start: dict) -> dict:
    """||got - ref|| / ||ref - start|| over each parameter group and over
    all parameters."""
    def sq(a, b):
        return float((a.double() - b.double()).pow(2).sum())

    out = {}
    for group, prefixes in list(SP_GROUPS.items()) + [("all", ("",))]:
        names = [n for n in ref if n.startswith(prefixes)]
        out[group] = (sum(sq(got[n], ref[n]) for n in names)
                      / max(sum(sq(ref[n], start[n]) for n in names),
                            1e-300)) ** 0.5
    return out


def _sp_cli(tmpdir: str, data: str, name: str, flags) -> dict:
    """One cli/train run (bf16, B=TRAIN_BATCH, crop 224, one epoch with
    evaluation) with `flags`: its result, the ranks' s / it of the
    epoch, and its wall time."""
    import re

    out = os.path.join(tmpdir, f"{name}.json")
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-c", SP_CLI_CHILD, out, "--data-path", data,
           "--model", "stflstm", "--amp", "true", "--use-subtraction",
           *flags, "--batch-size", str(TRAIN_BATCH), "--epochs", "1",
           "--eval-batch-size", str(SP_BATCH),
           "--data-base-size", str(TRAIN_SRC),
           "--data-crop-size", str(TRAIN_CROP),
           "--save-dir", os.path.join(tmpdir, f"weights_{name}"),
           "--output-dir", os.path.join(tmpdir, f"out_{name}"),
           "--print-freq", "1"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=here, capture_output=True, text=True,
                          timeout=DP_CHILD_TIMEOUT)
    wall = time.perf_counter() - t0
    print(proc.stdout[-3000:], flush=True)
    check(proc.returncode == 0, f"cli/train {flags} failed: "
                                f"{proc.stderr[-3000:]}{proc.stdout[-3000:]}")
    with open(out) as f:
        run = json.load(f)
    losses = [e["train_loss"] for e in run["epochs"]]
    check(all(np.isfinite(losses)) and np.isfinite(run["test_dice"]),
          f"cli/train {flags}: losses {losses}")
    return {"flags": flags, "steps": run["steps"], "losses": losses,
            "test_dice": run["test_dice"],
            "ms_per_step_by_rank": [float(v) * 1e3 for v in re.findall(
                r"Epoch: \[0\] Total time: \S+ \(([0-9.]+) s / it\)",
                proc.stdout)],
            "peak_memory_mb_by_rank": run["peak_memory_mb_by_rank"],
            "wall_s": wall}


def spatial_cards_run(tmpdir: str, data: str) -> dict:
    """(b): cli/train --spatial-parallel 2 under NCCL over the visible
    GPUs (2 x 2 with four, 1 x 2 with two or three), one epoch, beside
    the same run on one GPU."""
    import torch

    count = torch.cuda.device_count()
    if count < 2:
        return {"spatial_parallel_cards": "skipped: 1 GPU"}
    n_data = 2 if count >= 4 else 1
    return {"spatial_parallel_cards": {
        "gpus": count, "mesh": f"{n_data}x2", "batch": TRAIN_BATCH,
        "spatial": _sp_cli(tmpdir, data, "sp_cards", [
            "--spatial-parallel", "2", "--data-parallel", str(n_data)]),
        "one_gpu": _sp_cli(tmpdir, data, "sp_one", [
            "--data-parallel", "1"])}}


def spatial_parallel_phase(tmpdir: str, data: str) -> dict:
    """23. (a) and (b) above. Returns the launch counts of (a)'s two
    ranks' steps."""
    import torch

    from stf_unet_tpu_torch.core.distributed import free_port

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.empty_cache()
    port = str(free_port())
    outs = [os.path.join(tmpdir, f"sp_rank{r}") for r in range(2)]
    _run_children([[sys.executable, "-c", SP_CHILD, data, outs[r], str(r),
                    "2", port] for r in range(2)], here)
    solo = os.path.join(tmpdir, "sp_solo")
    _run_children([[sys.executable, "-c", SP_CHILD, data, solo, "0", "1",
                    "0"]], here)
    line = sp_compare(outs, solo)
    cards = spatial_cards_run(tmpdir, data)
    print(json.dumps({**cards, "phase_wall_s":
                      time.perf_counter() - t_phase}), flush=True)
    return {name: sum(c.get(name, 0) for c in line["launches_by_rank"])
            for name in counters()}


def sp_compare(outs, solo: str) -> dict:
    """(a)'s checks: the two ranks' results (files `outs`) against the one
    process's (`solo`). Prints the line and returns it."""
    import torch

    ranks = []
    for o in outs:
        with open(o + ".json") as f:
            ranks.append(json.load(f))
    with open(solo + ".json") as f:
        one = json.load(f)
    got = torch.load(outs[0] + ".pt", weights_only=True)
    ref = torch.load(solo + ".pt", weights_only=True)
    start = ref["start"]
    check(all(torch.equal(got["start"][n], w) for n, w in start.items()),
          "the ranks started from other weights")
    gaps = {kind: sp_gaps(got[kind], ref[kind], start)
            for kind in ("f32", "bf16")}
    gaps["no_halo_control"] = sp_gaps(got["no_halo"], ref["f32"], start)
    gaps["bf16_1proc_vs_f32_1proc"] = sp_gaps(ref["bf16"], ref["f32"],
                                              start)
    loss_rel = {kind: abs(ranks[0][kind]["loss"] - one[kind]["loss"])
                / abs(one[kind]["loss"]) for kind in ("f32", "bf16")}
    logits, want = got["logits"], ref["logits"]
    logit_rel = float((logits - want).abs().max() / want.abs().max())
    masks = _margin_check("spatial eval forward", want,
                          want.argmax(-1).numpy(),
                          logits.argmax(-1).numpy())
    memory = {"rank_activation_mb": [r["bf16"]["activation_mb"]
                                     for r in ranks],
              "one_process_activation_mb": one["bf16"]["activation_mb"],
              "rank_peak_mb": [r["bf16"]["peak_mb"] for r in ranks],
              "one_process_peak_mb": one["bf16"]["peak_mb"]}
    memory["activation_ratio"] = [m / memory["one_process_activation_mb"]
                                  for m in memory["rank_activation_mb"]]
    memory["peak_ratio"] = [m / memory["one_process_peak_mb"]
                            for m in memory["rank_peak_mb"]]
    line = {
        "mesh": "1x2 (gloo, both ranks on cuda:0)", "batch": SP_BATCH,
        "crop": TRAIN_CROP, "loss": {k: {"2ranks": ranks[0][k]["loss"],
                                         "1proc": one[k]["loss"],
                                         "rel": loss_rel[k]}
                                     for k in ("f32", "bf16")},
        "update_rel_l2": gaps, "eval_logits_rel": logit_rel,
        "eval_masks": masks, "memory": memory,
        "step_ms": {"2ranks": [r["step_ms"] for r in ranks],
                    "1proc": one["step_ms"],
                    "note": "bf16; the two ranks share the one card"},
        "space_comm": [r["comm"] for r in ranks],
        "launches_by_rank": [r["bf16"]["launches"] for r in ranks],
        "tolerance": {"loss_rtol": SP_LOSS_RTOL,
                      "update_rtol_f32": SP_UPDATE_RTOL,
                      "update_bf16": "2 x bf16-vs-f32 or "
                                     f"{SP_BF16_FLOOR}",
                      "logit_rel": SP_LOGIT_REL}}
    print(json.dumps({"spatial_parallel": line}), flush=True)
    for kind, tol in SP_LOSS_RTOL.items():
        check(loss_rel[kind] <= tol, f"{kind} loss {loss_rel[kind]:.3g} "
                                     f"relative from one process ({tol})")
    for group in SP_GROUPS:
        f32 = gaps["f32"][group]
        check(f32 <= SP_UPDATE_RTOL, f"f32 {group}: parameters {f32:.3g} "
                                     f"of the update from one process")
        bound = max(2 * gaps["bf16_1proc_vs_f32_1proc"][group],
                    SP_BF16_FLOOR)
        check(gaps["bf16"][group] <= bound,
              f"bf16 {group}: {gaps['bf16'][group]:.3g} of the update from "
              f"one process (bound {bound:.3g})")
    control = gaps["no_halo_control"]["all"]
    check(control > SP_UPDATE_RTOL, f"ranks without halos came "
                                     f"{control:.3g} of the update from one "
                                     f"process, within the bound")
    check(logit_rel <= SP_LOGIT_REL, f"sharded eval logits {logit_rel:.3g} "
                                     f"of max |logit| from one process")
    for r, counts in enumerate(line["launches_by_rank"]):
        for name in ("lstm_last_x", "lstm_last_x_bwd", "warp"):
            check(counts[name] > 0, f"{name} never launched on rank {r}")
    return line


# Phase 24: the trainer's diagnostics and the model tools. (a) one f32 step
# (B = DIAG_F32_BATCH) of the full-width STF model with and without
# --model-remat from the same weights and augmented batch, cuDNN
# deterministic: the loss within DIAG_LOSS_RTOL and every gradient within
# DIAG_GRAD_RTOL of the tensor's max |gradient| (the recompute runs the
# same kernels on the same inputs, but the f32 step is not reproducible to
# 1e-5 on the card: the bilinear head's and the max pool's backwards
# accumulate with atomics, and the same no-remat step run twice differed by
# 1.6e-5 to 2.0e-5 of a tensor's max on an H100; a faulty recompute is off
# by orders of magnitude more), every BN buffer equal after the step (the recompute must not update
# them a second time); then bf16 steps at TRAIN_BATCH with and
# without remat: peak memory (remat must lower it) and ms per step by
# events, with the host's ms per step split between dispatch and the
# previous loss's .item() (cli/train's pattern, unprofiled). (b) cli/train
# with the diagnostics flags for one epoch, its
# torch.profiler trace's kernel events by port kernel against the
# wrappers' launch counters over the same window. (c) a NaN weight under
# --nan-check: FloatingPointError naming the module. (d) cli.val on phase
# 6's best checkpoint, against cli/test on the
# same split: val's IoU / Dice (per-sample foreground, thresholded logit
# margin) against the same function of cli/test's logits within
# VAL_DICE_TOL, and the confusion matrices. (e) cli.export --check at a
# symbolic batch on the card: the artifact against the kernel-path eager
# forward within EXPORT_REL_TOL of max |logit| (f32), launching no port
# kernel. (f) cli.migrate --reverse then forward: phase 6's checkpoint back
# bit for bit; cli.average of its latest and best served once by
# cli/serve.
DIAG_F32_BATCH = 4
DIAG_LOSS_RTOL = 1e-5
DIAG_GRAD_RTOL = 1e-4
DIAG_TIMED = 5
VAL_DICE_TOL = 1e-3
EXPORT_REL_TOL = 1e-4
EXPORT_TIMED_BATCH = 8
# the trace's kernel symbols of each port kernel (csrc/*.cu, namespace stf)
TRACE_SYMBOLS = {"lstm_last_x": ("stf::lstm_last_x_kernel",
                                 "stf::lstm_last_x_tc_kernel"),
                 "lstm_last_x_bwd": ("stf::lstm_bwd_tile_kernel",
                                     "stf::lstm_bwd_tile_tc_kernel"),
                 "warp": ("stf::warp_kernel",),
                 "lstm_last": ("stf::lstm_last_kernel",
                               "stf::lstm_last_tc_kernel"),
                 "batch_norm_forward": ("stf::bn_stats_kernel",
                                        "stf::bn_finish_kernel",
                                        "stf::bn_apply_kernel"),
                 "batch_norm_backward": ("stf::bn_bwd_reduce_kernel",
                                         "stf::bn_bwd_finish_kernel",
                                         "stf::bn_bwd_dx_kernel")}


def remat_phase(data: str, device: str = "cuda") -> dict:
    """(a): returns the launch counts of its steps."""
    import torch

    from stf_unet_tpu_torch.core.prng import augment_generator
    from stf_unet_tpu_torch.train.loop import loss_and_grads, train_step

    dev = torch.device(device)
    settings = (torch.backends.cudnn.deterministic,
                torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    kernels = reset_counts()
    runs, batch = [], None
    try:
        for remat in (False, True):
            state, augment, host = train_objects(data, torch.float32, device,
                                                 DIAG_F32_BATCH)
            state.model.remat = remat
            if batch is None:  # one augmented batch for every model
                batch = augment(augment_generator(0, 0, 0),
                                torch.from_numpy(host.frames).to(dev),
                                torch.from_numpy(host.masks).to(dev),
                                host.sizes)
            loss = loss_and_grads(state.model, *batch, 2)
            runs.append((loss.item(),
                         {n: p.grad.detach().clone()
                          for n, p in state.model.named_parameters()},
                         {n: b.detach().clone()
                          for n, b in state.model.named_buffers()}))
            del state
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = settings
    launches = _launches(kernels)
    (loss0, grads0, bufs0), (loss1, grads1, bufs1) = runs
    errs = {n: float((grads1[n] - g).abs().max())
            / max(float(g.abs().max()), 1e-30) for n, g in grads0.items()}
    grad_worst = max(errs, key=errs.get)
    grad_err = errs[grad_worst]
    bufs_equal = all(torch.equal(bufs1[n], b) for n, b in bufs0.items())
    print(json.dumps({"diagnostics_remat_f32": {
        "loss": [loss0, loss1], "grad_max_rel_err": grad_err,
        "worst": grad_worst, "bn_buffers_equal": bufs_equal}}),
        flush=True)
    check(abs(loss1 - loss0) <= DIAG_LOSS_RTOL * abs(loss0),
          f"remat f32 loss {loss1} vs {loss0}")
    check(grad_err <= DIAG_GRAD_RTOL,
          f"remat f32 gradients differ by {grad_err:.3g} of {grad_worst}'s "
          "max")
    check(bufs_equal, "a BN buffer differs after a remat step (updated "
                      "twice?)")
    for name in ("lstm_last_x", "lstm_last_x_bwd", "warp") + BN_KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched in the "
                                  f"remat steps")

    memory, step_ms, host_split = {}, {}, {}
    for remat in (False, True, True, False):  # in turns
        state, augment, host = train_objects(data, torch.bfloat16, device,
                                             TRAIN_BATCH)
        state.model.remat = remat

        def step():
            return train_step(state, augment, host,
                              augment_generator(0, 0, 0), lambda s: 1e-3,
                              2, dev)[0]

        for _ in range(2):
            step()
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(DIAG_TIMED):
            loss = step()
        end.record()
        check(math.isfinite(loss.item()), "non-finite bf16 loss")
        key = "remat" if remat else "no_remat"
        if key not in host_split:
            host_split[key] = _host_split(step)
        step_ms.setdefault(key, []).append(start.elapsed_time(end)
                                           / DIAG_TIMED)
        memory[key] = {
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 2**30,
            "peak_above_state_gb": (torch.cuda.max_memory_allocated(dev)
                                    - base) / 2**30}
        del state, step
        torch.cuda.empty_cache()
    check(memory["remat"]["peak_gb"] < memory["no_remat"]["peak_gb"],
          f"remat did not lower the step's peak memory: {memory}")
    print(json.dumps({"diagnostics_remat": {
        "card": card_line(), "f32_batch": DIAG_F32_BATCH,
        "f32_loss": [loss0, loss1], "f32_grad_max_rel_err": grad_err,
        "bn_buffers_equal": bufs_equal, "bf16_batch": TRAIN_BATCH,
        "memory": memory, "ms_per_step": step_ms,
        "host_ms_per_step": host_split, "launches": launches}}), flush=True)
    return launches


def _host_split(step, steps: int = DIAG_TIMED) -> dict:
    """Host ms per step of cli/train's pattern (the loss of step s read
    while step s+1 runs), unprofiled: in train_step's dispatch and in the
    .item() wait for the previous step's loss."""
    pending, dispatch, wait = step(), 0.0, 0.0
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = step()
        t1 = time.perf_counter()
        pending.item()
        wait += time.perf_counter() - t1
        dispatch += t1 - t0
        pending = loss
    pending.item()
    return {"dispatch": dispatch * 1e3 / steps,
            "item_wait": wait * 1e3 / steps}


def _trace_summary(path: str) -> dict:
    """Kernel events of the port's kernels and the summed host time of
    each annotated region in a torch.profiler Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {name: 0 for name in TRACE_SYMBOLS}
    regions, busy, span = {}, 0.0, [float("inf"), 0.0]
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat == "kernel":
            busy += e.get("dur", 0.0)
            span = [min(span[0], e["ts"]), max(span[1], e["ts"] + e["dur"])]
            for port, symbols in TRACE_SYMBOLS.items():
                if any(s in name for s in symbols):
                    kernels[port] += 1
        elif cat == "user_annotation":
            r = regions.setdefault(name, [0, 0.0])
            r[0] += 1
            r[1] += e.get("dur", 0.0) / 1e3
    return {"kernel_events": kernels, "kernel_busy_ms": busy / 1e3,
            "kernel_span_ms": (span[1] - span[0]) / 1e3 if busy else 0.0,
            "regions_ms": {k: {"count": v[0], "ms": v[1]}
                           for k, v in sorted(regions.items())}}


def train_flags_phase(tmpdir: str, data: str, device: str = "cuda"):
    """(b) and (c): returns the launch counts of the cli/train run."""
    import contextlib
    import shutil

    import torch

    from stf_unet_tpu_torch.cli import train as train_cli

    prof = os.path.join(tmpdir, "diag_trace")
    window = {}
    real_trace = train_cli.trace

    @contextlib.contextmanager
    def counted_trace(*args, **kwargs):
        """cli/train's trace, with the launch counters read at the end of
        the profiled window."""
        before = _launches(counters())
        with real_trace(*args, **kwargs) as path:
            yield path
            _sync(device)
            window.update({k: v - before[k] for k, v in
                           _launches(counters()).items()})

    argv = ["--data-path", data, "--model", "stflstm", "--amp", "true",
            "--use-subtraction", "--batch-size", str(TRAIN_BATCH),
            "--eval-batch-size", str(TRAIN_BATCH), "--seed", "0",
            "--data-base-size", str(TRAIN_SRC),
            "--data-crop-size", str(TRAIN_CROP), "--print-freq", "1",
            "--device", device]
    kernels = reset_counts()
    train_cli.trace = counted_trace
    t0 = time.perf_counter()
    try:
        result = train_cli.run(argv + [
            "--epochs", "1", "--model-remat", "true", "--profile-dir", prof,
            "--matmul-precision", "high", "--aux",
            "--save-dir", os.path.join(tmpdir, "weights_diag"),
            "--output-dir", os.path.join(tmpdir, "out_diag")])
    finally:
        train_cli.trace = real_trace
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    wall = time.perf_counter() - t0
    launches = _launches(kernels)
    losses = [e["train_loss"] for e in result["epochs"]]
    check(all(math.isfinite(v) for v in losses), f"non-finite loss under "
                                                 f"the diagnostics: {losses}")
    trace_file = result["trace_file"]
    check(trace_file is not None and os.path.isfile(trace_file),
          f"no trace file: {trace_file}")
    summary = _trace_summary(trace_file)
    for name in ("lstm_last_x", "lstm_last_x_bwd", "warp") + BN_KERNELS:
        check(summary["kernel_events"][name] > 0,
              f"the trace holds no {name} kernel event")
    trace_vs_counter = {name: {"trace_events": summary["kernel_events"][name],
                               "counter": window.get(name)}
                        for name in TRACE_SYMBOLS}

    # (c) a NaN weight under --nan-check, resumed from a copy of (b)'s run
    nan_dir = os.path.join(tmpdir, "weights_nan")
    os.makedirs(nan_dir)
    src = os.path.join(tmpdir, "weights_diag", "stflstm_latest_model.pth")
    ckpt = torch.load(src, map_location="cpu", weights_only=True)
    ckpt["model"]["layer3.1.conv2.weight"][0, 0, 0, 0] = float("nan")
    torch.save(ckpt, os.path.join(nan_dir, "stflstm_latest_model.pth"))
    raised = None
    try:
        train_cli.run(argv + ["--epochs", "2", "--nan-check",
                              "--resume", "latest", "--save-dir", nan_dir,
                              "--output-dir", os.path.join(tmpdir,
                                                           "out_nan")])
    except FloatingPointError as e:
        raised = str(e)
    shutil.rmtree(nan_dir)
    check(raised is not None and "module" in raised,
          f"--nan-check did not raise FloatingPointError naming a module "
          f"({raised!r})")
    print(json.dumps({"diagnostics_train": {
        "card": card_line(), "wall_s": wall, "losses": losses,
        "trace_bytes": os.path.getsize(trace_file),
        "trace_vs_counter": trace_vs_counter,
        "trace_kernel_busy_ms": summary["kernel_busy_ms"],
        "trace_kernel_span_ms": summary["kernel_span_ms"],
        "regions_ms": summary["regions_ms"], "nan_check": raised,
        "launches": launches}}), flush=True)
    return launches


def val_phase(tmpdir: str, data: str, weights: str, device: str = "cuda"):
    """(d): returns the launch counts of cli.val."""
    from stf_unet_tpu_torch.cli import test as cli_test
    from stf_unet_tpu_torch.cli import val as cli_val
    from stf_unet_tpu_torch.metrics.binary import iou_score

    config = os.path.join(tmpdir, "val", "config.yml")
    cwd = os.getcwd()
    os.makedirs(os.path.dirname(config))
    os.chdir(os.path.dirname(config))
    try:
        cli_val.load_or_create_config(config)  # writes the defaults
        with open(config, "a") as f:
            f.write("# the synthetic tree's subtraction frames\n")
        text = open(config).read().replace(
            "use_subtraction: false", "use_subtraction: true").replace(
            "crop_size: 224", f"crop_size: {TRAIN_CROP}")
        with open(config, "w") as f:
            f.write(text)
        kernels = reset_counts()
        t0 = time.perf_counter()
        got = cli_val.main(["--model-path", weights, "--root", data,
                            "--config", config, "--split", "test",
                            "--data-parallel", "0", "--dtype", "bf16",
                            "--device", device])
        wall = time.perf_counter() - t0
        launches = _launches(kernels)
    finally:
        os.chdir(cwd)
    masks = len(os.listdir(os.path.join(tmpdir, "val", "outputs",
                                        "validation", "0")))
    ref = cli_test.main(["--model", "stflstm", "--model-dir", weights,
                         "--root", data, "--use-subtraction", "--dtype",
                         "bf16", "--device", device, "--output-dir",
                         os.path.join(tmpdir, "val_cli_test")])
    scores = [iou_score(lg[..., 1] - lg[..., 0], tgt == 1)
              for lg, (_, tgt) in zip(ref["outputs"], ref["batches"])]
    ref_iou = float(np.mean([s[0] for s in scores]))
    ref_dice = float(np.mean([s[1] for s in scores]))
    conf_diff = int(np.abs(got["confusion_matrix"]
                           - ref["confusion_matrix"]).sum() // 2)
    pixels = int(ref["confusion_matrix"].sum())
    check(abs(got["dice"] - ref_dice) <= VAL_DICE_TOL,
          f"cli.val dice {got['dice']} vs cli/test's logits {ref_dice}")
    check(abs(got["iou"] - ref_iou) <= VAL_DICE_TOL,
          f"cli.val IoU {got['iou']} vs cli/test's logits {ref_iou}")
    check(conf_diff <= VAL_DICE_TOL * pixels,
          f"cli.val's confusion matrix differs from cli/test's in "
          f"{conf_diff} of {pixels} pixels")
    check(masks == len(scores), f"cli.val wrote {masks} masks for "
                                f"{len(scores)} slices")
    for name in ("lstm_last_x", "lstm_last"):
        check(launches[name] > 0, f"kernel {name} never launched in cli.val")
    print(json.dumps({"cli_val": {
        "card": card_line(), "slices": len(scores), "iou": got["iou"],
        "dice": got["dice"], "cli_test_logits_iou": ref_iou,
        "cli_test_logits_dice": ref_dice, "cli_test_dice": ref["dice"],
        "confusion_pixels_moved": conf_diff,
        "device_ms_per_batch": got["device_time"] * 1e3,
        "wall_s": wall, "launches": launches}}), flush=True)
    return launches


def export_phase(tmpdir: str, weights: str, device: str = "cuda"):
    """(e): returns the launch counts of the kernel-path forward (the
    artifact's must be none)."""
    import torch

    from stf_unet_tpu_torch.cli import export as cli_export
    from stf_unet_tpu_torch.cli.common import restore_for_inference

    out = os.path.join(tmpdir, "stflstm.pt2")
    t0 = time.perf_counter()
    cli_export.main(["--model", "stflstm", "--model-dir", weights,
                     "--use-subtraction", "--crop-size", str(CROP),
                     "--batch", "0", "--check", "--output", out,
                     "--device", device])
    export_s = time.perf_counter() - t0
    sidecar = json.load(open(out + ".json"))
    program = torch.export.load(out).module()
    eager, _, _, _ = restore_for_inference(
        "stflstm", os.path.join(weights, "stflstm_best_model.pth"),
        use_subtraction=True, dtype="f32", device=device)
    rng = np.random.default_rng(6)
    errs, ms = {}, {}
    for b in (1, 3, EXPORT_TIMED_BATCH):
        x = torch.from_numpy(rng.normal(size=(b, T_STEPS, CROP, CROP, 1))
                             .astype(np.float32)).to(device)
        with torch.no_grad():
            kernels = reset_counts()
            got = program(x)
            _sync(device)
            artifact_launches = _launches(kernels)
            kernels = reset_counts()
            want = eager(x)["out"]
            _sync(device)
            eager_launches = _launches(kernels)
            if b == EXPORT_TIMED_BATCH:
                ms = {"artifact_plain_path": cuda_ms(lambda: program(x), 10),
                      "eager_kernel_path": cuda_ms(lambda: eager(x), 10)}
        errs[b] = float((got - want).abs().max() / want.abs().max())
        check(tuple(got.shape) == (b, CROP, CROP, 2),
              f"artifact output {tuple(got.shape)} at batch {b}")
        check(errs[b] <= EXPORT_REL_TOL, f"artifact vs kernel-path eager at "
                                         f"batch {b}: {errs[b]:.3g}")
        check(not any(artifact_launches.values()),
              f"the artifact launched port kernels: {artifact_launches}")
        for name in ("lstm_last_x", "lstm_last"):
            check(eager_launches[name] > 0, f"kernel {name} never launched "
                                            f"by the eager forward")
    print(json.dumps({"cli_export": {
        "card": card_line(), "export_and_check_s": export_s,
        "sidecar": sidecar, "max_rel_err_by_batch": errs,
        "ms_b8": ms, "artifact_launches": artifact_launches,
        "eager_launches_b8": eager_launches}}), flush=True)
    return eager_launches


def ckpt_tools_phase(tmpdir: str, weights: str, device: str = "cuda"):
    """(f): returns the launch counts of the served request."""
    import shutil

    import torch

    from stf_unet_tpu_torch.cli import average as cli_average
    from stf_unet_tpu_torch.cli import migrate as cli_migrate
    from stf_unet_tpu_torch.cli.serve import build_server, parse_args
    from stf_unet_tpu_torch.serve.client import SegmentationClient

    t0 = time.perf_counter()
    ref = os.path.join(tmpdir, "reference.pth")
    cli_migrate.main([ref, "--reverse", "--model", "stflstm",
                      "--save-dir", weights])
    back = os.path.join(tmpdir, "weights_migrated")
    cli_migrate.main([ref, "--model", "stflstm", "--save-dir", back])
    orig = torch.load(os.path.join(weights, "stflstm_best_model.pth"),
                      weights_only=True)
    again = torch.load(os.path.join(back, "stflstm_best_model.pth"),
                       weights_only=True)
    same = (orig["model"].keys() == again["model"].keys() and all(
        torch.equal(again["model"][k], v) for k, v in orig["model"].items()))
    check(same, "migrate --reverse then forward did not give phase 6's "
                "weights back bit for bit")
    check(again["epoch"] == orig["epoch"], "the epoch did not round-trip")
    avg_dir = os.path.join(tmpdir, "weights_avg")
    cli_average.main(["--model", "stflstm", "--save-dir", weights,
                      "--kinds", "latest,best", "--out-dir", avg_dir])
    server = build_server(parse_args(
        ["--model", "stflstm", "--model-dir", avg_dir, "--use-subtraction",
         "--port", "0", "--dtype", "bf16", "--no-warmup", "--device",
         device]))
    server.start()
    try:
        client = SegmentationClient("http://%s:%d" % server.address,
                                    timeout=300)
        kernels = reset_counts()
        frames = np.random.default_rng(8).integers(
            0, 256, (T_STEPS, CROP, CROP), dtype=np.uint8)
        mask = client.segment(frames)  # raises unless the answer is 200
        _sync(device)
        launches = _launches(kernels)
    finally:
        server.stop()
    check(mask.shape == (CROP, CROP), f"averaged model's mask {mask.shape}")
    for name in ("lstm_last_x", "lstm_last"):
        check(launches[name] > 0, f"kernel {name} never launched serving "
                                  f"the average")
    shutil.rmtree(back)
    print(json.dumps({"ckpt_tools": {
        "migrate_round_trip_bit_equal": same, "tensors": len(orig["model"]),
        "average_served": 200, "wall_s": time.perf_counter() - t0,
        "launches": launches}}), flush=True)
    return launches


def diagnostics_phase(tmpdir: str, data: str, weights: str) -> dict:
    """Phase 24: (a) - (f) above. Returns the launch counts, summed."""
    t0 = time.perf_counter()
    total = {name: 0 for name in counters()}
    for launches in (remat_phase(data), train_flags_phase(tmpdir, data),
                     val_phase(tmpdir, data, weights),
                     export_phase(tmpdir, weights),
                     ckpt_tools_phase(tmpdir, weights)):
        for name, n in launches.items():
            total[name] += n
    print(json.dumps({"diagnostics": {
        "phase_wall_s": time.perf_counter() - t0, "launches": total}}),
        flush=True)
    return total


# Phase 25: utils/benchkit's helpers at their own sizes with few
# iterations (BENCH_ITERS, the median of BENCH_REPS windows), and cli.plot
# on phase 6's logs. The packed val epoch alone runs on a smaller tree
# (BENCH_VAL_SAMPLES) than the two-batch-size one (benchkit's default 64).
BENCH_ITERS = 5
BENCH_REPS = 2
BENCH_VAL_SAMPLES = 16
BENCH_KERNELS = ("lstm_last_x", "lstm_last_x_bwd", "warp", "lstm_last",
                 "quant_patches", "quant_epilogue")


def _positive_numbers(label: str, value) -> None:
    if isinstance(value, dict):
        for k, v in value.items():
            _positive_numbers(f"{label}.{k}", v)
        return
    check(isinstance(value, (int, float)) and math.isfinite(value)
          and value > 0, f"benchkit {label} = {value!r}, expected a "
                         f"finite number > 0")


def benchkit_phase(tmpdir: str, train_result: dict,
                   device: str = "cuda") -> dict:
    """25. (a) and (b) above. Returns the launch counts of (a)."""
    from stf_unet_tpu_torch.cli import plot as cli_plot
    from stf_unet_tpu_torch.core.config import ModelConfig
    from stf_unet_tpu_torch.utils import benchkit as bk

    t_phase = time.perf_counter()
    card = card_line()
    timing = {"iters": BENCH_ITERS, "timed_reps": BENCH_REPS,
              "device": device}
    runs = (
        ("measure_train_step unet bf16",
         lambda: bk.measure_train_step("unet", True, **timing)),
        ("measure_train_step stflstm bf16",
         lambda: bk.measure_train_step("stflstm", True, **timing)),
        ("measure_fused_train unet", lambda: bk.measure_fused_train(
            model_name="unet", **timing)),
        ("measure_fused_rotsplit unet", lambda: bk.measure_fused_rotsplit(
            model_name="unet", **timing)),
        ("measure_serving_both stflstm",
         lambda: bk.measure_serving_both("stflstm", **timing)),
        ("measure_serving stflstm int8",
         lambda: bk.measure_serving("stflstm", int8=True, **timing)),
        ("measure_val_epoch_packed_multi stflstm",
         lambda: bk.measure_val_epoch_packed_multi(
             "stflstm", batch_sizes=(1, 8), timed_reps=BENCH_REPS,
             device=device)),
        ("measure_val_epoch_packed stflstm",
         lambda: bk.measure_val_epoch_packed(
             "stflstm", n_samples=BENCH_VAL_SAMPLES, batch_size=1,
             timed_reps=BENCH_REPS, device=device)),
    )
    kernels = reset_counts()
    results = {}
    for label, run in runs:
        t0 = time.perf_counter()
        results[label] = run()
        _positive_numbers(label, results[label])
        print(json.dumps({"benchkit": {
            "call": label, "card": card, "result": results[label],
            "wall_s": time.perf_counter() - t0}}), flush=True)
    launches = _launches(kernels)
    for name in BENCH_KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched by the "
                                  f"benchkit helpers")
    unet = results["measure_train_step unet bf16"]
    flop = bk.step_flops(ModelConfig(model="unet", num_classes=1,
                                     time_steps=T_STEPS), TRAIN_BATCH, CROP)
    check(abs(flop - UNET_STEP_FLOP) <= 1e-3 * UNET_STEP_FLOP,
          f"benchkit's UNet step FLOPs {flop:.6g}, expected "
          f"{UNET_STEP_FLOP:.6g}")
    implied = unet["tflops"] * 1e12 * unet["ms_per_step"] * 1e-3
    check(abs(implied - flop) <= 1e-6 * flop,
          f"measure_train_step's tflops imply {implied:.6g} FLOPs a step, "
          f"its counter {flop:.6g}")

    # (b) cli.plot on phase 6's per-epoch logs
    logged = [e["epoch"] for e in train_result["epochs"]]
    logs = (train_result["metrics_file"], train_result["results_file"])
    for path in logs:
        got = cli_plot.parse_run(path)["epoch"]
        check(got == logged, f"cli.plot.parse_run({os.path.basename(path)})"
                             f" gave epochs {got}, the run logged {logged}")
    plots = {}
    root = os.path.dirname(os.path.abspath(__file__))
    drawn = _have_matplotlib()
    for label, argv in (("single", [logs[1]]),
                        ("compare", list(logs) + ["--output", os.path.join(
                            tmpdir, "compare_curves.png")])):
        proc = subprocess.run(
            [sys.executable, "-m", "stf_unet_tpu_torch.cli.plot", *argv],
            cwd=root, capture_output=True, text=True, timeout=300)
        if drawn:
            written = [line[len("wrote "):] for line in
                       proc.stdout.splitlines() if line.startswith("wrote ")]
            check(proc.returncode == 0 and written
                  and all(os.path.getsize(w) > 0 for w in written),
                  f"cli.plot {label}: rc {proc.returncode}, "
                  f"{proc.stderr.strip()[-300:]}")
            plots[label] = {"rc": 0, "png": written}
        else:
            message = proc.stderr.strip().splitlines()[-1:] or [""]
            check(proc.returncode != 0 and "matplotlib" in message[0],
                  f"cli.plot {label} without matplotlib: rc "
                  f"{proc.returncode}, {proc.stderr.strip()[-300:]}")
            plots[label] = {"rc": proc.returncode, "message": message[0]}
    print(json.dumps({"benchkit_phase": {
        "card": card, "unet_step_flop": flop,
        "unet_step_flop_expected": UNET_STEP_FLOP,
        "plot_epochs": logged, "matplotlib": drawn, "cli_plot": plots,
        "launches": launches,
        "phase_wall_s": time.perf_counter() - t_phase}}), flush=True)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels only (no timing, "
                         "no serving); prints no result line")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False; chip_smoke.py "
              "needs a CUDA GPU", file=sys.stderr)
        return 1
    try:
        from stf_unet_tpu_torch.ops.kernels import build
    except ImportError as e:
        print(f"error: the stf_unet_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 1

    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.build()
    print(f"kernels built in {time.perf_counter() - t0:.3f} s", flush=True)
    for name, info in build.build_info.items():
        print(f"--- nvcc {name} ({info['seconds']:.3f} s) ---\n"
              f"{info['log'].strip()}", flush=True)

    device = torch.device("cuda")
    jobs = []  # torch.profiler windows, run once every event timing is done
    agg, recheck = kernel_phase(device, args.quick, jobs)
    agg["lstm_last_x_bwd"] = lstm_bwd_phase(device, args.quick, jobs)
    agg["warp"] = warp_phase(device, args.quick, jobs)
    agg["tofts_sums"] = tofts_phase(device, args.quick, jobs)
    agg.update(quant_phase(device, args.quick))
    bn_summary = bn_phase(device, args.quick)
    if args.quick:
        print("quick: kernels build and agree with their plain versions")
        return 0
    routing_phase(device, jobs)
    profiled_pass(jobs)
    recheck()
    with tempfile.TemporaryDirectory() as tmpdir:
        server, frames, serve_launches = serving_phase(tmpdir)
        weights_sd = torch.load(os.path.join(tmpdir, "stflstm_seed0.pth"),
                                weights_only=True)["model"]
    breakdown_phase(server, frames)
    path_phase(server, frames, weights_sd)
    del server, weights_sd
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmpdir:
        data = write_tree(tmpdir)
        train_launches, train_result = training_phase(tmpdir, data)
        step_phase(data)
        train_path_phase(data)
        torch.cuda.empty_cache()
        # the vanilla UNet: training, steps, parity; then cli/test on both
        # models' best checkpoints
        unet_launches, unet_result, unet_weights = unet_training_phase(
            tmpdir, data)
        step_phase(data, model_name="unet")
        unet_parity_phase(unet_weights, data)
        cli_launches = cli_test_phase(tmpdir, data, [
            ("stflstm", os.path.join(tmpdir, "weights"),
             train_result["test"]["dice"]),
            ("unet", unet_weights, unet_result["test"]["dice"])])
        torch.cuda.empty_cache()
        # the PK path: maps, then training and serving on them
        pk_runs = [pk_maps_phase(data)]
        launches, best = pk_training_phase(tmpdir, data)
        pk_runs += [launches, pk_serving_phase(best)]
        step_phase(data, pk=True)
        torch.cuda.empty_cache()
        # the training leftovers: packs, extras, EMA, accumulation,
        # preemption, the RAM cache, autobatch
        extras_launches = train_extras_phase(tmpdir, data)
        torch.cuda.empty_cache()
        # the labels-free deployment path on phase 6's checkpoint
        stf_weights = os.path.join(tmpdir, "weights")
        deploy = {
            "pk_enhanced": pk_enhanced_phase(tmpdir, data),
            "predict": predict_phase(tmpdir, data, stf_weights),
            "pipeline": pipeline_phase(tmpdir, data, stf_weights),
            "serve_dir": serve_dir_phase(
                stf_weights, os.path.join(tmpdir, "weights_extras",
                                          "stflstm_latest_model.pth"),
                best)}
        torch.cuda.empty_cache()
        # int8 post-training quantization: cli.quantize, the forwards,
        # cli/serve --dtype int8
        deploy["int8"], int8_forwards = int8_phase(
            data, stf_weights, unet_weights,
            os.path.join(tmpdir, "weights_extras"))
        torch.cuda.empty_cache()
        # data parallelism: --multihost at world 1, two gloo ranks, DDP's
        # cost on one card
        deploy["data_parallel"] = data_parallel_phase(tmpdir, data)
        # data-parallel inference: --data-parallel 0 through the CLIs,
        # two replicas on the card against one device
        torch.cuda.empty_cache()
        deploy["data_parallel_inference"] = dp_inference_phase(
            tmpdir, data, stf_weights)
        # spatial parallelism: two gloo ranks on the card against one
        # process; cli/train over the GPUs where there are several
        torch.cuda.empty_cache()
        deploy["spatial_parallel"] = spatial_parallel_phase(tmpdir, data)
        # the trainer's diagnostics and the model tools on phase 6's
        # checkpoint
        torch.cuda.empty_cache()
        deploy["diagnostics"] = diagnostics_phase(tmpdir, data, stf_weights)
        # the measurement helpers on the card; cli.plot on phase 6's logs
        torch.cuda.empty_cache()
        deploy["benchkit"] = benchkit_phase(tmpdir, train_result)
    for name in ("quant_patches", "quant_epilogue"):
        agg[name]["device_ms"] = int8_forwards["stflstm"]["int8_split_b8"][
            f"{name}_ms"]
    pk_launches = {name: sum(run[name] for run in pk_runs)
                   for name in counters()}

    train_file = "stf_unet_tpu/ops/pallas/lstm_train_kernel.py"
    kernels = [
        {"name": "lstm_last_x", "route": "cuda",
         "source": "stf_unet_tpu_torch/csrc/lstm_last_x.cu",
         "replaces": f"{train_file}:106"},
        {"name": "lstm_last", "route": "cuda",
         "source": "stf_unet_tpu_torch/csrc/lstm_last.cu",
         "replaces": "stf_unet_tpu/ops/pallas/lstm_kernel.py:69"},
        {"name": "lstm_last_x_bwd", "route": "cuda",
         "source": "stf_unet_tpu_torch/csrc/lstm_last_x_bwd.cu",
         "replaces": f"{train_file}:330, {train_file}:382"},
        {"name": "warp", "route": "cuda",
         "source": "stf_unet_tpu_torch/csrc/warp.cu",
         "replaces": "stf_unet_tpu/ops/pallas/warp_kernel.py:204"},
        {"name": "tofts_sums", "route": "cuda",
         "source": "stf_unet_tpu_torch/csrc/tofts_sums.cu",
         "replaces": "stf_unet_tpu/ops/pallas/tofts_kernel.py:42"},
        {"name": "quant_patches", "route": "cuda",
         "source": "stf_unet_tpu_torch/csrc/quant_patches.cu",
         "replaces": "stf_unet_tpu/ops/quant.py:86 (XLA int8 conv; no "
                     "pallas_call)"},
        {"name": "quant_epilogue", "route": "cuda",
         "source": "stf_unet_tpu_torch/csrc/quant_epilogue.cu",
         "replaces": "stf_unet_tpu/ops/quant.py:97 (the XLA int8 conv's "
                     "f32 epilogue; no pallas_call)"},
    ]
    dtypes = {"warp": "uint8 in, f32 out", "tofts_sums": "f32",
              "quant_patches": "bf16 in, int8 out",
              "quant_epilogue": "int32 in, bf16 out"}
    paths = {"serve": serve_launches, "train": train_launches,
             "unet_train": unet_launches, "cli_test": cli_launches,
             "pk": pk_launches, "train_extras": extras_launches, **deploy}

    def by_path(*names):
        return {path: sum(counts[n] for n in names)
                for path, counts in paths.items()}

    for k in kernels:
        a = agg[k["name"]]
        counts = by_path(k["name"])
        k.update(launches=sum(counts.values()), launches_by_path=counts,
                 max_abs_err=a["max_abs_err"], ms=a["ms"],
                 plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
                 bound_by=a["bound_by"], library_ms=a["library_ms"],
                 shapes=a["shapes"], dtype=dtypes.get(k["name"], "bf16"))
        for extra in ("pk_shape", "extras", "tensor_cores", "device_ms",
                      "library_device_ms", "host_us", "rule2_leave_alone",
                      "per_forward"):
            if extra in a:
                k[extra] = a[extra]
    bn_paths = by_path(*BN_KERNELS)
    kernels.append({
        "name": "batch_norm", "route": "cuda",
        "source": "stf_unet_tpu_torch/csrc/batch_norm.cu",
        "replaces": "none (the JAX package leaves BatchNorm to XLA)",
        "launches": sum(bn_paths.values()), "launches_by_path": bn_paths,
        "dtype": "bf16 / f32 in and out, f32 statistics", **bn_summary})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        sys.exit(1)
