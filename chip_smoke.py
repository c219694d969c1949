#!/usr/bin/env python3
"""Drive the PyTorch port (stf_unet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each of which fails the run (non-zero exit, no result line):
  1. card: print the GPU's name and power limit; build the four CUDA
     kernels from csrc/ with nvcc, in parallel, and print the build seconds.
  2. kernels: each kernel against its plain PyTorch version on the card.
     K1 forward and K3 at every row count the serving and training paths
     give them (serving batch buckets 1, 2, 4, 8 and the training /
     evaluation batch 16, at crop 224, T=8); K1b (the LSTM backward)
     at the training shapes (C=64/N=50176, C=128/N=12544, a ragged N, one
     C=256 shape), all in bf16 and f32, and twice to show it is
     deterministic; K2 (the augmentation warp) at B=16, 256^2 -> 224^2.
     Timings of kernel, plain version and a library yardstick, and the
     training routing: one pixel LSTM's forward + backward through K1 + K1b
     and through the scan at each scale.
  3. serving: a seeded full-width STF-LSTM-UNet (ResNet-34, pixel LSTMs at
     C=64..512, T=8, crop 224, bf16) written as a reference-layout .pth,
     served through cli/serve.build_server on 127.0.0.1, answering
     concurrent /v1/segment requests from the port's client. Every kernel
     on the path must have launched during this phase.
  4. breakdown: host preprocessing per request, engine.predict per batch
     bucket, and a torch.profiler view of one B=8 forward (kernel time by
     name, the pixel-LSTM kernels' share, the device's idle share).
  5. kernel path against plain path: logits of one batch with the kernels
     ("auto") and with the plain LSTM loop ("scan").
  6. training: a synthetic BreaDM tree at 256^2 (64 training slices),
     cli/train at full width (bf16, batch 16, crop 224) for 3 epochs = 12
     steps with evaluation and latest/best checkpoints; every loss finite
     and every training kernel launched during this phase.
  7. steps: the loss of repeated steps on one fixed batch falls; ms per
     step, samples/s, the device's idle share and a torch.profiler view of
     one step.
  8. training path against plain path: one f32 step through the kernels
     and through the scan + plain warp; loss and every gradient.
Then a {"kernels": [...]} line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.

Exits non-zero without a CUDA device, and when the package is not beside
this script.
"""

from __future__ import annotations

import argparse
import json
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


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BPS
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_cases(gen, device):
    """(kernel name, C, N, dtype, inputs, kernel fn, plain fn) for every
    row count the serving and training paths give each kernel."""
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
                           lstm_last_x, lstm_last_x_plain)
                else:
                    xp = x @ w_ih  # the serving path's projection, rounded
                    yield ("lstm_last", c, n, dname, (xp, w_hh, b),
                           lstm_last, lstm_last_plain)


def kernel_phase(device, quick: bool):
    """Every kernel vs its plain version; timings at B=8 in both dtypes.
    Returns per-kernel aggregates over one B=8 bf16 serving forward (the
    kernels line's ms and bound for K1 forward and K3)."""
    import torch

    gen = torch.Generator().manual_seed(0)
    agg = {}
    for name, c, n, dname, args, kern, plain in kernel_cases(gen, device):
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
        if dname == "bf16":
            a["max_abs_err"] = max(a["max_abs_err"], err)
        if n == 8 * dict(SCALES)[c] ** 2 and not quick:
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
            if dname == "bf16":  # the serving dtype: one B=8 forward
                a["ms"] += line["kernel_ms"]
                a["plain_ms"] += line["plain_ms"]
                a["bound_ms"] += bms
                if lib_ms is not None:
                    a["library_ms"] = (a["library_ms"] or 0.0) + lib_ms
                a["bound_by"] = by
                a["shapes"].append({"C": c, "N": n, "T": t_steps})
        print(json.dumps(line), flush=True)
    return agg


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


def lstm_bwd_inputs(gen, c, n, dtype, device):
    import torch

    k = 1.0 / c ** 0.5
    w_ih, w_hh = ((torch.rand((c, 4 * c), generator=gen) * 2 - 1) * k
                  for _ in range(2))
    b = (torch.rand((4 * c,), generator=gen) * 2 - 1) * k
    x = torch.randn((T_STEPS, n, c), generator=gen)
    dh = torch.randn((n, c), generator=gen)
    return tuple(v.to(device, dtype) for v in (x, w_ih, w_hh, b, dh))


def lstm_bwd_phase(device, quick: bool):
    """K1b against its plain version at the training shapes, in bf16 and
    f32; determinism (two launches, bitwise); timings at the two training
    shapes in bf16, the training dtype. Returns the kernels-line entry."""
    import torch

    from stf_unet_tpu_torch.ops.kernels.lstm_last_x_bwd import (
        lstm_last_x_bwd, lstm_last_x_bwd_plain)

    gen = torch.Generator().manual_seed(1)
    agg = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
           "bound_by": None, "library_ms": None, "shapes": []}
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


def routing_phase(device):
    """Time pixel_lstm's two training backends at every scale: the
    measurement behind FUSED_TRAIN_MAX_C (printed, not checked)."""
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


def lstm_bwd_bytes(args) -> float:
    """Each input read once, each output written once: x, W_ih, W_hh, b, dh
    in their dtype; dx in x's dtype; dW_ih, dW_hh, db in f32."""
    x, w_ih, w_hh, b, dh = args
    t_steps, n, c = x.shape
    item = x.element_size()
    return (item * (2 * t_steps * n * c + 8 * c * c + 4 * c + n * c)
            + 4 * (8 * c * c + 4 * c))


def warp_inputs(device):
    """A training batch's warp inputs: random uint8 frames and a binary
    mask on a 256^2 canvas (some samples padded), and the source grids
    TrainAugment draws for them."""
    import torch

    from stf_unet_tpu_torch.core.config import DataConfig
    from stf_unet_tpu_torch.core.prng import augment_generator
    from stf_unet_tpu_torch.data.transforms import TrainAugment

    gen = torch.Generator().manual_seed(2)
    aug = TrainAugment(DataConfig())
    frames = torch.randint(0, 256, (WARP_B, T_STEPS, WARP_SRC, WARP_SRC),
                           generator=gen, dtype=torch.uint8)
    masks = torch.randint(0, 2, (WARP_B, WARP_SRC, WARP_SRC), generator=gen,
                          dtype=torch.uint8)
    sizes = torch.full((WARP_B, 2), WARP_SRC, dtype=torch.int32)
    sizes[::4] = torch.tensor([240, 224], dtype=torch.int32)
    gy, gx = aug.grids(augment_generator(0, 0, 0), sizes, device)
    stacked = torch.cat([frames, masks.unsqueeze(1)], 1).to(device)
    valid = sizes.to(device, torch.float32)
    return aug, stacked, gy, gx, valid


def warp_phase(device, quick: bool):
    """K2 against its plain version at the training shape; timings of
    kernel, plain version and F.grid_sample. Returns the kernels-line
    entry."""
    import torch

    from stf_unet_tpu_torch.ops.kernels.warp import warp, warp_plain

    aug, stacked, gy, gx, valid = warp_inputs(device)
    args = (stacked, gy, gx, valid, aug.alpha, aug.beta)
    bil, near = warp(*args)
    bil_p, near_p = warp_plain(*args)
    torch.cuda.synchronize()
    err = (bil - bil_p).abs().max().item()
    near_diff = int((near != near_p).sum().item())
    check(bool(torch.isfinite(bil).all()), "warp: non-finite output")
    check(near_diff == 0, f"warp: {near_diff} nearest (label) values "
                          f"differ from the plain version")
    check(err <= WARP_TOL, f"warp: bilinear max abs err {err} > {WARP_TOL}")
    line = {"kernel": "warp", "B": WARP_B, "Cs": stacked.shape[1],
            "src": WARP_SRC, "out": gy.shape[-1], "max_abs_err": err,
            "nearest_mismatches": near_diff, "tol": WARP_TOL}
    entry = {"max_abs_err": err, "ms": None, "plain_ms": None,
             "bound_ms": None, "bound_by": None, "library_ms": None,
             "shapes": [{"B": WARP_B, "Cs": stacked.shape[1],
                         "H": WARP_SRC, "W": WARP_SRC,
                         "Ho": gy.shape[1], "Wo": gy.shape[2]}]}
    if not quick:
        nbytes = (stacked.numel() + 4 * (gy.numel() + gx.numel()
                                         + valid.numel())
                  + 4 * (bil.numel() + near.numel()))
        bms, by = bound_ms(nbytes, 0.0, "f32")
        entry.update(ms=cuda_ms(lambda: warp(*args)),
                     plain_ms=cuda_ms(lambda: warp_plain(*args), iters=5),
                     bound_ms=bms, bound_by=by,
                     library_ms=grid_sample_ms(stacked, gy, gx))
        line.update(kernel_ms=entry["ms"], plain_ms=entry["plain_ms"],
                    bound_us=bms * 1e3, bound_by=by,
                    library_ms=entry["library_ms"])
    print(json.dumps(line), flush=True)
    return entry


def grid_sample_ms(stacked, gy, gx) -> float:
    """F.grid_sample bilinear over the frames plus nearest over the mask at
    the same coordinates (a yardstick only; the port never calls it). The
    float source is made outside the timed region."""
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

    return cuda_ms(both)


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

        kernels = counters()
        for fn in kernels.values():
            fn.launches = 0
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

    def dev_ms(e):
        return (getattr(e, "device_time_total", 0.0)
                or getattr(e, "cuda_time_total", 0.0)) / 1e3

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


def counters():
    from stf_unet_tpu_torch.ops.kernels.lstm_last import lstm_last
    from stf_unet_tpu_torch.ops.kernels.lstm_last_x import lstm_last_x
    from stf_unet_tpu_torch.ops.kernels.lstm_last_x_bwd import (
        lstm_last_x_bwd)
    from stf_unet_tpu_torch.ops.kernels.warp import warp

    return {"lstm_last_x": lstm_last_x, "lstm_last": lstm_last,
            "lstm_last_x_bwd": lstm_last_x_bwd, "warp": warp}


def write_tree(tmpdir: str) -> str:
    from stf_unet_tpu_torch.data.synthetic import make_synthetic_breadm

    data = os.path.join(tmpdir, "breadm")
    t0 = time.perf_counter()
    make_synthetic_breadm(data, splits=("training",),
                          patients_per_split=TRAIN_PATIENTS,
                          slices_per_patient=TRAIN_SLICES, size=TRAIN_SRC,
                          seed=0)
    make_synthetic_breadm(data, splits=("val", "test"),
                          patients_per_split=EVAL_PATIENTS,
                          slices_per_patient=TRAIN_SLICES, size=TRAIN_SRC,
                          seed=1)
    print(f"synthetic tree written in {time.perf_counter() - t0:.3f} s",
          flush=True)
    return data


def training_phase(tmpdir: str, data: str, device: str = "cuda"):
    """cli/train.run at full width, bf16: every loss finite, >= 10 steps
    over >= 2 epochs, latest/best written, every training kernel launched.
    Returns (launch counts, the run's result)."""
    import math

    from stf_unet_tpu_torch.cli import train as train_cli

    kernels = counters()
    for fn in kernels.values():
        fn.launches = 0
    weights = os.path.join(tmpdir, "weights")
    t0 = time.perf_counter()
    result = train_cli.run([
        "--data-path", data, "--model", "stflstm", "--amp", "true",
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
    print(json.dumps({"training": {
        "wall_s": wall, "epochs": result["epochs"],
        "steps": result["steps"], "best_dice": result["best_dice"],
        "test_dice": result["test"]["dice"],
        "launches": launches}}), flush=True)
    return launches, result


def train_objects(data: str, dtype, device, batch: int):
    """Model (seeded, full width), optimizer, augmentation and one host
    batch of the synthetic tree, as cli/train builds them."""
    import torch

    from stf_unet_tpu_torch.core.config import (DataConfig, ModelConfig,
                                                OptimConfig)
    from stf_unet_tpu_torch.data.index import DatasetIndex
    from stf_unet_tpu_torch.data.loader import HostLoader
    from stf_unet_tpu_torch.data.transforms import TrainAugment
    from stf_unet_tpu_torch.models.registry import create_model
    from stf_unet_tpu_torch.train.state import TrainState, make_optimizer

    cfg = DataConfig(data_path=data, base_size=TRAIN_SRC,
                     crop_size=TRAIN_CROP)
    index = DatasetIndex(data, "train", cfg.resolved_sequence_types)
    host = next(iter(HostLoader(index, batch, shuffle=False,
                                prefetch=0).epoch(0)))
    torch.manual_seed(0)
    model = create_model(ModelConfig(), dtype=dtype).to(device)
    state = TrainState(model, make_optimizer(OptimConfig(), model,
                                             torch.device(device)))
    return state, TrainAugment(cfg), host


def step_phase(data: str, device: str = "cuda"):
    """bf16 training steps at batch 16 on one fixed batch: the loss of
    repeated steps must fall; ms per step and samples/s over back-to-back
    steps; a torch.profiler view of one step (kernel time by name, the
    device's idle share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stf_unet_tpu_torch.core.prng import augment_generator
    from stf_unet_tpu_torch.train.loop import train_step

    state, augment, host = train_objects(data, torch.bfloat16, device,
                                         TRAIN_BATCH)
    dev = torch.device(device)

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
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_ms(e):
        return (getattr(e, "device_time_total", 0.0)
                or getattr(e, "cuda_time_total", 0.0)) / 1e3

    busy = sum(dev_ms(e) for e in kernels)
    ours = sum(dev_ms(e) for e in kernels if "stf::" in e.key)
    top = sorted(kernels, key=dev_ms, reverse=True)[:12]
    print(json.dumps({"train_steps": {
        "batch": TRAIN_BATCH, "fixed_batch_losses": losses,
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
        "peak_memory_gb_timed_steps": (
            torch.cuda.max_memory_allocated(dev) / 2**30)
        if dev.type == "cuda" else "not measured",
        "top_kernels": [{"name": e.key[:90], "calls": e.count,
                         "ms": dev_ms(e)} for e in top]}}), flush=True)


def train_path_phase(data: str, device: str = "cuda"):
    """One training step at full width through the kernels (f32) and
    through the plain path (f32 and float64): same images; loss and
    gradients of both f32 paths against float64, with the kernels adding
    no error of their own (see PATH_ERR_RATIO)."""
    import torch

    from stf_unet_tpu_torch.core.config import ModelConfig
    from stf_unet_tpu_torch.core.prng import augment_generator
    from stf_unet_tpu_torch.models.registry import create_model
    from stf_unet_tpu_torch.ops.kernels.warp import warp_plain
    from stf_unet_tpu_torch.train.loop import loss_and_grads

    state, augment, host = train_objects(data, torch.float32, device,
                                         PATH_BATCH)
    f64 = create_model(ModelConfig(), dtype=torch.float64).to(
        device, torch.float64)
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
        x = images.double() if model is f64 else images
        loss = loss_and_grads(model, x, targets, 2).item()
        grads = {n: p.grad.detach().double()
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
    agg = kernel_phase(device, args.quick)
    agg["lstm_last_x_bwd"] = lstm_bwd_phase(device, args.quick)
    agg["warp"] = warp_phase(device, args.quick)
    if args.quick:
        print("quick: kernels build and agree with their plain versions")
        return 0
    routing_phase(device)
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
        train_launches, _ = training_phase(tmpdir, data)
        step_phase(data)
        train_path_phase(data)

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
    ]
    for k in kernels:
        a = agg[k["name"]]
        by_path = {"serve": serve_launches[k["name"]],
                   "train": train_launches[k["name"]]}
        k.update(launches=sum(by_path.values()), launches_by_path=by_path,
                 max_abs_err=a["max_abs_err"], ms=a["ms"],
                 plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
                 bound_by=a["bound_by"], library_ms=a["library_ms"],
                 shapes=a["shapes"],
                 dtype="uint8 in, f32 out" if k["name"] == "warp"
                 else "bf16")
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
