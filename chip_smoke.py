#!/usr/bin/env python3
"""Drive the PyTorch port (stf_unet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each of which fails the run (non-zero exit, no result line):
  1. card: print the GPU's name and power limit; build both CUDA kernels
     from csrc/ with nvcc, in parallel, and print the build seconds.
  2. kernels: each kernel against its plain PyTorch version on the card at
     every row count the serving path gives it (batch buckets 1, 2, 4, 8
     at crop 224, T=8), in bf16 and f32, within the stated tolerances;
     timings of kernel, plain version and a library yardstick at B=8.
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
    row count the serving path gives each kernel."""
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
            for bsz in BUCKETS:
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
    Returns per-kernel aggregates over one B=8 bf16 serving forward."""
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


def cudnn_lstm_ms(x, w_ih, w_hh, b) -> float:
    """One torch.nn.LSTM call computing the same h_T (a yardstick only;
    the port never calls it)."""
    import torch

    c = x.shape[-1]
    lstm = torch.nn.LSTM(c, c).to(x.device, x.dtype)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(w_ih.t())
        lstm.weight_hh_l0.copy_(w_hh.t())
        lstm.bias_ih_l0.copy_(b)
        lstm.bias_hh_l0.zero_()
    lstm.flatten_parameters()
    with torch.inference_mode():
        return cuda_ms(lambda: lstm(x)[1][0])


def serving_phase(tmpdir: str):
    import torch

    from stf_unet_tpu_torch.cli.serve import build_server, parse_args
    from stf_unet_tpu_torch.core.config import ModelConfig
    from stf_unet_tpu_torch.models.registry import create_model
    from stf_unet_tpu_torch.ops.kernels.lstm_last import lstm_last
    from stf_unet_tpu_torch.ops.kernels.lstm_last_x import lstm_last_x
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

        lstm_last_x.launches = lstm_last.launches = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(N_REQUESTS) as ex:
            results = list(ex.map(one, range(N_REQUESTS)))
        wall = time.perf_counter() - t0
        launches = {"lstm_last_x": lstm_last_x.launches,
                    "lstm_last": lstm_last.launches}
        metrics = client.metrics()
        for i, (mask, _) in enumerate(results):
            want = (256, 256) if i % 4 == 3 else (CROP, CROP)
            check(mask.shape == want,
                  f"request {i}: mask {mask.shape}, expected {want}")
            check(int(mask.max()) <= 1, f"request {i}: class out of range")
        lat = sorted(ms for _, ms in results)
        for name, count in launches.items():
            check(count > 0, f"kernel {name} never launched while serving")
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
    if args.quick:
        print("quick: kernels build and agree with their plain versions")
        return 0
    with tempfile.TemporaryDirectory() as tmpdir:
        server, frames, launches = serving_phase(tmpdir)
        weights_sd = torch.load(os.path.join(tmpdir, "stflstm_seed0.pth"),
                                weights_only=True)["model"]
    breakdown_phase(server, frames)
    path_phase(server, frames, weights_sd)

    kernels = [
        {"name": "lstm_last_x", "route": "cuda",
         "source": "stf_unet_tpu_torch/csrc/lstm_last_x.cu",
         "replaces": "stf_unet_tpu/ops/pallas/lstm_train_kernel.py:106"},
        {"name": "lstm_last", "route": "cuda",
         "source": "stf_unet_tpu_torch/csrc/lstm_last.cu",
         "replaces": "stf_unet_tpu/ops/pallas/lstm_kernel.py:69"},
    ]
    for k in kernels:
        a = agg[k["name"]]
        k.update(launches=launches[k["name"]], max_abs_err=a["max_abs_err"],
                 ms=a["ms"], plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
                 bound_by=a["bound_by"], library_ms=a["library_ms"],
                 shapes=a["shapes"], dtype="bf16")
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
