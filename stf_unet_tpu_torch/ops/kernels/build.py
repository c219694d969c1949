"""Build and load the hand-written CUDA kernels in `stf_unet_tpu_torch/csrc`.

Each `<name>.cu` is compiled by nvcc for Hopper (`sm_90a`) into its own
shared library with a plain C interface, bound with ctypes. The build
happens at first use, into `build/kernels/` at the repository root; the
file name carries a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is reused. `build()` starts one nvcc per
missing library, all at once, and waits for them together.

Nothing here runs at import: the CPU tests import every module, and the
CPU has no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("lstm_last_x", "lstm_last", "lstm_last_x_bwd", "warp",
           "tofts_sums", "quant_patches", "quant_epilogue", "batch_norm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": nvcc wall time (0.0 when reused), "log": nvcc output}
build_info: Dict[str, dict] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    candidates.append(shutil.which("nvcc") or "")
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                       "the CUDA toolkit's nvcc (set CUDA_HOME)")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every missing library among `names` in parallel; return
    name -> library path. Raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    t0 = time.perf_counter()
    for n, path in paths.items():
        if path.exists():
            build_info.setdefault(n, {"seconds": 0.0, "log": "reused"})
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        build_info[n] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str, argtypes) -> ctypes.CDLL:
    """The loaded library for kernel `name` (built on first use), with the
    C entry `stf_<name>` declared as `int stf_<name>(*argtypes)`."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            fn = getattr(lib, f"stf_{name}")
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _loaded[name] = lib
        return lib


# Element types the kernels take, as their C entries number them.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def pack_gates(w: torch.Tensor) -> torch.Tensor:
    """[C, 4C] (gate order i, f, g, o) -> contiguous [C, C, 4] with element
    (k, j, g) = w[k, g*C + j]: the four gate weights of one unit side by
    side, as the kernels read them (csrc/lstm_cell.cuh)."""
    c = w.shape[0]
    return w.reshape(c, 4, c).transpose(1, 2).contiguous()


def aligned(t: torch.Tensor) -> torch.Tensor:
    """t, contiguous and 32-byte aligned: the kernels read x in 16-byte
    runs and W as WMMA fragments."""
    if t.is_contiguous() and t.data_ptr() % 32 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def check_status(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {status}")
