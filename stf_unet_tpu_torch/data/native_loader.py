"""ctypes binding of the port's native C++ decode / resize stage
(`stf_unet_tpu_torch/native/decoder.cpp`; counterpart of
stf_unet_tpu/data/native_loader.py).

The library is built with g++ at first use into `build/native/` at the
repository root (the file name carries a hash of the source, so an
edited source rebuilds) and never touches the JAX package's own build.
Where g++, libjpeg or libpng is missing the build fails once, says so,
and the loader decodes with PIL, as the JAX package does. Decoded
grayscale matches PIL convert('L') (ITU-R 601-2 luma); the banded resize
is bit-identical to the numpy path of data/transforms.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "decoder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
LIBS = ("-ljpeg", "-lpng", "-lpthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libstfdecoder-{h.hexdigest()[:16]}.so"


def _build(target: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp),
                        *LIBS], check=True, capture_output=True,
                       timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        print(f"native decoder build failed ({e}; "
              f"{detail.decode(errors='replace').strip()[-300:]}); "
              f"decoding with PIL")
        return False
    os.replace(tmp, target)
    return True


def _declare(lib: ctypes.CDLL) -> None:
    lib.stf_decode_batch.restype = ctypes.c_int
    lib.stf_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_uint8, ctypes.c_int]
    lib.stf_image_size.restype = ctypes.c_int
    lib.stf_image_size.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.stf_banded_resize.restype = ctypes.c_int
    lib.stf_banded_resize.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int, ctypes.c_int]


def get_lib() -> Optional[ctypes.CDLL]:
    """The native decoder (built on first use), or None if it does not
    build or load; tried once per process."""
    global _lib, _load_attempted
    with _lock:
        if _lib is not None or _load_attempted:
            return _lib
        _load_attempted = True
        target = library_path()
        if not target.exists() and not _build(target):
            return None
        try:
            lib = ctypes.CDLL(str(target))
        except OSError as e:
            print(f"native decoder load failed ({e}); decoding with PIL")
            return None
        _declare(lib)
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def _threads(n_threads: Optional[int]) -> int:
    return n_threads if n_threads is not None else min(8, os.cpu_count()
                                                       or 1)


def image_size(path: str) -> Optional[Tuple[int, int]]:
    """(h, w) from the file's header, or None."""
    lib = get_lib()
    if lib is None:
        return None
    h, w = ctypes.c_int(0), ctypes.c_int(0)
    if lib.stf_image_size(path.encode(), ctypes.byref(h),
                          ctypes.byref(w)) != 0:
        return None
    return h.value, w.value


def decode_batch(paths: List[str], canvas_h: int, canvas_w: int,
                 fill: int = 0, n_threads: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Decode `paths` onto a uint8 canvas [N, canvas_h, canvas_w]
    (top-left anchored, `fill` padding) -> (canvas, sizes [N, 2]). A
    failed decode leaves a zero size (the caller's warn-and-skip)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native decoder unavailable")
    n = len(paths)
    canvas = np.empty((n, canvas_h, canvas_w), dtype=np.uint8)
    sizes = np.zeros((n, 2), dtype=np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.stf_decode_batch(
        arr, n, canvas.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        canvas_h, canvas_w,
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), fill,
        _threads(n_threads))
    return canvas, sizes


def banded_resize(src: np.ndarray, out_h: int, out_w: int,
                  idx_h: np.ndarray, wgt_h: np.ndarray,
                  idx_w: np.ndarray, wgt_w: np.ndarray,
                  n_threads: Optional[int] = None) -> np.ndarray:
    """Banded separable PIL-parity resize of uint8 planes [N, H, W] ->
    [N, out_h, out_w], bit-identical to data/transforms' numpy path
    (ascending-k f64 sums, round half to even)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native decoder unavailable")
    src = np.ascontiguousarray(src, dtype=np.uint8)
    n, in_h, in_w = src.shape
    dst = np.empty((n, out_h, out_w), dtype=np.uint8)
    idx_h = np.ascontiguousarray(idx_h, dtype=np.int64)
    wgt_h = np.ascontiguousarray(wgt_h, dtype=np.float64)
    idx_w = np.ascontiguousarray(idx_w, dtype=np.int64)
    wgt_w = np.ascontiguousarray(wgt_w, dtype=np.float64)
    if idx_h.shape[0] != out_h or idx_w.shape[0] != out_w:
        raise ValueError("banded_resize: tap tables do not match the "
                         "output size")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.stf_banded_resize(
        src.ctypes.data_as(u8p), n, in_h, in_w,
        dst.ctypes.data_as(u8p), out_h, out_w,
        idx_h.ctypes.data_as(i64p), wgt_h.ctypes.data_as(f64p),
        idx_h.shape[1],
        idx_w.ctypes.data_as(i64p), wgt_w.ctypes.data_as(f64p),
        idx_w.shape[1], _threads(n_threads))
    return dst
