"""ctypes bindings for the native C++ verification oracle ``native/``.

The library is shared with the JAX package by path, not by import (any
``gemm_hls_tpu`` import pulls in jax): ``native/libgemmref.so``, built on
demand with ``make -C native``, as ``gemm_hls_tpu/utils/native.py`` does.
Returns None when no toolchain is available; callers then use the numpy
oracle.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libgemmref.so"
_lock = threading.Lock()
_lib = None
_load_failed = False

_OPS = {"mul": 0, "add": 1, "min": 2, "max": 3, "and": 4, "or": 5}

# semiring name -> (map_op, reduce_op)
_SEMIRING_OPS = {
    "plus_times": ("mul", "add"),
    "min_plus": ("add", "min"),
    "max_plus": ("add", "max"),
    "max_min": ("min", "max"),
    "min_max": ("max", "min"),
    "max_times": ("mul", "max"),
    "or_and": ("and", "or"),
}


def build_library() -> Optional[Path]:
    """Compile the oracle with the repo Makefile (idempotent)."""
    if _LIB_PATH.exists():
        return _LIB_PATH
    try:
        subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                       capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError):
        return None
    return _LIB_PATH if _LIB_PATH.exists() else None


def _declare(lib):
    i64 = ctypes.c_int64
    i32 = ctypes.c_int
    for name, ctype in (("gemmref_f64", ctypes.c_double),
                        ("gemmref_i64", ctypes.c_int64)):
        fn = getattr(lib, name)
        fn.restype = i32
        fn.argtypes = [ctypes.POINTER(ctype)] * 3 + [i64] * 3 + [i32] * 5
    return lib


def get_library():
    """Load (building if needed) the native library, or None."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _load_failed:
            return None
        path = build_library()
        if path is None:
            _load_failed = True
            return None
        try:
            _lib = _declare(ctypes.CDLL(str(path)))
        except OSError:
            _load_failed = True
            return None
        return _lib


def native_reference_matmul(a: np.ndarray, b: np.ndarray,
                            semiring: str = "plus_times", *,
                            n_threads: int = 0) -> Optional[np.ndarray]:
    """Semiring GEMM of (M, K) x (K, N) in native code, in wide precision
    (f64 for floats, i64 for ints); None if the library is unavailable or
    the semiring has no native map/reduce pair."""
    lib = get_library()
    if lib is None or semiring not in _SEMIRING_OPS:
        return None
    map_op, reduce_op = (_OPS[o] for o in _SEMIRING_OPS[semiring])
    kind = np.dtype(a.dtype).kind
    if kind == "f":
        wide, fn, ctype = np.float64, lib.gemmref_f64, ctypes.c_double
    elif kind in "iub":
        wide, fn, ctype = np.int64, lib.gemmref_i64, ctypes.c_int64
    else:
        return None
    a_w = np.ascontiguousarray(a, dtype=wide)
    b_w = np.ascontiguousarray(b, dtype=wide)
    m, k = a_w.shape
    kb, n = b_w.shape
    if k != kb:
        raise ValueError(f"contraction mismatch: {a.shape} x {b.shape}")
    c = np.empty((m, n), dtype=wide)
    rc = fn(a_w.ctypes.data_as(ctypes.POINTER(ctype)),
            b_w.ctypes.data_as(ctypes.POINTER(ctype)),
            c.ctypes.data_as(ctypes.POINTER(ctype)),
            m, n, k, map_op, reduce_op, 0, 0, n_threads)
    if rc != 0:
        raise RuntimeError(f"gemmref returned error code {rc}")
    if kind == "b":
        return c != 0
    return c
