"""Build and load the port's CUDA kernels.

``csrc/*.cu`` is compiled at first use with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, under ``gemm_hls_tpu_torch/build/``
and named by a hash of the sources and flags, so an edited source rebuilds
and an unchanged one is reused.  The library is loaded with ctypes; every
pointer and the stream are passed as ``c_void_p`` (a plain int argument
would be cut to 32 bits).  Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Must match ``enum DType`` in csrc/common.cuh.
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                torch.int8: 3, torch.int32: 4}

_lock = threading.Lock()
_lib = None


def dtype_code(d: torch.dtype) -> int:
    try:
        return _DTYPE_CODES[d]
    except KeyError:
        raise NotImplementedError(
            f"no CUDA kernel takes dtype {d} (ROADMAP A, slice 2)") from None


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libgemm_hls_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the hashed library exists; the ptxas
    report (registers, shared memory, spills) goes to a ``.log`` beside it."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(p) for p in sorted(CSRC_DIR.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def _declare(lib):
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.mxu_gemm.restype = i32
    lib.mxu_gemm.argtypes = [vp, vp, vp, i32, i32, i32, i64, i64,
                             i32, i32, i32, i32, i32, i32, vp]
    lib.semiring_gemm.restype = i32
    lib.semiring_gemm.argtypes = [vp, vp, vp, i32, i32, i32, i64, i64,
                                  i32, i32, i32, i32, i32, vp]
    return lib


def library():
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(str(build())))
        return _lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero return of a launch wrapper."""
    if rc == -1:
        raise NotImplementedError(f"{what}: no kernel built for this dtype/op")
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
