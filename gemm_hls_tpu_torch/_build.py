"""Build and load the port's CUDA kernels.

``csrc/*.cu`` is compiled at first use with ``nvcc`` for ``sm_90a``, one
``nvcc -c`` per source, all started together, then linked into one shared
library with a plain C interface, under ``gemm_hls_tpu_torch/build/`` and
named by a hash of the sources and flags, so an edited source rebuilds and
an unchanged one is reused.  The library is loaded with ctypes; every
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
import time
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
            f"no CUDA kernel takes dtype {d} (ROADMAP B coverage items 1 and 2)") from None


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
    """Compile ``csrc/*.cu`` unless the hashed library exists: one ``nvcc -c``
    process per source, all running at once, then one link.  The log
    beside the library holds each source's compile seconds and the ptxas
    report (registers, shared memory, spills)."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = BUILD_DIR / f"{out.stem}.{os.getpid()}"
    jobs = []  # (source, object, log, process)
    t0 = time.perf_counter()
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj, log = (tag.with_name(f"{tag.name}.{src.stem}{ext}")
                    for ext in (".o", ".log"))
        with open(log, "w") as f:
            jobs.append((src, obj, log, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=f, stderr=subprocess.STDOUT)))
    seconds = {}
    while len(seconds) < len(jobs):
        for src, _, _, proc in jobs:
            if src not in seconds and proc.poll() is not None:
                seconds[src] = time.perf_counter() - t0
        time.sleep(0.1)
    report, failed = [], []
    for src, obj, log, proc in jobs:
        text = log.read_text()
        log.unlink()
        report.append(f"== {src.name}: {seconds[src]:.1f} s, rc "
                      f"{proc.returncode}\n{text}")
        if proc.returncode:
            failed.append(f"{src.name}: {text[-4000:]}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *(str(j[1]) for j in jobs)],
            capture_output=True, text=True)
        report.append(f"== link: rc {link.returncode}\n{link.stdout}"
                      f"{link.stderr}")
        if link.returncode:
            failed.append(f"link: {link.stderr[-4000:]}")
    for _, obj, _, _ in jobs:
        obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("".join(report))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, out)
    return out


def _declare(lib):
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    # (a, b, c, batch, M, N, K, lda, ldb, sa, sb, ta, tb, ...)
    gemm = [vp, vp, vp, i64, i32, i32, i32, i64, i64, i64, i64, i32, i32]
    lib.mxu_gemm.restype = i32
    lib.mxu_gemm.argtypes = gemm + [i32, i32, i32, i32, i32, vp, vp, i32, vp]
    # B1 / B2 on the tile engine: mxu_gemm's arguments without the vector
    # flags (its operands are aligned by the route's rule).
    lib.mxu_wgmma.restype = i32
    lib.mxu_wgmma.argtypes = gemm + [i32, i32, i32, vp, vp, i32, vp]
    lib.mxu_gemm_row_softmax.restype = i32
    lib.mxu_gemm_row_softmax.argtypes = gemm + [i32, i32, i32, i32, vp]
    # B2's row softmax on the tile engine: (..., in_code, out_code, stream).
    lib.row_softmax_wgmma.restype = i32
    lib.row_softmax_wgmma.argtypes = gemm + [i32, i32, vp]
    lib.semiring_gemm.restype = i32
    lib.semiring_gemm.argtypes = gemm + [i32, i32, i32, vp]
    # (a slices, b^T slices, n_used, c, c2, ua, ub, M, N, K, lda, ldb,
    #  n_diags, flush_steps, vec, engine, stream)
    ptrs = ctypes.POINTER(vp)
    lib.slice_gemm.restype = i32
    lib.slice_gemm.argtypes = [ptrs, ptrs, i32, vp, vp, vp, vp, i32, i32, i32,
                               i64, i64, i32, i32, i32, i32, vp]
    # B4 on the tile engine: (a slices, b^T slices, n_used, c, ua, ub, M, N,
    # K, lda, ldb, n_diags, stream)
    lib.slice_diag_wgmma.restype = i32
    lib.slice_diag_wgmma.argtypes = [ptrs, ptrs, i32, vp, vp, vp, i32, i32, i32,
                                     i64, i64, i32, vp]
    # Flash attention: (seqs, lse, kv_len | delta, q_seg, kv_seg, offs, dims,
    # cap, scale, dtype, stream); seqs holds (pointer, heads, sb, sh, ss)
    # per sequence, dims (B, group, S_q, S_kv, D, causal, window, vec).
    i64p, i32p, f32 = ctypes.POINTER(i64), ctypes.POINTER(i32), ctypes.c_float
    flash = [i64p, vp, vp, vp, vp, vp, i32p, f32, f32, i32, vp]
    for name in ("flash_fwd", "flash_wgmma", "flash_bwd_dq", "flash_bwd_dkv",
                 "flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma"):
        getattr(lib, name).restype = i32
        getattr(lib, name).argtypes = flash
    # Quantized and grouped GEMMs: pointers, then int sizes and codes, then
    # the stream.
    for name, n_ptr, n_int in (("dequant_gemm", 5, 10), ("dequant_wgmma", 4, 10),
                               ("w8a8_quantize", 3, 5),
                               ("w8a8_gemm", 5, 8), ("w8a8_wgmma", 5, 8),
                               ("grouped_gemm", 4, 9),
                               ("grouped_wgmma", 4, 7),
                               ("grouped_update", 4, 8),
                               ("grouped_update_wgmma", 4, 6)):
        getattr(lib, name).restype = i32
        getattr(lib, name).argtypes = [vp] * n_ptr + [i32] * n_int + [vp]
    # B13's engine plans: the clusters of (bn, splits) the card holds at once.
    lib.dequant_wgmma_clusters.restype = i32
    lib.dequant_wgmma_clusters.argtypes = [i32, i32, ctypes.POINTER(i32)]
    # The fused distributed GEMMs: (rank table of int64 pointers, int dims,
    # int[2] blocks per rank out, tensor maps, stamps, stream).
    for name in ("ring_gemm", "cannon_gemm"):
        getattr(lib, name).restype = i32
        getattr(lib, name).argtypes = [i64p, i32p, i32p, vp, vp, vp]
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
    if rc == -2:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled refused a TMA tensor map")
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
