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

# Must match ``enum DType`` in csrc/common.cuh.  The first five are the
# types every kernel's store writes; the wide ones after them (float64,
# int16, the unsigned ints, int64) only kernels B1 - B3 take.
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                torch.int8: 3, torch.int32: 4, torch.float64: 5,
                torch.int16: 6, torch.uint8: 7, torch.uint16: 8,
                torch.uint32: 9, torch.int64: 10}
_BASE_CODES = 5

_lock = threading.Lock()
_lib = None
# Generated libraries (user semirings, callable epilogues: ops/codegen.py)
# loaded in this process, by path, and the nvcc builds this process ran;
# their own lock, so a kernel launch never waits on their build.
_gen_lock = threading.Lock()
_generated = {}
_generated_fns = {}  # (source text, entry) -> its declared function
generated_builds = 0


def dtype_code(d: torch.dtype, wide: bool = False) -> int:
    """The kernels' code of ``d``.  ``wide``: the caller is a tile of B1 -
    B3 that also takes float64, int16, the unsigned ints and int64 (the
    CUDA-core tile, ``csrc/dmma_gemm.cu``); the other kernels refuse them
    here."""
    code = _DTYPE_CODES.get(d)
    if code is None or (code >= _BASE_CODES and not wide):
        raise NotImplementedError(
            f"no CUDA kernel of this call takes dtype {d} (ROADMAP B "
            f"coverage items 8-17: the wide types on the other kernels)")
    return code


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


# The C interfaces of the generated entry points (ops/codegen.py):
# semiring_gemm's arguments less the op code; mxu_gemm's with four
# epilogue operand pointers and no epilogue kind.
_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_GEMM_ARGS = [_VP, _VP, _VP, _I64, _I32, _I32, _I32, _I64, _I64, _I64, _I64, _I32, _I32]
GENERATED_ARGTYPES = {
    "gen_semiring_gemm": _GEMM_ARGS + [_I32, _I32, _VP],
    "gen_epilogue_gemm": _GEMM_ARGS + [_I32] * 4 + [_VP] * 4 + [_I32, _VP],
}


def generated_path(source: str) -> Path:
    """Where ``source``'s library lives: ``libgemm_hls_gen_<hash>.so`` in
    ``BUILD_DIR``, the hash over the generated text, every ``csrc/*.cuh`` it
    may include and the flags.  Keyed by the text, never by a semiring's or
    callable's name: two functors that differ in one constant, or share a
    name, get two libraries."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(source.encode())
    for p in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libgemm_hls_gen_{h.hexdigest()[:16]}.so"


def generated_libraries(specs):
    """The entry points of generated translation units, ``specs`` a list of
    (source text, ``extern "C"`` entry name): each library is loaded from
    ``BUILD_DIR`` where it exists, else built, the missing ones side by side
    (one ``nvcc -shared`` each, at most one a core at once, the same
    ``NVCC_FLAGS``, ``-I csrc``), written to a temporary name and moved into
    place.  Holds the generated libraries' lock, never the kernel
    library's, so launches of built kernels go on during a build.  The source is kept beside
    its library (``gen_<hash>.cu``) and so is the build log (seconds,
    ptxas registers and spills).  A failed build raises RuntimeError with
    the source's path and the end of nvcc's output; nothing falls back to
    a plain version.  Returns ctypes functions, declared as
    ``GENERATED_ARGTYPES`` says."""
    global generated_builds
    with _gen_lock:
        # A launch's lookup: its text and entry, no hash (the hash reads
        # every header; a millisecond a call).
        fns = [_generated_fns.get(tuple(spec)) for spec in specs]
        if all(fns):
            return fns
        paths = [generated_path(src) for src, _ in specs]
        jobs = {}  # library path -> (source path, log path, tmp path, process)
        missing = {p: src for p, (src, _) in zip(paths, specs)
                   if p not in _generated and not p.exists()}
        if missing:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()

            def start(out, src):
                cu = out.with_name(out.stem.replace("libgemm_hls_gen_", "gen_") + ".cu")
                cu.write_text(src)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                log = out.with_suffix(f".{os.getpid()}.buildlog")
                with open(log, "w") as f:
                    proc = subprocess.Popen(
                        [nvcc, *NVCC_FLAGS, "-shared", "-I", str(CSRC_DIR), "-o",
                         str(tmp), str(cu)], stdout=f, stderr=subprocess.STDOUT)
                jobs[out] = (cu, log, tmp, proc, time.perf_counter())

            # At most one nvcc a core at once (each holds a few GB in cicc /
            # ptxas); the rest start as they finish.
            waiting = list(missing.items())
            seconds = {}
            while len(seconds) < len(missing):
                while waiting and len(jobs) - len(seconds) < (os.cpu_count() or 8):
                    start(*waiting.pop(0))
                for out, (_, _, _, proc, t0) in jobs.items():
                    if out not in seconds and proc.poll() is not None:
                        seconds[out] = time.perf_counter() - t0
                time.sleep(0.1)
            failed = []
            for out, (cu, log, tmp, proc, _) in jobs.items():
                rc = proc.returncode
                text = log.read_text()
                log.unlink()
                out.with_suffix(".log").write_text(
                    f"== {cu.name}: {seconds[out]:.1f} s, rc {rc}\n{text}")
                if rc:
                    tmp.unlink(missing_ok=True)
                    failed.append(f"{cu}: {text[-4000:]}")
                else:
                    os.replace(tmp, out)
                    generated_builds += 1
            if failed:
                raise RuntimeError("nvcc failed on a generated functor:\n"
                                   + "\n".join(failed))
        fns = []
        for out, spec in zip(paths, specs):
            if out not in _generated:
                _generated[out] = ctypes.CDLL(str(out))
            fn = getattr(_generated[out], spec[1])
            fn.restype = ctypes.c_int
            fn.argtypes = GENERATED_ARGTYPES[spec[1]]
            _generated_fns[tuple(spec)] = fn
            fns.append(fn)
        return fns


def generated_library(source: str, entry: str):
    """The ``extern "C"`` function ``entry`` of one generated translation
    unit, built at first use (:func:`generated_libraries`)."""
    return generated_libraries([(source, entry)])[0]


def _declare(lib):
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    # (a, b, c, batch, M, N, K, lda, ldb, sa, sb, ta, tb, ...)
    gemm = [vp, vp, vp, i64, i32, i32, i32, i64, i64, i64, i64, i32, i32]
    lib.mxu_gemm.restype = i32
    lib.mxu_gemm.argtypes = gemm + [i32, i32, i32, i32, i32, vp, vp, i32, vp]
    # B1 / B2 for float64 on the FP64 tensor cores: mxu_gemm's arguments.
    lib.dmma_gemm.restype = i32
    lib.dmma_gemm.argtypes = lib.mxu_gemm.argtypes
    # B1 / B2 on the tile engine, and float64 on the TMA tile: mxu_gemm's
    # arguments without the vector flags (their operands are aligned by the
    # route's rule).
    lib.mxu_wgmma.restype = i32
    lib.mxu_wgmma.argtypes = gemm + [i32, i32, i32, vp, vp, i32, vp]
    lib.dmma_tma_gemm.restype = i32
    lib.dmma_tma_gemm.argtypes = lib.mxu_wgmma.argtypes
    lib.mxu_gemm_row_softmax.restype = i32
    lib.mxu_gemm_row_softmax.argtypes = gemm + [i32, i32, i32, i32, vp]
    # B2's row softmax on the tile engine: (..., in_code, out_code, stream).
    lib.row_softmax_wgmma.restype = i32
    lib.row_softmax_wgmma.argtypes = gemm + [i32, i32, vp]
    lib.semiring_gemm.restype = i32
    lib.semiring_gemm.argtypes = gemm + [i32, i32, i32, vp]
    # B3 float64's slice forms: (unsigned long long[2] out, reset).
    lib.semiring_f64_forms.restype = i32
    lib.semiring_f64_forms.argtypes = [vp, i32]
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
