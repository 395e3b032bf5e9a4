"""Dense plus_times GEMM: the wrapper of kernel B1 (``csrc/mxu_gemm.cu``)
and its plain PyTorch version.

Counterpart of ``gemm_hls_tpu/ops/pallas_mxu.py::mxu_matmul`` (2-D, no
epilogue).  A CUDA tensor launches the kernel or raises; a CPU tensor runs
:func:`mxu_matmul_plain`.  Operands are passed in their physical layout
with the transpose flags: no transpose is materialised.
"""

from __future__ import annotations

import torch

from gemm_hls_tpu_torch import _build
from gemm_hls_tpu_torch.config import GemmConfig, dtype_name

# Largest M the kernel's grid takes (gridDim.y <= 65535 blocks of 128 rows).
_MAX_M = 65535 * 128
_INT_MAX = 2**31 - 1


def _dims(a, b, transpose_a, transpose_b):
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"expected 2-D operands, got {a.shape} x {b.shape}")
    k, m = a.shape if transpose_a else a.shape[::-1]
    n, kb = b.shape if transpose_b else b.shape[::-1]
    if kb != k:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    return m, n, k


def _row_major(x: torch.Tensor) -> torch.Tensor:
    """``x`` with unit stride on its last axis (a copy only if it has none;
    the transpose flags, not a copy, express transposition)."""
    return x if x.stride(-1) == 1 and x.stride(0) >= x.shape[1] else x.contiguous()


def mxu_matmul_plain(a, b, *, cfg: GemmConfig, transpose_a=False,
                     transpose_b=False):
    """Plain version: ``torch.matmul`` accumulating in the accumulator type
    (bf16 / fp16 to the same type: ``torch.matmul`` as is).  Integer
    inputs go through float64 (CUDA's matmul takes no integers), exact
    while |sum| < 2^53, then wrap to int32 like the reference's int32 sum."""
    _dims(a, b, transpose_a, transpose_b)
    a_l = a.T if transpose_a else a
    b_l = b.T if transpose_b else b
    acc = cfg.tacc_dtype
    if a.dtype in (torch.bfloat16, torch.float16) and cfg.tout_dtype == a.dtype:
        # The platform's own half-precision GEMM: fp32 accumulation inside,
        # one rounding to the output type.
        out = torch.matmul(a_l, b_l)
    elif acc.is_floating_point:
        out = torch.matmul(a_l.to(acc), b_l.to(acc))
    else:
        wide = torch.matmul(a_l.to(torch.float64), b_l.to(torch.float64))
        out = wide.to(torch.int64).to(acc)
    return out.to(cfg.tout_dtype)


def mxu_matmul(a, b, *, cfg: GemmConfig, transpose_a=False, transpose_b=False):
    """C (M, N) = op(A) . op(B) in ``cfg.out_dtype``.

    a: (M, K), or (K, M) with ``transpose_a``; b: (K, N), or (N, K) with
    ``transpose_b``.  Shapes need not be tile-aligned: the kernel masks
    every edge itself.
    """
    m, n, k = _dims(a, b, transpose_a, transpose_b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mxu_matmul_plain(a, b, cfg=cfg, transpose_a=transpose_a,
                                transpose_b=transpose_b)
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.dtype != b.dtype:
        raise ValueError(f"dtype mismatch: {a.dtype} vs {b.dtype}")
    if a.dtype == torch.float64:
        raise NotImplementedError(
            "float64 on CUDA is not ported yet (ROADMAP A, slice 2: float64 "
            "on CUDA); pass backend='torch' for the plain version")
    out_dtype = cfg.tout_dtype
    if a.dtype.is_floating_point and not out_dtype.is_floating_point:
        raise NotImplementedError(
            f"{dtype_name(a.dtype)} -> {dtype_name(out_dtype)} output cast")
    if min(m, n, k) < 1 or m > _MAX_M or max(n, k) > _INT_MAX:
        raise ValueError(f"kernel B1 takes 1 <= M <= {_MAX_M} and "
                         f"1 <= N, K < 2^31, got ({m}, {n}, {k})")
    a, b = _row_major(a), _row_major(b)
    in_code = _build.dtype_code(a.dtype)
    out_code = _build.dtype_code(out_dtype)
    vec = 16 // a.element_size()

    def vec_ok(x):
        return int(x.data_ptr() % 16 == 0 and x.stride(0) % vec == 0)

    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    lib = _build.library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mxu_gemm(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                          a.stride(0), b.stride(0), int(transpose_a),
                          int(transpose_b), vec_ok(a), vec_ok(b), in_code,
                          out_code, stream)
    _build.check(rc, "mxu_gemm")
    mxu_matmul.launches += 1
    return out


# Kernel launches since the count was last reset (plain calls not counted).
mxu_matmul.launches = 0
