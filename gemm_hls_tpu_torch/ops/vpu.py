"""Generic-semiring GEMM: the wrapper of kernel B3
(``csrc/semiring_gemm.cu``) and its plain PyTorch version.

Counterpart of ``gemm_hls_tpu/ops/pallas_vpu.py::vpu_matmul``.  Unlike the
TPU entry it takes whole, unpadded operands (the kernel masks M, N and the
K tail itself) and the transpose flags (read through strides).  A CUDA
tensor launches the kernel or raises; a CPU tensor runs
:func:`vpu_matmul_plain`.
"""

from __future__ import annotations

import torch

from gemm_hls_tpu_torch import _build
from gemm_hls_tpu_torch.config import GemmConfig, dtype_name
from gemm_hls_tpu_torch.ops.mxu import _MAX_M, _INT_MAX, _dims, _row_major
from gemm_hls_tpu_torch.ops.semiring import Semiring

# Bytes the plain version's mapped (M, ck, N) chunk may take.
_PLAIN_CHUNK_BYTES = 256 << 20

_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.int32)


def vpu_matmul_plain(a, b, *, cfg: GemmConfig, sr: Semiring,
                     transpose_a=False, transpose_b=False):
    """Plain version: a K-chunked broadcast map / reduce in the accumulator
    dtype, its mapped intermediate bounded to M x ck x N elements."""
    m, n, k = _dims(a, b, transpose_a, transpose_b)
    acc_dtype = cfg.tacc_dtype
    a_l = (a.T if transpose_a else a).to(acc_dtype)
    b_l = (b.T if transpose_b else b).to(acc_dtype)
    acc = torch.full((m, n), sr.identity_for(acc_dtype), dtype=acc_dtype,
                     device=a.device)
    per_k = max(1, m * n * acc_dtype.itemsize)
    ck = max(1, min(k, _PLAIN_CHUNK_BYTES // per_k))
    for k0 in range(0, k, ck):
        k1 = min(k, k0 + ck)
        mapped = sr.map_op(a_l[:, k0:k1, None], b_l[None, k0:k1, :])
        acc = sr.reduce_op(acc, sr.reduce_along(mapped, 1))
    return acc.to(cfg.tout_dtype)


def vpu_matmul(a, b, *, cfg: GemmConfig, sr: Semiring, transpose_a=False,
               transpose_b=False):
    """C (M, N) = reduce_k map(op(A)[i,k], op(B)[k,j]) in ``cfg.out_dtype``."""
    m, n, k = _dims(a, b, transpose_a, transpose_b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return vpu_matmul_plain(a, b, cfg=cfg, sr=sr, transpose_a=transpose_a,
                                transpose_b=transpose_b)
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError(f"operands on {a.device} and {b.device}")
    if sr.op_code is None:
        raise NotImplementedError(
            f"semiring {sr.name!r} has no CUDA functor; custom semirings run "
            f"on CPU tensors or backend='torch' until their JIT lands "
            f"(ROADMAP A, slice 2: custom-semiring JIT)")
    if a.dtype != b.dtype:
        raise ValueError(f"dtype mismatch: {a.dtype} vs {b.dtype}")
    if a.dtype not in _KERNEL_DTYPES:
        raise NotImplementedError(
            f"kernel B3 takes float32, bfloat16 and int32, not "
            f"{dtype_name(a.dtype)} (ROADMAP A, slice 2)")
    out_dtype = cfg.tout_dtype
    if cfg.tacc_dtype != (torch.int32 if a.dtype == torch.int32
                          else torch.float32):
        raise NotImplementedError(
            f"accumulator {cfg.acc_dtype} for {dtype_name(a.dtype)} inputs")
    if a.dtype.is_floating_point and not out_dtype.is_floating_point:
        raise NotImplementedError(
            f"{dtype_name(a.dtype)} -> {dtype_name(out_dtype)} output cast")
    if min(m, n, k) < 1 or m > _MAX_M or max(n, k) > _INT_MAX:
        raise ValueError(f"kernel B3 takes 1 <= M <= {_MAX_M} and "
                         f"1 <= N, K < 2^31, got ({m}, {n}, {k})")
    a, b = _row_major(a), _row_major(b)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    lib = _build.library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.semiring_gemm(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                               m, n, k, a.stride(0), b.stride(0),
                               int(transpose_a), int(transpose_b),
                               _build.dtype_code(a.dtype),
                               _build.dtype_code(out_dtype), sr.op_code,
                               stream)
    _build.check(rc, f"semiring_gemm[{sr.name}]")
    vpu_matmul.launches += 1
    return out


# Kernel launches since the count was last reset (plain calls not counted).
vpu_matmul.launches = 0
