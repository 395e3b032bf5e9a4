"""Generic-semiring GEMM: the wrapper of kernel B3
(``csrc/semiring_gemm.cu``) and its plain PyTorch version.

Counterpart of ``gemm_hls_tpu/ops/pallas_vpu.py::vpu_matmul``, and of the
``jax.vmap`` over it that the JAX front door runs for 3-D operands.  Unlike
the TPU entry it takes whole, unpadded operands (the kernel masks M, N and
the K tail itself), the transpose flags (read through strides) and a batch
axis: 3-D operands, or one 3-D and one 2-D operand broadcast over the batch
through a batch stride of 0, run in one launch.  A CUDA tensor launches the
kernel or raises; a CPU tensor runs :func:`vpu_matmul_plain`.
"""

from __future__ import annotations

import torch

from gemm_hls_tpu_torch import _build
from gemm_hls_tpu_torch.config import GemmConfig, dtype_name
from gemm_hls_tpu_torch.ops.mxu import (
    _INT_MAX, _MAX_M, _dims, _row_major, _strides, batched_dims,
)
from gemm_hls_tpu_torch.ops.semiring import Semiring

# Bytes the plain version's mapped (M, ck, N) chunk may take.
_PLAIN_CHUNK_BYTES = 256 << 20

_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.int32)


def _shape(a, b, transpose_a, transpose_b):
    """(batch or None for 2-D operands, M, N, K)."""
    if a.ndim == 2 and b.ndim == 2:
        return (None, *_dims(a, b, transpose_a, transpose_b))
    return batched_dims(a, b, transpose_a, transpose_b)


def vpu_matmul_plain(a, b, *, cfg: GemmConfig, sr: Semiring,
                     transpose_a=False, transpose_b=False):
    """Plain version: a K-chunked broadcast map / reduce in the accumulator
    dtype, its mapped intermediate bounded to [B x] M x ck x N elements."""
    bsz, m, n, k = _shape(a, b, transpose_a, transpose_b)
    acc_dtype = cfg.tacc_dtype
    a_l = (a.transpose(-1, -2) if transpose_a else a).to(acc_dtype)
    b_l = (b.transpose(-1, -2) if transpose_b else b).to(acc_dtype)
    lead = () if bsz is None else (bsz,)
    acc = torch.full(lead + (m, n), sr.identity_for(acc_dtype),
                     dtype=acc_dtype, device=a.device)
    per_k = max(1, (bsz or 1) * m * n * acc_dtype.itemsize)
    ck = max(1, min(k, _PLAIN_CHUNK_BYTES // per_k))
    for k0 in range(0, k, ck):
        k1 = min(k, k0 + ck)
        mapped = sr.map_op(a_l[..., :, k0:k1, None], b_l[..., None, k0:k1, :])
        acc = sr.reduce_op(acc, sr.reduce_along(mapped, -2))
    return acc.to(cfg.tout_dtype)


def vpu_matmul(a, b, *, cfg: GemmConfig, sr: Semiring, transpose_a=False,
               transpose_b=False):
    """C = reduce_k map(op(A)[i,k], op(B)[k,j]) in ``cfg.out_dtype``: (M, N)
    for 2-D operands, (B, M, N) for batched ones."""
    bsz, m, n, k = _shape(a, b, transpose_a, transpose_b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return vpu_matmul_plain(a, b, cfg=cfg, sr=sr, transpose_a=transpose_a,
                                transpose_b=transpose_b)
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError(f"operands on {a.device} and {b.device}")
    if sr.op_code is None:
        raise NotImplementedError(
            f"semiring {sr.name!r} has no CUDA functor; custom semirings run "
            f"on CPU tensors or backend='torch' until their JIT lands "
            f"(ROADMAP B coverage item 5: custom-semiring JIT)")
    if a.dtype != b.dtype:
        raise ValueError(f"dtype mismatch: {a.dtype} vs {b.dtype}")
    if a.dtype not in _KERNEL_DTYPES:
        raise NotImplementedError(
            f"kernel B3 takes float32, bfloat16 and int32, not "
            f"{dtype_name(a.dtype)} (ROADMAP B coverage item 2)")
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
    (lda, sa), (ldb, sb) = _strides(a), _strides(b)
    lead = () if bsz is None else (bsz,)
    out = torch.empty(lead + (m, n), dtype=out_dtype, device=a.device)
    lib = _build.library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.semiring_gemm(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                               1 if bsz is None else bsz, m, n, k, lda,
                               ldb, sa, sb,
                               int(transpose_a), int(transpose_b),
                               _build.dtype_code(a.dtype),
                               _build.dtype_code(out_dtype), sr.op_code,
                               stream)
    _build.check(rc, f"semiring_gemm[{sr.name}]")
    vpu_matmul.launches += 1
    return out


# Kernel launches since the count was last reset (plain calls not counted).
vpu_matmul.launches = 0
