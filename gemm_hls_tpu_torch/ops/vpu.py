"""Generic-semiring GEMM: the wrapper of kernel B3
(``csrc/semiring_gemm.cu``; float64 on the tile of its own in
``csrc/simt_gemm.cuh``, with the Num form's gate :func:`num_gate`) and its
plain PyTorch version.

Counterpart of ``gemm_hls_tpu/ops/pallas_vpu.py::vpu_matmul``, and of the
``jax.vmap`` over it that the JAX front door runs for 3-D operands.  Unlike
the TPU entry it takes whole, unpadded operands (the kernel masks M, N and
the K tail itself), the transpose flags (read through strides) and a batch
axis: 3-D operands, or one 3-D and one 2-D operand broadcast over the batch
through a batch stride of 0, run in one launch.  A CUDA tensor launches the
kernel or raises; a CPU tensor runs :func:`vpu_matmul_plain`.  A built-in
semiring runs its functor in the library (``op_code``); a user-defined one
(``op_code`` None) runs a functor generated from its map and reduce
(``ops/codegen.py``), built at first use into a library of its own for the
call's input type: the same tile, the same checks, no plain fallback.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from gemm_hls_tpu_torch import _build
from gemm_hls_tpu_torch.config import GemmConfig, dtype_name
from gemm_hls_tpu_torch.ops import codegen
from gemm_hls_tpu_torch.ops.mxu import (
    _INT_MAX, _MAX_M, _dims, _row_major, _strides, batched_dims,
)
from gemm_hls_tpu_torch.ops.semiring import Semiring

# Bytes the plain version's mapped (M, ck, N) chunk may take.
_PLAIN_CHUNK_BYTES = 256 << 20

# Input dtype -> the accumulator kernel B3 keeps it in (the reference's
# ``jacc_dtype``): fp32 for the 16- and 32-bit floats, float64 for float64,
# int32 for every integer type (each element widened, or wrapped, at the
# load as ``astype(int32)`` does).
_KERNEL_DTYPES = {
    torch.float32: torch.float32, torch.bfloat16: torch.float32,
    torch.float16: torch.float32, torch.float64: torch.float64,
    torch.int32: torch.int32, torch.int8: torch.int32, torch.int16: torch.int32,
    torch.uint8: torch.int32, torch.uint16: torch.int32,
    torch.uint32: torch.int32, torch.int64: torch.int32,
}


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
    if a.is_cuda:
        vpu_matmul_plain.cuda_calls += 1
    acc_dtype = cfg.tacc_dtype
    # ``.to`` first: a uint16 / uint32 CUDA tensor takes few other ops.
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
    if a.dtype != b.dtype:
        raise ValueError(f"dtype mismatch: {a.dtype} vs {b.dtype}")
    if a.dtype not in _KERNEL_DTYPES:
        raise NotImplementedError(
            f"kernel B3 takes no {dtype_name(a.dtype)} inputs (ROADMAP B "
            f"coverage item 15: uint64)")
    out_dtype = cfg.tout_dtype
    if cfg.tacc_dtype != _KERNEL_DTYPES[a.dtype]:
        raise NotImplementedError(
            f"accumulator {cfg.acc_dtype} for {dtype_name(a.dtype)} inputs: "
            f"kernel B3 keeps them in {dtype_name(_KERNEL_DTYPES[a.dtype])} "
            f"(ROADMAP B coverage item 16: a configured acc_dtype)")
    if sr.name == "log_plus" and not cfg.tacc_dtype.is_floating_point:
        raise NotImplementedError(
            f"log_plus on {dtype_name(a.dtype)} inputs: kernel B3 takes it "
            f"on floating accumulators, as torch.logaddexp does")
    if a.dtype.is_floating_point and not out_dtype.is_floating_point:
        raise NotImplementedError(
            f"{dtype_name(a.dtype)} -> {dtype_name(out_dtype)} output cast")
    if min(m, n, k) < 1 or m > _MAX_M or max(n, k) > _INT_MAX:
        raise ValueError(f"kernel B3 takes 1 <= M <= {_MAX_M} and "
                         f"1 <= N, K < 2^31, got ({m}, {n}, {k})")
    # A user semiring's functor, lowered (and any refusal raised) before
    # anything is allocated or built.
    gen = (None if sr.op_code is not None
           else codegen.semiring_kernel(sr, a.dtype, cfg.tacc_dtype))
    a, b = _row_major(a), _row_major(b)
    (lda, sa), (ldb, sb) = _strides(a), _strides(b)
    lead = () if bsz is None else (bsz,)
    out = torch.empty(lead + (m, n), dtype=out_dtype, device=a.device)
    args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), 1 if bsz is None else bsz,
            m, n, k, lda, ldb, sa, sb, int(transpose_a), int(transpose_b),
            _build.dtype_code(a.dtype, True), _build.dtype_code(out_dtype, True))
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        if gen is None:
            rc = _build.library().semiring_gemm(*args, sr.op_code, stream)
        else:
            rc = gen(*args, stream)
    _build.check(rc, f"semiring_gemm[{sr.name}]")
    vpu_matmul.launches += 1
    if gen is None:
        vpu_matmul.dtype_launches[dtype_name(a.dtype)] += 1
    else:
        vpu_matmul.generated_launches[dtype_name(a.dtype)] += 1
    return out


# The float64 tile's Num gate (csrc/semiring_ops.cuh: gate_sum,
# gate_minmax, gate_product) by semiring: whether a K slice of the block's
# operands lets no mapped value be NaN, so the one-compare form runs.
NUM_GATES = {"min_plus": "sum", "max_plus": "sum", "max_min": "minmax",
             "min_max": "minmax", "max_times": "product"}


def num_gate(semiring: str, *slices):
    """The float64 tile's verdict on a K slice whose in-bounds operand
    values are ``slices`` (arrays or tensors): True where the semiring's
    Num form runs (no NaN; for an added pair not both +inf and -inf; for a
    product no infinity beside a zero), False where the NaN-keeping form
    runs, None for a semiring without a Num form."""
    kind = NUM_GATES.get(semiring)
    if kind is None:
        return None
    vals = torch.cat([torch.as_tensor(x).reshape(-1).double() for x in slices])
    if bool(torch.isnan(vals).any()):
        return False
    pos, neg = bool((vals == float("inf")).any()), bool((vals == float("-inf")).any())
    if kind == "sum":
        return not (pos and neg)
    if kind == "product":
        return not ((pos or neg) and bool((vals == 0).any()))
    return True


def f64_slice_forms(reset: bool = True):
    """(Num slices, NaN-keeping slices) the library's float64 B3 tiles ran
    since the last reset: full K slices of the min / max semirings, summed
    over the blocks (``semiring_f64_forms``); ``reset`` sets both to 0.
    Synchronises the card."""
    out = (ctypes.c_ulonglong * 2)()
    _build.check(_build.library().semiring_f64_forms(ctypes.addressof(out), int(reset)),
                 "semiring_f64_forms")
    return int(out[0]), int(out[1])


# Kernel launches since the count was last reset (plain calls not counted),
# and the same by input dtype: the built-in semirings' (each type's
# semiring_*.cu instantiation) and the user semirings' generated functors.
vpu_matmul.launches = 0
vpu_matmul.dtype_launches = collections.Counter()
vpu_matmul.generated_launches = collections.Counter()
# Plain-version calls on CUDA tensors (the front door's backend="torch", or
# a comparison): a custom semiring on the card never falls back to it.
vpu_matmul_plain.cuda_calls = 0
