"""fp32-class GEMM on the int8 tensor cores via integer slice decomposition.

Counterpart of ``gemm_hls_tpu/ops/int8_slices.py``.  Hopper's int8 dense
rate (1979 TOP/s) is twice its bf16 rate; this module trades it for
fp32-class accuracy:

1. Each fp32 operand is quantized into n signed-int8 slices of 7 magnitude
   bits on a shared per-row (A) / per-column (B) exponent grid:
   ``x ~= ulp_row * (s0 + s1/2^7 + s2/2^14 + ...)``.
2. The slice pairs with i + j < n run on the int8 tensor cores with int32
   accumulation, exact while ``n * 127^2 * K < 2^31``: kernel B4
   (``ops/slice_kernels.py``), one accumulator per diagonal over all of K,
   or kernel B5 past that bound, flushing per K block into (hi, lo).
3. The result is rescaled by the row / column ulps.

Accuracy (``n_slices``): 2 slices ~2^-14 normwise, 3 ~2^-21, 4 the fp32
output floor; 3 / 6 / 10 int8 products per output.

The quantize is elementwise torch work (as the JAX package does it
outside Pallas).  Its exponent is the exact ``floor(log2(amax)) + 1`` from
``torch.frexp``: the JAX package takes ``floor(log2(amax))`` with
``jnp.log2 = log(x) / log(2)``, which lands just below the integer at some
exact powers of two (8192, 32768, ...), so there its ulp is half this one
and its top slice clips at 127 (ROADMAP C2).  Everywhere else the slices
and ulps are bit-identical.
"""

from __future__ import annotations

import logging

import torch

from gemm_hls_tpu_torch.config import default_config, round_up
from gemm_hls_tpu_torch.ops import mxu
from gemm_hls_tpu_torch.ops.slice_kernels import (
    SLICE_BITS, _two_sum, fused_int8_fp32, fused_ozaki_int8,
)

__all__ = ["SLICE_BITS", "fp32_matmul_int8"]

_log = logging.getLogger(__name__)


def _exponent(amax):
    """``floor(log2(amax)) + 1`` as an int32 tensor, exactly (1 where
    ``amax`` is 0): with amax = m * 2^e and m in [0.5, 1), it is e."""
    safe = torch.where(amax > 0, amax, torch.ones_like(amax))
    return torch.frexp(safe).exponent


def _exp2(e, dtype=torch.float32):
    """2^e for an integer tensor, exactly (built as a float64 bit pattern,
    then cast: exact for every power of two ``dtype`` holds)."""
    return ((e.to(torch.int64) + 1023) << 52).view(torch.float64).to(dtype)


def _quantize_slices(x, axis: int, n_slices: int = 3, stacked: bool = True):
    """int8 slices + per-vector ulp (fp32): a stacked (n_slices, *x.shape)
    tensor, or a list of per-slice tensors with ``stacked=False`` (which
    kernel B4 reads slice by slice, with no stacked copy).

    Shared exponent along ``axis`` (the contraction axis), so every product
    in one output's dot shares the grid: the block-fixed-point property
    that makes the int32 accumulation exact.
    """
    r = x.to(torch.float32)
    amax = torch.linalg.vector_norm(r, float("inf"), dim=axis, keepdim=True)
    # ulp = 2^(e - SLICE_BITS) with 2^(e-1) <= max < 2^e.
    ulp = _exp2(_exponent(amax) - SLICE_BITS)
    slices = []
    cur_ulp = ulp
    for i in range(n_slices):
        q = torch.div(r, cur_ulp, rounding_mode="trunc").clamp_(-127, 127)
        slices.append(q.to(torch.int8))
        if i + 1 < n_slices:
            # r - q * ulp, exact (q * ulp lies on r's grid), in one pass; the
            # first update allocates, so ``x`` itself is never written.
            r = (torch.addcmul(r, q, cur_ulp, value=-1) if i == 0
                 else r.addcmul_(q, cur_ulp, value=-1))
        cur_ulp = cur_ulp * (2.0 ** -SLICE_BITS)
    return (torch.stack(slices) if stacked else slices), ulp


class _I8Matmul(torch.autograd.Function):
    """C = A . B on the slice scheme; the gradient of the bilinear map is
    dA = g . B^T, dB = A^T . g, computed with the same scheme."""

    @staticmethod
    def forward(ctx, a, b, block_m, block_n, block_k, n_slices, fused):
        ctx.save_for_backward(a, b)
        ctx.args = (block_m, block_n, block_k, n_slices, fused)
        return _fp32_matmul_int8_impl(a, b, *ctx.args)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _fp32_matmul_int8_impl(g, b.T, *ctx.args).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = _fp32_matmul_int8_impl(a.T, g, *ctx.args).to(b.dtype)
        return da, db, None, None, None, None, None


def fp32_matmul_int8(a, b, *, block_m: int = 512, block_n: int = 1024,
                     block_k: int = 8192, n_slices: int = 3,
                     fused: bool = None):
    """C = A . B for (M, K) x (K, N) float32 operands on the int8 tensor
    cores; differentiable (the backward runs the same scheme).

    ``fused`` (default True) runs the single-kernel slice triangle: kernel
    B4 while ``n_slices * 127^2 * K_padded < 2^31`` (K padded as the JAX
    package pads it, so both route alike), else kernel B5 with ``block_k``
    halved until each block's diagonals are exact (K unbounded).  ``False``
    runs staged per-pair int8 GEMMs on B1 (each int32 partial through device
    memory), kept for cross-validation; it needs K <= 2^17.
    """
    if fused is None:
        fused = True
    return _I8Matmul.apply(a, b, block_m, block_n, block_k, n_slices, fused)


def _fp32_matmul_int8_impl(a, b, block_m: int = 512, block_n: int = 1024,
                           block_k: int = 8192, n_slices: int = 3,
                           fused: bool = True):
    m, k = a.shape
    n = b.shape[1]
    if not fused and k > (1 << 17):
        raise ValueError(f"K={k} exceeds the int32 exactness bound (2^17) "
                         "of the staged path; use fused=True")
    sa, ulp_a = _quantize_slices(a, axis=1, n_slices=n_slices,
                                 stacked=False)  # ulp (m, 1)
    # B's slices as (K, N) views of K-contiguous (N, K) storage, the layout
    # kernels B4 / B5 read (int8 MMA operands are K-major); the same values
    # as quantizing b along axis 0.
    sbt, ulp_bt = _quantize_slices(b.T.contiguous(), axis=1,
                                   n_slices=n_slices, stacked=False)
    sb, ulp_b = [s.T for s in sbt], ulp_bt.T  # ulp (1, n)

    if fused:
        # The whole-K route's gate uses the K the JAX package pads to, so
        # both packages take the same kernel; B4 itself walks the unpadded K.
        bk_fast = min(block_k, 2048, round_up(k, 256))
        if n_slices * (127 ** 2) * round_up(k, bk_fast) < (1 << 31):
            return fused_int8_fp32(tuple(sa), tuple(sb), ulp_a, ulp_b,
                                   block_m=block_m, block_n=block_n,
                                   block_k=bk_fast, n_diags=n_slices)
        # Past the whole-K int32 bound: the hi/lo kernel with exact per-block
        # flushes (the JAX package's own routing).
        bk = min(block_k, 4096, round_up(k, 256))
        while n_slices * (127 ** 2) * bk >= (1 << 31):
            bk //= 2
        _log.info("fp32_matmul_int8: K=%d with %d slices is past the whole-K "
                  "int32 bound; kernel B5 with block_k=%d", k, n_slices, bk)
        # n_diags = n_slices matches the staged triangle (3 products for
        # i8x2, 6 for i8x3).
        hi, lo = fused_ozaki_int8(tuple(sa), tuple(sb), block_m=block_m,
                                  block_n=block_n, block_k=bk,
                                  n_diags=n_slices)
        return (hi + lo) * ulp_a * ulp_b

    cfg = default_config("int8", out_dtype="int32")
    hi = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    lo = torch.zeros_like(hi)
    for s in range(n_slices):
        for i in range(s + 1):
            j = s - i
            p = mxu.mxu_matmul(sa[i], sbt[j], cfg=cfg,
                               transpose_b=True)              # exact int32
            w = 2.0 ** (-SLICE_BITS * (i + j))
            # Exact fp32 split of the int32 partial (each half < 2^20).
            p_hi = (p >> 12).to(torch.float32) * 4096.0 * w
            p_lo = (p & 4095).to(torch.float32) * w
            hi, err = _two_sum(hi, p_hi)
            lo = lo + err
            hi, err = _two_sum(hi, p_lo)
            lo = lo + err
    return (hi + lo) * ulp_a * ulp_b
