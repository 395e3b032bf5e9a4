"""Weight quantization and the quantized GEMM front doors.

Counterpart of ``gemm_hls_tpu/ops/quant.py``.  :func:`quantize_weights`
and :func:`dequantize_weights` are numpy-only copies of the JAX package's
(byte-identical output, planar int4 packing included: byte row ``i`` of a
K-group holds K-rows ``i`` (low nibble) and ``i + g/2`` (high nibble)).

:func:`matmul_quantized` (weight-only, kernel B13) and :func:`matmul_w8a8`
(int8 activations x int8 weights, kernels B14 / B15) resolve their blocks
as the JAX front doors do when no autotune entry exists (the v5e autotune
lookup is not ported).  ``block_k`` is semantic here, not a tile size:

* W8A8 quantizes the activations per (row, K-block of ``block_k``) on the
  fused route (B14), so the output depends on it; group-wise weight
  scales need ``group_size == block_k``;
* the dequant GEMM requires whole scale groups per K-block, and JAX's
  kernel folds the scales into the weights when a block holds several
  groups.  The port's kernel folds group-wise scales into every block
  (ROADMAP C2) and applies per-channel scales at the store, so there
  ``block_k`` only decides which calls are refused.

The CUDA kernels keep their own K step, independent of this ``block_k``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gemm_hls_tpu_torch.config import GemmConfig, dtype_name, round_up


def quantize_weights(w, bits: int = 8,
                     group_size: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric weight quantization: returns (w_q, scales).

    Args:
      w: (K, N) float weights.
      bits: 8 (int8, range +-127) or 4 (int4 values in +-7, packed).
      group_size: K-rows per scale group (must divide K; None = whole K,
        i.e. per-channel).

    Returns:
      w_q: int8 array -- (K, N) for bits=8; (K//2, N) planar-packed for
        bits=4 (two nibbles per byte, low = first half of each group).
      scales: f32 (K/group_size, N) -- (1, N) for per-channel.
    """
    w = np.asarray(w, np.float32)
    k, n = w.shape
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    g = group_size or k
    if k % g:
        raise ValueError(f"group_size {g} must divide K={k}")
    if bits == 4 and g % 2:
        raise ValueError(f"int4 needs an even group_size, got {g}")
    qmax = 127.0 if bits == 8 else 7.0

    wg = w.reshape(k // g, g, n)
    scales = np.abs(wg).max(axis=1) / qmax          # (k/g, n)
    scales = np.where(scales == 0, 1.0, scales).astype(np.float32)
    q = np.rint(wg / scales[:, None, :]).clip(-qmax, qmax).astype(np.int8)

    if bits == 8:
        return q.reshape(k, n), scales

    # int4 planar packing per group: byte row i <- (low: row i,
    # high: row i + g/2).  Both nibbles share the group's scale.
    half = g // 2
    lo = q[:, :half, :].astype(np.int8)
    hi = q[:, half:, :].astype(np.int8)
    packed = ((lo & 0x0F) | (hi << 4)).astype(np.int8)
    return packed.reshape(k // 2, n), scales


def dequantize_weights(w_q, scales, bits: int = 8,
                       group_size: Optional[int] = None) -> np.ndarray:
    """Reference (host) inverse of :func:`quantize_weights`."""
    w_q = np.asarray(w_q)
    scales = np.asarray(scales, np.float32)
    if bits == 8:
        k = w_q.shape[0]
        g = group_size or k
        return (w_q.reshape(k // g, g, -1).astype(np.float32)
                * scales[:, None, :]).reshape(k, -1)
    k2, n = w_q.shape
    k = 2 * k2
    g = group_size or k
    half = g // 2
    packed = w_q.reshape(k // g, half, n)
    lo = ((packed.astype(np.int8) << 4).astype(np.int8) >> 4)
    hi = packed.astype(np.int8) >> 4
    q = np.concatenate([lo, hi], axis=1).astype(np.float32)
    return (q * scales[:, None, :]).reshape(k, n)


def _on(x, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """``x`` (numpy or tensor) as a tensor on ``like``'s device."""
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                        device=like.device)
    return t if dtype is None else t.to(dtype)


# The JAX package's ``default_config`` blocks by element type
# (gemm_hls_tpu/config.py:291-297): 16-bit floats take (512, 1024, 1024),
# other types (float32, int8) (512, 512, 512).
def _reference_blocks(dtype) -> Tuple[int, int, int]:
    if dtype_name(dtype) in ("bfloat16", "float16"):
        return 512, 1024, 1024
    return 512, 512, 512


def dequant_config(m: int, n: int, k: int, dtype) -> GemmConfig:
    """The blocks ``matmul_quantized`` resolves for an (M, K) x (K, N)
    call without a config (quant.py:134-147): the dtype's default blocks,
    at M <= 128 ``block_n = min(2048, N)`` and ``block_k = min(2048, K)``
    (``matmul_quantized`` then aligns ``block_k`` to whole scale groups)."""
    bm, bn, bk = _reference_blocks(dtype)
    if m <= 128:
        bn, bk = min(2048, n), min(2048, k)
    return GemmConfig(dtype=dtype_name(dtype), block_m=bm, block_n=bn,
                      block_k=bk)


def matmul_quantized(x, w_q, scales, *, bits: int = 8,
                     group_size: Optional[int] = None,
                     config: Optional[GemmConfig] = None, out_dtype=None,
                     interpret: Optional[bool] = None):
    """y = x . dequant(w_q, scales), the dequantization inside kernel B13.

    Args:
      x: (M, K) activations (bf16 / fp16 / fp32 tensor).
      w_q, scales: from :func:`quantize_weights` (same bits/group_size),
        numpy or tensors; moved to x's device.
      config: optional GemmConfig; its ``block_k`` is aligned to whole
        scale groups.
      out_dtype: the output's type (default: x's).

    Inference path (no gradient); see ``ops/dequant.py``.
    """
    from gemm_hls_tpu_torch.ops.dequant import dequant_matmul

    m, k = x.shape
    n = w_q.shape[1]
    g = group_size or k
    cfg = config if config is not None else dequant_config(m, n, k, x.dtype)
    bk = min(cfg.block_k, k)
    if g != k:
        # Whole scale groups per K-block.
        bk = max(g, (bk // g) * g)
    cfg = cfg.replace(dtype=dtype_name(x.dtype), block_k=bk)
    if out_dtype is not None:
        cfg = cfg.replace(out_dtype=dtype_name(out_dtype))
    return dequant_matmul(x, _on(w_q, x), _on(scales, x, torch.float32),
                          cfg=cfg, bits=bits, group_size=group_size,
                          interpret=interpret)


def matmul_w8a8(x, w_q, scales, *, group_size: Optional[int] = None,
                config: Optional[GemmConfig] = None, out_dtype=None,
                interpret: Optional[bool] = None):
    """y ~ x . dequant(w_q, scales) on the int8 tensor cores: activations
    quantized dynamically (per (row, K-block) on the fused route B14, per
    row on the two-pass route B15), the dot exact in int32, both scales on
    the fp32 accumulator.  Error ~1e-2.  Output float32 unless
    ``out_dtype`` says otherwise.  Inference path."""
    from gemm_hls_tpu_torch.ops.dequant import w8a8_matmul

    cfg = w8a8_resolve(x.shape[0], w_q.shape[1], x.shape[1], group_size,
                       out_dtype, config)
    return w8a8_matmul(x, _on(w_q, x), _on(scales, x, torch.float32),
                       cfg=cfg, group_size=group_size, interpret=interpret)


def w8a8_resolve(m: int, n: int, k: int, group_size=None, out_dtype=None,
                 config: Optional[GemmConfig] = None) -> GemmConfig:
    """The config ``matmul_w8a8`` hands to ``w8a8_matmul``: the given blocks
    or, without a config, the int8 winner geometry clamped to the problem
    (quant.py:196-201); ``block_k`` clamped to K and set to the group size
    for group-wise scales; int8; the output type (default float32)."""
    g = group_size or k
    cfg = config if config is not None else GemmConfig(
        dtype="int8", block_m=min(512, round_up(m, 32)),
        block_n=min(1024, round_up(n, 128)), block_k=min(4096, round_up(k, 128)))
    bk = g if g != k else min(cfg.block_k, k)
    return cfg.replace(dtype="int8", block_k=bk,
                       out_dtype=dtype_name(out_dtype or torch.float32))
