"""Fused per-head attention on the batched GEMM kernel B2.

Counterpart of ``gemm_hls_tpu/ops/attention.py`` (``attention_scores``,
``attention``): the scores' row softmax runs inside the GEMM, so the scores
never reach device memory, only the probabilities.  A row softmax needs
whole rows in one block: kernel B2's row-softmax variant
(``csrc/row_softmax.cu``) keeps a strip of rows and every column in shared
memory, which bounds the row length (``config.ROW_SOFTMAX_MAX_N``, the
port's counterpart of the JAX package's VMEM rule).  Past the bound the
scores are written in fp32 by B2's plain variant and softmaxed after, as
the JAX package does past its own rule (its ``attention.py:88-90``).

Numerics: scores accumulate in fp32; the softmax runs in fp32; only the
probabilities are cast to the storage dtype.  The max subtraction makes
the exp overflow-safe for any score magnitude.

The flash kernels (``flash_attention``, ``flash_mha_diff``; TPU kernels
B6-B12) are slice 3 of the port.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from gemm_hls_tpu_torch.config import GemmConfig, row_softmax_fusable


def _fused_scores_ok(q, k, config: Optional[GemmConfig]) -> bool:
    """Whether the scores' softmax can ride kernel B2's row-softmax variant:
    the row (S_k) fits its shared-memory strip and the config takes no
    route that splits rows (strict padding, like the JAX rule)."""
    if config is not None and config.pad_policy == "strict":
        return False
    return row_softmax_fusable(q.dtype, k.shape[1])


def attention_scores(q, k, *, scale: Optional[float] = None,
                     config: Optional[GemmConfig] = None,
                     interpret: Optional[bool] = None):
    """softmax(q . k^T * scale) per head, the softmax fused into kernel B2.

    Args:
      q: (B, S_q, D) per-head queries.
      k: (B, S_k, D) per-head keys (contracted via ``transpose_b``; no
        materialised transpose).
      scale: score scale; default 1/sqrt(D).  It is folded into q (rounded
        to q's dtype first, as the reference does), so the epilogue takes
        no parameter.

    Returns (B, S_q, S_k) probabilities in q's dtype.  Differentiable: the
    backward recomputes the fp32 scores on B2 and pulls the cotangent back
    through the softmax.
    """
    from gemm_hls_tpu_torch.ops.matmul import matmul

    if q.ndim != 3 or k.ndim != 3:
        raise ValueError(f"attention_scores expects (B, S, D) operands, "
                         f"got {tuple(q.shape)} x {tuple(k.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    # A 0-dim CPU tensor enters a CUDA kernel as a scalar argument: no
    # host-to-device copy, which would synchronise the stream every call.
    qs = q * torch.tensor(scale, dtype=q.dtype)
    if _fused_scores_ok(q, k, config):
        return matmul(qs, k, transpose_b=True, config=config,
                      interpret=interpret, epilogue="softmax")
    scores = matmul(qs, k, transpose_b=True, config=config,
                    interpret=interpret, out_dtype=torch.float32)
    return torch.softmax(scores, dim=-1).to(q.dtype)


def attention(q, k, v, *, scale: Optional[float] = None,
              config: Optional[GemmConfig] = None,
              interpret: Optional[bool] = None):
    """Per-head attention: softmax(q . k^T * scale) . v, the softmax fused
    into the first batched GEMM and p . v on B2's plain variant.

    Args:
      q: (B, S_q, D); k: (B, S_k, D); v: (B, S_k, D).

    Returns (B, S_q, D) in q's dtype.  The probabilities are materialised
    once in device memory between the two GEMMs (fused-scores attention,
    not flash attention: O(S^2) memory).
    """
    from gemm_hls_tpu_torch.ops.matmul import matmul

    p = attention_scores(q, k, scale=scale, config=config,
                         interpret=interpret)
    return matmul(p, v, config=config, interpret=interpret)


def flash_attention(*args, **kwargs):
    raise NotImplementedError(
        "flash_attention is not ported yet (ROADMAP A, slice 3: flash "
        "attention, kernels B6-B12); use attention() for fused-scores "
        "attention")


def flash_mha_diff(*args, **kwargs):
    raise NotImplementedError(
        "flash_mha_diff is not ported yet (ROADMAP A, slice 3: flash "
        "attention, kernels B6-B12)")
