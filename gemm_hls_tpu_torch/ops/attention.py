"""Fused per-head attention on the batched GEMM kernel B2.

Counterpart of ``gemm_hls_tpu/ops/attention.py`` (``attention_scores``,
``attention``): the scores' row softmax runs inside the GEMM, so the scores
never reach device memory, only the probabilities.  A row softmax needs
whole rows in one block: kernel B2's row-softmax variant computes each
row's max and sum before it writes the row (``csrc/row_softmax_wgmma.cu``
on the tile engine, which computes the scores twice) or keeps a strip of
rows and every column in shared memory (``csrc/row_softmax.cu``, which
bounds the row length: ``config.ROW_SOFTMAX_MAX_N``, the port's
counterpart of the JAX package's VMEM rule, holds for both).  Past the bound the
scores are written in fp32 by B2's plain variant and softmaxed after, as
the JAX package does past its own rule (its ``attention.py:88-90``).

Numerics: scores accumulate in fp32; the softmax runs in fp32; only the
probabilities are cast to the storage dtype.  The max subtraction makes
the exp overflow-safe for any score magnitude.

``flash_attention`` is the flash path (``ops/flash.py``, kernels
``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``: TPU kernels B6-B12):
the probabilities never reach device memory.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from gemm_hls_tpu_torch.config import GemmConfig, dtype_name, row_softmax_fusable


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


def flash_attention(q, k, v, *, scale: Optional[float] = None,
                    causal: bool = False,
                    window: Optional[int] = None,
                    logit_cap: Optional[float] = None,
                    kv_lengths=None,
                    q_segment_ids=None, kv_segment_ids=None,
                    config: Optional[GemmConfig] = None,
                    block_q: Optional[int] = None,
                    block_kv: Optional[int] = None,
                    block_kv_compute: Optional[int] = None,
                    block_q_compute: Optional[int] = None,
                    bwd_block_q: Optional[int] = None,
                    bwd_block_kv: Optional[int] = None,
                    interpret: Optional[bool] = None):
    """Per-head attention in one kernel, softmax(q k^T scale) v with the
    probabilities never in device memory (``ops/flash.py``: kernels
    ``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``).

    Args:
      q: (B, S_q, D), or (batch, S_q, H, D) (auto-detected; the result
        comes back in the same layout, read and written in place).
      k, v: (B_kv, S_kv, D) / (batch, S_kv, H_kv, D); H_kv may divide H
        (GQA / MQA: each group of q heads reads its shared kv head, and the
        backward sums the group's dk / dv onto it).
      scale: score scale, default 1/sqrt(D); a Python number is applied to
        the fp32 scores in the kernel, a tensor is folded into q.
      window: sliding window (requires ``causal``): q attends
        (q_pos - window, q_pos].
      logit_cap: soft cap, scores squashed to cap tanh(s / cap).
      kv_lengths: per kv head (3-D) or per batch element (4-D) logical
        lengths for padded-cache decode; with ``causal`` the queries sit at
        the cache end.  Inference only (no gradient on this path).
      q_segment_ids / kv_segment_ids: (B, S) or (batch, S) int packed-
        sequence ids, broadcast over heads in the 4-D layout.
      config: accepted for the JAX signature (unused).
      block_q / bwd_block_q: the plain versions' q tiles; the other
        ``block_*`` arguments are accepted for the JAX signature.  The
        CUDA kernels' tiles are their own (csrc/flash_*.cu).  With
        ``block_q`` or ``block_kv`` None, a tuned ``flash`` winner for this
        shape bucket (``tools/autotune.py``: the user cache, then the
        packaged H100 seed) names the forward's and the backward pair's
        routes, as the JAX package's entry names its blocks
        (gemm_hls_tpu/ops/attention.py:203-224); a miss keeps
        ``flash_route`` / ``flash_bwd_route``.
      interpret: CUDA has no interpreter mode; True on a CUDA tensor
        raises.

    Returns the attention output in q's layout and dtype.
    """
    from gemm_hls_tpu_torch.ops import flash
    from gemm_hls_tpu_torch.ops.flash import flash_mha, flash_mha_diff

    del config, block_kv_compute, block_q_compute, bwd_block_kv
    four_d = q.ndim == 4
    decode_fast = False
    if four_d:
        if k.ndim != 4 or v.ndim != 4:
            raise ValueError(f"mixed layouts: {tuple(q.shape)} x "
                             f"{tuple(k.shape)}")
        nb, hq, hkv = q.shape[0], q.shape[2], k.shape[2]
        # Single-token decode: each kv head's group of q heads becomes the
        # q rows of one (batch * H_kv) head against the cache, read in
        # place; at S_q = 1 with decode anchoring, causal attends every
        # valid position, so it is dropped (attention.py:170-186).
        decode_fast = (q.shape[1] == 1 and hq % hkv == 0
                       and window is None and q_segment_ids is None
                       and logit_cap is None
                       and (kv_lengths is not None or not causal))
        if kv_lengths is not None:
            # One length per batch element -> one per kv head.
            kv_lengths = torch.as_tensor(
                kv_lengths, device=q.device).repeat_interleave(hkv)
        if decode_fast:
            # q head h reads kv head h // group: (kv head, within group)
            # keeps head identity.
            q = q.reshape(nb * hkv, hq // hkv, q.shape[3])
            causal = False
        elif q_segment_ids is not None:
            q_segment_ids = torch.as_tensor(
                q_segment_ids, device=q.device).repeat_interleave(hq, 0)
            kv_segment_ids = torch.as_tensor(
                kv_segment_ids, device=q.device).repeat_interleave(hkv, 0)
    elif q.ndim != 3:
        raise ValueError(f"flash_attention expects (B, S, D) or "
                         f"(batch, S, H, D), got {tuple(q.shape)}")
    route = bwd_route = None
    if block_q is None or block_kv is None:
        from gemm_hls_tpu_torch.tools.autotune import cached_family_entry

        e = cached_family_entry(
            "flash", (flash._heads(q), q.shape[1], k.shape[1], q.shape[-1]),
            dtype=dtype_name(q.dtype), tag="causal" if causal else "full",
            device=q.device, aligned=bool(flash._vec(q, k, v))) or {}
        route, bwd_route = e.get("route"), e.get("bwd_route")
    block_q = block_q or 512
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if isinstance(scale, (int, float)):
        qs, kscale = q, float(scale)
    else:
        qs = (q * torch.as_tensor(scale, dtype=q.dtype)).to(q.dtype)
        kscale = 1.0
    if kv_lengths is not None:
        out = flash_mha(qs, k, v, kv_lengths, q_segment_ids, kv_segment_ids,
                        causal=causal, block_q=block_q, interpret=interpret,
                        window=window, logit_cap=logit_cap, scale=kscale,
                        route=route)
    else:
        out = flash_mha_diff(qs, k, v, q_segment_ids, kv_segment_ids,
                             causal=causal, block_q=block_q,
                             interpret=interpret, window=window,
                             logit_cap=logit_cap, bwd_block_q=bwd_block_q,
                             scale=kscale, route=route, bwd_route=bwd_route)
    if decode_fast:
        # The (batch * H_kv, group, D) rows are the q heads of one token.
        out = out.reshape(nb, 1, hq, out.shape[-1])
    return out
