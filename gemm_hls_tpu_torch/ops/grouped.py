"""Grouped (ragged) matmul front door: the MoE expert GEMM.

Counterpart of ``gemm_hls_tpu/ops/grouped.py``.  ``grouped_matmul(lhs,
rhs, group_sizes)`` computes, for each group ``g``, ``out[rows(g), :] =
lhs[rows(g), :] @ rhs[g]`` where ``rows(g)`` is the contiguous row span
given by ``group_sizes``: ``jax.lax.ragged_dot`` semantics, with rows
past ``sum(group_sizes)`` defined as zero, on kernel B16
(``ops/gmm.py``).

Forward only in the port so far: the JAX package's custom VJP needs the
per-group weight-gradient kernel B17 (ROADMAP A, item 13).  On the card, a
call that would need a gradient raises rather than fall back to plain
autograd; on the CPU the plain version is differentiable as it is.
"""

from __future__ import annotations

from typing import Optional

import torch

from gemm_hls_tpu_torch.config import GemmConfig
from gemm_hls_tpu_torch.ops.gmm import grouped_mxu


def grouped_matmul(lhs, rhs, group_sizes, cfg: Optional[GemmConfig] = None,
                   *, transpose_rhs: bool = False):
    """Ragged grouped matmul (MoE expert GEMM), forward.

    Args:
      lhs: (M, K) activations, rows grouped contiguously by expert.
      rhs: (G, K, N) expert weights -- (G, N, K) with ``transpose_rhs``.
      group_sizes: (G,) integer rows-per-expert (a tensor on lhs's device,
        or anything ``torch.as_tensor`` takes); ``sum`` may be < M
        (trailing rows return zeros).  Oversized routing (``sum > M``) is
        not an error: every group's row range is clamped to [0, M), so the
        trailing rows are dropped.
      cfg: optional :class:`GemmConfig`; only its ``out_dtype`` is read
        (default: the promoted input type).  The kernel's tiles are its own.
      transpose_rhs: contract over each expert matrix's *last* axis.

    Returns (M, N).
    """
    if lhs.ndim != 2 or rhs.ndim != 3:
        raise ValueError(f"expected (M,K) x (G,K,N), got "
                         f"{tuple(lhs.shape)} x {tuple(rhs.shape)}")
    gs = torch.as_tensor(group_sizes, device=lhs.device)
    if gs.ndim != 1 or gs.shape[0] != rhs.shape[0]:
        raise ValueError(
            f"group_sizes must be ({rhs.shape[0]},), got {tuple(gs.shape)}")
    if gs.is_floating_point() or gs.is_complex() or gs.dtype == torch.bool:
        raise ValueError(f"group_sizes must be integer, got {gs.dtype}")
    if (lhs.device.type != "cpu" and torch.is_grad_enabled()
            and (lhs.requires_grad or rhs.requires_grad)):
        raise NotImplementedError(
            "grouped_matmul: no gradient on the card yet -- it needs the "
            "per-group weight-gradient kernel B17 (ROADMAP A, item 13)")
    out_dtype = cfg.tout_dtype if cfg is not None and cfg.out_dtype else None
    return grouped_mxu(lhs, rhs, gs, transpose_rhs=transpose_rhs,
                       out_dtype=out_dtype)
