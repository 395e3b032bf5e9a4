"""Grouped (ragged) matmul front door: the differentiable MoE expert GEMM.

Counterpart of ``gemm_hls_tpu/ops/grouped.py``.  ``grouped_matmul(lhs,
rhs, group_sizes)`` computes, for each group ``g``, ``out[rows(g), :] =
lhs[rows(g), :] @ rhs[g]`` where ``rows(g)`` is the contiguous row span
given by ``group_sizes``: ``jax.lax.ragged_dot`` semantics, with rows
past ``sum(group_sizes)`` defined as zero, on kernel B16
(``ops/gmm.py``).

Differentiable through one autograd Function on every device, as the JAX
package's custom VJP: the lhs cotangent is another grouped matmul (B16)
with the contraction flipped onto the experts' other axis (read in place,
no transpose materialised), and the rhs cotangent is the per-group
weight-gradient kernel B17 (``grouped_update_mxu``, ``lhs[rows(g)].T @
g[rows(g)]``).  On the CPU both are the plain versions, so the CPU tests
run the composition the card runs.
"""

from __future__ import annotations

from typing import Optional

import torch

from gemm_hls_tpu_torch.config import GemmConfig, dtype_name
from gemm_hls_tpu_torch.ops.gmm import _vec, grouped_mxu, grouped_update_mxu


class _Grouped(torch.autograd.Function):
    """B16 forward; backward: B16 for dlhs (``transpose_rhs`` flipped,
    out in lhs's type), B17 for drhs (out in rhs's type), each launched
    only if its input needs a gradient."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes, out_dtype, transpose_rhs, route):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        ctx.transpose_rhs = transpose_rhs
        return grouped_mxu(lhs, rhs, group_sizes, transpose_rhs=transpose_rhs,
                           out_dtype=out_dtype, route=route)

    @staticmethod
    def backward(ctx, g):
        lhs, rhs, group_sizes = ctx.saved_tensors
        trb = ctx.transpose_rhs
        dlhs = drhs = None
        if ctx.needs_input_grad[0]:
            dlhs = grouped_mxu(g, rhs, group_sizes, transpose_rhs=not trb,
                               out_dtype=lhs.dtype)
        if ctx.needs_input_grad[1]:
            a, b = (g, lhs) if trb else (lhs, g)
            drhs = grouped_update_mxu(a, b, group_sizes,
                                      num_groups=rhs.shape[0],
                                      out_dtype=rhs.dtype)
        return dlhs, drhs, None, None, None, None


def grouped_matmul(lhs, rhs, group_sizes, cfg: Optional[GemmConfig] = None,
                   *, transpose_rhs: bool = False):
    """Differentiable ragged grouped matmul (MoE expert GEMM).

    Args:
      lhs: (M, K) activations, rows grouped contiguously by expert.
      rhs: (G, K, N) expert weights -- (G, N, K) with ``transpose_rhs``.
      group_sizes: (G,) integer rows-per-expert (a tensor on lhs's device,
        or anything ``torch.as_tensor`` takes); ``sum`` may be < M
        (trailing rows return zeros).  Oversized routing (``sum > M``) is
        not an error: every group's row range is clamped to [0, M), so the
        trailing rows are dropped.
      cfg: optional :class:`GemmConfig`; only its output type is read,
        ``out_dtype`` else ``dtype`` (float32 by default), as the JAX
        package's ``cfg.jout_dtype``.  Without a config the output is the
        promoted input type, and a tuned ``grouped`` winner for this
        (M, K, N, G) bucket (``tools/autotune.py``: the user cache, then the
        packaged H100 seed) names B16's forward route, as the JAX package's
        entry names its blocks (gemm_hls_tpu/ops/grouped.py:43-56); a miss
        keeps ``ops/gmm.py::grouped_route``.  The kernel's tiles are its
        own; the backward keeps the route rule.
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
    out_dtype = cfg.tout_dtype if cfg is not None else None
    route = None
    if cfg is None and lhs.dtype == rhs.dtype:
        from gemm_hls_tpu_torch.tools.autotune import cached_family_entry

        k = lhs.shape[1]
        n = rhs.shape[1] if transpose_rhs else rhs.shape[2]
        e = cached_family_entry(
            "grouped", (lhs.shape[0], k, n, rhs.shape[0]),
            dtype=dtype_name(lhs.dtype), device=lhs.device,
            aligned=bool(k and _vec(lhs, k) and _vec(rhs, k if transpose_rhs else n)))
        route = (e or {}).get("route")
    return _Grouped.apply(lhs, rhs, gs, out_dtype, bool(transpose_rhs), route)
