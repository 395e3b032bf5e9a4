"""Gradients for additive-map semiring matmuls.

Counterpart of ``gemm_hls_tpu/ops/tropical_grad.py``:

* ``min_plus`` / ``max_plus``: the subgradient routes each output's
  cotangent to the k attaining the reduce, ties sharing it equally:
  ``dA[i,k] = sum_j g[i,j] * 1[k attains (i,j)] / ties[i,j]``.
* ``log_plus``: the gradient is the softmax weight of each term,
  ``dA[i,k] = sum_j g[i,j] * exp(A[i,k] + B[k,j] - C[i,j])``.
* ``max_min`` / ``min_max``: the map itself selects an operand, so dA gets
  the cotangent only where k is selected AND A[i,k] attains the map;
  map-level ties split the weight 0.5 / 0.5.

The forward is kernel B3 (through the front door's ``_vpu_dispatch``); the
backward recomputes the map in K chunks against the saved output, in plain
torch (the JAX package's backward is no Pallas kernel either).  The chunk
width is chosen from a memory budget (one (M, ck, N) fp32 chunk, of which
a pass holds a few at once) instead of the JAX package's fixed 128; it
changes only the order of the fp32 sums.  Batched operands (3-D, or one
2-D operand broadcast over the other's batch) take the backward per
example, the broadcast operand's gradient summed over the batch, as the
transpose of the JAX front door's vmap gives.
"""

from __future__ import annotations

import torch

_SUPPORTED = ("min_plus", "max_plus", "log_plus", "max_min", "min_max")

# Bytes one (M, ck, N) fp32 chunk of the backward may take.
_CHUNK_BYTES = 256 << 20


def tropical_matmul(a, b, semiring_name: str, config):
    """Differentiable C = reduce_k map(A[i,k], B[k,j]) for the five
    additive-map semirings (untransposed operands)."""
    if semiring_name not in _SUPPORTED:
        raise ValueError(
            f"tropical_matmul supports {_SUPPORTED}, got {semiring_name!r}")
    return _Tropical.apply(a, b, semiring_name, config)


class _Tropical(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, semiring_name, config):
        from gemm_hls_tpu_torch.ops.matmul import _vpu_dispatch
        from gemm_hls_tpu_torch.ops.semiring import get_semiring

        c = _vpu_dispatch(a, b, config, get_semiring(semiring_name))
        ctx.save_for_backward(a, b, c)
        ctx.semiring_name = semiring_name
        if not c.is_floating_point():
            ctx.mark_non_differentiable(c)
        return c

    @staticmethod
    def backward(ctx, g):
        a, b, c = ctx.saved_tensors
        da, db = _backward(ctx.semiring_name, a, b, c, g)
        return (da if ctx.needs_input_grad[0] else None,
                db if ctx.needs_input_grad[1] else None, None, None)


def _backward(name, a, b, c, g):
    if a.ndim == 2 and b.ndim == 2:
        return _backward_2d(name, a, b, c, g)
    das, dbs = [], []
    for z in range(c.shape[0]):
        da, db = _backward_2d(name, a[z] if a.ndim == 3 else a,
                              b[z] if b.ndim == 3 else b, c[z], g[z])
        das.append(da)
        dbs.append(db)
    da = torch.stack(das) if a.ndim == 3 else torch.stack(das).sum(0)
    db = torch.stack(dbs) if b.ndim == 3 else torch.stack(dbs).sum(0)
    return da, db


def _backward_2d(name, a, b, c, g):
    m, k = a.shape
    n = b.shape[1]
    ck = max(1, min(k, _CHUNK_BYTES // max(1, m * n * 4)))
    soft = name == "log_plus"
    selective_map = name in ("max_min", "min_max")

    def weight_chunk(k0, k1):
        """Per-term routing weights (w_a, w_b): softmax for log_plus, the
        arg-reduce equality mask for the tropical cases, times the
        map-operand selection for min / max maps."""
        a3 = a[:, k0:k1, None]                                   # (m, ck, 1)
        b3 = b[None, k0:k1, :]                                   # (1, ck, n)
        mapped = (torch.minimum(a3, b3) if name == "max_min"
                  else torch.maximum(a3, b3) if name == "min_max"
                  else a3 + b3)                                  # (m, ck, n)
        if soft:
            w = torch.exp(mapped - c[:, None, :]).to(torch.float32)
            return w, w
        w = (mapped == c[:, None, :]).to(torch.float32)
        if not selective_map:
            return w, w
        # Map-level selection: route to the operand attaining the map,
        # splitting ties 0.5 / 0.5.
        a_sel = (a3 < b3) if name == "max_min" else (a3 > b3)
        b_sel = (b3 < a3) if name == "max_min" else (b3 > a3)
        tie = 0.5 * (a3 == b3)
        return w * (a_sel + tie), w * (b_sel + tie)

    chunks = [(k0, min(k, k0 + ck)) for k0 in range(0, k, ck)]
    if soft:
        # Softmax weights already sum to 1 over k.
        g_shared = g.to(torch.float32)
    else:
        # Pass 1: reduce-level tie counts per output.  w_a + w_b sums to the
        # reduce mask for selective maps and to twice it for additive maps.
        count_factor = 1.0 if selective_map else 0.5
        ties = torch.zeros((m, n), dtype=torch.float32, device=a.device)
        for k0, k1 in chunks:
            w_a, w_b = weight_chunk(k0, k1)
            ties = ties + count_factor * (w_a + w_b).sum(1)
        g_shared = (g / torch.clamp(ties, min=1.0)).to(torch.float32)

    # Pass 2: route the cotangents through the weights.
    da = torch.empty((m, k), dtype=torch.float32, device=a.device)
    db = torch.empty((k, n), dtype=torch.float32, device=a.device)
    for k0, k1 in chunks:
        w_a, w_b = weight_chunk(k0, k1)
        da[:, k0:k1] = torch.einsum("mkn,mn->mk", w_a, g_shared)
        db[k0:k1] = torch.einsum("mkn,mn->kn", w_b, g_shared)
    return da.to(a.dtype), db.to(b.dtype)
