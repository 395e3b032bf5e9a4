"""Graph algorithms on the semiring GEMM: the application layer.

Counterpart of ``gemm_hls_tpu/models/graph.py``.  The reference motivates
its configurable semiring with the distance product (reference
``README.md:50``); these are its applications, each on the front door
``matmul`` (kernel B3 for the semirings, B1 for PageRank's (+, x) and for
the default bool closure), on the device of the input:

* :func:`distance_product`: one (min, +) relaxation step.
* :func:`all_pairs_shortest_paths`: repeated (min, +) squaring,
  ceil(log2(n - 1)) GEMMs.
* :func:`transitive_closure`: boolean reachability by (or, and) squaring.
* :func:`widest_paths`: bottleneck paths in (max, min).
* :func:`pagerank`: power iteration on (+, x).

Each takes a ``matmul_fn`` hook in place of the front door (a distributed
GEMM, or another backend).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from gemm_hls_tpu_torch.config import GemmConfig
from gemm_hls_tpu_torch.ops.matmul import matmul


def distance_product(d1, d2, *, config: Optional[GemmConfig] = None,
                     matmul_fn: Optional[Callable] = None):
    """(min, +) product: out[i,j] = min_k d1[i,k] + d2[k,j]."""
    if matmul_fn is not None:
        return matmul_fn(d1, d2)
    return matmul(d1, d2, semiring="min_plus", config=config)


def _square_until_fixed(x, n: int, semiring: str, config, matmul_fn):
    """Repeated semiring squaring: ceil(log2(n-1)) steps cover all simple
    paths of an n-node graph (shared by APSP / closure / widest paths)."""
    for _ in range(max(1, math.ceil(math.log2(max(n - 1, 2))))):
        if matmul_fn is not None:
            x = matmul_fn(x, x)
        else:
            x = matmul(x, x, semiring=semiring, config=config)
    return x


def _eye(n, like):
    return torch.eye(n, dtype=torch.bool, device=like.device)


def all_pairs_shortest_paths(adj, *, config: Optional[GemmConfig] = None,
                             matmul_fn: Optional[Callable] = None):
    """APSP via repeated squaring in the tropical semiring.

    Args:
      adj: (n, n) edge-weight matrix; +inf where no edge; the diagonal is
        forced to 0 (paths of length 0).
    Returns the shortest-path distance matrix after ceil(log2(n - 1))
    squarings.
    """
    n = adj.shape[0]
    d = torch.where(_eye(n, adj), torch.zeros_like(adj), adj)
    return _square_until_fixed(d, n, "min_plus", config, matmul_fn)


def transitive_closure(adj, *, config: Optional[GemmConfig] = None,
                       matmul_fn: Optional[Callable] = None):
    """Boolean reachability closure via (or, and) repeated squaring."""
    n = adj.shape[0]
    r = adj.to(torch.bool) | _eye(n, adj)
    return _square_until_fixed(r, n, "or_and", config, matmul_fn)


def pagerank(adj, *, damping: float = 0.85, iters: int = 50,
             config: Optional[GemmConfig] = None,
             matmul_fn: Optional[Callable] = None):
    """PageRank by power iteration on the (+, x) semiring.

    Args:
      adj: (n, n) adjacency matrix (adj[i, j] != 0 means an edge i -> j).
    Returns the stationary rank vector (n,).
    """
    n = adj.shape[0]
    edges = adj.to(torch.float32) != 0
    out_deg = torch.clamp(edges.sum(dim=1, keepdim=True), min=1)
    # Column-stochastic transition matrix, dangling nodes -> uniform.
    t = torch.where(edges, 1.0 / out_deg, 0.0).to(torch.float32)
    dangling = (edges.sum(dim=1) == 0).to(torch.float32)
    r = torch.full((n, 1), 1.0 / n, dtype=torch.float32, device=adj.device)
    if matmul_fn is None:
        t_t = t.T.contiguous()  # one copy, not one per iteration

        def step(r_):
            return matmul(t_t, r_, config=config)
    else:
        def step(r_):
            return matmul_fn(t.T, r_)
    for _ in range(iters):
        flow = step(r)  # (n, 1)
        leak = torch.sum(dangling[:, None] * r) / n
        r = damping * (flow + leak) + (1.0 - damping) / n
    return r[:, 0]


def widest_paths(cap, *, config: Optional[GemmConfig] = None,
                 matmul_fn: Optional[Callable] = None):
    """All-pairs bottleneck (maximum-capacity) paths in (max, min).

    Args:
      cap: (n, n) capacity matrix; 0 (or -inf) where no edge; the diagonal
        is forced to +inf (a node reaches itself with unlimited capacity).
    """
    n = cap.shape[0]
    w = torch.where(_eye(n, cap), torch.full_like(cap, float("inf")), cap)
    return _square_until_fixed(w, n, "max_min", config, matmul_fn)
