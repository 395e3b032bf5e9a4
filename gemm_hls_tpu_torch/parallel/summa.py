"""SUMMA and Cannon distributed CA-GEMM over a mesh of ranks: the port of
``gemm_hls_tpu/parallel/summa.py``.

* :func:`summa_matmul`: gather-SUMMA.  Each rank all-gathers its A panel
  over the column axis and its B panel over the row axis, then runs one
  local GEMM.  Rectangular meshes, any semiring, transpose flags.
* :func:`cannon_matmul`: Cannon's algorithm on a square mesh.  A joint-axis
  skew (rank (i, j) sends A to (i, j - i) and B to (i - j, j)), then p
  local GEMMs with a shift of A along the row and of B along the column
  between them; the partials are combined by the semiring's reduce in the
  accumulator type and cast once.

The local step is the port's front door ``ops.matmul.matmul`` on each
rank's device: kernel B1 for plus_times, B3 for the other semirings (each
rank one launch a call for SUMMA, p for Cannon).  The collectives are
``parallel/sharding.py``'s copies between ranks.  Each front door leaves
the kernel route every rank took in ``last_routes`` ({rank: [route, ...]},
on CUDA ranks).
"""

from __future__ import annotations

from typing import Optional, Tuple

from gemm_hls_tpu_torch.config import GemmConfig, default_config, torch_dtype
from gemm_hls_tpu_torch.ops import mxu
from gemm_hls_tpu_torch.ops.matmul import matmul
from gemm_hls_tpu_torch.ops.semiring import Semiring, get_semiring
from gemm_hls_tpu_torch.parallel.mesh import Mesh
from gemm_hls_tpu_torch.parallel.sharding import (
    P, Sharded, all_gather, device_put, map_shards, ppermute, rank_coords,
)


def _local_config(config: Optional[GemmConfig], dtype, semiring: str,
                  out_dtype=None):
    """(accumulator type, output type) of each rank's local matmul.

    Each rank's call takes the caller's config as given (the front door
    holds it to a compiled tile) or None (the front door's choice for the
    local shape: a cached winner, else the route rule).  The JAX package
    clamps its blocks to the local shard (the TPU's layout rules); a
    clamped block names no compiled tile of the port, so nothing is clamped
    here."""
    base = config if config is not None else default_config(dtype, semiring=semiring)
    out = torch_dtype(out_dtype) if out_dtype is not None else base.tout_dtype
    return base.tacc_dtype, out


def _local_matmul(routes: dict, coord, a, b, sr: Semiring, **kw):
    """One rank's local GEMM, its kernel route recorded in ``routes``."""
    out = matmul(a, b, semiring=sr, **kw)
    if a.is_cuda:
        route = mxu.mxu_matmul.last_route if sr.is_mxu else "semiring_gemm"
        routes.setdefault(coord, []).append(route)
    return out


def shard_operands_2d(a, b, mesh: Mesh, axes: Tuple[str, str] = ("x", "y")):
    """Place A as P(x, y) over (M, K) and B as P(x, y) over (K, N)."""
    ax, ay = axes
    return device_put(a, mesh, P(ax, ay)), device_put(b, mesh, P(ax, ay))


def summa_matmul(a, b, mesh: Mesh, *, axes: Tuple[str, str] = ("x", "y"),
                 semiring="plus_times", config: Optional[GemmConfig] = None,
                 out_dtype=None, transpose_a: bool = False,
                 transpose_b: bool = False) -> Sharded:
    """Gather-SUMMA: C[P(x, y)] = op(A) . op(B), operands P(x, y)-sharded
    (tensors, numpy arrays or :class:`Sharded` laid out otherwise are
    placed first).

    Bytes each rank receives: (py - 1) / py of its A row panel (M/px x K)
    plus (px - 1) / px of its B column panel (K x N/py), the 2-D
    communication-avoiding optimum for a stationary C
    (``models/scaling_model.comm_volume_per_device("summa", ...)``).

    ``transpose_a``: A is supplied (K, M) sharded P(y, x); the gathered
    panel stays K-major and the local GEMM reads it transposed, with no
    copy.  ``transpose_b`` likewise takes B as (N, K) sharded P(y, x).
    """
    sr = get_semiring(semiring)
    ax, ay = axes
    px, py = mesh.shape[ax], mesh.shape[ay]
    m, k = (a.shape[1], a.shape[0]) if transpose_a else tuple(a.shape)
    n = b.shape[0] if transpose_b else b.shape[1]
    if m % px or k % (px * py) or n % py:
        raise ValueError(
            f"shape ({m},{n},{k}) not divisible by mesh {px}x{py} "
            f"(K must divide {px * py})")
    a_s = device_put(a, mesh, P(ay, ax) if transpose_a else P(ax, ay))
    b_s = device_put(b, mesh, P(ay, ax) if transpose_b else P(ax, ay))
    # Gather the K axis whatever the layout: axis 0 of a (K, M/px)
    # transposed panel, axis 1 of an (M/px, K) one.
    a_pan = all_gather(a_s.shards, mesh, ay, dim=0 if transpose_a else 1)
    b_pan = all_gather(b_s.shards, mesh, ax, dim=1 if transpose_b else 0)
    routes = {}

    def local(coord):
        c = _local_matmul(routes, coord, a_pan[coord], b_pan[coord], sr, config=config,
                          out_dtype=out_dtype, transpose_a=transpose_a, transpose_b=transpose_b)
        a_pan[coord] = b_pan[coord] = None  # a rank's panels live for its GEMM only
        return c

    shards = map_shards(local, rank_coords(mesh), mesh=mesh)
    summa_matmul.last_routes = routes
    return Sharded(mesh, P(ax, ay), (m, n), shards)


def cannon_matmul(a, b, mesh: Mesh, *, axes: Tuple[str, str] = ("x", "y"),
                  semiring="plus_times", config: Optional[GemmConfig] = None,
                  out_dtype=None) -> Sharded:
    """Cannon's algorithm on a square (p x p) mesh: skew, then p steps of
    local GEMM and ring shifts; O(|A_blk| + |B_blk|) memory a rank.

    Bytes each rank receives in the shifts: (p - 1) (|A_blk| + |B_blk|)
    (``comm_volume_per_device("cannon", ...)``); the skew's, which the
    model leaves out, are counted under the tag "skew"."""
    sr = get_semiring(semiring)
    ax, ay = axes
    p = mesh.shape[ax]
    if mesh.shape[ay] != p:
        raise ValueError(f"cannon_matmul needs a square mesh, got "
                         f"{mesh.shape[ax]}x{mesh.shape[ay]}")
    m, k = tuple(a.shape)
    n = b.shape[1]
    if m % p or n % p or k % p:
        raise ValueError(f"shape ({m},{n},{k}) not divisible by mesh {p}x{p}")
    a_s = device_put(a, mesh, P(ax, ay))
    b_s = device_put(b, mesh, P(ax, ay))
    acc_dtype, out = _local_config(config, a_s.dtype, sr.name, out_dtype)

    # Joint-axis permutations, linearized as i * p + j.
    skew_a = [(i * p + j, i * p + ((j - i) % p)) for i in range(p) for j in range(p)]
    skew_b = [(i * p + j, ((i - j) % p) * p + j) for i in range(p) for j in range(p)]
    shift_left = [(j, (j - 1) % p) for j in range(p)]
    shift_up = [(i, (i - 1) % p) for i in range(p)]

    a_blk = ppermute(a_s.shards, mesh, (ax, ay), skew_a, tag="skew")
    b_blk = ppermute(b_s.shards, mesh, (ax, ay), skew_b, tag="skew")
    routes = {}
    coords = rank_coords(mesh)

    def step(coord, x, y):
        return _local_matmul(routes, coord, x, y, sr, config=config, out_dtype=acc_dtype)

    acc = map_shards(step, coords, a_blk, b_blk, mesh=mesh)
    for _ in range(p - 1):
        a_blk = ppermute(a_blk, mesh, ay, shift_left)
        b_blk = ppermute(b_blk, mesh, ax, shift_up)
        acc = map_shards(lambda coord, c, x, y: sr.reduce_op(c, step(coord, x, y)),
                         coords, acc, a_blk, b_blk, mesh=mesh)
    shards = map_shards(lambda c: c.to(out), acc, mesh=mesh)
    cannon_matmul.last_routes = routes
    return Sharded(mesh, P(ax, ay), (m, n), shards)


summa_matmul.last_routes = {}
cannon_matmul.last_routes = {}
