"""2.5D communication-avoiding GEMM over a (z, x, y) mesh of ranks: the
port of ``gemm_hls_tpu/parallel/grid25d.py``.

The 2.5D scheme (Solomonik-Demmel) replicates the 2-D SUMMA grid c times
and splits the contraction across the replicas: each z-slice runs
gather-SUMMA over its K/c chunk, and a reduction over ``z`` combines the
partials, cutting the operand traffic by sqrt(c) for c-fold replication.
The cross-slice combine honours the semiring: ``psum`` for plus_times,
an all-gather over z and a balanced fold of the semiring's reduce
otherwise.  The partials stay in the accumulator type until the one cast.
"""

from __future__ import annotations

from typing import Optional, Tuple

from gemm_hls_tpu_torch.config import GemmConfig
from gemm_hls_tpu_torch.ops.semiring import fold_axis, get_semiring
from gemm_hls_tpu_torch.parallel.mesh import Mesh
from gemm_hls_tpu_torch.parallel.sharding import (
    P, Sharded, all_gather, device_put, map_shards, psum, rank_coords,
)
from gemm_hls_tpu_torch.parallel.summa import _local_config, _local_matmul


def shard_operands_25d(a, b, mesh: Mesh,
                       axes: Tuple[str, str, str] = ("z", "x", "y")):
    """A: (M, K) as P(x, (z, y)); B: (K, N) as P((z, x), y).

    Both K partitions are z-major, so slice z owns the same K/c range of A
    and of B."""
    az, ax, ay = axes
    return (device_put(a, mesh, P(ax, (az, ay))),
            device_put(b, mesh, P((az, ax), ay)))


def matmul_25d(a, b, mesh: Mesh, *, axes: Tuple[str, str, str] = ("z", "x", "y"),
               semiring="plus_times", config: Optional[GemmConfig] = None,
               out_dtype=None) -> Sharded:
    """C[P(x, y)] = A[P(x, (z, y))] . B[P((z, x), y)] on a (c, px, py) mesh;
    C is replicated over z.  Each rank's local GEMM (B1 for plus_times, B3
    otherwise) leaves its route in ``last_routes``.

    Bytes each rank receives: the SUMMA panels of its K/c chunk, then
    2 (c - 1) / c of its C block in the accumulator type for the psum (or
    (c - 1) blocks for the all-gather of another semiring)."""
    sr = get_semiring(semiring)
    az, ax, ay = axes
    c, px, py = mesh.shape[az], mesh.shape[ax], mesh.shape[ay]
    m, k = tuple(a.shape)
    n = b.shape[1]
    # A's K is split c * py ways, B's c * px ways; both shards must be whole.
    if m % px or n % py or k % (c * px) or k % (c * py):
        raise ValueError(
            f"shape ({m},{n},{k}) not divisible by 2.5D mesh "
            f"({c},{px},{py}); K must be divisible by both "
            f"c*px={c * px} and c*py={c * py}")
    a_s = device_put(a, mesh, P(ax, (az, ay)))
    b_s = device_put(b, mesh, P((az, ax), ay))
    acc_dtype, out = _local_config(config, a_s.dtype, sr.name, out_dtype)
    # Within each z-slice: gather-SUMMA over its K/c chunk.
    a_pan = all_gather(a_s.shards, mesh, ay, dim=1)  # (M/px, K/c)
    b_pan = all_gather(b_s.shards, mesh, ax, dim=0)  # (K/c, N/py)
    routes = {}

    def local(coord):
        part = _local_matmul(routes, coord, a_pan[coord], b_pan[coord], sr,
                             config=config, out_dtype=acc_dtype)
        a_pan[coord] = b_pan[coord] = None
        return part

    partial = map_shards(local, rank_coords(mesh), mesh=mesh)
    if sr.is_mxu:
        full = psum(partial, mesh, az)
    else:
        stacked = all_gather(partial, mesh, az, dim=0, tiled=False)
        full = map_shards(lambda s: fold_axis(s, sr.reduce_op, 0), stacked, mesh=mesh)
    matmul_25d.last_routes = routes
    return Sharded(mesh, P(ax, ay), (m, n),
                   map_shards(lambda x: x.to(out), full, mesh=mesh))


matmul_25d.last_routes = {}
