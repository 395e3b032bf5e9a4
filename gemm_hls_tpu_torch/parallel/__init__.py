"""Distributed and staged GEMMs of the port: the counterpart of
``gemm_hls_tpu.parallel`` for the parts ported so far.

``make_mesh`` / ``mesh_25d`` build meshes of torch devices; ``ring_matmul``
(kernel B18) and ``cannon_matmul_fused`` (kernel B19) run their ranks
concurrently on one card, or their plain schedules on the CPU.
``streamed_matmul`` and ``streamed_matmul_files`` (``parallel/staging.py``)
run GEMMs larger than the card's memory from host memory or disk, one
device-resident C tile at a time.  The rest of the JAX package's
``parallel`` (SUMMA, Cannon on collectives, 2.5D, ``distributed_matmul``,
``distributed_streamed_matmul``, ring attention, the pipeline) waits for
the multi-card transport, ROADMAP A7.
"""

from gemm_hls_tpu_torch.ops.cannon import cannon_matmul_fused
from gemm_hls_tpu_torch.ops.ring import ring_matmul, shard_operands_ring
from gemm_hls_tpu_torch.parallel.mesh import Mesh, make_mesh, mesh_25d
from gemm_hls_tpu_torch.parallel.staging import (
    streamed_matmul,
    streamed_matmul_files,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "mesh_25d",
    "ring_matmul",
    "shard_operands_ring",
    "cannon_matmul_fused",
    "streamed_matmul",
    "streamed_matmul_files",
]
