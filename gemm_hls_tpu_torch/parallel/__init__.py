"""Distributed and staged GEMMs of the port: the counterpart of
``gemm_hls_tpu.parallel`` for the parts ported so far.

``make_mesh`` / ``mesh_25d`` build meshes of torch devices (a device may
repeat: several ranks on one card).  One process drives every rank
(``parallel/sharding.py``: sharded tensors, ``device_put`` and the
collectives as copies between ranks).  On it run the communication-avoiding
GEMMs: ``summa_matmul`` and ``cannon_matmul`` (``parallel/summa.py``),
``matmul_25d`` (``parallel/grid25d.py``), the front door
``distributed_matmul`` (``parallel/dispatch.py``) and
``distributed_streamed_matmul``; each rank's local step is kernel B1 or
B3.  ``ring_matmul`` (kernel B18) and ``cannon_matmul_fused`` (kernel B19)
run their ranks concurrently in one launch on one card, or their plain
schedules on the CPU.  ``streamed_matmul`` and ``streamed_matmul_files``
(``parallel/staging.py``) run GEMMs larger than the card's memory from
host memory or disk, one device-resident C tile at a time.  The training
half: ``ring_flash_attention`` / ``ring_decode_attention``
(``parallel/ring_attention.py``: sequence-parallel flash attention on
kernels B6-B12, plain, zigzag and decode) and the GPipe pipeline
(``parallel/pipeline.py``: ``init_pipeline_params``,
``shard_pipeline_params``, ``stages_forward``, ``pipeline_forward``,
``pipeline_train_step``, each stage on B1); the collectives are
differentiable (their backward the adjoint copies) and include
``all_to_all`` (``models/moe.py``'s expert parallelism).
"""

from gemm_hls_tpu_torch.ops.cannon import cannon_matmul_fused
from gemm_hls_tpu_torch.ops.ring import ring_matmul, shard_operands_ring
from gemm_hls_tpu_torch.parallel.dispatch import distributed_matmul
from gemm_hls_tpu_torch.parallel.grid25d import matmul_25d, shard_operands_25d
from gemm_hls_tpu_torch.parallel.mesh import Mesh, make_mesh, mesh_25d
from gemm_hls_tpu_torch.parallel.pipeline import (
    init_pipeline_params,
    pipeline_forward,
    pipeline_train_step,
    shard_pipeline_params,
    stages_forward,
)
from gemm_hls_tpu_torch.parallel.ring_attention import (
    ring_decode_attention,
    ring_flash_attention,
)
from gemm_hls_tpu_torch.parallel.sharding import P, Sharded, device_put
from gemm_hls_tpu_torch.parallel.staging import (
    distributed_streamed_matmul,
    streamed_matmul,
    streamed_matmul_files,
)
from gemm_hls_tpu_torch.parallel.summa import (
    cannon_matmul,
    shard_operands_2d,
    summa_matmul,
)

__all__ = [
    "Mesh",
    "P",
    "Sharded",
    "device_put",
    "distributed_matmul",
    "make_mesh",
    "mesh_25d",
    "summa_matmul",
    "cannon_matmul",
    "shard_operands_2d",
    "matmul_25d",
    "shard_operands_25d",
    "distributed_streamed_matmul",
    "streamed_matmul",
    "streamed_matmul_files",
    "ring_matmul",
    "ring_flash_attention",
    "ring_decode_attention",
    "shard_operands_ring",
    "cannon_matmul_fused",
    "init_pipeline_params",
    "pipeline_forward",
    "pipeline_train_step",
    "shard_pipeline_params",
    "stages_forward",
]
