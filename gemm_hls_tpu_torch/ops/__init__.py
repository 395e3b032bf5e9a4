"""Operators: the semiring registry, kernel wrappers and the matmul front door.

Exports what ``gemm_hls_tpu.ops`` exports: ``ops.matmul`` and
``ops.grouped_matmul`` are the functions, as in the reference (the modules
of the same names stay reachable through ``importlib.import_module``).
"""

from gemm_hls_tpu_torch.ops.semiring import (
    Semiring,
    available_semirings,
    get_semiring,
    register_semiring,
)
from gemm_hls_tpu_torch.ops.matmul import matmul
from gemm_hls_tpu_torch.ops.grouped import grouped_matmul

__all__ = [
    "Semiring",
    "get_semiring",
    "register_semiring",
    "available_semirings",
    "matmul",
    "grouped_matmul",
]
