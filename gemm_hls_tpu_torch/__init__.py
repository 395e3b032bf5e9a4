"""gemm_hls_tpu_torch — the PyTorch / CUDA port of gemm_hls_tpu for one
NVIDIA H100.

Same public surface as the JAX package for this slice: the semiring GEMM
front door ``matmul``, ``GemmConfig`` / ``default_config`` and the semiring
registry.  The dense plus_times GEMM runs on a hand-written tensor-core
kernel (``csrc/mxu_gemm.cu``), every other semiring on a CUDA-core kernel
(``csrc/semiring_gemm.cu``); both build with nvcc at first use.  This
package imports neither jax nor ``gemm_hls_tpu``.
"""

from gemm_hls_tpu_torch.config import GemmConfig, default_config
from gemm_hls_tpu_torch.ops.matmul import matmul
from gemm_hls_tpu_torch.ops.semiring import (
    Semiring,
    available_semirings,
    get_semiring,
    register_semiring,
)

__version__ = "0.1.0"

__all__ = [
    "GemmConfig",
    "default_config",
    "Semiring",
    "get_semiring",
    "register_semiring",
    "available_semirings",
    "matmul",
]
