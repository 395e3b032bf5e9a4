"""gemm_hls_tpu_torch — the PyTorch / CUDA port of gemm_hls_tpu for one
NVIDIA H100.

Same public surface as the JAX package for the slices ported so far: the
semiring GEMM front door ``matmul`` (2-D, batched and N-D, with fused
epilogues, the int8-slice precision tiers and semiring gradients),
``GemmConfig`` / ``default_config``, the semiring registry,
``fused_linear``, fused-scores ``attention`` / ``attention_scores``,
``flash_attention`` (forward, backward, GQA, padded-cache decode), the
Ozaki f64-class GEMMs in ``ops.ozaki``, the graph applications in
``models.graph`` and the MLP trainer in ``models.mlp``.  The dense
plus_times GEMM runs on hand-written tensor-core kernels
(``csrc/mxu_gemm.cu``: B1 and the batched B2; ``csrc/row_softmax_wgmma.cu``
on the tile engine or ``csrc/row_softmax.cu`` by shape: B2's row-softmax
variant), the integer-slice GEMMs on ``csrc/int8_slices.cu``
(B4, B5), every other semiring on a CUDA-core kernel
(``csrc/semiring_gemm.cu``), flash attention on ``csrc/flash_wgmma.cu``
and ``csrc/flash_bwd_wgmma.cu`` (the tile engine) or ``csrc/flash_fwd.cu``,
``csrc/flash_bwd_dq.cu`` and ``csrc/flash_bwd_dkv.cu`` by shape (B6-B12), the
quantized GEMMs ``matmul_quantized`` / ``matmul_w8a8`` on
``csrc/dequant_wgmma.cu`` / ``csrc/w8a8_wgmma.cu`` (the tile engine) or
``csrc/dequant_gemm.cu`` / ``csrc/w8a8_gemm.cu`` by shape (B13; B14, B15), and
``grouped_matmul`` (the MoE expert GEMM of ``models.moe``, differentiable:
``moe_train_step`` trains through it) on ``csrc/grouped_gemm.cu`` (B16) and
its weight gradient on ``csrc/grouped_update.cu`` (B17), and the fused
distributed GEMMs of ``parallel`` -- ``ring_matmul`` on
``csrc/ring_gemm.cu`` (B18) and ``cannon_matmul_fused`` on
``csrc/cannon_gemm.cu`` (B19), whose ranks run concurrently on one card
and exchange blocks under in-kernel signal / wait; all build with nvcc at
first use.  This package imports neither jax nor ``gemm_hls_tpu``.
"""

from gemm_hls_tpu_torch.config import GemmConfig, default_config
from gemm_hls_tpu_torch.ops.attention import (
    attention,
    attention_scores,
    flash_attention,
)
from gemm_hls_tpu_torch.ops.fused_linear import fused_linear
from gemm_hls_tpu_torch.ops.grouped import grouped_matmul
from gemm_hls_tpu_torch.ops.matmul import matmul
from gemm_hls_tpu_torch.ops.quant import (
    dequantize_weights,
    matmul_quantized,
    matmul_w8a8,
    quantize_weights,
)
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
    "fused_linear",
    "attention",
    "attention_scores",
    "flash_attention",
    "grouped_matmul",
    "quantize_weights",
    "dequantize_weights",
    "matmul_quantized",
    "matmul_w8a8",
]
