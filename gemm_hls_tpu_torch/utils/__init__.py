"""Verification and timing helpers (numpy oracles, CUDA-event timing)."""

from gemm_hls_tpu_torch.utils.verify import (
    KSEED,
    check_result,
    make_operands,
    reference_matmul,
    tolerance_for,
    unaligned_sizes,
    verify_matmul,
)

__all__ = ["KSEED", "check_result", "make_operands", "reference_matmul",
           "tolerance_for", "unaligned_sizes", "verify_matmul"]
