"""Verification, timing and checkpoint helpers (numpy oracles, CUDA-event
timing), exporting what ``gemm_hls_tpu.utils`` exports."""

from gemm_hls_tpu_torch.utils.benchmark import gflops, percent_of_peak, time_fn
from gemm_hls_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
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
           "tolerance_for", "unaligned_sizes", "verify_matmul", "gflops",
           "percent_of_peak", "time_fn", "load_checkpoint", "save_checkpoint"]
