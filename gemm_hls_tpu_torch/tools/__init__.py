"""Command-line tools (``python -m gemm_hls_tpu_torch.tools.run``)."""
