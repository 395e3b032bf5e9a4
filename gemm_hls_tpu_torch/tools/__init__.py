"""Command-line tools (``python -m gemm_hls_tpu_torch`` lists them) and the
tile optimizer, exporting what ``gemm_hls_tpu.tools`` exports."""

from gemm_hls_tpu_torch.tools.tile_optimizer import optimal_tiles, tile_candidates

__all__ = ["optimal_tiles", "tile_candidates"]
