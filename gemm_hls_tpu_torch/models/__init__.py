"""Models: the roofline constants of the card, the graph applications on
the semiring GEMM, and the MLP trainer (``models.mlp``)."""

from gemm_hls_tpu_torch.models.graph import (
    all_pairs_shortest_paths,
    distance_product,
    transitive_closure,
    widest_paths,
)
from gemm_hls_tpu_torch.models.perf_model import ChipSpec, detect_chip

__all__ = [
    "ChipSpec",
    "detect_chip",
    "all_pairs_shortest_paths",
    "distance_product",
    "transitive_closure",
    "widest_paths",
]
