"""Models: the roofline constants of the card, the graph applications on
the semiring GEMM, the MLP trainer (``models.mlp``) and the MoE FFN.

Exports what ``gemm_hls_tpu.models`` exports where the port defines the
name; the rest of the reference's ``perf_model`` (``get_chip``,
``available_chips``, ``specifications``, ``format_specifications``) waits
for ROADMAP A4, and ``scaling_model`` for A5."""

from gemm_hls_tpu_torch.models.graph import (
    all_pairs_shortest_paths,
    distance_product,
    transitive_closure,
    widest_paths,
)
from gemm_hls_tpu_torch.models.moe import (
    MoEConfig,
    init_moe_params,
    load_balance_loss,
    moe_forward,
    moe_forward_ep,
    moe_forward_ep_a2a,
    moe_train_step,
)
from gemm_hls_tpu_torch.models.perf_model import ChipSpec, detect_chip

__all__ = [
    "ChipSpec",
    "detect_chip",
    "all_pairs_shortest_paths",
    "distance_product",
    "transitive_closure",
    "widest_paths",
    "MoEConfig",
    "init_moe_params",
    "load_balance_loss",
    "moe_forward",
    "moe_forward_ep",
    "moe_forward_ep_a2a",
    "moe_train_step",
]
