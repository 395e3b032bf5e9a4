"""Models: the analytical model of the card (``perf_model``: roofline
constants, ``specifications``; ``scaling_model`` for groups of cards), the
graph applications on the semiring GEMM, the MLP trainer (``models.mlp``)
and the MoE FFN.

Exports what ``gemm_hls_tpu.models`` exports."""

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
from gemm_hls_tpu_torch.models.perf_model import (
    ChipSpec,
    available_chips,
    detect_chip,
    format_specifications,
    get_chip,
    specifications,
)
from gemm_hls_tpu_torch.models.scaling_model import (
    comm_volume_per_device,
    multichip_model,
    weak_scaling_efficiency,
)

__all__ = [
    "ChipSpec",
    "get_chip",
    "available_chips",
    "detect_chip",
    "specifications",
    "format_specifications",
    "comm_volume_per_device",
    "multichip_model",
    "weak_scaling_efficiency",
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
