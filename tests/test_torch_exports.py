"""The port's subpackages export what the JAX package's export.

For each subpackage of ``gemm_hls_tpu`` that has an ``__all__`` (ops,
models, utils, parallel, tools), every name in it either imports from the
matching ``gemm_hls_tpu_torch`` subpackage or sits on NOT_PORTED, keyed to
the ROADMAP.md item that ports it.  The reference's names are read by
parsing its ``__init__.py`` with ``ast``: nothing of ``gemm_hls_tpu`` is
imported here.
"""

import ast
import importlib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
SUBPACKAGES = ("ops", "models", "utils", "parallel", "tools")

# Names the reference exports that the port does not define yet, by the
# ROADMAP.md item (section A) that ports them.
NOT_PORTED = {
    "models": {
        "A4": {"get_chip", "available_chips", "specifications", "format_specifications"},
        "A5": {"comm_volume_per_device", "multichip_model", "weak_scaling_efficiency"},
    },
    "parallel": {
        "A7": {"distributed_matmul", "summa_matmul", "cannon_matmul", "shard_operands_2d",
               "matmul_25d", "shard_operands_25d", "distributed_streamed_matmul",
               "streamed_matmul", "streamed_matmul_files", "ring_flash_attention",
               "ring_decode_attention", "init_pipeline_params", "pipeline_forward",
               "pipeline_train_step", "shard_pipeline_params", "stages_forward"},
    },
    "tools": {"A4": {"optimal_tiles", "tile_candidates"}},
}


def reference_all(sub):
    """The ``__all__`` of ``gemm_hls_tpu/<sub>/__init__.py``, read with ast."""
    tree = ast.parse((REPO / "gemm_hls_tpu" / sub / "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return [ast.literal_eval(e) for e in node.value.elts]
    raise AssertionError(f"gemm_hls_tpu/{sub}/__init__.py has no __all__")


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_reference_exports_are_ported_or_listed(sub):
    port = importlib.import_module(f"gemm_hls_tpu_torch.{sub}")
    waiting = set().union(*NOT_PORTED.get(sub, {}).values())
    names = reference_all(sub)
    assert names, sub
    for name in names:
        if name in waiting:
            # The list stays honest: a name that lands leaves it.
            assert not hasattr(port, name), f"{sub}.{name} is ported: drop it from NOT_PORTED"
        else:
            assert hasattr(port, name), f"gemm_hls_tpu_torch.{sub} lacks {name}"
            assert name in getattr(port, "__all__", ()), f"{sub}.__all__ lacks {name}"
    assert waiting <= set(names), f"NOT_PORTED[{sub!r}] names what the reference lacks"


def test_not_ported_items_are_roadmap_items():
    roadmap = (REPO / "ROADMAP.md").read_text()
    for items in NOT_PORTED.values():
        for item in items:
            assert f"**{item}." in roadmap, item


def test_ops_exports_the_functions():
    # gemm_hls_tpu.ops.matmul is the function, and so is the port's; the
    # modules stay reachable through importlib.
    from gemm_hls_tpu_torch import grouped_matmul as top_grouped
    from gemm_hls_tpu_torch import matmul as top_matmul
    from gemm_hls_tpu_torch.ops import grouped_matmul, matmul

    assert matmul is top_matmul and grouped_matmul is top_grouped
    assert callable(matmul) and callable(grouped_matmul)
    mod = importlib.import_module("gemm_hls_tpu_torch.ops.matmul")
    assert mod.matmul is matmul
