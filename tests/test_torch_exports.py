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
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
SUBPACKAGES = ("ops", "models", "utils", "parallel", "tools")

# Names the reference exports that the port does not define yet, by the
# ROADMAP.md item (section A) that ports them.
NOT_PORTED = {
    "parallel": {
        "A7": {"distributed_matmul", "summa_matmul", "cannon_matmul", "shard_operands_2d",
               "matmul_25d", "shard_operands_25d", "distributed_streamed_matmul",
               "ring_flash_attention", "ring_decode_attention", "init_pipeline_params",
               "pipeline_forward", "pipeline_train_step", "shard_pipeline_params",
               "stages_forward"},
    },
}

# The modules of the staged GEMM, the analytical model and the tools; each
# must import on a machine without jax.
JAX_FREE_MODULES = (
    "gemm_hls_tpu_torch.__main__",
    "gemm_hls_tpu_torch.utils.tileio",
    "gemm_hls_tpu_torch.parallel.staging",
    "gemm_hls_tpu_torch.models.perf_model",
    "gemm_hls_tpu_torch.models.scaling_model",
    "gemm_hls_tpu_torch.tools.oversize",
    "gemm_hls_tpu_torch.tools.print_specifications",
    "gemm_hls_tpu_torch.tools.tile_optimizer",
    "gemm_hls_tpu_torch.tools.profile",
    "gemm_hls_tpu_torch.tools.selftest",
)


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


@pytest.fixture(scope="module")
def imports_without_jax():
    """{module: error text or ""}, each imported in one fresh interpreter
    where ``sys.modules["jax"] = None`` makes any import of jax fail."""
    code = ("import importlib, json, sys\nsys.modules['jax'] = None\nout = {}\n"
            f"for m in {list(JAX_FREE_MODULES)!r}:\n"
            "    try:\n        importlib.import_module(m)\n        out[m] = ''\n"
            "    except Exception as e:\n        out[m] = repr(e)\n"
            "out['gemm_hls_tpu'] = ' '.join(m for m in sys.modules "
            "if m == 'gemm_hls_tpu' or m.startswith('gemm_hls_tpu.'))\n"
            "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.splitlines()[-1])


@pytest.mark.parametrize("module", JAX_FREE_MODULES)
def test_module_imports_without_jax(imports_without_jax, module):
    assert imports_without_jax[module] == ""
    assert imports_without_jax["gemm_hls_tpu"] == ""
