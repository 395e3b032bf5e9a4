"""The port's examples (``examples/torch/``) on the CPU.

Each runs in its own interpreter with ``--device cpu`` (the plain versions
of the kernels), under a prelude that sets ``sys.modules["jax"] = None``, so
an example that imports jax, or anything of ``gemm_hls_tpu``, fails.  Each
must exit 0 and print the reference example's verification lines.  On the
card, ``chip_smoke.py`` phase 27a runs every example with ``--device cuda``
and checks the kernels each launched.

The directory holds exactly the reference's examples but those that wait
for a later slice (``NOT_PORTED_EXAMPLES``, keyed to the ROADMAP.md item
that ports them).
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORTED = sorted((REPO / "examples" / "torch").glob("[0-9]*.py"))

# The reference's examples that the port does not run yet, by the ROADMAP.md
# item (section A) that ports them: none since 06 landed with A7's training
# half.
NOT_PORTED_EXAMPLES = {}

# Lines each example must print (a line starts with the given text), the
# reference example's verification lines.
VERIFIED = {
    "01_basic_gemm.py": ["fp32 1000x1030x999: verified vs BLAS oracle",
                         "bf16 with fp32 accumulation: (512, 512) float32",
                         "Problem: C[8192,8192] = A[8192,8192] . B[8192,8192]  (bfloat16, h100)"],
    "02_semirings.py": ["built-in semirings:", "min_plus (distance product): verified",
                        "max_min (widest path): verified", "or_and (reachability): verified",
                        "custom plus_max: registered and verified"],
    "03_graph_algorithms.py": ["APSP on a 64-node sparse digraph",
                               "  reachable pairs: 3970 / 4096",
                               "  longest shortest path: 23.27",
                               "transitive closure (or_and): consistent with APSP reachability",
                               "widest paths (max_min): median bottleneck 28.7"],
    "04_distributed.py": ["SUMMA on {'x': 2, 'y': 4}: verified; C sharding "
                          "PartitionSpec('x', 'y')", "Cannon on (2,2): verified",
                          "2.5D on {'z': 2, 'x': 2, 'y': 2}: verified",
                          "distributed min_plus: verified"],
    "05_f64_on_bf16.py": ["K=512: 8 slices of 7 mantissa bits each", "elementwise max rel err:",
                          "normwise max err:", "fused int8 variant normwise max err:"],
    "06_training.py": ["mesh: {'dp': 2, 'tp': 4}",
                       *(f"step {i}: loss " for i in range(5)),
                       "checkpoint saved + restored: ck.npz"],
    "07_differentiable_semirings.py": ["initial 2-hop dist(0 -> 23): 6.825 (target 3.0)",
                                       "after 40 subgradient steps: 3.000, loss 0.0000",
                                       "log_plus (soft-min) gradient: 7 edges receive signal"],
    "08_fused_distributed_kernels.py": ["fused RDMA ring matmul on 8 devices: verified",
                                        "tiled ring (out-of-VMEM locals, 3-level overlap): "
                                        "verified",
                                        "fused 2x2 Cannon (in-kernel skew + shifts): verified"],
    "09_fp32_frontier.py": ["fp32 full accuracy (precision='high')",
                            "fp32 fast mode (precision='default')",
                            "int8 slices, n=2", "int8 slices, n=3"],
    "10_transformer_block.py": ["transformer block: (2, 128, 256) bfloat16 -> (2, 128, 256) "
                                "bfloat16", "max abs diff vs", "OK"],
    "11_attention_scores.py": ["scores (4, 256, 256): rows sum to 1 within",
                               "fused vs unfused softmax max abs diff:",
                               "attention (4, 256, 64): max abs diff vs reference",
                               "dL/dq (4, 256, 64): finite=True"],
    "12_flash_attention.py": ["flash vs fused-scores path (4, 256, 64): max abs diff",
                              "causal flash vs masked reference: max abs diff",
                              "flash backward dq: rel err vs autodiff",
                              "flash backward dk: rel err vs autodiff",
                              "flash backward dv: rel err vs autodiff", "OK",
                              "sliding-window(64) causal: (4, 256, 64)",
                              "logit soft-cap(30): (4, 256, 64)",
                              "packed causal (2 segments): (4, 256, 64)",
                              "GQA decode vs padded cache (lens [100, 256]): (8, 1, 64)",
                              "serving features OK"],
    "13_quantized_inference.py": ["int8 per-channel: rel err 0.0072 (weights 2x smaller)",
                                  "int4 g=128: rel err 0.1159 (weights 4x smaller)",
                                  "int4 kernel vs host-dequant oracle:",
                                  "W8A8 (dynamic per-row activation quant): rel err 0.0126",
                                  "OK"],
    "14_moe.py": ["grouped_matmul vs ragged_dot (128x64x64, 4 experts, sizes [29, 31, 28, 40])",
                  "MoE train: loss", "expert parallelism skipped (1 device(s))"],
    "15_serving_decoder.py": ["prefill attention (W8A8 proj + causal GQA flash): rel err 0.0112",
                              "prefill full block: median token err",
                              "decode (int4 proj + padded-cache flash + MoE): rel err",
                              "decode x3: lengths [67, 50], output finite",
                              "serving decoder block OK"],
}


def test_examples_are_the_reference_minus_not_ported():
    reference = {p.name for p in (REPO / "examples").glob("[0-9]*.py")}
    waiting = set().union(*NOT_PORTED_EXAMPLES.values())
    assert {p.name for p in PORTED} == reference - waiting
    assert waiting <= reference
    assert set(VERIFIED) == {p.name for p in PORTED}


def test_not_ported_examples_are_roadmap_items():
    roadmap = (REPO / "ROADMAP.md").read_text()
    for item in NOT_PORTED_EXAMPLES:
        assert item == "A7" and f"**{item}." in roadmap, item


@pytest.mark.parametrize("path", PORTED, ids=lambda p: p.name)
def test_example_runs_on_the_cpu_without_jax(path):
    code = ("import runpy, sys\nsys.modules['jax'] = None\n"
            f"sys.argv = [{str(path)!r}, '--device', 'cpu']\n"
            f"runpy.run_path({str(path)!r}, run_name='__main__')\n"
            "assert not [m for m in sys.modules if m.split('.')[0] == 'gemm_hls_tpu']\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    for want in VERIFIED[path.name]:
        assert any(line.startswith(want) for line in lines), (want, proc.stdout[-2000:])


def test_example_asks_for_the_card_and_raises_without_one():
    # --device cuda (the default) on a machine without a card raises; there
    # is no fallback to the plain versions.
    path = PORTED[0]
    code = ("import runpy, sys, torch\nsys.modules['jax'] = None\n"
            "torch.cuda.is_available = lambda: False\n"
            f"sys.argv = [{str(path)!r}]\n"
            f"runpy.run_path({str(path)!r}, run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
