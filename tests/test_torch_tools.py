"""The port's tools on the CPU: the tile optimizer on the card's compiled
tiles, the scaling model against ``gemm_hls_tpu.models.scaling_model`` with
the same constants (every numeric key equal to rel 1e-12; 2.5D's C
reduction charged in the accumulator type on both sides, where the JAX
model charges operand width), and the CLIs
(``print_specifications``, ``profile``, ``oversize``, ``selftest`` and
``python -m gemm_hls_tpu_torch``) as smoke tests with ``--device cpu``.
"""

import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gemm_hls_tpu.config import GemmConfig as JaxConfig
from gemm_hls_tpu.models import perf_model as jax_pm
from gemm_hls_tpu.models import scaling_model as jax_sm

from gemm_hls_tpu_torch.config import ENGINE_TILES, KERNEL_TILES, SMEM_LIMIT_BYTES
from gemm_hls_tpu_torch.models import perf_model as pm
from gemm_hls_tpu_torch.models import scaling_model as sm
from gemm_hls_tpu_torch.tools import optimal_tiles, tile_candidates
from gemm_hls_tpu_torch.tools import oversize, print_specifications, profile, selftest
from gemm_hls_tpu_torch.tools import tile_optimizer

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


# ---- tile optimizer ---------------------------------------------------------

def test_bf16_picks_the_engine_tile():
    cfg = optimal_tiles("bfloat16", m=8192, n=8192, k=8192)
    assert (cfg.block_m, cfg.block_n, cfg.block_k) == ENGINE_TILES["bfloat16"]
    assert cfg.route() == "wgmma"
    assert cfg.smem_bytes() <= SMEM_LIMIT_BYTES
    cfg.validate(strict_alignment=True)
    wmma = JaxConfig(dtype="bfloat16", block_m=128, block_n=128, block_k=32)
    # The law, as the JAX config computes it: the engine tile moves 3/4.
    assert JaxConfig(dtype="bfloat16", block_m=128, block_n=256, block_k=64) \
        .io_volume_bytes(8192, 8192, 8192) < wmma.io_volume_bytes(8192, 8192, 8192)


@pytest.mark.parametrize("dtype,kw,tile", [
    ("float16", {}, ENGINE_TILES["float16"]),
    ("float32", {}, ENGINE_TILES["float32"]),  # TF32 passes on the engine
    ("int8", {}, ENGINE_TILES["int8"]),  # B (K, N): on the engine after its pack pass
    ("int8", {"transpose_b": True}, ENGINE_TILES["int8"]),
    ("bfloat16", {"semiring": "min_plus"}, KERNEL_TILES["simt"]),
    ("bfloat16", {"vmem_budget": 100_000}, KERNEL_TILES["tc"]),
])
def test_result_is_a_tile_the_card_runs(dtype, kw, tile):
    cfg = optimal_tiles(dtype, **kw)
    assert (cfg.block_m, cfg.block_n, cfg.block_k) == tile
    assert (cfg.block_m, cfg.block_n, cfg.block_k) in tile_candidates(
        dtype, **{k: v for k, v in kw.items() if k == "semiring"})
    cfg.validate(strict_alignment=True)


def test_candidates_are_compiled_tiles():
    for dtype in ("bfloat16", "float16", "int8", "float32", "int32"):
        for tile in tile_candidates(dtype):
            assert tile in set(KERNEL_TILES.values()) | set(ENGINE_TILES.values())
    assert tile_candidates("bfloat16") == [(128, 256, 64), (128, 128, 32)]
    assert tile_candidates("bfloat16", max_dim=128) == [(128, 128, 32)]
    assert tile_candidates("bfloat16", min_block_k=64) == [(128, 256, 64)]


def test_larger_budget_never_more_io():
    m = n = k = 8192
    small = optimal_tiles("bfloat16", vmem_budget=64 << 10, m=m, n=n, k=k)
    large = optimal_tiles("bfloat16", vmem_budget=SMEM_LIMIT_BYTES, m=m, n=n, k=k)
    assert large.io_volume_bytes(m, n, k) <= small.io_volume_bytes(m, n, k)


def test_infeasible_budget_raises():
    with pytest.raises(ValueError, match="no feasible"):
        optimal_tiles("float32", vmem_budget=1000)


def test_small_problem_clamps():
    cfg = optimal_tiles("bfloat16", m=128, n=128, k=256)
    assert cfg.block_m <= 128 and cfg.block_n <= 256


def test_tile_optimizer_cli(capsys):
    tile_optimizer.main(["--dtype", "bfloat16", "--m", "4096", "--n", "4096",
                         "--k", "4096"])
    out = capsys.readouterr().out
    assert "block_m=128 block_n=256 block_k=64 route=wgmma" in out
    assert "io_volume_bytes=" in out and "smem_bytes=201840" in out


# ---- scaling model ----------------------------------------------------------

def _jax_chip(chip):
    return jax_pm.ChipSpec(**dataclasses.asdict(chip))


_JAX_VOLUME = jax_sm.comm_volume_per_device


def _jax_volume_acc_reduce(alg, m, n, k, mesh, itemsize=2):
    """The JAX model's volume with 2.5D's C reduction charged in the
    accumulator type (fp32 for 2-byte operands), as the port charges it."""
    volume = _JAX_VOLUME(alg, m, n, k, mesh, itemsize)
    if alg != "25d":
        return volume
    c, px, py = mesh
    operands = _JAX_VOLUME("summa", m, n, k // c, (px, py), itemsize)
    return operands + (volume - operands) // itemsize * max(itemsize, 4)


@pytest.fixture
def jax_sm_acc_reduce(monkeypatch):
    """``jax_sm`` whose model reads :func:`_jax_volume_acc_reduce`."""
    monkeypatch.setattr(jax_sm, "comm_volume_per_device", _jax_volume_acc_reduce)
    return jax_sm


CASES = [("summa", (16384, 16384, 16384), (4, 4)), ("summa", (8192, 4096, 2048), (2, 4)),
         ("cannon", (8192, 8192, 8192), (4, 4)), ("cannon", (4096, 4096, 4096), (2, 2)),
         ("25d", (16384, 16384, 16384), (4, 4, 4)), ("25d", (8192, 8192, 8192), (2, 2, 2))]


@pytest.mark.parametrize("alg,mnk,mesh", CASES, ids=str)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_comm_volume_matches_jax(alg, mnk, mesh, itemsize):
    assert sm.comm_volume_per_device(alg, *mnk, mesh, itemsize) == \
        _jax_volume_acc_reduce(alg, *mnk, mesh, itemsize)


@pytest.mark.parametrize("alg,mnk,mesh", CASES, ids=str)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("overlap", [0.0, 0.8])
def test_multichip_model_matches_jax(alg, mnk, mesh, dtype, overlap, jax_sm_acc_reduce):
    got = sm.multichip_model(alg, *mnk, mesh, dtype=dtype, chip=pm.H100, overlap=overlap)
    want = jax_sm_acc_reduce.multichip_model(alg, *mnk, mesh, dtype=dtype, chip=_jax_chip(pm.H100),
                                  overlap=overlap)
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, float):
            assert got[key] == pytest.approx(value, rel=1e-12), key
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("alg,mesh", [("25d", (4, 2, 2)), ("summa", (4, 4)),
                                      ("cannon", (2, 2))])
def test_weak_scaling_matches_jax(alg, mesh, jax_sm_acc_reduce):
    got = sm.weak_scaling_efficiency(alg, (8192, 8192, 8192), mesh, chip=pm.H100)
    want = jax_sm_acc_reduce.weak_scaling_efficiency(alg, (8192, 8192, 8192), mesh,
                                          chip=_jax_chip(pm.H100))
    assert got == pytest.approx(want, rel=1e-12)
    assert 0 < got <= 1


def test_scaling_model_refusals():
    with pytest.raises(ValueError, match="square"):
        sm.comm_volume_per_device("cannon", 64, 64, 64, (2, 4))
    with pytest.raises(ValueError, match="unknown algorithm"):
        sm.comm_volume_per_device("ring", 64, 64, 64, (2, 2))


def test_scaling_model_defaults_to_the_local_chip():
    r = sm.multichip_model("summa", 4096, 4096, 4096, (2, 2))
    assert r["chip"] == pm.detect_chip().name


# ---- the CLIs ---------------------------------------------------------------

def test_print_specifications_without_a_card(capsys):
    spec = print_specifications.main(["8192", "8192", "8192", "--dtype", "bfloat16",
                                      "--chip", "h100"])
    out = capsys.readouterr().out
    assert spec["chip"] == "h100" and spec["blocks"] == (128, 256, 64)
    assert "Peak performance: 989000.0 GOp/s" in out
    spec = print_specifications.main(["256", "256", "256", "--block-m", "64"])
    assert spec["blocks"][0] == 64


def test_profile_matmul_on_the_cpu(tmp_path):
    r = profile.profile_matmul(32, 128, 64, dtype="float32", iters=2, device="cpu",
                               logdir=str(tmp_path))
    assert r["measured_seconds"] > 0 and r["expected_seconds"] > 0
    assert r["bound"] in ("compute", "memory")
    assert r["clock"] == "host" and r["chip"] == "cpu" and r["route"] is None
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]


def test_profile_cli(capsys):
    profile.main(["64", "64", "64", "--dtype", "bfloat16", "--device", "cpu",
                  "--iters", "1"])
    assert "roofline expectation" in capsys.readouterr().out


def test_oversize_on_the_cpu(capsys):
    assert oversize.main(["--m", "96", "--n", "80", "--k", "112", "--tile", "32",
                          "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Spot verification: PASS" in out and "ratio" in out
    r = oversize.run(["--m", "64", "--n", "64", "--k", "128", "--tile", "32",
                      "--dtype", "float32", "--semiring", "min_plus",
                      "--no-prefetch", "--device", "cpu"])
    assert r["ok"] and r["stats"]["prefetch"] is False
    # Divisible sizes: the staged bytes are the CA law's exactly.
    assert r["stats"]["h2d_bytes"] == r["law_h2d_bytes"]


def test_cuda_tools_refuse_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    assert oversize.main(["--m", "8", "--n", "8", "--k", "8", "--tile", "8"]) == 1
    assert selftest.main(["--quick"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_selftest_quick_on_the_cpu(capsys):
    assert selftest.main(["--quick", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "21/21 checks passed" in out and "FAIL" not in out


def test_package_main_lists_its_clis():
    proc = subprocess.run([sys.executable, "-m", "gemm_hls_tpu_torch"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "CLIs:" in proc.stdout and "chip model: cpu" in proc.stdout
    mods = [ln.split()[2] for ln in proc.stdout.splitlines()
            if ln.strip().startswith("python -m")]
    assert "gemm_hls_tpu_torch.tools.oversize" in mods and len(mods) == 13
    # The reference's index lists its tuning CLIs (gemm_hls_tpu/__main__.py:22-27).
    for mod in ("sweep", "autotune", "calibrate"):
        assert f"gemm_hls_tpu_torch.tools.{mod}" in mods
    for mod in mods:
        assert importlib.util.find_spec(mod) is not None, mod


@pytest.mark.parametrize("argv", [
    ["gemm_hls_tpu_torch.tools.print_specifications", "1024", "1024", "1024",
     "--chip", "h100"],
    ["gemm_hls_tpu_torch.tools.tile_optimizer", "--dtype", "float16"],
])
def test_tool_modules_run(argv):
    proc = subprocess.run([sys.executable, "-m", *argv], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout
