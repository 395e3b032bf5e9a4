"""The port's configuration, registry and packaging, held against the JAX
package: the same GemmConfig fields and tiling law, the same semiring
identities, and an import that pulls in neither jax nor a GPU toolchain.

Runs on the CPU; nothing here needs a card.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gemm_hls_tpu import GemmConfig as JaxConfig
from gemm_hls_tpu.ops.semiring import get_semiring as jax_get_semiring

from gemm_hls_tpu_torch import GemmConfig, default_config
from gemm_hls_tpu_torch import _build
from gemm_hls_tpu_torch.config import ENGINE_TILES, KERNEL_TILES, call_route, kernel_route
from gemm_hls_tpu_torch.ops.semiring import available_semirings, get_semiring
from gemm_hls_tpu_torch.utils import unaligned_sizes
from gemm_hls_tpu_torch.utils.verify import tolerance_for

import gemm_hls_tpu.utils.verify as jax_verify

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("fields", [
    dict(),
    dict(dtype="bfloat16", out_dtype="float32", block_m=128, block_n=256,
         block_k=64, transpose_a=True, precision="highest"),
    dict(dtype="int8", acc_dtype="int32", semiring="min_plus",
         pad_policy="strict", interpret=True, debug=True),
])
def test_from_reference_round_trip(fields):
    jcfg = JaxConfig(**fields)
    cfg = GemmConfig.from_reference(dataclasses.asdict(jcfg))
    shared = {f.name for f in dataclasses.fields(GemmConfig)}
    assert shared == ({f.name for f in dataclasses.fields(JaxConfig)}
                      - {"interpret", "vmem_limit_bytes", "debug"})
    for name in shared:
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert str(cfg.tacc_dtype).removeprefix("torch.") == str(jcfg.jacc_dtype)
    assert str(cfg.tout_dtype).removeprefix("torch.") == str(jcfg.jout_dtype)


@pytest.mark.parametrize("blocks,dtype,out", [
    ((128, 128, 32), "bfloat16", None),
    ((128, 128, 16), "float32", None),
    ((16, 128, 64), "int8", "int32"),
    ((512, 1024, 1024), "bfloat16", "float32"),
])
@pytest.mark.parametrize("mnk", [(8192, 8192, 8192), (65, 140, 131),
                                 (1, 1, 1), (4096, 1000, 77)])
def test_tiling_law_matches_reference(blocks, dtype, out, mnk):
    bm, bn, bk = blocks
    kw = dict(dtype=dtype, out_dtype=out, block_m=bm, block_n=bn, block_k=bk)
    cfg, jcfg = GemmConfig(**kw), JaxConfig(**kw)
    assert cfg.grid(*mnk) == jcfg.grid(*mnk)
    assert cfg.padded_shape(*mnk) == jcfg.padded_shape(*mnk)
    assert cfg.io_volume_words(*mnk) == jcfg.io_volume_words(*mnk)
    assert cfg.io_volume_bytes(*mnk) == jcfg.io_volume_bytes(*mnk)
    assert cfg.flops(*mnk) == jcfg.flops(*mnk)
    assert cfg.arithmetic_intensity(*mnk) == pytest.approx(
        jcfg.arithmetic_intensity(*mnk), rel=1e-12)


@pytest.mark.parametrize("dtype,semiring,route", [
    ("bfloat16", "plus_times", "tc"), ("float16", "plus_times", "tc"),
    ("int8", "plus_times", "tc"), ("float32", "plus_times", "simt"),
    ("int32", "plus_times", "simt"), ("bfloat16", "min_plus", "simt"),
    ("float32", "log_plus", "simt"),
])
def test_default_config_is_the_compiled_tile(dtype, semiring, route):
    cfg = default_config(dtype, semiring=semiring)
    assert kernel_route(dtype, semiring) == route
    # The call itself takes the engine for every plus_times type it runs
    # (int32 as byte planes since the integer route moved there).
    engine = semiring == "plus_times" and dtype in ENGINE_TILES
    assert call_route(dtype, semiring) == ("wgmma" if engine else route)
    assert (cfg.block_m, cfg.block_n, cfg.block_k) == KERNEL_TILES[route]
    cfg.validate(strict_alignment=True)
    assert cfg.smem_bytes() <= 48 * 1024  # static shared memory, no opt-in


@pytest.mark.parametrize("bad,match", [
    (dict(pad_policy="zero"), "pad_policy"),
    (dict(precision="tf32"), "precision"),
    (dict(block_m=0), "block_m"),
    (dict(block_k=1.5), "block_k"),
])
def test_validate_rejects_like_reference(bad, match):
    with pytest.raises(ValueError, match=match):
        GemmConfig(**bad).validate()
    with pytest.raises(ValueError, match=match):
        JaxConfig(**bad).validate()


def test_validate_hopper_checks():
    # The TPU's lane rules are gone: odd blocks pass without a kernel.
    GemmConfig(block_m=16, block_n=128, block_k=64).validate()
    with pytest.raises(ValueError, match="compiled tile"):
        GemmConfig(block_m=16, block_n=128, block_k=64).validate(
            strict_alignment=True)
    with pytest.raises(ValueError, match="compiled tile"):
        default_config("bfloat16").validate(strict_alignment=True,
                                            route="simt")
    # TC tile: 2 operands x 2 K planes x 128 rows x 24 x 2 B + 8 warps'
    # 16x16 fp32 staging = 32 KiB (csrc/mxu_gemm.cu).
    assert default_config("bfloat16").smem_bytes() == 32768
    assert default_config("float32").smem_bytes() == 16 * 258 * 4


def test_unaligned_sizes_match_reference():
    for blocks in ((32, 128, 128), (128, 128, 16), (16, 128, 64)):
        bm, bn, bk = blocks
        assert unaligned_sizes(GemmConfig(block_m=bm, block_n=bn, block_k=bk)) \
            == jax_verify.unaligned_sizes(
                JaxConfig(block_m=bm, block_n=bn, block_k=bk))


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16", "int8",
                                   "int32", "bool", "float64"])
def test_tolerances_match_reference(dtype):
    import jax.numpy as jnp
    assert tolerance_for(dtype) == jax_verify.tolerance_for(jnp.dtype(dtype))


@pytest.mark.parametrize("name", sorted(available_semirings()))
@pytest.mark.parametrize("dtype", ["float32", "int32", "int8", "bool"])
def test_semiring_registry_matches_reference(name, dtype):
    sr, jsr = get_semiring(name), jax_get_semiring(name)
    assert sr.is_mxu == jsr.is_mxu
    assert sr.np_map is jsr.np_map or sr.np_map.__name__ == jsr.np_map.__name__
    assert sr.np_reduce is jsr.np_reduce
    assert sr.supports_dtype(dtype) == jsr.supports_dtype(dtype)
    assert sr.identity_for(dtype) == jsr.identity_for(dtype)
    assert sr.absorbing_for(dtype) == jsr.absorbing_for(dtype)


def test_registry_names_match_reference():
    from gemm_hls_tpu.ops.semiring import available_semirings as jax_names
    assert available_semirings() == jax_names()
    codes = [get_semiring(n).op_code for n in available_semirings()
             if n != "or_and"]
    assert sorted(codes) == list(range(9))  # csrc/semiring_gemm.cu enum Op


def _fresh_python(code: str, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_import_pulls_in_no_jax():
    proc = _fresh_python(
        "import sys, gemm_hls_tpu_torch, gemm_hls_tpu_torch.tools.run\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'gemm_hls_tpu' not in sys.modules, 'gemm_hls_tpu imported'\n")
    assert proc.returncode == 0, proc.stderr


def test_import_needs_no_gpu_toolchain():
    env = dict(os.environ, PATH="/nonexistent", CUDA_HOME="/nonexistent")
    proc = _fresh_python(
        "import sys, gemm_hls_tpu_torch\n"
        "from gemm_hls_tpu_torch import _build\n"
        "assert 'triton' not in sys.modules\n"
        "assert _build._lib is None\n"
        "print(_build.library_path().name)\n", env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("libgemm_hls_kernels_")


def test_package_sources_import_no_jax():
    pkg = REPO / "gemm_hls_tpu_torch"
    for path in pkg.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1].split(".")[0].rstrip(",")
                assert mod not in ("jax", "jaxlib", "gemm_hls_tpu"), (
                    f"{path}: {line}")


def test_build_names_library_by_source_hash(tmp_path, monkeypatch):
    first = _build.library_path()
    assert first == _build.library_path()
    src = tmp_path / "csrc"
    src.mkdir()
    for p in _build.CSRC_DIR.iterdir():
        (src / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", src)
    assert _build.library_path() == first
    (src / "mxu_gemm.cu").write_text("// edited\n")
    assert _build.library_path() != first


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "library_path",
                        lambda: tmp_path / "build" / "lib.so")
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


@pytest.mark.parametrize("dtype,code", [
    (torch.float32, 0), (torch.bfloat16, 1), (torch.float16, 2),
    (torch.int8, 3), (torch.int32, 4)])
def test_dtype_codes(dtype, code):
    assert _build.dtype_code(dtype) == code


def test_dtype_code_rejects_float64():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _build.dtype_code(torch.float64)


def test_check_raises_on_launch_errors():
    _build.check(0, "ok")
    with pytest.raises(RuntimeError, match="error 700"):
        _build.check(700, "mxu_gemm")
    with pytest.raises(NotImplementedError):
        _build.check(-1, "semiring_gemm")


def test_perf_model_h100_peaks():
    from gemm_hls_tpu_torch.models.perf_model import H100
    assert H100.peak_for("bfloat16") == 989e12
    assert H100.peak_for("float16") == 989e12
    assert H100.peak_for("int8") == 1979e12
    assert H100.peak_for("tfloat32") == 495e12
    assert H100.peak_for(torch.float32) == 67e12
    # One CUDA-core instruction per lane per clock (132 SMs x 128 lanes x
    # 1.98 GHz), a semiring term's (map, reduce) pair two instructions
    # counted as 2 ops: half the FMA-counted fp32 rate.
    assert np.isclose(H100.vpu_ops, 33.45e12, rtol=1e-3)
