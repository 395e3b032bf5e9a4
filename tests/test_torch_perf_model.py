"""The port's analytical model (``models/perf_model.py``) against
``gemm_hls_tpu.models.perf_model`` for the same configs, with a JAX
``ChipSpec`` built from the port's H100 constants: every numeric key of
``specifications`` equal to rel 1e-12.  ``vmem_bytes`` / ``vmem_budget``
differ by design (a thread block's shared memory and the card's limit a
block, not a Pallas VMEM estimate) and are checked on their own.  Also the
registry, the H100 constants, and ``config.route_config``: the tile of the
route a call takes.
"""

import dataclasses

import pytest
import torch

from gemm_hls_tpu.config import GemmConfig as JaxConfig
from gemm_hls_tpu.models import perf_model as jax_pm

from gemm_hls_tpu_torch.config import (
    SMEM_LIMIT_BYTES, GemmConfig, call_route, default_config, pack_bytes, route_config,
)
from gemm_hls_tpu_torch.models import perf_model as pm

OWN_MEANING = {"vmem_bytes", "vmem_budget"}


def _jax_chip(chip: pm.ChipSpec) -> jax_pm.ChipSpec:
    return jax_pm.ChipSpec(**dataclasses.asdict(chip))


CONFIGS = [
    dict(dtype="bfloat16", block_m=128, block_n=256, block_k=64),            # the engine
    dict(dtype="bfloat16", block_m=128, block_n=128, block_k=32, out_dtype="float32"),
    dict(dtype="float32", block_m=128, block_n=128, block_k=16),             # CUDA cores
    dict(dtype="int8", block_m=128, block_n=256, block_k=128, out_dtype="int32"),
    dict(dtype="bfloat16", block_m=512, block_n=1024, block_k=1024),         # the JAX default
    dict(dtype="float32", block_m=128, block_n=128, block_k=16, semiring="min_plus"),
]
PROBLEMS = [(8192, 8192, 8192), (4096, 1000, 77), (65, 140, 131), (1, 1, 1),
            (32768, 32768, 32768), (2048, 8192, 64)]


@pytest.mark.parametrize("fields", CONFIGS, ids=str)
@pytest.mark.parametrize("mnk", PROBLEMS, ids=str)
@pytest.mark.parametrize("mxu", [True, False])
@pytest.mark.parametrize("latch", [0.0, 2.2e-7])
def test_specifications_match_jax(fields, mnk, mxu, latch):
    chip = dataclasses.replace(pm.H100, grid_step_overhead_s=latch)
    cfg, jcfg = GemmConfig(**fields), JaxConfig(**fields)
    got = pm.specifications(cfg, *mnk, chip=chip, semiring_is_mxu=mxu)
    want = jax_pm.specifications(jcfg, *mnk, chip=_jax_chip(chip), semiring_is_mxu=mxu)
    assert set(got) == set(want)
    for key, value in want.items():
        if key in OWN_MEANING:
            continue
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            assert got[key] == pytest.approx(value, rel=1e-12), key
        else:
            assert got[key] == value, key
    assert got["vmem_bytes"] == cfg.smem_bytes()
    assert got["vmem_budget"] == SMEM_LIMIT_BYTES


@pytest.mark.parametrize("fields", CONFIGS, ids=str)
@pytest.mark.parametrize("mnk", PROBLEMS, ids=str)
def test_hbm_traffic_matches_jax(fields, mnk):
    assert GemmConfig(**fields).hbm_traffic_bytes(*mnk) == \
        JaxConfig(**fields).hbm_traffic_bytes(*mnk)


def test_registry():
    assert pm.available_chips() == ["cpu", "h100"]
    assert pm.get_chip("h100") is pm.H100
    with pytest.raises(KeyError, match="unknown chip"):
        pm.get_chip("v5e")


def test_detect_chip_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert pm.detect_chip().name == "cpu"
    assert pm.detect_chip("cpu") is pm.CPU


def test_h100_constants():
    h = pm.H100
    assert h.hbm_bandwidth == 3.35e12
    assert h.vmem_bytes == SMEM_LIMIT_BYTES
    # NVLink 4: 18 links, 450 GB/s each way per card.
    assert h.ici_links == 18 and h.ici_bandwidth * h.ici_links == pytest.approx(450e9)
    assert h.tdp_watts == 700.0
    assert h.grid_step_overhead_s == 0.0  # not fitted: see perf_model.H100
    # The bounds of the kernels still read the bandwidth.
    secs, by = h.bound(0.0, 1.0, 3.35e12)
    assert (secs, by) == (1.0, "bytes")


def test_engine_tile_is_memory_bound_under_the_law():
    # The law counts every block's slab reads as device-memory traffic: for
    # bf16 8192^3 on the engine tile that is 13.0 GB, 3.886 ms at 3.35 TB/s.
    spec = pm.specifications(route_config("bfloat16"), 8192, 8192, 8192, chip=pm.H100)
    assert spec["blocks"] == (128, 256, 64)
    assert spec["bound"] == "memory"
    assert spec["io_volume_bytes"] == 8192 ** 3 * 2 * (1 / 128 + 1 / 256) + 8192 ** 2 * 2
    assert spec["expected_runtime_s"] == pytest.approx(3.886e-3, rel=1e-3)
    assert spec["ideal_runtime_s"] == pytest.approx(2 * 8192 ** 3 / 989e12)


def test_format_specifications():
    text = pm.format_specifications(
        pm.specifications(route_config("bfloat16"), 1024, 1024, 1024, chip=pm.H100))
    for line in ("Peak performance", "Communication volume", "Shared memory a block",
                 "(128, 256, 64)"):
        assert line in text


@pytest.mark.parametrize("dtype,semiring,ta,tb,aligned,route", [
    ("bfloat16", "plus_times", False, False, True, "wgmma"),
    ("float16", "plus_times", True, True, True, "wgmma"),
    ("bfloat16", "plus_times", False, False, False, "wgmma"),
    ("int8", "plus_times", False, True, True, "wgmma"),
    ("int8", "plus_times", False, False, True, "wgmma"),
    ("int8", "plus_times", True, True, True, "wgmma"),
    ("float32", "plus_times", False, False, True, "wgmma"),
    ("float32", "plus_times", True, False, False, "wgmma"),
    ("int32", "plus_times", False, False, True, "wgmma"),
    ("bfloat16", "min_plus", False, False, True, "simt"),
])
def test_route_config_follows_mxu_route(dtype, semiring, ta, tb, aligned, route):
    # Since the pack pass every bf16 / fp16 / int8 / fp32 plus_times call
    # takes the engine's tile, in any layout and at any alignment: the rule
    # and the config read neither (``aligned`` names the call each case
    # stands for).
    from gemm_hls_tpu_torch.ops.mxu import mxu_route

    assert call_route(dtype, semiring) == route
    if semiring == "plus_times":
        assert mxu_route(getattr(torch, dtype)) == route
    cfg = route_config(dtype, semiring=semiring, transpose_a=ta, transpose_b=tb)
    assert cfg.route() == route
    cfg.validate(strict_alignment=True, route=route)
    assert cfg.smem_bytes(route) <= SMEM_LIMIT_BYTES


@pytest.mark.parametrize("dtype,mnk,ta,tb,want", [
    ("bfloat16", (8192, 8192, 8190), False, False, 8192 * (8190 + 8192) * 2),  # A
    ("bfloat16", (8192, 8192, 8192), False, False, 0),
    ("bfloat16", (65, 100, 30), True, True, (65 + 100) * (30 + 32) * 2),  # both
    ("int8", (8192, 8192, 8192), False, False, 8192 * 8192 * 2),  # B (K, N)
    ("int8", (8192, 8192, 8192), False, True, 0),
    ("int8", (300, 520, 272), True, False, (300 + 520) * 272 * 2),
    ("float16", (7, 13, 5), False, True, (7 + 13) * (5 + 8) * 2),
    ("float32", (8192, 8192, 8190), False, False, 0),  # its split pass is its own
    ("int32", (100, 100, 99), False, False, 0),
])
def test_pack_bytes_charge_what_the_launch_packs(dtype, mnk, ta, tb, want):
    # config.pack_bytes: each operand packed_operands names read once and
    # written once with K rounded up to 16-byte rows, for contiguous
    # operands of these dims; perf_model charges them at the memory rate.
    assert pack_bytes(dtype, *mnk, ta, tb) == want
    cfg = route_config(dtype, transpose_a=ta, transpose_b=tb)
    base = pm.specifications(cfg, *mnk, chip=pm.H100)
    spec = pm.specifications(cfg, *mnk, chip=pm.H100, pack_bytes=want)
    if want:
        assert spec["pack_bytes"] == want
        assert spec["pack_s"] == pytest.approx(want / pm.H100.hbm_bandwidth)
        assert spec["expected_runtime_s"] == pytest.approx(
            base["expected_runtime_s"] + spec["pack_s"])
        assert "Pack pass" in pm.format_specifications(spec)
    else:
        assert spec == base and "pack_bytes" not in spec


def test_bf16_8192x8190_pack_bound():
    # The pack of bf16 8192 x 8190's A at 3.35 TB/s: 0.080 ms.
    assert pack_bytes("bfloat16", 8192, 8192, 8190) / pm.H100.hbm_bandwidth == \
        pytest.approx(80.1e-6, rel=1e-3)


def test_engine_shared_memory_is_the_kernels():
    # csrc/mxu_wgmma.cuh's kMxuWgSmem: 1024 bytes of slack, 4 stages of a
    # 128 x 128-byte A slab and a 256 x 128-byte B slab, 14 mbarriers, and
    # 2 x 2 x 256 floats of epilogue staging.
    want = 1024 + 4 * (128 + 256) * 128 + 14 * 8 + 2 * 2 * 256 * 4
    assert route_config("bfloat16").smem_bytes() == want == 201840
    assert route_config("int8", transpose_b=True).smem_bytes() == want


def test_default_config_stays_the_front_doors():
    # The front door validates against kernel_route's tile; route_config
    # is what the tools read.
    assert (default_config("bfloat16").block_m, default_config("bfloat16").block_n) == (128, 128)
    with pytest.raises(ValueError, match="compiled tile"):
        route_config("bfloat16").validate(strict_alignment=True, route="tc")


@pytest.mark.parametrize("dtype,passes", [("uint8", 1), ("int16", 4), ("uint16", 4),
                                          ("uint32", 10), ("int32", 10)])
def test_int_split_bound_counts_the_plane_pairs(dtype, passes):
    # B1 / B2's integers on the engine: slice_passes(planes, 4) products of
    # 2 M N K at the int8 rate (1 / 4 / 10), the split's bytes added (uint8:
    # the pack's, 0 in place); the CUDA-core tile's IMAD rate stays its own.
    from gemm_hls_tpu_torch.config import INT_PLANES, int_split_bytes
    m, n, k = 4096, 2048, 1000
    assert pm.slice_passes(INT_PLANES[dtype], 4) == passes
    products = passes * 2.0 * m * n * k / pm.H100.peak_for("int8")
    before = 0 if dtype == "uint8" else int_split_bytes(dtype, m, n, k) / pm.H100.hbm_bandwidth
    t, by = pm.int_split_bound(pm.H100, dtype, m, n, k)
    assert by == "operations" and t == pytest.approx(products + before, rel=1e-12)
    # Batched: every example's products and bytes.
    assert pm.int_split_bound(pm.H100, dtype, m, n, k, batch=3)[0] == pytest.approx(3 * t,
                                                                                  rel=1e-12)
    # The engine's tile and shared memory are int8's: one byte a K value.
    assert route_config(dtype).route() == "wgmma"
    assert route_config(dtype).smem_bytes() == route_config("int8", transpose_b=True).smem_bytes()
    if dtype != "uint8":  # the tensor cores take uint8 at the int8 rate
        assert pm.H100.peak_for(dtype) < pm.H100.peak_for("int8") / 10


def test_print_specifications_prints_the_byte_plane_bound(capsys):
    # The integers on the engine are charged the int8 rate over their plane
    # pairs and the split's bytes, in specifications itself.
    from gemm_hls_tpu_torch.config import int_split_bytes
    from gemm_hls_tpu_torch.tools import print_specifications
    spec = print_specifications.main(["4096", "4096", "4096", "--dtype", "int32",
                                      "--chip", "h100"])
    out = capsys.readouterr().out
    assert spec["peak_flops"] == pytest.approx(pm.H100.peak_for("int8") / 10, rel=1e-12)
    assert spec["ideal_runtime_s"] == pytest.approx(0.6945e-3, rel=1e-3)
    assert spec["split_bytes"] == int_split_bytes("int32", 4096, 4096, 4096)
    assert "Byte-plane split" in out and f"{spec['peak_flops'] / 1e9:.1f} GOp/s" in out
    assert spec["expected_runtime_s"] >= spec["ideal_runtime_s"] + spec["split_s"]


@pytest.mark.parametrize("dtype", ["int16", "uint8", "uint16", "uint32", "int32"])
def test_engine_integer_share_of_peak_stays_under_100(dtype):
    # run.py and profile.py read the peak of the route the call took: a
    # time at the function's floor on the engine is at most 100% of it,
    # while the CUDA-core tile named keeps the int32 multiply-add's peak.
    from gemm_hls_tpu_torch.utils.benchmark import gflops, percent_of_peak
    n = 4096
    floor, by = pm.int_gemm_bound(pm.H100, dtype, n, n, n)
    assert by == "operations"
    for cfg, route in ((route_config(dtype), None), (default_config(dtype), "wgmma")):
        spec = pm.specifications(cfg, n, n, n, chip=pm.H100, route=route)
        assert spec["peak_flops"] == pm.plus_times_peak(pm.H100, dtype, "wgmma")
        assert percent_of_peak(gflops(n, n, n, floor), spec["peak_flops"]) <= 100.0 + 1e-9
        assert spec["percent_of_peak"] <= 100.0
    simt = pm.specifications(default_config(dtype), n, n, n, chip=pm.H100)
    assert simt["peak_flops"] == pm.H100.peak_for(dtype) and "split_bytes" not in simt
