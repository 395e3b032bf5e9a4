"""B1 / B2's fp32 route on the tile engine (TF32 passes) and the backward's
precision, with no card.

On the card an aligned fp32 plus_times call runs the split pass
(``ops/mxu.py::tf32_operand``, ``csrc/tf32_split.cu``) and the engine's
TF32 passes (``csrc/mxu_wgmma_tf32.cu``): one at "default", the
reference's Precision.DEFAULT, three at "high" / "highest".  JAX computes
DEFAULT in full fp32 on the CPU, so the port's CPU plain path stays IEEE
fp32 and these tests hold what the CPU can show: the route rule, the
precision the backward asks for against the reference's
``_resolve_precision``, the split's plain version (which the card's
kernel equals bit for bit, phase 33 of ``chip_smoke.py``) and the passes
in float64 against JAX's ``matmul``.  Tolerances are stated at each test.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gemm_hls_tpu import GemmConfig as JaxConfig
from gemm_hls_tpu import matmul as jax_matmul
from gemm_hls_tpu.ops import pallas_mxu
from gemm_hls_tpu_torch import matmul
from gemm_hls_tpu_torch.config import (
    ENGINE_TILES, GemmConfig, call_route, named_route, route_config,
)
from gemm_hls_tpu_torch.ops import codegen, mxu
from gemm_hls_tpu_torch.tools import autotune
from gemm_hls_tpu_torch.utils import make_operands

matmul_mod = importlib.import_module("gemm_hls_tpu_torch.ops.matmul")
LAYOUTS = [(False, False), (True, False), (False, True), (True, True)]
JCFG = JaxConfig(block_m=32, block_n=128, block_k=128, interpret=True)


# ---- the route rule ---------------------------------------------------------

@pytest.mark.parametrize("ta,tb", LAYOUTS)
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("batched", [False, True])
def test_fp32_route_is_the_engine_where_a_tma_map_describes_it(ta, tb, aligned, batched):
    # fp32 plus_times takes the engine in every layout, 2-D (B1) and
    # batched (B2), whether or not both operands' bases, row pitches and
    # batch strides are whole 16-byte units: the split pass reads any pitch
    # and writes 16-byte rows, so since the pack pass's slice no pitch
    # keeps fp32 on the CUDA cores.
    lead = (3,) if batched else ()
    cols = 64 if aligned else 63  # 256- or 252-byte rows
    a = torch.zeros(lead + (40, cols))
    b = torch.zeros(lead + (cols, 64))
    ok = bool(mxu._vec_ok(a) and mxu._vec_ok(b))
    assert ok == aligned
    want = "wgmma"
    assert mxu.mxu_route(torch.float32) == want
    assert call_route("float32", "plus_times") == want
    cfg = route_config("float32", transpose_a=ta, transpose_b=tb)
    assert cfg.route() == want
    cfg.validate(strict_alignment=True, route=want)
    assert (cfg.block_m, cfg.block_n, cfg.block_k) == ENGINE_TILES["float32"] == (128, 256, 32)
    # One 128-byte swizzle row of 32 fp32 values a stage: the 16-bit types'
    # shared memory.
    assert cfg.smem_bytes() == route_config("bfloat16").smem_bytes()


@pytest.mark.parametrize("route,rule,ok", [
    ("simt", "wgmma", True),     # the CUDA-core tile beside the engine (a winner, an A/B)
    ("wgmma", "simt", False),    # fp32 into float64: the engine stores the base types
    ("wmma", "wgmma", False),    # no fp32 WMMA tile
    ("wmma", "simt", False),
    ("dmma", "wgmma", False),
])
def test_named_routes_of_fp32(route, rule, ok):
    if ok:
        assert named_route(route, rule, "B1", torch.float32) == route
    else:
        with pytest.raises(ValueError, match="cannot run"):
            named_route(route, rule, "B1", torch.float32)
    # The 16-bit types keep their rule: the CUDA cores never run them.
    with pytest.raises(ValueError, match="cannot run"):
        named_route("simt", "wgmma", "B1", torch.bfloat16)


def test_card_table_takes_the_routes_it_names():
    # chip_smoke.py's TF32_ROUTE_CASES (phase 33a and the card tests) and
    # UNALIGNED_TF32_CASES (phase 34c): the route each case asserts is
    # mxu_route's for its layout, pitches and batch strides (the engine at
    # every alignment), and both precisions are covered on aligned and
    # unaligned operands, the unaligned cases being run again on the CUDA
    # cores, named (their retired route).
    seen = set()
    for case in chip_smoke.TF32_ROUTE_CASES + chip_smoke.UNALIGNED_TF32_CASES:
        prec, ta, tb, bsz, m, n, k, pitch, bcast, _, specials, route = case

        def ok(rows, cols, three_d):
            width = (cols + 3) // 4 * 4 + 4 if pitch else cols
            return width % 4 == 0 and (not three_d or rows * width % 4 == 0)

        aligned = (ok(*((k, m) if ta else (m, k)), bsz and bcast != "a")
                   and ok(*((n, k) if tb else (k, n)), bsz and bcast != "b"))
        assert mxu.mxu_route(torch.float32) == route == "wgmma", case
        old = chip_smoke.retired_route(*chip_smoke.tf32_case_layout(case))
        assert old == (None if aligned else "simt"), case
        seen.add((old or route, prec))
        if specials:
            seen.add(("specials", old or route, prec))
    assert seen == {(r, p) for r in ("wgmma", "simt") for p in ("default", "high")} | {
        ("specials", r, p) for r in ("wgmma", "simt") for p in ("default", "high")}
    assert all(chip_smoke.retired_route(*chip_smoke.tf32_case_layout(c)) == "simt"
               for c in chip_smoke.UNALIGNED_TF32_CASES)
    assert chip_smoke.TF32_REPEAT_CASES and all(
        c[-1] == "wgmma" for c in chip_smoke.TF32_REPEAT_CASES)


# ---- the backward's precision against the reference's -----------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32", "float64"])
@pytest.mark.parametrize("precision", ["default", "high", "highest"])
def test_backward_precision_is_the_references(dtype, precision, monkeypatch):
    # The reference's backward keeps the forward's config, whose
    # _resolve_precision gives DEFAULT for 16-bit inputs.  Read from the
    # configs and operands _mxu_bwd hands to the two GEMMs: a 16-bit
    # layer's cotangent arrives in its own type here (out.float()'s
    # backward casts it back), so both GEMMs run on that type (its products
    # exact in fp32, DEFAULT's values); fp32 and float64 layers keep the
    # config's precision on their own type.  An fp32 cotangent of a 16-bit
    # layer (an fp32 output) meets the 16-bit operand as fp32 at DEFAULT:
    # one TF32 pass on the card, the 16-bit operand handed over unpromoted
    # (the split pass reads it as it is).
    want = pallas_mxu._resolve_precision(JaxConfig(dtype=dtype, precision=precision))
    assert matmul_mod.backward_precision(GemmConfig(dtype=dtype, precision=precision)) in (
        pallas_mxu._PRECISION)
    seen, inner = [], matmul_mod._plus_times

    def spy(a, b, cfg, route=None):
        seen.append((cfg, a.dtype, b.dtype))
        return inner(a, b, cfg, route)

    dt = getattr(torch, dtype)
    a = torch.from_numpy(make_operands(9, 6, 7, "float32")[0]).to(dt).requires_grad_()
    b = torch.from_numpy(make_operands(9, 6, 7, "float32")[1]).to(dt).requires_grad_()
    out = matmul(a, b, precision=precision)
    out32 = matmul(a, b, precision=precision, out_dtype="float32")
    monkeypatch.setattr(matmul_mod, "_plus_times", spy)
    out.float().sum().backward()
    assert len(seen) == 2 and a.grad is not None and b.grad is not None
    for cfg, da, db in seen:
        assert cfg.dtype == dtype and da == db == dt
        assert pallas_mxu._PRECISION[cfg.precision] == want, (cfg.precision, want)
    if dt.itemsize != 2:
        return
    seen.clear()
    out32.sum().backward()
    assert len(seen) == 2
    for cfg, da, db in seen:
        assert cfg.dtype == "float32" and {da, db} == {torch.float32, dt}
        assert pallas_mxu._PRECISION[cfg.precision] == want, (cfg.precision, want)
    # A 16-bit layer's fp32 cotangent runs one TF32 pass on the card.
    assert {mxu.tf32_passes(c.precision) for c, _, _ in seen} == {1}


# ---- the split's plain version ---------------------------------------------

def _parts(x):
    x = torch.tensor(x, dtype=torch.float32)
    hi, lo = mxu.tf32_split_plain(x)
    return x, hi, lo


def _low_bits(t):
    return (t.view(torch.int32) & 0x1FFF).abs()


def test_split_of_normals_reconstructs_to_2_to_the_minus_22():
    # hi: 10 mantissa bits (the low 13 zero); |x - hi - lo| <= 2^-22 |x|
    # (lo is x - hi rounded to TF32), under the 2^-21 three passes need.
    rng = np.random.default_rng(0)
    vals = (rng.standard_normal(20000) * 10.0 ** rng.integers(-30, 30, 20000)).astype(np.float32)
    x, hi, lo = _parts(vals)
    assert int(_low_bits(hi).max()) == 0 and int(_low_bits(lo).max()) == 0
    err = (x.double() - hi.double() - lo.double()).abs()
    assert float((err / x.double().abs()).max()) <= 2.0 ** -22
    assert float(((x.double() - hi.double()).abs() / x.double().abs()).max()) <= 2.0 ** -11


def test_split_rounds_to_nearest_even_as_an_independent_rounding_does():
    # hi against frexp / rint / ldexp in float64 (rint ties to even): 11
    # significant bits of every normal fp32 value whose rounding stays
    # finite.
    rng = np.random.default_rng(1)
    bits = rng.integers(0x00800000, 0x7F7F0000, 40000, dtype=np.int64).astype(np.uint32)
    bits = np.concatenate([bits, bits | np.uint32(0x80000000)])
    vals = bits.view(np.float32)
    mant, exp = np.frexp(vals.astype(np.float64))
    want = np.ldexp(np.rint(np.ldexp(mant, 11)), exp - 11).astype(np.float32)
    _, hi, _ = _parts(vals)
    np.testing.assert_array_equal(hi.numpy().view(np.uint32), want.view(np.uint32))
    # Ties at bit 13 go to the even neighbour, away from it otherwise.
    _, hi, lo = _parts([1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -11 + 2 ** -20])
    assert hi.tolist() == [1.0, 1 + 2 ** -9, -1.0, 1 + 2 ** -10]
    assert lo.tolist()[:3] == [2 ** -11, -(2 ** -11), -(2 ** -11)]


def test_split_of_subnormals_powers_of_two_and_the_largest_values():
    # Subnormals: hi on TF32's subnormal grid (2^-136 apart), hi + lo
    # within half of it (2^-137); powers of two exact with lo 0; the
    # largest finite values, whose rounding would overflow, cut toward zero
    # so hi stays finite and hi + lo stays x within 2^-22.
    x, hi, lo = _parts([1e-40, -3e-39, 2.0 ** -149, 2.0 ** -126 + 2.0 ** -140, 5e-45])
    assert int(_low_bits(hi).max()) == 0
    assert float((x.double() - hi.double() - lo.double()).abs().max()) <= 2.0 ** -137
    p2 = [2.0 ** e for e in range(-126, 128, 7)] + [-(2.0 ** e) for e in range(-100, 100, 9)]
    x, hi, lo = _parts(p2)
    assert torch.equal(hi, x) and int((lo != 0).sum()) == 0
    x, hi, lo = _parts([3.4028235e38, -3.4028235e38, 3.3e38])
    assert bool(torch.isfinite(hi).all()) and int(_low_bits(hi).max()) == 0
    assert float(((x.double() - hi.double() - lo.double()).abs() / x.double().abs()).max()) \
        <= 2.0 ** -22


def test_split_of_infinities_nan_and_zeros():
    x, hi, lo = _parts([float("inf"), -float("inf"), float("nan"), -float("nan"), 0.0, -0.0])
    assert hi[0] == float("inf") and hi[1] == -float("inf")
    assert bool(torch.isnan(hi[2:4]).all()) and int(_low_bits(hi[2:4]).max()) == 0
    assert lo.tolist()[:4] == [0.0] * 4
    assert torch.equal(hi[4:].view(torch.int32), x[4:].view(torch.int32))
    # A NaN whose payload sits only in the low 13 bits stays a NaN.
    odd_nan = torch.tensor([0x7F800001, 0x7F801000], dtype=torch.int32).view(torch.float32)
    assert bool(torch.isnan(mxu.tf32_split_plain(odd_nan)[0]).all())


@pytest.mark.parametrize("mn_major", [False, True])
@pytest.mark.parametrize("passes,side", [(1, "a"), (3, "a"), (3, "b")])
@pytest.mark.parametrize("lead", [(), (3,), (1,)])
def test_workspace_layout(mn_major, passes, side, lead):
    # (rows, passes * kp), K padded to 4 values with zeros; the segments
    # hi | hi | lo for A and hi | lo | hi for B, the hi facing the other's
    # lo (A's segment 1, B's segment 2) 0 for +-inf and NaN; a batch of
    # one is 2-D.  The card's split pass equals this bit for bit (phase 33).
    rows, k = 5, 7
    x = torch.randn(lead + ((k, rows) if mn_major else (rows, k)))
    x[..., 1, 2], x[..., 3, 4], x[..., 4, 0] = float("inf"), -float("inf"), float("nan")
    w = mxu.tf32_operand_plain(x, mn_major, passes, side)
    assert w.shape == ((3,) if lead == (3,) else ()) + (rows, passes * 8)
    xr = x.transpose(-1, -2) if mn_major else x
    hi, lo = mxu.tf32_split_plain(xr)
    hi, lo = (t[0] if lead == (1,) else t for t in (hi, lo))
    segs = w.reshape(w.shape[:-1] + (passes, 8))
    lo_seg = mxu.TF32_LO_SEG[side] if passes == 3 else None
    for s in range(passes):
        want = lo if s == lo_seg else hi
        if lo_seg is not None and s == 3 - lo_seg:
            want = torch.where(torch.isfinite(hi), hi, torch.zeros_like(hi))
            assert int((segs[..., s, :k] == 0).sum()) >= 3 * (lead[0] if lead else 1)
        assert torch.equal(segs[..., s, :k].view(torch.int32), want.view(torch.int32))
        assert int((segs[..., s, k:] != 0).sum()) == 0


def test_split_pass_wrapper_takes_only_card_tensors():
    with pytest.raises(ValueError, match="runs on the card"):
        mxu.tf32_operand(torch.ones(4, 4), False, 3, "a")


# ---- the passes in float64 against JAX's matmul ------------------------------

@pytest.mark.parametrize("transpose_a", [False, True])
def test_emulated_passes_against_jax(transpose_a):
    # tests/test_matmul.py's gradient shapes, 33 x 60 x 70: the three
    # passes within its rtol 1e-3 of JAX's matmul on the CPU, elementwise
    # (observed normwise 1.22e-7 without and 1.28e-7 with transpose_a, most
    # of it JAX's own fp32 rounding); one pass normwise within 1e-3
    # (observed 5.2e-5 and 4.7e-5: TF32's 2^-11 rounding, which the CPU's
    # IEEE DEFAULT does not have).
    a, b = make_operands(33, 60, 70, "float32", transpose_a=transpose_a)
    exp = np.asarray(jax_matmul(jnp.asarray(a), jnp.asarray(b), config=JCFG,
                                transpose_a=transpose_a)).astype(np.float64)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    three = mxu.tf32_matmul_plain(ta, tb, 3, transpose_a=transpose_a).double().numpy()
    one = mxu.tf32_matmul_plain(ta, tb, 1, transpose_a=transpose_a).double().numpy()
    np.testing.assert_allclose(three, exp, rtol=1e-3)
    assert np.linalg.norm(three - exp) / np.linalg.norm(exp) < 1e-6
    assert np.linalg.norm(one - exp) / np.linalg.norm(exp) < 1e-3
    # The port's CPU front door stays IEEE fp32 at every precision, as
    # JAX's CPU dot computes DEFAULT.
    for precision in ("default", "high"):
        got = matmul(ta, tb, transpose_a=transpose_a, precision=precision).numpy()
        np.testing.assert_allclose(got, exp, rtol=1e-5)


@pytest.mark.parametrize("ta,tb", LAYOUTS)
@pytest.mark.parametrize("passes", [1, 3])
def test_emulated_passes_put_infinities_and_nans_where_jax_does(ta, tb, passes):
    # +-inf and NaN in both operands (chip_smoke.tf32_plant_specials, the
    # card cases' own): the passes give +-inf and NaN exactly where JAX's
    # matmul on the CPU does (IEEE fp32), among them +-inf times a value
    # whose lo is 0 (1.0), which the cross terms alone would make NaN; the
    # finite values as test_emulated_passes_against_jax holds them
    # (observed normwise 1.2e-7 for three passes, 5e-5 for one).
    a, b = make_operands(33, 60, 70, "float32", transpose_a=ta, transpose_b=tb)
    ta_, tb_ = torch.from_numpy(a), torch.from_numpy(b)
    chip_smoke.tf32_plant_specials(torch, ta_)
    chip_smoke.tf32_plant_specials(torch, tb_)
    ta_[..., 7, :] = 1.0  # a whole row (or column) of 1.0 meets B's infinities
    exp = np.asarray(jax_matmul(jnp.asarray(ta_.numpy()), jnp.asarray(tb_.numpy()),
                                config=JCFG, transpose_a=ta, transpose_b=tb))
    exp = torch.from_numpy(exp.astype(np.float64))
    got = mxu.tf32_matmul_plain(ta_, tb_, passes, transpose_a=ta, transpose_b=tb).double()
    for test in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(test(got), test(exp)), test
    n_inf, n_nan = int(torch.isinf(exp).sum()), int(torch.isnan(exp).sum())
    assert n_inf > 60 and n_nan > 60 and n_inf + n_nan < exp.numel() // 2
    fin = torch.isfinite(exp)
    err = float((got[fin] - exp[fin]).norm() / exp[fin].norm())
    assert err < (1e-6 if passes == 3 else 1e-3), err
    # The port's CPU front door is IEEE fp32 and agrees with JAX's too.
    cpu = matmul(ta_, tb_, transpose_a=ta, transpose_b=tb).double()
    for test in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(test(cpu), test(exp)), test


def test_emulated_batched_and_broadcast_operands():
    # B2's workspaces: a 3-D operand per example, a 2-D one once.
    a = torch.randn(4, 9, 12)
    b = torch.randn(12, 5)
    want = torch.matmul(a.double(), b.double())
    got = mxu.tf32_matmul_plain(a, b, 3)
    assert got.shape == (4, 9, 5)
    assert float((got.double() - want).norm() / want.norm()) < 1e-6


# ---- the generated epilogue's engine source ---------------------------------

def test_fp32_engine_epilogue_sources():
    prog = codegen.lower_epilogue(lambda acc, c: torch.relu(acc + c), torch.float32,
                                  [torch.float32])
    three = codegen.epilogue_source(prog, "wgmma", torch.float32, False, True, tile="tf32x3")
    one = codegen.epilogue_source(prog, "wgmma", torch.float32, False, True, tile="tf32x1")
    assert "launch_mxu_wg_ep<float, false, false, true>" in three
    assert "launch_mxu_wg_ep<float, false, false>" in one
    with pytest.raises(NotImplementedError, match="engine tile"):
        codegen.epilogue_source(prog, "wgmma", torch.float32, False, True)
    with pytest.raises(NotImplementedError, match="engine tile"):
        codegen.epilogue_source(prog, "wgmma", torch.bfloat16, False, False, tile="tf32x3")


# ---- the tuner: both routes offered, a CUDA-core winner adopted ---------------

def test_tuner_offers_both_fp32_routes_and_its_ceiling_is_tf32s():
    cands = autotune.candidate_configs(1024, 1024, 1024, "float32", "plus_times")
    assert [autotune._MXU_ROUTE[c.route()] for c in cands] == ["wgmma", "simt"]
    assert autotune.batch_block_candidates(8, 512, 512, 512, "float32") == ["wgmma", "simt"]
    # An unaligned K keeps both: the engine (after the split pass, which
    # reads any pitch) and the CUDA cores beside it.
    cands = autotune.candidate_configs(1024, 1024, 1001, "float32", "plus_times")
    assert [autotune._MXU_ROUTE[c.route()] for c in cands] == ["wgmma", "simt"]
    assert autotune._ceiling("cpu", "float32") == autotune._ceiling("cpu", "tfloat32")


@pytest.mark.parametrize("route", ["simt", "wgmma"])
def test_cached_fp32_winner_of_either_route_is_adopted(route, tmp_path, monkeypatch):
    cache = tmp_path / "tune.json"
    bm, bn, bk = (128, 128, 16) if route == "simt" else ENGINE_TILES["float32"]
    key = autotune._key("cpu", "float32", "plus_times", 512, 512, 512)
    bkey = autotune._key_batched("cpu", "float32", "plus_times", 8, 512, 512, 512)
    autotune._store(str(cache), {key: {"block_m": bm, "block_n": bn, "block_k": bk,
                                       "route": route},
                                 bkey: {"route": route}})
    hit = autotune.cached_winner(512, 512, 512, dtype="float32", cache_path=str(cache),
                                 device="cpu")
    assert hit is not None and hit[1] == route and hit[0].route() == route
    assert autotune.cached_batch_block(8, 512, 512, 512, dtype="float32",
                                       cache_path=str(cache), device="cpu") == route
    # The front door's hooks take the entry and the plain output stays.
    monkeypatch.setattr(autotune, "DEFAULT_CACHE", str(cache))
    monkeypatch.setattr(autotune, "SEED_CACHE", str(tmp_path / "absent.json"))
    a, b = torch.randn(512, 512), torch.randn(512, 512)
    torch.testing.assert_close(matmul(a, b), torch.matmul(a, b), rtol=1e-5, atol=1e-4)
    a3, b3 = torch.randn(8, 512, 512), torch.randn(8, 512, 512)
    torch.testing.assert_close(matmul(a3, b3), torch.matmul(a3, b3), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("out,want", [(None, "wgmma"), ("float32", "wgmma"),
                                      ("bfloat16", "wgmma"), ("float16", "wgmma"),
                                      ("float64", "simt")])
def test_route_rule_reads_the_output_type(out, want, tmp_path):
    # The engine stores the base types, so fp32 into float64 stays on the
    # CUDA cores; the tuner's rule and its cached-winner lookups read the
    # same rule, so a cached fp32 engine winner is a miss for a float64
    # output (and a CUDA-core one is taken for any output).
    assert call_route("float32", "plus_times", out) == want
    assert mxu.mxu_route(torch.float32, out) == want
    assert autotune._dense_rule("float32", "plus_times", out) == want
    cache = tmp_path / "tune.json"
    bm, bn, bk = ENGINE_TILES["float32"]
    autotune._store(str(cache), {
        autotune._key("cpu", "float32", "plus_times", 512, 512, 512): {
            "block_m": bm, "block_n": bn, "block_k": bk, "route": "wgmma"},
        autotune._key_batched("cpu", "float32", "plus_times", 8, 512, 512, 512): {
            "route": "wgmma"}})
    hit = autotune.cached_winner(512, 512, 512, dtype="float32", cache_path=str(cache),
                                 device="cpu", out_dtype=out)
    assert (hit is not None and hit[1] == "wgmma") == (want == "wgmma")
    batched = autotune.cached_batch_block(8, 512, 512, 512, dtype="float32",
                                          cache_path=str(cache), device="cpu", out_dtype=out)
    assert batched == (None if want == "simt" else "wgmma")
    # The front door's hook passes the call's output type.
    a = torch.zeros(512, 512)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(autotune, "DEFAULT_CACHE", str(cache))
        mp.setattr(autotune, "SEED_CACHE", str(tmp_path / "absent.json"))
        assert matmul_mod._cached_winner(a, a, False, False, out)[1] == (
            None if want == "simt" else "wgmma")
        assert matmul_mod._cached_winner(a[None].expand(8, -1, -1), a, False, False, out)[1] \
            == (None if want == "simt" else "wgmma")
