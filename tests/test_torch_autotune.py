"""The port's tuner (``gemm_hls_tpu_torch/tools/autotune.py``) on the CPU.

Its keys and padding guard against the JAX package's
(``gemm_hls_tpu.tools.autotune``) on the same inputs, exact; the lookups'
guards (a route the rule cannot run, padding over 1.3x, the user cache
before the seed); the tuning loop with an injected ``measure``; the front
doors' hooks, which on the CPU read a ``cpu`` entry and run the plain
version unchanged; the packaged seed's entries.  Candidates are measured
only on the card (``tests/test_torch_kernels.py``, ``chip_smoke.py`` phase
26).
"""

import importlib
import json

import numpy as np
import pytest
import torch

from gemm_hls_tpu.tools import autotune as jat
from gemm_hls_tpu_torch import attention, flash_attention, grouped_matmul, matmul
from gemm_hls_tpu_torch.config import ENGINE_TILES, KERNEL_TILES, GemmConfig
from gemm_hls_tpu_torch.ops import dequant, flash, gmm, quant
from gemm_hls_tpu_torch.tools import autotune as at

mm = importlib.import_module("gemm_hls_tpu_torch.ops.matmul")
grouped_mod = importlib.import_module("gemm_hls_tpu_torch.ops.grouped")


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """(user cache, seed) paths the lookups read, both absent at first."""
    user, seed = tmp_path / "user.json", tmp_path / "seed.json"
    monkeypatch.setattr(at, "DEFAULT_CACHE", str(user))
    monkeypatch.setattr(at, "SEED_CACHE", str(seed))
    return user, seed


def write(path, data):
    path.write_text(json.dumps(data))
    at._load_memo.clear()  # a rewrite within the file system's mtime tick


# ---- keys and the padding guard, exactly the reference's ------------------

@pytest.mark.parametrize("x", [0, 1, 2, 3, 127, 128, 129, 1000, 1024, 1025, 4100,
                               8191, 8192, 65537, 2**31 - 1])
def test_bucket_matches_jax(x):
    assert at._bucket(x) == jat._bucket(x)


@pytest.mark.parametrize("layout", ["nn", "tn", "nt", "tt"])
@pytest.mark.parametrize("dims", [(8192, 8192, 8192), (100, 3000, 77), (1, 1, 1)])
def test_dense_and_batched_keys_match_jax(layout, dims):
    assert at._key("h100", "bfloat16", "plus_times", *dims, layout) == jat._key(
        "h100", "bfloat16", "plus_times", *dims, layout)
    assert at._key_batched("h100", "int8", "plus_times", 64, *dims) == jat._key_batched(
        "h100", "int8", "plus_times", 64, *dims)


@pytest.mark.parametrize("family,dims,tag", [
    ("flash", (32, 1024, 1024, 128), "causal"), ("flash", (5, 1000, 3000, 80), "full"),
    ("dequant4", (64, 2048, 2048), "g128"), ("dequant8", (130, 512, 4100), "chan"),
    ("w8a8", (4096, 2048, 2048), "chan"), ("grouped", (8192, 2048, 4096, 8), "")])
def test_family_keys_match_jax(family, dims, tag):
    assert at._key_family("h100", family, "bfloat16", dims, tag) == jat._key_family(
        "h100", family, "bfloat16", dims, tag)


@pytest.mark.parametrize("family,dims", [
    ("flash", (32, 1024, 1024, 128)), ("flash", (8, 1000, 1100, 64)),
    ("w8a8", (4096, 2048, 2048)), ("dequant4", (64, 2048, 2048)),
    ("dequant8", (130, 700, 4100)), ("grouped", (8192, 2048, 4096, 8)),
    ("grouped", (300, 100, 1000, 4)), ("other", (1, 2, 3))])
@pytest.mark.parametrize("entry", [
    {}, {"block_q": 128, "block_kv": 64}, {"block_m": 64, "block_n": 64, "block_k": 64},
    {"block_m": 256, "block_n": 128, "block_k": 128, "block_q": 512, "block_kv": 4096}])
def test_family_pad_ratio_matches_jax(family, dims, entry):
    assert at._family_pad_ratio(family, dims, entry) == jat._family_pad_ratio(
        family, dims, entry)


def test_seed_key_dtype_matches_jax():
    for key in ("h100/bfloat16/plus_times/8x8x8", "h100/flash/float16/1x2x3x4/full",
                "h100/grouped/bfloat16/8x8x8x8", "bad"):
        assert at._seed_key_dtype(key) == jat._seed_key_dtype(key)


# ---- the lookups' guards ---------------------------------------------------

ENGINE = {"block_m": 128, "block_n": 256, "block_k": 64, "route": "wgmma"}
WMMA = {"block_m": 128, "block_n": 128, "block_k": 32, "route": "wmma"}


def test_cached_config_hit_and_guards(caches):
    user, _ = caches
    write(user, {"cpu/bfloat16/plus_times/1024x1024x1024": ENGINE,
                 "cpu/bfloat16/plus_times/1024x1024x1024/tn": WMMA,
                 "cpu/int8/plus_times/1024x1024x1024": dict(ENGINE, block_k=128),
                 "cpu/int8/plus_times/1024x1024x1024/nt": dict(ENGINE, block_k=128),
                 "cpu/float16/plus_times/1024x1024x1024": dict(ENGINE, block_m=256),
                 "cpu/float16/plus_times/256x256x256": dict(WMMA, route="wgmma")})
    cfg = at.cached_config(1024, 1024, 1024, dtype="bfloat16", device="cpu")
    assert (cfg.block_m, cfg.block_n, cfg.block_k) == ENGINE_TILES["bfloat16"]
    assert cfg.route() == "wgmma"
    cfg = at.cached_config(1024, 1024, 1024, dtype="bfloat16", layout="tn", device="cpu")
    assert cfg.transpose_a and not cfg.transpose_b and cfg.route() == "tc"
    assert at.cached_winner(1000, 1000, 1000, dtype="bfloat16", layout="tn",
                            device="cpu")[1] == "wmma"
    # The engine reads int8 K-major only, and the pack pass turns an "nn"
    # call's B K-major first: an "nn" engine entry is a hit too.
    assert at.cached_config(1024, 1024, 1024, dtype="int8", device="cpu") is not None
    assert at.cached_config(1024, 1024, 1024, dtype="int8", layout="nt",
                            device="cpu") is not None
    # Rows that are not whole 16-byte units (K = 1000 bf16 is, 1001 is not):
    # the engine runs them after the pack pass, so its entry is a hit, and
    # the lookup asks nothing of the operands' alignment.
    assert at.cached_config(1024, 1024, 1000, dtype="bfloat16", device="cpu")
    assert at.cached_config(1024, 1024, 1001, dtype="bfloat16", device="cpu")
    with pytest.raises(TypeError):
        at.cached_config(1024, 1024, 1024, dtype="bfloat16", aligned=False, device="cpu")
    # Blocks that are no compiled tile, a route the blocks do not name.
    assert at.cached_config(1024, 1024, 1024, dtype="float16", device="cpu") is None
    assert at.cached_config(256, 256, 256, dtype="float16", device="cpu") is None
    # Padding: M = 520 under a 128-row tile pads 640 / 520 = 1.23 (a hit);
    # N = 520 under the 256-wide tile pads 768 / 520 = 1.48 (a miss).
    assert at.cached_config(520, 1024, 640, dtype="bfloat16", device="cpu")
    assert at.cached_config(1024, 520, 1024, dtype="bfloat16", device="cpu") is None


def test_user_cache_before_seed(caches):
    user, seed = caches
    write(seed, {"cpu/bfloat16/plus_times/2048x2048x2048": ENGINE})
    assert at.cached_winner(2048, 2048, 2048, dtype="bfloat16", device="cpu")[1] == "wgmma"
    write(user, {"cpu/bfloat16/plus_times/2048x2048x2048": WMMA})
    assert at.cached_winner(2048, 2048, 2048, dtype="bfloat16", device="cpu")[1] == "wmma"
    # An unusable user entry falls through to the seed's.
    write(user, {"cpu/bfloat16/plus_times/2048x2048x2048": dict(WMMA, block_k=16)})
    assert at.cached_winner(2048, 2048, 2048, dtype="bfloat16", device="cpu")[1] == "wgmma"
    # The lookups key on the device's chip: the card's entries are not the CPU's.
    write(seed, {"h100/bfloat16/plus_times/2048x2048x2048": ENGINE})
    assert at.cached_winner(2048, 2048, 2048, dtype="bfloat16", device="cpu") is None


def test_cached_batch_block_is_b2s_route(caches):
    user, _ = caches
    write(user, {"cpu/bfloat16/plus_times/256bx128x128x128": {"route": "wmma"},
                 "cpu/bfloat16/plus_times/64bx512x512x512": {"route": "wgmma"},
                 "cpu/bfloat16/plus_times/4bx128x128x128": {"route": "wgmma"},
                 "cpu/bfloat16/plus_times/8bx512x512x512": {"batch_block": 4}})
    assert at.cached_batch_block(256, 128, 128, 128, dtype="bfloat16", device="cpu") == "wmma"
    assert at.cached_batch_block(64, 512, 512, 512, dtype="bfloat16", device="cpu") == "wgmma"
    # The engine's 256-wide tile pads N = 128 twice over: a miss.
    assert at.cached_batch_block(4, 128, 128, 128, dtype="bfloat16", device="cpu") is None
    # The TPU's batch block is not a route.
    assert at.cached_batch_block(8, 512, 512, 512, dtype="bfloat16", device="cpu") is None


def test_cached_family_entry_guards(caches):
    user, _ = caches
    write(user, {
        "cpu/flash/bfloat16/32x1024x1024x128/causal": {"route": "wgmma", "bwd_route": "wgmma",
                                                       "block_q": 128, "block_kv": 128},
        "cpu/flash/bfloat16/32x128x64x128/causal": {"route": "mma.sync", "bwd_route": "wgmma"},
        "cpu/dequant4/bfloat16/64x2048x2048/g128": {"route": "wgmma", "plan": [64, 1],
                                                     "block_m": 64, "block_n": 64,
                                                     "block_k": 128},
        "cpu/w8a8/bfloat16/4096x2048x2048/g128": {"route": "wgmma", "plan": 128},
        "cpu/w8a8/bfloat16/4096x2048x2048/chan": {"route": "wgmma", "plan": 128},
        "cpu/grouped/bfloat16/8192x2048x4096x8": {"route": "wgmma", "block_m": 128,
                                                  "block_n": 256, "block_k": 64}})
    kw = dict(dtype="bfloat16", device="cpu")
    assert at.cached_family_entry("flash", (32, 1024, 1024, 128), tag="causal", **kw)
    # D 80 has no engine kernel; the backward's engine needs 64 kv rows.
    assert at.cached_family_entry("flash", (32, 1024, 1024, 80), tag="causal", **kw) is None
    assert at.cached_family_entry("flash", (32, 100, 60, 128), tag="causal", **kw) is None
    assert at.cached_family_entry("flash", (32, 1024, 1024, 128), tag="causal",
                                  aligned=False, **kw) is None
    # B13's plan must be one the engine plans for this shape.
    plans = dequant.dequant_engine_plans(64, 2048, 2048, 132)
    e = at.cached_family_entry("dequant4", (64, 2048, 2048), tag="g128", **kw)
    assert (e is not None) == ((64, 1) in plans)
    write(user, dict(json.loads(user.read_text()), **{
        "cpu/dequant4/bfloat16/64x2048x2048/g128": {"route": "wgmma", "plan": list(plans[1]),
                                                     "block_m": 64, "block_n": plans[1][0],
                                                     "block_k": 128}}))
    assert at.cached_family_entry("dequant4", (64, 2048, 2048), tag="g128", **kw)
    # W8A8 group-wise: scale blocks end inside K, so the engine takes N 64 only.
    assert at.cached_family_entry("w8a8", (4096, 2048, 2048), tag="g128", **kw) is None
    assert at.cached_family_entry("w8a8", (4096, 2048, 2048), tag="chan", **kw)
    assert at.cached_family_entry("grouped", (8192, 2048, 4096, 8), **kw)
    # 8000 slots and K 2000 pad the engine's tile 1.03x, its rows of 4000
    # bytes whole 16-byte units; rows of K 1100 (2200 bytes) are not.
    assert at.cached_family_entry("grouped", (8000, 2000, 4096, 8), **kw)
    assert at.cached_family_entry("grouped", (8000, 1100, 4096, 8), **kw) is None


# ---- candidates and the tuning loop ----------------------------------------

@pytest.mark.parametrize("dtype,layout,routes", [
    ("bfloat16", "nn", ["wgmma", "wmma"]), ("float16", "tt", ["wgmma", "wmma"]),
    ("int8", "nn", ["wgmma", "wmma"]), ("int8", "nt", ["wgmma", "wmma"]),
    ("float32", "nn", ["wgmma", "simt"]), ("int32", "nn", ["wgmma", "simt"])])
def test_candidate_configs_are_the_routes_that_run(dtype, layout, routes):
    cands = at.candidate_configs(1024, 1024, 1024, dtype, "plus_times", layout=layout)
    assert [at._MXU_ROUTE[c.route()] for c in cands] == routes
    for c in cands:
        c.validate(strict_alignment=True)
        assert (c.transpose_a, c.transpose_b) == (layout[0] == "t", layout[1] == "t")
    assert at.batch_block_candidates(8, 1024, 1024, 1024, dtype) == routes
    # Unaligned rows keep both: the engine (after the pack pass) and WMMA.
    assert [at._MXU_ROUTE[c.route()] for c in at.candidate_configs(
        1024, 1024, 1001, "bfloat16", "plus_times")] == ["wgmma", "wmma"]
    sr = at.candidate_configs(512, 512, 512, "float32", "min_plus")
    assert [(c.block_m, c.block_n, c.block_k) for c in sr] == [KERNEL_TILES["simt"]]


def test_tuning_loop_picks_fastest_and_drops_failures(tmp_path):
    cache = str(tmp_path / "tuned.json")
    calls = {"slow": 0, "flaky": 0, "impossible": 0}

    def measure(e):
        calls[e["route"]] += 1
        if e["route"] == "flaky" and calls["flaky"] == 2:
            raise RuntimeError("a launch failed in round 2")
        return {"slow": 2e-3, "flaky": 1e-3, "impossible": 1e-9}[e["route"]]

    flops = 2.0 * 1024 ** 3
    best = at._tune_family("grouped", (1024, 1024, 1024, 4), "bfloat16", "",
                           [{"route": "slow"}, {"route": "flaky"}, {"route": "impossible"}],
                           measure, flops, 1e6, cache, 3, True, False, device="cpu")
    report = {r["entry"]["route"]: r for r in at._tune_family.last_report}
    # The flaky candidate read fastest in round 1 and failed in round 2: it
    # loses every round (no partial median).
    assert best["route"] == "slow" and report["flaky"]["status"] == "fail:RuntimeError"
    assert report["flaky"]["samples_ms"] == [] and calls["flaky"] == 2
    # Above the ceiling: measured three times a round, every reading dropped.
    assert report["impossible"]["status"] == "unreliable_timing"
    assert calls["impossible"] == 9 and report["impossible"]["dropped"] == 3
    assert report["slow"]["samples_ms"] == [2.0, 2.0, 2.0]
    stored = json.loads(open(cache).read())["cpu/grouped/bfloat16/1024x1024x1024x4"]
    assert stored["route"] == "slow" and stored["ms"] == 2.0 and stored["card"] == "cpu"
    assert stored["gflops"] == round(flops / 2e-3 / 1e9, 1)
    # A cached winner is returned without measuring.
    assert at._tune_family("grouped", (1024, 1024, 1024, 4), "bfloat16", "", [],
                           None, flops, None, cache, 3, False, False,
                           device="cpu")["route"] == "slow"


def test_tuning_loop_checks_against_plain_first():
    def check(e):
        if e["route"] == "broken":
            raise ValueError("cannot run")
        return e["route"] != "wrong"

    best, gf, ms, report = at._measure(
        [{"route": r} for r in ("wrong", "broken", "ok")], lambda e: 1e-3, 1e9, None, 2,
        False, check)
    assert best == {"route": "ok"} and ms == 1.0
    assert [r["status"] for r in report] == ["wrong_result", "fail:ValueError", "ok"]
    assert at._measure([{"route": "x"}], lambda e: 1e-3, 1e9, None, 1, False,
                       lambda e: False)[0] is None


def test_tuners_on_the_cpu_with_an_injected_timer(tmp_path, monkeypatch):
    """The tuners' candidates, plain checks and entries; the timer is the
    one part that needs the card."""
    monkeypatch.setattr(at, "_timer", lambda run, iters: (
        lambda e: (run(e), 1e-3 if e["route"] == "wgmma" else 2e-3)[1]))
    cache = str(tmp_path / "tuned.json")
    kw = dict(cache_path=cache, device="cpu", rounds=1)
    cfg = at.autotune(256, 256, 256, dtype="bfloat16", **kw)
    assert (cfg.block_m, cfg.block_n, cfg.block_k) == ENGINE_TILES["bfloat16"]
    assert at.autotune_batched(4, 256, 256, 256, **kw) == "wgmma"
    e = at.autotune_flash(2, 128, 128, 64, causal=True, **kw)
    assert e["route"] == "wgmma" and (e["block_q"], e["block_kv"]) == (128, 128)
    e = at.autotune_flash_bwd(2, 128, 128, 64, causal=True, **kw)
    assert e["route"] == e["bwd_route"] == "wgmma"
    e = at.autotune_quant(64, 256, 512, mode="int4", group_size=128, **kw)
    assert e["route"] == "wgmma" and tuple(e["plan"]) in dequant.dequant_engine_plans(
        64, 256, 512, 132)
    e = at.autotune_quant(256, 256, 512, mode="w8a8", **kw)
    assert e["route"] == "wgmma" and e["plan"] in dequant.W8A8_ENGINE_BN
    assert at.autotune_grouped(256, 128, 256, 4, **kw)["route"] == "wgmma"
    keys = sorted(json.loads(open(cache).read()))
    assert keys == sorted([
        "cpu/bfloat16/plus_times/256x256x256", "cpu/bfloat16/plus_times/4bx256x256x256",
        "cpu/flash/bfloat16/2x128x128x64/causal", "cpu/dequant4/bfloat16/64x256x512/g128",
        "cpu/w8a8/bfloat16/256x256x512/chan", "cpu/grouped/bfloat16/256x128x256x4"])


def test_derived_seed_priors_over_the_port_table(tmp_path):
    seed = {"h100/bfloat16/plus_times/8192x8192x8192": dict(ENGINE, gflops=700000.0),
            "h100/flash/bfloat16/32x1024x1024x128/causal": {"route": "wgmma", "gflops": 9e5}}
    out = at.derive_seed_priors(seed, "h100", ("cpu",))
    twin = out["cpu/bfloat16/plus_times/8192x8192x8192"]
    assert twin["derived"] and twin["route"] == "wgmma"
    assert twin["gflops"] == round(700000.0 * 2e11 / 989e12, 1)
    assert out["cpu/flash/bfloat16/32x1024x1024x128/causal"]["derived"]
    assert at.derive_seed_priors(seed) == seed  # no other card in the table
    path = tmp_path / "seed.json"
    write(path, dict(seed, **{"cpu/x/y/1x1x1": {"derived": True}}))
    assert at.refresh_derived_seeds(str(path)) == 0
    assert json.loads(path.read_text()) == seed


def test_packaged_seed_holds_card_measurements_only():
    seed = json.loads(open(at.SEED_CACHE).read())
    for key, e in seed.items():
        assert key.startswith("h100/") and not e.get("derived"), key
        assert "H100" in e["card"] and e["gflops"] > 0 and e["ms"] > 0, key
        assert e.get("route") in ("wgmma", "wmma", "mma.sync"), key


# ---- the front doors' hooks on the CPU --------------------------------------

def test_matmul_adopts_a_cached_dense_winner(caches, monkeypatch):
    user, _ = caches
    seen = []
    orig = mm._plus_times
    monkeypatch.setattr(mm, "_plus_times", lambda a, b, cfg, route=None: (
        seen.append(((cfg.block_m, cfg.block_n, cfg.block_k), route)), orig(a, b, cfg, route))[1])
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((256, 384), dtype=np.float32)).bfloat16()
    b = torch.from_numpy(rng.standard_normal((384, 512), dtype=np.float32)).bfloat16()
    a3, b3 = a.expand(4, -1, -1).contiguous(), b.expand(4, -1, -1).contiguous()
    # No cache file: today's config and the route rule.
    want, want_tn, want3 = (matmul(a, b), matmul(a.T.contiguous(), b, transpose_a=True),
                            matmul(a3, b3))
    assert seen == [(KERNEL_TILES["tc"], None)] * 3
    write(user, {"cpu/bfloat16/plus_times/256x512x512": WMMA,
                 "cpu/bfloat16/plus_times/256x512x512/tn": ENGINE,
                 "cpu/bfloat16/plus_times/4bx256x512x512": {"route": "wmma"}})
    assert torch.equal(matmul(a, b), want)
    assert seen[-1] == (KERNEL_TILES["tc"], "wmma")
    assert torch.equal(matmul(a.T.contiguous(), b, transpose_a=True), want_tn)
    assert seen[-1] == (ENGINE_TILES["bfloat16"], "wgmma")
    assert torch.equal(matmul(a3, b3), want3)
    assert seen[-1] == (KERNEL_TILES["tc"], "wmma")
    # An explicit config, an epilogue or another backend skip the lookup.
    matmul(a, b, config=GemmConfig(dtype="bfloat16", block_m=128, block_n=128, block_k=32))
    assert seen[-1] == (KERNEL_TILES["tc"], None)
    # The engine's tile as a config names the engine.
    matmul(a, b, config=GemmConfig(dtype="bfloat16", block_m=128, block_n=256, block_k=64))
    assert seen[-1] == (ENGINE_TILES["bfloat16"], "wgmma")


def test_flash_attention_adopts_cached_routes(caches, monkeypatch):
    user, _ = caches
    seen = []
    orig = flash.flash_mha_diff
    monkeypatch.setattr(flash, "flash_mha_diff", lambda *a, **kw: (
        seen.append((kw.get("route"), kw.get("bwd_route"))), orig(*a, **kw))[1])
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 128, 64, generator=gen) for _ in range(3))
    want = flash_attention(q, k, v, causal=True)
    assert seen[-1] == (None, None)
    write(user, {"cpu/flash/float32/2x128x128x64/causal": {"route": "simt",
                                                           "bwd_route": "simt"}})
    assert torch.equal(flash_attention(q, k, v, causal=True), want)
    assert seen[-1] == ("simt", "simt")
    flash_attention(q, k, v, causal=True, block_q=128, block_kv=128)
    assert seen[-1] == (None, None)
    # A tensor-core route for fp32 is one the rule cannot run: a miss.
    write(user, {"cpu/flash/float32/2x128x128x64/causal": {"route": "wgmma"}})
    flash_attention(q, k, v, causal=True)
    assert seen[-1] == (None, None)


def test_quantized_front_doors_adopt_route_and_plan_only(caches, monkeypatch):
    user, _ = caches
    seen = []
    for name in ("dequant_matmul", "w8a8_matmul"):
        orig = getattr(dequant, name)
        monkeypatch.setattr(dequant, name, lambda *a, _o=orig, **kw: (
            seen.append((kw["cfg"].block_k, kw.get("route"), kw.get("plan"))), _o(*a, **kw))[1])
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((64, 512), dtype=np.float32)).bfloat16()
    wq4, s4 = quant.quantize_weights(rng.standard_normal((512, 256)), 4, 128)
    wq8, s8 = quant.quantize_weights(rng.standard_normal((512, 256)), 8)
    want4 = quant.matmul_quantized(x, wq4, s4, bits=4, group_size=128)
    want8 = quant.matmul_w8a8(x, wq8, s8)
    base = seen[:]
    plan = list(dequant.dequant_engine_plans(64, 256, 512, 132)[1])
    write(user, {"cpu/dequant4/bfloat16/64x256x512/g128": {
                     "route": "wgmma", "plan": plan, "block_m": 64, "block_n": plan[0],
                     "block_k": 128},
                 "cpu/w8a8/bfloat16/64x256x512/chan": {
                     "route": "mma.sync", "block_m": 64, "block_n": 128, "block_k": 64}})
    assert torch.equal(quant.matmul_quantized(x, wq4, s4, bits=4, group_size=128), want4)
    assert torch.equal(quant.matmul_w8a8(x, wq8, s8), want8)
    # The semantic block_k is the front door's, whatever the entry holds.
    assert seen[-2:] == [(base[0][0], "wgmma", tuple(plan)), (base[1][0], "mma.sync", None)]
    assert base == [(base[0][0], None, None), (base[1][0], None, None)]


def test_grouped_matmul_adopts_a_cached_route(caches, monkeypatch):
    user, _ = caches
    seen = []
    orig = grouped_mod.grouped_mxu
    monkeypatch.setattr(grouped_mod, "grouped_mxu", lambda *a, **kw: (
        seen.append(kw.get("route")), orig(*a, **kw))[1])
    rng = np.random.default_rng(2)
    lhs = torch.from_numpy(rng.standard_normal((256, 128), dtype=np.float32)).bfloat16()
    rhs = torch.from_numpy(rng.standard_normal((4, 128, 256), dtype=np.float32)).bfloat16()
    sizes = torch.tensor([64, 64, 64, 64])
    want = grouped_matmul(lhs, rhs, sizes)
    write(user, {"cpu/grouped/bfloat16/256x128x256x4": {"route": "mma.sync", "block_m": 64,
                                                        "block_n": 128, "block_k": 32}})
    assert torch.equal(grouped_matmul(lhs, rhs, sizes), want)
    assert seen == [None, "mma.sync"]
    grouped_matmul(lhs, rhs, sizes, GemmConfig(dtype="bfloat16"))
    assert seen[-1] is None


def test_attention_and_unknown_chips_never_raise_on_a_lookup(caches, monkeypatch):
    user, _ = caches
    write(user, {"cpu/bfloat16/plus_times/8bx128x64x128": {"route": "wmma"}})
    q = torch.randn(8, 128, 64).bfloat16()
    assert attention(q, q, q).shape == (8, 128, 64)
    # Meta tensors (the refusal tests' stand-in for the card) have no chip.
    meta = torch.zeros((128, 128), device="meta", dtype=torch.bfloat16)
    assert at._chip_name(meta.device) is None
    write(user, {"h100/bfloat16/plus_times/128x128x128": ENGINE})
    assert at.cached_config(128, 128, 128, dtype="bfloat16", device="meta") is None
    monkeypatch.setattr(at, "_chip_name", lambda device=None: None)
    assert at.cached_config(128, 128, 128, dtype="bfloat16", device="cpu") is None
    assert at.cached_family_entry("grouped", (1, 1, 1, 1), dtype="bfloat16") is None
