"""The port's flash-attention model (``models/attn_model.py``) against the
JAX package's (``gemm_hls_tpu/models/attn_model.py``) on the CPU.

Both run on a JAX ``ChipSpec`` built from the port's H100 fields, and the
JAX module's softmax slot constants are set to the port's ``h100`` entry
(``monkeypatch``: no file is edited).  Where neither of the reference's
counting faults applies (a forward; a backward with one outer trip), every
leg equals the reference's to rel 1e-12; the Hopper law (the expected
runtime, the bound) is the port's own and is tested apart.  Where a fault
applies, the port's HBM leg and latch are pinned to the corrected closed
forms.  The reference's structural tests (``tests/test_attn_model.py``)
are ported, and the ``h100`` entry is held to the engine kernels' times
that ``PERF.md`` §6 records (NVIDIA H100 80GB HBM3, 700 W): within ±15%.
"""

import dataclasses
import math

import pytest

from gemm_hls_tpu.models import attn_model as jam
from gemm_hls_tpu.models import perf_model as jax_pm

from gemm_hls_tpu_torch.models import attn_model as am
from gemm_hls_tpu_torch.models.perf_model import H100

REL = 1e-12
H100_JAX = jax_pm.ChipSpec(**dataclasses.asdict(H100))
# A chip with a block-step cost, where the latch fault shows.
LATCHED = dataclasses.replace(H100, grid_step_overhead_s=1e-6)
FWD_LEGS = ("problem", "blocks", "grid", "causal", "window", "live_fraction", "flops",
            "mxu_s", "vpu_softmax_s", "hbm_s", "latch_s", "probability_bytes_saved")
BWD_LEGS = ("problem", "kernel", "contractions", "blocks", "causal", "live_fraction",
            "flops", "mxu_s", "vpu_recompute_s", "hbm_s")


@pytest.fixture
def jax_h100(monkeypatch):
    slots = am.ENGINE_CONSTANTS["h100"]["slots"]
    monkeypatch.setattr(jam, "K_SOFTMAX", slots["fwd"])
    monkeypatch.setattr(jam, "K_SOFTMAX_DQ", slots["dq"])
    monkeypatch.setattr(jam, "K_SOFTMAX_DKV", slots["dkv"])
    return H100_JAX


def _same(got, want, keys):
    assert set(got) == set(want)
    for key in keys:
        if isinstance(want[key], float):
            assert got[key] == pytest.approx(want[key], rel=REL), key
        else:
            assert got[key] == want[key], key


FWD_CASES = [
    ((32, 1024, 1024, 128), dict(block_q=128, block_kv=128)),
    ((8, 8192, 8192, 128), dict(block_q=128, block_kv=128)),
    ((32, 1024, 1024, 64), dict(block_q=512, block_kv=2048)),
    ((4, 1000, 1333, 128), dict(block_q=128, block_kv=128)),
    ((2, 300, 4096, 64), dict(block_q=256, block_kv=512, dtype="float16")),
]


@pytest.mark.parametrize("args,kw", FWD_CASES)
def test_forward_legs_equal_the_reference(jax_h100, args, kw):
    # Full mask: every block live, nothing to miscount.
    got = am.attention_specifications(*args, chip=H100, **kw)
    want = jam.attention_specifications(*args, chip=jax_h100, **kw)
    _same(got, want, FWD_LEGS)


@pytest.mark.parametrize("args,kw", FWD_CASES[:2])
def test_causal_forward_legs_equal_the_reference_without_a_latch(jax_h100, args, kw):
    # The H100's block step costs 0, so the latch fault does not show and
    # every leg matches, causal too.
    got = am.attention_specifications(*args, causal=True, chip=H100, **kw)
    want = jam.attention_specifications(*args, causal=True, chip=jax_h100, **kw)
    _same(got, want, FWD_LEGS)


@pytest.mark.parametrize("kernel,args,kw", [
    ("dq", (8, 1024, 2048, 128), dict(block_q=1024, block_kv=2048)),   # one q tile
    ("dq", (16, 512, 512, 64), dict(block_q=512, block_kv=64)),
    ("dkv", (8, 1024, 2048, 128), dict(block_q=512, block_kv=2048)),   # one kv tile
    ("dkv", (16, 4096, 512, 64), dict(block_q=64, block_kv=512)),
])
def test_backward_legs_equal_the_reference_with_one_outer_trip(jax_h100, kernel, args, kw):
    got = am.attention_bwd_specifications(*args, kernel=kernel, chip=H100, **kw)
    want = jam.attention_bwd_specifications(*args, kernel=kernel, chip=jax_h100, **kw)
    _same(got, want, BWD_LEGS + ("latch_s",))


@pytest.mark.parametrize("causal", [False, True])
def test_backward_hbm_counts_inner_reads_once_per_outer_trip(jax_h100, causal):
    b, s_q, s_kv, d, in_b = 8, 4096, 4096, 128, 2
    q_side = 2 * b * s_q * d * in_b + 2 * b * s_q * 4      # q, dO; lse, delta
    kv_side = 2 * b * s_kv * d * in_b                       # k, v
    dq = am.attention_bwd_specifications(b, s_q, s_kv, d, kernel="dq", causal=causal,
                                         block_q=256, block_kv=512, chip=H100)
    n_q = s_q // 256
    want = q_side + n_q * dq["live_fraction"] * kv_side + b * s_q * d * in_b
    assert dq["hbm_s"] == pytest.approx(want / H100.hbm_bandwidth, rel=REL)
    dkv = am.attention_bwd_specifications(b, s_q, s_kv, d, kernel="dkv", causal=causal,
                                          block_q=256, block_kv=512, chip=H100)
    n_kv = s_kv // 512
    want = kv_side + n_kv * dkv["live_fraction"] * q_side + 2 * b * s_kv * d * in_b
    assert dkv["hbm_s"] == pytest.approx(want / H100.hbm_bandwidth, rel=REL)
    if not causal:  # every trip whole: n_q and n_kv times
        ref = jam.attention_bwd_specifications(b, s_q, s_kv, d, kernel="dq", block_q=256,
                                               block_kv=512, chip=jax_h100)
        extra = (n_q - 1) * kv_side / H100.hbm_bandwidth
        assert dq["hbm_s"] == pytest.approx(ref["hbm_s"] + extra, rel=REL)


def test_causal_latch_counts_live_blocks_only():
    b, s, d = 4, 4096, 128
    spec = am.attention_specifications(b, s, s, d, causal=True, block_q=512, block_kv=512,
                                       chip=LATCHED)
    n = s // 512
    live = n * (n + 1) // 2
    assert spec["latch_s"] == pytest.approx(b * live * 1e-6, rel=REL)
    # The reference's forward charges every block, dead ones too.
    ref = jam.attention_specifications(b, s, s, d, causal=True, block_q=512, block_kv=512,
                                       chip=jax_pm.ChipSpec(**dataclasses.asdict(LATCHED)))
    assert ref["latch_s"] == pytest.approx(b * n * n * 1e-6, rel=REL)
    bwd = am.attention_bwd_specifications(b, s, s, d, kernel="dq", causal=True,
                                          block_q=512, block_kv=512, chip=LATCHED)
    assert bwd["latch_s"] == pytest.approx(spec["latch_s"], rel=REL)


# ---- the reference's structural tests (tests/test_attn_model.py) -----------

def test_bwd_contraction_convention():
    dq = am.attention_bwd_specifications(8, 1024, 1024, 128, kernel="dq", chip=H100)
    dkv = am.attention_bwd_specifications(8, 1024, 1024, 128, kernel="dkv", chip=H100)
    assert dq["contractions"] == 3 and dkv["contractions"] == 4
    assert dkv["flops"] / dq["flops"] == pytest.approx(4 / 3)
    with pytest.raises(ValueError):
        am.attention_bwd_specifications(8, 1024, 1024, 128, kernel="dx", chip=H100)


def test_bwd_causal_tri_grid_skips_latch_and_mxu():
    kw = dict(kernel="dkv", block_q=512, block_kv=512, chip=LATCHED)
    full = am.attention_bwd_specifications(8, 4096, 4096, 128, **kw)
    caus = am.attention_bwd_specifications(8, 4096, 4096, 128, causal=True, **kw)
    assert 0.5 <= caus["live_fraction"] < 0.57
    assert caus["latch_s"] == pytest.approx(full["latch_s"] * caus["live_fraction"])
    assert caus["mxu_s"] == pytest.approx(full["mxu_s"] * caus["live_fraction"])


def test_causal_halves_mxu_leg_at_fine_blocks():
    full = am.attention_specifications(4, 4096, 4096, 128, block_q=128, block_kv=128,
                                       chip=H100)
    caus = am.attention_specifications(4, 4096, 4096, 128, causal=True, block_q=128,
                                       block_kv=128, chip=H100)
    assert 0.5 <= caus["live_fraction"] < 0.55
    assert caus["mxu_s"] < 0.55 * full["mxu_s"]


def test_causal_time_is_the_longest_item_within_one_round():
    # 4 heads of 4096 rows: 128 items, one round, so causal masking leaves
    # the runtime to the longest (unmasked) item; at 8 heads, two rounds
    # pair long items with short ones and causal takes about half.
    kw = dict(block_q=128, block_kv=128, chip=H100)
    for heads, lo, hi in ((4, 0.95, 1.0), (8, 0.45, 0.6)):
        full = am.attention_specifications(heads, 4096, 4096, 128, **kw)
        caus = am.attention_specifications(heads, 4096, 4096, 128, causal=True, **kw)
        ratio = caus["expected_runtime_s"] / full["expected_runtime_s"]
        assert lo <= ratio <= hi, (heads, ratio)


def test_window_reduces_live_fraction_further():
    caus = am.attention_specifications(1, 8192, 8192, 128, causal=True, block_q=256,
                                       block_kv=256, chip=H100)
    win = am.attention_specifications(1, 8192, 8192, 128, causal=True, window=1024,
                                      block_q=256, block_kv=256, chip=H100)
    assert win["live_fraction"] < 0.3 * caus["live_fraction"] + 0.05


def test_decode_is_memory_bound():
    spec = am.attention_specifications(32, 1, 2048, 128, block_q=8, block_kv=512, chip=H100)
    assert spec["bound"] == "memory"
    assert spec["hbm_s"] > 10 * spec["mxu_s"]


def test_flash_saves_the_probability_traffic():
    spec = am.attention_specifications(32, 1024, 1024, 128, chip=H100)
    assert spec["probability_bytes_saved"] == 2 * 32 * 1024 * 1024 * 2


# ---- the Hopper law ---------------------------------------------------------

def test_default_blocks_are_the_engine_tiles():
    assert am.attention_specifications(32, 1024, 1024, 128, chip=H100)["blocks"] == (128, 128)
    assert am.attention_bwd_specifications(
        32, 1024, 1024, 128, kernel="dq", chip=H100)["blocks"] == (128, 64)
    # dk / dv: 128 kv rows, or 64 where 128-row items fill at most a round.
    assert am.attention_bwd_specifications(
        32, 1024, 1024, 128, kernel="dkv", chip=H100)["blocks"] == (64, 128)
    assert am.attention_bwd_specifications(
        16, 1024, 1024, 128, kernel="dkv", chip=H100)["blocks"] == (64, 64)


def test_rounds_alternate_direction():
    blocks = am._rounds(10, 4)
    assert blocks == [[0, 7, 8], [1, 6, 9], [2, 5], [3, 4]]
    assert sorted(i for blk in blocks for i in blk) == list(range(10))


def test_waves_step_the_runtime():
    # 16 heads of 1024 rows: 128 items, one round; 17 heads: 136 items, two.
    one = am.predict_s("fwd", 16, 1024, 128, False, chip=H100)
    two = am.predict_s("fwd", 17, 1024, 128, False, chip=H100)
    assert two > 1.6 * one
    assert am.predict_s("fwd", 4, 1024, 128, False, chip=H100) == pytest.approx(one)


def test_no_v5e_constant_is_carried():
    assert set(am.ENGINE_CONSTANTS) == {"h100"}
    for name in ("K_SOFTMAX", "K_SOFTMAX_DQ", "K_SOFTMAX_DKV"):
        assert not hasattr(am, name)
    slots = am.ENGINE_CONSTANTS["h100"]["slots"]
    assert (slots["fwd"], slots["dq"], slots["dkv"]) != (jam.K_SOFTMAX, jam.K_SOFTMAX_DQ,
                                                         jam.K_SOFTMAX_DKV)


# The engine kernels' device times PERF.md §6 records (chip_smoke.py phase
# 15; NVIDIA H100 80GB HBM3, 700 W), ms: (kernel, heads, S, D, causal).
PERF_ANCHORS = [
    (("fwd", 32, 1024, 128, True), 0.0296),     # B6
    (("fwd", 32, 1024, 128, False), 0.0411),
    (("fwd", 8, 8192, 128, True), 0.2664),
    (("dq", 32, 1024, 128, True), 0.0367),      # B9
    (("dq", 32, 1024, 128, False), 0.0611),
    (("dkv", 32, 1024, 128, True), 0.0501),     # B10
    (("dkv", 32, 1024, 128, False), 0.0796),
]


@pytest.mark.parametrize("case,ms", PERF_ANCHORS, ids=lambda x: str(x))
def test_h100_entry_meets_the_recorded_times(case, ms):
    kernel, heads, s, d, causal = case
    ratio = am.predict_s(kernel, heads, s, d, causal, chip=H100) * 1e3 / ms
    assert 0.85 < ratio < 1.15, ratio


def test_fit_recovers_the_constants_it_was_given():
    # Readings the law itself predicts with the h100 entry: the fit finds
    # the entry again.
    shapes = [(b, s, d, c) for b, s in ((4, 1024), (32, 1024), (33, 1024), (8, 4096),
                                        (128, 256), (16, 2048))
              for d in (64, 128) for c in (False, True)]
    readings = [(k, b, s, d, c, am.predict_s(k, b, s, d, c, chip=H100))
                for k in ("fwd", "dq", "dkv") for b, s, d, c in shapes]
    fit = am.fit_constants(readings, H100)
    want = am.ENGINE_CONSTANTS["h100"]
    for k in ("fwd", "dq", "dkv"):
        assert fit["slots"][k] == pytest.approx(want["slots"][k], rel=0.02), k
        assert fit["overlap"][k] == pytest.approx(want["overlap"][k], abs=0.02), k
    assert fit["launch_s"] == pytest.approx(want["launch_s"], rel=0.05)
    assert "_fit" not in am.ENGINE_CONSTANTS
    assert math.isfinite(fit["launch_s"])
