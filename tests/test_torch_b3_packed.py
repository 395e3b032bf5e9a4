"""Kernel B3's packed route (``csrc/packed_gemm.cuh``, ``ops/vpu.py::b3_route``):
its premise, its rule, and the port's 16-bit order-semiring results
against the JAX package's.

The premise: the reference widens float16 / bfloat16 operands to fp32,
folds in fp32 and rounds to the input type at the store
(``gemm_hls_tpu/ops/pallas_vpu.py:74-75, 113``); the packed tile folds in
the 16-bit type.  The two agree bit for bit where every sum or product of
two 16-bit values, rounded to fp32 and then to the type, is the exact one
rounded once (min and max commute with the monotone rounding).  Checked
here against exact arithmetic: float16 sums and products and bfloat16 sums
are exact in float64 (a bfloat16 sum is rounded there where its exponents
lie far apart, and float64's 53 bits keep that innocuous for bfloat16's 8
and fp32's 24), numpy's float64 -> float16 and -> float32 conversions
round to nearest even, and ``_rne_bf16`` does for bfloat16.  Every a of
the 65,536 patterns meets a structured set of b (every exponent with
mantissas at its edges and middle, both signs: +-0, subnormals, +-inf,
NaN, the largest finite values and those that take them past it); the
bfloat16 products, exact in fp32 but below its normal range, are checked
for every significand product at every exponent there.  The card checks
the instructions themselves over all 2^32 pairs (``chip_smoke.py`` phase
36b) and the tile against the scalar one (36, ``tests/test_torch_kernels.py``).

Against the JAX package: exact, NaN at the same places, zeros compared by
value (``np.testing.assert_array_equal``; the reference and torch may
order -0 and +0 apart).  The JAX side runs its Pallas kernel in interpret
mode, as ``tests/test_vpu_semiring.py`` does; the port's side on the CPU
runs B3's plain version, and the packed route's arithmetic is emulated in
the 16-bit type (``_fold16``) and held to the same.  XLA on the CPU
flushes fp32 subnormals (inputs read as zero, results written as zero:
ROADMAP C, "a subnormal facing an infinity"), which float16 values never
are and bfloat16 ones below 2^-126 are: there the port keeps IEEE
arithmetic, as its scalar tile and plain version always have, and
``test_bfloat16_subnormals_keep_ieee_where_the_reference_flushes`` holds
the port to IEEE's result and the reference to the flushed one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gemm_hls_tpu import GemmConfig as JaxConfig
from gemm_hls_tpu import matmul as jax_matmul
from gemm_hls_tpu_torch import Semiring, matmul
from gemm_hls_tpu_torch.models.perf_model import B3_TERMS, H100, b3_class
from gemm_hls_tpu_torch.ops import vpu
from gemm_hls_tpu_torch.ops.semiring import get_semiring

torch.set_num_threads(1)

JCFG = JaxConfig(block_m=16, block_n=128, block_k=64, interpret=True)
PACKED = ["min_plus", "max_plus", "max_min", "min_max", "max_times"]
SUMS = ["plus_times", "plus_absdiff", "plus_sqdiff", "log_plus"]
B3_DTYPES = [torch.float16, torch.bfloat16, torch.float32, torch.float64, torch.int8,
             torch.int16, torch.int32, torch.int64, torch.uint8, torch.uint16, torch.uint32]
LAYOUTS = [(False, False), (True, False), (False, True), (True, True)]


# ---- the premise -------------------------------------------------------------

def _all16():
    return np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)


def _structured(mant_bits, exp_bits, mants):
    """Every exponent field, each with the mantissas ``mants`` (their
    edges and middle), both signs: +-0, subnormals, normals, +-inf, NaN."""
    e = np.arange(1 << exp_bits, dtype=np.uint32)[:, None]
    m = np.asarray(mants, dtype=np.uint32)[None, :]
    mag = ((e << mant_bits) | m).reshape(-1)
    return np.concatenate([mag, mag | (1 << (mant_bits + exp_bits))]).astype(np.uint16)


def _f16(bits):
    return bits.view(np.float16).astype(np.float64)


def _bf16(bits):
    return (bits.astype(np.uint32) << 16).view(np.float32).astype(np.float64)


def _rne_bf16(x):
    """float64 -> the nearest bfloat16 value (ties to even), as float64:
    8 significant bits down to 2^-126, a quantum of 2^-133 below it, +-inf
    from 2^128 on (the rounded magnitude), NaN kept."""
    x = np.asarray(x, dtype=np.float64)
    with np.errstate(invalid="ignore", over="ignore"):
        _, e = np.frexp(x)
        q = np.maximum(e - 8, -133)
        r = np.ldexp(np.rint(np.ldexp(x, -q)), q)
        r = np.where(np.isfinite(x), r, x)
        return np.where(np.abs(r) >= 2.0 ** 128, np.copysign(np.inf, x), r)


def _same(once, twice):
    """Equal values (the same bits for these types: -0 and +0 apart), or
    both NaN."""
    both_nan = np.isnan(once) & np.isnan(twice)
    same = (once == twice) & (np.signbit(once) == np.signbit(twice))
    return bool(np.all(same | both_nan))


@pytest.mark.parametrize("op", ["add", "mul"])
def test_float16_terms_round_once_through_fp32(op):
    a = _f16(_all16())[:, None]
    b = _f16(_structured(10, 5, [0, 1, 2, 0x155, 0x200, 0x3fe, 0x3ff]))
    assert 16.0 in b and 65504.0 in a  # 65504 + 16 = 65520: a tie that rounds to inf
    fn = np.add if op == "add" else np.multiply
    for j in range(0, b.size, 64):
        with np.errstate(invalid="ignore", over="ignore"):
            exact = fn(a, b[None, j:j + 64])  # exact in float64
            once = exact.astype(np.float16).astype(np.float64)
            twice = exact.astype(np.float32).astype(np.float16).astype(np.float64)
        assert _same(once, twice), f"float16 {op}"


def test_bfloat16_sums_round_once_through_fp32():
    a = _bf16(_all16())[:, None]
    b = _bf16(_structured(7, 8, [0, 1, 0x40, 0x7f]))
    for j in range(0, b.size, 64):
        with np.errstate(invalid="ignore", over="ignore"):
            s = a + b[None, j:j + 64]
            once = _rne_bf16(s)
            twice = _rne_bf16(s.astype(np.float32).astype(np.float64))
        assert _same(once, twice)


def test_bfloat16_products_round_once_through_fp32():
    # A bfloat16 significand has at most 8 bits, so a product's has at most
    # 16: exact in fp32 wherever fp32 is normal (and past its largest value
    # both roundings give inf).  Below 2^-126 fp32 rounds it to a multiple
    # of 2^-149: every significand product, at every exponent from where it
    # rounds to 0 up to past fp32's largest value.
    sig = np.arange(1, 256, dtype=np.int64)
    prods = np.unique(sig[:, None] * sig[None, :]).astype(np.float64)
    for e in range(-170, 129):
        p = np.ldexp(prods, e)
        with np.errstate(over="ignore"):
            once = _rne_bf16(p)
            twice = _rne_bf16(p.astype(np.float32).astype(np.float64))
        assert _same(once, twice), f"2^{e}"


def test_rne_bf16_matches_torch():
    # The helper against torch's own float32 -> bfloat16 rounding.
    x = np.random.default_rng(27).standard_normal(20000).astype(np.float32)
    x = np.concatenate([x * 1e-38, x, x * 3e38, [np.inf, -np.inf, np.nan, 0.0, -0.0],
                        np.float32(2.0 ** -133) * np.arange(1, 64, dtype=np.float32)])
    want = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    assert _same(_rne_bf16(x.astype(np.float64)), want)


# ---- the rule ------------------------------------------------------------------

@pytest.mark.parametrize("semiring", PACKED + SUMS)
@pytest.mark.parametrize("dtype", B3_DTYPES, ids=str)
def test_b3_route(dtype, semiring):
    for out in {dtype, torch.float32, torch.float16, torch.bfloat16, torch.float64}:
        want = ("packed" if dtype in (torch.float16, torch.bfloat16) and out == dtype
                and semiring in PACKED else "simt")
        assert vpu.b3_route(dtype, semiring, out) == want
        assert vpu.b3_route(dtype, get_semiring(semiring), out) == want


def test_b3_route_of_a_user_semiring_is_the_scalar_tile():
    user = Semiring("user_min_plus", torch.add, torch.minimum, float("inf"), np.add,
                    np.minimum)
    assert vpu.b3_route(torch.float16, user, torch.float16) == "simt"
    assert vpu.b3_route(torch.float16, "min_plus", torch.float16) == "packed"


def test_packed_cases_cover_every_type_and_semiring():
    pairs = {(c[0], c[1]) for c in chip_smoke.B3_PACKED_CASES}
    assert pairs == {(dt, sr) for dt in ("float16", "bfloat16") for sr in PACKED}
    for case in chip_smoke.B3_PACKED_CASES:
        dtype = getattr(torch, case[0])
        assert vpu.b3_route(dtype, case[1], dtype) == "packed"
    layouts = {(c[2], c[3], c[6] % 8 == 0) for c in chip_smoke.B3_PACKED_CASES}
    assert layouts >= {(ta, tb, al) for ta, tb in LAYOUTS for al in (False, True)}


# ---- the bound -----------------------------------------------------------------

@pytest.mark.parametrize("semiring", PACKED)
@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_packed_bound_is_half_the_scalar_tiles_issue(dtype, semiring):
    # Two terms a pair: a map and a reduce on pairs issue one instruction a
    # term, half the scalar tile's two; max_min / min_max two HMNMX2 a pair
    # on the 64-lane pipe.
    assert b3_class(dtype, semiring, dtype) == "packed"
    assert b3_class(dtype, semiring, "float32") == "fp32"
    packed, scalar = H100.vpu_ops_for(dtype, semiring), H100.vpu_ops_for(dtype, semiring,
                                                                         "float32")
    if semiring in ("max_min", "min_max"):
        assert packed == H100.vpu_ops and scalar == H100.vpu_ops / 2
    else:
        assert packed == 2 * H100.vpu_ops and scalar == H100.vpu_ops
    assert H100.bound(2.0 * 4096 ** 3, packed, 3 * 4096 ** 2 * 2)[1] == "operations"


def test_every_class_counts_every_semiring_it_runs():
    for cls, terms in B3_TERMS.items():
        assert "min_plus" in terms, cls
    for sr in PACKED + SUMS:
        assert sr in B3_TERMS["fp32"]
    assert set(B3_TERMS["packed"]) == set(PACKED)


# ---- against the JAX package -------------------------------------------------------

# Magnitudes an operand sprinkles in: +-0, the least magnitudes, the
# largest finite values, values whose sums and products pass them (to inf)
# or fall among float16's subnormals, +-inf; NaN sparsely (one in a row or
# column NaNs the output's whole row or column).  bfloat16's least here are
# fp32 normals whose products underflow past fp32's subnormals to zero
# (its subnormals: test_bfloat16_subnormals_keep_ieee_where_the_reference_flushes).
SPECIALS = {
    "float16": [0.0, -0.0, 2.0 ** -24, -(2.0 ** -24), 6e-8, 2.0 ** -14, 65504.0, -65504.0,
                16.0, 300.0, 1e-4, np.inf, -np.inf],
    "bfloat16": [0.0, -0.0, 2.0 ** -100, -(2.0 ** -100), 1e-30, 3.3895313892515355e38,
                 -3.3895313892515355e38, 1e38, 300.0, np.inf, -np.inf],
}


def _draw(rng, shape, dtype):
    """float32 values exact in ``dtype``: U(-2, 2) with SPECIALS on 15% of
    the elements and NaN on 0.5%."""
    x = rng.uniform(-2, 2, shape)
    pick = rng.random(shape)
    sp = np.asarray(SPECIALS[dtype])[rng.integers(0, len(SPECIALS[dtype]), shape)]
    x = np.where(pick < 0.15, sp, x)
    x = np.where(pick > 0.995, np.nan, x)
    t = torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dtype))
    return t.float().numpy()


def _port(a, b, semiring, dtype, **kw):
    dt = getattr(torch, dtype)
    got = matmul(torch.from_numpy(a).to(dt), torch.from_numpy(b).to(dt), semiring=semiring, **kw)
    assert got.dtype == dt
    return got.float().numpy()


def _jax(a, b, semiring, dtype, **kw):
    cfg = JCFG.replace(dtype=dtype, semiring=semiring)
    jd = getattr(jnp, dtype)
    out = jax_matmul(jnp.asarray(a).astype(jd), jnp.asarray(b).astype(jd), semiring=semiring,
                     config=cfg, **kw)
    assert out.dtype == jd
    return np.asarray(out.astype(jnp.float32))


def _fold16(a, b, semiring, dtype, ta=False, tb=False):
    """The packed route's arithmetic on the CPU: each term's map in the
    16-bit type (torch rounds the fp32 result once to it: the correctly
    rounded 16-bit op, by the premise above), the reduce by min / max in
    it."""
    dt = getattr(torch, dtype)
    x, y = torch.from_numpy(a).to(dt), torch.from_numpy(b).to(dt)
    x = x.transpose(-1, -2) if ta else x
    y = y.transpose(-1, -2) if tb else y
    sr = get_semiring(semiring)
    mapped = sr.map_op(x[..., :, :, None], y[..., None, :, :])
    assert mapped.dtype == dt
    return sr.reduce_along(mapped, -2).float().numpy()


@pytest.mark.parametrize("ta,tb", LAYOUTS)
@pytest.mark.parametrize("semiring", PACKED)
@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_2d_matches_jax(dtype, semiring, ta, tb):
    rng = np.random.default_rng(27)
    m, n, k = 37, 29, 45
    a = _draw(rng, (k, m) if ta else (m, k), dtype)
    b = _draw(rng, (n, k) if tb else (k, n), dtype)
    kw = dict(transpose_a=ta, transpose_b=tb)
    want = _jax(a, b, semiring, dtype, **kw)
    np.testing.assert_array_equal(_port(a, b, semiring, dtype, **kw), want)
    np.testing.assert_array_equal(_fold16(a, b, semiring, dtype, ta, tb), want)


@pytest.mark.parametrize("semiring", PACKED)
@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_batched_matches_jax(dtype, semiring):
    rng = np.random.default_rng(28)
    a, b = _draw(rng, (3, 19, 33), dtype), _draw(rng, (3, 33, 21), dtype)
    want = _jax(a, b, semiring, dtype)
    np.testing.assert_array_equal(_port(a, b, semiring, dtype), want)
    np.testing.assert_array_equal(_fold16(a, b, semiring, dtype), want)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_sums_and_products_past_the_largest_value_match_jax(dtype):
    # Rows of the largest finite value against columns that take it past
    # (sums to +-inf), products that overflow and products among the
    # subnormals, where the packed and fp32 roundings would part if the
    # premise failed.
    big = 65504.0 if dtype == "float16" else 3.3895313892515355e38
    tiny = 2.0 ** -12 if dtype == "float16" else 2.0 ** -100
    a = np.array([[big, -big, tiny, 300.0], [big, big, -tiny, 2.0]], np.float32)
    b = np.array([[16.0, -16.0], [big, 0.5], [tiny, tiny], [300.0, -0.0]], np.float32)
    a = torch.from_numpy(a).to(getattr(torch, dtype)).float().numpy()
    b = torch.from_numpy(b).to(getattr(torch, dtype)).float().numpy()
    for semiring in PACKED:
        want = _jax(a, b, semiring, dtype)
        np.testing.assert_array_equal(_port(a, b, semiring, dtype), want)
        np.testing.assert_array_equal(_fold16(a, b, semiring, dtype), want)


def _terms_oracle(a, b, semiring, flush):
    """C over float64 bfloat16 values a (M, K), b (K, N): each term exact,
    rounded to fp32 then to bfloat16 (``flush``: as XLA on the CPU runs
    it, fp32 subnormal inputs and terms read as zero), the min / max fold
    NaN-keeping."""
    tiny = 2.0 ** -126

    def ftz(x):
        return np.where(np.abs(x) < tiny, np.copysign(0.0, x), x) if flush else x
    x, y = ftz(a)[:, :, None], ftz(b)[None, :, :]
    with np.errstate(invalid="ignore", over="ignore"):
        mapped = {"min_plus": np.add, "max_plus": np.add, "max_times": np.multiply,
                  "max_min": np.minimum, "min_max": np.maximum}[semiring](x, y)
        term = _rne_bf16(ftz(mapped.astype(np.float32).astype(np.float64)))
    fold = np.minimum if semiring in ("min_plus", "min_max") else np.maximum
    return fold.reduce(term, axis=1)


@pytest.mark.parametrize("semiring", PACKED)
def test_bfloat16_subnormals_keep_ieee_where_the_reference_flushes(semiring):
    # bfloat16 subnormals (fp32 subnormals when widened) and terms that land
    # among fp32's subnormals: the port (its plain version and the packed
    # arithmetic) gives IEEE's result, the reference XLA's flushed one.
    rng = np.random.default_rng(29)
    vals = np.array([2.0 ** -133, -(2.0 ** -133), 1e-39, 2.0 ** -126, 3e-20, -1e-20, 0.5,
                     np.inf, -np.inf, 0.0])
    a = vals[rng.integers(0, vals.size, (9, 11))]
    b = vals[rng.integers(0, vals.size, (11, 7))]
    # C[0, 0] reads subnormals alone (sums, min and max of them are
    # subnormal), C[1, 1] products of 3e-20 (subnormal in fp32).
    a[0], b[:, 0], a[1], b[:, 1] = 2.0 ** -133, 2.0 ** -130, 3e-20, 3e-20
    a = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float().numpy()
    b = torch.from_numpy(b.astype(np.float32)).to(torch.bfloat16).float().numpy()
    ieee = _terms_oracle(a.astype(np.float64), b.astype(np.float64), semiring, False)
    flushed = _terms_oracle(a.astype(np.float64), b.astype(np.float64), semiring, True)
    assert not np.array_equal(ieee, flushed, equal_nan=True)  # the case shows
    np.testing.assert_array_equal(_port(a, b, semiring, "bfloat16"), ieee)
    np.testing.assert_array_equal(_fold16(a, b, semiring, "bfloat16"), ieee)
    np.testing.assert_array_equal(_jax(a, b, semiring, "bfloat16"), flushed)


# ---- the measurement tool ------------------------------------------------------

def _enum(source, name, end):
    import re
    from gemm_hls_tpu_torch import _build
    text = (_build.CSRC_DIR / source).read_text()
    body = text[text.index(f"enum {name}"):]
    body = body[:body.index(end)]
    return re.findall(r"\bk(\w+)", re.sub(r"//[^\n]*", "", body))


def test_b3_ab_tables_match_the_probe_and_the_library():
    from gemm_hls_tpu_torch.tools import b3_ab
    seqs = _enum("b3_probe.cu", "Seq", "kSeqs")
    assert len(seqs) == len(b3_ab.SEQUENCES)
    for enum_name, (name, what, per_step, _) in zip(seqs, b3_ab.SEQUENCES):
        assert what == ("terms" if enum_name.startswith("Term") else "results")
        assert per_step == (2 if enum_name in ("Hadd2", "Hmul2", "Hmnmx2", "Badd2", "Bmul2",
                                               "Bmnmx2", "TermI32MaxMin3")
                            or enum_name.startswith(("TermF16", "TermBF16")) else 1), name
    import re
    from gemm_hls_tpu_torch import _build
    probe = (_build.CSRC_DIR / "b3_probe.cu").read_text()
    consts = dict(re.findall(r"kRate(\w+) = (\d+)", probe))
    assert (b3_ab._RATE_THREADS, b3_ab._RATE_CHAINS, b3_ab._RATE_UNROLL) == (
        int(consts["Threads"]), int(consts["Chains"]), int(consts["Unroll"]))
    ops = _enum("b3_probe.cu", "PairOp", "};")
    assert [op.lower().removeprefix("pair") for op in ops] == ["add", "mul", "min", "max"]
    assert {op for _, op, _ in b3_ab.PAIR_OPS} == {"add", "mul", "min", "max"}
    for sr, code in b3_ab.OPS.items():
        assert get_semiring(sr).op_code == code
    for dt, code in b3_ab.CODES.items():
        assert _build.dtype_code(getattr(torch, dt), True) == code


def test_b3_ab_needs_the_card(capsys, tmp_path):
    from gemm_hls_tpu_torch.tools import b3_ab
    assert b3_ab.main([str(tmp_path)]) == 2
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_cpu_calls_run_the_plain_version_and_count_no_launch(dtype):
    # A CPU tensor runs B3's plain version, whatever b3_route gives on the
    # card: no launch, no route counted.
    before = (vpu.vpu_matmul.launches, dict(vpu.vpu_matmul.route_launches))
    a = torch.ones((4, 5), dtype=getattr(torch, dtype))
    got = matmul(a, a.T.contiguous(), semiring="min_plus")
    assert got.dtype == getattr(torch, dtype) and bool((got == 2).all())
    assert (vpu.vpu_matmul.launches, dict(vpu.vpu_matmul.route_launches)) == before
