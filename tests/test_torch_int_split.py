"""B1 / B2's integers on the tile engine as byte planes (int16, uint8,
uint16, uint32, int32 plus_times), the port against the JAX package on the
CPU.

The engine cuts each operand into byte planes (``ops/mxu.py::
int_split_operand``, ``csrc/int_split.cu``) and sums the products of every
plane pair (i, j) with i + j <= 3 on the int8 tensor cores, diagonal by
diagonal, its one int32 accumulator shifted 8 bits between diagonals
(``csrc/mxu_wgmma_int.cu``).  Here, with no card:

* the split's plain version (``int_split_operand_plain``), put back
  together, is the operand modulo 2^32 (2^16 for the 16-bit types; int16's
  high plane read signed), in the four layouts, batched and with a
  broadcast batch;
* the plain walk of byte-plane products (``int_planes_matmul_plain``)
  equals ``gemm_hls_tpu.matmul`` (in interpret mode, as ``tests/conftest.py``
  runs it) bit for bit, and the port's own plain version, for every type
  over its whole range: sums that wrap past 2^31, ragged K, batched and
  broadcast operands, an epilogue into fp32 and each type's own output;
* the route rule, ``perf_model.int_split_bound`` and the card tables'
  routes.

The kernels are held to these plain versions on the card by
``tests/test_torch_kernels.py`` and ``chip_smoke.py``'s phase 35.
Tolerance: exact everywhere (the epilogue's fp32 sum is one rounding of
the same exact int32 value on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gemm_hls_tpu import GemmConfig as JaxConfig
from gemm_hls_tpu import matmul as jax_matmul
from gemm_hls_tpu_torch import matmul
from gemm_hls_tpu_torch.config import (
    ENGINE_TILES, INT_PLANES, call_route, default_config, int_split_bytes, pack_bytes,
    packed_operands,
)
from gemm_hls_tpu_torch.models.perf_model import (
    H100, int_gemm_bound, int_split_bound, slice_passes,
)
from gemm_hls_tpu_torch.ops import mxu

torch.set_num_threads(1)

TYPES = ["int16", "uint8", "uint16", "uint32", "int32"]
SPLIT = ["int16", "uint16", "uint32", "int32"]
JCFG = JaxConfig(block_m=16, block_n=128, block_k=64, interpret=True)


def _draw(rng, shape, dtype, top=False):
    """Integers over the type's whole range (``top``: its largest value)."""
    info = np.iinfo(dtype)
    if top:
        return np.full(shape, info.max, dtype=dtype)
    return rng.integers(int(info.min), int(info.max), shape, endpoint=True).astype(dtype)


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _jax(a, b, block_k=64, **kw):
    cfg = JCFG.replace(dtype=str(a.dtype), block_k=block_k)
    return np.asarray(jax_matmul(jnp.asarray(a), jnp.asarray(b), config=cfg, **kw))


# ---- the split ----------------------------------------------------------------

def _value(planes, dtype):
    """sum_i plane_i 2^(8 i) of a split workspace's planes (uint8), int16's
    high plane read as a signed byte, as int64."""
    total = 0
    for i, p in enumerate(planes):
        v = p.to(torch.int64)
        if dtype == torch.int16 and i == 1:
            v = v - ((v >> 7) << 8)
        total = total + (v << (8 * i))
    return total


@pytest.mark.parametrize("dtype", SPLIT)
@pytest.mark.parametrize("ta,tb", chip_smoke.LAYOUTS)
@pytest.mark.parametrize("lead", [(), (3,), "broadcast"])
def test_split_planes_put_back_together_are_the_operand(dtype, ta, tb, lead):
    rng = np.random.default_rng(2601)
    dt = getattr(torch, dtype)
    m, n, k = 7, 5, 131
    bcast = lead == "broadcast"
    lead = (3,) if bcast else lead
    a = torch.from_numpy(_draw(rng, (*lead, *((k, m) if ta else (m, k))), dtype))
    b = torch.from_numpy(_draw(rng, (*lead, *((n, k) if tb else (k, n))), dtype))
    if bcast:  # one example read for every batch entry: a stride of 0
        a = a[:1].expand(3, *a.shape[1:])
    for x, mn_major, rows in ((a, ta, m), (b, not tb, n)):
        w = mxu.int_split_operand_plain(x, mn_major)
        planes = INT_PLANES[dtype]
        kp = w.shape[-1] // planes
        assert w.dtype == torch.uint8 and kp % 128 == 0 and kp >= k
        assert w.shape[:-1] == ((rows,) if (not lead or bcast and x is a) else (3, rows))
        assert not w[..., k:kp].any() and all(not w[..., i * kp + k:(i + 1) * kp].any()
                                              for i in range(planes))
        got = _value([w[..., i * kp:i * kp + k] for i in range(planes)], dt)
        xr = (x[0] if w.ndim == 2 and x.ndim == 3 else x)
        xr = xr.transpose(-1, -2) if mn_major else xr
        want = xr.to(torch.int64)
        bits = 8 * dt.itemsize
        assert torch.equal(got & ((1 << bits) - 1), want & ((1 << bits) - 1))
        if dtype != "int32":  # 16-bit and unsigned: the value itself
            assert torch.equal(got, want)


def test_split_refuses_other_types_and_the_cpu():
    for dt in (torch.int8, torch.uint8, torch.float32, torch.int64):
        with pytest.raises(TypeError, match="byte-plane split"):
            mxu.int_split_operand_plain(torch.zeros((4, 5), dtype=dt), False)
    with pytest.raises(ValueError, match="runs on the card"):
        mxu.int_split_operand(torch.zeros((4, 5), dtype=torch.int16), False)


def test_diagonals_walk_the_pairs_under_four():
    assert mxu.int_diagonals(1) == [(0, [(0, 0)])]
    assert mxu.int_diagonals(2) == [(2, [(1, 1)]), (1, [(0, 1), (1, 0)]), (0, [(0, 0)])]
    assert mxu.int_diagonals(4) == [
        (3, [(0, 3), (1, 2), (2, 1), (3, 0)]), (2, [(0, 2), (1, 1), (2, 0)]),
        (1, [(0, 1), (1, 0)]), (0, [(0, 0)])]
    for dt in TYPES:
        n = INT_PLANES[dt]
        assert slice_passes(n, 4) == sum(len(p) for _, p in mxu.int_diagonals(n))
    assert [slice_passes(INT_PLANES[dt], 4) for dt in TYPES] == [4, 1, 4, 10, 10]


# ---- the plain walk against the reference -----------------------------------

@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("ta,tb", chip_smoke.LAYOUTS)
def test_plain_walk_matches_jax_bit_for_bit(dtype, ta, tb):
    # Whole-range values: every type's int32 sum wraps at K 70 (uint8: in
    # the 2^16-wide products), K off every 64- and 128-deep step.
    rng = np.random.default_rng(2602)
    m, n, k = 20, 36, 70
    a = _draw(rng, (k, m) if ta else (m, k), dtype)
    b = _draw(rng, (n, k) if tb else (k, n), dtype)
    kw = dict(transpose_a=ta, transpose_b=tb)
    want = _jax(a, b, **kw)
    ta_, tb_ = _t(a, b)
    cfg = default_config(getattr(torch, dtype))
    got = mxu.int_planes_matmul_plain(ta_, tb_, cfg=cfg, **kw)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, mxu.mxu_matmul_plain(ta_, tb_, cfg=cfg, **kw))
    assert torch.equal(got, matmul(ta_, tb_, **kw))


@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("out", ["int32", "own"])
def test_plain_walk_wraps_as_the_reference(dtype, out):
    # Sums far past 2^31: uint8 all 255 at K 40000 (K 255^2 = 2.6e9), the
    # others over their whole range at K 4100 (ragged: 32 128-deep steps and
    # 4); into int32 and into the type's own output.
    rng = np.random.default_rng(2603)
    top = dtype == "uint8"
    k = 40_000 if top else 4100
    a, b = _draw(rng, (4, k), dtype, top), _draw(rng, (k, 3), dtype, top)
    od = "int32" if out == "int32" else dtype
    want = _jax(a, b, block_k=2048, out_dtype=od)
    cfg = default_config(getattr(torch, dtype), out_dtype=od)
    got = mxu.int_planes_matmul_plain(*_t(a, b), cfg=cfg)
    np.testing.assert_array_equal(got.numpy(), want)
    if top:
        exact = k * 255 * 255
        wrapped = (exact + 2**31) % 2**32 - 2**31 if od == "int32" else exact % 256
        assert exact > 2**31 and int(got[0, 0]) == wrapped


@pytest.mark.parametrize("dtype", TYPES)
def test_plain_walk_batched_and_broadcast_match_jax(dtype):
    rng = np.random.default_rng(2604)
    a, b = _draw(rng, (3, 12, 40), dtype), _draw(rng, (3, 40, 20), dtype)
    b2 = _draw(rng, (40, 20), dtype)
    cfg = default_config(getattr(torch, dtype))
    for x, y in ((a, b), (a, b2)):
        got = mxu.int_planes_matmul_plain(*_t(x, y), cfg=cfg)
        np.testing.assert_array_equal(got.numpy(), _jax(x, y))


@pytest.mark.parametrize("dtype", TYPES)
def test_plain_walk_epilogue_to_fp32_matches_jax(dtype):
    # The wrapped int32 sum widened to fp32 meets the epilogue (relu(acc +
    # bias)), as the engine's store does.
    from gemm_hls_tpu_torch.ops.epilogue import get_epilogue
    rng = np.random.default_rng(2605)
    a, b = _draw(rng, (16, 48), dtype), _draw(rng, (48, 24), dtype)
    bias = rng.uniform(-1e9, 1e9, 24).astype(np.float32)
    want = _jax(a, b, out_dtype="float32", epilogue=lambda acc, x: jnp.maximum(acc + x, 0),
                epilogue_operands=(jnp.asarray(bias),))
    cfg = default_config(getattr(torch, dtype), out_dtype="float32")
    ta_, tb_, tbias = _t(a, b, bias)
    got = mxu.int_planes_matmul_plain(ta_, tb_, tbias, cfg=cfg,
                                      epilogue=get_epilogue("bias_relu"))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    front = matmul(ta_, tb_, out_dtype="float32", epilogue="bias_relu",
                   epilogue_operands=(tbias,))
    assert torch.equal(got, front)


@pytest.mark.parametrize("out", ["int16", "uint8", "uint16", "uint32"])
def test_int8_into_wide_integer_outputs_matches_jax(out):
    # The engine's store writes int16 and the unsigned ints for int8 inputs
    # too: the int32 sum's wrapping cast, as the reference's astype.
    rng = np.random.default_rng(2606)
    a, b = _draw(rng, (16, 300), "int8"), _draw(rng, (300, 24), "int8")
    want = _jax(a, b, out_dtype=out)
    got = matmul(*_t(a, b), out_dtype=out)
    assert got.dtype == getattr(torch, out)
    np.testing.assert_array_equal(got.numpy(), want)


# ---- the rule, the bound, the card tables -----------------------------------

@pytest.mark.parametrize("dtype", TYPES)
def test_route_rule_gives_the_engine(dtype):
    dt = getattr(torch, dtype)
    for out in (None, dtype, "int32", "int8", "float32", "bfloat16", "uint16"):
        assert call_route(dtype, "plus_times", out) == "wgmma"
        assert mxu.mxu_route(dt, None if out is None else getattr(torch, out)) == "wgmma"
    for out in ("float64", "int64"):  # the engine does not store them
        assert call_route(dtype, "plus_times", out) == "simt"
    assert call_route(dtype, "min_plus") == "simt"
    assert ENGINE_TILES[dtype] == (128, 256, 128)
    # uint8 packs as int8 does; the split types pack nothing.
    for ta, tb in chip_smoke.LAYOUTS:
        for aligned in (False, True):
            want = ((ta or not aligned, not tb or not aligned) if dtype == "uint8"
                    else (False, False))
            assert packed_operands(dtype, ta, tb, aligned, aligned) == want


def test_int_split_bound():
    # 1 / 4 / 10 passes of 2 M N K at the int8 rate, plus the pass's bytes.
    n = 4096
    one = 2.0 * n ** 3 / H100.peak_for("int8")
    for dt, passes in (("uint8", 1), ("int16", 4), ("uint16", 4), ("uint32", 10),
                       ("int32", 10)):
        t, by = int_split_bound(H100, dt, n, n, n)
        split = 0 if dt == "uint8" else int_split_bytes(dt, n, n, n) / H100.hbm_bandwidth
        assert by == "operations" and t == pytest.approx(passes * one + split, rel=1e-12)
    assert int_split_bound(H100, "uint8", n, n, n)[0] == pytest.approx(0.0695e-3, rel=1e-2)
    assert int_split_bound(H100, "int16", n, n, n)[0] == pytest.approx(0.318e-3, rel=1e-2)
    assert int_split_bound(H100, "int32", n, n, n)[0] == pytest.approx(0.775e-3, rel=1e-2)
    # uint8's B held (K, N) is packed: its bytes added.
    packed = pack_bytes("uint8", n, n, n)
    assert packed == 2 * n * n
    assert int_split_bound(H100, "uint8", n, n, n, pack_bytes=packed)[0] == pytest.approx(
        one + packed / H100.hbm_bandwidth, rel=1e-12)
    # Each operand read once, its planes (K rounded up to 128) written once.
    assert int_split_bytes("int32", 100, 50, 130) == 150 * (4 * 130 + 4 * 256)


@pytest.mark.parametrize("dtype", TYPES)
def test_int_gemm_bound_is_the_functions_floor(dtype):
    # The function's floor: the plane pairs at the int8 rate, or A, B and C
    # moved once in their own type; the design's bound adds the split's (or
    # the pack's) bytes and reads the planes, never less.
    for m, n, k, batch in ((4096, 4096, 4096, 1), (64, 64, 8192, 3), (4096, 8, 8, 1)):
        t, by = int_gemm_bound(H100, dtype, m, n, k, batch=batch)
        size = np.dtype(dtype).itemsize
        ops = slice_passes(INT_PLANES[dtype], 4) * 2.0 * batch * m * n * k / H100.peak_for("int8")
        moved = batch * ((m + n) * k + m * n) * size / H100.hbm_bandwidth
        assert t == pytest.approx(max(ops, moved), rel=1e-12)
        assert by == ("operations" if ops >= moved else "bytes")
        packed = pack_bytes(dtype, m, n, k) if dtype == "uint8" else 0
        assert int_split_bound(H100, dtype, m, n, k, batch=batch, pack_bytes=packed)[0] >= t
    n = 4096
    t = int_gemm_bound(H100, dtype, n, n, n)[0]
    assert t == pytest.approx(slice_passes(INT_PLANES[dtype], 4) * 2.0 * n ** 3
                              / H100.peak_for("int8"), rel=1e-12)
    if dtype != "uint8":
        # The split's bytes lie between the two.
        assert int_split_bound(H100, dtype, n, n, n)[0] - t == pytest.approx(
            int_split_bytes(dtype, n, n, n) / H100.hbm_bandwidth, rel=1e-12)


@pytest.mark.parametrize("dtype", TYPES)
def test_callable_epilogue_source_names_the_byte_walk(dtype):
    # A callable epilogue on the engine's integer route launches the one
    # integer kernel template with its planes and int16's signed high byte.
    from gemm_hls_tpu_torch.ops import codegen
    prog = codegen.lower_epilogue(lambda acc, b: torch.relu(acc + b), torch.int32,
                                  [torch.float32])
    planes = INT_PLANES[dtype]
    src = codegen.epilogue_source(prog, "wgmma", getattr(torch, dtype), False, True,
                                  f"planes{planes}")
    signed = "true" if dtype == "int16" else "false"
    assert f"launch_mxu_wg_int<ByteWalk<{planes}, {signed}>>(call, s, ep)" in src
    with pytest.raises(Exception, match="engine tile"):
        codegen.epilogue_source(prog, "wgmma", getattr(torch, dtype), False, True, "tf32x1")


def test_card_tables_take_the_routes_they_name():
    # chip_smoke.py's phase-35 tables: each integer case names the engine,
    # its retired route the CUDA-core tile; the int8 wide-output cases the
    # engine, with no retired route to run on (no other tile stores them
    # for int8); the callable epilogue's library is among phase 31's
    # prebuilt ones.
    from gemm_hls_tpu_torch.ops import codegen
    seen = set()
    for case in chip_smoke.INT_ROUTE_CASES + chip_smoke.WIDE_B1_CASES:
        if case[0] not in INT_PLANES:
            continue
        assert mxu.mxu_route(getattr(torch, case[0])) == case[-1] == "wgmma", case
        assert chip_smoke.retired_route(*chip_smoke.wide_case_layout(case)) == "simt"
        seen.add(case[0])
    assert seen == set(TYPES)
    assert {c[8] for c in chip_smoke.INT_ROUTE_CASES} == {"rand", "small", "max"}
    for case in chip_smoke.INT8_WIDE_OUT_CASES:
        assert case[0] == "int8" and case[-1] == "wgmma" and case[1] not in ("float64", "int64")
    specs = {src for src, _ in chip_smoke.phase31_specs(torch)}
    fn, count = chip_smoke.user_epilogues()["relu_bias"]
    for case in chip_smoke.INT_GEN_EPILOGUE_CASES:
        dt = getattr(torch, case[1])
        assert mxu.mxu_route(dt) == case[-1] == "wgmma"
        for route, tile, tb in (("wgmma", "planes2", True), ("simt", None, False)):
            src, _ = codegen.epilogue_spec(fn, route, dt, torch.int32, [torch.float32] * count,
                                           False, tb, "relu_bias", tile)
            assert src in specs, (case, route)
    assert {c[0] for c in chip_smoke.INT_SPLIT_CASES} == set(SPLIT)
