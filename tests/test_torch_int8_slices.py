"""The int8-slice precision tiers of the port (``ops/int8_slices.py``,
``ops/slice_kernels.py``, ``matmul(precision="i8x*")``) against
``gemm_hls_tpu``'s counterparts on the same numpy inputs.

The JAX side runs its Pallas kernels (``_diag_kernel``, ``_oz_kernel``) in
interpret mode, as ``tests/test_int8_slices.py`` does; the port runs the
kernels' plain versions, as CPU tensors do.  Tolerances: slices and ulps
exact; the plain B4 / B5 against the Pallas kernels exact for the int32
diagonals (so for every fp32 combine that follows in the same order),
relative 1e-6 where an fp32 output is compared; the front door relative
1e-6 to JAX plus the JAX tests' normwise bounds against the float64
oracle.  Cases with K past the int32 bounds run against the oracle only.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemm_hls_tpu import matmul as jax_matmul
from gemm_hls_tpu.ops import int8_slices as jax_i8
from gemm_hls_tpu.ops import pallas_ozaki as jax_oz

from gemm_hls_tpu_torch import matmul
from gemm_hls_tpu_torch.config import (
    OZAKI_ENGINE_TILE, SLICE_TILES, SMEM_LIMIT_BYTES, ozaki_engine_smem_bytes,
    slice_route, slice_smem_bytes,
)
from gemm_hls_tpu_torch.models import perf_model
from gemm_hls_tpu_torch.ops import int8_slices, slice_kernels
from gemm_hls_tpu_torch.ops.int8_slices import _quantize_slices, fp32_matmul_int8
from gemm_hls_tpu_torch.utils import make_operands

torch.set_num_threads(1)

BLOCKS = dict(block_m=32, block_n=128, block_k=128)


def _t(x):
    return torch.from_numpy(np.array(x))


def _normwise(got, a, b):
    exp = a.astype(np.float64) @ b.astype(np.float64)
    scale = (np.linalg.norm(a.astype(np.float64), axis=1)[:, None]
             * np.linalg.norm(b.astype(np.float64), axis=0)[None, :])
    return (np.abs(np.asarray(got, np.float64) - exp) / (scale + 1e-30)).max()


def _data(kind, seed=3):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        x = rng.uniform(-100, 100, (16, 32))
    elif kind == "wide":
        x = rng.uniform(-1, 1, (24, 48)) * 10.0 ** rng.integers(-3, 4, (24, 48))
    else:  # zero rows and columns among ordinary ones
        x = rng.uniform(-5, 5, (20, 36))
        x[[2, 7]] = 0.0
        x[:, [0, 5]] = 0.0
    return x.astype(np.float32)


# ---- the quantize ----------------------------------------------------------

@pytest.mark.parametrize("kind", ["uniform", "wide", "zeros"])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("n_slices", [2, 3, 4])
def test_quantize_slices_bit_identical(kind, axis, n_slices):
    x = _data(kind)
    js, ju = jax_i8._quantize_slices(jnp.asarray(x), axis=axis,
                                     n_slices=n_slices)
    xt = _t(x)
    ts, tu = _quantize_slices(xt, axis=axis, n_slices=n_slices)
    assert torch.equal(xt, _t(x))  # the input is not written
    assert ts.dtype == torch.int8 and tu.dtype == torch.float32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    listed, lu = _quantize_slices(_t(x), axis=axis, n_slices=n_slices,
                                  stacked=False)
    assert torch.equal(torch.stack(listed), ts) and torch.equal(lu, tu)


def test_quantize_reconstructs():
    x = _data("uniform", seed=0)
    slices, ulp = _quantize_slices(_t(x), axis=1)
    recon = sum(slices[i].double() * ulp.double() * 2.0 ** (-7 * i)
                for i in range(3))
    rel = (recon - _t(x).double()).abs() / ulp.double() / 2 ** 14
    assert float(rel.max()) < 1.0  # residual below the last slice's ulp


def test_quantize_exponent_is_exact_at_powers_of_two():
    # A row whose max is exactly 8192: the port's grid puts it at 64 ulps
    # and reconstructs it exactly; the JAX package's log(x)/log(2) lands
    # just below 13 there, halving the ulp so its top slice clips at 127
    # (ROADMAP C2).  Everywhere else the two agree (the test above).
    x = np.array([[8192.0, 3.0, -1.5]], np.float32)
    ts, tu = _quantize_slices(_t(x), axis=1, n_slices=3)
    assert float(tu) == 2.0 ** 7 and int(ts[0, 0, 0]) == 64
    recon = sum(ts[i].double() * 2.0 ** (-7 * i) for i in range(3)) * float(tu)
    np.testing.assert_array_equal(recon.numpy(), x.astype(np.float64))
    js, ju = jax_i8._quantize_slices(jnp.asarray(x), axis=1, n_slices=3)
    assert float(ju[0, 0]) == 2.0 ** 6 and int(js[0, 0, 0]) == 127


# ---- plain B4 / B5 against the Pallas kernels ------------------------------

def _slices(n_slices, m, n, k, seed=0):
    rng = np.random.default_rng(seed)
    sa = rng.integers(-127, 128, (n_slices, m, k)).astype(np.int8)
    sb = rng.integers(-127, 128, (n_slices, k, n)).astype(np.int8)
    return sa, sb


@pytest.mark.parametrize("n_slices", [2, 3, 4])
@pytest.mark.parametrize("form", ["split", "stacked_scaled"])
def test_fused_int8_fp32_plain_matches_pallas(n_slices, form):
    m, n, k = 32, 128, 256
    sa, sb = _slices(n_slices, m, n, k, seed=n_slices)
    rng = np.random.default_rng(9)
    ua = (2.0 ** rng.integers(-9, 3, (m, 1))).astype(np.float32)
    ub = (2.0 ** rng.integers(-9, 3, (1, n))).astype(np.float32)
    if form == "split":
        jx = (tuple(jnp.asarray(s) for s in sa), tuple(jnp.asarray(s) for s in sb))
        tx = (tuple(_t(s) for s in sa), tuple(_t(s) for s in sb))
        ulps_j, ulps_t = (), ()
    else:
        jx, tx = (jnp.asarray(sa), jnp.asarray(sb)), (_t(sa), _t(sb))
        ulps_j, ulps_t = (jnp.asarray(ua), jnp.asarray(ub)), (_t(ua), _t(ub))
    exp = np.asarray(jax_oz.fused_int8_fp32(*jx, *ulps_j, block_m=32,
                                            block_n=128, block_k=128))
    got = slice_kernels.fused_int8_fp32(*tx, *ulps_t).numpy()
    if form == "split":  # unscaled: the exact diagonals' combine
        np.testing.assert_array_equal(got, exp)
    else:
        np.testing.assert_allclose(got, exp, rtol=1e-6)


@pytest.mark.parametrize("n_slices,n_diags,k", [(3, 2, 192), (4, 3, 320), (4, 2, 192),
                                               (2, 1, 64), (3, 3, 448)])
@pytest.mark.parametrize("scaled", [False, True])
def test_fused_int8_fp32_plain_matches_pallas_below_n_slices(n_slices, n_diags, k, scaled):
    # The diagonals the engine route keeps (n_diags below n_slices, one
    # diagonal) at K off its 128-deep slab: the plain B4 equals the Pallas
    # _diag_kernel exactly unscaled, to 1e-6 with the ulps.
    m, n = 32, 128
    sa, sb = _slices(n_slices, m, n, k, seed=10 + n_slices + n_diags)
    rng = np.random.default_rng(k)
    ua = (2.0 ** rng.integers(-9, 3, (m, 1))).astype(np.float32)
    ub = (2.0 ** rng.integers(-9, 3, (1, n))).astype(np.float32)
    ulps_j = (jnp.asarray(ua), jnp.asarray(ub)) if scaled else ()
    ulps_t = (_t(ua), _t(ub)) if scaled else ()
    exp = np.asarray(jax_oz.fused_int8_fp32(jnp.asarray(sa), jnp.asarray(sb), *ulps_j,
                                            block_m=32, block_n=128, block_k=64,
                                            n_diags=n_diags))
    got = slice_kernels.fused_int8_fp32(_t(sa), _t(sb), *ulps_t, n_diags=n_diags).numpy()
    if scaled:
        np.testing.assert_allclose(got, exp, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("n_slices,n_diags", [(2, None), (3, 3), (8, 8)])
def test_fused_ozaki_int8_plain_matches_pallas(n_slices, n_diags):
    m, n, k = 32, 128, 512
    sa, sb = _slices(n_slices, m, n, k, seed=11)
    jh, jl = jax_oz.fused_ozaki_int8(jnp.asarray(sa), jnp.asarray(sb),
                                     block_m=32, block_n=128, block_k=256,
                                     n_diags=n_diags)
    th, tl = slice_kernels.fused_ozaki_int8(_t(sa), _t(sb), block_k=256,
                                            n_diags=n_diags)
    exp = np.asarray(jh, np.float64) + np.asarray(jl, np.float64)
    got = th.double().numpy() + tl.double().numpy()
    scale = np.abs(exp).max()
    assert np.abs(got - exp).max() <= 1e-15 * scale


def test_fused_ozaki_int8_plain_unpadded_k():
    # The port takes unpadded K; its last partial block equals the JAX
    # kernel's zero-padded one.
    sa, sb = _slices(3, 32, 128, 300, seed=13)
    pad = 512 - 300
    jh, jl = jax_oz.fused_ozaki_int8(
        jnp.asarray(np.pad(sa, ((0, 0), (0, 0), (0, pad)))),
        jnp.asarray(np.pad(sb, ((0, 0), (0, pad), (0, 0)))),
        block_m=32, block_n=128, block_k=256, n_diags=3)
    th, tl = slice_kernels.fused_ozaki_int8(_t(sa), _t(sb), block_k=256,
                                            n_diags=3)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


@pytest.mark.parametrize("case", ["mixed_forms", "shapes", "ulp_pair",
                                  "ulp_shape", "whole_k", "block_k_bound",
                                  "block_k_step"])
def test_slice_kernel_argument_errors(case):
    sa, sb = (_t(x) for x in _slices(3, 8, 16, 32))
    k_big = 44400  # 3 * 127^2 * 44400 >= 2^31
    ones_m, ones_n = torch.ones(8, 1), torch.ones(1, 16)
    calls = {
        "mixed_forms": (lambda: slice_kernels.fused_int8_fp32(
            tuple(sa), sb), "both be stacked"),
        "shapes": (lambda: slice_kernels.fused_int8_fp32(
            tuple(sa), tuple(sb[:, :16])), "disagree"),
        "ulp_pair": (lambda: slice_kernels.fused_int8_fp32(
            sa, sb, ones_m), "both ulp_a and ulp_b"),
        "ulp_shape": (lambda: slice_kernels.fused_int8_fp32(
            sa, sb, ones_n, ones_m), "ulp shapes"),
        "whole_k": (lambda: slice_kernels.fused_int8_fp32(
            torch.zeros(3, 8, k_big, dtype=torch.int8),
            torch.zeros(3, k_big, 16, dtype=torch.int8)), "whole-K"),
        "block_k_bound": (lambda: slice_kernels.fused_ozaki_int8(
            sa, sb, block_k=45056), "too large"),
        "block_k_step": (lambda: slice_kernels.fused_ozaki_int8(
            sa, sb, block_k=48), "K step"),
    }
    fn, match = calls[case]
    with pytest.raises(ValueError, match=match):
        fn()


# ---- fp32_matmul_int8 and the front door ----------------------------------

@pytest.mark.parametrize("mnk", [(64, 96, 128), (33, 65, 127)])
@pytest.mark.parametrize("n_slices,bound", [(2, 3e-4), (3, 2e-6), (4, 2e-7)])
def test_fp32_matmul_int8_matches_jax(mnk, n_slices, bound):
    m, n, k = mnk
    a, b = make_operands(m, n, k, "float32", low=-5.0, high=5.0)
    exp = np.asarray(jax_i8.fp32_matmul_int8(jnp.asarray(a), jnp.asarray(b),
                                             n_slices=n_slices, **BLOCKS))
    got = fp32_matmul_int8(_t(a), _t(b), n_slices=n_slices, **BLOCKS).numpy()
    np.testing.assert_allclose(got, exp, rtol=1e-6, atol=1e-6 * np.abs(exp).max())
    assert _normwise(got, a, b) < bound


def test_wide_magnitudes():
    rng = np.random.default_rng(3)
    a = (rng.uniform(-1, 1, (24, 48)) * 10.0 **
         rng.integers(-3, 4, (24, 48))).astype(np.float32)
    b = (rng.uniform(-1, 1, (48, 24)) * 10.0 **
         rng.integers(-3, 4, (48, 24))).astype(np.float32)
    exp = np.asarray(jax_i8.fp32_matmul_int8(jnp.asarray(a), jnp.asarray(b),
                                             **BLOCKS))
    got = fp32_matmul_int8(_t(a), _t(b), **BLOCKS).numpy()
    np.testing.assert_allclose(got, exp, rtol=1e-6, atol=1e-6 * np.abs(exp).max())
    assert _normwise(got, a, b) < 1e-5


def test_k_bound_staged_only():
    a = torch.zeros((8, 1 << 18))
    b = torch.zeros((1 << 18, 8))
    with pytest.raises(ValueError, match="exactness bound"):
        fp32_matmul_int8(a, b, fused=False)


@pytest.mark.parametrize("n_slices,bound", [(2, 3e-4), (3, 2e-6)])
def test_fused_matches_staged(n_slices, bound):
    rng = np.random.default_rng(7)
    a = rng.uniform(-3, 3, (40, 200)).astype(np.float32)
    b = rng.uniform(-3, 3, (200, 72)).astype(np.float32)
    kw = dict(n_slices=n_slices, block_m=32, block_n=128, block_k=256)
    fused = fp32_matmul_int8(_t(a), _t(b), fused=True, **kw).numpy()
    staged = fp32_matmul_int8(_t(a), _t(b), fused=False, **kw).numpy()
    exp = np.asarray(jax_i8.fp32_matmul_int8(jnp.asarray(a), jnp.asarray(b),
                                             fused=False, **kw))
    np.testing.assert_allclose(staged, exp, rtol=1e-6, atol=1e-6 * np.abs(exp).max())
    for got in (fused, staged):
        assert _normwise(got, a, b) < bound


@pytest.mark.parametrize("m,n,k,route", [(16, 128, 44000, "B5"),
                                         (8, 8, (1 << 17) + 128, "B5"),
                                         (16, 128, 40000, "B4")])
def test_routing_past_the_whole_k_bound(m, n, k, route, caplog):
    # K = 44000 fits the bound unpadded but not padded as the JAX package
    # pads it: both take the hi/lo kernel.  Checked against the oracle.
    rng = np.random.default_rng(5)
    a = rng.uniform(-1, 1, (m, k)).astype(np.float32)
    b = rng.uniform(-1, 1, (k, n)).astype(np.float32)
    with caplog.at_level(logging.INFO, logger=int8_slices.__name__):
        got = fp32_matmul_int8(_t(a), _t(b), n_slices=3, block_m=16,
                               block_n=128, block_k=2048).numpy()
    took_b5 = any("kernel B5" in r.getMessage() for r in caplog.records)
    assert took_b5 == (route == "B5")
    assert _normwise(got, a, b) < 2e-6


def test_int8_slices_gradients():
    a, b = make_operands(24, 32, 40, "float32", low=-2.0, high=2.0)
    g = np.random.default_rng(4).uniform(-1, 1, (24, 32)).astype(np.float32)
    ja, jb = jax.grad(lambda x, y: jnp.sum(jax_i8.fp32_matmul_int8(
        x, y, **BLOCKS) * g), argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    x, y = _t(a).requires_grad_(), _t(b).requires_grad_()
    fp32_matmul_int8(x, y, **BLOCKS).backward(_t(g))
    for got, exp in ((x.grad, ja), (y.grad, jb)):
        exp = np.asarray(exp)
        np.testing.assert_allclose(got.numpy(), exp, rtol=1e-6,
                                   atol=1e-6 * np.abs(exp).max())
    # And against plain fp32 autograd, as the JAX test holds it.
    np.testing.assert_allclose(x.grad.numpy(), g @ b.T, rtol=1e-3,
                               atol=np.abs(g @ b.T).max() * 1e-4)


@pytest.mark.parametrize("precision,bound", [("i8x2", 3e-4), ("i8x3", 2e-6),
                                             ("i8x4", 2e-7)])
def test_precision_i8_via_matmul_api(precision, bound):
    a, b = make_operands(40, 70, 90, "float32", low=-3.0, high=3.0)
    exp = np.asarray(jax_matmul(jnp.asarray(a), jnp.asarray(b),
                                precision=precision))
    got = matmul(_t(a), _t(b), precision=precision).numpy()
    np.testing.assert_allclose(got, exp, rtol=1e-6, atol=1e-6 * np.abs(exp).max())
    assert _normwise(got, a, b) < bound
    out = matmul(_t(a), _t(b), precision=precision, out_dtype="bfloat16")
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("request_", ["transpose", "bfloat16", "epilogue"])
def test_precision_i8_refusals(request_):
    a, b = make_operands(8, 16, 24, "float32")
    ta, tb = _t(a), _t(b)
    kw = dict(precision="i8x3")
    if request_ == "transpose":
        tb, kw["transpose_b"] = tb.T.contiguous(), True
    elif request_ == "bfloat16":
        ta, tb = ta.bfloat16(), tb.bfloat16()
    else:
        kw.update(epilogue="bias", epilogue_operands=(torch.ones(16),))
    with pytest.raises(ValueError, match="i8x|int8-slice"):
        matmul(ta, tb, **kw)
    if request_ == "transpose":
        with pytest.raises(ValueError, match="i8x"):
            jax_matmul(jnp.asarray(a), jnp.asarray(b).T, precision="i8x3",
                       transpose_b=True)


@pytest.mark.parametrize("layout", ["3d_x_2d", "2d_x_3d", "3d_x_3d"])
def test_precision_i8_batched_matches_vmap(layout):
    rng = np.random.default_rng(21)
    a = rng.uniform(-4, 4, (2, 24, 40)).astype(np.float32)
    b = rng.uniform(-4, 4, (2, 40, 32)).astype(np.float32)
    if layout == "3d_x_2d":
        b = b[0]
    elif layout == "2d_x_3d":
        a = a[0]
    exp = np.asarray(jax_matmul(jnp.asarray(a), jnp.asarray(b),
                                precision="i8x2"))
    got = matmul(_t(a), _t(b), precision="i8x2").numpy()
    assert got.shape == exp.shape
    np.testing.assert_allclose(got, exp, rtol=1e-6, atol=1e-6 * np.abs(exp).max())


def test_i8x4_reaches_f32_output_floor():
    rng = np.random.default_rng(11)
    m, n, k = 48, 128, 160
    a = rng.uniform(1, 10, (m, k)).astype(np.float32)
    b = rng.uniform(1, 10, (k, n)).astype(np.float32)
    exp = a.astype(np.float64) @ b.astype(np.float64)
    errs = {}
    for mode in ("i8x3", "i8x4"):
        got = matmul(_t(a), _t(b), precision=mode).double().numpy()
        errs[mode] = np.linalg.norm(got - exp) / np.linalg.norm(exp)
    assert errs["i8x4"] < errs["i8x3"] / 4, errs
    assert errs["i8x4"] < 2 ** -22, errs


# ---- tiles and bounds --------------------------------------------------------

@pytest.mark.parametrize("max_diags", sorted(SLICE_TILES))
def test_slice_tiles_fit_shared_memory(max_diags):
    # The ring of K steps for every slice the instantiation may read.
    assert slice_smem_bytes(max_diags, max_diags) <= SMEM_LIMIT_BYTES
    bm, bn, bk = SLICE_TILES[max_diags]
    assert bk == slice_kernels._K_STEP and bm % 16 == 0 and bn % 16 == 0


def test_ozaki_engine_tile_fits_shared_memory():
    # One block a SM: the 6-stage ring of (A_i, B_j^T) slab pairs, 128-byte
    # swizzled rows (the slab is the swizzle's whole row).
    bm, bn, slab = OZAKI_ENGINE_TILE
    assert ozaki_engine_smem_bytes() <= SMEM_LIMIT_BYTES
    assert slab == 128 and bm == 128 and bn % 8 == 0 and bn <= 256


@pytest.mark.parametrize("n_diags,flush,route", [(1, False, 2), (2, False, 2),
                                                 (3, False, 3), (4, False, 4),
                                                 (8, False, 9), (2, True, 9)])
def test_slice_route(n_diags, flush, route):
    assert slice_route(n_diags, flush) == route


@pytest.mark.parametrize("n_slices,n_diags,passes,n,bound_ms", [
    (2, 2, 3, 8192, 1.67), (3, 3, 6, 8192, 3.33), (4, 4, 10, 8192, 5.56),
    (8, 8, 36, 2048, 0.31)])
def test_slice_pass_counts_and_bounds(n_slices, n_diags, passes, n, bound_ms):
    # bench.py:269-272's pass counts (i8x2 / i8x3 / i8x4, 8-slice Ozaki);
    # bounds on the int8 tensor cores.
    assert perf_model.slice_passes(n_slices, n_diags) == passes
    secs, by = perf_model.slice_gemm_bound(perf_model.H100, n, n, n, n_slices, n_diags)
    assert by == "operations" and round(secs * 1e3, 2) == bound_ms


@pytest.mark.parametrize("lda,ldb", [(1024, 1024), (4096, 2048), (1008, 1008),
                                     (1000, 1024), (1024, 131)])
@pytest.mark.parametrize("block_k", [64, 128, 192, 256, 2048])
@pytest.mark.parametrize("aligned", [True, False])
def test_ozaki_route(lda, ldb, block_k, aligned):
    # B5 takes the engine where TMA describes every slice row (16-byte
    # pitches and bases) and no 128-deep slab straddles a flush.
    engine = (aligned and lda % 16 == 0 and ldb % 16 == 0
              and block_k % slice_kernels.OZ_ENGINE_SLAB == 0)
    want = "wgmma" if engine else "mma.sync"
    assert slice_kernels.ozaki_route(lda, ldb, block_k, aligned) == want


@pytest.mark.parametrize("k", [64, 100, 1000, 2048, 44000, (1 << 17) + 128])
def test_front_doors_block_k_reaches_the_engine(k):
    # ozaki_matmul_int8's and the i8x tiers' block_k are multiples of 256:
    # with K-contiguous rows of whole 16-byte units, every such call runs
    # on the engine.
    for bk in (min(2048, -(-k // 256) * 256), min(4096, -(-k // 256) * 256)):
        route = slice_kernels.ozaki_route(k, k, bk, True)
        assert route == ("wgmma" if k % 16 == 0 else "mma.sync")


def test_card_table_takes_the_routes_it_names():
    # chip_smoke.py's B5 route table (phase 10b and the card tests): the
    # route each case asserts is ozaki_route's for its pitches and block_k.
    import chip_smoke

    routes = set()
    for case in chip_smoke.OZAKI_ROUTE_CASES + [chip_smoke.OZAKI_REPEAT_CASE]:
        _, _, block_k, (_, _, k), layout, route = case
        pitch = (k + 15) // 16 * 16 + 16 if layout == "pitched" else k
        assert slice_kernels.ozaki_route(pitch, pitch, block_k, True) == route, case
        routes.add(route)
    assert routes == {"wgmma", "mma.sync"}


@pytest.mark.parametrize("n_diags,lda,ldb,aligned,want", [
    (3, 8192, 8192, True, "wgmma"),      # i8x3 at 8192^3
    (2, 4096, 2048, True, "wgmma"),
    (4, 1008, 1008, True, "wgmma"),      # K off the 128 slab, pitch 16-byte
    (1, 1024, 1024, True, "wgmma"),
    (5, 1024, 1024, True, "mma.sync"),   # more diagonals than the engine holds
    (9, 1024, 1024, True, "mma.sync"),   # phase 10a's 8 slices
    (3, 1000, 1024, True, "mma.sync"),   # A's pitch off 16 bytes
    (3, 1024, 131, True, "mma.sync"),    # B's pitch off 16 bytes
    (3, 1024, 1024, False, "mma.sync"),  # a base off 16 bytes
])
def test_diag_route(n_diags, lda, ldb, aligned, want):
    # B4 takes the engine for at most 4 diagonals where TMA describes every
    # slice row (16-byte pitches and bases); any K, as TMA zero-fills it.
    assert slice_kernels.diag_route(n_diags, lda, ldb, aligned) == want


def test_diag_card_table_takes_the_routes_it_names():
    # chip_smoke.py's B4 route table (phase 10a and the card tests): the
    # route each case asserts is diag_route's for its pitches (B's slices
    # K-contiguous with A's pitch, as the wrapper reads them); each engine
    # case also runs on mma.sync; the edge cases sit at the whole-K bound.
    import chip_smoke

    routes = set()
    for case in chip_smoke.DIAG_ROUTE_CASES + [chip_smoke.DIAG_REPEAT_CASE]:
        ns, n_diags, (_, _, k), layout, _, fill, route = case
        pitch = (k + 15) // 16 * 16 + 16 if layout == "pitched" else k
        assert slice_kernels.diag_route(n_diags, pitch, pitch, True) == route, case
        assert ns * 127 ** 2 * k < 2 ** 31, case
        if fill == "max":
            assert ns * 127 ** 2 * (k + 16) >= 2 ** 31, case
        routes.add(route)
    assert routes == {"wgmma", "mma.sync"}
    overrides = [c for c, r in chip_smoke.DIAG_RUNS if r == "mma.sync"]
    assert overrides == [c for c in chip_smoke.DIAG_ROUTE_CASES if c[-1] == "wgmma"]


def test_plain_b4_leaves_the_route_alone():
    slice_kernels.fused_int8_fp32.last_route = None
    sa, sb = (_t(x) for x in _slices(3, 8, 16, 32))
    slice_kernels.fused_int8_fp32(sa, sb)
    assert slice_kernels.fused_int8_fp32.last_route is None


def test_plain_b5_leaves_the_route_alone():
    slice_kernels.fused_ozaki_int8.last_route = None
    sa, sb = (_t(x) for x in _slices(3, 8, 16, 32))
    slice_kernels.fused_ozaki_int8(sa, sb, block_k=64)
    assert slice_kernels.fused_ozaki_int8.last_route is None


def test_b4_b5_refuse_a_diagonal_count_past_the_kernels():
    sa, sb = (_t(x) for x in _slices(3, 8, 16, 32))
    with pytest.raises(ValueError, match="no slice kernel keeps"):
        slice_route(10)
    with pytest.raises(ValueError, match="n_diags must be a positive int"):
        slice_kernels.fused_int8_fp32(sa, sb, n_diags=0)
