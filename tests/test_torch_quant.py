"""The port's quantized GEMMs (``ops/quant.py``, ``ops/dequant.py``)
against the JAX package on the CPU, over ``tests/test_quant.py``'s cases.

The same numpy inputs, drawn from a seed, go through the JAX functions
(Pallas kernels in interpret mode) and through the port's plain versions
(CPU tensors).  The quantizer's bytes must be identical.  Tolerances are
``tests/test_quant.py``'s own: relative 1e-4 with absolute 1e-5 for the
dequant GEMM, absolute 1e-4 for W8A8 (its int8 values and int32 products
are the JAX ones exactly; the fp32 scaling differs in order only).  The
kernels themselves run only on the card (``tests/test_torch_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemm_hls_tpu.config import default_config as jax_default_config
from gemm_hls_tpu.ops import pallas_dequant as jdq
from gemm_hls_tpu.ops import quant as jquant
from gemm_hls_tpu_torch import (GemmConfig, dequantize_weights, matmul_quantized,
                                matmul_w8a8, quantize_weights)
from gemm_hls_tpu_torch.ops import dequant, quant

torch.set_num_threads(1)

DQ = dict(rtol=1e-4, atol=1e-5)
W8 = dict(rtol=1e-4, atol=1e-4)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("bits,g", [(8, None), (8, 64), (4, 64), (4, None),
                                    (4, 2), (8, 1)])
def test_quantizer_bytes_identical(bits, g):
    w = _rng(1).standard_normal((256, 128)).astype(np.float32)
    w[:, 5] = 0.0                       # a zero column: scale 1
    wq, s = quantize_weights(w, bits=bits, group_size=g)
    jwq, js = jquant.quantize_weights(w, bits=bits, group_size=g)
    assert wq.dtype == jwq.dtype == np.int8 and s.dtype == js.dtype == np.float32
    np.testing.assert_array_equal(wq, jwq)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(
        dequantize_weights(wq, s, bits=bits, group_size=g),
        jquant.dequantize_weights(jwq, js, bits=bits, group_size=g))


@pytest.mark.parametrize("bits,g", [(8, 64), (4, 64), (4, None)])
def test_unpack_matches_host_dequant(bits, g):
    w = _rng(2).standard_normal((256, 64)).astype(np.float32)
    wq, s = quantize_weights(w, bits=bits, group_size=g)
    q = dequant.unpack_weights(_t(wq), bits, g or 256).float()
    k = 256
    gg = g or k
    want = (q.reshape(k // gg, gg, -1) * _t(s)[:, None, :]).reshape(k, -1)
    np.testing.assert_array_equal(
        want.numpy(), dequantize_weights(wq, s, bits=bits, group_size=g))


@pytest.mark.parametrize("kw", [dict(bits=5), dict(group_size=48),
                                dict(bits=4, group_size=31)])
def test_quantizer_rejects_bad_args(kw):
    with pytest.raises(ValueError):
        quantize_weights(np.zeros((64, 32), np.float32), **kw)


@pytest.mark.parametrize("bits,g", [(8, None), (8, 64), (4, 64), (4, None)])
@pytest.mark.parametrize("m", [32, 1])
def test_matmul_quantized_vs_jax(bits, g, m):
    rng = _rng(5)
    w = rng.standard_normal((256, 128)).astype(np.float32)
    x = rng.standard_normal((m, 256)).astype(np.float32)
    wq, s = quantize_weights(w, bits=bits, group_size=g)
    want = np.asarray(jquant.matmul_quantized(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(s), bits=bits,
        group_size=g, interpret=True))
    got = matmul_quantized(_t(x), wq, s, bits=bits, group_size=g)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **DQ)
    np.testing.assert_allclose(
        got.numpy(), x @ dequantize_weights(wq, s, bits=bits, group_size=g), **DQ)


def test_matmul_quantized_multi_kblock_int8():
    # Per-channel int8 with K split into 4 semantic blocks.
    rng = _rng(6)
    w = rng.standard_normal((512, 128)).astype(np.float32)
    x = rng.standard_normal((16, 512)).astype(np.float32)
    wq, s = quantize_weights(w, bits=8)
    jcfg = jax_default_config("float32").replace(block_m=16, block_n=128,
                                                 block_k=128)
    want = np.asarray(jquant.matmul_quantized(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(s), bits=8, config=jcfg,
        interpret=True))
    cfg = GemmConfig(dtype="float32", block_m=16, block_n=128, block_k=128)
    got = matmul_quantized(_t(x), wq, s, bits=8, config=cfg)
    np.testing.assert_allclose(got.numpy(), want, **DQ)


@pytest.mark.parametrize("bits", [8, 4])
def test_multi_group_per_block_vs_jax(bits):
    # block_k = 2 groups: the JAX kernel folds the scales before the dot.
    rng = _rng(7)
    w = rng.standard_normal((256, 128)).astype(np.float32)
    x = rng.standard_normal((8, 256)).astype(np.float32)
    wq, s = quantize_weights(w, bits=bits, group_size=64)
    jcfg = jax_default_config("float32").replace(block_m=8, block_n=128,
                                                 block_k=128)
    want = np.asarray(jdq.dequant_matmul(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(s), cfg=jcfg, bits=bits,
        group_size=64, interpret=True))
    got = dequant.dequant_matmul(
        _t(x), _t(wq), _t(s), cfg=GemmConfig(dtype="float32", block_k=128),
        bits=bits, group_size=64)
    np.testing.assert_allclose(got.numpy(), want, **DQ)


def test_dequant_bf16_x_vs_jax():
    # bf16 activations: both expand the weights to bf16 and sum in fp32.
    rng = _rng(8)
    w = rng.standard_normal((256, 128)).astype(np.float32)
    x = rng.standard_normal((64, 256)).astype(np.float32)
    wq, s = quantize_weights(w, bits=4, group_size=64)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jquant.matmul_quantized(
        xb, jnp.asarray(wq), jnp.asarray(s), bits=4, group_size=64,
        out_dtype=jnp.float32, interpret=True))
    got = matmul_quantized(_t(np.asarray(xb, np.float32)).bfloat16(), wq, s,
                           bits=4, group_size=64, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("g", [32, None])
@pytest.mark.parametrize("m", [64, 256])
def test_matmul_quantized_vs_jax_at_engine_shapes(m, g):
    # int4 at the engine route's shapes (bf16 x, N 512, g32 and
    # per-channel); K 512 is one K-block on both sides (ROADMAP C:
    # pallas_dequant.py's per-channel int4 over several blocks is wrong).
    rng = _rng(10 + m)
    w = rng.standard_normal((512, 512)).astype(np.float32)
    x = rng.standard_normal((m, 512)).astype(np.float32)
    wq, s = quantize_weights(w, bits=4, group_size=g)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jquant.matmul_quantized(
        xb, jnp.asarray(wq), jnp.asarray(s), bits=4, group_size=g,
        out_dtype=jnp.float32, interpret=True))
    got = matmul_quantized(_t(np.asarray(xb, np.float32)).bfloat16(), wq, s,
                           bits=4, group_size=g, out_dtype=torch.float32)
    assert dequant.dequant_route(torch.bfloat16, 512, 512, g or 512, True) == "wgmma"
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype,n,k,g,aligned,want", [
    (torch.bfloat16, 2048, 2048, 128, True, "wgmma"),   # the decode q / o projection
    (torch.bfloat16, 512, 2048, 128, True, "wgmma"),    # the decode k / v projection
    (torch.float16, 512, 2048, 32, True, "wgmma"),
    (torch.bfloat16, 2048, 2048, 16, True, "wgmma"),    # the narrowest group a step holds
    (torch.bfloat16, 2048, 2048, 2048, True, "wgmma"),  # per-channel: a multiple of the step
    (torch.bfloat16, 1001, 2048, 128, True, "mma.sync"),  # N not a whole 16-byte row
    (torch.bfloat16, 2048, 1000, 1000, True, "mma.sync"),  # per-channel off the step
    (torch.bfloat16, 2048, 2016, 96, True, "mma.sync"),  # g96 does not tile 128
    (torch.bfloat16, 2048, 2048, 8, True, "mma.sync"),   # groups under 16
    (torch.bfloat16, 2048, 2048, 128, False, "mma.sync"),  # a base off 16 bytes
    (torch.float32, 2048, 2048, 128, True, "simt"),
    (torch.float32, 1001, 1000, 1000, False, "simt"),
])
def test_dequant_route(dtype, n, k, g, aligned, want):
    # The engine takes bf16 / fp16 with 16-byte rows and bases and groups
    # that tile its 128-deep K step; fp32 x stays on the CUDA cores.
    assert dequant.dequant_route(dtype, n, k, g, aligned) == want


# Clusters an H100 (132 SMs) holds at once by splits, as
# cudaOccupancyMaxActiveClusters reported them for the engine (PERF.md, section 6).
_H100_CLUSTERS = {8: 15, 6: 17, 4: 30, 2: 66}


@pytest.mark.parametrize("m,n,k,plan,card", [
    (64, 2048, 2048, (128, 8), False),  # the decode q / o projection: 128 blocks
    (64, 2048, 2048, (128, 6), True),   # 16 clusters of 8 do not fit the card at once
    (64, 512, 2048, (32, 8), False),    # k / v: 16 tiles of 32
    (64, 512, 2048, (32, 6), True),
    (256, 2048, 2048, (128, 2), False),  # 64 tiles: 3 splits would take two waves
    (1, 512, 96, (32, 1), True),
    (4096, 2048, 2048, (128, 1), True),
])
def test_dequant_engine_plan(m, n, k, plan, card):
    held = (lambda bn, splits: _H100_CLUSTERS[splits]) if card else None
    assert dequant.dequant_engine_plan(m, n, k, 132, held) == plan


def test_dequant_engine_plan_leaves_no_rank_empty():
    # Every split a whole number of steps and none empty, at most a
    # portable cluster, whatever the shape and SM count.
    for sms in (1, 78, 132):
        for m in (1, 64, 130, 1024):
            for n in (16, 512, 528, 2048):
                for k in (8, 96, 128, 1000, 2048, 8192):
                    bn, splits = dequant.dequant_engine_plan(m, n, k, sms)
                    steps = -(-k // dequant.DEQUANT_ENGINE_STEP)
                    per = -(-steps // splits)
                    assert bn in dequant.DEQUANT_ENGINE_BN
                    assert 1 <= splits <= dequant.DEQUANT_ENGINE_MAX_SPLITS
                    assert (splits - 1) * per < steps


def test_dequant_card_table_takes_the_routes_it_names():
    # chip_smoke.py's B13 route table (phase 16 and the card tests): the
    # route each case asserts is dequant_route's; each engine case also
    # runs on mma.sync.
    import chip_smoke

    routes = set()
    for case in chip_smoke.DEQUANT_ROUTE_CASES:
        dt, _, g, _, n, k, _, route = case
        assert dequant.dequant_route(getattr(torch, dt), n, k, g or k, True) == route, case
        assert k % (g or k) == 0, case
        routes.add(route)
    assert routes == {"wgmma", "mma.sync", "simt"}
    overrides = [c for c, r in chip_smoke.DEQUANT_RUNS if r == "mma.sync"]
    assert overrides == [c for c in chip_smoke.DEQUANT_ROUTE_CASES if c[-1] == "wgmma"]
    assert chip_smoke.DEQUANT_REPEAT_CASE[-1] == "wgmma"


def test_plain_dequant_leaves_the_route_alone():
    dequant.dequant_matmul.last_route = None
    wq, s = quantize_weights(_rng(11).standard_normal((64, 32)).astype(np.float32), bits=8)
    dequant.dequant_matmul(torch.ones(4, 64), _t(wq), _t(s),
                           cfg=GemmConfig(dtype="float32", block_k=64))
    assert dequant.dequant_matmul.last_route is None


def test_dequant_rejects_mismatches():
    rng = _rng(9)
    w = rng.standard_normal((256, 128)).astype(np.float32)
    x = _t(rng.standard_normal((8, 256)).astype(np.float32))
    with pytest.raises(ValueError, match="whole multiple"):
        wq, s = quantize_weights(w, bits=8, group_size=128)
        dequant.dequant_matmul(x, _t(wq), _t(s),
                               cfg=GemmConfig(dtype="float32", block_k=64),
                               bits=8, group_size=128)
    wq, s = quantize_weights(w, bits=8, group_size=64)
    with pytest.raises(ValueError, match="int8"):
        matmul_quantized(x, _t(wq).to(torch.int32), s, bits=8, group_size=64)
    with pytest.raises(ValueError, match="multiple of block_k"):
        dequant.dequant_matmul(x, _t(wq), _t(s),
                               cfg=GemmConfig(dtype="float32", block_k=96),
                               bits=8, group_size=64)
    with pytest.raises(ValueError, match="rows"):
        matmul_quantized(x, wq, s, bits=4, group_size=64)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32", "int8"])
def test_reference_blocks_are_jax_defaults(dtype):
    c = jax_default_config(dtype)
    assert quant._reference_blocks(getattr(torch, dtype)) == (
        c.block_m, c.block_n, c.block_k)


@pytest.mark.parametrize("m,n,k,dtype,want", [
    (64, 2048, 2048, torch.bfloat16, (512, 2048, 2048)),
    (4096, 2048, 2048, torch.bfloat16, (512, 1024, 1024)),
    (300, 256, 640, torch.float32, (512, 512, 512)),
    (129, 100, 96, torch.bfloat16, (512, 1024, 1024)),
])
def test_dequant_default_resolution(m, n, k, dtype, want):
    cfg = quant.dequant_config(m, n, k, dtype)
    assert (cfg.block_m, cfg.block_n, cfg.block_k) == want


@pytest.mark.parametrize("m,n,k,g,want", [
    (4096, 2048, 2048, None, (512, 1024, 2048)),
    (4096, 512, 2048, None, (512, 512, 2048)),
    (64, 100, 8192, None, (64, 128, 4096)),
    (64, 100, 8192, 256, (64, 128, 256)),
    (1, 1, 1, None, (32, 128, 1)),
])
def test_w8a8_default_resolution(m, n, k, g, want):
    cfg = quant.w8a8_resolve(m, n, k, g)
    assert (cfg.block_m, cfg.block_n, cfg.block_k) == want
    assert cfg.dtype == "int8" and cfg.out_dtype == "float32"


@pytest.mark.parametrize("g", [None, 64])
def test_matmul_w8a8_vs_jax(g):
    rng = _rng(10)
    w = rng.standard_normal((256, 128)).astype(np.float32)
    x = rng.standard_normal((32, 256)).astype(np.float32)
    wq, s = quantize_weights(w, bits=8, group_size=g)
    want = np.asarray(jquant.matmul_w8a8(jnp.asarray(x), jnp.asarray(wq),
                                         jnp.asarray(s), group_size=g,
                                         interpret=True))
    got = matmul_w8a8(_t(x), wq, s, group_size=g)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **W8)
    # The test_quant.py oracle: per-row quantized x times dequantized w
    # (exact for the two-pass route, which g = 64 takes: block_k 64 < 128).
    if g:
        xq, sx = jdq.quantize_activations(jnp.asarray(x))
        ref = (np.asarray(xq, np.float32) * np.asarray(sx)) @ dequantize_weights(
            wq, s, bits=8, group_size=g)
        np.testing.assert_allclose(got.numpy(), ref, **W8)


def test_quantize_activations_bytes_identical():
    rng = _rng(11)
    x = rng.standard_normal((40, 300)).astype(np.float32) * 3
    x[7] = 0.0
    x[9, 4] = 127.5 / 127 * np.abs(x[9]).max()   # a far outlier
    jq, js = jdq.quantize_activations(jnp.asarray(x))
    q, s = dequant.quantize_activations(_t(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert float(s[7, 0]) == 1.0 and not q[7].any()


def _fused_jax(x, wq, s, bk, g=None, fuse=True, m_block=32, n_block=128):
    cfg = jax_default_config("int8").replace(block_m=m_block, block_n=n_block,
                                             block_k=bk, out_dtype="float32",
                                             interpret=True)
    return np.asarray(jdq.w8a8_matmul(jnp.asarray(x), jnp.asarray(wq),
                                      jnp.asarray(s), cfg=cfg, group_size=g,
                                      interpret=True, fuse_quant=fuse))


def _port_w8a8(x, wq, s, bk, g=None, fuse=True, m_block=32, n_block=128):
    cfg = GemmConfig(dtype="int8", block_m=m_block, block_n=n_block,
                     block_k=bk, out_dtype="float32")
    return dequant.w8a8_matmul(_t(x), _t(wq), _t(s), cfg=cfg, group_size=g,
                               fuse_quant=fuse).numpy()


def test_w8a8_fused_multi_kblock_matches_blockwise_oracle():
    """Per-(row, K-block) activation scales at equal block_k: the JAX
    kernel, the port and test_quant.py's host oracle agree."""
    rng = _rng(12)
    m, k, n, bk = 32, 512, 128, 256
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    wq, s = quantize_weights(w, bits=8)
    got = _port_w8a8(x, wq, s, bk)
    ref = np.zeros((m, n), np.float32)
    wd = dequantize_weights(wq, s, bits=8)
    for b in range(k // bk):
        xt = x[:, b * bk:(b + 1) * bk]
        ax = np.abs(xt).max(axis=1, keepdims=True)
        sx = np.where(ax == 0, 0.0, ax / 127.0)
        r = np.where(ax == 0, 0.0, 127.0 / ax)
        ref += (np.clip(np.round(xt * r), -127, 127) * sx) @ wd[b * bk:(b + 1) * bk]
    np.testing.assert_allclose(got, ref, **W8)
    np.testing.assert_allclose(got, _fused_jax(x, wq, s, bk), **W8)


@pytest.mark.parametrize("route", ["fused", "fused_groupwise", "int_acc",
                                   "per_block_groupwise"])
def test_w8a8_routes_vs_jax_kernels(route):
    rng = _rng(13)
    m, k, n = 64, 512, 256
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[:, : k // 2] *= 50.0
    x[5] = 0.0                                     # a zero row
    g = 256 if "groupwise" in route else None
    wq, s = quantize_weights(w, bits=8, group_size=g)
    fuse = route.startswith("fused")
    bk = 256 if g or fuse else 128
    got = _port_w8a8(x, wq, s, bk, g=g, fuse=fuse, m_block=64, n_block=256)
    want = _fused_jax(x, wq, s, bk, g=g, fuse=fuse, m_block=64, n_block=256)
    np.testing.assert_allclose(got, want, **W8)
    assert np.isfinite(got).all() and not got[5].any()


def test_w8a8_fused_no_less_accurate_than_unfused():
    rng = _rng(14)
    m, k, n = 64, 1024, 256
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[:, : k // 2] *= 50.0
    wq, s = quantize_weights(w, bits=8)
    ref = x @ w
    errs = {fuse: np.abs(_port_w8a8(x, wq, s, 256, fuse=fuse, m_block=64,
                                    n_block=256) - ref).max() / np.abs(ref).max()
            for fuse in (True, False)}
    assert errs[True] <= errs[False] * 1.1, errs


def test_w8a8_fused_zero_rows_are_zero():
    rng = _rng(15)
    x = np.zeros((32, 256), np.float32)
    x[3] = rng.standard_normal(256)
    w = (rng.standard_normal((256, 128)) / 16).astype(np.float32)
    wq, s = quantize_weights(w, bits=8)
    got = _port_w8a8(x, wq, s, 128)
    assert np.isfinite(got).all()
    assert np.abs(got[0]).max() == 0 and np.abs(got[3]).max() > 0
    np.testing.assert_allclose(got, _fused_jax(x, wq, s, 128), **W8)


def test_w8a8_without_int_acc_past_the_int32_bound():
    # 127^2 K >= 2^31: the two-pass route scales per K-block in fp32.
    rng = _rng(16)
    m, n, k = 4, 16, 135168
    w = (rng.standard_normal((k, n)) / 64).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    wq, s = quantize_weights(w, bits=8)
    got = _port_w8a8(x, wq, s, 4096, fuse=False, n_block=128)
    want = _fused_jax(x, wq, s, 4096, fuse=False, n_block=128)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_w8a8_routing_rule_is_jax_s():
    # A 64-wide N tile is not a multiple of 128: the fused request takes the
    # two-pass route (per-row scales), as pallas_dequant.py:380-382 does.
    rng = _rng(17)
    w = rng.standard_normal((256, 64)).astype(np.float32)
    x = rng.standard_normal((16, 256)).astype(np.float32)
    x[:, :128] *= 20
    wq, s = quantize_weights(w, bits=8)
    got = matmul_w8a8(_t(x), wq, s)
    unfused = _port_w8a8(x, wq, s, 256, fuse=False)
    np.testing.assert_array_equal(got.numpy(), unfused)
    want = np.asarray(jquant.matmul_w8a8(jnp.asarray(x), jnp.asarray(wq),
                                         jnp.asarray(s), interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **W8)


def test_w8a8_rejects_mismatches():
    rng = _rng(18)
    w = rng.standard_normal((256, 128)).astype(np.float32)
    x = _t(rng.standard_normal((8, 256)).astype(np.float32))
    wq, s = quantize_weights(w, bits=8, group_size=64)
    with pytest.raises(ValueError, match="group_size == block_k"):
        dequant.w8a8_matmul(x, _t(wq), _t(s), cfg=GemmConfig(dtype="int8",
                            block_k=128), group_size=64)
    with pytest.raises(ValueError, match="int8"):
        matmul_w8a8(x, _t(wq).to(torch.int16), s, group_size=64)
    with pytest.raises(ValueError, match="multiple of block_k"):
        dequant.w8a8_matmul(x, _t(wq), _t(s), cfg=GemmConfig(dtype="int8",
                            block_k=96), group_size=64)
    with pytest.raises(ValueError, match="inconsistent"):
        matmul_w8a8(x, wq, s[:2], group_size=64)


def test_dequant_and_w8a8_bounds_arithmetic():
    from gemm_hls_tpu_torch.models.perf_model import H100, dequant_bound, w8a8_bound
    # Decode wq: 64x2048 bf16 x, 2048x2048 int4 (2 MB), 16x2048 fp32
    # scales, 64x2048 bf16 y; bytes bound at 3.35 TB/s.
    t, by = dequant_bound(H100, 64, 2048, 2048, 4, 128, torch.bfloat16, torch.bfloat16)
    moved = 64 * 2048 * 2 + 2048 * 2048 // 2 + 16 * 2048 * 4 + 64 * 2048 * 2
    assert by == "bytes" and t == pytest.approx(moved / 3.35e12)
    # Prefill projection: 2 * 4096 * 2048^2 int8 operations at 1979 TOP/s.
    t, by = w8a8_bound(H100, 4096, 2048, 2048, None, torch.bfloat16, torch.bfloat16)
    assert by == "operations" and t == pytest.approx(2 * 4096 * 2048 ** 2 / 1979e12)
    assert t * 1e6 == pytest.approx(17.36, abs=0.01)
