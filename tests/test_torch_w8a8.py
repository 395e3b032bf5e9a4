"""The W8A8 GEMMs' routing in the port (``ops/dequant.py``: kernels B14 /
B15 on the Hopper tile engine, ``csrc/w8a8_wgmma.cu``, or the mma.sync
tile, ``csrc/w8a8_gemm.cu``) on literal cases: the schedule the JAX rule
gives, the route by shape, the engine's N tile, and ``chip_smoke.py``'s
route table; then the port's plain version against the JAX kernels in
interpret mode at the block sizes each route takes, the mma.sync tile's
32-deep scale blocks included.

Nothing here launches a kernel: the CPU path is the plain version, and the
kernels run only on the card (``tests/test_torch_kernels.py``, which holds
both routes of every engine case in ``chip_smoke.W8A8_ROUTE_CASES`` to the
same bits).  Tolerance against JAX: ``tests/test_quant.py``'s absolute
1e-4 (the int8 values and int32 products are the JAX ones exactly; the
fp32 scaling differs in order only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gemm_hls_tpu.config import default_config as jax_default_config
from gemm_hls_tpu.ops import pallas_dequant as jdq
from gemm_hls_tpu_torch import GemmConfig, quantize_weights
from gemm_hls_tpu_torch.ops import dequant, quant

torch.set_num_threads(1)

W8 = dict(rtol=1e-4, atol=1e-4)
# The prefill's projections (B 4 x S 1024 tokens, d 2048, GQA 16 / 4 heads
# of 128): (M, K, N) of q, k, v and o.
PREFILL = {"q": (4096, 2048, 2048), "k": (4096, 2048, 512), "v": (4096, 2048, 512),
           "o": (4096, 2048, 2048)}
H100_SMS = 132


@pytest.mark.parametrize("n,k,bk,mode,aligned,want", [
    (2048, 2048, 2048, "fused", True, "wgmma"),      # the prefill's q / o, one scale block
    (512, 2048, 2048, "int_acc", True, "wgmma"),     # k / v on the two-pass route
    (2048, 2048, 512, "fused", True, "wgmma"),       # fused over 4 K-blocks
    (2048, 1024, 128, "fused", True, "wgmma"),       # group-wise g128 fused
    (2048, 1024, 256, "per_block", True, "wgmma"),   # group-wise g256 two-pass
    (144, 135168, 4096, "per_block", True, "wgmma"),  # past the int32 bound
    (2048, 1040, 1040, "int_acc", True, "wgmma"),    # a partial 128-deep step
    (2048, 1024, 64, "int_acc", True, "wgmma"),      # one int32 sum: block_k decides nothing
    (16, 16, 16, "int_acc", True, "wgmma"),          # the narrowest rows TMA takes
    (2048, 1000, 1000, "int_acc", True, "mma.sync"),  # K off 16 bytes
    (1000, 1024, 1024, "int_acc", True, "mma.sync"),  # N off 16 bytes
    (2048, 1024, 64, "per_block", True, "mma.sync"),  # bk off the 128-deep step
    (2048, 1024, 32, "per_block", True, "mma.sync"),  # the mma.sync tile's 32-deep fold
    (2048, 2048, 2048, "fused", False, "mma.sync"),   # a base off 16 bytes
    (512, 2048, 2048, "int_acc", False, "mma.sync"),
])
def test_w8a8_route(n, k, bk, mode, aligned, want):
    assert dequant.w8a8_route(n, k, bk, mode, aligned) == want


def _cfg(m, n, k, g=None, bk=None):
    return quant.w8a8_resolve(m, n, k, g, torch.bfloat16,
                              GemmConfig(block_k=bk) if bk else None)


@pytest.mark.parametrize("m,n,k,g,bk,fuse,want", [
    # The prefill: matmul_w8a8's default blocks keep the fused route.
    (4096, 2048, 2048, None, None, True, (True, "fused", 2048)),
    (4096, 512, 2048, None, None, True, (True, "fused", 2048)),
    (4096, 2048, 2048, None, None, False, (False, "int_acc", 2048)),
    (130, 2048, 2048, None, 512, True, (True, "fused", 512)),
    (64, 512, 1024, 128, None, True, (True, "fused", 128)),
    # The JAX rule sends a fused request to the two-pass route: an N tile
    # (1000), K (1040) or block_k (64) off 128, a strip over 8 Mi elements.
    (130, 1000, 1024, None, None, True, (False, "int_acc", 1024)),
    (64, 512, 1040, None, None, True, (False, "int_acc", 1040)),
    (64, 512, 1024, 64, None, True, (False, "per_block", 64)),
    (4096, 256, 32768, None, None, True, (False, "int_acc", 4096)),
    # Per-block scales on the two-pass route: group-wise, or 127^2 K >= 2^31.
    (130, 2048, 1024, 256, None, False, (False, "per_block", 256)),
    (8, 144, 135168, None, None, False, (False, "per_block", 4096)),
    (130, 256, 512, 32, None, False, (False, "per_block", 32)),
])
def test_w8a8_schedule(m, n, k, g, bk, fuse, want):
    cfg = _cfg(m, n, k, g, bk)
    assert dequant.w8a8_schedule(m, n, k, cfg, k // (g or k), fuse) == want


@pytest.mark.parametrize("m,n,k,bk,mode,want", [
    (4096, 2048, 2048, 2048, "fused", 128),     # q / o: 16 x 16 = 256 tiles
    (4096, 2048, 2048, 2048, "int_acc", 128),
    (4096, 512, 2048, 2048, "fused", 64),       # k / v: 16 x 4 at 128, 16 x 8 at 64
    (4096, 512, 2048, 2048, "int_acc", 64),
    (2200, 2048, 1024, 1024, "fused", 128),     # 9 x 16 = 144 tiles
    (2048, 2048, 1024, 1024, "fused", 64),      # 8 x 16 = 128: under a wave
    (64, 2048, 2048, 2048, "int_acc", 64),
    (4096, 2048, 2048, 512, "fused", 64),       # scale blocks inside K: 32 + 32 registers
    (4096, 2048, 2048, 128, "per_block", 64),
])
def test_w8a8_engine_plan(m, n, k, bk, mode, want):
    assert dequant.w8a8_engine_plan(m, n, k, bk, mode, H100_SMS) == want


@pytest.mark.parametrize("proj", sorted(PREFILL))
@pytest.mark.parametrize("fuse", [True, False])
def test_w8a8_prefill_fills_the_card(proj, fuse):
    # Each prefill projection on the engine, on at least 128 of the H100's
    # 132 SMs (one block a SM).
    m, k, n = PREFILL[proj]
    fused, mode, bk = dequant.w8a8_schedule(m, n, k, _cfg(m, n, k), 1, fuse)
    assert fused == fuse
    assert dequant.w8a8_route(n, k, bk, mode, True) == "wgmma"
    bn = dequant.w8a8_engine_plan(m, n, k, bk, mode, H100_SMS)
    blocks = -(-m // dequant.W8A8_ENGINE_BM) * -(-n // bn)
    assert blocks >= 128


def test_w8a8_card_table_takes_the_routes_it_names():
    # chip_smoke.py's W8A8 route table (phase 16 and the card tests): the
    # route each case asserts is w8a8_route's, and between them the cases
    # hold every mode and both N tiles on the engine, and both reasons for
    # mma.sync.
    on_engine, tiles, off = set(), set(), set()
    for case in chip_smoke.W8A8_ROUTE_CASES:
        _, g, m, n, k, *_ = case
        cfg, fused, mode, bk, route = chip_smoke.w8a8_route_plan(case)
        assert route == case[-1], case
        assert k % min(cfg.block_k, k) == 0 and k % (g or k) == 0, case
        if route == "wgmma":
            on_engine.add(mode)
            tiles.add(dequant.w8a8_engine_plan(m, n, k, bk, mode, H100_SMS))
        else:
            off.add("rows" if k % 16 or n % 16 else f"bk {bk}")
    assert on_engine == {"fused", "int_acc", "per_block"}
    assert tiles == set(dequant.W8A8_ENGINE_BN)
    assert off == {"rows", "bk 64", "bk 32"}
    assert chip_smoke.W8A8_REPEAT_CASE[-1] == "wgmma"


def test_plain_w8a8_leaves_the_routes_alone():
    dequant.w8a8_matmul.last_route = None
    dequant.w8a8_matmul.routes = {}
    wq, s = quantize_weights(np.random.default_rng(3).standard_normal((256, 128))
                             .astype(np.float32), bits=8)
    dequant.w8a8_matmul(torch.ones(4, 256), torch.from_numpy(wq), torch.from_numpy(s),
                        cfg=_cfg(4, 128, 256))
    assert dequant.w8a8_matmul.last_route is None and dequant.w8a8_matmul.routes == {}


def _jax_w8a8(x, wq, s, bk, g, fuse, m_block, n_block):
    cfg = jax_default_config("int8").replace(block_m=m_block, block_n=n_block, block_k=bk,
                                             out_dtype="float32", interpret=True)
    return np.asarray(jdq.w8a8_matmul(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(s),
                                      cfg=cfg, group_size=g, interpret=True, fuse_quant=fuse))


@pytest.mark.parametrize("g,bk,fuse,mode", [
    (None, 256, True, "fused"),      # one scale block: the engine's int32 sum
    (None, 128, True, "fused"),      # two K-blocks, whole engine steps
    (128, 128, True, "fused"),       # group-wise on the engine
    (None, 256, False, "int_acc"),
    (128, 128, False, "per_block"),
    (64, 64, False, "per_block"),    # on mma.sync
    (32, 32, False, "per_block"),    # mma.sync's 32-deep fold
])
def test_w8a8_plain_vs_jax_at_each_routes_blocks(g, bk, fuse, mode):
    rng = np.random.default_rng(17)
    m, k, n = 40, 256, 128
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[:, : k // 2] *= 20.0
    x[7] = 0.0
    wq, s = quantize_weights(w, bits=8, group_size=g)
    cfg = GemmConfig(dtype="int8", block_m=32, block_n=128, block_k=bk, out_dtype="float32")
    assert dequant.w8a8_schedule(m, n, k, cfg, k // (g or k), fuse) == (fuse, mode, bk)
    got = dequant.w8a8_matmul(torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(s),
                              cfg=cfg, group_size=g, fuse_quant=fuse).numpy()
    want = _jax_w8a8(x, wq, s, bk, g, fuse, 32, 128)
    np.testing.assert_allclose(got, want, **W8)
    assert not got[7].any()
