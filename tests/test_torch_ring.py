"""The port's ring GEMM (``gemm_hls_tpu_torch.parallel.ring_matmul``, the
plain schedule of kernel B18 on CPU ranks) against the JAX package's
``ring_matmul`` on the conftest's virtual 8-device mesh in interpret mode,
on the same numpy inputs; the port's meshes against JAX's.

Tolerances: int8 exact (both sides sum the integer products exactly:
int32 here, float32 below 2^24 there); float32 relative 1e-5 (the same
per-step products, summed in another order); bfloat16 inputs relative 1e-3
(the port's contract; both sum the exact products in fp32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from gemm_hls_tpu.ops.pallas_ring import ring_matmul as jax_ring_matmul
from gemm_hls_tpu.ops.pallas_ring import shard_operands_ring as jax_shard
from gemm_hls_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gemm_hls_tpu.parallel.mesh import mesh_25d as jax_mesh_25d
from gemm_hls_tpu_torch.parallel import (
    Mesh,
    make_mesh,
    mesh_25d,
    ring_matmul,
    shard_operands_ring,
)
from gemm_hls_tpu_torch.ops.cannon import cannon_spin_ms
from gemm_hls_tpu_torch.ops.ring import ring_spin_ms, spin_budget_ms
from gemm_hls_tpu_torch.utils import make_operands

RTOL = {"float32": 1e-5, "bfloat16": 1e-3, "int8": 0.0}


def operands(m, n, k, dtype, seed):
    """Seeded numpy operands: U(1, 10) floats (cast to bf16 on both sides
    from the same float32), int8 in [-8, 8]."""
    if dtype == "int8":
        a, b = make_operands(m, n, k, "int32", seed=seed, low=-8, high=8)
        return a.astype(np.int8), b.astype(np.int8)
    return make_operands(m, n, k, "float32", seed=seed)


def jax_ring(a, b, n, dtype, block_k=None, perm=None):
    devs = np.array(jax.devices()[:n])
    if perm is not None:
        devs = devs[perm]
    mesh = JaxMesh(devs.reshape(n), ("x",))
    a_s, b_s = jax_shard(jnp.asarray(a, jnp.dtype(dtype)), jnp.asarray(b, jnp.dtype(dtype)), mesh)
    return np.asarray(jax_ring_matmul(a_s, b_s, mesh, block_k=block_k))


def torch_ring(a, b, n, dtype, block_k=None):
    mesh = make_mesh((n,), ("x",), devices=["cpu"] * n)
    dt = getattr(torch, dtype)
    out = ring_matmul(torch.from_numpy(a).to(dt), torch.from_numpy(b).to(dt), mesh,
                      block_k=block_k)
    return torch.cat(out).numpy()


def agree(got, want, dtype):
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    if RTOL[dtype] == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL[dtype], atol=0)


# (ranks, dtype, block_k, permuted JAX mesh): every ring size in the three
# types, block_k 64 and 128 (the tiled body), permuted meshes (the port's
# ring order is the mesh order, as JAX's logical order is).
CASES = ([(n, dt, None, False) for n in (1, 2, 4, 8) for dt in RTOL]
         + [(4, dt, bk, False) for dt in RTOL for bk in (64, 128)]
         + [(8, "float32", 64, True), (4, "bfloat16", None, True), (2, "int8", 128, True)])


@pytest.mark.parametrize("n,dtype,block_k,permute", CASES)
def test_ring_matmul_vs_jax(n, dtype, block_k, permute):
    a, b = operands(12 * n, 24 * n, 256, dtype, seed=300 + n)
    perm = np.random.default_rng(n).permutation(n) if permute else None
    agree(torch_ring(a, b, n, dtype, block_k), jax_ring(a, b, n, dtype, block_k, perm), dtype)


def test_ring_output_sharding():
    # JAX returns P("x", None): row shards with full N.  The port returns
    # the n row shards (M/n, N) in ring order, each on its rank's device.
    mesh = make_mesh((4,), ("x",), devices=["cpu"] * 4)
    a, b = (torch.from_numpy(t) for t in make_operands(16, 32, 24, "float32"))
    out = ring_matmul(a, b, mesh)
    assert len(out) == 4
    full = a.double() @ b.double()
    for r, shard in enumerate(out):
        assert tuple(shard.shape) == (4, 32) and shard.device.type == "cpu"
        np.testing.assert_allclose(shard.double().numpy(), full[4 * r:4 * (r + 1)].numpy(),
                                   rtol=1e-5)


def test_ring_takes_shard_lists():
    mesh = make_mesh((4,), ("x",), devices=["cpu"] * 4)
    a, b = (torch.from_numpy(t) for t in make_operands(16, 32, 64, "float32", seed=9))
    a_s, b_s = shard_operands_ring(a, b, mesh)
    assert [tuple(t.shape) for t in a_s] == [(4, 64)] * 4
    assert [tuple(t.shape) for t in b_s] == [(64, 8)] * 4
    torch.testing.assert_close(torch.cat(b_s, dim=1), b, rtol=0, atol=0)
    got = torch.cat(ring_matmul(a_s, b_s, mesh, block_k=32))
    torch.testing.assert_close(got, torch.cat(ring_matmul(a, b, mesh)), rtol=0, atol=0)


def test_ring_rejects_indivisible():
    mesh = make_mesh((4,), ("x",), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="not divisible"):
        ring_matmul(torch.zeros((10, 8)), torch.zeros((8, 16)), mesh)


def test_tiled_ring_rejects_bad_block_k():
    mesh = make_mesh((2,), ("x",), devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="divisible by block_k"):
        ring_matmul(torch.zeros((8, 100)), torch.zeros((100, 16)), mesh, block_k=30)


def test_block_k_64_is_accepted():
    # JAX's compiled mode refuses block_k % 128 (an HBM slice on the TPU's
    # lane dimension, pallas_ring.py:243-247); that rule comes from the
    # TPU's (8, 128) tiling and is not ported, whatever ``interpret`` says.
    a, b = operands(16, 32, 128, "float32", seed=11)
    got = torch_ring(a, b, 2, "float32", block_k=64)
    mesh = make_mesh((2,), ("x",), devices=["cpu"] * 2)
    again = torch.cat(ring_matmul(torch.from_numpy(a), torch.from_numpy(b), mesh,
                                  block_k=64, interpret=False)).numpy()
    np.testing.assert_array_equal(got, again)
    agree(got, jax_ring(a, b, 2, "float32", block_k=64), "float32")


def test_ranks_on_two_cards_raise_before_any_cuda_call():
    # Ranks on distinct cards need the multi-card transport (ROADMAP A7);
    # the check reads the device names only, so it runs without a card.
    mesh = Mesh([torch.device("cuda", 0), torch.device("cuda", 1)], ("x",))
    with pytest.raises(NotImplementedError, match="A7"):
        ring_matmul(torch.zeros((4, 4)), torch.zeros((4, 4)), mesh)


def test_mesh_mixing_cpu_and_cuda_raises():
    mesh = Mesh(["cpu", "cuda:0"], ("x",))
    with pytest.raises(ValueError, match="mixes"):
        ring_matmul(torch.zeros((4, 4)), torch.zeros((4, 4)), mesh)


@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_shapes_match_jax(n):
    jm = jax_make_mesh(devices=jax.devices()[:n])
    tm = make_mesh(devices=["cpu"] * n)
    assert tm.devices.shape == jm.devices.shape
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.shape == dict(jm.shape)
    jm1, tm1 = (jax_make_mesh((n,), ("x",), devices=jax.devices()[:n]),
                make_mesh((n,), ("x",), devices=["cpu"] * n))
    assert tm1.shape == dict(jm1.shape) == {"x": n}


@pytest.mark.parametrize("n", range(1, 9))
@pytest.mark.parametrize("c", [1, 2])
def test_mesh_25d_shapes_match_jax(n, c):
    try:
        jm = jax_mesh_25d(c, devices=jax.devices()[:n])
    except ValueError as exc:
        with pytest.raises(ValueError, match="not divisible"):
            mesh_25d(c, devices=["cpu"] * n)
        assert "not divisible" in str(exc)
        return
    tm = mesh_25d(c, devices=["cpu"] * n)
    assert tm.devices.shape == jm.devices.shape and tm.shape == dict(jm.shape)


def test_make_mesh_needs_devices_or_a_card():
    # No CPU fallback: without ``devices`` the mesh is over the visible
    # cards, and with none it raises.
    if torch.cuda.is_available():
        mesh = make_mesh((1,), ("x",))
        assert mesh.devices.flat[0].type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def test_mesh_too_small_raises():
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh((2, 2), devices=["cpu"] * 3)


def test_spin_budget_arithmetic():
    # A flag wait traps past its budget (csrc/rank_sync.cuh): 4 s plus four
    # times the whole launch at the floor rates (1e12 fp32 / 1e13 bf16 and
    # int8 operations a second, 1e9 bytes a second for one sender block).
    assert spin_budget_ms(0, 0, torch.bfloat16) == 4000
    assert spin_budget_ms(1e13, 0, torch.bfloat16) == 8000
    assert spin_budget_ms(1e12, 0, torch.float32) == 8000
    assert spin_budget_ms(0, 1e9, torch.int8) == 8000
    assert spin_budget_ms(1e30, 0, torch.float32) == 2 ** 31 - 1
    # The headline ring, bf16 8192^3 over 4 ranks: 1.1 TFLOP and 4 x 32 MiB
    # staged and forwarded by each rank.
    assert ring_spin_ms(4, 2048, 2048, 8192, torch.bfloat16) == int(
        (4 + 4 * (2 * 8192 ** 3 / 1e13 + 4 * 2048 * 8192 * 2 / 1e9)) * 1e3)
    assert cannon_spin_ms(2, 4096, 4096, 4096, torch.bfloat16) == int(
        (4 + 4 * (2 * 8192 ** 3 / 1e13 + 2 * 8192 * 4096 * 2 / 1e9)) * 1e3)


def test_spin_budget_outlasts_a_long_step():
    # An fp32 ring of 3 ranks at 49152^3 on the CUDA cores: one step is
    # 2 M N K / 3 = 79 TFLOP, several seconds even at the fp32 peak, where a
    # fixed budget of a few seconds would trap a correct launch.  The budget
    # outlasts the whole launch (all three steps) at a tenth of the fp32 peak.
    m = 49152
    budget_s = ring_spin_ms(3, m // 3, m // 3, m, torch.float32) / 1e3
    assert budget_s > 2 * m ** 3 / 6.7e12
    assert budget_s > ring_spin_ms(3, 1024, 1024, 3072, torch.float32) / 1e3 > 4


# ---- the wrapper's pure-Python choices (the card runs what they decide) ----

@pytest.mark.parametrize("dtype,k,route", [
    ("float32", 64, "simt"), ("float32", 90, "simt"),
    ("bfloat16", 96, "wgmma"), ("bfloat16", 8, "wgmma"), ("bfloat16", 8192, "wgmma"),
    ("bfloat16", 100, "mma.sync"), ("bfloat16", 33, "mma.sync"),
    ("int8", 64, "wgmma"), ("int8", 16, "wgmma"), ("int8", 72, "mma.sync"),
    ("int8", 200, "mma.sync")])
def test_route_by_shape(dtype, k, route):
    # The Hopper tile engine's TMA maps need K rows of whole 16-byte units.
    from gemm_hls_tpu_torch.ops.ring import ring_route
    assert ring_route(getattr(torch, dtype), k) == route


def test_card_tables_reach_both_routes():
    # chip_smoke's tables (also the card tests' parameters) put bf16 and
    # int8 on both routes, the engine with M and N off its 128 x 256 tile,
    # capped blocks on the engine, and the same-bits repeat on the engine.
    import chip_smoke
    from gemm_hls_tpu_torch.ops.ring import WG_TILE, ring_route

    def route(case):
        return ring_route(getattr(torch, case[1]), case[4])

    for dt in ("bfloat16", "int8"):
        rows = [c for c in chip_smoke.RING_CASES if c[1] == dt]
        assert any(route(c) == "mma.sync" for c in rows)
        assert any(route(c) == "wgmma" and c[2] % WG_TILE[0] and c[3] % WG_TILE[1]
                   for c in rows)
        assert any(route(c) == "wgmma" and c[7] == 3 for c in rows)
    assert route(chip_smoke.RING_REPEAT_CASE) == "wgmma"
    cannon_routes = {(c[1], ring_route(getattr(torch, c[1]), c[4] // c[0]))
                     for c in chip_smoke.CANNON_CASES}
    assert {("bfloat16", "wgmma"), ("bfloat16", "mma.sync"), ("int8", "wgmma"),
            ("int8", "mma.sync")} <= cannon_routes
    assert {(c[0], c[7]) for c in chip_smoke.CANNON_CASES} >= {(2, "bfloat16"),
                                                               (3, "bfloat16")}


@pytest.mark.parametrize("rows,cols,esize", [(2048, 8192, 2), (300, 320, 2), (1, 1, 1),
                                             (50, 100, 2), (33, 90, 4), (130, 256, 1)])
def test_slot_starts_are_aligned(rows, cols, esize):
    # Each ring-buffer slot starts on 256 bytes (the bulk copies' and TMA
    # maps' 16-byte bases) and holds the whole block.
    from gemm_hls_tpu_torch.ops.ring import slot_elems
    slot = slot_elems(rows, cols, esize)
    assert slot * esize % 256 == 0
    assert 0 <= slot - rows * cols < 256 // esize


def test_send_blocks_sizing():
    # The sender blocks of a rank: the share that forwards a step's bytes
    # in the time the rest take for its operations; none for one rank.
    from gemm_hls_tpu_torch.ops.ring import send_blocks
    bf16, s = torch.bfloat16, 8192
    assert send_blocks(132, 2.0 * s ** 3, 0.0, bf16) == 0
    # The headline ring (bf16 8192^3) at 4 and 8 ranks, Cannon at p = 2.
    assert send_blocks(33, 2.0 * 2048 * 2048 * s, 2048 * s * 2.0, bf16) == 2
    assert send_blocks(16, 2.0 * 1024 * 1024 * s, 1024 * s * 2.0, bf16) == 2
    assert send_blocks(33, 2.0 * 4096 ** 3, 2 * 4096 * 4096 * 2.0, bf16) == 2
    # Small blocks are mostly bytes: most blocks forward.
    assert 16 < send_blocks(33, 2.0 * 64 * 64 * 256, 64 * 256 * 2.0, bf16) < 33
    # At least one, at most all but one, and more bytes never fewer blocks.
    counts = [send_blocks(16, 1e10, b, torch.int8) for b in (1e3, 1e6, 1e8, 1e10, 1e12)]
    assert counts == sorted(counts) and counts[0] == 1 and counts[-1] == 15


def test_stamp_words_and_buffer_checks():
    from gemm_hls_tpu_torch.ops.ring import check_stamps, stamp_words
    assert stamp_words(4) == 16 and stamp_words(1) == 7
    dev = torch.device("cpu")
    assert check_stamps(None, 4, 4, dev) == 0
    st = torch.full((4 * stamp_words(4),), 7, dtype=torch.int64)
    assert check_stamps(st, 4, 4, dev) == st.data_ptr() and not st.any()
    with pytest.raises(ValueError, match="int64"):
        check_stamps(torch.zeros(10, dtype=torch.int64), 4, 4, dev)
    with pytest.raises(ValueError, match="int64"):
        check_stamps(torch.zeros(64, dtype=torch.int32), 4, 4, dev)
