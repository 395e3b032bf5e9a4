"""B1 / B2 on the tile engine at any layout and alignment: the pack pass
(``ops/mxu.py::pack_operand``, ``csrc/operand_pack.cu``) and the route
rule that sends every bf16 / fp16 / int8 / fp32 plus_times call to the
engine, on the CPU.

* ``pack_operand_plain``'s workspace against an independent numpy
  construction, bit for bit, over chip_smoke.py's ``PACK_CASES`` (every
  holding, pitch, base offset and broadcast batch; the card holds the
  kernel to the same plain version there).
* ``packed_matmul_plain`` (the engine route's function on packed
  operands) against the JAX package's ``pallas_mxu.mxu_matmul`` /
  ``mxu_matmul_batched`` in interpret mode at small unaligned shapes:
  bf16 and fp16 at rel 1e-3 (scaled by the largest value), int8 exact.
* ``tf32_operand_plain`` of an unaligned view against that of its
  contiguous copy, bit for bit.
* ``named_route`` keeps "wmma" / "simt" on unaligned operands, and the
  tuner's rule, the front door's and ``route_config`` agree on them.
* The tile walk's shared-memory layout (``csrc/operand_tile.cuh``: the
  register turn of an operand held (K, rows), the swizzled columns)
  emulated: each warp step in 32 banks, each word read back in place.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gemm_hls_tpu import GemmConfig as JaxConfig
from gemm_hls_tpu.ops import pallas_mxu

from gemm_hls_tpu_torch.config import (
    call_route, default_config, named_route, pack_bytes, packed_operands, route_config,
)
from gemm_hls_tpu_torch.ops import mxu
from gemm_hls_tpu_torch.tools import autotune

torch.set_num_threads(1)

LAYOUTS = chip_smoke.LAYOUTS
_BITS = {"bfloat16": (np.int16, torch.bfloat16), "float16": (np.int16, torch.float16),
         "int8": (np.int8, torch.int8)}


def _held(case, seed=0):
    """(numpy storage bits, torch view) of a PACK_CASES case on the CPU:
    random bits held (rows, K), or (K, rows) with mn_major, in rows ``pad``
    elements longer, ``offset`` in; a broadcast batch a stride of 0."""
    dt, mn, bsz, rows, k, pad, off, bcast = case
    np_bits, tdt = _BITS[dt]
    held = (k, rows) if mn else (rows, k)
    lead = () if bsz is None else (1 if bcast else bsz,)
    info = np.iinfo(np_bits)
    store = np.random.default_rng(seed).integers(
        info.min, info.max + 1, (*lead, held[0], held[1] + pad + off)).astype(np_bits)
    view = store[..., off:off + held[1]]
    x = torch.from_numpy(store).view(tdt)[..., off:off + held[1]]
    if bcast:
        view = np.broadcast_to(view, (bsz, *held))
        x = x.expand(bsz, *held)
    return view, x


def _numpy_workspace(view, mn, k, esize, broadcast):
    """The K-major workspace built with numpy alone: each example turned
    (rows, K), K padded with zeros to whole 16-byte units, a broadcast (or
    one-example) batch once."""
    w = np.swapaxes(view, -1, -2) if mn else view
    kp = -(-k // (16 // esize)) * (16 // esize)
    out = np.zeros(w.shape[:-1] + (kp,), dtype=w.dtype)
    out[..., :k] = w
    if out.ndim == 3 and (broadcast or out.shape[0] == 1):
        out = out[0]
    return out


@pytest.mark.parametrize("case", chip_smoke.PACK_CASES, ids=str)
def test_plain_pack_is_the_numpy_workspace(case):
    dt, mn, bsz, rows, k, pad, off, bcast = case
    view, x = _held(case, seed=len(str(case)))
    got = mxu.pack_operand_plain(x, mn)
    want = _numpy_workspace(view, mn, k, x.element_size(), bcast)
    assert got.is_contiguous() and tuple(got.shape) == want.shape
    np_bits = _BITS[dt][0]
    np.testing.assert_array_equal(got.view(torch.int16 if np_bits is np.int16 else torch.int8)
                                  .numpy(), want)
    # The workspace's rows are whole 16-byte units: the engine reads it in place.
    assert mxu._vec_ok(got)


@pytest.mark.parametrize("dt", ["float32", "int32", "float64"])
def test_pack_refuses_other_types_and_the_cpu(dt):
    x = torch.zeros((4, 5), dtype=getattr(torch, dt))
    with pytest.raises(TypeError, match="bfloat16, float16 or int8"):
        mxu.pack_operand_plain(x, False)
    with pytest.raises(TypeError, match="bfloat16, float16 or int8"):
        mxu.pack_operand(x, False)
    with pytest.raises(ValueError, match="runs on the card"):
        mxu.pack_operand(torch.zeros((4, 5), dtype=torch.bfloat16), True)


# ---- the engine route on packed operands against JAX --------------------

def _operand(rng, shape, dt, pitch_pad=0, offset=0):
    """U(-1, 1) (integers in [-20, 20] for int8) as numpy, and the same
    values as a torch view into rows ``pitch_pad`` longer, ``offset`` in
    (the view's base and pitch off the 16-byte grid)."""
    if dt == "int8":
        vals = rng.integers(-20, 21, shape).astype(np.int8)
    else:
        vals = rng.uniform(-1, 1, shape).astype(np.float32)
    lead, (r, c) = shape[:-2], shape[-2:]
    store = np.zeros((*lead, r, c + pitch_pad + offset), dtype=vals.dtype)
    store[..., offset:offset + c] = vals
    x = torch.from_numpy(store)[..., offset:offset + c].to(getattr(torch, dt)) \
        if dt == "int8" else torch.from_numpy(store).to(getattr(torch, dt))[..., offset:offset + c]
    return vals, x


def _jax_b1(a, b, dt, out, ta, tb):
    cfg = JaxConfig(dtype=dt, out_dtype=out, block_m=16, block_n=128, block_k=64,
                    interpret=True)
    return np.asarray(pallas_mxu.mxu_matmul(jnp.asarray(a, dt), jnp.asarray(b, dt), cfg=cfg,
                                            transpose_a=ta, transpose_b=tb, interpret=True))


def _jax_b2(a, b, dt, out, ta, tb):
    cfg = JaxConfig(dtype=dt, out_dtype=out, interpret=True)
    return np.asarray(pallas_mxu.mxu_matmul_batched(
        jnp.asarray(a, dt), jnp.asarray(b, dt), cfg=cfg, transpose_a=ta, transpose_b=tb,
        interpret=True))


def _agree(got, want, dt):
    got = got.float().numpy() if got.is_floating_point() else got.numpy()
    if dt == "int8":
        np.testing.assert_array_equal(got, want.astype(got.dtype))
    else:
        want = want.astype(np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())


@pytest.mark.parametrize("dt,out", [("bfloat16", "float32"), ("float16", "float32"),
                                    ("int8", "int32")])
@pytest.mark.parametrize("ta,tb", LAYOUTS)
@pytest.mark.parametrize("m,n,k,pad,off", [(65, 140, 131, 0, 0), (33, 24, 40, 1, 1),
                                           (7, 13, 5, 2, 0)])
def test_packed_engine_route_vs_jax(dt, out, ta, tb, m, n, k, pad, off):
    rng = np.random.default_rng(m * n + k)
    a_np, a = _operand(rng, (k, m) if ta else (m, k), dt, pad, off)
    b_np, b = _operand(rng, (n, k) if tb else (k, n), dt, pad, off)
    packs = packed_operands(a.dtype, ta, tb, mxu._vec_ok(a), mxu._vec_ok(b))
    # Every case packs something: unaligned rows, or int8 not K-major.
    assert any(packs)
    cfg = default_config(dt, out_dtype=out)
    got = mxu.packed_matmul_plain(a, b, cfg=cfg, transpose_a=ta, transpose_b=tb)
    _agree(got, _jax_b1(a_np, b_np, dt, out, ta, tb), dt)
    # The plain version of the call as it stands, bit for bit.
    assert torch.equal(got, mxu.mxu_matmul_plain(a, b, cfg=cfg, transpose_a=ta,
                                                 transpose_b=tb))


@pytest.mark.parametrize("dt,out", [("bfloat16", "float32"), ("int8", "int32")])
@pytest.mark.parametrize("ta,tb", LAYOUTS)
def test_packed_engine_route_batched_vs_jax(dt, out, ta, tb):
    bsz, m, n, k = 3, 33, 40, 21
    rng = np.random.default_rng(11)
    a_np, a = _operand(rng, (bsz, k, m) if ta else (bsz, m, k), dt, 1, 0)
    b_np, b = _operand(rng, (bsz, n, k) if tb else (bsz, k, n), dt, 0, 1)
    assert any(packed_operands(a.dtype, ta, tb, mxu._vec_ok(a), mxu._vec_ok(b)))
    cfg = default_config(dt, out_dtype=out)
    got = mxu.packed_matmul_plain(a, b, cfg=cfg, transpose_a=ta, transpose_b=tb)
    _agree(got, _jax_b2(a_np, b_np, dt, out, ta, tb), dt)


def test_packed_engine_route_broadcast_operand():
    # A 2-D b broadcast over the batch (read with a stride of 0) is packed
    # once, 2-D.
    rng = np.random.default_rng(3)
    a_np, a = _operand(rng, (4, 20, 30), "int8")
    b_np, b = _operand(rng, (30, 50), "int8", 2, 1)
    bb = b.expand(4, 30, 50)
    assert mxu.pack_operand_plain(bb, True).shape == (50, 32)
    cfg = default_config("int8", out_dtype="int32")
    got = mxu.packed_matmul_plain(a, bb, cfg=cfg)
    want = np.einsum("zmk,kn->zmn", a_np.astype(np.int64), b_np.astype(np.int64))
    np.testing.assert_array_equal(got.numpy(), want)


# ---- fp32: the split pass reads any pitch -------------------------------

@pytest.mark.parametrize("mn", [False, True])
@pytest.mark.parametrize("passes,side", [(1, "a"), (3, "a"), (3, "b")])
@pytest.mark.parametrize("batched", [False, True])
def test_tf32_workspace_of_an_unaligned_view_is_its_copys(mn, passes, side, batched):
    rng = np.random.default_rng(5)
    lead = (3,) if batched else ()
    store = torch.from_numpy(rng.uniform(-1, 1, (*lead, 37, 67 + 2)).astype(np.float32))
    store[..., 0, 1] = float("inf")
    store[..., 3, 4] = float("nan")
    view = store[..., 1:68]  # base 4 bytes in, rows of 69 values
    assert not mxu._vec_ok(view)
    got = mxu.tf32_operand_plain(view, mn, passes, side)
    want = mxu.tf32_operand_plain(view.contiguous(), mn, passes, side)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ---- the route rule and its readers -------------------------------------

@pytest.mark.parametrize("dt,route", [("bfloat16", "wmma"), ("float16", "wmma"),
                                      ("int8", "wmma"), ("float32", "simt")])
@pytest.mark.parametrize("ta,tb", LAYOUTS)
def test_named_route_keeps_the_old_kernels_on_unaligned_operands(dt, route, ta, tb):
    # The rule gives the engine; a caller may still name the WMMA tile (or
    # the CUDA cores for fp32) on any operands: a tuned winner, a comparison.
    a = torch.zeros((40, 61), dtype=getattr(torch, dt))  # rows off 16 bytes
    assert not mxu._vec_ok(a)
    rule = mxu.mxu_route(a.dtype)
    assert rule == "wgmma"
    assert named_route(route, rule, "B1", a.dtype) == route
    assert named_route(None, rule, "B1", a.dtype) == "wgmma"
    with pytest.raises(ValueError, match="cannot run"):
        named_route("dmma", rule, "B1", a.dtype)


def test_fp32_into_float64_stays_on_the_cuda_cores():
    assert call_route("float32", "plus_times", "float64") == "simt"
    assert mxu.mxu_route(torch.float32, torch.float64) == "simt"
    with pytest.raises(ValueError, match="cannot run"):
        named_route("wgmma", "simt", "B1", torch.float32)


@pytest.mark.parametrize("dt,layout,shape", [
    ("bfloat16", "nn", (1000, 1030, 999)),   # K off 16 bytes: A packed
    ("bfloat16", "tn", (1001, 1024, 1024)),  # A held (K, M), M off: packed
    ("int8", "nn", (512, 512, 512)),         # B held (K, N): packed
    ("float16", "tt", (640, 99, 256)),
    ("float32", "nn", (1000, 1030, 999)),    # split, any pitch
])
def test_tuner_and_front_door_agree_on_an_unaligned_call(dt, layout, shape):
    m, n, k = shape
    ta, tb = layout[0] == "t", layout[1] == "t"
    a = torch.zeros((k, m) if ta else (m, k), dtype=getattr(torch, dt))
    b = torch.zeros((n, k) if tb else (k, n), dtype=getattr(torch, dt))
    # One rule, read by the front door, the tuner and route_config alike,
    # from the type alone.
    front = mxu.mxu_route(a.dtype)
    tuner = autotune._dense_rule(dt, "plus_times")
    assert front == tuner == call_route(dt, "plus_times") == "wgmma"
    assert route_config(dt, transpose_a=ta, transpose_b=tb).route() == "wgmma"
    # The tuner times the engine against the kernel beside it.
    cands = autotune.candidate_configs(m, n, k, dt, "plus_times", layout=layout)
    assert [autotune._MXU_ROUTE[c.route()] for c in cands] == [
        "wgmma", "simt" if dt == "float32" else "wmma"]
    # The model charges the pack pass's bytes where the launch packs.
    packs = packed_operands(dt, ta, tb, mxu._vec_ok(a), mxu._vec_ok(b))
    assert (pack_bytes(dt, m, n, k, ta, tb) > 0) == any(packs)


# ---- the tile walk's shared-memory layout (csrc/operand_tile.cuh) ---------

def _byte_perm(x, y, s):
    """CUDA's ``__byte_perm``: byte i of the result is byte (s >> 4 i) & 7
    of y:x (x the low four)."""
    both = x | (y << 32)
    return sum(((both >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i) for i in range(4))


def _tile_transpose(w):
    """``tile_transpose<V>`` of csrc/operand_tile.cuh, on Python ints."""
    if len(w) == 2:
        return [_byte_perm(w[0], w[1], 0x5410), _byte_perm(w[0], w[1], 0x7632)]
    if len(w) == 4:
        t0, t1 = _byte_perm(w[0], w[1], 0x5140), _byte_perm(w[0], w[1], 0x7362)
        t2, t3 = _byte_perm(w[2], w[3], 0x5140), _byte_perm(w[2], w[3], 0x7362)
        return [_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
                _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632)]
    return list(w)


@pytest.mark.parametrize("v", [1, 2, 4])
@pytest.mark.parametrize("mn", [False, True])
def test_tile_walk_turns_the_tile_in_whole_words_without_bank_conflicts(v, mn):
    # One tile of operand_tile_kernel emulated: values tagged by (row, K);
    # each warp's 32 stores and 32 loads of a step fall in 32 banks, and
    # the word read for (row, K word) holds that row's V values in K order.
    size = 32 * v
    bits = 32 // v
    pitch = 32 if mn else 33  # words a tile row

    def col(i, w):
        return w ^ ((i // v) & 31) if mn else w

    value = {(r, kk): (r * size + kk) % (1 << bits) for r in range(size) for kk in range(size)}

    def word(vals):
        return sum(x << (bits * j) for j, x in enumerate(vals))

    tile = {}
    if mn:
        for c in range(32):
            banks = {j: set() for j in range(v)}
            for tx in range(32):
                # w[jj]: rows tx V .. tx V + V - 1 at K index c V + jj.
                w = [word([value[(tx * v + j, c * v + jj)] for j in range(v)])
                     for jj in range(v)]
                for j, out in enumerate(_tile_transpose(w)):
                    addr = (tx * v + j) * pitch + col(tx * v + j, c)
                    tile[addr] = out
                    banks[j].add(addr % 32)
            assert all(len(b) == 32 for b in banks.values())
    else:
        for i in range(size):
            banks = set()
            for tx in range(32):
                addr = i * pitch + col(i, tx)
                tile[addr] = word([value[(i, tx * v + j)] for j in range(v)])
                banks.add(addr % 32)
            assert len(banks) == 32
    assert len(tile) == size * 32
    for i in range(size):
        addrs = [i * pitch + col(i, tx) for tx in range(32)]
        assert len({a % 32 for a in addrs}) == 32
        for tx, a in enumerate(addrs):
            assert tile[a] == word([value[(i, tx * v + j)] for j in range(v)])


def test_pack_ab_needs_the_card(capsys, tmp_path):
    from gemm_hls_tpu_torch.tools import pack_ab
    assert pack_ab.main([str(tmp_path)]) == 2
    assert "no CUDA device" in capsys.readouterr().err
