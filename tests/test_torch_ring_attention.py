"""The port's ring attention (``parallel/ring_attention.py``) against
``gemm_hls_tpu.parallel``'s on the CPU.

The JAX side runs on the virtual CPU devices of ``tests/conftest.py`` with
its flash kernels in interpret mode (each call under one ``jax.jit``: an
eager ``shard_map`` runs op by op); the port on CPU ranks of one process,
where the flash kernels run their plain versions.  The same numpy q, k, v
(and segment ids, lengths) go to both; shapes are
``tests/test_ring_attention.py``'s, tiles one grid step a shard.  Every
form is held to JAX's output and, where JAX differentiates it, to the
gradient of sum(out * w) with respect to q, k and v: relative error below
1e-3 of the largest value (fp32).  The port's ring is also held to its
own single-rank ``flash_mha_diff`` (the check ``chip_smoke.py`` phase 29a
makes on the card) and its rotations' bytes to (n - 1) 2 |KV shard|.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemm_hls_tpu.parallel import make_mesh as jmake_mesh
from gemm_hls_tpu.parallel import ring_attention as jra

from gemm_hls_tpu_torch.ops.flash import flash_mha_diff
from gemm_hls_tpu_torch.parallel import make_mesh, ring_decode_attention, ring_flash_attention
from gemm_hls_tpu_torch.parallel import ring_attention as ra
from gemm_hls_tpu_torch.parallel import sharding

torch.set_num_threads(1)


def _meshes(n):
    return make_mesh((n,), ("x",), devices=["cpu"] * n), jmake_mesh((n,), ("x",))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@functools.partial(jax.jit, static_argnums=(0, 1))
def _jax_fwd_vjp(fn, grad, q, k, v, w):
    """fn(q, k, v) and, with ``grad``, the gradient of sum(fn * w)."""
    if not grad:
        return fn(q, k, v), None
    out, vjp = jax.vjp(fn, q, k, v)
    return out, vjp(w)


# (id, ring, (B, B_kv, S_q, S_kv, D), options, differentiate, input range):
# tests/test_ring_attention.py's cases.
_SEG = "seg"
RING_CASES = [
    ("plain-8", 8, (2, 2, 256, 256, 64), {}, False, 2),
    ("plain-4", 4, (1, 1, 128, 128, 32), {}, False, 2),
    ("plain-2", 2, (2, 2, 128, 128, 64), {}, False, 2),
    ("plain-grad", 4, (2, 2, 128, 128, 32), {}, True, 1),
    ("cross-lengths", 4, (1, 1, 64, 256, 32), {}, False, 1),
    ("scale", 2, (1, 1, 64, 64, 32), {"scale": 0.1}, True, 1),
    ("causal-4", 4, (1, 1, 128, 128, 32), {"causal": True}, True, 1),
    ("causal-2", 2, (2, 2, 64, 64, 32), {"causal": True}, False, 1),
    ("zigzag-4", 4, (1, 1, 128, 128, 32), {"causal": True, "zigzag": True}, True, 1),
    ("zigzag-8", 8, (1, 1, 256, 256, 32), {"causal": True, "zigzag": True}, False, 1),
    ("zigzag-1", 1, (1, 1, 64, 64, 32), {"causal": True, "zigzag": True}, False, 1),
    ("gqa", 4, (8, 2, 128, 128, 32), {}, False, 1),
    ("gqa-causal", 4, (8, 2, 128, 128, 32), {"causal": True}, True, 1),
    ("window-16", 4, (2, 2, 128, 128, 32), {"causal": True, "window": 16}, False, 1),
    ("window-48", 4, (2, 2, 128, 128, 32), {"causal": True, "window": 48}, True, 1),
    ("window-200", 4, (2, 2, 128, 128, 32), {"causal": True, "window": 200}, False, 1),
    ("window-40-ring-8", 8, (2, 2, 256, 256, 32), {"causal": True, "window": 40}, False, 1),
    ("logit-cap", 4, (2, 2, 128, 128, 32), {"causal": True, "logit_cap": 5.0}, True, 2),
    ("segments", 4, (2, 2, 128, 128, 32), {_SEG: (50, 90)}, False, 1),
    ("segments-causal", 4, (2, 2, 64, 64, 16), {"causal": True, _SEG: (30, 50)}, True, 1),
    ("gqa-window", 4, (4, 2, 64, 64, 16), {"causal": True, "window": 24}, True, 1),
    ("kv-lengths", 4, (3, 3, 128, 128, 32), {"kv_lengths": (128, 43, 70)}, False, 1),
    ("zigzag-gqa-cap", 4, (4, 2, 128, 128, 32),
     {"causal": True, "zigzag": True, "logit_cap": 10.0}, False, 1),
    ("zigzag-gqa-grad", 2, (4, 2, 64, 64, 16), {"causal": True, "zigzag": True}, True, 1),
]


def _operands(seed, shape, span):
    b, b_kv, s_q, s_kv, d = shape
    rng = np.random.default_rng(seed)
    q = rng.uniform(-span, span, (b, s_q, d)).astype(np.float32)
    k = rng.uniform(-span, span, (b_kv, s_kv, d)).astype(np.float32)
    v = rng.uniform(-span, span, (b_kv, s_kv, d)).astype(np.float32)
    w = rng.uniform(-1, 1, (b, s_q, d)).astype(np.float32)
    return q, k, v, w


@pytest.mark.parametrize("case", RING_CASES, ids=lambda c: c[0])
def test_ring_vs_jax(case):
    name, n, shape, opts, grad, span = case
    mesh, jmesh = _meshes(n)
    q, k, v, w = _operands(len(name), shape, span)
    opts = dict(opts)
    seg = opts.pop(_SEG, None)
    if seg is not None:
        ids = np.zeros((shape[0], shape[2]), np.int32)
        for row, start in enumerate(seg):
            ids[row, start:] = 1
        opts.update(q_segment_ids=ids, kv_segment_ids=ids)
    if "kv_lengths" in opts:
        opts["kv_lengths"] = np.asarray(opts["kv_lengths"], np.int32)
    block = shape[2] // n // (2 if opts.get("zigzag") else 1)
    jopts = {key: (jnp.asarray(val) if isinstance(val, np.ndarray) else val)
             for key, val in opts.items()}
    jfn = functools.partial(jra.ring_flash_attention, mesh=jmesh, block_q=block,
                            block_kv=block, interpret=True, **jopts)
    jout, jgrads = _jax_fwd_vjp(jfn, grad, *(jnp.asarray(a) for a in (q, k, v, w)))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_(grad) for a in (q, k, v))
    sharding.reset_bytes()
    out = ring_flash_attention(tq, tk, tv, mesh, block_q=block, **opts)
    assert out.shape == q.shape and tuple(out.spec) == (None, "x", None)
    got = out.full()
    assert _rel(got.detach().numpy(), jout) < 1e-3
    if not grad:
        return
    grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(w))
    for which, g, want in zip(("dq", "dk", "dv"), grads, jgrads):
        assert _rel(g.numpy(), want) < 1e-3, which


# (ring, S_q, window): tests/test_ring_attention.py's decode cases.
DECODE_CASES = [(4, 1, None), (4, 4, None), (4, 1, 48), (2, 8, 40)]


@pytest.mark.parametrize("case", DECODE_CASES + ["gqa"], ids=str)
def test_ring_decode_vs_jax(case):
    """Ragged lengths: one shorter than a shard (the later shards wholly past
    the cache end: their length re-anchored to <= 0), one at a shard
    boundary, one mid-shard, one full (earlier shards see lengths > S_loc)."""
    if case == "gqa":
        n, s_q, window, (b, b_kv, s_kv, d), lengths = 4, 1, None, (8, 2, 128, 64), [40, 128]
    else:
        (n, s_q, window), (b, b_kv, s_kv, d) = case, (4, 4, 256, 64)
        lengths = [9, 64, 150, 256]
    mesh, jmesh = _meshes(n)
    rng = np.random.default_rng(7 + n + s_q)
    q = rng.uniform(-1, 1, (b, s_q, d)).astype(np.float32)
    k, v = (rng.uniform(-1, 1, (b_kv, s_kv, d)).astype(np.float32) for _ in range(2))
    lens = np.asarray(lengths, np.int32)
    jfn = jax.jit(functools.partial(jra.ring_decode_attention, mesh=jmesh, window=window,
                                    block_q=32, block_kv=32, interpret=True))
    want = jfn(*(jnp.asarray(a) for a in (q, k, v, lens)))
    sharding.reset_bytes()
    out = ring_decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                torch.from_numpy(lens), mesh, window=window, block_q=32)
    assert tuple(out.spec) == (None, None, None)
    for c in mesh.coords():  # replicated: every rank holds the merged output
        assert _rel(out.shard(c).numpy(), want) < 1e-3
    # Each rank gathers the other ranks' fp32 partials and their lse.
    per = (n - 1) * (b * s_q * d + b * s_q) * 4
    assert set(sharding.BYTES[ra.DECODE_TAG].values()) == ({per} if n > 1 else set())


@pytest.mark.parametrize("causal,zigzag", [(False, False), (True, False), (True, True)])
def test_ring_matches_single_rank_flash(causal, zigzag):
    """The ring against the port's single-rank flash_mha_diff on the same
    pre-scaled q (forward and gradient), and its bytes against the
    formulas: forward (n - 1) 2 |KV shard|, backward that again plus
    n 2 |KV shard in fp32|."""
    n, (b, s, d) = 4, (2, 128, 32)
    mesh, _ = _meshes(n)
    q, k, v, w = (torch.from_numpy(a).requires_grad_() for a in _operands(3, (b, b, s, s, d), 1))
    sharding.reset_bytes()
    out = ring_flash_attention(q, k, v, mesh, causal=causal, zigzag=zigzag, block_q=32).full()
    fwd = dict(sharding.BYTES)
    grads = torch.autograd.grad(out, (q, k, v), w.detach())
    scale = torch.tensor(d ** -0.5, dtype=q.dtype)
    ref = flash_mha_diff(q * scale, k, v, causal=causal, block_q=32)
    want = torch.autograd.grad(ref, (q, k, v), w.detach())
    assert _rel(out.detach().numpy(), ref.detach().numpy()) < 1e-5
    for g, r in zip(grads, want):
        assert _rel(g.numpy(), r.numpy()) < 1e-5
    shard = b * (s // n) * d * 4
    assert set(fwd[ra.FWD_TAG].values()) == {(n - 1) * 2 * shard}
    assert set(sharding.BYTES[ra.BWD_TAG].values()) == {(n - 1) * 2 * shard + n * 2 * shard}


def test_ring_launch_schedule():
    """The host branches: a causal ring runs n (n + 1) / 2 live steps, with
    window w <= S_loc 2n - 1, zigzag 3 + 2 (n - 1) calls a rank."""
    from gemm_hls_tpu_torch.ops import flash
    n, calls = 4, []
    real = flash.flash_mha

    def counted(*a, **kw):
        calls.append(kw.get("causal"))
        return real(*a, **kw)

    mesh, _ = _meshes(n)
    q = torch.rand(1, 128, 16)
    ra.flash_mha = counted
    try:
        for opts, want in (({"causal": True}, n * (n + 1) // 2),
                           ({"causal": True, "window": 32}, 2 * n - 1),
                           ({"causal": True, "zigzag": True}, n * (3 + 2 * (n - 1))),
                           ({}, n * n)):
            calls.clear()
            ring_flash_attention(q, q, q, mesh, **opts)
            assert len(calls) == want, opts
    finally:
        ra.flash_mha = real


def test_zigzag_indices_match_jax():
    for s, n in [(32, 4), (256, 8), (64, 1)]:
        np.testing.assert_array_equal(ra.zigzag_indices(s, n).numpy(),
                                      np.asarray(jra.zigzag_indices(s, n)))
    with pytest.raises(ValueError):
        ra.zigzag_indices(30, 4)


@pytest.mark.parametrize("bad", [
    dict(causal=True, kv_lengths=[128, 64]),   # kv_lengths needs non-causal
    dict(window=16),                           # window needs causal
    dict(causal=True, zigzag=True, window=16),  # zigzag has no window surface
    dict(zigzag=True),                         # zigzag needs causal
    dict(q_segment_ids=np.zeros((2, 128), np.int32)),  # segment ids come in pairs
    dict(kv_lengths=[128]),                    # one length a kv head
], ids=str)
def test_ring_refusals(bad):
    mesh, _ = _meshes(4)
    q = torch.zeros((2, 128, 32))
    bad = {key: (torch.tensor(val) if isinstance(val, list) else val) for key, val in bad.items()}
    with pytest.raises(ValueError):
        ring_flash_attention(q, q, q, mesh, **bad)


def test_ring_refuses_shapes():
    mesh, _ = _meshes(8)
    with pytest.raises(ValueError, match="divide"):
        ring_flash_attention(torch.zeros(1, 100, 32), torch.zeros(1, 100, 32),
                             torch.zeros(1, 100, 32), mesh)
    mesh2, _ = _meshes(2)
    with pytest.raises(ValueError, match="S_q == S_kv"):
        ring_flash_attention(torch.zeros(1, 64, 32), torch.zeros(1, 128, 32),
                             torch.zeros(1, 128, 32), mesh2, causal=True)
    q2 = torch.zeros(1, 132, 32)
    with pytest.raises(ValueError, match="zigzag"):
        ring_flash_attention(q2, q2, q2, _meshes(4)[0], causal=True, zigzag=True)
    with pytest.raises(ValueError, match="divide"):
        ring_decode_attention(torch.zeros(2, 1, 64), torch.zeros(2, 130, 64),
                              torch.zeros(2, 130, 64), torch.tensor([1, 1]), _meshes(4)[0])
    with pytest.raises(ValueError, match="kv_lengths"):
        ring_decode_attention(torch.zeros(2, 1, 64), torch.zeros(2, 128, 64),
                              torch.zeros(2, 128, 64), torch.tensor([1, 1, 1]), _meshes(4)[0])
