"""Flash attention in the port (``gemm_hls_tpu_torch.flash_attention``,
``ops.flash``) against the JAX package on the CPU.

The same numpy inputs, drawn from a seed, go through
``gemm_hls_tpu.ops.attention.flash_attention`` (its Pallas kernels in
interpret mode, as ``tests/test_flash.py`` runs them) and through the
port's plain versions (CPU tensors), over ``tests/test_flash.py``'s matrix.
Tolerances are the JAX tests' own: relative 1e-4, absolute 1e-5 for
forward outputs (both sides sum in fp32, in different orders); relative
1e-3, absolute 1e-5 for gradients (three chained products, each summed in
fp32).  The kernels themselves run only on the card
(``tests/test_torch_kernels.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemm_hls_tpu.config import default_config
from gemm_hls_tpu.ops import pallas_flash as jflash
from gemm_hls_tpu.ops.attention import flash_attention as jax_flash
from gemm_hls_tpu_torch import flash_attention
from gemm_hls_tpu_torch.ops import flash

torch.set_num_threads(1)

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
JCFG = default_config("float32").replace(out_dtype="float32")


def _draw(seed, *shapes, lo=-1.0, hi=1.0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(lo, hi, s).astype(np.float32) for s in shapes]


def _both(q, k, v, **kw):
    """(JAX output, port output) of flash_attention on the same inputs."""
    a = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  interpret=True, **kw)
    b = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), **kw)
    assert b.shape == a.shape and b.dtype == torch.float32
    return np.asarray(a), b.numpy()


def _grads(q, k, v, w, **kw):
    """Gradients of sum(flash_attention(q, k, v) * w) on both sides."""
    def jloss(q_, k_, v_):
        return jnp.sum(jax_flash(q_, k_, v_, interpret=True, **kw) * w)

    gj = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (flash_attention(*xs, **kw) * torch.from_numpy(w)).sum().backward()
    return [np.asarray(g) for g in gj], [x.grad.numpy() for x in xs]


def _assert_grads(gj, gt):
    for name, a, b in zip(("dq", "dk", "dv"), gj, gt):
        assert b.shape == a.shape, name
        np.testing.assert_allclose(b, a, err_msg=name, **GRAD)


CASES = [
    # (B, Sq, Skv, D, bq, bkv, causal): tests/test_flash.py's CASES
    (2, 128, 128, 64, 64, 64, False),
    (2, 128, 128, 64, 64, 64, True),
    (1, 96, 150, 64, 64, 64, False),
    (1, 150, 150, 64, 64, 64, True),
    (2, 64, 256, 64, 64, 256, False),
    (1, 50, 70, 40, 32, 32, False),
    (1, 1, 17, 64, 512, 1024, False),
]


@pytest.mark.parametrize("b,sq,skv,d,bq,bkv,causal", CASES)
def test_forward_cases(b, sq, skv, d, bq, bkv, causal):
    q, k, v = _draw(1, (b, sq, d), (b, skv, d), (b, skv, d), lo=-2, hi=2)
    np.testing.assert_allclose(*_both(q, k, v, causal=causal, block_q=bq,
                                      block_kv=bkv)[::-1], **FWD)


def test_custom_scale():
    q, k, v = _draw(2, (2, 64, 32), (2, 64, 32), (2, 64, 32))
    a, b = _both(q, k, v, scale=0.125, block_q=32, block_kv=32)
    np.testing.assert_allclose(b, a, **FWD)
    # A tensor scale is folded into q instead.
    c = flash_attention(*map(torch.from_numpy, (q, k, v)),
                        scale=torch.tensor(0.125), block_q=32)
    np.testing.assert_allclose(c.numpy(), a, **FWD)


@pytest.mark.parametrize("b,sq,skv,d,bq,bkv,causal", [
    (2, 128, 128, 64, 64, 64, False),
    (2, 128, 128, 64, 64, 64, True),
    (1, 96, 150, 64, 64, 64, False),
    (1, 150, 150, 64, 64, 64, True),
    (2, 64, 256, 64, 64, 256, False),
])
def test_gradients(b, sq, skv, d, bq, bkv, causal):
    q, k, v, w = _draw(3, (b, sq, d), (b, skv, d), (b, skv, d), (b, sq, d))
    _assert_grads(*_grads(q, k, v, w, causal=causal, block_q=bq,
                          block_kv=bkv))


def test_grad_zero_for_future_kv_under_causal():
    q, k, v = _draw(4, (1, 32, 64), (1, 64, 64), (1, 64, 64))
    xs = [torch.from_numpy(q)] + [torch.from_numpy(x).requires_grad_()
                                  for x in (k, v)]
    (flash_attention(*xs, causal=True, block_q=32) ** 2).sum().backward()
    assert not xs[1].grad[0, 32:].any() and not xs[2].grad[0, 32:].any()


def test_rejects_bad_shapes():
    q = torch.zeros((2, 16, 8))
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros((2, 16, 4)), torch.zeros((2, 16, 4)))
    with pytest.raises(ValueError):
        flash_attention(torch.zeros((16, 8)), torch.zeros((16, 8)),
                        torch.zeros((16, 8)))


def test_gqa_forward():
    q, k, v = _draw(5, (8, 128, 64), (2, 128, 64), (2, 128, 64))
    a, b = _both(q, k, v, block_q=64, block_kv=64)
    np.testing.assert_allclose(b, a, **FWD)
    # == the kv heads broadcast explicitly
    kb, vb = (torch.from_numpy(x).repeat_interleave(4, 0) for x in (k, v))
    c = flash_attention(torch.from_numpy(q), kb, vb)
    np.testing.assert_allclose(b, c.numpy(), rtol=1e-5, atol=1e-6)


def test_gqa_gradients():
    q, k, v, w = _draw(6, (4, 96, 32), (2, 96, 32), (2, 96, 32), (4, 96, 32))
    _assert_grads(*_grads(q, k, v, w, block_q=32, block_kv=32))


def test_4d_layout_gqa():
    q, k, v = _draw(7, (2, 64, 4, 32), (2, 64, 2, 32), (2, 64, 2, 32))
    a, b = _both(q, k, v, block_q=32, block_kv=32)
    np.testing.assert_allclose(b, a, **FWD)


def test_4d_causal_gradient():
    q, k, v, w = _draw(8, *[(1, 96, 2, 32)] * 4)
    _assert_grads(*_grads(q, k, v, w, causal=True, block_q=32, block_kv=32))


def test_4d_gqa_causal_gradient():
    q, k, v, w = _draw(9, (2, 48, 4, 16), (2, 48, 1, 16), (2, 48, 1, 16),
                       (2, 48, 4, 16))
    _assert_grads(*_grads(q, k, v, w, causal=True, block_q=16, block_kv=16))


def test_window_forward():
    q, k, v = _draw(10, *[(1, 160, 32)] * 3)
    a, b = _both(q, k, v, causal=True, window=48, block_q=32, block_kv=32)
    np.testing.assert_allclose(b, a, **FWD)


def test_window_gradients():
    q, k, v, w = _draw(11, *[(1, 128, 32)] * 4)
    _assert_grads(*_grads(q, k, v, w, causal=True, window=32, block_q=32,
                          block_kv=32))


def test_window_requires_causal():
    q = torch.zeros((1, 64, 32))
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, q, q, window=16)


def test_logit_cap_forward_and_gradients():
    q, k, v, w = _draw(12, *[(1, 96, 32)] * 4, lo=-2, hi=2)
    a, b = _both(q, k, v, logit_cap=2.0, block_q=32, block_kv=32)
    np.testing.assert_allclose(b, a, **FWD)
    _assert_grads(*_grads(q, k, v, w, logit_cap=2.0, block_q=32,
                          block_kv=32))


def test_logit_cap_window_combined():
    q, k, v = _draw(13, *[(1, 128, 32)] * 3, lo=-2, hi=2)
    a, b = _both(q, k, v, causal=True, window=40, logit_cap=3.0, block_q=32,
                 block_kv=32)
    np.testing.assert_allclose(b, a, **FWD)


@pytest.mark.parametrize("causal", [False, True])
def test_kv_lengths_3d(causal):
    q, k, v = _draw(14, (3, 32, 64), (3, 128, 64), (3, 128, 64))
    lens = np.array([128, 70, 40], np.int32)
    a, b = _both(q, k, v, kv_lengths=lens, causal=causal, block_q=32,
                 block_kv=32)
    np.testing.assert_allclose(b, a, **FWD)


def test_kv_lengths_decode_shape_gqa():
    q, k, v = _draw(15, (4, 1, 64), (2, 256, 64), (2, 256, 64))
    a, b = _both(q, k, v, kv_lengths=np.array([100, 256], np.int32),
                 block_q=8, block_kv=64)
    np.testing.assert_allclose(b, a, **FWD)


def test_kv_lengths_4d():
    q, k, v = _draw(16, *[(2, 64, 2, 32)] * 3)
    a, b = _both(q, k, v, kv_lengths=np.array([30, 64], np.int32),
                 block_q=32, block_kv=32)
    np.testing.assert_allclose(b, a, **FWD)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("layout", ["3d_gqa", "4d_decode"])
def test_kv_lengths_stale_slots_ignored(causal, layout):
    # A padded cache's slots past each length hold NaN (K) and +inf (V):
    # both sides must ignore them (v rows zeroed: pallas_flash.py:179-180).
    if layout == "3d_gqa":
        q, k, v = _draw(22, (4, 3, 64), (2, 128, 64), (2, 128, 64))
        lens = np.array([100, 37], np.int32)
    else:
        q, k, v = _draw(22, (2, 1, 4, 32), (2, 96, 2, 32), (2, 96, 2, 32))
        lens = np.array([60, 9], np.int32)
    for i, n in enumerate(lens):
        k[i, n:] = np.nan
        v[i, n:] = np.inf
    a, b = _both(q, k, v, kv_lengths=lens, causal=causal, block_q=8,
                 block_kv=32)
    assert np.isfinite(a).all() and np.isfinite(b).all()
    np.testing.assert_allclose(b, a, **FWD)


def test_kv_lengths_bad_shape():
    q = torch.zeros((2, 16, 128))
    with pytest.raises(ValueError):
        flash_attention(q, q, q, kv_lengths=torch.zeros(3, dtype=torch.int32))


def _segments(b, s, cuts):
    seg = np.zeros((b, s), np.int32)
    for i, c in enumerate(cuts):
        seg[:, c:] = i + 1
    return seg


def test_segment_ids_forward():
    q, k, v = _draw(17, *[(2, 160, 64)] * 3)
    seg = _segments(2, 160, (50, 120))
    a, b = _both(q, k, v, q_segment_ids=seg, kv_segment_ids=seg, block_q=32,
                 block_kv=32)
    np.testing.assert_allclose(b, a, **FWD)


def test_segment_ids_causal_packed_training():
    q, k, v, w = _draw(18, *[(1, 128, 32)] * 4)
    seg = _segments(1, 128, (40, 90))
    kw = dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg,
              block_q=32, block_kv=32)
    a, b = _both(q, k, v, **kw)
    np.testing.assert_allclose(b, a, **FWD)
    _assert_grads(*_grads(q, k, v, w, **kw))


def test_segment_ids_4d_gqa():
    q, k, v = _draw(19, (2, 64, 4, 32), (2, 64, 2, 32), (2, 64, 2, 32))
    seg = _segments(2, 64, (30,))
    a, b = _both(q, k, v, q_segment_ids=seg, kv_segment_ids=seg, block_q=32,
                 block_kv=32)
    np.testing.assert_allclose(b, a, **FWD)


def test_segment_ids_require_both():
    q = torch.zeros((1, 32, 128))
    with pytest.raises(ValueError, match="together"):
        flash_attention(q, q, q,
                        q_segment_ids=torch.zeros((1, 32), dtype=torch.int32))


def test_causal_decode_anchored_at_cache_end():
    q, k, v = _draw(20, (2, 1, 32), (2, 128, 32), (2, 128, 32))
    a, b = _both(q, k, v, causal=True, kv_lengths=np.array([100, 128]),
                 block_q=8, block_kv=32)
    np.testing.assert_allclose(b, a, **FWD)


def test_causal_decode_multi_token_chunk():
    q, k, v = _draw(21, (1, 4, 32), (1, 96, 32), (1, 96, 32))
    a, b = _both(q, k, v, causal=True, kv_lengths=np.array([60]), block_q=8,
                 block_kv=32)
    np.testing.assert_allclose(b, a, **FWD)


def test_rejects_mixed_dtypes():
    q = torch.zeros((1, 32, 128), dtype=torch.bfloat16)
    kf = torch.zeros((1, 32, 128))
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q, kf, kf)


# ---- offsets: flash_mha's (q_offset, kv_offset) pair ----------------------

def _mha_both(q, k, v, **kw):
    a = jflash.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         cfg=JCFG, interpret=True,
                         **{n: (jnp.asarray(x) if n == "offsets" else x)
                            for n, x in kw.items()})
    b = flash.flash_mha(*map(torch.from_numpy, (q, k, v)), **kw)
    if kw.get("save_lse"):
        return [np.asarray(x) for x in a], [x.numpy() for x in b]
    return np.asarray(a), b.numpy()


@pytest.mark.parametrize("window", [None, 24])
def test_offsets_forward(window):
    q, k, v = _draw(22, *[(2, 128, 32)] * 3)
    q, k = q * 0.2, k * 0.2
    a, b = _mha_both(q, k, v, offsets=np.array([128, 0]), causal=True,
                     window=window, block_q=32, block_kv=32)
    np.testing.assert_allclose(b, a, **FWD)


def test_offsets_zero_matches_plain_causal():
    q, k, v = _draw(23, *[(1, 96, 32)] * 3)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    a = flash.flash_mha(*t, offsets=[0, 0], causal=True, block_q=32)
    b = flash.flash_mha(*t, causal=True, block_q=32)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


def test_offsets_fully_future_shard():
    (q,) = _draw(24, (1, 64, 32))
    (oj, lj), (ot, lt) = _mha_both(q, q, q, offsets=np.array([0, 64]),
                                   causal=True, block_q=32, block_kv=32,
                                   save_lse=True)
    assert np.abs(ot).max() == 0.0 and np.all(lt == -np.inf)
    assert lt.shape == lj.shape and np.all(lj == -np.inf)


def test_offsets_backward_against_jax_kernels():
    q, k, v, do = _draw(25, *[(1, 64, 16)] * 4)
    q, k = q * 0.3, k * 0.3
    offs = np.array([64, 0])
    kw = dict(causal=True, window=80, block_q=16, block_kv=16)
    (oj, lj), (ot, lt) = _mha_both(q, k, v, offsets=offs, save_lse=True, **kw)
    np.testing.assert_allclose(ot, oj, **FWD)
    np.testing.assert_allclose(lt, lj, **FWD)
    delta = np.sum(do * oj, axis=-1, keepdims=True)
    jargs = [jnp.asarray(x) for x in (q, k, v, do, lj, delta)]
    targs = [torch.from_numpy(np.array(x)) for x in (q, k, v, do, lj, delta)]
    dqj = jflash.flash_mha_bwd_dq(*jargs, None, None, jnp.asarray(offs),
                                  cfg=JCFG, interpret=True, **kw)
    dkj, dvj = jflash.flash_mha_bwd_dkv(*jargs, None, None, jnp.asarray(offs),
                                        cfg=JCFG, interpret=True, **kw)
    dqt = flash.flash_mha_bwd_dq(*targs, offsets=offs, **kw)
    dkt, dvt = flash.flash_mha_bwd_dkv(*targs, offsets=offs, **kw)
    for name, a, b in (("dq", dqj, dqt), ("dk", dkj, dkt), ("dv", dvj, dvt)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=name,
                                   **GRAD)


def test_offsets_rejections():
    q = torch.zeros((1, 32, 32))
    with pytest.raises(ValueError, match="causal"):
        flash.flash_mha(q, q, q, offsets=[0, 0])
    with pytest.raises(ValueError, match="kv_lengths"):
        flash.flash_mha(q, q, q, kv_lengths=[32], offsets=[0, 0], causal=True)


def test_bwd_dkv_folds_gqa_group():
    # The port's dkv sums a GQA group in the kernel; JAX's returns per-q-head
    # tiles that its caller folds.
    q, k, v, do = _draw(26, (4, 48, 16), (2, 48, 16), (2, 48, 16), (4, 48, 16))
    o, lse = jflash.flash_mha(*map(jnp.asarray, (q, k, v)), cfg=JCFG,
                              interpret=True, save_lse=True, block_q=16,
                              block_kv=16)
    delta = np.sum(do * np.asarray(o), axis=-1, keepdims=True)
    jargs = [jnp.asarray(x) for x in (q, k, v, do, np.asarray(lse), delta)]
    dkj, dvj = jflash.flash_mha_bwd_dkv(*jargs, cfg=JCFG, interpret=True,
                                        block_q=16, block_kv=16)
    dkt, dvt = flash.flash_mha_bwd_dkv(
        *[torch.from_numpy(np.array(x)) for x in (q, k, v, do, lse, delta)],
        block_q=16)
    for a, b in ((dkj, dkt), (dvj, dvt)):
        np.testing.assert_allclose(b.numpy(),
                                   np.asarray(a).reshape(2, 2, 48, 16).sum(1),
                                   **GRAD)


# ---- decode fast path ------------------------------------------------------

def test_decode_fast_path_causal():
    q, k, v = _draw(27, (2, 1, 8, 32), (2, 128, 2, 32), (2, 128, 2, 32))
    a, b = _both(q, k, v, causal=True, kv_lengths=np.array([100, 37]),
                 block_q=32, block_kv=32)
    np.testing.assert_allclose(b, a, **FWD)


def test_decode_fast_path_noncausal():
    q, k, v = _draw(28, (1, 1, 4, 16), (1, 64, 4, 16), (1, 64, 4, 16))
    a, b = _both(q, k, v, block_q=16, block_kv=16)
    np.testing.assert_allclose(b, a, **FWD)


def test_bwd_block_overrides():
    q, k, v, w = _draw(29, *[(1, 256, 32)] * 4)
    kw = dict(causal=True, block_q=64, block_kv=128)
    gj, g0 = _grads(q, k, v, w, **kw)
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (flash_attention(*xs, bwd_block_q=128, bwd_block_kv=64, **kw)
     * torch.from_numpy(w)).sum().backward()
    _assert_grads(gj, [x.grad.numpy() for x in xs])
    for a, x in zip(g0, xs):
        np.testing.assert_allclose(a, x.grad.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("causal,window,cap", [(False, None, None),
                                               (True, None, None),
                                               (True, 24, 5.0)])
def test_save_lse(causal, window, cap):
    q, k, v = _draw(30, (2, 80, 32), (1, 80, 32), (1, 80, 32))
    (oj, lj), (ot, lt) = _mha_both(q, k, v, causal=causal, window=window,
                                   logit_cap=cap, scale=0.2, save_lse=True,
                                   block_q=32, block_kv=32)
    assert lt.shape == lj.shape == (2, 80, 1)
    np.testing.assert_allclose(ot, oj, **FWD)
    np.testing.assert_allclose(lt, lj, **FWD)


# ---- the port's own rules --------------------------------------------------

@pytest.mark.parametrize("what", ["interpret", "head_dim", "dtype"])
def test_kernel_refusals_off_the_cpu(what):
    # Off the CPU (meta tensors here, CUDA alike) the wrapper launches a
    # kernel or raises before any launch; it never falls back.
    d = 160 if what == "head_dim" else 64
    dt = torch.float64 if what == "dtype" else torch.float32
    q = torch.zeros((2, 32, d), device="meta", dtype=dt)
    with pytest.raises(NotImplementedError):
        flash_attention(q, q, q, interpret=what == "interpret")


def test_cpu_runs_the_plain_version_uncounted():
    before = (flash.flash_mha.launches, flash.flash_mha_bwd_dq.launches,
              flash.flash_mha_bwd_dkv.launches)
    q = torch.rand((2, 40, 24), requires_grad=True)
    flash_attention(q, q, q, causal=True).sum().backward()
    assert q.grad is not None
    assert (flash.flash_mha.launches, flash.flash_mha_bwd_dq.launches,
            flash.flash_mha_bwd_dkv.launches) == before


def test_plain_versions_any_head_dim_and_block():
    # The plain versions take any D and any block_q; the q tiling does not
    # change the result.
    q, k, v = _draw(31, (2, 70, 200), (2, 90, 200), (2, 90, 200))
    t = [torch.from_numpy(x) for x in (q, k, v)]
    o1, l1 = flash.flash_fwd_plain(*t, causal=True, scale=0.05, block_q=16)
    o2, l2 = flash.flash_fwd_plain(*t, causal=True, scale=0.05, block_q=512)
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=1e-6, atol=1e-7)


# ---- the forward's routes (ops.flash.flash_route) --------------------------
# The wgmma engine (csrc/flash_wgmma.cu) and the mma.sync tile run only on
# the card; here the route rule and the engine's shapes at a small size.


def test_route_rule():
    bf16, f16 = torch.bfloat16, torch.float16
    # The main path's shapes take the engine; decode's four rows a kv head,
    # other head dims, unaligned rows and fp32 do not.
    assert flash.flash_route(bf16, 128, 1024, True) == "wgmma"
    assert flash.flash_route(f16, 64, 64, True) == "wgmma"
    assert flash.flash_route(bf16, 128, 4, True) == "mma.sync"
    assert flash.flash_route(bf16, 128, 63, True) == "mma.sync"
    assert flash.flash_route(bf16, 96, 1024, True) == "mma.sync"
    assert flash.flash_route(bf16, 128, 1024, False) == "mma.sync"
    assert flash.flash_route(torch.float32, 128, 1024, True) == "simt"


def test_route_cases_take_the_routes_they_name():
    # chip_smoke.py's FLASH_ROUTE_CASES (phase 13 and the card tests): the
    # route each case asserts is flash_route's for its dtype, head dim, rows
    # and row pitch, and the table reaches every route.
    import chip_smoke

    seen = set()
    for case in list(chip_smoke.FLASH_ROUTE_CASES) + [chip_smoke.FLASH_REPEAT_CASE]:
        _, dt, _, _, _, s_q, _, d, kw, route = case
        dtype = getattr(torch, dt)
        width = d + 1 if kw.get("pitched") else d
        aligned = width * dtype.itemsize % 16 == 0
        assert flash.flash_route(dtype, d, s_q, aligned) == route, case
        seen.add((dt, route))
    assert {("bfloat16", "wgmma"), ("float16", "wgmma"), ("bfloat16", "mma.sync"),
            ("float32", "simt")} <= seen


def test_plain_calls_leave_the_route_alone():
    flash.flash_mha.last_route = None
    q = torch.zeros((1, 64, 64))
    flash.flash_mha(q, q, q)
    assert flash.flash_mha.last_route is None


@pytest.mark.parametrize("causal", [False, True])
def test_engine_shapes_gqa_kv_lengths_3d(causal):
    # The engine route's shapes at a small size: S_q 128, D 64, 8 q heads
    # over 2 kv heads (GQA 4), a 256-slot cache with stale NaN / inf slots
    # past each length (lengths >= S_q: every row sees a key, as the JAX
    # kernel assumes under causal anchoring).
    q, k, v = _draw(31, (8, 128, 64), (2, 256, 64), (2, 256, 64))
    lens = np.array([256, 200], np.int32)
    for i, n in enumerate(lens):
        k[i, n:] = np.nan
        v[i, n:] = np.inf
    a, b = _both(q, k, v, kv_lengths=lens, causal=causal, block_q=64,
                 block_kv=64)
    assert np.isfinite(b).all()
    np.testing.assert_allclose(b, a, **FWD)


@pytest.mark.parametrize("causal", [False, True])
def test_engine_shapes_gqa_4d(causal):
    # The same in the (batch, S, H, D) layout the engine reads in place,
    # kv lengths per batch element.
    q, k, v = _draw(32, (2, 128, 8, 64), (2, 256, 2, 64), (2, 256, 2, 64))
    lens = np.array([256, 150], np.int32)
    a, b = _both(q, k, v, kv_lengths=lens, causal=causal, block_q=64,
                 block_kv=64)
    np.testing.assert_allclose(b, a, **FWD)


# ---- the backward's routes (ops.flash.flash_bwd_route) ---------------------
# The backward's wgmma engine (csrc/flash_bwd_wgmma.cu) and its mma.sync tile
# run only on the card; here the route rule, the card table's routes, and
# the plain backward against the JAX kernels at a shape the engine takes.


def test_bwd_route_rule():
    bf16, f16 = torch.bfloat16, torch.float16
    # dq takes S_q rows, dk / dv S_kv rows: the main path's shapes take the
    # engine; fewer than 64 rows, other head dims, unaligned rows and fp32
    # do not.
    assert flash.flash_bwd_route(bf16, 128, 1024, True) == "wgmma"
    assert flash.flash_bwd_route(f16, 64, 64, True) == "wgmma"
    assert flash.flash_bwd_route(bf16, 128, 63, True) == "mma.sync"
    assert flash.flash_bwd_route(bf16, 128, 1, True) == "mma.sync"
    assert flash.flash_bwd_route(bf16, 96, 1024, True) == "mma.sync"
    assert flash.flash_bwd_route(f16, 40, 1024, True) == "mma.sync"
    assert flash.flash_bwd_route(bf16, 128, 1024, False) == "mma.sync"
    assert flash.flash_bwd_route(torch.float32, 128, 1024, True) == "simt"
    assert flash.flash_bwd_route(torch.float32, 64, 8, False) == "simt"


def test_bwd_route_cases_take_the_routes_they_name():
    # chip_smoke.py's FLASH_BWD_ROUTE_CASES (phase 13 and the card tests):
    # the route each case asserts is flash_bwd_route's for dq (S_q rows) and
    # for dk / dv (S_kv rows) alike, no case passes kv_lengths (the
    # backward takes none), and the table reaches every route.
    import chip_smoke

    seen = set()
    for case in list(chip_smoke.FLASH_BWD_ROUTE_CASES) + [chip_smoke.FLASH_BWD_REPEAT_CASE]:
        _, dt, _, _, _, s_q, s_kv, d, kw, route = case
        dtype = getattr(torch, dt)
        width = d + 1 if kw.get("pitched") else d
        aligned = width * dtype.itemsize % 16 == 0
        assert flash.flash_bwd_route(dtype, d, s_q, aligned) == route, case
        assert flash.flash_bwd_route(dtype, d, s_kv, aligned) == route, case
        assert "kv_lengths" not in kw, case
        seen.add((dt, d, route))
    assert {("bfloat16", 64, "wgmma"), ("bfloat16", 128, "wgmma"),
            ("float16", 64, "wgmma"), ("float16", 128, "wgmma"),
            ("bfloat16", 128, "mma.sync"), ("float32", 64, "simt")} <= seen


def test_plain_backward_calls_leave_the_routes_alone():
    flash.flash_mha_bwd_dq.last_route = flash.flash_mha_bwd_dkv.last_route = None
    q = torch.rand((2, 64, 64), requires_grad=True)
    flash_attention(q, q, q, causal=True).sum().backward()
    assert flash.flash_mha_bwd_dq.last_route is None
    assert flash.flash_mha_bwd_dkv.last_route is None


@pytest.mark.parametrize("seg", [False, True])
def test_bwd_plain_vs_jax_kernels_at_an_engine_shape(seg):
    # The card check holds the engine kernels to the plain versions at the
    # engine's shapes (D 64, rows >= 64, GQA); here the plain versions are
    # held to the JAX kernels (interpret mode) at such a shape: 2 kv heads
    # x GQA 4, S 128, D 64, causal + window, with and without segment ids.
    q, do = _draw(41, (8, 128, 64), (8, 128, 64))
    k, v = _draw(42, (2, 128, 64), (2, 128, 64))
    kw = dict(causal=True, window=48, block_q=32, block_kv=32, scale=0.125)
    sq = _segments(8, 128, (40, 90)) if seg else None
    skv = _segments(2, 128, (40, 90)) if seg else None
    o, lse = jflash.flash_mha(*map(jnp.asarray, (q, k, v)), None, sq, skv,
                              cfg=JCFG, interpret=True, save_lse=True, **kw)
    delta = np.sum(do * np.asarray(o), axis=-1, keepdims=True)
    jargs = [jnp.asarray(x) for x in (q, k, v, do, np.asarray(lse), delta)]
    jseg = (None, None) if not seg else (jnp.asarray(sq)[..., None],
                                         jnp.asarray(skv)[:, None, :])
    dqj = jflash.flash_mha_bwd_dq(*jargs, *jseg, cfg=JCFG, interpret=True, **kw)
    dkj, dvj = jflash.flash_mha_bwd_dkv(*jargs, *jseg, cfg=JCFG,
                                        interpret=True, **kw)
    targs = [torch.from_numpy(np.array(x)) for x in (q, k, v, do, lse, delta)]
    tseg = dict(q_segment_ids=sq, kv_segment_ids=skv)
    dqt = flash.flash_mha_bwd_dq(*targs, **tseg, **kw)
    dkt, dvt = flash.flash_mha_bwd_dkv(*targs, **tseg, **kw)
    np.testing.assert_allclose(dqt.numpy(), np.asarray(dqj), err_msg="dq", **GRAD)
    # JAX's dkv returns per-q-head tiles that its caller folds.
    for name, a, b in (("dk", dkj, dkt), ("dv", dvj, dvt)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a).reshape(2, 4, 128, 64).sum(1),
                                   err_msg=name, **GRAD)


@pytest.mark.parametrize("dt,causal", [("bfloat16", True), ("float16", False)])
def test_fp32_output_vs_jax(dt, causal):
    # flash_mha(out_dtype=float32) on 16-bit operands (the ring's partials):
    # o unrounded, against the JAX kernel with cfg.out_dtype "float32" (ring
    # attention's setting) in interpret mode; rounded to the operand type it
    # is bit for bit the 16-bit-output call (the same arithmetic, another
    # store); lse unchanged.  Another output type is refused.
    q, k, v = _draw(61, (4, 128, 64), (2, 128, 64), (2, 128, 64))
    jdt, tdt = getattr(jnp, dt), getattr(torch, dt)
    cfg = default_config(dt).replace(dtype=dt, out_dtype="float32")
    jo, jl = jflash.flash_mha(*(jnp.asarray(x, jdt) for x in (q, k, v)), cfg=cfg,
                              causal=causal, block_q=64, block_kv=64, interpret=True,
                              save_lse=True, scale=0.125)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    o32, l32 = flash.flash_mha(tq, tk, tv, causal=causal, block_q=64, save_lse=True,
                               scale=0.125, out_dtype=torch.float32)
    o16, l16 = flash.flash_mha(tq, tk, tv, causal=causal, block_q=64, save_lse=True,
                               scale=0.125)
    assert o32.dtype == torch.float32 and o16.dtype == tdt
    # Both round p to the operand type before p v, from exps computed
    # differently: a probability may round the other way, so the bound is
    # one 16-bit ulp (2^-8) of the largest output.
    scale = np.abs(np.asarray(jo)).max()
    np.testing.assert_allclose(o32.numpy(), np.asarray(jo), rtol=1e-3, atol=2 ** -8 * scale)
    np.testing.assert_allclose(l32.numpy(), np.asarray(jl), **FWD)
    assert torch.equal(o32.to(tdt), o16) and torch.equal(l32, l16)
    with pytest.raises(ValueError, match="out_dtype"):
        flash.flash_mha(tq, tk, tv, out_dtype=torch.float16 if dt == "bfloat16"
                        else torch.bfloat16)
