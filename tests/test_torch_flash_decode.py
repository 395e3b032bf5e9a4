"""The split-KV flash decode (kernel ``csrc/flash_decode.cu``, route
``"splitkv"`` of ``ops.flash.flash_route``) against the JAX package on the
CPU.

The same numpy inputs, drawn from a seed, go through the JAX flash kernel
B6 (``gemm_hls_tpu.ops.pallas_flash.flash_mha``, and the decode fast path
of ``gemm_hls_tpu.ops.attention.flash_attention``) in interpret mode and
through the port's plain version of the split-KV decode,
``flash_decode_plain`` (its split arithmetic: per split the split's max, p,
a partial o and lse; the splits merged in split order), in fp32.  The
tolerance is ``tests/test_torch_flash.py``'s ``FWD``, relative 1e-4 and
absolute 1e-5: both sides sum in fp32, in different orders, and the
partials' merge is exact algebra.  The kernel itself runs only on the card
(``tests/test_torch_kernels.py``, over ``chip_smoke.FLASH_DECODE_CASES``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemm_hls_tpu.config import default_config
from gemm_hls_tpu.ops import pallas_flash as jflash
from gemm_hls_tpu.ops.attention import flash_attention as jax_flash
from gemm_hls_tpu_torch import flash_attention
from gemm_hls_tpu_torch.config import named_route
from gemm_hls_tpu_torch.ops import flash

torch.set_num_threads(1)

FWD = dict(rtol=1e-4, atol=1e-5)
JCFG = default_config("float32").replace(out_dtype="float32")
# Four kv heads of 600 slots: the plan's three splits of 256
# (``splitkv_plan(4, 600)``); lengths inside the first split (two splits
# dead), on the first split boundary, just past the second, the whole cache.
S_KV, LENS = 600, [40, 256, 513, 600]


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1.0, 1.0, s).astype(np.float32) for s in shapes]


def _stale(k, v, lens, layout):
    """NaN (K) and +inf (V) in every slot at or past its kv head's length."""
    for i, n in enumerate(lens):
        at = (i, slice(n, None)) if layout == "3d" else (i // k.shape[2], slice(n, None),
                                                        i % k.shape[2])
        k[at] = np.nan
        v[at] = np.inf


def _pack(x):
    """(batch, S, H, D) -> (batch * H, S, D), in numpy."""
    return x.transpose(0, 2, 1, 3).reshape(-1, x.shape[1], x.shape[3])


def _jax_mha(q, k, v, lens=None, **kw):
    """JAX's B6 on 3-D arrays in interpret mode: (o, lse (B, S_q))."""
    o, lse = jflash.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              None if lens is None else jnp.asarray(lens, jnp.int32),
                              cfg=JCFG, interpret=True, save_lse=True, block_q=16,
                              block_kv=128, **kw)
    return np.asarray(o), np.asarray(lse)[..., 0]


def _port(q, k, v, lens=None, **kw):
    """The port's split-KV decode (its plain version) on CPU tensors, 3-D or
    4-D (packed as the front door packs them): (o, lse) as numpy."""
    t = [flash._pack(torch.from_numpy(x)) for x in (q, k, v)]
    lt = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    o, lse = flash.flash_decode_plain(*t, lt, **kw)
    return flash._unpack(o, torch.from_numpy(q)).numpy(), lse.numpy()


# (group, S_q) within 16 rows a kv head, each at D 64 and 128, 3-D and 4-D.
_GROUPS = [(1, 1), (1, 4), (4, 1), (4, 4), (8, 1), (16, 1)]


@pytest.mark.parametrize("layout", ["3d", "4d"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("group,s_q", _GROUPS)
def test_plain_vs_jax(group, s_q, d, layout):
    # Stale NaN / inf slots past every length; decode-anchored causal, with
    # a window where S_q > 1; lse beside o.
    hkv = 2
    if layout == "3d":
        q, k, v = _draw(7 * group + s_q, (4 * group, s_q, d), (4, S_KV, d), (4, S_KV, d))
    else:
        q, k, v = _draw(7 * group + s_q, (2, s_q, hkv * group, d), (2, S_KV, hkv, d),
                        (2, S_KV, hkv, d))
    _stale(k, v, LENS, layout)
    kw = dict(causal=True, window=100 if s_q > 1 else None, scale=d ** -0.5)
    o, lse = _port(q, k, v, LENS, **kw)
    flat = (q, k, v) if layout == "3d" else (_pack(q), _pack(k), _pack(v))
    jo, jl = _jax_mha(*flat, LENS, **kw)
    assert np.isfinite(o).all()
    np.testing.assert_allclose(o if layout == "3d" else _pack(o), jo, **FWD)
    np.testing.assert_allclose(lse, jl, **FWD)
    # The plain forward (no splits) on the same inputs.
    t = [torch.from_numpy(x) for x in flat]
    fo, fl = flash.flash_fwd_plain(*t, torch.tensor(LENS, dtype=torch.int32), **kw)
    np.testing.assert_allclose(o if layout == "3d" else _pack(o), fo.numpy(), **FWD)
    np.testing.assert_allclose(lse, fl.numpy(), **FWD)


@pytest.mark.parametrize("group", [4, 16])
def test_decode_fast_path_vs_jax(group):
    # JAX's decode fast path (gemm_hls_tpu/ops/attention.py:161-186: a kv
    # head's group of q heads as the q rows of one head) against the port's
    # split-KV decode on the same packing, the cache read in place (4-D).
    nb, hkv, d = 2, 2, 128
    q, k, v = _draw(40 + group, (nb, 1, hkv * group, d), (nb, S_KV, hkv, d),
                    (nb, S_KV, hkv, d))
    lens = [300, 513]
    for i, n in enumerate(lens):
        k[i, n:] = np.nan
        v[i, n:] = np.inf
    jo = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                              kv_lengths=jnp.asarray(lens), interpret=True, block_q=16,
                              block_kv=128))
    lt = torch.tensor(lens, dtype=torch.int32).repeat_interleave(hkv)
    o, _ = flash.flash_decode_plain(torch.from_numpy(q).reshape(nb * hkv, group, d),
                                    flash._pack(torch.from_numpy(k)),
                                    flash._pack(torch.from_numpy(v)), lt, scale=d ** -0.5)
    np.testing.assert_allclose(o.reshape(nb, 1, hkv * group, d).numpy(), jo, **FWD)


@pytest.mark.parametrize("what", ["full", "cap", "segments", "offsets"])
def test_mask_options_vs_jax(what):
    # Every other mask option the kernel takes, at 8 rows a kv head (group
    # 4, S_q 2), D 64, against JAX's B6.
    q, k, v = _draw(50, (8, 2, 64), (2, S_KV, 64), (2, S_KV, 64))
    t = [torch.from_numpy(x) for x in (q, k, v)]
    kw, ints, jints = dict(scale=0.125), [None, None, None, None], {}
    if what == "cap":
        kw.update(logit_cap=2.0)
    elif what == "offsets":
        kw.update(causal=True)
        offs = np.array([700, 200], np.int32)
        ints[3], jints["offsets"] = torch.from_numpy(offs), jnp.asarray(offs)
    elif what == "segments":
        qs = np.tile(np.array([[0, 1]], np.int32), (8, 1))
        ks = np.tile(np.repeat(np.array([0, 1], np.int32), [250, 350])[None], (2, 1))
        ints[1:3] = torch.from_numpy(qs), torch.from_numpy(ks)
        jints.update(q_segment_ids=jnp.asarray(qs), kv_segment_ids=jnp.asarray(ks))
    jo, jl = _jax_mha(q, k, v, None, **jints, **kw)
    o, lse = flash.flash_decode_plain(*t, *ints, **kw)
    np.testing.assert_allclose(o.numpy(), jo, **FWD)
    np.testing.assert_allclose(lse.numpy(), jl, **FWD)


@pytest.mark.parametrize("dt", ["bfloat16", "float16"])
def test_fp32_output_vs_jax(dt):
    # o stored in fp32 from 16-bit operands (the ring's partials) against
    # the JAX kernel with cfg.out_dtype "float32" in interpret mode, to
    # tests/test_torch_flash.py::test_fp32_output_vs_jax's bound (p rounded
    # to the operand type from exps computed differently: one 16-bit ulp of
    # the largest output); rounded to the operand type it is bit for bit the
    # 16-bit-output call, lse the same.
    q, k, v = _draw(51, (8, 2, 128), (2, S_KV, 128), (2, S_KV, 128))
    lens = [S_KV, 300]
    jdt, tdt = getattr(jnp, dt), getattr(torch, dt)
    cfg = default_config(dt).replace(dtype=dt, out_dtype="float32")
    jo, jl = jflash.flash_mha(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                              jnp.asarray(lens, jnp.int32), cfg=cfg, causal=True,
                              block_q=16, block_kv=128, interpret=True, save_lse=True,
                              scale=0.125)
    t = [torch.from_numpy(x).to(tdt) for x in (q, k, v)]
    lt = torch.tensor(lens, dtype=torch.int32)
    o32, l32 = flash.flash_decode_plain(*t, lt, causal=True, scale=0.125,
                                        out_dtype=torch.float32)
    o16, l16 = flash.flash_decode_plain(*t, lt, causal=True, scale=0.125)
    assert o32.dtype == torch.float32 and o16.dtype == tdt
    scale = np.abs(np.asarray(jo)).max()
    np.testing.assert_allclose(o32.numpy(), np.asarray(jo), rtol=1e-3, atol=2 ** -8 * scale)
    np.testing.assert_allclose(l32.numpy(), np.asarray(jl)[..., 0], **FWD)
    assert torch.equal(o32.to(tdt), o16) and torch.equal(l32, l16)


@pytest.mark.parametrize("split_len", [64, 128, 256, 640])
def test_split_arithmetic_is_the_split_free_softmax(split_len):
    # Any plan gives the function of one softmax over the whole cache: the
    # merge of (o_s, lse_s) in split order is exact algebra, to fp32's
    # rounding; dead splits (past every length) contribute nothing.
    q, k, v = _draw(60, (8, 2, 64), (4, S_KV, 64), (4, S_KV, 64))
    _stale(k, v, LENS, "3d")
    t = [torch.from_numpy(x) for x in (q, k, v)]
    lens = torch.tensor(LENS, dtype=torch.int32)
    ref = flash.flash_fwd_plain(*t, lens, causal=True, scale=0.3)
    got = flash.flash_decode_plain(*t, lens, causal=True, scale=0.3, split_len=split_len)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_lengths_past_both_ends_of_a_shard():
    # A ring-decode shard: lengths <= 0 leave a kv head no key (o = 0, lse =
    # -inf on its rows), lengths past S_kv see the whole shard.
    q, k, v = _draw(61, (16, 4, 128), (4, 512, 128), (4, 512, 128))
    lens = torch.tensor([512, -5, 300, 900], dtype=torch.int32)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    o, lse = flash.flash_decode_plain(*t, lens, causal=True, scale=0.1)
    assert (o[4:8] == 0).all() and torch.isneginf(lse[4:8]).all()
    assert torch.isfinite(lse[:4]).all() and torch.isfinite(lse[8:]).all()
    ro, rl = flash.flash_fwd_plain(*t, lens, causal=True, scale=0.1)
    np.testing.assert_allclose(o.numpy(), ro.numpy(), **FWD)
    np.testing.assert_allclose(lse.numpy(), rl.numpy(), **FWD)


def test_front_door_takes_the_split_kv_plain_version_on_the_cpu():
    # A bf16 decode step on CPU tensors: the rule gives "splitkv", so the
    # front door runs flash_decode_plain (the kernel's arithmetic), counted
    # nowhere; an fp32 call keeps the plain forward.
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _draw(
        62, (2, 1, 8, 128), (2, S_KV, 2, 128), (2, S_KV, 2, 128)))
    lens = torch.tensor([300, 600], dtype=torch.int32)
    before = (flash.flash_mha.launches, flash.flash_decode.launches)
    got = flash_attention(q, k, v, causal=True, kv_lengths=lens)
    assert (flash.flash_mha.launches, flash.flash_decode.launches) == before
    want, _ = flash.flash_decode_plain(q.reshape(4, 4, 128), flash._pack(k), flash._pack(v),
                                       lens.repeat_interleave(2), scale=128 ** -0.5)
    assert torch.equal(got.reshape(4, 4, 128), want)


def test_plan():
    # The serving decode: 8 splits of 512 over 256 kv heads of 4096 slots
    # (2048 blocks); a ring shard of 1024: 4 of 256; every plan's splits
    # whole 64-slot tiles, at most 8, none empty.
    assert flash.splitkv_plan(256, 4096) == (8, 512)
    assert flash.splitkv_plan(256, 1024) == (4, 256)
    for b_kv in (1, 3, 64, 256, 70000):
        for s_kv in (1, 63, 64, 300, 1000, 4096, 32768, 100000):
            splits, n = flash.splitkv_plan(b_kv, s_kv)
            assert 1 <= splits <= flash.SPLITKV_MAX_SPLITS and n % 64 == 0
            assert (splits - 1) * n < s_kv <= splits * n


def test_route_rule_and_names():
    bf16, f16 = torch.bfloat16, torch.float16
    assert flash.flash_route(bf16, 128, 1, True, group=16) == "splitkv"
    assert flash.flash_route(f16, 64, 4, True, group=4) == "splitkv"
    assert flash.flash_route(bf16, 128, 17, True) == "mma.sync"
    assert flash.flash_route(bf16, 128, 5, True, group=4) == "mma.sync"
    assert flash.flash_route(bf16, 96, 1, True) == "mma.sync"
    assert flash.flash_route(bf16, 128, 1, False) == "mma.sync"
    assert flash.flash_route(torch.float32, 128, 1, True) == "simt"
    # The backward has no split-KV route.
    assert flash.flash_bwd_route(bf16, 128, 4, True) == "mma.sync"
    # "mma.sync" may be named where the rule gives "splitkv"; "splitkv"
    # nowhere else.
    assert named_route("mma.sync", "splitkv", "flash_fwd") == "mma.sync"
    for rule in ("mma.sync", "wgmma", "simt"):
        with pytest.raises(ValueError):
            named_route("splitkv", rule, "flash_fwd")


@pytest.mark.parametrize("what", ["fp32", "head_dim", "rows", "unaligned"])
def test_split_kv_named_off_its_shapes_raises(what):
    # Off the CPU (meta tensors here, CUDA alike) the split-KV decode runs
    # only where the rule gives it: named for another shape, the front door
    # raises before any launch.
    dt = torch.float32 if what == "fp32" else torch.bfloat16
    d = 96 if what == "head_dim" else 128
    s_q = 17 if what == "rows" else 4
    width = d + 1 if what == "unaligned" else d
    q = torch.zeros((2, s_q, width), device="meta", dtype=dt)[..., :d]
    with pytest.raises(ValueError, match="splitkv"):
        flash.flash_mha(q, q, q, route="splitkv")


def test_decode_cases_take_the_split_kv_route():
    # chip_smoke.py's FLASH_DECODE_CASES (phase 13 and the card tests): every
    # case is the rule's "splitkv" and its plain version agrees with the plain
    # forward at the operand type's tolerance (CPU copies of the operands).
    import chip_smoke

    gen = torch.Generator().manual_seed(3)

    def signed(torch_, shape, dtype, _):
        return (torch.rand(shape, generator=gen) * 2 - 1).to(dtype)

    for case in chip_smoke.FLASH_DECODE_CASES:
        _, dt, _, hq, hkv, s_q, _, d, kw, route = case
        assert flash.flash_route(getattr(torch, dt), d, s_q, True, hq // hkv) == route, case
    saved, chip_smoke.signed = chip_smoke.signed, signed
    try:
        for case in chip_smoke.FLASH_DECODE_CASES[::4]:
            q, k, v, ints, scale, kw = chip_smoke.flash_route_operands(torch, gen, case)
            args = (flash._pack(q), flash._pack(k), flash._pack(v), *ints)
            ro, rl = flash.flash_decode_plain(*args, scale=scale, **kw)
            fo, fl = flash.flash_fwd_plain(*args, scale=scale, **kw)
            chip_smoke.compare(torch, ro, fo, chip_smoke.flash_rtol(torch, q.dtype), str(case),
                               scaled=True)
            chip_smoke.compare(torch, rl, fl, chip_smoke.F32_RTOL, str(case), scaled=True)
    finally:
        chip_smoke.signed = saved
