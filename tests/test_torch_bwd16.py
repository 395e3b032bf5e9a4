"""The backward GEMMs of 16-bit layers and the TF32 split's 16-bit sources,
with no card.

A bfloat16 / float16 layer whose cotangent arrives in its own type runs
both backward GEMMs on that type (``ops/matmul.py::backward_on_16_bits``:
B1 / B2's 16-bit engine route on the card, its plain version here); so do
``fused_linear``'s identity and relu, whose output-form derivative (0 or
1) keeps the cotangent's values and type (``ops/epilogue.py``).  Any other
cotangent (gelu's, sigmoid's and tanh's fp32 ``dacc``) meets the 16-bit
operand as fp32 at the reference's DEFAULT, the operand handed to the GEMM
unpromoted (the split pass reads it as it is on the card).  The same numpy
inputs go through the JAX package (its Pallas kernels in interpret mode,
the blocks of ``tests/test_torch_epilogue.py``) and the port; gradients
are held to JAX's at relative 1e-2 of the largest entry (16-bit results,
rounded once each side after sums in another order), as the bf16 tests of
``tests/test_torch_epilogue.py`` hold bf16 outputs.  A spy on
``_plus_times`` records the type and operands of every backward GEMM.

``tf32_operand_plain`` of a 16-bit source is the split of its fp32
promotion; every one of the 65536 bit patterns of each type is held to it
bit for bit and, independently (numpy's widening), to hi = the value, lo
= 0 (``csrc/tf32_split.cu`` equals it on the card: phase 33 of
``chip_smoke.py`` and ``tests/test_torch_kernels.py``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemm_hls_tpu import GemmConfig as JaxConfig
from gemm_hls_tpu import matmul as jax_matmul
from gemm_hls_tpu.models import mlp as jmlp
from gemm_hls_tpu.ops.fused_linear import fused_linear as jax_fused_linear

from gemm_hls_tpu_torch import fused_linear, matmul
from gemm_hls_tpu_torch.config import GemmConfig
from gemm_hls_tpu_torch.models import mlp
from gemm_hls_tpu_torch.ops import mxu
from gemm_hls_tpu_torch.parallel import make_mesh, pipeline

torch.set_num_threads(1)

matmul_mod = importlib.import_module("gemm_hls_tpu_torch.ops.matmul")
JCFG = JaxConfig(block_m=32, block_n=128, block_k=128, interpret=True)
DTYPES = ["bfloat16", "float16"]
LAYOUTS = [(False, False), (True, False), (False, True), (True, True)]
RTOL = 1e-2
JAX_ACTS = {"identity": lambda acc, b: acc + b,
            "relu": lambda acc, b: jax.nn.relu(acc + b),
            "sigmoid": lambda acc, b: jax.nn.sigmoid(acc + b),
            "tanh": lambda acc, b: jnp.tanh(acc + b),
            "gelu": lambda acc, b: jax.nn.gelu(acc + b)}


@pytest.fixture
def spy(monkeypatch):
    """[(config dtype, a's dtype, b's dtype)] of every ``_plus_times`` call
    after it is set."""
    seen, inner = [], matmul_mod._plus_times

    def record(a, b, cfg, route=None):
        seen.append((cfg.dtype, a.dtype, b.dtype))
        return inner(a, b, cfg, route)

    monkeypatch.setattr(matmul_mod, "_plus_times", record)
    return seen


def _u(shape, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _close(got, exp, rtol=RTOL):
    got = got.detach().float().numpy().astype(np.float64)
    exp = np.asarray(exp).astype(np.float64)
    assert got.shape == exp.shape
    np.testing.assert_allclose(got, exp, rtol=rtol, atol=rtol * np.abs(exp).max())


def _grads(port_fn, jax_fn, arrays, dtype, g, spy):
    """The port's and JAX's gradients of sum(f(...) * g) (the output read
    as fp32, so its cotangent arrives in the output's 16-bit type on both
    sides) for numpy ``arrays`` cast to ``dtype``; the spy holds the
    backward's GEMMs only."""
    dt = getattr(torch, dtype)
    xs = [torch.from_numpy(x).to(dt).requires_grad_() for x in arrays]
    out = port_fn(*xs)
    spy.clear()
    (out.float() * torch.from_numpy(g)).sum().backward()

    def loss(*ys):
        return jnp.sum(jax_fn(*ys).astype(jnp.float32) * g)

    exp = jax.grad(loss, argnums=tuple(range(len(arrays))))(
        *(jnp.asarray(x, dtype) for x in arrays))
    for x, e in zip(xs, exp):
        assert x.grad.dtype == x.dtype
        _close(x.grad, e)


# ---- matmul: 2-D, batched, broadcast ----------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ta,tb", LAYOUTS)
def test_matmul_gradients_on_the_16_bit_route(dtype, ta, tb, spy):
    a = _u((50, 33) if ta else (33, 50), 1)
    b = _u((40, 50) if tb else (50, 40), 2)
    _grads(lambda x, y: matmul(x, y, transpose_a=ta, transpose_b=tb),
           lambda x, y: jax_matmul(x, y, config=JCFG, transpose_a=ta, transpose_b=tb),
           (a, b), dtype, _u((33, 40), 3), spy)
    dt = getattr(torch, dtype)
    assert spy == [(dtype, dt, dt)] * 2


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["both", "a 3-D b 2-D", "a 2-D", "transposed"])
def test_batched_gradients_on_the_16_bit_route(dtype, case, spy):
    # Both 3-D (B2); a 3-D a against a 2-D b (flattened onto B1); a 2-D a
    # broadcast over b's batch (B2, its gradient the batch's sum in the
    # operand's type); both 3-D with both transposes.
    shapes = {"both": ((3, 16, 48), (3, 48, 40), False, False),
              "a 3-D b 2-D": ((3, 16, 48), (48, 40), False, False),
              "a 2-D": ((16, 48), (3, 48, 40), False, False),
              "transposed": ((3, 48, 16), (3, 40, 48), True, True)}
    sa, sb, ta, tb = shapes[case]
    _grads(lambda x, y: matmul(x, y, transpose_a=ta, transpose_b=tb),
           lambda x, y: jax_matmul(x, y, config=JCFG, transpose_a=ta, transpose_b=tb),
           (_u(sa, 4), _u(sb, 5)), dtype, _u((3, 16, 40), 6), spy)
    dt = getattr(torch, dtype)
    assert spy == [(dtype, dt, dt)] * 2


@pytest.mark.parametrize("dtype", DTYPES)
def test_stride_0_cotangent(dtype, spy):
    # out.sum().backward() hands the backward an expanded view of one value
    # (every stride 0): the launch takes a row-major copy of it
    # (mxu._row_major) before the engine's maps, and the plain version the
    # same values; the gradients are ones . B^T and A^T . ones.
    dt = getattr(torch, dtype)
    a = torch.from_numpy(_u((24, 40), 7)).to(dt).requires_grad_()
    b = torch.from_numpy(_u((40, 32), 8)).to(dt).requires_grad_()
    out = matmul(a, b)
    cotangents = []
    inner = mxu.mxu_matmul

    def keep(x, y, *eps, **kw):
        cotangents.extend(t for t in (x, y) if 0 in t.stride())
        return inner(x, y, *eps, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mxu, "mxu_matmul", keep)
        spy.clear()
        out.sum().backward()
    assert spy == [(dtype, dt, dt)] * 2
    assert cotangents and all(t.dtype == dt for t in cotangents)
    for t in cotangents:
        rm = mxu._row_major(t)
        assert 0 not in rm.stride() and rm.stride(-1) == 1 and torch.equal(rm, t)
    ones = np.ones((24, 32))
    _close(a.grad, ones @ b.detach().double().numpy().T)
    _close(b.grad, a.detach().double().numpy().T @ ones)


# ---- fused_linear and fused epilogues ---------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["identity", "relu", "sigmoid", "tanh", "gelu"])
def test_fused_gradients_and_their_routes(dtype, act, spy):
    # identity and relu: dacc in the cotangent's 16-bit type, both GEMMs on
    # it; sigmoid, tanh (output-form) and gelu (the accumulator recomputed,
    # torch.func.vjp of the epilogue): an fp32 dacc against the unpromoted
    # 16-bit operand.  dbias summed in fp32 either way.
    x, w = _u((24, 48), 9), _u((48, 64), 10)
    bias = np.linspace(-0.5, 0.5, 64).astype(np.float32)
    if act == "gelu":
        port = lambda x_, w_, b_: matmul(x_, w_, epilogue="bias_gelu",  # noqa: E731
                                         epilogue_operands=(b_,))
    else:
        port = lambda x_, w_, b_: fused_linear(x_, w_, b_, act)  # noqa: E731
    _grads(port, lambda x_, w_, b_: jax_matmul(x_, w_, config=JCFG, epilogue=JAX_ACTS[act],
                                               epilogue_operands=(b_,)),
           (x, w, bias), dtype, _u((24, 64), 11), spy)
    dt = getattr(torch, dtype)
    if act in ("identity", "relu"):
        assert spy == [(dtype, dt, dt)] * 2
    else:
        assert len(spy) == 2 and all(
            c == "float32" and {da, db} == {torch.float32, dt} for c, da, db in spy)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["identity", "relu"])
def test_fused_linear_against_jax_fused_linear(dtype, act, spy):
    # The JAX package's own fused_linear (its fp32 dacc) on a batched x.
    x, w = _u((2, 20, 48), 12), _u((48, 64), 13)
    bias = np.linspace(-1, 1, 64).astype(np.float32)
    _grads(lambda *t: fused_linear(*t, act),
           lambda *t: jax_fused_linear(*t, act, JCFG),
           (x, w, bias), dtype, _u((2, 20, 64), 14), spy)
    dt = getattr(torch, dtype)
    assert spy == [(dtype, dt, dt)] * 2


@pytest.mark.parametrize("act", ["identity", "relu", "sigmoid", "tanh"])
def test_output_form_derivative_types(act):
    # dacc keeps a 16-bit g's type where the derivative is 0 or 1, holding
    # g's values (or zeros); fp32 otherwise; dbias fp32, the same sum.
    from gemm_hls_tpu_torch.ops.epilogue import get_epilogue
    names = {"identity": "bias", "relu": "bias_relu", "sigmoid": "bias_sigmoid",
             "tanh": "bias_tanh"}
    bwd = get_epilogue(names[act]).bwd
    y = torch.from_numpy(_u((16, 32), 15)).to(torch.bfloat16)
    g = torch.from_numpy(_u((16, 32), 16)).to(torch.bfloat16)
    dacc, dbias = bwd(y, g, torch.zeros(1, 32, dtype=torch.bfloat16))
    ref, ref_bias = bwd(y.float(), g.float(), torch.zeros(1, 32))
    assert dacc.dtype == (torch.bfloat16 if act in ("identity", "relu") else torch.float32)
    assert dbias.dtype == torch.float32 and ref.dtype == torch.float32
    assert torch.equal(dacc.float(), ref)
    torch.testing.assert_close(dbias, ref_bias, rtol=1e-6, atol=1e-6)


# ---- the trainer --------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
def test_bf16_train_steps_against_jax(fused, spy):
    # Three SGD steps of the bf16 MLP from the same weights and batch: the
    # loss and the parameters after each step within 1e-2 of JAX's (bf16
    # sums in another order on each side); every GEMM of the step (forward
    # and backward) in bf16, none promoted.
    dims, lr = (64, 128, 32), 0.05
    ref = jmlp.init_params(jax.random.PRNGKey(0), dims, "bfloat16")
    rng = np.random.default_rng(2)
    xb = rng.standard_normal((32, dims[0])).astype(np.float32)
    yb = rng.standard_normal((32, dims[-1])).astype(np.float32)
    jbatch = (jnp.asarray(xb, jnp.bfloat16), jnp.asarray(yb, jnp.bfloat16))
    batch = tuple(torch.from_numpy(t).to(torch.bfloat16) for t in (xb, yb))
    params = mlp.params_from_reference(ref, device="cpu")

    def jloss(p):
        return jnp.mean((jmlp.mlp_forward(p, jbatch[0], config=JCFG, fused=fused)
                         - jbatch[1]) ** 2)

    for _ in range(3):
        value, grads = jax.value_and_grad(jloss)(ref)
        ref = jax.tree.map(lambda p, g: p - lr * g, ref, grads)
        params, loss = mlp.train_step(params, batch, lr=lr, fused=fused)
        assert abs(float(loss) - float(value)) <= RTOL * abs(float(value))
        for (w, b), (jw, jb) in zip(params, ref):
            assert w.dtype == b.dtype == torch.bfloat16
            _close(w, jw)
            _close(b, jb)
    assert spy and set(spy) == {("bfloat16", torch.bfloat16, torch.bfloat16)}


def test_sharded_and_pipelined_bf16_steps_stay_16_bit(spy):
    # The sharded MLP step (dp 2, tp 2) and the pipeline's train step on CPU
    # ranks: every GEMM of the step in bf16 (their cotangents arrive bf16
    # through the collectives' backward).
    gen = torch.Generator().manual_seed(0)
    params = mlp.init_params(gen, (64, 128, 64), torch.bfloat16)
    batch = mlp.make_batch(gen, 32, 64, 64, torch.bfloat16)
    mesh = make_mesh((2, 2), ("dp", "tp"), devices=["cpu"] * 4)
    mlp.train_step(mlp.shard_params(params, mesh), batch, lr=1e-2)
    assert spy and set(spy) == {("bfloat16", torch.bfloat16, torch.bfloat16)}
    spy.clear()
    pp = make_mesh((2,), ("pp",), devices=["cpu"] * 2)
    sp = pipeline.shard_pipeline_params(
        pipeline.init_pipeline_params(gen, 2, 64, 128, dtype=torch.bfloat16), pp)
    x = torch.randn((16, 64), generator=gen).to(torch.bfloat16)
    pipeline.pipeline_train_step(sp, (x, 0.1 * x), pp, microbatches=4, lr=1e-2)
    assert spy and set(spy) == {("bfloat16", torch.bfloat16, torch.bfloat16)}


def test_fp32_and_float64_layers_keep_their_backward(spy):
    # fp32 and float64 layers: every backward GEMM on the layer's own type
    # and precision.  An fp32 layer's bf16 cotangent (a bf16 output) is
    # handed over as it is: the split pass's workspace of it is its
    # promotion's bit for bit, so the GEMM is the promoted one's.
    for dtype, out_dtype in (("float32", None), ("float32", "bfloat16"), ("float64", None)):
        dt = getattr(torch, dtype)
        a = torch.from_numpy(_u((16, 24), 17)).to(dt).requires_grad_()
        b = torch.from_numpy(_u((24, 8), 18)).to(dt).requires_grad_()
        out = matmul(a, b, out_dtype=out_dtype, precision="high")
        spy.clear()
        out.float().sum().backward()
        g = torch.bfloat16 if out_dtype else dt
        assert [(c, {x, y}) for c, x, y in spy] == [(dtype, {dt, g})] * 2
        want = a.detach().double().sum(0, keepdim=True).T.expand(24, 8)
        _close(b.grad, want.numpy(), rtol=1e-6)


# ---- the split's 16-bit sources -------------------------------------------------

def _every_pattern(dtype):
    """All 65536 bit patterns of ``dtype`` as a (256, 256) tensor, and
    numpy's widening of them to fp32 bits."""
    bits = np.arange(65536, dtype=np.uint32).astype(np.uint16).reshape(256, 256)
    x = torch.from_numpy(bits.view(np.int16).copy()).view(getattr(torch, dtype))
    if dtype == "bfloat16":
        wide = bits.astype(np.uint32) << 16
    else:
        wide = bits.view(np.float16).astype(np.float32).view(np.uint32)
    return x, wide


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mn_major", [False, True])
@pytest.mark.parametrize("passes,side", [(1, "a"), (3, "a"), (3, "b")])
def test_split_of_16_bit_sources_is_its_promotions(dtype, mn_major, passes, side):
    # Every 16-bit pattern (+-inf, NaNs, subnormals, +-0 among them): the
    # workspace equals its fp32 promotion's bit for bit, and is hi = the
    # widened value (a NaN made quiet), lo = 0, the cross segment's hi 0
    # for +-inf and NaN, zeros past K (K 256 is already whole).
    x, wide = _every_pattern(dtype)
    x = x.t() if mn_major else x
    got = mxu.tf32_operand_plain(x, mn_major, passes, side)
    want = mxu.tf32_operand_plain(x.float(), mn_major, passes, side)
    assert got.dtype == torch.float32 and got.shape == (256, passes * 256)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    u = got.view(torch.int32).numpy().view(np.uint32).reshape(256, passes, 256)
    special = (wide & 0x7F800000) == 0x7F800000
    nan = special & ((wide & 0x7FFFFF) != 0)
    hi = np.where(nan, (wide | 0x400000) & 0xFFFFE000, wide).astype(np.uint32)
    np.testing.assert_array_equal(u[:, 0], hi)
    if passes == 3:
        lo_seg = mxu.TF32_LO_SEG[side]
        np.testing.assert_array_equal(u[:, lo_seg], 0)
        np.testing.assert_array_equal(u[:, 3 - lo_seg], np.where(special, 0, hi))


@pytest.mark.parametrize("dtype", DTYPES)
def test_split_of_16_bit_sources_pads_k(dtype):
    # K 7 pads to 8 with zeros, batched, the same as the promotion's.
    x = torch.from_numpy(_u((3, 5, 7), 19, -4, 4)).to(getattr(torch, dtype))
    x[0, 1, 2], x[1, 3, 4] = float("inf"), float("nan")
    for passes, side in ((1, "a"), (3, "b")):
        got = mxu.tf32_operand_plain(x, False, passes, side)
        assert got.shape == (3, 5, passes * 8)
        assert torch.equal(got.view(torch.int32),
                           mxu.tf32_operand_plain(x.float(), False, passes, side)
                           .view(torch.int32))
        assert int((got.reshape(3, 5, passes, 8)[..., 7] != 0).sum()) == 0


def test_split_sources_and_refusals():
    assert mxu.TF32_SOURCES == (torch.float32, torch.bfloat16, torch.float16)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        mxu.tf32_operand_plain(torch.ones(4, 4, dtype=torch.int8), False, 1, "a")
    for dt in mxu.TF32_SOURCES:
        with pytest.raises(ValueError, match="runs on the card"):
            mxu.tf32_operand(torch.ones(4, 4, dtype=dt), False, 3, "a")


@pytest.mark.parametrize("ta,tb", LAYOUTS)
def test_mixed_pair_plain_versions(ta, tb):
    # An fp32 cotangent against a bf16 operand: the IEEE plain version and
    # the TF32 passes in float64 read the bf16 member as its promotion.
    a = torch.from_numpy(_u((40, 30) if ta else (30, 40), 20))
    b = torch.from_numpy(_u((20, 40) if tb else (40, 20), 21)).to(torch.bfloat16)
    cfg = GemmConfig(dtype="float32", out_dtype="bfloat16", precision="default")
    got = mxu.mxu_matmul_plain(a, b, cfg=cfg, transpose_a=ta, transpose_b=tb)
    want = mxu.mxu_matmul_plain(a, b.float(), cfg=cfg, transpose_a=ta, transpose_b=tb)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    for passes in (1, 3):
        got = mxu.tf32_matmul_plain(a, b, passes, ta, tb)
        want = mxu.tf32_matmul_plain(a, b.float(), passes, ta, tb)
        assert torch.equal(got, want)


def test_split_of_a_stride_0_batch_is_split_once():
    # A batch read with a stride of 0 (an expanded example) is one 2-D
    # workspace, as the kernel writes it; a batch of one too.
    x = torch.from_numpy(_u((1, 6, 10), 22)).to(torch.bfloat16)
    for t in (x.expand(4, 6, 10), x):
        w = mxu.tf32_operand_plain(t, False, 3, "a")
        assert w.shape == (6, 36)
        assert torch.equal(w, mxu.tf32_operand_plain(x[0], False, 3, "a"))
    # The passes over a broadcast operand keep the batch of the product.
    b = torch.from_numpy(_u((10, 5), 23))
    assert mxu.tf32_matmul_plain(x.expand(4, 6, 10), b, 1).shape == (4, 6, 5)


def test_card_split_table_covers_each_source_and_edge():
    # chip_smoke.py's TF32_SPLIT_CASES (phase 33a and the card tests):
    # every source type in both holdings at one and three segments (both
    # sides), unaligned bases and pitches, K tails off 4 and 8 values, a
    # row group cut by the last row, a batch and a stride-0 batch.
    import chip_smoke
    cases = chip_smoke.TF32_SPLIT_CASES
    for dt in ("float32", "bfloat16", "float16"):
        mine = [c for c in cases if c[0] == dt]
        assert {(c[1], c[8], c[9]) for c in mine} >= {
            (mn, p, s) for mn in (False, True) for p, s in ((1, "a"), (3, "a"), (3, "b"))}
        assert any(c[5] for c in mine) and any(c[6] for c in mine)           # pitch, base
        assert any(c[4] % 4 for c in mine) and any(c[4] % 8 for c in mine)   # K tails
        assert any(c[3] % 8 for c in mine)                                   # row groups
        assert any(c[2] and not c[7] for c in mine)                          # a batch
        assert any(c[2] and c[7] for c in mine)                              # stride 0
        assert any(c[3] == c[4] == 1 for c in mine)                          # 1 x 1


def test_trainer_ab_needs_the_card(monkeypatch):
    # tools/trainer_ab.py times a tree on the card; without one it exits 2.
    from pathlib import Path

    from gemm_hls_tpu_torch.tools import trainer_ab
    monkeypatch.chdir(Path(__file__).resolve().parent.parent)
    assert trainer_ab.main(["--tag", "cpu"]) == 2
