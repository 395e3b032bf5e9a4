"""Fused epilogues (``matmul(epilogue=...)``, ``ops/epilogue.py``) and
``fused_linear`` against the JAX package's ``tests/test_epilogue.py`` and
``tests/test_fused_linear.py`` cases.

The same numpy inputs go through the JAX functions (Pallas in interpret
mode, with the blocks of those tests) and the port's (the plain versions,
as CPU tensors run them).  The port's registry epilogues are held against
the JAX lambdas they stand for; a torch callable runs on the CPU the way a
JAX callable runs in the reference.  Tolerances: relative 1e-3 (absolute
1e-5 for entries near zero) for fp32 outputs and gradients; relative 1e-2
for bf16 outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemm_hls_tpu import GemmConfig as JaxConfig
from gemm_hls_tpu import matmul as jax_matmul
from gemm_hls_tpu.ops.fused_linear import fused_linear as jax_fused_linear

from gemm_hls_tpu_torch import fused_linear, matmul
from gemm_hls_tpu_torch.ops import mxu
from gemm_hls_tpu_torch.ops.epilogue import available_epilogues, get_epilogue

torch.set_num_threads(1)

JCFG = JaxConfig(block_m=32, block_n=128, block_k=128, interpret=True)
RTOL, ATOL = 1e-3, 1e-5

# registry name -> the JAX epilogue it stands for
JAX_EPILOGUES = {
    "bias": lambda acc, b: acc + b,
    "bias_relu": lambda acc, b: jax.nn.relu(acc + b),
    "bias_sigmoid": lambda acc, b: jax.nn.sigmoid(acc + b),
    "bias_tanh": lambda acc, b: jnp.tanh(acc + b),
    "col_scale": lambda acc, s: acc * s,
    "scale_bias": lambda acc, s, b: acc * s + b,
    "bias_gelu": lambda acc, b: jax.nn.gelu(acc + b),
}
ACTS = {"identity": lambda p: p, "relu": jax.nn.relu,
        "sigmoid": jax.nn.sigmoid, "tanh": jnp.tanh}


def _u(shape, seed, lo=-2.0, hi=2.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _check(got, exp, rtol=RTOL, atol=ATOL):
    got = got.detach()
    got = got.float() if got.dtype == torch.bfloat16 else got
    np.testing.assert_allclose(got.numpy(), np.asarray(exp, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", sorted(JAX_EPILOGUES))
def test_registry_epilogue_matches_jax(name):
    a, b = _u((40, 64), 1), _u((64, 129), 2)
    eps = [np.linspace(-3, 3, 129).astype(np.float32) * (i + 1)
           for i in range(get_epilogue(name).n_operands)]
    got = matmul(*_t(a, b), epilogue=name, epilogue_operands=_t(*eps))
    exp = jax_matmul(jnp.asarray(a), jnp.asarray(b), config=JCFG,
                     epilogue=JAX_EPILOGUES[name],
                     epilogue_operands=tuple(map(jnp.asarray, eps)))
    _check(got, exp)


def test_callable_epilogue_runs_plain_on_cpu():
    a, b = _u((40, 64), 3, -5, 5), _u((64, 129), 4, -5, 5)
    bias = np.linspace(-10, 10, 129).astype(np.float32)
    got = matmul(*_t(a, b), epilogue=lambda acc, x: torch.relu(acc + x),
                 epilogue_operands=_t(bias))
    _check(got, np.maximum(a.astype(np.float64) @ b + bias, 0.0))


def test_epilogue_without_operands():
    a, b = _u((16, 32), 5), _u((32, 128), 6)
    got = matmul(*_t(a, b),
                 epilogue=lambda acc: torch.nn.functional.gelu(acc, approximate="tanh"))
    exp = jax_matmul(jnp.asarray(a), jnp.asarray(b), config=JCFG,
                     epilogue=jax.nn.gelu)
    _check(got, exp)


def test_bf16_epilogue_matches_jax():
    a, b = _u((40, 64), 7), _u((64, 136), 8)
    bias = np.linspace(-1, 1, 136).astype(np.float32)
    conv = lambda x: torch.from_numpy(x).to(torch.bfloat16)  # noqa: E731
    got = matmul(conv(a), conv(b), epilogue="bias_relu",
                 epilogue_operands=(conv(bias),))
    assert got.dtype == torch.bfloat16
    exp = jax_matmul(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
                     config=JCFG.replace(dtype="bfloat16"),
                     epilogue=JAX_EPILOGUES["bias_relu"],
                     epilogue_operands=(jnp.asarray(bias, jnp.bfloat16),))
    _check(got, np.asarray(exp, np.float32), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("out", ["int32", "float32"])
@pytest.mark.parametrize("name", ["bias_relu", "col_scale"])
def test_int8_epilogue_matches_jax(out, name):
    # The int32 accumulator meets an fp32 operand: promoted to fp32 on both
    # sides, then cast to the output dtype.  Exact.
    rng = np.random.default_rng(14)
    a = rng.integers(-9, 10, (40, 64)).astype(np.int8)
    b = rng.integers(-9, 10, (64, 129)).astype(np.int8)
    ep = np.linspace(-300, 300, 129).astype(np.float32)
    got = matmul(*_t(a, b), out_dtype=out, epilogue=name,
                 epilogue_operands=_t(ep))
    exp = jax_matmul(jnp.asarray(a), jnp.asarray(b),
                     config=JCFG.replace(dtype="int8", out_dtype=out),
                     epilogue=JAX_EPILOGUES[name],
                     epilogue_operands=(jnp.asarray(ep),))
    assert str(got.dtype) == f"torch.{out}"
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


@pytest.mark.parametrize("backend,semiring", [("cuda", "min_plus"),
                                              ("torch", "plus_times")])
def test_epilogue_rejects_other_routes(backend, semiring):
    a, b = _t(_u((8, 16), 9), _u((16, 128), 10))
    with pytest.raises(ValueError, match="plus_times"):
        matmul(a, b, semiring=semiring, backend=backend, epilogue="col_scale",
               epilogue_operands=(torch.ones(128),))
    with pytest.raises(ValueError, match="plus_times"):
        jax_matmul(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                   semiring=semiring, config=JCFG.replace(semiring=semiring),
                   backend="xla" if backend == "torch" else None,
                   epilogue=JAX_EPILOGUES["col_scale"],
                   epilogue_operands=(jnp.ones((128,)),))


@pytest.mark.parametrize("bad", [(8, 128), (127,)])
def test_epilogue_bad_operand_shape(bad):
    a, b = _u((8, 16), 11), _u((16, 128), 12)
    with pytest.raises(ValueError, match="epilogue operands"):
        matmul(*_t(a, b), epilogue="col_scale",
               epilogue_operands=(torch.ones(bad),))
    with pytest.raises(ValueError, match="epilogue operands"):
        jax_matmul(jnp.asarray(a), jnp.asarray(b), config=JCFG,
                   epilogue=JAX_EPILOGUES["col_scale"],
                   epilogue_operands=(jnp.ones(bad),))


def test_epilogue_operand_count_is_checked():
    with pytest.raises(ValueError, match="takes 2 operands"):
        matmul(torch.ones(4, 8), torch.ones(8, 16), epilogue="scale_bias",
               epilogue_operands=(torch.ones(16),))


def test_unknown_epilogue_name():
    with pytest.raises(ValueError, match="unknown epilogue"):
        matmul(torch.ones(4, 8), torch.ones(8, 16), epilogue="gelu")
    assert "softmax" in available_epilogues()


def test_callable_epilogue_refused_off_the_cpu():
    # A callable has no compiled code: any device other than the CPU (the
    # card included) raises, never running it unfused.
    a = torch.ones(8, 16, device="meta")
    b = torch.ones(16, 128, device="meta")
    with pytest.raises(NotImplementedError, match="callable epilogues"):
        matmul(a, b, epilogue=lambda acc: acc)


def _grad_case(epilogue, lead=(), ep_bwd=None, seed=13):
    a = _u(lead + (24, 48), seed)
    b = _u((48, 128), seed + 1)
    bias = np.linspace(-3, 3, 128).astype(np.float32)
    g = _u(lead + (24, 128), seed + 2, -1, 1)

    def loss(x, w, bb):
        return jnp.sum(jax_matmul(x, w, config=JCFG, epilogue=JAX_EPILOGUES[epilogue],
                                  epilogue_operands=(bb,)) * g)

    exp = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (a, b, bias)))
    xs = [t.requires_grad_() for t in _t(a, b, bias)]
    out = matmul(xs[0], xs[1], epilogue=epilogue, epilogue_operands=(xs[2],),
                 epilogue_bwd=ep_bwd)
    out.backward(torch.from_numpy(g))
    for x, e in zip(xs, exp):
        assert x.grad.shape == e.shape
        _check(x.grad, e)


@pytest.mark.parametrize("name", ["bias", "bias_relu", "bias_sigmoid",
                                  "bias_tanh", "col_scale"])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_epilogue_gradient_via_recompute(name, lead):
    # Default backward: recompute the accumulator, pull the cotangent back
    # through torch.func.vjp of the epilogue: the JAX gradients.
    _grad_case(name, lead)


@pytest.mark.parametrize("name", ["bias", "bias_relu", "bias_sigmoid",
                                  "bias_tanh"])
def test_epilogue_gradient_via_epilogue_bwd(name):
    # Output-form backward (no recompute): the same gradients.
    _grad_case(name, ep_bwd=get_epilogue(name).bwd)


def test_custom_epilogue_bwd_is_used():
    calls = []

    def ep_bwd(y, g, bias2d):
        calls.append(tuple(y.shape))
        dacc = g * (y > 0)
        return dacc, dacc.sum(0, keepdim=True)

    x = torch.from_numpy(_u((16, 32), 16)).requires_grad_()
    out = matmul(x, torch.from_numpy(_u((32, 128), 17)), epilogue="bias_relu",
                 epilogue_operands=(torch.zeros(128),), epilogue_bwd=ep_bwd)
    out.sum().backward()
    assert calls == [(16, 128)]


@pytest.mark.parametrize("name", ["bias_relu", "scale_bias", "bias_gelu"])
def test_batched_epilogue_matches_jax(name):
    # Both operands 3-D: the batched kernel (B2) with the epilogue.
    a, b = _u((4, 16, 32), 18), _u((4, 32, 128), 19)
    eps = [np.linspace(-2, 2, 128).astype(np.float32) + i
           for i in range(get_epilogue(name).n_operands)]
    got = matmul(*_t(a, b), epilogue=name, epilogue_operands=_t(*eps))
    exp = jax_matmul(jnp.asarray(a), jnp.asarray(b), interpret=True,
                     epilogue=JAX_EPILOGUES[name],
                     epilogue_operands=tuple(map(jnp.asarray, eps)))
    _check(got, exp)


def test_batched_epilogue_gradient_matches_jax():
    a, b = _u((3, 16, 32), 20), _u((3, 32, 128), 21)
    bias = np.linspace(-1, 1, 128).astype(np.float32)

    def loss(x, w, bb):
        return jnp.sum(jax_matmul(x, w, interpret=True,
                                  epilogue=JAX_EPILOGUES["bias_relu"],
                                  epilogue_operands=(bb,)) ** 2)

    exp = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (a, b, bias)))
    xs = [t.requires_grad_() for t in _t(a, b, bias)]
    (matmul(xs[0], xs[1], epilogue="bias_relu",
            epilogue_operands=(xs[2],)) ** 2).sum().backward()
    for x, e in zip(xs, exp):
        _check(x.grad, e)


def test_plain_epilogue_calls_launch_nothing():
    before = (mxu.mxu_matmul.epilogue_launches, mxu.mxu_matmul.launches)
    matmul(torch.ones(4, 8), torch.ones(8, 16), epilogue="bias",
           epilogue_operands=(torch.ones(16),))
    assert (mxu.mxu_matmul.epilogue_launches, mxu.mxu_matmul.launches) == before


# ---- fused_linear -----------------------------------------------------------

@pytest.mark.parametrize("act", sorted(ACTS))
@pytest.mark.parametrize("lead", [(), (2,)])
def test_fused_linear_forward_matches_jax(act, lead):
    x, w = _u(lead + (40, 64), 22, -1, 1), _u((64, 130), 23, -1, 1)
    b = np.linspace(-1, 1, 130).astype(np.float32)
    got = fused_linear(*_t(x, w, b), act)
    assert got.shape == lead + (40, 130)
    exp = jax_fused_linear(*map(jnp.asarray, (x, w, b)), act, JCFG)
    _check(got, exp)


@pytest.mark.parametrize("act", sorted(ACTS))
def test_fused_linear_gradients_match_jax(act):
    x, w = _u((24, 48), 24, -1, 1), _u((48, 64), 25, -1, 1)
    b = np.linspace(-0.5, 0.5, 64).astype(np.float32)

    def loss(*args):
        return jnp.sum(jax_fused_linear(*args, act, JCFG) ** 2)

    exp = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
    xs = [t.requires_grad_() for t in _t(x, w, b)]
    (fused_linear(*xs, act) ** 2).sum().backward()
    for t, e in zip(xs, exp):
        _check(t.grad, e)


def test_fused_linear_bad_activation():
    with pytest.raises(ValueError, match="activation must be"):
        fused_linear(torch.zeros(8, 16), torch.zeros(16, 128), torch.zeros(128),
                     "gelu")
