"""Fused-scores attention (``attention_scores``, ``attention``) against the
JAX package's ``tests/test_attention.py`` cases.

The same numpy inputs go through ``gemm_hls_tpu.ops.attention`` (Pallas in
interpret mode) and the port (the plain versions, as CPU tensors run them:
the row-softmax epilogue's torch function where the port fuses, the fp32
scores and a softmax where it does not).  Tolerances: relative 1e-3
(absolute 1e-6 for probabilities near zero) for fp32 outputs and
gradients; relative 1e-2 for bf16.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemm_hls_tpu.ops.attention import attention as jax_attention
from gemm_hls_tpu.ops.attention import attention_scores as jax_scores

from gemm_hls_tpu_torch import attention, attention_scores
from gemm_hls_tpu_torch.config import ROW_SOFTMAX_MAX_N, GemmConfig
from gemm_hls_tpu_torch.ops import attention as attn_mod

torch.set_num_threads(1)

RTOL = 1e-3


def _u(shape, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _ref_scores(q, k, scale):
    s = np.asarray(q, np.float64) @ np.asarray(k, np.float64).transpose(
        0, 2, 1) * scale
    e = np.exp(s - s.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _routes(monkeypatch):
    """Record the epilogue of every matmul the attention module makes."""
    mm = importlib.import_module("gemm_hls_tpu_torch.ops.matmul")

    seen, real = [], mm.matmul

    def spy(*args, **kw):
        seen.append(kw.get("epilogue"))
        return real(*args, **kw)

    # The attention module imports matmul at call time, so it sees the spy.
    assert not hasattr(attn_mod, "matmul")
    monkeypatch.setattr(mm, "matmul", spy)
    return seen


@pytest.mark.parametrize("shape", [(4, 64, 48, 32), (2, 33, 130, 16)])
def test_scores_match_jax(shape, monkeypatch):
    b, sq, sk, d = shape
    q, k = _u((b, sq, d), 1, -2, 2), _u((b, sk, d), 2, -2, 2)
    routes = _routes(monkeypatch)
    got = attention_scores(torch.from_numpy(q), torch.from_numpy(k))
    assert routes == ["softmax"]  # fused: the row-softmax epilogue
    exp = jax_scores(jnp.asarray(q), jnp.asarray(k), interpret=True)
    assert got.shape == (b, sq, sk)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(got.numpy(), _ref_scores(q, k, d ** -0.5),
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(got.numpy().sum(-1), 1.0, rtol=1e-5)


def test_scores_custom_scale():
    q, k = _u((2, 16, 8), 3), _u((2, 16, 8), 4)
    got = attention_scores(torch.from_numpy(q), torch.from_numpy(k), scale=0.25)
    exp = jax_scores(jnp.asarray(q), jnp.asarray(k), scale=0.25,
                     interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=RTOL,
                               atol=1e-6)


def test_scores_fallback_when_not_batched_routable(monkeypatch):
    # A row longer than the row-softmax kernel's shared-memory strip takes
    # the unfused branch (fp32 scores, then a softmax) and still matches.
    q, k = _u((1, 8, 16), 5), _u((1, ROW_SOFTMAX_MAX_N + 100, 16), 6)
    routes = _routes(monkeypatch)
    got = attention_scores(torch.from_numpy(q), torch.from_numpy(k))
    assert routes == [None]
    np.testing.assert_allclose(got.numpy(), _ref_scores(q, k, 0.25),
                               rtol=RTOL, atol=1e-7)
    exp = jax_scores(jnp.asarray(q), jnp.asarray(k), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=RTOL,
                               atol=1e-7)


def test_scores_fallback_for_strict_padding(monkeypatch):
    q, k = _u((2, 128, 32), 7), _u((2, 128, 32), 8)
    routes = _routes(monkeypatch)
    cfg = GemmConfig(block_m=32, block_n=128, block_k=32, pad_policy="strict")
    got = attention_scores(torch.from_numpy(q), torch.from_numpy(k), config=cfg)
    assert routes == [None]
    np.testing.assert_allclose(got.numpy(), _ref_scores(q, k, 32 ** -0.5),
                               rtol=RTOL, atol=1e-6)


def test_scores_bf16_match_jax():
    q, k = _u((2, 40, 64), 9, -3, 3), _u((2, 72, 64), 10, -3, 3)
    conv = lambda x: torch.from_numpy(x).to(torch.bfloat16)  # noqa: E731
    got = attention_scores(conv(q), conv(k))
    assert got.dtype == torch.bfloat16
    exp = jax_scores(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                     interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(exp, np.float32),
                               rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("shape", [(3, 32, 40, 16), (2, 17, 65, 8)])
def test_attention_matches_jax(shape):
    b, sq, sk, d = shape
    q, k, v = _u((b, sq, d), 11), _u((b, sk, d), 12), _u((b, sk, d), 13)
    got = attention(*map(torch.from_numpy, (q, k, v)))
    exp = jax_attention(*map(jnp.asarray, (q, k, v)), interpret=True)
    assert got.shape == (b, sq, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=RTOL,
                               atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), _ref_scores(q, k, d ** -0.5) @ v.astype(np.float64),
        rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("s_k", [16, ROW_SOFTMAX_MAX_N + 64])
def test_attention_gradient_matches_jax(s_k):
    q, k, v = _u((2, 16, 8), 14), _u((2, s_k, 8), 15), _u((2, s_k, 8), 16)

    def loss(*xs):
        return jnp.sum(jax_attention(*xs, interpret=True) ** 2)

    exp = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (attention(*xs) ** 2).sum().backward()
    for x, e in zip(xs, exp):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(e), rtol=RTOL,
                                   atol=1e-6)


def test_scores_rejects_2d():
    with pytest.raises(ValueError, match="expects"):
        attention_scores(torch.zeros(8, 4), torch.zeros(8, 4))
    with pytest.raises(ValueError, match="expects"):
        jax_scores(jnp.zeros((8, 4)), jnp.zeros((8, 4)))
