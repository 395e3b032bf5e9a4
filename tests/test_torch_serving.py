"""The serving decoder block of the port (``models/serving.py``:
``block_prefill``, ``block_decode``) against
``examples/15_serving_decoder.py``'s on the CPU, at the example's size; and
the ``bias_gelu`` epilogue the port's example 10 fuses, against the JAX
``matmul(..., epilogue=_bias_gelu)``.

The example is loaded with importlib and builds its own weights and MoE
parameters (``make_block``); the port gets the same numpy weights and the
MoE parameters through ``serving.params_from_reference(..., device="cpu")``.
The JAX side runs its Pallas kernels in interpret mode, the port its plain
versions.  Tolerance: relative error 1e-3 of the largest output (the same
W8A8 / int4 quantization on both sides, fp32 sums in other orders); the
epilogue at ``tests/test_epilogue.py``'s rtol 1e-4, atol 1e-5.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemm_hls_tpu import GemmConfig as JaxConfig
from gemm_hls_tpu import matmul as jax_matmul
from gemm_hls_tpu.utils import make_operands

from gemm_hls_tpu_torch import matmul
from gemm_hls_tpu_torch.models import moe as tmoe
from gemm_hls_tpu_torch.models import serving

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-3


@pytest.fixture(scope="module")
def example():
    spec = importlib.util.spec_from_file_location(
        "serving_decoder_example", REPO / "examples" / "15_serving_decoder.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    rng = np.random.default_rng(5)
    dense, quant, quant4, moe, moe_cfg = ex.make_block(rng)
    x = rng.standard_normal((ex.B, ex.S, ex.D)).astype(np.float32) * 0.5
    _, tquant, tquant4, tparams = serving.params_from_reference(dense, quant, quant4, moe,
                                                                device="cpu")
    port = dict(
        quant=tquant, quant4=tquant4, moe=tparams,
        cfg=tmoe.MoEConfig(d_model=moe_cfg.d_model, d_ff=moe_cfg.d_ff,
                           num_experts=moe_cfg.num_experts, top_k=moe_cfg.top_k),
        dims=dict(h_q=ex.H_Q, h_kv=ex.H_KV, d_head=ex.D_HEAD))
    return ex, (quant, quant4, moe, moe_cfg), port, x


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def test_serving_prefill_vs_example(example):
    ex, (quant, _, moe, moe_cfg), port, x = example
    y, y_attn, k, v = ex.block_prefill(jnp.asarray(x), quant, moe, moe_cfg)
    ty, ty_attn, tk, tv = serving.block_prefill(
        torch.from_numpy(x), port["quant"], port["moe"], port["cfg"], **port["dims"])
    assert _rel(ty_attn.numpy(), y_attn) < TOL
    assert _rel(ty.numpy(), y) < TOL
    # The example returns k, v as (B * H_kv, S, D); the port keeps (B, S, H_kv, D).
    b, s, h, d = tk.shape
    assert _rel(tk.permute(0, 2, 1, 3).reshape(b * h, s, d).numpy(), k) < TOL
    assert _rel(tv.permute(0, 2, 1, 3).reshape(b * h, s, d).numpy(), v) < TOL


def test_serving_prefill_two_pass_route(example):
    # The two-pass W8A8 route (per-row activation scales) stays inside the
    # example's quantization budget against its dense reference.
    ex, (_, _, moe, moe_cfg), port, x = example
    dense = ex.make_block(np.random.default_rng(5))[0]
    _, want_attn = ex.ref_block(jnp.asarray(x), dense, moe, moe_cfg)
    _, ty_attn, _, _ = serving.block_prefill(
        torch.from_numpy(x), port["quant"], port["moe"], port["cfg"],
        fuse_quant=False, **port["dims"])
    assert _rel(ty_attn.numpy(), want_attn) < 0.05


def test_serving_decode_vs_example(example):
    ex, (quant, quant4, moe, moe_cfg), port, x = example
    _, _, k_pre, v_pre = ex.block_prefill(jnp.asarray(x), quant, moe, moe_cfg)
    shape = (ex.B, ex.S_MAX, ex.H_KV, ex.D_HEAD)
    cache_k, cache_v = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    cache_k[:, :ex.S] = np.asarray(k_pre).reshape(
        ex.B, ex.H_KV, ex.S, ex.D_HEAD).transpose(0, 2, 1, 3)
    cache_v[:, :ex.S] = np.asarray(v_pre).reshape(
        ex.B, ex.H_KV, ex.S, ex.D_HEAD).transpose(0, 2, 1, 3)
    lengths = np.asarray([ex.S, ex.S - 17], np.int32)
    x_tok = np.random.default_rng(6).standard_normal((ex.B, ex.D)).astype(np.float32) * 0.5
    jk, jv, jl = jnp.asarray(cache_k), jnp.asarray(cache_v), jnp.asarray(lengths)
    tk, tv, tl = (torch.from_numpy(a.copy()) for a in (cache_k, cache_v, lengths))
    jx, tx = jnp.asarray(x_tok), torch.from_numpy(x_tok)
    for step in range(3):
        jx, jk, jv, jl = ex.block_decode(jx, jk, jv, jl, quant4, moe, moe_cfg)
        tx, tk2, tv2, tl = serving.block_decode(
            tx, tk, tv, tl, port["quant4"], port["moe"], port["cfg"],
            group_size=32, **port["dims"])
        assert tk2 is tk and tv2 is tv          # written in place
        assert _rel(tx.numpy(), jx) < TOL, step
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        assert _rel(tk.numpy(), jk) < TOL and _rel(tv.numpy(), jv) < TOL
        assert torch.isfinite(tx).all()


def _top2(y, router):
    """Each token's two largest router logits' experts, as a set."""
    logits = np.asarray(y, np.float64).reshape(-1, router.shape[0]) @ np.asarray(router,
                                                                                  np.float64)
    return [frozenset(row) for row in np.argsort(-logits, axis=-1)[:, :2]]


def test_serving_block_routing_agrees(example):
    # The MoE sublayer of the whole block: at least 95% of the tokens take
    # the same top-2 experts on both sides (the router reads the attention
    # sublayer's output, where the two sides differ by fp32 sums in other
    # orders), and those tokens' outputs match at rel 1e-3.
    ex, (quant, _, moe, moe_cfg), port, x = example
    y, y_attn, _, _ = ex.block_prefill(jnp.asarray(x), quant, moe, moe_cfg)
    ty, ty_attn, _, _ = serving.block_prefill(
        torch.from_numpy(x), port["quant"], port["moe"], port["cfg"], **port["dims"])
    router = np.asarray(moe["router"])
    same = np.array([a == b for a, b in zip(_top2(y_attn, router),
                                            _top2(ty_attn.numpy(), router))])
    assert same.mean() >= 0.95, same.mean()
    got, want = ty.numpy().reshape(-1, ex.D)[same], np.asarray(y).reshape(-1, ex.D)[same]
    assert _rel(got, want) < TOL


def _bias_gelu(acc, b):
    return jax.nn.gelu(acc + b)


def test_bias_gelu_epilogue_matches_jax():
    # tests/test_epilogue.py::test_bias_relu_fused's operands and blocks.
    a, b = make_operands(40, 129, 64, "float32", low=-5.0, high=5.0)
    bias = np.linspace(-10, 10, 129).astype(np.float32)
    got = matmul(torch.from_numpy(a), torch.from_numpy(b), epilogue="bias_gelu",
                 epilogue_operands=(torch.from_numpy(bias),))
    exp = jax_matmul(jnp.asarray(a), jnp.asarray(b),
                     config=JaxConfig(block_m=32, block_n=128, block_k=128, interpret=True),
                     epilogue=_bias_gelu, epilogue_operands=(jnp.asarray(bias),))
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-4, atol=1e-5)


def test_bias_gelu_batched_epilogue_matches_jax():
    # tests/test_epilogue.py::test_batched_epilogue_fused's operands.
    rng = np.random.default_rng(5)
    a = rng.uniform(-2, 2, (4, 16, 32)).astype(np.float32)
    b = rng.uniform(-2, 2, (4, 32, 128)).astype(np.float32)
    bias = np.linspace(-2, 2, 128).astype(np.float32)
    got = matmul(torch.from_numpy(a), torch.from_numpy(b), epilogue="bias_gelu",
                 epilogue_operands=(torch.from_numpy(bias),))
    exp = jax_matmul(jnp.asarray(a), jnp.asarray(b), interpret=True, epilogue=_bias_gelu,
                     epilogue_operands=(jnp.asarray(bias),))
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-4, atol=1e-5)
