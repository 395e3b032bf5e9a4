"""The serving decoder block of ``chip_smoke.py`` (``serving_prefill``,
``serving_decode``) against ``examples/15_serving_decoder.py``'s
``block_prefill`` / ``block_decode`` on the CPU, at the example's size.

The example is loaded with importlib and builds its own weights and MoE
parameters (``make_block``); the port gets the same numpy weights and the
MoE parameters through ``params_from_reference(..., device="cpu")``.  The
JAX side runs its Pallas kernels in interpret mode, the port its plain
versions.  Tolerance: relative error 1e-3 of the largest output (the same
W8A8 / int4 quantization on both sides, fp32 sums in other orders).
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gemm_hls_tpu_torch.models import moe as tmoe

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
    port = dict(
        quant={k: tuple(torch.from_numpy(a) for a in v) for k, v in quant.items()},
        quant4={k: tuple(torch.from_numpy(a) for a in v) for k, v in quant4.items()},
        moe=tmoe.params_from_reference(moe, device="cpu"),
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
    ty, ty_attn, tk, tv = chip_smoke.serving_prefill(
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
    _, ty_attn, _, _ = chip_smoke.serving_prefill(
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
        tx, tk2, tv2, tl = chip_smoke.serving_decode(
            tx, tk, tv, tl, port["quant4"], port["moe"], port["cfg"],
            group_size=32, **port["dims"])
        assert tk2 is tk and tv2 is tv          # written in place
        assert _rel(tx.numpy(), jx) < TOL, step
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        assert _rel(tk.numpy(), jk) < TOL and _rel(tv.numpy(), jv) < TOL
        assert torch.isfinite(tx).all()
