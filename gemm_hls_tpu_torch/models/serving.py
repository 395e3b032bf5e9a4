"""The serving decoder block of ``examples/15_serving_decoder.py``: one
transformer decoder block as a production server runs it, composed of the
port's quantized, flash and MoE paths.

* prefill (:func:`block_prefill`): W8A8 projections over the B S rows
  (``matmul_w8a8``: kernels B14 / B15), causal GQA flash attention on the
  4-D (B, S, H, D) layout read in place (B6-B8), the residual, the MoE FFN
  on the grouped GEMM (B16);
* decode (:func:`block_decode`): int4 weight-only projections over the B
  rows (``matmul_quantized``: B13), the new K / V written at each
  sequence's logical end of a padded cache, flash attention with
  per-sequence lengths, the MoE FFN.

Every intermediate is in x's type.  :func:`prefill_plain` and
:func:`decode_plain` are the same block in plain PyTorch (``torch.matmul``,
``scaled_dot_product_attention``, a per-expert loop), the references the
card's runs are held to.  :func:`make_block` draws the weights as the
example does (numpy, seeded) and quantizes them; :func:`serving_setup`
builds the block at a given width on the card, as
``experiments/serving_bench.py`` draws it; :func:`params_from_reference`
carries the JAX example's own weights across.  Imports neither jax nor
``gemm_hls_tpu``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from gemm_hls_tpu_torch.models import moe as moe_mod
from gemm_hls_tpu_torch.models.moe import MoEConfig, gelu_tanh, init_moe_params, moe_forward
from gemm_hls_tpu_torch.ops import dequant, quant
from gemm_hls_tpu_torch.ops.attention import flash_attention
from gemm_hls_tpu_torch.ops.quant import matmul_quantized, matmul_w8a8, quantize_weights


def _w8a8_proj(a, wq, sc, out_dtype, fuse_quant):
    """A prefill projection: ``matmul_w8a8`` (its fused route, B14, where
    the JAX rule allows), or the same resolution through the two-pass
    route (B15)."""
    if fuse_quant:
        return matmul_w8a8(a, wq, sc, out_dtype=out_dtype)
    cfg = quant.w8a8_resolve(a.shape[0], wq.shape[1], a.shape[1], None, out_dtype)
    return dequant.w8a8_matmul(a, wq, sc, cfg=cfg, fuse_quant=False)


def block_prefill(x, quant_w, moe, moe_cfg, *, h_q, h_kv, d_head, fuse_quant=True):
    """Prefill (``examples/15_serving_decoder.py::block_prefill``): x (B, S,
    d_model), ``quant_w`` {name: (int8 weights, per-channel scales)} of
    "wq", "wk", "wv", "wo".  Returns (block output, attention sublayer
    output y, k, v), k and v (B, S, H_kv, D)."""
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    proj = {name: _w8a8_proj(flat, *quant_w[name], x.dtype, fuse_quant)
            for name in ("wq", "wk", "wv")}
    q = proj["wq"].reshape(b, s, h_q, d_head)
    k = proj["wk"].reshape(b, s, h_kv, d_head)
    v = proj["wv"].reshape(b, s, h_kv, d_head)
    att = flash_attention(q, k, v, causal=True, block_q=32, block_kv=32)
    out = _w8a8_proj(att.reshape(b * s, -1), *quant_w["wo"], x.dtype, fuse_quant)
    y = x + out.reshape(b, s, d)
    ffn = moe_forward(moe, y.reshape(b * s, d), moe_cfg)
    return y + ffn.reshape(b, s, d), y, k, v


def block_decode(x_tok, cache_k, cache_v, lengths, quant4, moe, moe_cfg, *,
                 h_q, h_kv, d_head, group_size):
    """One-token decode (``examples/15_serving_decoder.py::block_decode``):
    int4 projections (B13) over the B rows, the new K / V written at each
    sequence's logical end in place (``index_put_`` on the (B, S_max, H_kv,
    D) caches, where the JAX example's functional ``.at[].set`` copies),
    padded-cache flash attention with per-sequence lengths, the MoE FFN.
    Returns (output, cache_k, cache_v, lengths + 1)."""
    b = x_tok.shape[0]

    def mq(a, name):
        return matmul_quantized(a, *quant4[name], bits=4, group_size=group_size)

    q = mq(x_tok, "wq").reshape(b, 1, h_q, d_head)
    k_new = mq(x_tok, "wk").reshape(b, 1, h_kv, d_head)
    v_new = mq(x_tok, "wv").reshape(b, 1, h_kv, d_head)
    at = (torch.arange(b, device=x_tok.device), lengths.long())
    cache_k.index_put_(at, k_new[:, 0])
    cache_v.index_put_(at, v_new[:, 0])
    lengths = lengths + 1
    att = flash_attention(q, cache_k, cache_v, causal=True, kv_lengths=lengths,
                          block_q=32, block_kv=32)
    y = x_tok + mq(att.reshape(b, h_q * d_head), "wo")
    return y + moe_forward(moe, y, moe_cfg), cache_k, cache_v, lengths


# ---- the plain references ---------------------------------------------------

def moe_plain(params, x, cfg):
    """The MoE FFN as a plain per-expert loop: each expert's routed tokens
    gathered (their count read on the host), two ``torch.matmul``, the tanh
    GELU, the mix; ``torch.topk`` routing."""
    logits = x.float() @ params["router"]
    top, ids = torch.topk(logits, cfg.top_k, dim=-1)
    mix = torch.softmax(top, dim=-1)
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(cfg.num_experts):
        tok, slot = torch.nonzero(ids == e, as_tuple=True)
        if tok.numel():
            h = gelu_tanh(x[tok] @ params["w1"][e]).to(params["w2"].dtype)
            y.index_add_(0, tok, (h @ params["w2"][e]).float() * mix[tok, slot, None])
    return y.to(x.dtype)


def attention_plain(q, k, v, causal, lens=None):
    """GQA attention on (B, S, H, D) by ``scaled_dot_product_attention`` (kv
    heads repeated); ``lens`` masks the cache slots at or past each
    sequence's length (the query at the cache end)."""
    rep = q.shape[2] // k.shape[2]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    kh, vh = kh.repeat_interleave(rep, 1), vh.repeat_interleave(rep, 1)
    mask = None
    if lens is not None:
        mask = (torch.arange(k.shape[1], device=k.device)[None, :]
                < lens[:, None])[:, None, None, :]
    o = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                       is_causal=causal and lens is None)
    return o.transpose(1, 2)


def prefill_plain(x, dense, moe, moe_cfg, *, h_q, h_kv, d_head):
    """The prefill block in plain PyTorch with the un-quantized weights
    ``dense`` {name: (K, N) tensor}: ``torch.matmul``, SDPA, the per-expert
    loop.  Returns (block output, attention sublayer output)."""
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    q, k, v = (flat @ dense[n] for n in ("wq", "wk", "wv"))
    att = attention_plain(q.reshape(b, s, h_q, d_head), k.reshape(b, s, h_kv, d_head),
                          v.reshape(b, s, h_kv, d_head), True)
    y = x + (att.reshape(b * s, -1) @ dense["wo"]).reshape(b, s, d)
    return y + moe_plain(moe, y.reshape(b * s, d), moe_cfg).reshape(b, s, d), y


def decode_plain(x_tok, cache_k, cache_v, lengths, dense4, moe, moe_cfg, *,
                 h_q, h_kv, d_head):
    """The decode step in plain PyTorch with the int4 weights dequantized as
    the kernel expands them (``dense4``: q s in x's type, as
    :func:`serving_setup` makes them): ``torch.matmul``, the new token
    written in place, SDPA over each sequence's live slots (the caller's
    cache holds zeros past the lengths), the per-expert loop.  Returns (output, lengths + 1)."""
    b = x_tok.shape[0]
    q = (x_tok @ dense4["wq"]).reshape(b, 1, h_q, d_head)
    at = (torch.arange(b, device=x_tok.device), lengths.long())
    cache_k.index_put_(at, (x_tok @ dense4["wk"]).reshape(b, h_kv, d_head))
    cache_v.index_put_(at, (x_tok @ dense4["wv"]).reshape(b, h_kv, d_head))
    lengths = lengths + 1
    att = attention_plain(q, cache_k, cache_v, True, lengths)
    y = x_tok + att.reshape(b, h_q * d_head) @ dense4["wo"]
    return y + moe_plain(moe, y, moe_cfg), lengths


# ---- weights ----------------------------------------------------------------

def _on(pair, device):
    return tuple(torch.as_tensor(np.asarray(a)).to(device) for a in pair)


def make_block(rng, *, d_model, h_q, h_kv, d_head, d_ff, num_experts=8, top_k=2,
               group_size=32, dtype="float32", device="cuda", moe_seed=0):
    """The block's weights as ``examples/15_serving_decoder.py::make_block``
    draws them: dense f32 (K, N) projections from ``rng`` (numpy), each
    quantized to int8 per-channel (prefill) and int4 ``group_size`` (decode);
    the MoE parameters from a ``torch.Generator`` seeded ``moe_seed`` (the
    numbers differ from ``jax.random``'s).  Returns (dense {name: numpy
    f32}, quant {name: (int8, scales)} and quant4 on ``device``, moe params,
    MoEConfig)."""
    shapes = {"wq": (d_model, h_q * d_head), "wk": (d_model, h_kv * d_head),
              "wv": (d_model, h_kv * d_head), "wo": (h_q * d_head, d_model)}
    dense = {n: (rng.standard_normal(sh) / np.sqrt(sh[0])).astype(np.float32)
             for n, sh in shapes.items()}
    quant_w = {n: _on(quantize_weights(w, bits=8), device) for n, w in dense.items()}
    quant4 = {n: _on(quantize_weights(w, bits=4, group_size=group_size), device)
              for n, w in dense.items()}
    cfg = MoEConfig(d_model=d_model, d_ff=d_ff, num_experts=num_experts, top_k=top_k,
                    dtype=dtype)
    moe = init_moe_params(torch.Generator(device=device).manual_seed(moe_seed), cfg)
    return dense, quant_w, quant4, moe, cfg


def serving_setup(width, seed=5, device="cuda"):
    """The block at ``width`` (``chip_smoke.SERVING``'s keys: d_model, h_q,
    h_kv, d_head, d_ff, experts, top_k, group), seeded as
    ``experiments/serving_bench.py`` draws it: bf16 copies of the dense
    projections, int8 per-channel (prefill) and int4 (decode) copies, bf16
    copies of the dequantized int4 weights, and bf16 MoE parameters.
    Returns (dense, quant, quant4, dense4, moe, MoEConfig)."""
    c = width
    dense, q8, q4, moe, cfg = make_block(
        np.random.default_rng(seed), d_model=c["d_model"], h_q=c["h_q"], h_kv=c["h_kv"],
        d_head=c["d_head"], d_ff=c["d_ff"], num_experts=c["experts"], top_k=c["top_k"],
        group_size=c["group"], dtype="bfloat16", device=device)
    # The int4 weights as the B13 kernel expands them: the plain kernel on an
    # identity.
    dense4 = {n: dequant.dequant_matmul_plain(
        torch.eye(wq.shape[0] * 2, device=device, dtype=torch.bfloat16), wq, sc, bits=4,
        group_size=c["group"]) for n, (wq, sc) in q4.items()}
    dense = {n: torch.from_numpy(w).to(device).to(torch.bfloat16) for n, w in dense.items()}
    return dense, q8, q4, dense4, moe, cfg


def params_from_reference(dense, quant, quant4, moe, device="cuda"):
    """The JAX example's block (``make_block``'s numpy weights and int8 /
    int4 copies, its MoE parameters as jax or numpy arrays) as the port's:
    (dense {name: f32 tensor}, quant, quant4 {name: (weights, scales)}, moe
    params), on ``device`` (the card unless the caller names another)."""
    return ({n: torch.as_tensor(np.asarray(w)).to(device) for n, w in dense.items()},
            {n: _on(p, device) for n, p in quant.items()},
            {n: _on(p, device) for n, p in quant4.items()},
            moe_mod.params_from_reference(moe, device=device))
