"""A serving decoder block: the quantized + flash + MoE stack composed.

End-to-end integration of the serving path -- one transformer decoder block
in the configuration a production server would run:

* **GQA attention** on the flash kernels: causal prefill, then
  padded-cache decode with per-example ``kv_lengths`` (each sequence's
  cache ends mid-buffer).
* **Quantized projections**: W8A8 on the int8 tensor cores for prefill
  (compute-bound, M = B*S rows), weight-only int4 for decode
  (weight-bandwidth-bound, M = B rows) -- same weights, two execution
  strategies.
* **MoE FFN** on the grouped GEMM: top-2 of 8 experts, tokens sorted by
  expert, one ragged kernel launch for any routing.

Everything is verified against a dense float32 reference of the same block;
the only error budget is the quantization itself.

The port of ``examples/15_serving_decoder.py`` to ``gemm_hls_tpu_torch``:
the same sizes, seeds, printed lines and checks.  The block is the port's
module ``gemm_hls_tpu_torch/models/serving.py`` (``make_block``,
``block_prefill``, ``block_decode``), which ``chip_smoke.py`` also drives
at ``experiments/serving_bench.py``'s width.  On the card the prefill runs
kernels B14 / B15 (W8A8), B6-B8 (flash) and B16 (the experts), the decode
B13 (int4), B6-B8 and B16; ``--device cpu`` runs their plain versions.
Differences from the reference: the MoE parameters come from a
``torch.Generator`` seeded 0 (the numbers differ from ``jax.random``'s);
k and v keep the (B, S, H_kv, D) layout that seeds the cache.

    python examples/torch/15_serving_decoder.py [--device cuda|cpu]
"""

import argparse
import math

import numpy as np
import torch

from gemm_hls_tpu_torch.models.moe import moe_forward
from gemm_hls_tpu_torch.models.serving import block_decode, block_prefill, make_block
from gemm_hls_tpu_torch.ops.quant import dequantize_weights

B, S, S_MAX = 2, 64, 96          # batch, prefill length, cache capacity
H_Q, H_KV, D_HEAD = 8, 2, 32     # GQA: 8 query heads share 2 kv heads
D = H_Q * D_HEAD                 # d_model
DIMS = dict(h_q=H_Q, h_kv=H_KV, d_head=D_HEAD)


def ref_block(x, dense, moe, moe_cfg):
    """Dense f32 reference of the same prefill block."""
    b, s, _ = x.shape
    flat = x.reshape(b * s, D)
    q, k, v = ((flat @ dense[n]).reshape(b, s, -1, D_HEAD).transpose(1, 2)
               for n in ("wq", "wk", "wv"))
    k = k.repeat_interleave(H_Q // H_KV, dim=1)
    v = v.repeat_interleave(H_Q // H_KV, dim=1)
    sc = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(D_HEAD)
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=x.device))
    p = torch.softmax(torch.where(mask, sc, -torch.inf), dim=-1)
    att = torch.einsum("bhqk,bhkd->bhqd", p, v).transpose(1, 2).reshape(b * s, -1)
    y = x + (att @ dense["wo"]).reshape(b, s, D)
    ffn = moe_forward(moe, y.reshape(b * s, D), moe_cfg)
    return y + ffn.reshape(b, s, D), y


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default): the kernels on the card; cpu: their plain versions")
    dev = p.parse_args(argv).device
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the plain versions")

    rng = np.random.default_rng(5)
    dense_np, quant, quant4, moe, moe_cfg = make_block(
        rng, d_model=D, h_q=H_Q, h_kv=H_KV, d_head=D_HEAD, d_ff=2 * D, group_size=32,
        device=dev)
    dense = {n: torch.from_numpy(w).to(dev) for n, w in dense_np.items()}
    x = torch.from_numpy(rng.standard_normal((B, S, D)) * 0.5).to(dev, torch.float32)

    # --- prefill ------------------------------------------------------
    y, y_attn, k_pre, v_pre = block_prefill(x, quant, moe, moe_cfg, **DIMS)
    want, want_attn = ref_block(x, dense, moe, moe_cfg)
    rel_attn = float((y_attn - want_attn).abs().max() / want_attn.abs().max())
    print(f"prefill attention (W8A8 proj + causal GQA flash): "
          f"rel err {rel_attn:.4f}")
    assert rel_attn < 0.05, rel_attn        # W8A8 quantization budget
    # After the MoE the discrete top-k routing can FLIP for tokens whose
    # router logits sit within the ~1% quantization perturbation -- a real
    # serving phenomenon; judge the block by the token-median error, and
    # count the flipped outliers.
    tok_err = ((y - want).abs().amax(-1) / want.abs().max()).reshape(-1)
    med = float(tok_err.median())
    frac_flipped = float((tok_err > 0.1).float().mean())
    print(f"prefill full block: median token err {med:.4f}, "
          f"{frac_flipped:.1%} tokens routing-flipped")
    assert med < 0.05, med
    assert frac_flipped < 0.1, frac_flipped

    # --- decode against a padded cache --------------------------------
    # Seed the cache with the prefill's K/V, then stagger the logical
    # lengths so the padded-cache masking is real.
    cache_k = torch.zeros((B, S_MAX, H_KV, D_HEAD), device=dev)
    cache_v = torch.zeros((B, S_MAX, H_KV, D_HEAD), device=dev)
    cache_k[:, :S] = k_pre
    cache_v[:, :S] = v_pre
    lengths = torch.tensor([S, S - 17], dtype=torch.int32, device=dev)
    ref_k, ref_v, ref_len = cache_k.clone(), cache_v.clone(), lengths.clone()

    x_tok = torch.from_numpy(rng.standard_normal((B, D)) * 0.5).to(dev, torch.float32)
    y_tok, cache_k2, cache_v2, lengths2 = block_decode(
        x_tok, cache_k, cache_v, lengths, quant4, moe, moe_cfg, group_size=32, **DIMS)

    # Decode reference: dense attention over each example's ragged logical
    # prefix, int4 weights dequantized on the host -- the kernels are exact
    # against the quantized weights, so this matches to fp error, not a
    # quantization budget.
    d4 = {n: torch.from_numpy(np.asarray(dequantize_weights(
        wq.cpu().numpy(), sc.cpu().numpy(), bits=4, group_size=32))).to(dev)
          for n, (wq, sc) in quant4.items()}
    q_r = (x_tok @ d4["wq"]).reshape(B, H_Q, D_HEAD)
    k_r = (x_tok @ d4["wk"]).reshape(B, H_KV, D_HEAD)
    v_r = (x_tok @ d4["wv"]).reshape(B, H_KV, D_HEAD)
    att_rows = []
    for i in range(B):
        n = int(ref_len[i])
        kk = torch.cat([ref_k[i, :n], k_r[i][None]]).repeat_interleave(H_Q // H_KV, dim=1)
        vv = torch.cat([ref_v[i, :n], v_r[i][None]]).repeat_interleave(H_Q // H_KV, dim=1)
        sc_i = torch.einsum("hd,khd->hk", q_r[i], kk) / math.sqrt(D_HEAD)
        att_rows.append(torch.einsum("hk,khd->hd", torch.softmax(sc_i, -1), vv).reshape(-1))
    y_ref = x_tok + torch.stack(att_rows) @ d4["wo"]
    y_ref = y_ref + moe_forward(moe, y_ref, moe_cfg)
    rel = float((y_tok - y_ref).abs().max() / y_ref.abs().max())
    print(f"decode (int4 proj + padded-cache flash + MoE): rel err "
          f"{rel:.2e} vs ragged dense reference")
    assert rel < 1e-3, rel

    x_tok2, lengths = y_tok, lengths2
    for _ in range(2):
        x_tok2, cache_k2, cache_v2, lengths = block_decode(
            x_tok2, cache_k2, cache_v2, lengths, quant4, moe, moe_cfg, group_size=32,
            **DIMS)
        assert bool(torch.isfinite(x_tok2).all())
    print(f"decode x3: lengths {lengths.tolist()}, output finite")
    print("serving decoder block OK")


if __name__ == "__main__":
    main()
