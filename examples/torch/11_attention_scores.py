"""Fused attention scores: softmax(Q.K^T/sqrt(d)) computed *inside* the
batched CA-GEMM kernel's store, plus the full attention product.

The thin-K scores shape (B=heads, M=N=seq, K=head_dim) is where a
standalone GEMM kernel pays for writing the raw scores; ``attention_scores``
fuses the softmax consumer into the batched kernel instead -- the row
softmax runs on the fp32 accumulator, legal because the kernel holds each
example's full score row.

The port of ``examples/11_attention_scores.py`` to ``gemm_hls_tpu_torch``:
the same sizes, printed lines and checks.  On the card the scores run
kernel B2's row-softmax variant (fp32 operands: ``csrc/row_softmax.cu``;
bf16 / fp16 ones take ``csrc/row_softmax_wgmma.cu`` on the tile engine)
and p . v kernel B2; ``--device cpu`` runs their plain versions.  The
operands come from a ``torch.Generator`` seeded 5 (the numbers differ
from ``jax.random``'s).

    python examples/torch/11_attention_scores.py [--device cuda|cpu]
"""

import argparse
import math

import torch

from gemm_hls_tpu_torch.ops.attention import attention, attention_scores

HEADS, SEQ, D_HEAD = 4, 256, 64
DTYPE = torch.float32


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default): the kernels on the card; cpu: their plain versions")
    dev = p.parse_args(argv).device
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the plain versions")

    gen = torch.Generator().manual_seed(5)
    q, k, v = ((torch.rand((HEADS, SEQ, D_HEAD), generator=gen, dtype=DTYPE) * 2 - 1)
               .to(dev) for _ in range(3))

    # --- fused scores: softmax runs inside the batched kernel ---
    p_ = attention_scores(q, k)
    rows = p_.sum(-1)
    print(f"scores {tuple(p_.shape)}: rows sum to 1 within "
          f"{float((rows - 1.0).abs().max()):.2e}")

    # verify against the unfused composition
    s = torch.einsum("bqd,bkd->bqk", q, k) / math.sqrt(D_HEAD)
    ref = torch.softmax(s, dim=-1)
    err = float((p_ - ref).abs().max())
    print(f"fused vs unfused softmax max abs diff: {err:.2e}")
    assert err < 1e-5

    # --- full attention: two batched GEMMs, softmax fused in the first ---
    out = attention(q, k, v)
    ref_out = torch.einsum("bqk,bkd->bqd", ref, v)
    err = float((out - ref_out).abs().max())
    print(f"attention {tuple(out.shape)}: max abs diff vs reference {err:.2e}")
    assert err < 1e-4

    # --- and it trains: gradients flow through the fused softmax ---
    qg = q.detach().requires_grad_()
    g, = torch.autograd.grad((attention(qg, k, v) ** 2).sum(), qg)
    print(f"dL/dq {tuple(g.shape)}: finite={bool(torch.isfinite(g).all())}")


if __name__ == "__main__":
    main()
