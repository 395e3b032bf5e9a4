"""A transformer block on the CA-GEMM kernels: every matmul in one
attention + MLP block routed through ``gemm_hls_tpu_torch.matmul`` -- fused
bias epilogues for the projections, the batched GEMM for the per-head
attention products.

The port of ``examples/10_transformer_block.py`` to ``gemm_hls_tpu_torch``:
the same sizes, block, printed lines and check.  On the card the
projections run kernel B1 with its fused epilogue (``csrc/mxu_wgmma.cuh``)
and the per-head products kernel B2; ``--device cpu`` runs their plain
versions.  Differences from the reference: the fused epilogues are the
registered ``epilogue="bias"`` and ``epilogue="bias_gelu"`` (the tanh GELU,
``jax.nn.gelu``'s default), since a CUDA kernel runs only the epilogues
compiled into it (``ops/epilogue.py``); the weights come from
``torch.Generator`` seeds 0 and 1 (the numbers differ from
``jax.random``'s).

    python examples/torch/10_transformer_block.py [--device cuda|cpu]
"""

import argparse
import math

import torch

from gemm_hls_tpu_torch import matmul
from gemm_hls_tpu_torch.ops.epilogue import gelu_tanh

# Tiny config so the example runs anywhere (the CPU included); scale dims up
# on a real card.
BATCH, SEQ, D_MODEL, N_HEADS, D_FF = 2, 128, 256, 4, 1024
D_HEAD = D_MODEL // N_HEADS
DTYPE = torch.bfloat16


def linear(x, w, b):
    """(tokens, d_in) @ (d_in, d_out) with the bias add fused into the
    kernel's output store (saves one round trip of the activations)."""
    return matmul(x, w, epilogue="bias", epilogue_operands=(b,), out_dtype=x.dtype)


def heads(t):
    return t.reshape(BATCH, SEQ, N_HEADS, D_HEAD).transpose(1, 2).reshape(-1, SEQ, D_HEAD)


def attention(x, wq, wk, wv, wo, bq, bk_, bv, bo):
    tokens = x.reshape(-1, D_MODEL)                      # (B*S, D)
    # (B*H, S, D_HEAD): the batched 3-D form is one B2 launch per product;
    # scores = Q.K^T reads K through transpose_b, no materialized transpose.
    q, k, v = (heads(linear(tokens, w, b)) for w, b in ((wq, bq), (wk, bk_), (wv, bv)))

    scores = matmul(q, k, transpose_b=True, out_dtype=torch.float32)
    probs = torch.softmax(scores / math.sqrt(D_HEAD), dim=-1)
    ctx = matmul(probs.to(DTYPE), v, out_dtype=DTYPE)   # (B*H, S, D_HEAD)

    ctx = (ctx.reshape(BATCH, N_HEADS, SEQ, D_HEAD)
              .transpose(1, 2).reshape(-1, D_MODEL))
    return linear(ctx, wo, bo).reshape(BATCH, SEQ, D_MODEL)


def mlp(x, w_up, b_up, w_down, b_down):
    tokens = x.reshape(-1, D_MODEL)
    h = matmul(tokens, w_up, epilogue="bias_gelu", epilogue_operands=(b_up,),
               out_dtype=DTYPE)
    return linear(h, w_down, b_down).reshape(BATCH, SEQ, D_MODEL)


def block(x, params):
    x = x + attention(_norm(x), *params["attn"])
    return x + mlp(_norm(x), *params["mlp"])


def _norm(x):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + 1e-6)).to(x.dtype)


def init(seed, device):
    gen = torch.Generator().manual_seed(seed)

    def s(shape):
        return (torch.randn(shape, generator=gen) * 0.02).to(device, DTYPE)

    def zeros(n):
        return torch.zeros((n,), dtype=DTYPE, device=device)

    return {
        "attn": (s((D_MODEL, D_MODEL)), s((D_MODEL, D_MODEL)),
                 s((D_MODEL, D_MODEL)), s((D_MODEL, D_MODEL)),
                 zeros(D_MODEL), zeros(D_MODEL), zeros(D_MODEL), zeros(D_MODEL)),
        "mlp": (s((D_MODEL, D_FF)), zeros(D_FF), s((D_FF, D_MODEL)), zeros(D_MODEL)),
    }


def ref_linear(t, w, b):
    return (t.float() @ w.float() + b.float()).to(DTYPE)


def ref_block(x, p):
    """Plain PyTorch on the same params, in fp32 between the bf16 roundings."""
    wq, wk, wv, wo, bq, bk_, bv, bo = p["attn"]
    t = _norm(x).reshape(-1, D_MODEL)
    q, k, v = (heads(ref_linear(t, w, b)) for w, b in ((wq, bq), (wk, bk_), (wv, bv)))
    sc = torch.einsum("bsd,btd->bst", q.float(), k.float())
    pr = torch.softmax(sc / math.sqrt(D_HEAD), -1)
    ctx = torch.einsum("bst,btd->bsd", pr, v.float())
    ctx = (ctx.to(DTYPE).reshape(BATCH, N_HEADS, SEQ, D_HEAD)
              .transpose(1, 2).reshape(-1, D_MODEL))
    y = x + ref_linear(ctx, wo, bo).reshape(BATCH, SEQ, D_MODEL)
    w_up, b_up, w_down, b_down = p["mlp"]
    t2 = _norm(y).reshape(-1, D_MODEL)
    h = gelu_tanh(t2.float() @ w_up.float() + b_up.float()).to(DTYPE)
    return y + ref_linear(h, w_down, b_down).reshape(BATCH, SEQ, D_MODEL)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default): the kernels on the card; cpu: their plain versions")
    dev = p.parse_args(argv).device
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the plain versions")

    params = init(0, dev)
    x = torch.randn((BATCH, SEQ, D_MODEL), generator=torch.Generator().manual_seed(1)
                    ).to(dev, DTYPE)
    out = block(x, params)
    print(f"transformer block: {tuple(x.shape)} {str(x.dtype).removeprefix('torch.')} -> "
          f"{tuple(out.shape)} {str(out.dtype).removeprefix('torch.')}")

    # Cross-check against plain PyTorch on the same params.
    exp = ref_block(x, params)
    err = float((out.float() - exp.float()).abs().max())
    print(f"max abs diff vs torch reference: {err:.3e}")
    assert err < 0.1, err
    print("OK")


if __name__ == "__main__":
    main()
