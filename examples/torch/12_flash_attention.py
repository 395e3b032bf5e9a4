"""Flash attention: the whole softmax(Q.K^T/sqrt(d)).V in ONE kernel.

Where example 11 fuses the softmax into the scores GEMM but still writes
the (S, S) probability matrix before the p . v GEMM, ``flash_attention``
streams KV blocks through shared memory with an online-softmax recurrence:
the probabilities never exist in device memory, for the forward *or* the
backward (which recomputes score blocks from the saved per-row
log-sum-exp).

The port of ``examples/12_flash_attention.py`` to ``gemm_hls_tpu_torch``:
the same sizes, seeds, printed lines and checks, ``jax.grad`` turned into
torch autograd.  On the card the forward runs kernel B6-B8 (fp32 operands:
``csrc/flash_fwd.cu`` on the CUDA cores; bf16 / fp16 at D 64 / 128 take
``csrc/flash_wgmma.cu`` on the tile engine) and the gradients B9-B12
(``csrc/flash_bwd_dq.cu``, ``csrc/flash_bwd_dkv.cu``); the fused-scores
comparison runs B2; ``--device cpu`` runs their plain versions.

    python examples/torch/12_flash_attention.py [--device cuda|cpu]
"""

import argparse
import math

import numpy as np
import torch

from gemm_hls_tpu_torch.ops.attention import attention, flash_attention

HEADS, SEQ, D_HEAD = 4, 256, 64
DTYPE = torch.float32


def _masked_ref(q, k, v):
    s = torch.einsum("bqd,bkd->bqk", q, k) / math.sqrt(D_HEAD)
    s = torch.where(torch.tril(torch.ones((SEQ, SEQ), dtype=torch.bool, device=q.device)),
                    s, -torch.inf)
    return torch.einsum("bqk,bkd->bqd", torch.softmax(s, dim=-1), v)


def run(dev):
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((HEADS, SEQ, D_HEAD))).to(dev, DTYPE)
               for _ in range(3))

    # --- bidirectional: must match the two-kernel fused-scores path ---
    o_flash = flash_attention(q, k, v, block_q=128, block_kv=128)
    o_ref = attention(q, k, v)
    err = float((o_flash - o_ref).abs().max())
    print(f"flash vs fused-scores path {tuple(o_flash.shape)}: max abs diff {err:.2e}")
    assert err < 1e-4

    # --- causal: future positions carry exactly zero weight -----------
    o_causal = flash_attention(q, k, v, causal=True, block_q=128, block_kv=128)
    err = float((o_causal - _masked_ref(q, k, v)).abs().max())
    print(f"causal flash vs masked reference: max abs diff {err:.2e}")
    assert err < 1e-4

    # --- training: gradients through the flash backward kernels -------
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(
        (flash_attention(*leaves, causal=True, block_q=128, block_kv=128) ** 2).sum(),
        leaves)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad((_masked_ref(*leaves) ** 2).sum(), leaves)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        e = float((a - b).abs().max() / b.abs().max())
        print(f"flash backward {name}: rel err vs autodiff {e:.2e}")
        assert e < 1e-3

    print("OK")


def serving_features(dev):
    """The serving/training mask surface, all in the same kernel."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((HEADS, SEQ, D_HEAD))).to(dev, DTYPE)
               for _ in range(3))

    # Sliding window (Mistral-style): O(S*window*D) work.
    o_win = flash_attention(q, k, v, causal=True, window=64, block_q=64, block_kv=64)
    print(f"sliding-window(64) causal: {tuple(o_win.shape)}")

    # Logit soft-cap (Gemma-style).
    o_cap = flash_attention(q, k, v, causal=True, logit_cap=30.0, block_q=128,
                            block_kv=128)
    print(f"logit soft-cap(30): {tuple(o_cap.shape)}")

    # Packed sequences: two documents per row, causal within each.
    seg = np.zeros((HEADS, SEQ), np.int32)
    seg[:, SEQ // 2:] = 1
    seg = torch.from_numpy(seg).to(dev)
    o_packed = flash_attention(q, k, v, causal=True, q_segment_ids=seg,
                               kv_segment_ids=seg, block_q=64, block_kv=64)
    print(f"packed causal (2 segments): {tuple(o_packed.shape)}")

    # Padded-cache decode: Sq=1 queries, per-example cache lengths, GQA
    # (4 q heads per kv head).
    qd = torch.from_numpy(rng.standard_normal((8, 1, D_HEAD))).to(dev, DTYPE)
    kc = torch.from_numpy(rng.standard_normal((2, SEQ, D_HEAD))).to(dev, DTYPE)
    vc = torch.from_numpy(rng.standard_normal((2, SEQ, D_HEAD))).to(dev, DTYPE)
    lens = torch.tensor([100, SEQ], dtype=torch.int32, device=dev)
    o_dec = flash_attention(qd, kc, vc, kv_lengths=lens, block_q=8, block_kv=64)
    print(f"GQA decode vs padded cache (lens {lens.tolist()}): {tuple(o_dec.shape)}")
    print("serving features OK")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default): the kernels on the card; cpu: their plain versions")
    dev = p.parse_args(argv).device
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the plain versions")
    run(dev)
    serving_features(dev)


if __name__ == "__main__":
    main()
