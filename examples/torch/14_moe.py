"""Mixture-of-experts on the grouped (ragged) CA-GEMM kernel.

End-to-end MoE story: raw grouped matmul against a per-group product, a
top-2-routed expert FFN that trains (gradients through router, dispatch,
and both grouped GEMMs), and the expert-parallel variant.  The grouped
kernel's schedule is a static bound over the dynamic routing, and nothing
on the path reads the routing on the host.

The port of ``examples/14_moe.py`` to ``gemm_hls_tpu_torch``: the same
sizes (the reference's chip sizes on the card, its CPU sizes with
``--device cpu``), seeds, printed lines and checks.  On the card the
grouped GEMMs run kernel B16 (``csrc/grouped_gemm.cu`` for fp32; bf16 /
fp16 take ``csrc/grouped_wgmma.cu``) and the experts' weight gradient
kernel B17 (``csrc/grouped_update.cu``); ``--device cpu`` runs their plain
versions.  Differences from the reference: the oracle of the raw grouped
GEMM is a float64 product per group (the reference's
``jax.lax.ragged_dot`` at HIGHEST); the MoE parameters and data come from
``torch.Generator`` seeds (the numbers differ from ``jax.random``'s); the
expert-parallel part prints that it is skipped on one device, as the
reference does there: it waits for the multi-GPU slice (ROADMAP A7).

    python examples/torch/14_moe.py [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

from gemm_hls_tpu_torch import GemmConfig, grouped_matmul
from gemm_hls_tpu_torch.models.moe import MoEConfig, init_moe_params, moe_train_step


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default): the kernels on the card; cpu: their plain versions")
    dev = p.parse_args(argv).device
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the plain versions")
    on_card = dev == "cuda"
    rng = np.random.default_rng(5)

    # --- raw grouped GEMM: one matmul per expert over a ragged row
    # partition, one kernel launch total -------------------------------
    m, k, n, G = (2048, 512, 1024, 8) if on_card else (128, 64, 64, 4)
    gs = rng.multinomial(m, np.ones(G) / G)
    lhs = rng.standard_normal((m, k)).astype(np.float32)
    rhs = rng.standard_normal((G, k, n)).astype(np.float32)
    cfg = (GemmConfig(block_m=256, block_n=512, block_k=512) if on_card
           else GemmConfig(block_m=32, block_n=32, block_k=32))
    out = grouped_matmul(torch.from_numpy(lhs).to(dev), torch.from_numpy(rhs).to(dev),
                         torch.from_numpy(gs).to(dev, torch.int32), cfg).cpu().numpy()
    ends = np.cumsum(gs)
    want = np.concatenate([lhs[e - g:e].astype(np.float64) @ rhs[i]
                           for i, (g, e) in enumerate(zip(gs, ends))])
    total = int(gs.sum())
    err = float(np.abs(out[:total] - want).max() / np.abs(want).max())
    print(f"grouped_matmul vs ragged_dot ({m}x{k}x{n}, {G} experts, "
          f"sizes {[int(v) for v in gs]}): rel err {err:.2e}")
    assert err < 1e-5

    # --- top-2 routed MoE FFN trains, with no host synchronisation ------
    mcfg = MoEConfig(d_model=64, d_ff=128, num_experts=G, top_k=2,
                     gemm=None if on_card else cfg)
    params = init_moe_params(torch.Generator(device=dev).manual_seed(0), mcfg)
    x = torch.randn((256, mcfg.d_model), generator=torch.Generator().manual_seed(1)).to(dev)
    y = torch.tanh(x @ torch.randn((mcfg.d_model, mcfg.d_model),
                                   generator=torch.Generator().manual_seed(2)).to(dev))
    losses = []
    for _ in range(6):
        params, loss = moe_train_step(params, (x, y), mcfg, lr=0.05)
        losses.append(float(loss))
    print(f"MoE train: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(router + experts learned)")
    assert losses[-1] < losses[0]

    # --- expert parallelism over a mesh: one device here ----------------
    n_dev = 1
    print(f"expert parallelism skipped ({n_dev} device(s))")


if __name__ == "__main__":
    main()
