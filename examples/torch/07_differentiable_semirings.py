"""Differentiable semirings: gradients through shortest paths.

min_plus matmuls are piecewise linear -- their subgradients route loss
signals to the edges on shortest paths, enabling learning graph weights
from path-cost objectives (the discrete analogue; log_plus gives the smooth
version).

The port of ``examples/07_differentiable_semirings.py`` to
``gemm_hls_tpu_torch``: the same graph, steps, printed lines and checks,
``jax.value_and_grad`` turned into torch autograd.  On the card the
products and their gradients' products run kernel B3
(``csrc/semiring_gemm.cu``); ``--device cpu`` runs the plain versions.

    python examples/torch/07_differentiable_semirings.py [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

from gemm_hls_tpu_torch import matmul


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default): the kernels on the card; cpu: their plain versions")
    dev = p.parse_args(argv).device
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the plain versions")

    rng = np.random.default_rng(0)
    n = 24
    w = rng.uniform(1, 10, (n, n)).astype(np.float32)
    adj = np.where(rng.uniform(size=(n, n)) < 0.3, w, 1e6).astype(np.float32)
    np.fill_diagonal(adj, 0.0)
    adj = torch.from_numpy(adj).to(dev)

    target = 3.0  # desired two-hop distance between node 0 and node n-1

    def loss(edges):
        two_hop = matmul(edges, edges, semiring="min_plus")
        return (two_hop[0, -1] - target) ** 2

    print(f"initial 2-hop dist(0 -> {n - 1}): "
          f"{float(matmul(adj, adj, semiring='min_plus')[0, -1]):.3f} "
          f"(target {target})")

    edges = adj
    for _ in range(40):
        e = edges.detach().requires_grad_()
        grad, = torch.autograd.grad(loss(e), e)
        edges = edges - 0.2 * grad  # subgradient descent on the active path
    with torch.no_grad():
        print(f"after 40 subgradient steps: "
              f"{float(matmul(edges, edges, semiring='min_plus')[0, -1]):.3f}, "
              f"loss {float(loss(edges)):.4f}")

    # Smooth version: log-semiring with exact softmax gradients.
    e = adj.detach().requires_grad_()
    soft, = torch.autograd.grad(matmul(-e, -e, semiring="log_plus")[0, -1], e)
    print(f"log_plus (soft-min) gradient: {int((soft != 0).sum())} "
          f"edges receive signal (vs the single hard argmin path)")


if __name__ == "__main__":
    main()
