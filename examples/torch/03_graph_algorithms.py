"""Graph algorithms on the semiring GEMM: APSP, reachability, widest paths.

The port of ``examples/03_graph_algorithms.py`` to ``gemm_hls_tpu_torch``:
the same graph, calls, printed lines and checks.  On the card the
distance products run kernel B3 (``csrc/semiring_gemm.cu``); ``--device
cpu`` runs their plain versions.

    python examples/torch/03_graph_algorithms.py [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

from gemm_hls_tpu_torch.models.graph import (
    all_pairs_shortest_paths, transitive_closure, widest_paths,
)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default): the kernels on the card; cpu: their plain versions")
    dev = p.parse_args(argv).device
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the plain versions")

    rng = np.random.default_rng(42)
    n = 64
    w = rng.uniform(1, 10, (n, n)).astype(np.float32)
    adj = np.where(rng.uniform(size=(n, n)) < 0.1, w, np.inf).astype(np.float32)
    np.fill_diagonal(adj, 0.0)

    dist = all_pairs_shortest_paths(torch.from_numpy(adj).to(dev)).cpu().numpy()
    reach = np.isfinite(dist)
    print(f"APSP on a {n}-node sparse digraph (min_plus repeated squaring):")
    print(f"  reachable pairs: {reach.sum()} / {n * n}")
    print(f"  longest shortest path: {dist[np.isfinite(dist)].max():.2f}")

    closure = transitive_closure(torch.from_numpy(adj < np.inf).to(dev)).cpu().numpy()
    assert np.array_equal(closure, reach), "closure must match APSP reachability"
    print("transitive closure (or_and): consistent with APSP reachability")

    cap = np.where(adj < np.inf, 100.0 / np.maximum(adj, 1e-3), 0.0).astype(np.float32)
    bw = widest_paths(torch.from_numpy(cap).to(dev)).cpu().numpy()
    print(f"widest paths (max_min): median bottleneck "
          f"{np.median(bw[np.isfinite(dist) & (dist > 0)]):.1f}")


if __name__ == "__main__":
    main()
