"""Distributed CA-GEMM: SUMMA / Cannon / 2.5D over a mesh of ranks.

The port of ``examples/04_distributed.py`` to ``gemm_hls_tpu_torch``: the
same operands, calls, printed lines and checks.  The reference runs on a
virtual 8-device CPU mesh; here the 8 ranks are explicit virtual ranks of
one device (``[torch.device("cuda")] * 8``), driven by one process: the
collectives are copies between the ranks' buffers
(``parallel/sharding.py``) and each rank's local GEMM launches kernel B1
(plus_times) or B3 (min_plus) on the card.  ``--device cpu`` puts the
ranks on the CPU, where the kernels run their plain versions.

    python examples/torch/04_distributed.py [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

from gemm_hls_tpu_torch.parallel import (
    cannon_matmul, make_mesh, matmul_25d, mesh_25d, shard_operands_2d,
    shard_operands_25d, summa_matmul,
)
from gemm_hls_tpu_torch.utils import make_operands, reference_matmul, verify_matmul


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default): the kernels on the card; cpu: their plain versions")
    dev = p.parse_args(argv).device
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the plain versions")
    ranks = [torch.device(dev)] * 8

    m, n, k = 128, 256, 512
    a, b = make_operands(m, n, k, "float32")
    exp = a.astype(np.float64) @ b

    # 2-D gather-SUMMA on an auto-shaped mesh.
    mesh = make_mesh(devices=ranks)
    a_s, b_s = shard_operands_2d(a, b, mesh)
    c = summa_matmul(a_s, b_s, mesh)
    verify_matmul(c.full().cpu().numpy(), exp)
    print(f"SUMMA on {dict(mesh.shape)}: verified; C sharding {c.spec}")

    # Cannon on a square sub-mesh (joint-axis skew + torus shifts).
    mesh_sq = make_mesh((2, 2), devices=ranks[:4])
    a_s, b_s = shard_operands_2d(a, b, mesh_sq)
    c = cannon_matmul(a_s, b_s, mesh_sq)
    verify_matmul(c.full().cpu().numpy(), exp)
    print("Cannon on (2,2): verified")

    # 2.5D: replicate the grid, split K, reduce over z (sqrt(c) less traffic).
    mesh3 = mesh_25d(c=2, devices=ranks)
    a_s, b_s = shard_operands_25d(a, b, mesh3)
    c = matmul_25d(a_s, b_s, mesh3)
    verify_matmul(c.full().cpu().numpy(), exp)
    print(f"2.5D on {dict(mesh3.shape)}: verified")

    # Any semiring distributes the same way.
    a_s, b_s = shard_operands_2d(a, b, mesh)
    c = summa_matmul(a_s, b_s, mesh, semiring="min_plus")
    verify_matmul(c.full().cpu().numpy(), reference_matmul(a, b, semiring="min_plus"))
    print("distributed min_plus: verified")


if __name__ == "__main__":
    main()
