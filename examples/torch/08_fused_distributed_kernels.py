"""Fused distributed kernels: the data movement inside the compute kernel.

Unlike collective decompositions, these run the whole distributed algorithm
-- data movement included -- inside one kernel: operand blocks are
forwarded along the ring / torus while the tensor cores consume them.

The port of ``examples/08_fused_distributed_kernels.py`` to
``gemm_hls_tpu_torch``: the same operands, calls, printed lines and checks.
Differences from the reference: the ranks live on one card, as
``ops/ring.py`` and ``ops/cannon.py`` run them (one cooperative launch of
kernel B18, ``csrc/ring_gemm.cu``, or B19, ``csrc/cannon_gemm.cu``, whose
ranks exchange blocks under in-kernel signal / wait); ranks on distinct
cards wait for the multi-GPU slice (ROADMAP A7).  ``--device cpu`` runs
the plain schedules on CPU ranks.

    python examples/torch/08_fused_distributed_kernels.py [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

from gemm_hls_tpu_torch.ops.cannon import cannon_matmul_fused
from gemm_hls_tpu_torch.ops.ring import ring_matmul, shard_operands_ring
from gemm_hls_tpu_torch.parallel.mesh import make_mesh
from gemm_hls_tpu_torch.utils import make_operands, verify_matmul


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default): the kernels on the card; cpu: their plain versions")
    dev = p.parse_args(argv).device
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the plain versions")

    # --- 1-D ring: B blocks circulate while each rank computes -------------
    n_dev = 8
    mesh = make_mesh((n_dev,), ("x",), devices=[torch.device(dev)] * n_dev)
    m, n, k = 8 * n_dev, 16 * n_dev, 64
    a, b = make_operands(m, n, k, "float32")
    a_s, b_s = shard_operands_ring(torch.from_numpy(a), torch.from_numpy(b), mesh)
    c = torch.cat(ring_matmul(a_s, b_s, mesh))
    verify_matmul(c.cpu().numpy(), a.astype(np.float64) @ b)
    print(f"fused RDMA ring matmul on {n_dev} devices: verified "
          f"({n_dev - 1} hidden neighbor transfers)")

    # Tiled variant: K streamed in blocks inside each ring step.
    c = torch.cat(ring_matmul(a_s, b_s, mesh, block_k=32))
    verify_matmul(c.cpu().numpy(), a.astype(np.float64) @ b)
    print("tiled ring (out-of-VMEM locals, 3-level overlap): verified")

    # --- 2-D fused Cannon: skew + torus shifts --------------------------------
    m2 = n2 = k2 = 64
    a2, b2 = make_operands(m2, n2, k2, "float32")
    c2 = cannon_matmul_fused(torch.from_numpy(a2), torch.from_numpy(b2), p=2,
                             devices=[torch.device(dev)] * 4)
    verify_matmul(c2.cpu().numpy(), a2.astype(np.float64) @ b2)
    print("fused 2x2 Cannon (in-kernel skew + shifts): verified")


if __name__ == "__main__":
    main()
