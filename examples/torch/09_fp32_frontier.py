"""The fp32 accuracy/speed frontier: pick your point.

One GEMM, four ways to run it -- full fp32, the fast mode, and two
integer-slice schemes on the int8 tensor cores with exact int32
accumulation (the error-free-transformation family that also powers the
f64-class path).

The port of ``examples/09_fp32_frontier.py`` to ``gemm_hls_tpu_torch``: the
same operands, calls and printed errors.  On the card the fp32 calls run
kernel B1 on the CUDA cores and the slice schemes kernel B4
(``csrc/diag_wgmma.cu``, on the tile engine); ``--device cpu`` runs their
plain versions.  Differences from the reference: each line prints the
normwise error only, without the reference's TPU rates; the fp32 config
names the CUDA cores' compiled tile (``config.route_config("float32")``,
128 x 128 x 16), which the card requires, for the reference's 128 x 128 x
512; on the card ``precision="default"`` runs IEEE fp32 as "high" does
(ROADMAP B, coverage item 6).

    python examples/torch/09_fp32_frontier.py [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

from gemm_hls_tpu_torch import matmul
from gemm_hls_tpu_torch.config import route_config
from gemm_hls_tpu_torch.ops.int8_slices import fp32_matmul_int8
from gemm_hls_tpu_torch.utils import make_operands


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default): the kernels on the card; cpu: their plain versions")
    dev = p.parse_args(argv).device
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the plain versions")

    m = n = k = 512
    a, b = make_operands(m, n, k, "float32", low=-5.0, high=5.0)
    at, bt = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    exp = a.astype(np.float64) @ b
    norm = (np.linalg.norm(a, axis=1)[:, None] * np.linalg.norm(b, axis=0)[None, :])

    cfg = route_config("float32")

    def report(name, out):
        err = (np.abs(out.cpu().numpy().astype(np.float64) - exp) / norm).max()
        print(f"{name:42s} normwise err {err:.1e}")

    report("fp32 full accuracy (precision='high')", matmul(at, bt, config=cfg))
    report("fp32 fast mode (precision='default')",
           matmul(at, bt, config=cfg, precision="default"))
    report("int8 slices, n=2",
           fp32_matmul_int8(at, bt, block_m=128, block_n=128, block_k=512, n_slices=2))
    report("int8 slices, n=3",
           fp32_matmul_int8(at, bt, block_m=128, block_n=128, block_k=512, n_slices=3))


if __name__ == "__main__":
    main()
