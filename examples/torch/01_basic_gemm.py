"""Basic CA-GEMM usage: configs, verification, the analytical model.

The port of ``examples/01_basic_gemm.py`` to ``gemm_hls_tpu_torch``: the
same operands, calls, printed lines and checks.  On the card the fp32 call
runs kernel B1 on the CUDA cores and the bf16 one on B1's tile engine
(``csrc/mxu_wgmma.cuh``); ``--device cpu`` runs their plain versions.

Differences from the reference: the explicit config names the tile a bf16
call runs on the card (``config.route_config``: the engine's 128 x 256 x
64), since every kernel runs fixed compiled tiles and the card refuses the
reference's 512 x 1024 x 1024; the analytical model prints the H100's
``format_specifications`` for it.

    python examples/torch/01_basic_gemm.py [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

from gemm_hls_tpu_torch import GemmConfig, matmul
from gemm_hls_tpu_torch.config import route_config
from gemm_hls_tpu_torch.models import format_specifications, get_chip, specifications
from gemm_hls_tpu_torch.ops.semiring import get_semiring
from gemm_hls_tpu_torch.utils import make_operands, reference_matmul, verify_matmul


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default): the kernels on the card; cpu: their plain versions")
    dev = p.parse_args(argv).device
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the plain versions")

    # Seeded operands, reference-style (U(1,10), seed 5), deliberately unaligned.
    m, n, k = 1000, 1030, 999
    a, b = make_operands(m, n, k, "float32")

    # Default config: the route and tile chosen by dtype and shape.
    c = matmul(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev))
    err = verify_matmul(c.cpu().numpy(), reference_matmul(a, b))
    print(f"fp32 {m}x{n}x{k}: verified vs BLAS oracle (max rel err {err:.2e})")

    # Explicit specialization -- the Config.h analogue; hashable.  Its blocks
    # name a compiled tile: the tile engine's for bf16.
    cfg = route_config("bfloat16", out_dtype="float32")
    assert isinstance(cfg, GemmConfig)
    a16 = torch.from_numpy(np.ascontiguousarray(a[:512, :512])).to(dev, torch.bfloat16)
    b16 = torch.from_numpy(np.ascontiguousarray(b[:512, :512])).to(dev, torch.bfloat16)
    c16 = matmul(a16, b16, config=cfg)
    print(f"bf16 with fp32 accumulation: {tuple(c16.shape)} "
          f"{str(c16.dtype).removeprefix('torch.')}")

    # What should this run cost on an H100? (PrintSpecifications port.)
    print()
    print(format_specifications(
        specifications(cfg, 8192, 8192, 8192, chip=get_chip("h100"),
                       semiring_is_mxu=get_semiring("plus_times").is_mxu)))


if __name__ == "__main__":
    main()
