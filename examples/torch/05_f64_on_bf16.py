"""Double-precision GEMM without f64 hardware (Ozaki slice scheme).

The port of ``examples/05_f64_on_bf16.py`` to ``gemm_hls_tpu_torch``: the
same operands, calls, printed lines and checks.  On the card the bf16
slices' products run kernel B1 and the fused int8 variant kernel B5
(``csrc/int8_slices.cu``, on the tile engine); ``--device cpu`` runs their
plain versions.  (The H100 has FP64 tensor cores too; the scheme is the
reference's, run on its int8 and bf16 engines.)

    python examples/torch/05_f64_on_bf16.py [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

from gemm_hls_tpu_torch.ops.ozaki import ozaki_matmul, ozaki_matmul_int8, slice_plan


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default): the kernels on the card; cpu: their plain versions")
    dev = p.parse_args(argv).device
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the plain versions")

    rng = np.random.default_rng(5)
    m = n = k = 512
    a = rng.uniform(-5, 5, (m, k))
    b = rng.uniform(-5, 5, (k, n))

    bits, ns = slice_plan(k)
    print(f"K={k}: {ns} slices of {bits} mantissa bits each "
          f"(2*{bits}+log2({k}) <= 24 keeps every fp32 accumulation exact)")

    got = ozaki_matmul(a, b, device=dev)
    exp = a @ b
    elem = np.abs(got - exp) / np.maximum(np.abs(exp), 1e-300)
    normw = np.abs(got - exp) / (np.linalg.norm(a, axis=1)[:, None]
                                 * np.linalg.norm(b, axis=0)[None, :])
    f32 = np.abs(a.astype(np.float32) @ b.astype(np.float32) - exp) / np.abs(exp)
    print(f"elementwise max rel err: {elem.max():.2e} "
          f"(plain f32 would be {f32.max():.2e})")
    print(f"normwise max err: {normw.max():.2e} (full f64 quality)")

    # The production path: the same error-free transformation on the int8
    # engine, the whole slice triangle fused into one kernel (B5), K-unbounded.
    got_i8 = ozaki_matmul_int8(a, b, device=dev)
    normw_i8 = np.abs(got_i8 - exp) / (np.linalg.norm(a, axis=1)[:, None]
                                       * np.linalg.norm(b, axis=0)[None, :])
    print(f"fused int8 variant normwise max err: {normw_i8.max():.2e}")


if __name__ == "__main__":
    main()
