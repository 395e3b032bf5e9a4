"""Quantized inference GEMMs: weight-only int8/int4 and W8A8.

A serving-shaped tour of ``ops/quant.py``: weights are quantized once
offline, stream from device memory quantized, and expand in registers
inside the kernel.  Pick the mode by batch size:

* small M (decode / small batch) -> weight-bandwidth-bound -> weight-only
  int4 or int8;
* large M (prefill / training-free scoring) -> compute-bound -> W8A8 on
  the int8 tensor cores.

The port of ``examples/13_quantized_inference.py`` to
``gemm_hls_tpu_torch``: the same sizes, seeds, printed lines and checks.
On the card the weight-only GEMMs run kernel B13 (``csrc/dequant_gemm.cu``
for fp32 activations; bf16 / fp16 take ``csrc/dequant_wgmma.cu``) and W8A8
kernel B14 / B15 (``csrc/w8a8_wgmma.cu`` after ``csrc/w8a8_gemm.cu``'s
quantize pass); ``--device cpu`` runs their plain versions.

    python examples/torch/13_quantized_inference.py [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

from gemm_hls_tpu_torch import (
    dequantize_weights, matmul_quantized, matmul_w8a8, quantize_weights,
)

K, N = 512, 256


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default): the kernels on the card; cpu: their plain versions")
    dev = p.parse_args(argv).device
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the plain versions")

    def on(x):
        return torch.from_numpy(np.asarray(x)).to(dev)

    rng = np.random.default_rng(5)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    x_small = rng.standard_normal((8, K)).astype(np.float32)
    ref_small = x_small @ w

    # --- weight-only int8, per-channel scales -------------------------
    wq8, s8 = quantize_weights(w, bits=8)
    y8 = matmul_quantized(on(x_small), on(wq8), on(s8), bits=8).cpu().numpy()
    rel = np.abs(y8 - ref_small).max() / np.abs(ref_small).max()
    print(f"int8 per-channel: rel err {rel:.4f} (weights 2x smaller)")
    assert rel < 0.02

    # --- weight-only int4, group-wise scales --------------------------
    wq4, s4 = quantize_weights(w, bits=4, group_size=128)
    assert wq4.shape == (K // 2, N)          # two K-rows per byte
    y4 = matmul_quantized(on(x_small), on(wq4), on(s4), bits=4,
                          group_size=128).cpu().numpy()
    rel = np.abs(y4 - ref_small).max() / np.abs(ref_small).max()
    print(f"int4 g=128: rel err {rel:.4f} (weights 4x smaller)")
    assert rel < 0.15

    # The kernel is exact vs the quantized weights -- the error above is
    # the quantization itself.
    exact = x_small @ np.asarray(dequantize_weights(wq4, s4, bits=4, group_size=128))
    kerr = np.abs(y4 - exact).max() / np.abs(exact).max()
    print(f"int4 kernel vs host-dequant oracle: {kerr:.2e}")
    assert kerr < 1e-4

    # --- W8A8: large-batch compute-bound mode -------------------------
    x_big = rng.standard_normal((128, K)).astype(np.float32)
    ref_big = x_big @ w
    y88 = matmul_w8a8(on(x_big), on(wq8), on(s8)).cpu().numpy()
    rel = np.abs(y88 - ref_big).max() / np.abs(ref_big).max()
    print(f"W8A8 (dynamic per-row activation quant): rel err {rel:.4f} "
          "(int8 tensor cores)")
    assert rel < 0.04
    print("OK")


if __name__ == "__main__":
    main()
