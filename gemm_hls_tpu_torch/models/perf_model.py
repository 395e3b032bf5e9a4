"""Roofline constants of the card: the ``ChipSpec`` / ``detect_chip``
subset of ``gemm_hls_tpu/models/perf_model.py`` for an NVIDIA H100.

Rates are NVIDIA's published dense peaks for the H100 SXM at its full
700 W power limit (NVIDIA H100 data sheet).  A card set to a
lower limit runs slower under load, so every measurement states the limit
beside it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """One accelerator's roofline constants.

    ``peak_flops`` maps dtype name -> peak FLOP/s of the tensor cores
    (float32: the CUDA-core FMA rate); ``vpu_ops`` is the CUDA-core fp32
    rate that bounds the generic-semiring kernel.
    """

    name: str
    peak_flops: Dict[str, float]
    vpu_ops: float                # non-tensor fp32 ops/s

    def peak_for(self, dtype) -> float:
        d = str(dtype).removeprefix("torch.")
        return self.peak_flops.get(d, self.peak_flops["float32"])


H100 = ChipSpec(
    name="h100",
    # bf16/fp16 989 TFLOP/s, int8 1979 TOP/s, tf32 495 TFLOP/s dense; fp32
    # outside the tensor cores 67 TFLOP/s (NVIDIA H100 SXM data sheet).
    peak_flops={"bfloat16": 989e12, "float16": 989e12, "int8": 1979e12,
                "tfloat32": 495e12, "float32": 67e12},
    # 67e12 counts an FMA as 2 ops: 132 SMs x 128 fp32 lanes x 2 x 1.98 GHz
    # (H100 SXM boost clock).  A (map, reduce) pair costs two instructions
    # without fusion, so the generic-semiring ceiling in 2*M*N*K ops is the
    # same figure.
    vpu_ops=67e12,
)


def detect_chip() -> ChipSpec:
    """The constants of CUDA device 0 (``torch.cuda.get_device_name``);
    raises for a card without an entry."""
    name = torch.cuda.get_device_name(0)
    if "H100" in name:
        return H100
    raise NotImplementedError(f"no roofline constants for {name!r}")
