"""Analytical multi-card scaling model for SUMMA / Cannon / 2.5D CA-GEMM:
the port of ``gemm_hls_tpu/models/scaling_model.py``.

Extends the one-card roofline (``models/perf_model.py``) to a group of
cards: per-card time is local compute plus the card-to-card traffic that
compute does not hide, and weak-scaling efficiency is the ratio ideal /
actual.  The reference's ICI terms are the card's NVLink here
(``ChipSpec.ici_bandwidth`` per link and direction, ``ici_links``); as in
the reference, one ring step is charged one link each way, which on an
NVSwitch node (where a card drives all 18 links at once) is the model's
pessimistic edge.

Communication volumes per card (operand words moved between cards):

* gather-SUMMA on (px, py):  A panel (M/px * K) * (py-1)/py received over
  the y-axis ring + B panel (K * N/py) * (px-1)/px over x.
* Cannon on (p, p):          (p-1) shifts of |A_blk| + |B_blk|.
* 2.5D with replication c:   the 2-D volume shrunk to the K/c chunk, plus
  one reduce of the C block over z ((c-1)/c * M/px * N/py).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from gemm_hls_tpu_torch.config import GemmConfig
from gemm_hls_tpu_torch.models.perf_model import ChipSpec, detect_chip


def comm_volume_per_device(algorithm: str, m: int, n: int, k: int,
                           mesh_shape: Tuple[int, ...],
                           itemsize: int = 2) -> int:
    """Bytes sent+received per card over its links."""
    if algorithm == "summa":
        px, py = mesh_shape
        a_recv = (m // px) * k * (py - 1) // py
        b_recv = k * (n // py) * (px - 1) // px
        return (a_recv + b_recv) * itemsize
    if algorithm == "cannon":
        p, p2 = mesh_shape
        if p != p2:
            raise ValueError("cannon needs a square mesh")
        blk = (m // p) * (k // p) + (k // p) * (n // p)
        return (p - 1) * blk * itemsize
    if algorithm == "25d":
        c, px, py = mesh_shape
        kc = k // c
        a_recv = (m // px) * kc * (py - 1) // py
        b_recv = kc * (n // py) * (px - 1) // px
        c_reduce = (m // px) * (n // py) * (c - 1) // c * 2  # reduce-scatter+gather
        return (a_recv + b_recv + c_reduce) * itemsize
    raise ValueError(f"unknown algorithm {algorithm!r}")


def multichip_model(algorithm: str, m: int, n: int, k: int,
                    mesh_shape: Tuple[int, ...], *, dtype="bfloat16",
                    cfg: Optional[GemmConfig] = None,
                    chip: Optional[ChipSpec] = None,
                    overlap: float = 0.8) -> Dict:
    """Expected per-step time and scaling efficiency on ``mesh_shape``.

    ``overlap``: fraction of the link time hidden behind compute (0 =
    fully exposed, 1 = fully hidden).  ``cfg`` is accepted for the
    reference's signature and not read.
    """
    del cfg
    chip = chip or detect_chip()
    n_dev = int(np.prod(mesh_shape))
    itemsize = np.dtype("float32").itemsize if dtype == "float32" else 2
    peak = chip.peak_for(dtype)

    flops_total = 2 * m * n * k
    t_compute = flops_total / n_dev / peak
    comm = comm_volume_per_device(algorithm, m, n, k, mesh_shape, itemsize)
    # One link each way along the ring's axis.
    t_comm = comm / (2 * chip.ici_bandwidth) if chip.ici_bandwidth else 0.0
    t_exposed = t_comm * (1.0 - overlap)
    t_step = t_compute + t_exposed
    eff = t_compute / t_step if t_step else 1.0
    return {
        "algorithm": algorithm,
        "mesh_shape": tuple(mesh_shape),
        "devices": n_dev,
        "t_compute_s": t_compute,
        "t_comm_s": t_comm,
        "t_step_s": t_step,
        "gflops_total": flops_total / t_step / 1e9,
        "parallel_efficiency": eff,
        "comm_bytes_per_device": comm,
        "chip": chip.name,
    }


def weak_scaling_efficiency(algorithm: str, base_mnk: Tuple[int, int, int],
                            mesh_shape: Tuple[int, ...], *, dtype="bfloat16",
                            chip: Optional[ChipSpec] = None,
                            overlap: float = 0.8) -> float:
    """Weak scaling: grow the problem so per-card work is constant, and
    compare against the one-card roofline."""
    chip = chip or detect_chip()
    n_dev = int(np.prod(mesh_shape))
    m0, n0, k0 = base_mnk
    # Scale the volume by n_dev (cube root per dimension).
    s = n_dev ** (1.0 / 3.0)
    m, n, k = (int(round(d * s)) for d in (m0, n0, k0))
    model = multichip_model(algorithm, m, n, k, mesh_shape, dtype=dtype,
                            chip=chip, overlap=overlap)
    return model["parallel_efficiency"]
