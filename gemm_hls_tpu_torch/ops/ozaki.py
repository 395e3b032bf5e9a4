"""Double-precision-accurate GEMM from low-precision tensor cores: the Ozaki
slice scheme.

Counterpart of ``gemm_hls_tpu/ops/ozaki.py``: numpy in, numpy out, the
products on the card (``device``, default "cuda"; "cpu" runs the plain
versions).

1. **Split** (exact): each f64 operand is decomposed into slices on a grid
   shared along the contraction axis, so every product of two slices is
   exact in the engine's accumulator.
2. **Multiply** (exact): :func:`ozaki_matmul` runs the bf16 slice pairs on
   kernel B1 with fp32 accumulation (``2 * slice_bits + ceil(log2 K) <=
   24``); :func:`ozaki_matmul_int8` runs 7-bit int8 slices through kernel
   B5 (``ops/slice_kernels.py``), 36 int8 products for 8 slices.
3. **Accumulate** (compensated): exact partials are summed in float-float
   (hi, lo) arithmetic (TwoSum), then combined in f64.

The H100 has float64 arithmetic, so on CUDA ``split="auto"`` runs
:func:`split_f64_int8`'s f64 arithmetic on the card
(:func:`device_split_f64_int8`), and :func:`ozaki_matmul` sums its exact
fp32 partials in float64; the JAX package's workarounds for the TPU's
lack of f64, the fp32 double-single split and the float-float (hi, lo) sum,
are kept as ``split="device"`` and :func:`device_accumulate` (the CPU's
path, for parity).  :func:`ozaki_matmul_distributed` and
:func:`ozaki_matmul_int8_distributed` run the same schemes over a mesh of
ranks (``parallel/summa.py``'s gather-SUMMA schedule).

Reference for the technique: Ozaki et al., "Error-free transformations of
matrix multiplication by using fast routines of matrix multiplication and
its applications" (Numer. Algorithms, 2012).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from gemm_hls_tpu_torch.config import GemmConfig, default_config, round_up
from gemm_hls_tpu_torch.ops.int8_slices import _exp2, _exponent
from gemm_hls_tpu_torch.ops.slice_kernels import _two_sum, fused_ozaki_int8

INT8_SLICE_BITS = 7


# ---------------------------------------------------------------------------
# Host-side splits (numpy; copied from the JAX package)
# ---------------------------------------------------------------------------

def slice_plan(k: int, target_rel: float = 1e-14) -> Tuple[int, int]:
    """Choose (slice_bits, n_slices) for contraction length ``k``.

    Exactness constraint: 2*slice_bits + ceil(log2(k)) <= 24 (fp32
    accumulator); accuracy: n_slices * slice_bits mantissa bits must cover
    the f64 target (plus headroom for the float-float accumulator).
    """
    guard = math.ceil(math.log2(max(k, 2)))
    slice_bits = (24 - guard) // 2
    if slice_bits < 1:
        raise ValueError(
            f"K={k} exceeds the exactness bound of the fp32 accumulator "
            f"(2*slice_bits + log2(K) <= 24 requires K <= 2^22); split the "
            f"contraction into segments and combine the segment results in "
            f"float64")
    slice_bits = min(slice_bits, 8)  # bf16 holds 8 mantissa bits
    need_bits = min(53, int(-math.log2(target_rel)) + 6)
    n_slices = math.ceil(need_bits / slice_bits)
    return slice_bits, n_slices


def split_f64(x: np.ndarray, slice_bits: int, n_slices: int,
              axis: int = 1) -> np.ndarray:
    """Exact fixed-grid decomposition of f64 ``x`` into ``n_slices``, each
    on a grid whose exponent is shared along ``axis`` with at most
    ``slice_bits`` integer bits per element (Ozaki et al. 2012).

    Returns an (n_slices, *x.shape) float64 array with
    ``x ~= sum(slices)`` (exact up to the tail past the last slice).
    """
    x = np.asarray(x, np.float64)
    slices = np.empty((n_slices,) + x.shape, np.float64)
    r = x.copy()
    for i in range(n_slices):
        amax = np.max(np.abs(r), axis=axis, keepdims=True)
        safe = np.where(amax > 0, amax, 1.0)
        # Grid: ulp = 2^(e - slice_bits) with 2^(e-1) <= max < 2^e, so the
        # quantized integers stay strictly below 2^slice_bits.
        e = np.floor(np.log2(safe)) + 1.0
        ulp = np.exp2(e - slice_bits)
        s = np.trunc(r / ulp) * ulp
        slices[i] = s
        r = r - s  # exact: s lies on a grid coarser than r's ulp
    return slices


def split_f64_int8(x: np.ndarray, n_slices: int, axis: int) -> tuple:
    """Exact fixed-grid decomposition into int8 slices of 7 magnitude bits.

    Returns (slices int8 (n, *shape), ulp float64 per contraction vector)
    with ``x ~= ulp * sum_i slices[i] * 2^(-7 i)``.
    """
    x = np.asarray(x, np.float64)
    amax = np.max(np.abs(x), axis=axis, keepdims=True)
    safe = np.where(amax > 0, amax, 1.0)
    e = np.floor(np.log2(safe)) + 1.0
    ulp = np.exp2(e - INT8_SLICE_BITS)
    slices = np.empty((n_slices,) + x.shape, np.int8)
    r = x.copy()
    cur = ulp.copy()
    for i in range(n_slices):
        q = np.clip(np.trunc(r / cur), -127, 127)
        slices[i] = q.astype(np.int8)
        r = r - q * cur
        cur = cur * 2.0 ** -INT8_SLICE_BITS
    return slices, ulp


def f64_to_f32pair(x: np.ndarray):
    """Double-single representation: x ~= hi + lo with hi = f32(x) and
    lo = f32(x - hi), carrying ~48 of f64's 53 mantissa bits."""
    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi).astype(np.float32)
    return hi, lo


# ---------------------------------------------------------------------------
# Device-side splits (torch)
# ---------------------------------------------------------------------------

def device_split_f64(x: torch.Tensor, slice_bits: int, n_slices: int,
                     axis: int = 1) -> torch.Tensor:
    """:func:`split_f64` in float64 torch arithmetic, wherever ``x`` lies
    (the card has f64).  Returns the (n_slices, *x.shape) float64 slices.

    The exponent is the exact ``floor(log2(amax)) + 1`` (``torch.frexp``):
    the host split's slices, except where ``np.log2`` rounds a value a few
    ulps below a power of two up to it (that slice then sits one bit
    lower, still exact)."""
    x = x.to(torch.float64)
    slices = torch.empty((n_slices,) + tuple(x.shape), dtype=torch.float64,
                         device=x.device)
    r = x
    for i in range(n_slices):
        amax = r.abs().amax(dim=axis, keepdim=True)
        ulp = _exp2(_exponent(amax) - slice_bits, torch.float64)
        slices[i] = torch.trunc(r / ulp) * ulp
        r = r - slices[i]  # exact: the slice lies on a grid coarser than r's
    return slices


def device_split_f64_int8(x: torch.Tensor, n_slices: int, axis: int):
    """:func:`split_f64_int8` in float64 torch arithmetic, wherever ``x``
    lies (the card has f64).  Returns (slices int8 (n, *shape), ulp float64).

    The exponent is the exact ``floor(log2(amax)) + 1`` (``torch.frexp``),
    so the slices equal the host split's except where ``np.log2`` rounds a
    value a few ulps below a power of two up to it."""
    x = x.to(torch.float64)
    amax = x.abs().amax(dim=axis, keepdim=True)
    ulp = _exp2(_exponent(amax) - INT8_SLICE_BITS, torch.float64)
    slices = torch.empty((n_slices,) + tuple(x.shape), dtype=torch.int8,
                         device=x.device)
    r = x
    cur = ulp
    for i in range(n_slices):
        q = torch.clamp(torch.trunc(r / cur), -127, 127)
        slices[i] = q.to(torch.int8)
        r = r - q * cur
        cur = cur * 2.0 ** -INT8_SLICE_BITS
    return slices, ulp


def device_split_int8(hi, lo, *, n_slices: int, axis: int):
    """The JAX package's TPU split: int8 slices from the (hi, lo) fp32 pair
    in double-single arithmetic, no f64.  Returns (slices int8 (n, *shape),
    ulp fp32 per contraction vector); exact to the ~48 bits the pair
    carries (~2^-45 end to end)."""
    amax = hi.abs().amax(dim=axis, keepdim=True)
    ulp = _exp2(_exponent(amax) - INT8_SLICE_BITS)
    # Scaled double-single value v = r_h + r_l in (-2^7, 2^7); divisions by
    # the power-of-two ulp are exact.
    r_h = hi / ulp
    r_l = lo / ulp
    scale = 2.0 ** INT8_SLICE_BITS
    slices = []
    for _ in range(n_slices):
        q = torch.clamp(torch.trunc(r_h), -127, 127)
        slices.append(q.to(torch.int8))
        r_h = r_h - q                      # exact (integer on r_h's grid)
        r_h, r_l = _two_sum(r_h, r_l)      # renormalize: pull lo bits up
        r_h = r_h * scale                  # exact (power of two)
        r_l = r_l * scale
    return torch.stack(slices), ulp


# ---------------------------------------------------------------------------
# The GEMMs
# ---------------------------------------------------------------------------

def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def _check_pair(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"contraction mismatch: {a.shape} x {b.shape}")
    return a, b


def device_accumulate(a_slices, b_slices, *, config: GemmConfig):
    """All slice-pair GEMMs (kernel B1, bf16 -> fp32, exact) and the
    float-float accumulation, on the slices' device.

    Args:
      a_slices: (n_slices, M, K) bf16; b_slices: (n_slices, K, N) bf16.
    Returns (hi, lo) float32 with C ~= hi + lo.
    """
    from gemm_hls_tpu_torch.ops.matmul import matmul

    n_slices, m, _ = a_slices.shape
    n = b_slices.shape[2]
    hi = torch.zeros((m, n), dtype=torch.float32, device=a_slices.device)
    lo = torch.zeros_like(hi)
    # Partials by decreasing magnitude (i + j ascending); the triangle
    # keeps diagonals up to i + j <= n_slices.
    for s in range(n_slices + 1):
        for i in range(s + 1):
            j = s - i
            if i >= n_slices or j >= n_slices:
                continue
            p = matmul(a_slices[i], b_slices[j], config=config)
            hi, err = _two_sum(hi, p)
            lo = lo + err
    return hi, lo


def _f64_accumulate(a_slices, b_slices, *, config: GemmConfig):
    """:func:`device_accumulate`'s slice-pair GEMMs (kernel B1, exact fp32
    partials), summed in float64 on the device in the same order."""
    from gemm_hls_tpu_torch.ops.matmul import matmul

    n_slices = a_slices.shape[0]
    c = None
    for s in range(n_slices + 1):
        for i in range(s + 1):
            j = s - i
            if i >= n_slices or j >= n_slices:
                continue
            p = matmul(a_slices[i], b_slices[j], config=config).double()
            c = p if c is None else c + p
    return c


def ozaki_matmul(a: np.ndarray, b: np.ndarray, *, target_rel: float = 1e-14,
                 config: Optional[GemmConfig] = None,
                 interpret: Optional[bool] = None,
                 device=None) -> np.ndarray:
    """f64-accurate C = A . B from bf16 slices on kernel B1; the operands
    are split on the device (:func:`device_split_f64`).

    The exact fp32 partials are summed in float64 on CUDA; elsewhere in the
    JAX package's float-float scheme (:func:`device_accumulate`), whose
    fp32 ``lo`` floors the result near 2^-45 relative (ROADMAP C2).

    Args:
      a: (M, K) float64 (numpy, host); b: (K, N) float64.
      target_rel: requested relative accuracy (drives the slice count).
      interpret: accepted for the JAX signature; only None / False.
      device: where the products run (default "cuda").

    Returns (M, N) float64.
    """
    if interpret:
        raise NotImplementedError("CUDA has no interpreter mode; pass "
                                  "device='cpu' for the plain versions")
    a, b = _check_pair(a, b)
    slice_bits, n_slices = slice_plan(a.shape[1], target_rel)
    if config is None:
        config = default_config("bfloat16", out_dtype="float32")
    else:
        config = config.replace(dtype="bfloat16", out_dtype="float32")
    dev = _device(device)
    # The split of :func:`split_f64`, in float64 where the products run:
    # exact bf16 slices (<= 8 mantissa bits by construction), a grid per
    # row of A and per column of B.
    a_dev = device_split_f64(torch.from_numpy(a).to(dev), slice_bits, n_slices,
                             axis=1).to(torch.bfloat16)
    b_dev = device_split_f64(torch.from_numpy(b).to(dev), slice_bits, n_slices,
                             axis=0).to(torch.bfloat16)
    if dev.type == "cuda":
        return _f64_accumulate(a_dev, b_dev, config=config).cpu().numpy()
    hi, lo = device_accumulate(a_dev, b_dev, config=config)
    return (hi.double() + lo.double()).cpu().numpy()


def _int8_accumulate(sa, sb, *, n_slices: int):
    """Staged: every int8 slice pair with i + j <= n_slices on kernel B1
    (exact int32), then the float-float combine.  Returns (hi, lo) fp32;
    the caller applies the f64 ulps."""
    from gemm_hls_tpu_torch.ops.matmul import matmul

    m = sa.shape[1]
    n = sb.shape[2]
    cfg = default_config("int8", out_dtype="int32")
    hi = torch.zeros((m, n), dtype=torch.float32, device=sa.device)
    lo = torch.zeros_like(hi)
    for s in range(n_slices + 1):
        for i in range(s + 1):
            j = s - i
            if i >= n_slices or j >= n_slices:
                continue
            p = matmul(sa[i], sb[j], config=cfg)
            w = 2.0 ** (-INT8_SLICE_BITS * (i + j))
            p_hi = (p >> 12).to(torch.float32) * 4096.0 * w
            p_lo = (p & 4095).to(torch.float32) * w
            hi, err = _two_sum(hi, p_hi)
            lo = lo + err
            hi, err = _two_sum(hi, p_lo)
            lo = lo + err
    return hi, lo


def ozaki_matmul_int8(a: np.ndarray, b: np.ndarray, *,
                      target_rel: float = 1e-14, n_slices: int = None,
                      fused: bool = True, split: str = "auto",
                      device=None) -> np.ndarray:
    """f64-class GEMM on the int8 tensor cores: 7-bit slices with exact
    int32 accumulation, 8 slices to span f64's mantissa.

    ``fused`` (default) runs kernel B5: int32 within each K block, flushed
    error-free into float-float per block, so K is unbounded.  The staged
    path (``fused=False``) accumulates int32 across all of K on B1 and keeps
    the K <= 2^17 bound.

    ``split``: "host" runs :func:`split_f64_int8` in numpy; "device" ships
    each operand as an exact (hi, lo) fp32 pair and extracts the slices on
    the device (:func:`device_split_int8`, ~2^-45); "auto" runs the f64
    split on the card (:func:`device_split_f64_int8`) on CUDA, the host
    split elsewhere.
    """
    a, b = _check_pair(a, b)
    m, k = a.shape
    n = b.shape[1]
    if not fused and k > (1 << 17):
        raise ValueError(f"K={k} exceeds the int32 exactness bound (2^17) "
                         "of the staged path; use fused=True")
    if n_slices is None:
        need_bits = min(53, int(-math.log2(target_rel)) + 6)
        n_slices = math.ceil(need_bits / INT8_SLICE_BITS)
    if split not in ("auto", "device", "host"):
        raise ValueError(f"split must be 'auto'|'device'|'host', got {split!r}")
    dev = _device(device)
    if split == "auto" and dev.type != "cuda":
        split = "host"
    if split == "auto":
        sa, ulp_a = device_split_f64_int8(torch.from_numpy(a).to(dev),
                                          n_slices, axis=1)
        sb, ulp_b = device_split_f64_int8(torch.from_numpy(b).to(dev),
                                          n_slices, axis=0)
    elif split == "device":
        (ha, la), (hb, lb) = f64_to_f32pair(a), f64_to_f32pair(b)
        sa, ulp_a = device_split_int8(torch.from_numpy(ha).to(dev),
                                      torch.from_numpy(la).to(dev),
                                      n_slices=n_slices, axis=1)
        sb, ulp_b = device_split_int8(torch.from_numpy(hb).to(dev),
                                      torch.from_numpy(lb).to(dev),
                                      n_slices=n_slices, axis=0)
        # ulps are exact powers of two; fp32 -> f64 is lossless.
        ulp_a, ulp_b = ulp_a.double(), ulp_b.double()
    else:
        sa_h, ulp_a_h = split_f64_int8(a, n_slices, axis=1)
        sb_h, ulp_b_h = split_f64_int8(b, n_slices, axis=0)
        sa, sb = torch.from_numpy(sa_h).to(dev), torch.from_numpy(sb_h).to(dev)
        ulp_a = torch.from_numpy(ulp_a_h).to(dev)
        ulp_b = torch.from_numpy(ulp_b_h).to(dev)
    if fused:
        # n_diags = n_slices: diagonal d = n_slices contributes at
        # 2^(-7 * n_slices) ~ 2^-56, below the float-float floor (~2^-49).
        hi, lo = fused_ozaki_int8(sa, sb, block_k=min(2048, round_up(k, 256)),
                                  n_diags=n_slices)
    else:
        hi, lo = _int8_accumulate(sa, sb, n_slices=n_slices)
    return ((hi.double() + lo.double()) * ulp_a * ulp_b).cpu().numpy()


def ozaki_matmul_distributed(a: np.ndarray, b: np.ndarray, mesh, *,
                             axes=("x", "y"), target_rel: float = 1e-14,
                             config: Optional[GemmConfig] = None) -> np.ndarray:
    """f64-class GEMM over a mesh of ranks: Ozaki bf16 slices x gather-SUMMA
    (``parallel/summa.py``'s schedule, kernel B1 on each rank).

    The exactness argument does not depend on the distribution: SUMMA
    computes every output element as one full-K fp32 accumulation on one
    rank, so the ``2 * slice_bits + log2(K) <= 24`` bound holds unchanged.
    The operands are split on the first rank's device
    (:func:`device_split_f64`), each slice stack is laid out P(None, x, y)
    and gathered once (A along the column axis, B along the row axis), and
    each rank runs the slice pairs' products on its panels.  The exact
    partials are summed per rank in float64 on CUDA ranks, and in the JAX
    package's float-float (hi, lo) scheme elsewhere (ROADMAP C2).  Each
    rank's kernel routes are left in ``last_routes``.

    Args:
      a: (M, K) float64 (numpy); b: (K, N) float64; the mesh must divide M
        by x, N by y and K by x * y, as SUMMA's.
    Returns (M, N) float64.
    """
    from gemm_hls_tpu_torch.parallel.sharding import (
        P, Sharded, all_gather, device_put, map_shards, rank_coords,
    )
    from gemm_hls_tpu_torch.ops.semiring import get_semiring
    from gemm_hls_tpu_torch.parallel.summa import _local_matmul

    a, b = _check_pair(a, b)
    m, k = a.shape
    n = b.shape[1]
    ax, ay = axes
    px, py = mesh.shape[ax], mesh.shape[ay]
    if m % px or k % (px * py) or n % py:
        raise ValueError(f"shape ({m},{n},{k}) not divisible by mesh {px}x{py} "
                         f"(K must divide {px * py})")
    slice_bits, n_slices = slice_plan(k, target_rel)
    if config is None:
        config = default_config("bfloat16", out_dtype="float32")
    else:
        config = config.replace(dtype="bfloat16", out_dtype="float32")
    home = mesh.devices.flat[0]
    sa = device_split_f64(torch.from_numpy(a).to(home), slice_bits, n_slices,
                          axis=1).to(torch.bfloat16)
    sb = device_split_f64(torch.from_numpy(b).to(home), slice_bits, n_slices,
                          axis=0).to(torch.bfloat16)
    sa_d = device_put(sa, mesh, P(None, ax, ay))
    sb_d = device_put(sb, mesh, P(None, ax, ay))
    del sa, sb
    ga = all_gather(sa_d.shards, mesh, ay, dim=2)  # (s, M/px, K)
    gb = all_gather(sb_d.shards, mesh, ax, dim=1)  # (s, K, N/py)
    del sa_d, sb_d
    pairs = [(i, s - i) for s in range(n_slices + 1) for i in range(s + 1)
             if i < n_slices and s - i < n_slices]
    plus_times = get_semiring("plus_times")
    routes = {}

    def local(coord):
        acc = hi = lo = None
        for i, j in pairs:
            part = _local_matmul(routes, coord, ga[coord][i], gb[coord][j],
                                 plus_times, config=config)
            if part.is_cuda:  # exact fp32 partials summed in float64 (C2)
                acc = part.double() if acc is None else acc + part.double()
            elif hi is None:
                hi, lo = part, torch.zeros_like(part)
            else:
                hi, err = _two_sum(hi, part)
                lo = lo + err
        ga[coord] = gb[coord] = None  # a rank's panels live for its products only
        return acc if acc is not None else hi.double() + lo.double()

    shards = map_shards(local, rank_coords(mesh), mesh=mesh)
    ozaki_matmul_distributed.last_routes = routes
    return Sharded(mesh, P(ax, ay), (m, n), shards).full().cpu().numpy()


def ozaki_matmul_int8_distributed(a: np.ndarray, b: np.ndarray, mesh, *,
                                  axes=("x", "y"), target_rel: float = 1e-14,
                                  n_slices: int = None) -> np.ndarray:
    """Distributed f64-class GEMM on the fused int8 kernel: each rank
    all-gathers its slice-stack panels (the gather-SUMMA schedule: A along
    the column axis, B along the row axis) and runs the whole slice
    triangle in one launch of kernel B5, so each rank's arithmetic is the
    single-card path's (~1e-15 normwise, K unbounded).

    The operands are split on the first rank's device (on CUDA the f64
    split on the card, :func:`device_split_f64_int8`; elsewhere the host
    split) and zero-padded so the mesh divides M by x, N by y and K by
    x * y (zero slices add exact zeros).  Each rank receives ``n_slices``
    int8 panels, the bytes of one f64 panel.
    """
    from gemm_hls_tpu_torch.parallel.sharding import (
        P, Sharded, all_gather, device_put, on_device, pad_to,
    )

    a, b = _check_pair(a, b)
    m, k = a.shape
    n = b.shape[1]
    if n_slices is None:
        need_bits = min(53, int(-math.log2(target_rel)) + 6)
        n_slices = math.ceil(need_bits / INT8_SLICE_BITS)
    ax, ay = axes
    px, py = mesh.shape[ax], mesh.shape[ay]
    home = mesh.devices.flat[0]
    if home.type == "cuda":
        sa, ulp_a = device_split_f64_int8(torch.from_numpy(a).to(home), n_slices, axis=1)
        sb, ulp_b = device_split_f64_int8(torch.from_numpy(b).to(home), n_slices, axis=0)
    else:
        sa_h, ulp_a_h = split_f64_int8(a, n_slices, axis=1)
        sb_h, ulp_b_h = split_f64_int8(b, n_slices, axis=0)
        sa, sb = torch.from_numpy(sa_h).to(home), torch.from_numpy(sb_h).to(home)
        ulp_a, ulp_b = torch.from_numpy(ulp_a_h).to(home), torch.from_numpy(ulp_b_h).to(home)
    mp, np_, kp = round_up(m, px), round_up(n, py), round_up(k, px * py)
    sa_d = device_put(pad_to(sa, (n_slices, mp, kp)), mesh, P(None, ax, ay))
    sb_d = device_put(pad_to(sb, (n_slices, kp, np_)), mesh, P(None, ax, ay))
    del sa, sb
    ga = all_gather(sa_d.shards, mesh, ay, dim=2)  # (s, M/px, K)
    gb = all_gather(sb_d.shards, mesh, ax, dim=1)  # (s, K, N/py)
    del sa_d, sb_d
    his = np.empty(mesh.devices.shape, dtype=object)
    los = np.empty(mesh.devices.shape, dtype=object)
    for coord in mesh.coords():
        with on_device(mesh.devices[coord]):
            # n_diags = n_slices: diagonal n_slices weighs 2^(-7 n_slices),
            # below the float-float floor (as ozaki_matmul_int8).
            his[coord], los[coord] = fused_ozaki_int8(
                ga[coord], gb[coord], block_k=min(2048, round_up(kp, 256)),
                n_diags=n_slices)
        ga[coord] = gb[coord] = None
    hi = Sharded(mesh, P(ax, ay), (mp, np_), his).full()[:m, :n]
    lo = Sharded(mesh, P(ax, ay), (mp, np_), los).full()[:m, :n]
    return ((hi.double() + lo.double()) * ulp_a * ulp_b).cpu().numpy()


ozaki_matmul_distributed.last_routes = {}
