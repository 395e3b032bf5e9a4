"""Fused 2-D Cannon: the wrapper of the Hopper kernel that replaces TPU
kernel B19, its plain version, and the front door ``cannon_matmul_fused``.

Counterpart of ``gemm_hls_tpu/ops/pallas_cannon.py``.  On a p x p grid
(flat rank d = i p + j) the skew sends A_ij to rank (i, j - i) and B_ij to
rank (i - j, j); then p steps each add the product of the blocks a rank
holds into its sum while A moves one rank left and B one rank up.  On a
card all p^2 ranks run concurrently in one cooperative launch of
``csrc/cannon_gemm.cu``, exchanging blocks through device memory under
flag signal / wait (acks included); on the CPU ``cannon_gemm_plain`` runs
the same schedule in PyTorch.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence

import torch

from gemm_hls_tpu_torch import _build
from gemm_hls_tpu_torch.ops.ring import (
    _aligned,
    _dims_ptr,
    _in_dtype,
    _KERNEL_DTYPES,
    WG_TILE,
    blocks_per_rank,
    check_stamps,
    flag_words,
    one_device,
    ring_route,
    send_blocks,
    slot_elems,
    spin_budget_ms,
    tensor_maps,
)

_MAX_GRID = 4  # p^2 <= 16 ranks: csrc/cannon_gemm.cu's rank table


def _skew(p: int):
    """(A's, B's) destination of each flat rank's block in the skew."""
    return ([i * p + (j - i) % p for i in range(p) for j in range(p)],
            [(i - j) % p * p + j for i in range(p) for j in range(p)])


# Output types whose running sum is kept at their own precision, as
# pallas_cannon.py's acc of out_dtype is (csrc/cannon_gemm.cu's ``round``).
_NARROW = (torch.bfloat16, torch.float16)


def sum_dtype(in_dtype, out_dtype):
    """The running sum's buffer type: fp32 for floating inputs and for a
    narrow float output (whose rounded values it holds exactly), int32 for
    int8 otherwise."""
    return torch.float32 if in_dtype.is_floating_point or out_dtype in _NARROW else torch.int32


def tile_flags(ml: int, nl: int) -> int:
    """Per-tile flags of the wgmma route (one per WG_TILE tile of a rank's
    (ml, nl) block)."""
    return -(-ml // WG_TILE[0]) * -(-nl // WG_TILE[1])


def cannon_spin_ms(p: int, ml: int, nl: int, kl: int, dtype) -> int:
    """The spin budget of one B19 launch (``ops.ring.spin_budget_ms``): 2 M
    N K operations, and per rank the skew and p - 1 shifts of its A and B
    blocks."""
    e = torch.empty((), dtype=dtype).element_size()
    return spin_budget_ms(2.0 * (p * ml) * (p * nl) * (p * kl), float(p * (ml + nl) * kl * e),
                          dtype)


def cannon_gemm_plain(a_blocks: Sequence[torch.Tensor], b_blocks: Sequence[torch.Tensor],
                      p: int, *, out_dtype=torch.float32):
    """Plain version of ``cannon_gemm``: the kernel's schedule in PyTorch.

    The skew places each block at its destination; then at each of the p
    steps every rank adds one ``torch.matmul`` of the blocks it holds into
    its sum (fp32 for floating inputs, exact for int8) and takes A from its
    right neighbour and B from the one below.  Returns the p^2 C blocks,
    flat order, cast to ``out_dtype`` once at the end as the kernel does.
    A bfloat16 or float16 ``out_dtype`` keeps the sum at that precision
    instead, as JAX's kernel does: each step's product is rounded to it,
    and so is each new partial sum (added in fp32, which holds both
    exactly).
    """
    dt = _in_dtype(a_blocks[0], b_blocks[0])
    to_a, to_b = _skew(p)
    a_at, b_at = [None] * (p * p), [None] * (p * p)
    for d in range(p * p):
        a_at[to_a[d]] = a_blocks[d].to(dt).clone()
        b_at[to_b[d]] = b_blocks[d].to(dt).clone()
    right = [i * p + (j + 1) % p for i in range(p) for j in range(p)]
    down = [(i + 1) % p * p + j for i in range(p) for j in range(p)]
    narrow = out_dtype in _NARROW
    sums = [None] * (p * p)
    for s in range(p):
        for d in range(p * p):
            a, b = a_at[d], b_at[d]
            part = a.float() @ b.float() if dt.is_floating_point else (
                (a.double() @ b.double()).to(torch.int64))
            if narrow:
                part = part.to(out_dtype)
                sums[d] = part if s == 0 else (sums[d].float() + part.float()).to(out_dtype)
            else:
                sums[d] = part if s == 0 else sums[d] + part
        if s + 1 < p:
            a_at = [a_at[right[d]].to(a_at[d].device, copy=True) for d in range(p * p)]
            b_at = [b_at[down[d]].to(b_at[d].device, copy=True) for d in range(p * p)]
    if not dt.is_floating_point and not narrow:
        return [t.to(torch.int32).to(out_dtype) for t in sums]
    return [t.to(out_dtype) for t in sums]


@dataclasses.dataclass
class CannonScratch:
    """Per-rank buffers of one ``cannon_gemm`` launch, flat rank order:
    ``comm_a`` / ``comm_b`` (2, slot) ring buffers of the input type, the
    running ``sums`` (ml, nl) of ``sum_dtype``, ``flags`` int32 (per-step
    counters, then the wgmma route's per-tile flags)."""

    comm_a: List[torch.Tensor]
    comm_b: List[torch.Tensor]
    sums: List[torch.Tensor]
    flags: List[torch.Tensor]


def cannon_scratch(p: int, ml: int, nl: int, kl: int, dtype, device,
                   out_dtype=torch.float32) -> CannonScratch:
    """Fresh scratch for a p x p grid of (ml, kl) x (kl, nl) ``dtype``
    blocks and an ``out_dtype`` result."""
    e = torch.empty((), dtype=dtype).element_size()
    sums_dt = sum_dtype(dtype, out_dtype)
    ranks = range(p * p)
    return CannonScratch(
        comm_a=[torch.empty((2, slot_elems(ml, kl, e)), dtype=dtype, device=device)
                for _ in ranks],
        comm_b=[torch.empty((2, slot_elems(nl, kl, e)), dtype=dtype, device=device)
                for _ in ranks],
        sums=[torch.empty((ml, nl), dtype=sums_dt, device=device) for _ in ranks],
        flags=[torch.zeros(flag_words(p, 3, tile_flags(ml, nl)), dtype=torch.int32,
                           device=device) for _ in ranks])


def cannon_gemm(a_blocks: Sequence[torch.Tensor], b_blocks: Sequence[torch.Tensor], p: int,
                *, out_dtype=torch.float32, scratch: Optional[CannonScratch] = None,
                max_blocks_per_rank: int = 0, stamps: Optional[torch.Tensor] = None):
    """Kernel B19 on one card: Cannon's p x p grid in one launch.

    ``a_blocks[d]`` (M/p, K/p) and ``b_blocks[d]`` (K/p, N/p) for flat rank
    d = i p + j, on one CUDA device, float32 / bfloat16 / int8 (the routes
    of ``ops.ring.ring_gemm``, by K/p; ``cannon_gemm.last_route``).
    Returns the p^2 C blocks (M/p, N/p) of ``out_dtype``, flat order; a
    bfloat16 or float16 ``out_dtype`` rounds per step as
    ``cannon_gemm_plain`` says.  ``stamps`` as ``ring_gemm``'s.  Raises on a
    refused launch: no path falls back.
    """
    ranks = p * p
    if len(a_blocks) != ranks or len(b_blocks) != ranks:
        raise ValueError(f"need {ranks} blocks of A and of B for a {p}x{p} grid")
    if p > _MAX_GRID:
        raise NotImplementedError(f"cannon_gemm: p={p} > {_MAX_GRID} (the kernel's rank table)")
    dev = one_device([t.device for t in (*a_blocks, *b_blocks)])
    if dev.type != "cuda":
        raise ValueError("cannon_gemm launches the kernel: blocks must be on a card "
                         "(cannon_gemm_plain runs on the CPU)")
    ml, kl = a_blocks[0].shape
    nl = b_blocks[0].shape[1]
    for a, b in zip(a_blocks, b_blocks):
        if tuple(a.shape) != (ml, kl) or tuple(b.shape) != (kl, nl):
            raise ValueError(f"blocks of unequal shapes: {tuple(a.shape)} x {tuple(b.shape)}")
    dt = _in_dtype(a_blocks[0], b_blocks[0])
    if dt not in _KERNEL_DTYPES:
        raise NotImplementedError(f"cannon_gemm: no kernel takes {dt} (float32, bfloat16, "
                                  f"int8; ROADMAP B coverage item 9)")
    a_blocks = [_aligned(a.to(dt)) for a in a_blocks]
    b_blocks = [_aligned(b.to(dt)) for b in b_blocks]
    out = [torch.empty((ml, nl), dtype=out_dtype, device=dev) for _ in range(ranks)]
    if ml == 0 or nl == 0:
        return out
    if kl == 0:
        return [o.zero_() for o in out]
    if scratch is None:
        scratch = cannon_scratch(p, ml, nl, kl, dt, dev, out_dtype)
    e = a_blocks[0].element_size()
    slot_a, slot_b = slot_elems(ml, kl, e), slot_elems(nl, kl, e)
    words = flag_words(p, 3, tile_flags(ml, nl))
    if (len(scratch.comm_a) != ranks or len(scratch.comm_b) != ranks
            or any(c.dtype != dt or c.numel() < 2 * slot_a or not c.is_contiguous()
                   for c in scratch.comm_a)
            or any(c.dtype != dt or c.numel() < 2 * slot_b or not c.is_contiguous()
                   for c in scratch.comm_b)
            or any(s.shape != (ml, nl) or not s.is_contiguous() for s in scratch.sums)
            or any(f.dtype != torch.int32 or f.numel() < words for f in scratch.flags)):
        raise ValueError("scratch does not fit this grid (see cannon_scratch)")
    sums_dt = sum_dtype(dt, out_dtype)
    table = []
    for d in range(ranks):
        ca, cb = scratch.comm_a[d].reshape(-1), scratch.comm_b[d].reshape(-1)
        sums, fl = scratch.sums[d], scratch.flags[d]
        if sums.dtype != sums_dt:
            raise ValueError(f"scratch sums must be {sums_dt}")
        fl.zero_()
        table += [a_blocks[d].data_ptr(), b_blocks[d].data_ptr(), out[d].data_ptr(),
                  sums.data_ptr(), ca.data_ptr(), ca[slot_a:].data_ptr(), cb.data_ptr(),
                  cb[slot_b:].data_ptr(), fl.data_ptr()]
    vec = int((kl * e) % 16 == 0)
    spin = cannon_spin_ms(p, ml, nl, kl, dt)
    route = ring_route(dt, kl)
    n_send = -1
    if route == "wgmma":
        n_send = send_blocks(blocks_per_rank(dev, ranks, max_blocks_per_rank),
                             2.0 * ml * nl * kl, float((ml + nl) * kl * e) if p > 1 else 0.0, dt)
    rnd = _build.dtype_code(out_dtype) if out_dtype in _NARROW else 0
    dims = _dims_ptr([p, ml, nl, kl, _build.dtype_code(dt), _build.dtype_code(out_dtype),
                      vec, vec, int(max_blocks_per_rank), spin, int(route == "wgmma"), n_send,
                      rnd])
    maps = tensor_maps(ranks, route, dev)
    split = (ctypes.c_int * 2)()
    lib = _build.library()
    with torch.cuda.device(dev):
        stamps_ptr = check_stamps(stamps, ranks, p, dev)
        rc = lib.cannon_gemm((ctypes.c_int64 * len(table))(*table), dims, split,
                             0 if maps is None else maps.data_ptr(), stamps_ptr,
                             torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "cannon_gemm")
    cannon_gemm.launches += 1
    cannon_gemm.last_split = (split[0], split[1])
    cannon_gemm.last_route = route
    return out


def cannon_blocks(a, b, p: int):
    """Pre-blocking of ``pallas_cannon.py:140-144``: (p^2) A blocks (M/p,
    K/p) and B blocks (K/p, N/p), flat index i p + j."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2 or m % p or n % p or k % p:
        raise ValueError(f"shape ({m},{n},{k}) not divisible by grid {p}")
    ml, nl, kl = m // p, n // p, k // p
    ab = a.reshape(p, ml, p, kl).transpose(1, 2).reshape(p * p, ml, kl)
    bb = b.reshape(p, kl, p, nl).transpose(1, 2).reshape(p * p, kl, nl)
    return list(ab.unbind(0)), list(bb.unbind(0))


def cannon_matmul_fused(a, b, p: int, *, devices=None, interpret=None, precision=None,
                        out_dtype=torch.float32):
    """C = A . B via fused Cannon on a p x p grid of p^2 ranks.

    A (M, K), B (K, N) with M, N, K divisible by p; returns the assembled
    (M, N).  ``devices=None`` puts the p^2 ranks on the current card; a
    given list names each rank's device (all on one card, or ``["cpu"] *
    p * p`` for the plain version; ranks on distinct cards raise
    NotImplementedError, ROADMAP A7).  float32 runs IEEE fp32 whatever
    ``precision`` says, bf16 sums in fp32, int8 in int32 cast at the store;
    ``interpret`` is accepted and ignored.

    A bfloat16 or float16 ``out_dtype`` keeps the running sum at that
    precision, rounding each step's product and partial sum, as JAX's
    kernel keeps its sum in ``out_dtype``; other outputs sum in fp32
    (int32) and are cast once.
    """
    del interpret, precision
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices=['cpu'] * p * p for the "
                               "plain version")
        devices = [torch.device("cuda")] * (p * p)
    devices = list(devices)[: p * p]
    if len(devices) < p * p:
        raise ValueError(f"need {p * p} devices for a {p}x{p} grid, "
                         f"have {len(devices)}")
    dev = one_device(devices)
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    a_blocks, b_blocks = cannon_blocks(a, b, p)
    a_blocks = [t.to(dev) for t in a_blocks]
    b_blocks = [t.to(dev) for t in b_blocks]
    if dev.type == "cpu":
        out = cannon_gemm_plain(a_blocks, b_blocks, p, out_dtype=out_dtype)
    else:
        out = cannon_gemm(a_blocks, b_blocks, p, out_dtype=out_dtype)
    return assemble(out, p)


def assemble(blocks: Sequence[torch.Tensor], p: int) -> torch.Tensor:
    """The (M, N) matrix of p^2 blocks in flat order
    (``pallas_cannon.py:190-191``)."""
    ml, nl = blocks[0].shape
    return torch.stack(list(blocks)).reshape(p, p, ml, nl).transpose(1, 2).reshape(p * ml, p * nl)


# Kernel launches since the counts were last reset (plain calls not counted),
# and the (sender, compute) blocks per rank and the route of the last launch.
cannon_gemm.launches = 0
cannon_gemm.last_split = None
cannon_gemm.last_route = None
