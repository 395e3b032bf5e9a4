"""The 1-D ring GEMM with the transfer fused into the kernel: the wrapper of
the Hopper kernel that replaces TPU kernel B18, its plain version, and the
front doors ``ring_matmul`` / ``shard_operands_ring``.

Counterpart of ``gemm_hls_tpu/ops/pallas_ring.py``.  A is row-sharded over
the ring, B column-sharded; at step s rank r multiplies its A block by the
B block that came from rank (r - s) mod n, writing that column block of
its C rows, while it passes the block on to rank r + 1.  The result is
row-sharded with full N: the port's form of JAX's ``P(axis, None)``
output is the list of the n row shards (M/n, N), in ring order.

The ranks of a mesh live on one device (``parallel.mesh.one_device``).  On
a card, all n ranks run concurrently in one cooperative launch of
``csrc/ring_gemm.cu``, each with its own buffers, exchanging blocks
through device memory under flag signal / wait: the TPU kernel's protocol,
acks included, under real concurrency; only the transport (HBM, not
NVLink) differs from a multi-card ring.  On the CPU, ``ring_gemm_plain``
runs the same step schedule in PyTorch.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import TYPE_CHECKING, List, Optional, Sequence

import torch

from gemm_hls_tpu_torch import _build

if TYPE_CHECKING:
    from gemm_hls_tpu_torch.parallel.mesh import Mesh


def one_device(devices) -> torch.device:
    """``parallel.mesh.one_device``, imported at call time:
    ``parallel/__init__.py`` imports this module."""
    from gemm_hls_tpu_torch.parallel.mesh import one_device as check
    return check(devices)


_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.int8)

# The Hopper tile engine's tile (csrc/wgmma_tile.cuh: kWgBM x kWgBN).
WG_TILE = (128, 256)


def ring_route(dtype, k: int) -> str:
    """The compute route a B18 / B19 launch takes for input ``dtype`` and a
    K (K/p for Cannon) of ``k``: ``"wgmma"`` (the Hopper tile engine: TMA,
    warp-specialised wgmma) for bf16 and int8 whose K rows are whole
    16-byte units, which a TMA map needs; ``"mma.sync"`` for bf16 and int8
    with other K; ``"simt"`` (IEEE fp32 on the CUDA cores) for fp32.  A
    route is chosen here by shape, never as a fallback: a kernel that
    fails to build or launch raises."""
    if dtype == torch.float32:
        return "simt"
    esize = torch.empty((), dtype=dtype).element_size()
    return "wgmma" if (k * esize) % 16 == 0 else "mma.sync"


# Rates behind ``send_blocks``, per SM of an H100, from phase 24's stamps
# and shaded toward what a ring needs: the bytes a second one sender block
# forwards with bulk copies beside a busy card (16.7 MB in ~0.44 ms, 38
# GB/s), and the operations a second one engine block does (bf16: 5.5
# TFLOP/s an SM).  They give 2 sender blocks a rank at 4 and 8 ranks of
# bf16 8192^3 and in Cannon at p = 2; a third was no faster at either ring
# size in an A/B on the card.
_SEND_RATE = 3.5e10
_SM_RATE = {torch.bfloat16: 4.5e12, torch.int8: 9e12}


def send_blocks(per_rank: int, step_ops: float, step_bytes: float, dtype) -> int:
    """Sender blocks a rank of ``per_rank`` blocks gives the forwarding on
    the wgmma route: the share of its blocks that makes a step's
    ``step_bytes`` of forwarding take no longer than its ``step_ops``
    operations on the rest (rates ``_SEND_RATE`` / ``_SM_RATE``), at least
    one and at most ``per_rank - 1``; none when nothing is forwarded (one
    rank)."""
    if step_bytes <= 0:
        return 0
    t_send = step_bytes / _SEND_RATE
    t_comp = step_ops / _SM_RATE[dtype]
    want = -(-per_rank * t_send // (t_send + t_comp))
    return int(min(max(want, 1), per_rank - 1))


def blocks_per_rank(dev, ranks: int, cap: int = 0) -> int:
    """Blocks of each rank on the wgmma route, which runs one block a SM:
    the card's SMs shared among the ranks, capped by ``cap`` > 0."""
    per_rank = torch.cuda.get_device_properties(dev).multi_processor_count // ranks
    return min(per_rank, cap) if cap > 0 else per_rank

# Flag words per rank: one ack, then recv[n] and done[n] from word 8
# (csrc/ring_gemm.cu), padded to whole 128-byte lines.
_FLAG_BASE = 8


def flag_words(n_steps: int, per_step: int, extra: int = 0) -> int:
    """Int32 flag words of one rank: 8 single flags, then ``per_step``
    counters per step and ``extra`` more (Cannon's per-tile flags), padded
    to 32 words."""
    return -(-(_FLAG_BASE + per_step * n_steps + extra) // 32) * 32


def slot_elems(rows: int, cols: int, esize: int) -> int:
    """Elements of one ring-buffer slot of (rows, cols): padded so that
    each slot starts 256-byte aligned (the kernels' 16-byte vectors, the
    bulk copies' and TMA maps' 16-byte bases)."""
    return -(-(rows * cols * esize) // 256) * 256 // esize


# Floor rates of the spin budget (``spin_budget_ms``), far below what the
# kernels reach on an H100 (B18 at bf16 8192^3 ran at ~80 TFLOP/s, PERF.md
# section 6): operations a second of the whole card by input type, and bytes
# a second that one sender block copies or transposes.
_FLOOR_OPS = {torch.float32: 1e12, torch.bfloat16: 1e13, torch.int8: 1e13}
_FLOOR_COPY = 1e9


def spin_budget_ms(ops: float, copy_bytes: float, dtype) -> int:
    """Milliseconds a flag wait of B18 / B19 may spin before it traps
    (``csrc/rank_sync.cuh``).

    No wait can rightly outlast its launch, so the budget is 4 s plus four
    times the whole launch at floor rates: ``ops`` (all ranks, all steps)
    over ``_FLOOR_OPS[dtype]`` and ``copy_bytes`` (what one rank's sender
    blocks stage and forward, as if one block did it all) over
    ``_FLOOR_COPY``.  It grows with the size of the call, so a large one is
    never cut short, and a protocol fault still traps.  Clamped to int32.
    """
    seconds = 4.0 + 4.0 * (ops / _FLOOR_OPS[dtype] + copy_bytes / _FLOOR_COPY)
    return int(min(seconds * 1e3, 2 ** 31 - 1))


def ring_spin_ms(n: int, ml: int, nl: int, k: int, dtype) -> int:
    """The spin budget of one B18 launch: 2 M N K operations, and per rank
    the staging transpose and n - 1 forwards of its (k, nl) block."""
    esize = torch.empty((), dtype=dtype).element_size()
    return spin_budget_ms(2.0 * (n * ml) * (n * nl) * k, float(n * nl * k * esize), dtype)


def _product(a, b, out_dtype):
    """One (rank, step) product, the plain versions' arithmetic: fp32 sums
    for floating inputs (bf16 products exact in fp32), exact integer sums
    for int8 (float64 holds every int8 product sum below 2^53), each cast
    to ``out_dtype`` once, as the kernels store it."""
    if a.dtype.is_floating_point:
        return (a.float() @ b.float()).to(out_dtype)
    return (a.double() @ b.double()).to(torch.int32).to(out_dtype)


def _in_dtype(a, b):
    return torch.promote_types(a.dtype, b.dtype)


def ring_gemm_plain(a_shards: Sequence[torch.Tensor], b_shards: Sequence[torch.Tensor],
                    *, out_dtype=torch.float32):
    """Plain version of ``ring_gemm``: the kernel's step schedule in PyTorch.

    Each rank's buffer starts as its own B block; at step s every rank r
    writes C_r's column block (r - s) mod n from one ``torch.matmul`` of its
    A block by the block it holds, then every rank takes its left
    neighbour's block.  ``block_k`` changes neither (see ``ring_gemm``).
    """
    n = len(a_shards)
    nl = b_shards[0].shape[1]
    dt = _in_dtype(a_shards[0], b_shards[0])
    bufs = [b.to(dt).clone() for b in b_shards]
    out = [torch.empty((a.shape[0], n * nl), dtype=out_dtype, device=a.device)
           for a in a_shards]
    for s in range(n):
        for r in range(n):
            src = (r - s) % n
            out[r][:, src * nl:(src + 1) * nl] = _product(a_shards[r].to(dt), bufs[r],
                                                          out_dtype)
        if s + 1 < n:
            bufs = [bufs[(r - 1) % n].to(a_shards[r].device, copy=True) for r in range(n)]
    return out


@dataclasses.dataclass
class RingScratch:
    """Per-rank buffers of one ``ring_gemm`` launch, in rank order: ``comm``
    (2, slot) ring buffers of the input type, ``flags`` int32 counters.
    They may sit anywhere (the rank table takes each rank's own pointers);
    the wrapper zeroes the flags before each launch."""

    comm: List[torch.Tensor]
    flags: List[torch.Tensor]


def ring_scratch(n: int, k: int, nl: int, dtype, device) -> RingScratch:
    """Fresh scratch for ``n`` ranks with B blocks of (k, nl) ``dtype``."""
    esize = torch.empty((), dtype=dtype).element_size()
    slot = slot_elems(nl, k, esize)
    return RingScratch(
        comm=[torch.empty((2, slot), dtype=dtype, device=device) for _ in range(n)],
        flags=[torch.zeros(flag_words(n, 2), dtype=torch.int32, device=device)
               for _ in range(n)])


def stamp_words(steps: int) -> int:
    """Int64 time stamps per rank of a launch of ``steps`` steps
    (``csrc/dist_tile.cuh::stamp_words``): launch start, staging done, the
    longest flag wait, a spare word, then each step's compute start,
    compute end and sends' end."""
    return 4 + 3 * steps


def check_stamps(stamps, ranks: int, steps: int, dev):
    """The stamps tensor's pointer (0 for None), zeroed on the stream."""
    if stamps is None:
        return 0
    if (stamps.dtype != torch.int64 or stamps.device.type != dev.type
            or not stamps.is_contiguous()
            or stamps.numel() < ranks * stamp_words(steps)):
        raise ValueError(f"stamps: {ranks * stamp_words(steps)} contiguous int64 on {dev} needed")
    stamps.zero_()
    return stamps.data_ptr()


def tensor_maps(ranks: int, route: str, dev):
    """The device buffer of the wgmma route's tensor maps (4 of 128 bytes a
    rank, written by the launch before the kernel; freed after the call,
    which the caching allocator orders after the kernel on its stream)."""
    if route != "wgmma":
        return None
    return torch.empty(ranks * 4 * 128, dtype=torch.uint8, device=dev)


def _vec(t: torch.Tensor, k: int) -> int:
    """1 if the K-contiguous rows of ``t`` start at 16-byte boundaries
    (the kernels' cp.async tile loads)."""
    return int(t.data_ptr() % 16 == 0 and (k * t.element_size()) % 16 == 0)


def _dims_ptr(values):
    return (ctypes.c_int * len(values))(*values)


def ring_gemm(a_shards: Sequence[torch.Tensor], b_shards: Sequence[torch.Tensor], *,
              out_dtype=torch.float32, block_k: Optional[int] = None,
              scratch: Optional[RingScratch] = None, max_blocks_per_rank: int = 0,
              stamps: Optional[torch.Tensor] = None):
    """Kernel B18 on one card: the ring GEMM of n ranks in one launch.

    ``a_shards[r]`` (M/n, K) and ``b_shards[r]`` (K, N/n), rank order, on
    one CUDA device, of one type among float32, bfloat16 and int8 (fp32
    runs IEEE fp32 on the CUDA cores; bf16 the tensor cores with fp32 sums;
    int8 sums in int32, cast at the store).  Returns the n row shards (M/n,
    N) of ``out_dtype``.  ``block_k`` (None or a divisor of K) picks the
    TPU's body (VMEM or K streamed in block_k chunks) and is only checked
    here: the kernel streams K through shared memory in steps of its own,
    so every block_k gives the same bits.  The compute route is
    ``ring_route``'s, recorded as ``ring_gemm.last_route``.  ``scratch``
    (default: fresh) holds the ring buffers and flags;
    ``max_blocks_per_rank`` > 0 caps the blocks of a rank (tests);
    ``stamps`` (int64, n * ``stamp_words(n)``, zeroed here) receives the
    launch's time stamps (``csrc/dist_tile.cuh``).  Raises on a refused
    launch: no path falls back.
    """
    n = len(a_shards)
    if n != len(b_shards) or n < 1:
        raise ValueError(f"{n} A shards and {len(b_shards)} B shards")
    dev = one_device([t.device for t in (*a_shards, *b_shards)])
    if dev.type != "cuda":
        raise ValueError("ring_gemm launches the kernel: shards must be on a card "
                         "(ring_gemm_plain runs on the CPU)")
    ml, k = a_shards[0].shape
    nl = b_shards[0].shape[1]
    for a, b in zip(a_shards, b_shards):
        if tuple(a.shape) != (ml, k) or tuple(b.shape) != (k, nl):
            raise ValueError(f"shards of unequal shapes: {tuple(a.shape)} x {tuple(b.shape)}")
    dt = _in_dtype(a_shards[0], b_shards[0])
    if dt not in _KERNEL_DTYPES:
        raise NotImplementedError(f"ring_gemm: no kernel takes {dt} (float32, bfloat16, int8)")
    if block_k is not None and (int(block_k) < 1 or k % int(block_k)):
        raise ValueError(f"K={k} must be divisible by block_k={block_k}")
    a_shards = [_aligned(a.to(dt)) for a in a_shards]
    b_shards = [_aligned(b.to(dt)) for b in b_shards]
    out = [torch.empty((ml, n * nl), dtype=out_dtype, device=dev) for _ in range(n)]
    if ml == 0 or nl == 0:
        return out
    if k == 0:
        return [o.zero_() for o in out]
    if scratch is None:
        scratch = ring_scratch(n, k, nl, dt, dev)
    esize = a_shards[0].element_size()
    slot = slot_elems(nl, k, esize)
    if len(scratch.comm) != n or any(c.dtype != dt or c.numel() < 2 * slot or
                                     not c.is_contiguous() for c in scratch.comm):
        raise ValueError(f"scratch: {n} contiguous ring buffers of 2 x {slot} {dt} needed")
    words = flag_words(n, 2)
    if len(scratch.flags) != n or any(f.dtype != torch.int32 or f.numel() < words
                                      for f in scratch.flags):
        raise ValueError(f"scratch: {n} int32 flag arrays of {words} words needed")
    table = []
    for a, b, c, comm, fl in zip(a_shards, b_shards, out, scratch.comm, scratch.flags):
        fl.zero_()
        base = comm.reshape(-1)
        table += [a.data_ptr(), b.data_ptr(), c.data_ptr(), base.data_ptr(),
                  base[slot:].data_ptr(), fl.data_ptr()]
    vec_a = min(_vec(a, k) for a in a_shards)
    vec_b = int((k * esize) % 16 == 0)
    spin = ring_spin_ms(n, ml, nl, k, dt)
    route = ring_route(dt, k)
    n_send = -1
    if route == "wgmma":
        n_send = send_blocks(blocks_per_rank(dev, n, max_blocks_per_rank),
                             2.0 * ml * nl * k, float(nl * k * esize) if n > 1 else 0.0, dt)
    dims = _dims_ptr([n, ml, nl, k, _build.dtype_code(dt), _build.dtype_code(out_dtype),
                      vec_a, vec_b, int(max_blocks_per_rank), spin, int(route == "wgmma"),
                      n_send])
    maps = tensor_maps(n, route, dev)
    split = (ctypes.c_int * 2)()
    lib = _build.library()
    with torch.cuda.device(dev):
        stamps_ptr = check_stamps(stamps, n, n, dev)
        rc = lib.ring_gemm((ctypes.c_int64 * len(table))(*table), dims, split,
                           0 if maps is None else maps.data_ptr(), stamps_ptr,
                           torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "ring_gemm")
    ring_gemm.launches += 1
    ring_gemm.last_split = (split[0], split[1])
    ring_gemm.last_route = route
    return out


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (a copy if not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _ring_devices(mesh: Mesh, axis: str):
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis!r} (axes {mesh.axis_names})")
    return mesh.along(axis)


def shard_operands_ring(a, b, mesh: Mesh, axis: str = "x"):
    """A in row blocks and B in column blocks, one of each per rank in ring
    order, each on its rank's device: the port's form of JAX's
    ``P(axis, None)`` / ``P(None, axis)`` shardings."""
    devices = _ring_devices(mesh, axis)
    n = len(devices)
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    m, k = a.shape
    k2, nn = b.shape
    if k != k2 or m % n or nn % n:
        raise ValueError(f"shape ({m},{nn},{k}) not divisible by ring size {n}")
    ml, nl = m // n, nn // n
    return ([a[r * ml:(r + 1) * ml].to(d).contiguous() for r, d in enumerate(devices)],
            [b[:, r * nl:(r + 1) * nl].to(d).contiguous() for r, d in enumerate(devices)])


def ring_matmul(a, b, mesh: Mesh, *, axis: str = "x", config=None, interpret=None,
                out_dtype=torch.float32, block_k: Optional[int] = None):
    """C[P(x), full-N] = A[P(x), K] . B[K, P(x)] on a 1-D ring of the mesh's
    ``axis``.

    ``a`` and ``b`` are global (M, K) / (K, N) tensors (sharded here) or
    the shard lists of :func:`shard_operands_ring`.  Returns the n row
    shards (M/n, N) of ``out_dtype``, in ring order, on the ranks' device.
    ``block_k`` (a divisor of K) names the TPU's tiled body, None its VMEM
    body; both are one kernel here and give the same bits.  float32, bfloat16 and int8 inputs:
    float32 runs IEEE fp32 whatever ``config.precision`` says (the port's
    rule for "default"), bf16 sums in fp32, int8 sums in int32 and is cast
    at the store.

    Not ported: the TPU compiled mode's lane rules (N/n and block_k
    multiples of 128, ``pallas_ring.py:232-247``), which come from its (8,
    128) tiling; ``interpret`` is accepted and ignored, as
    ``GemmConfig.from_reference`` drops it.  Ranks on two or more cards
    raise NotImplementedError (ROADMAP A7).
    """
    del config, interpret
    devices = _ring_devices(mesh, axis)
    n = len(devices)
    dev = one_device(devices)
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        a_s, b_s = list(a), list(b)
        if len(a_s) != n or len(b_s) != n:
            raise ValueError(f"{len(a_s)} / {len(b_s)} shards for a ring of {n}")
        m, k = a_s[0].shape[0] * n, a_s[0].shape[1]
        if b_s[0].shape[0] != k:
            raise ValueError(f"shape ({m},{b_s[0].shape[1] * n},{k}) not divisible by "
                             f"ring size {n}")
        a_s = [t.to(dev) for t in a_s]
        b_s = [t.to(dev) for t in b_s]
    else:
        a_s, b_s = shard_operands_ring(a, b, mesh, axis)
        k = a_s[0].shape[1]
    if block_k is not None and k % block_k:
        raise ValueError(f"K={k} must be divisible by block_k={block_k}")
    if dev.type == "cpu":
        return ring_gemm_plain(a_s, b_s, out_dtype=out_dtype)
    return ring_gemm(a_s, b_s, out_dtype=out_dtype, block_k=block_k)


# Kernel launches since the counts were last reset (plain calls not counted),
# and the (sender, compute) blocks per rank and the route of the last launch.
ring_gemm.launches = 0
ring_gemm.last_split = None
ring_gemm.last_route = None
