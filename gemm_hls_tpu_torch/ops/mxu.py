"""Dense plus_times GEMM: the wrappers of kernels B1 and B2
(``csrc/mxu_wgmma.cu`` on the tile engine, ``csrc/mxu_gemm.cu``, float64 on
``csrc/dmma_tma.cu`` or ``csrc/dmma_gemm.cu``; B2's row softmax
``csrc/row_softmax_wgmma.cu`` on the engine, ``csrc/row_softmax.cu``) and
their plain PyTorch version.

Counterparts of ``gemm_hls_tpu/ops/pallas_mxu.py::mxu_matmul`` (2-D, B1)
and ``::mxu_matmul_batched`` (3-D, B2), each with its optional fused
epilogue (``ops/epilogue.py``): a registered one in the library, a Python
callable as a functor generated for the call's route, type and layout
(``ops/codegen.py``) at the same store.  A CUDA tensor launches a kernel
or raises; a CPU tensor runs :func:`mxu_matmul_plain`.  Operands are passed
in their physical layout with the transpose flags and, batched, with their
batch stride: no transpose is materialised and a 2-D operand broadcast over
the batch is never copied.
"""

from __future__ import annotations

import collections
from typing import Optional

import torch

from gemm_hls_tpu_torch import _build
from gemm_hls_tpu_torch.config import (
    ROW_SOFTMAX_MAX_N, GemmConfig, call_route, dtype_name, named_route,
    row_softmax_fusable,
)
from gemm_hls_tpu_torch.ops import codegen
from gemm_hls_tpu_torch.ops.epilogue import Epilogue, kernel_code

# Largest M the kernels' grid takes (gridDim.y <= 65535 blocks of 128 rows).
_MAX_M = 65535 * 128
_INT_MAX = 2**31 - 1

_EP_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# Integer inputs no kernel takes: the reference refuses int64 plus_times (its
# int32 accumulator is narrower than the inputs).
_NO_PLUS_TIMES = (torch.int64, torch.uint64)


def _dims(a, b, transpose_a, transpose_b):
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"expected 2-D operands, got {a.shape} x {b.shape}")
    return _mnk(a, b, transpose_a, transpose_b)


def _mnk(a, b, transpose_a, transpose_b):
    k, m = a.shape[-2:] if transpose_a else a.shape[-2:][::-1]
    n, kb = b.shape[-2:] if transpose_b else b.shape[-2:][::-1]
    if kb != k:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    return m, n, k


def batched_dims(a, b, transpose_a, transpose_b):
    """(batch, M, N, K) of a batched call: both operands 3-D with one batch
    size, or one of them 2-D (broadcast over the other's batch)."""
    if {a.ndim, b.ndim} not in ({3}, {2, 3}):
        raise ValueError(f"expected 3-D operands (one may be 2-D), got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    if a.ndim == b.ndim == 3 and a.shape[0] != b.shape[0]:
        raise ValueError(f"batch dims must match: {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    bsz = a.shape[0] if a.ndim == 3 else b.shape[0]
    return (bsz, *_mnk(a, b, transpose_a, transpose_b))


def _row_major(x: torch.Tensor) -> torch.Tensor:
    """``x`` with unit stride on its last axis and whole rows (a copy only
    if it has neither; transpose flags and batch strides, not a copy,
    express transposition and broadcasting)."""
    if x.stride(-1) == 1 and x.stride(-2) >= x.shape[-1]:
        return x
    return x.contiguous()


def _strides(x):
    """(row pitch, batch stride) in elements; a 2-D operand's batch stride
    is 0 (broadcast), and so is a batch of one's (its stride is never
    stepped)."""
    return x.stride(-2), (x.stride(0) if x.ndim == 3 and x.shape[0] > 1 else 0)


def _as_int32(x):
    """``x`` as the reference's ``astype(int32)`` makes it: integers of
    other widths widened, or wrapped to their low 32 bits (uint32, int64);
    other types as they are."""
    if x.is_floating_point() or x.dtype in (torch.int32, torch.bool):
        return x
    return x.to(torch.int64).to(torch.int32)


# Deepest K whose 16-bit-half partial sums stay exact in float64
# (K 2^32 <= 2^53 with a margin).
_HALF_SUM_K = 1 << 20


def _int32_matmul(a, b):
    """The int32 product ``a . b`` (``torch.matmul``'s broadcasting) of
    int32 operands, exact modulo 2^32 as the reference's int32 sum wraps,
    on either device from float64 products (CUDA's matmul takes no
    integers): one product where K max|a| max|b| < 2^53, every partial sum
    exact; else each operand splits into a signed high and an unsigned low
    16-bit half, and the three products that reach the low 32 bits run in
    float64, each exact (|partial sum| < K 2^32), K cut into pieces of
    ``_HALF_SUM_K``."""
    def top(x):
        return int(x.to(torch.int64).abs().amax()) if x.numel() else 0

    if a.shape[-1] * top(a) * top(b) < 2**53:
        wide = torch.matmul(a.to(torch.float64), b.to(torch.float64))
        return wide.to(torch.int64).to(torch.int32)
    total = None
    for k0 in range(0, a.shape[-1], _HALF_SUM_K):
        x = a[..., k0:k0 + _HALF_SUM_K]
        y = b[..., k0:k0 + _HALF_SUM_K, :]
        x_lo, y_lo = (x & 0xFFFF).double(), (y & 0xFFFF).double()
        x_hi, y_hi = (x >> 16).double(), (y >> 16).double()
        low = torch.matmul(x_lo, y_lo).to(torch.int64)
        cross = (torch.matmul(x_hi, y_lo) + torch.matmul(x_lo, y_hi)).to(torch.int64)
        part = (low & 0xFFFFFFFF) + ((cross & 0xFFFF) << 16)
        total = part if total is None else total + part
    return (total & 0xFFFFFFFF).to(torch.int32)


def _vec_ok(x) -> int:
    """16-byte loads are legal: aligned base, row pitch and batch stride."""
    vec = 16 // x.element_size()
    return int(x.data_ptr() % 16 == 0
               and all(s % vec == 0 for s in _strides(x)))


def operand_aligned(x) -> bool:
    """Whether ``x``, as a launch passes it (:func:`_row_major`), has the
    16-byte base, row pitch and batch stride a TMA map describes; found
    without the copy a launch makes of an operand that is not row-major
    (a fresh copy is aligned where its rows are whole 16-byte units)."""
    if x.stride(-1) == 1 and x.stride(-2) >= x.shape[-1]:
        return bool(_vec_ok(x))
    return x.shape[-1] * x.element_size() % 16 == 0


def mxu_route(dtype, transpose_a: bool, transpose_b: bool, aligned: bool) -> str:
    """The kernel a B1 or B2 launch takes (one rule for both, 2-D and
    batched): ``"wgmma"`` (the Hopper tile engine, ``csrc/mxu_wgmma.cu``:
    TMA and warp-specialised wgmma, a batch walked as the engine's steps)
    for bf16 or fp16 in any layout, or int8 with both operands K-major (A
    (M, K), B held (N, K): int8 wgmma reads nothing else), whose operands
    are ``aligned`` (16-byte bases, row pitches and batch strides whole
    16-byte units: what a TMA map describes); ``"wmma"``
    (``csrc/mxu_gemm.cu``'s tensor-core tile) for the other bf16 / fp16 /
    int8 calls; ``"dmma"`` (IEEE float64 on the FP64 tensor cores, any
    layout and alignment; its tile: :func:`dmma_tile`) for float64;
    ``"simt"`` (IEEE
    fp32, or an int32 accumulator that wraps, on the CUDA cores) for fp32
    and int32, int16, uint8, uint16 and uint32.  B2's row softmax has kernels of its own
    (:func:`row_softmax_route`).  Chosen by shape, never as a fallback: a
    kernel that fails to build or launch raises.  The rule itself is
    ``config.call_route``'s, whose "tc" tile is WMMA's."""
    route = call_route(dtype, "plus_times", transpose_a, transpose_b, aligned)
    return "wmma" if route == "tc" else route


DMMA_TILES = ("tma", "cp_async")


def dmma_tile(aligned: bool) -> str:
    """The tile a float64 ("dmma") launch of B1 or B2 runs: ``"tma"``
    (``csrc/dmma_tma.cu``: TMA loads, a producer thread and two consumer
    warpgroups, persistent blocks) where the operands are ``aligned``
    (16-byte bases, row pitches and batch strides: what a TMA map
    describes), else ``"cp_async"`` (``csrc/dmma_gemm.cu``: any pitch, 8-byte
    copies).  Chosen by shape, never as a fallback."""
    return "tma" if aligned else "cp_async"


# Deepest K the row softmax's engine route takes: its block holds the
# item's whole 128-row A tile (64 KB of shared memory at K 256).
ROW_SOFTMAX_ENGINE_MAX_K = 256


def row_softmax_route(dtype, out_dtype, n: int, k: int, aligned: bool) -> str:
    """The kernel a row-softmax launch of B2 takes: ``"wgmma"`` (the Hopper
    tile engine, ``csrc/row_softmax_wgmma.cu``: the scores computed twice by
    wgmma, once for each row's max and sum and once for P, which leaves by
    TMA stores) for bf16 or fp16 in any layout whose operands are
    ``aligned`` (16-byte bases, row pitches and batch strides whole 16-byte
    units, as for :func:`mxu_route`), with K <= ROW_SOFTMAX_ENGINE_MAX_K
    (the block holds a whole 128-row A tile) and rows of P that are whole
    16-byte units (N times ``out_dtype``'s bytes: what P's TMA map
    describes); else ``csrc/row_softmax.cu``, ``"wmma"`` for bf16 / fp16
    (its tensor-core strip) and ``"simt"`` for fp32 (the CUDA cores).
    Every route takes N up to ``ROW_SOFTMAX_MAX_N``.  Chosen by shape, never
    as a fallback."""
    if dtype == torch.float32:
        return "simt"
    if (aligned and k <= ROW_SOFTMAX_ENGINE_MAX_K
            and n * out_dtype.itemsize % 16 == 0):
        return "wgmma"
    return "wmma"


def _ep_operands(eps, n, device, wide=False):
    """The (N,) epilogue operands as contiguous tensors of one dtype the
    kernel reads (f32, bf16 or f16; anything else is widened to f32).
    ``wide``: a float64 GEMM's, which also reads float64 operands and
    widens anything else to float64, as the plain version's promotion
    does."""
    flat = []
    for e in eps:
        if e.numel() != n or e.shape[-1] != n:
            raise ValueError(f"epilogue operands must be (N,)=({n},), got "
                             f"{tuple(e.shape)}")
        if e.device != device:
            raise ValueError(f"epilogue operand on {e.device}, operands on "
                             f"{device}")
        flat.append(e.reshape(n))
    dt = flat[0].dtype if flat else torch.float32
    kinds = _EP_DTYPES + ((torch.float64,) if wide else ())
    if dt not in kinds or any(e.dtype != dt for e in flat):
        dt = torch.float64 if wide else torch.float32
    return [e.to(dt).contiguous() for e in flat], dt


def mxu_matmul_plain(a, b, *ep_operands, cfg: GemmConfig, transpose_a=False,
                     transpose_b=False, epilogue: Optional[Epilogue] = None):
    """Plain version of B1 and B2: ``torch.matmul`` (2-D, or batched with
    broadcasting) in the accumulator dtype, then the epilogue's torch
    function, then the cast.  bf16 / fp16 to the same type without an
    epilogue: ``torch.matmul`` as is (fp32 accumulation inside, one
    rounding).  Integer inputs are cast to int32 first, as the reference's
    ``astype`` does (uint32 wraps), and summed exactly modulo 2^32 like the
    reference's int32 sum (:func:`_int32_matmul`).  float64 is
    ``torch.matmul`` in float64."""
    _mnk(a, b, transpose_a, transpose_b)
    if a.is_cuda:
        mxu_matmul_plain.cuda_calls += 1
    a_l = a.transpose(-1, -2) if transpose_a else a
    b_l = b.transpose(-1, -2) if transpose_b else b
    acc = cfg.tacc_dtype
    if (epilogue is None and a.dtype in (torch.bfloat16, torch.float16)
            and cfg.tout_dtype == a.dtype):
        out = torch.matmul(a_l, b_l)
    elif acc.is_floating_point:
        out = torch.matmul(a_l.to(acc), b_l.to(acc))
    else:
        out = _int32_matmul(_as_int32(a_l), _as_int32(b_l)).to(acc)
    if epilogue is not None:
        out = epilogue.fn(out, *ep_operands)
    return out.to(cfg.tout_dtype)


def _launch(a, b, eps, bsz, m, n, k, cfg, ta, tb, epilogue, what, route=None,
            dmma_tile_=None):
    """Launch B1 / B2 on CUDA operands: :func:`mxu_route`'s kernel (the row
    softmax: :func:`row_softmax_route`'s), or ``route`` where a caller names
    one; returns (bsz, M, N).  A call named to the tile engine that the
    route rule does not give the engine (unaligned operands, int8 not
    K-major, a row softmax past its bounds) raises: the engine's TMA maps
    cannot describe it.  float64 runs :func:`dmma_tile`'s tile;
    ``dmma_tile_="cp_async"`` runs the cp.async tile on aligned operands
    too (a comparison in turns), and naming the TMA tile for operands it
    cannot describe raises."""
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.dtype != b.dtype:
        raise ValueError(f"dtype mismatch: {a.dtype} vs {b.dtype}")
    if a.dtype in _NO_PLUS_TIMES:
        raise TypeError(f"{what}: {dtype_name(a.dtype)} plus_times has no "
                        f"kernel: the int32 accumulator is narrower than the "
                        f"inputs (the reference refuses it too)")
    out_dtype = cfg.tout_dtype
    if a.dtype.is_floating_point and not out_dtype.is_floating_point:
        raise NotImplementedError(
            f"{dtype_name(a.dtype)} -> {dtype_name(out_dtype)} output cast")
    if min(m, n, k) < 1 or m > _MAX_M or max(n, k) > _INT_MAX:
        raise ValueError(f"{what} takes 1 <= M <= {_MAX_M} and "
                         f"1 <= N, K < 2^31, got ({m}, {n}, {k})")
    code = 0 if epilogue is None else kernel_code(epilogue)
    gen = code if isinstance(code, codegen.GeneratedEpilogue) else None
    if gen is not None:
        code = 0
    elif epilogue is not None and epilogue.n_operands != len(eps):
        raise ValueError(f"epilogue {epilogue.name!r} takes "
                         f"{epilogue.n_operands} operands, got {len(eps)}")
    if (code or gen) and not a.dtype.is_floating_point and any(
            e.dtype != torch.float32 for e in eps):
        # The kernel widens the int32 accumulator to fp32 for the epilogue:
        # the plain version's int32 + fp32 promotes the same way, while an
        # int32 or 16-bit operand would keep the sum in that type.
        raise ValueError(f"{what}: an epilogue on {dtype_name(a.dtype)} "
                         f"inputs takes float32 operands, got "
                         f"{[dtype_name(e.dtype) for e in eps]}")
    rows = epilogue is not None and epilogue.rows
    if rows and not row_softmax_fusable(a.dtype, n):
        raise ValueError(
            f"{what}: the row-softmax kernel takes bf16 / fp16 / fp32 rows of "
            f"at most {ROW_SOFTMAX_MAX_N} columns, got {dtype_name(a.dtype)} "
            f"N={n}; softmax the fp32 scores instead")
    a, b = _row_major(a), _row_major(b)
    (lda, sa), (ldb, sb) = _strides(a), _strides(b)
    vec_a, vec_b = _vec_ok(a), _vec_ok(b)
    aligned = bool(vec_a and vec_b)
    if rows:
        old = "simt" if a.dtype == torch.float32 else "wmma"
        if route not in (None, "wgmma", old):
            raise ValueError(f"{what}: the row softmax of {dtype_name(a.dtype)} "
                             f"runs on 'wgmma' or {old!r}, not {route!r}")
        rule = row_softmax_route(a.dtype, out_dtype, n, k, aligned)
    else:
        rule = mxu_route(a.dtype, ta, tb, aligned)
    route = named_route(route, rule, what)
    tile = None
    if route == "dmma":
        tile = dmma_tile(aligned)
        if dmma_tile_ not in (None, tile) and not (dmma_tile_ == "cp_async" and aligned):
            raise ValueError(f"{what}: the {dmma_tile_!r} float64 tile cannot take "
                             f"these operands (16-byte aligned: {aligned})")
        tile = dmma_tile_ or tile
    ops, ep_dt = _ep_operands(eps, n, a.device, wide=route == "dmma")
    fn = None
    if gen is not None:
        # The functor sees each operand in its own type where the kernel's
        # read of it is exact (f32 / bf16 / fp16; float64 on dmma), as the
        # plain version's promotion does; lowered, and any refusal raised,
        # before its library is looked up.
        kept = _EP_DTYPES + ((torch.float64,) if route == "dmma" else ())
        fn = codegen.epilogue_kernel(
            gen.fn, route, a.dtype, cfg.tacc_dtype,
            [e.dtype if e.dtype in kept else ep_dt for e in eps], ta, tb, gen.name,
            tile=tile)
    out = torch.empty((bsz, m, n), dtype=out_dtype, device=a.device)
    # The CUDA-core and float64 tiles store every type; the tensor-core
    # tiles (the engine, WMMA) and the row softmax the base five (ROADMAP B
    # coverage item 17).
    wide = not rows and route in ("simt", "dmma")
    codes = (_build.dtype_code(a.dtype, wide), _build.dtype_code(out_dtype, wide))
    lib = _build.library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, m, n, k,
                lda, ldb, sa, sb, int(ta), int(tb))
        # The registered epilogues read two operands, a generated one four.
        ptrs = [e.data_ptr() for e in ops] + [None] * (codegen.MAX_OPERANDS - len(ops))
        ep_args = (code, *ptrs[:2], _build.dtype_code(ep_dt, wide), stream)
        if fn is not None:
            rc = fn(*args, vec_a, vec_b, *codes, *ptrs, *ep_args[3:])
        elif rows and route == "wgmma":
            rc = lib.row_softmax_wgmma(*args, *codes, stream)
        elif rows:
            rc = lib.mxu_gemm_row_softmax(*args, vec_a, vec_b, *codes, stream)
        elif route == "wgmma":
            rc = lib.mxu_wgmma(*args, *codes, *ep_args)
        elif route == "dmma" and tile == "tma":
            rc = lib.dmma_tma_gemm(*args, *codes, *ep_args)
        elif route == "dmma":
            rc = lib.dmma_gemm(*args, vec_a, vec_b, *codes, *ep_args)
        else:
            rc = lib.mxu_gemm(*args, vec_a, vec_b, *codes, *ep_args)
    if rc and tile == "tma":
        what += (f" (float64 TMA tile: A {tuple(a.shape)} strides {a.stride()}, B "
                 f"{tuple(b.shape)} strides {b.stride()}, ta {ta}, tb {tb})")
    _build.check(rc, what)
    route_launches[route, dtype_name(a.dtype)] += 1
    if fn is not None:
        generated_launches[route, dtype_name(a.dtype)] += 1
    if tile is not None:
        dmma_tile_launches[tile] += 1
    if rows:
        mxu_matmul_batched.row_softmax_route = route
    else:
        entry = mxu_matmul if what == "kernel B1" else mxu_matmul_batched
        entry.last_route, entry.last_dmma_tile = route, tile
    return out


def mxu_matmul(a, b, *ep_operands, cfg: GemmConfig, transpose_a=False,
               transpose_b=False, epilogue: Optional[Epilogue] = None,
               route: Optional[str] = None, _dmma_tile: Optional[str] = None):
    """C (M, N) = epilogue(op(A) . op(B)) in ``cfg.out_dtype`` (kernel B1).

    a: (M, K), or (K, M) with ``transpose_a``; b: (K, N), or (N, K) with
    ``transpose_b``; ``ep_operands``: the epilogue's (N,) operands.  Shapes
    need not be tile-aligned: the kernel masks every edge itself.  The
    kernel is :func:`mxu_route`'s, recorded as ``mxu_matmul.last_route``;
    ``route`` names one (a tuned winner, a comparison).  float64 records
    its tile (:func:`dmma_tile`) as ``mxu_matmul.last_dmma_tile``.  A whole-row
    epilogue (the row softmax) cannot run on B1's tiles, which
    split rows; it runs on B2's row-softmax variant with a batch of one.
    """
    m, n, k = _dims(a, b, transpose_a, transpose_b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mxu_matmul_plain(a, b, *ep_operands, cfg=cfg,
                                transpose_a=transpose_a,
                                transpose_b=transpose_b, epilogue=epilogue)
    if epilogue is not None and epilogue.rows:
        return mxu_matmul_batched(a[None], b, *ep_operands, cfg=cfg,
                                  transpose_a=transpose_a,
                                  transpose_b=transpose_b,
                                  epilogue=epilogue, route=route)[0]
    out = _launch(a, b, ep_operands, 1, m, n, k, cfg, transpose_a,
                  transpose_b, epilogue, "kernel B1", route, _dmma_tile)[0]
    if epilogue is None:
        mxu_matmul.launches += 1
    else:
        mxu_matmul.epilogue_launches += 1
    return out


def mxu_matmul_batched(a, b, *ep_operands, cfg: GemmConfig, transpose_a=False,
                       transpose_b=False, epilogue: Optional[Epilogue] = None,
                       route: Optional[str] = None, _dmma_tile: Optional[str] = None):
    """C (B, M, N) = epilogue(op(A[z]) . op(B[z])) in ``cfg.out_dtype``
    (kernel B2).

    a: (B, M, K), or (B, K, M) with ``transpose_a``; b: (B, K, N), or
    (B, N, K) with ``transpose_b``.  One of them may be 2-D: it is read
    for every example, never copied per example.  A per-column epilogue
    runs at the store of the tile kernel, :func:`mxu_route`'s (recorded as
    ``mxu_matmul_batched.last_route``; ``route`` names another for a
    comparison); the row softmax runs on B2's row-softmax variant (rows of
    at most ``ROW_SOFTMAX_MAX_N``), :func:`row_softmax_route`'s kernel
    (recorded as ``mxu_matmul_batched.row_softmax_route``; ``route`` names
    the other for a comparison).
    """
    bsz, m, n, k = batched_dims(a, b, transpose_a, transpose_b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mxu_matmul_plain(a, b, *ep_operands, cfg=cfg,
                                transpose_a=transpose_a,
                                transpose_b=transpose_b, epilogue=epilogue)
    out = _launch(a, b, ep_operands, bsz, m, n, k, cfg, transpose_a,
                  transpose_b, epilogue, "kernel B2", route, _dmma_tile)
    if epilogue is not None and epilogue.rows:
        mxu_matmul_batched.row_softmax_launches += 1
    else:
        mxu_matmul_batched.launches += 1
    return out


# Kernel launches since the counts were last reset (plain calls not
# counted): B1 without / with a per-column epilogue; B2 plain or with a
# per-column epilogue; B2's row-softmax variant.  And the route of B1's, of
# B2's and of B2's row softmax's last launch, and the float64 tile of B1's
# and B2's last launch (None for the other types).
mxu_matmul.launches = 0
mxu_matmul.last_route = None
mxu_matmul.last_dmma_tile = None
mxu_matmul.epilogue_launches = 0
mxu_matmul_batched.launches = 0
mxu_matmul_batched.last_route = None
mxu_matmul_batched.last_dmma_tile = None
mxu_matmul_batched.row_softmax_launches = 0
mxu_matmul_batched.row_softmax_route = None
# Launches of B1 and B2 together (the row softmax's too) by (route, input
# dtype): the kernel source each reached, "dmma" csrc/dmma_gemm.cu and
# ("simt", "int16" / "uint8" / "uint16" / "uint32") csrc/mxu_simt_int.cu.
route_launches = collections.Counter()
# The same for the launches with a generated epilogue (a Python callable,
# ops/codegen.py: the route's tile in a library of its own).
generated_launches = collections.Counter()
# float64 launches of B1 and B2 by tile: "tma" csrc/dmma_tma.cu (or its
# generated epilogue's library), "cp_async" csrc/dmma_gemm.cu.
dmma_tile_launches = collections.Counter()
# Plain-version calls on CUDA tensors (the front door's backend="torch", or
# a comparison): a callable epilogue on the card never falls back to it.
mxu_matmul_plain.cuda_calls = 0
