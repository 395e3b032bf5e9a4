"""Dense plus_times GEMM: the wrappers of kernels B1 and B2
(``csrc/mxu_wgmma.cu`` on the tile engine, in any layout and at any
alignment after the pack pass ``csrc/operand_pack.cu`` where its TMA maps
cannot read an operand in place, fp32 there as TF32 after the split pass
``csrc/tf32_split.cu``, int16 / uint8 / uint16 / uint32 / int32 as byte
planes on the int8 tensor cores, ``csrc/mxu_wgmma_int.cu``, after the
split pass ``csrc/int_split.cu`` or uint8's pack; ``csrc/mxu_gemm.cu``
where a caller names it,
float64 on
``csrc/dmma_tma.cu`` or ``csrc/dmma_gemm.cu``; B2's row softmax
``csrc/row_softmax_wgmma.cu`` on the engine, ``csrc/row_softmax.cu``) and
their plain PyTorch versions.

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
    ENGINE_INT_OUTPUTS, INT_PLANE_K, INT_PLANES, ROW_SOFTMAX_MAX_N, GemmConfig, call_route,
    dtype_name, named_route, packed_operands, round_up, row_softmax_fusable,
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


def mxu_route(dtype, out_dtype=None) -> str:
    """The kernel a B1 or B2 launch takes (one rule for both, 2-D and
    batched): ``"wgmma"`` (the Hopper tile engine, ``csrc/mxu_wgmma.cu``:
    TMA and warp-specialised wgmma, a batch walked as the engine's steps)
    for bf16, fp16 and int8 in every layout and at every alignment (an
    operand whose base, row pitch or batch stride is not a whole 16-byte
    unit, or an int8 operand that is not K-major, is first packed into a
    K-major workspace: :func:`pack_operand`, chosen by
    ``config.packed_operands``), and for fp32 in every layout and at every
    alignment (as TF32: :func:`tf32_operand` splits and turns each operand
    K-major first, and the engine runs :func:`tf32_passes` passes) into an
    fp32 / bf16 / fp16 ``out_dtype`` (None: the config's); ``"dmma"``
    (IEEE float64 on the FP64 tensor cores, any layout and alignment; its
    tile: :func:`dmma_tile`) for float64.  int16, uint8, uint16, uint32 and
    int32 take the engine too, in every layout and at every alignment, as
    products of byte planes on the int8 tensor cores (:func:`int_planes`:
    uint8 is its own plane, packed as int8 is; the others are split once
    an operand by :func:`int_split_operand`), their int32 sum wrapping as
    the reference's does, into any ``out_dtype`` but float64 and int64.
    ``"simt"`` (IEEE fp32, or an int32 accumulator that wraps, on the CUDA
    cores) takes fp32 into float64 and the integers into float64 / int64
    (the engine does not store them).  A caller may name ``"wmma"``
    (``csrc/mxu_gemm.cu``'s tensor-core tile) for bf16 / fp16 / int8 and
    ``"simt"`` for fp32 and these integers on any operands
    (``config.beside_engine``: a tuned winner, a comparison).
    B2's row softmax has kernels of its own (:func:`row_softmax_route`).
    Chosen by type, never as a fallback: a kernel that fails to build or
    launch raises.  The rule itself is ``config.call_route``'s."""
    return call_route(dtype, "plus_times", out_dtype)


# ---- B1 / B2's fp32 route on the engine: the TF32 split ------------------

def tf32_passes(precision: str) -> int:
    """TF32 passes of an fp32 launch on the engine: 1 for ``"default"`` (hi
    . hi, the reference's Precision.DEFAULT: about 2^-11 relative a
    product), 3 for ``"high"`` / ``"highest"`` (hi . hi + hi . lo + lo . hi
    in one fp32 accumulator, HIGHEST's fp32 accuracy: the dropped lo . lo
    is about 2^-22 of a product)."""
    return 1 if precision == "default" else 3


# The segment of a three-pass workspace row that holds lo: A [hi | hi | lo]
# against B [hi | lo | hi] along K gives hi.hi + hi.lo + lo.hi.  The hi
# facing the other operand's lo, segment 3 - lo, holds 0 for +-inf and NaN:
# only hi.hi carries them, so inf . 1.0 is inf, not inf + 1.0 . 0 . inf.
TF32_LO_SEG = {"a": 2, "b": 1}


def _tf32_bits(u):
    """TF32 bits of fp32 bits ``u`` (int64 holding the uint32): round to
    nearest even at bit 13, the low 13 bits cleared; a rounding that
    reaches the all-ones exponent cut toward zero instead (hi stays
    finite); +-inf kept, NaN kept quiet with its sign.  The integer
    operations of ``csrc/tf32_split.cu::tf32_bits``."""
    special = (u & 0x7F800000) == 0x7F800000
    r = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    r = torch.where((r & 0x7F800000) == 0x7F800000, u & 0xFFFFE000, r)
    nan = torch.where((u & 0x7FFFFF) != 0, (u | 0x400000) & 0xFFFFE000, u)
    return torch.where(special, nan, r)


def _bits(x):
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _from_bits(u):
    return (u - ((u >> 31) << 32)).to(torch.int32).view(torch.float32)


def tf32_split_plain(x):
    """(hi, lo) of fp32 ``x``, the split pass's plain version: hi = x
    rounded to TF32 (:func:`_tf32_bits`), lo = (x - hi) rounded the same
    way (x - hi is exact in fp32), 0 where x is +-inf or NaN.  |x - hi - lo|
    is at most 2^-22 |x|, or half TF32's subnormal spacing (2^-137) where
    x - hi is that small; on the card ``csrc/tf32_split.cu`` equals it bit
    for bit."""
    if x.dtype != torch.float32:
        raise TypeError(f"the TF32 split takes float32, got {x.dtype}")
    u = _bits(x)
    hi = _from_bits(_tf32_bits(u))
    lo = _from_bits(_tf32_bits(_bits(x - hi)))
    special = (u & 0x7F800000) == 0x7F800000
    return hi, torch.where(special, torch.zeros_like(lo), lo)


def _operand_layout(x, mn_major: bool):
    """(batch, rows, k) of an operand held (rows, k), or (k, rows) with
    ``mn_major``; batch 1 for a 2-D operand or a batch of one (the split
    and pack passes' view of it)."""
    rows, k = (x.shape[-1], x.shape[-2]) if mn_major else (x.shape[-2], x.shape[-1])
    return (x.shape[0] if x.ndim == 3 else 1), rows, k


# The types the split pass reads: fp32, and the 16-bit floats, each value
# of which widened to fp32 is its own TF32 value (hi the value, lo 0).
TF32_SOURCES = (torch.float32, torch.bfloat16, torch.float16)


def _tf32_check(x, passes, side):
    if x.dtype not in TF32_SOURCES:
        raise TypeError(f"the TF32 split takes float32, bfloat16 or float16, got {x.dtype}")
    if passes not in (1, 3) or side not in TF32_LO_SEG:
        raise ValueError(f"passes 1 or 3 and side 'a' or 'b', got {passes}, {side!r}")
    return TF32_LO_SEG[side] if passes == 3 else -1


def tf32_operand_plain(x, mn_major: bool, passes: int, side: str):
    """Plain version of :func:`tf32_operand`, on ``x``'s own device: the
    workspace built from :func:`tf32_split_plain`, the cross term's hi
    (``TF32_LO_SEG``) 0 where x is +-inf or NaN; a batch read with a
    stride of 0 (a broadcast, or a batch of one) 2-D.  A bfloat16 / float16
    ``x`` is split as its fp32 promotion (``x.float()``)."""
    lo_seg = _tf32_check(x, passes, side)
    once = x.ndim == 3 and _strides(_row_major(x))[1] == 0  # the kernel's reading
    x = x.float()
    k = _operand_layout(x, mn_major)[2]
    xr = x.transpose(-1, -2) if mn_major else x
    pad = round_up(k, 4) - k
    hi, lo = (torch.nn.functional.pad(p, (0, pad)) for p in tf32_split_plain(xr))
    cross = torch.where(torch.isfinite(hi), hi, torch.zeros_like(hi))
    out = torch.cat([lo if s == lo_seg else cross if lo_seg > 0 and s == 3 - lo_seg else hi
                     for s in range(passes)], dim=-1)
    return out[0] if once else out


def tf32_operand(x, mn_major: bool, passes: int, side: str):
    """The K-major TF32 workspace the engine reads for operand ``x`` on the
    card: fp32, or bfloat16 / float16 read as they are (2 bytes a value;
    the workspace is its fp32 promotion's bit for bit), held (rows, K), or
    (K, rows) with ``mn_major``; 2-D, or 3-D with the batch first, at any
    base, pitch and batch stride: (rows, passes * kp), or (batch, rows,
    passes * kp) for a batch of more than one, kp = K rounded up to 4
    values (16-byte rows), each row's segments one after another: hi alone
    for one pass; for three, ``side`` "a" [hi | hi | lo] or "b" [hi | lo |
    hi] (``TF32_LO_SEG``: the hi facing the other's lo 0 for +-inf and
    NaN); every value past K zero (a batch read with a stride of 0 is
    split once, 2-D).  Launches ``csrc/tf32_split.cu`` (counted in
    ``tf32_operand.launches``, and by source type in
    ``tf32_operand.source_launches``); only the card's fp32 route calls it,
    so a tensor off the card raises."""
    lo_seg = _tf32_check(x, passes, side)
    if not x.is_cuda:
        raise ValueError(f"the TF32 split pass runs on the card, got a tensor on {x.device}")
    bsz, rows, k = _operand_layout(x, mn_major)
    kp = round_up(k, 4)
    x = _row_major(x)
    ld, bs = _strides(x)  # bs 0: one example (a broadcast batch is split once)
    out = torch.empty(((bsz,) if bs else ()) + (rows, passes * kp), dtype=torch.float32,
                      device=x.device)
    lib = _build.library()
    entry = {torch.float32: lib.tf32_split, torch.bfloat16: lib.tf32_split_bf16,
             torch.float16: lib.tf32_split_f16}[x.dtype]
    with torch.cuda.device(x.device):
        rc = entry(x.data_ptr(), out.data_ptr(), bsz if bs else 1, rows, k, ld, bs,
                   int(mn_major), kp, passes, lo_seg, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "the TF32 split pass")
    tf32_operand.launches += 1
    tf32_operand.source_launches[dtype_name(x.dtype)] += 1
    return out


def tf32_matmul_plain(a, b, passes: int, transpose_a=False, transpose_b=False):
    """Plain version of the fp32 engine route, on the operands' device: the
    same passes in float64 over the split operands
    (:func:`tf32_operand_plain`'s workspaces), rounded once to fp32.  The
    kernel sums in fp32 in the tensor cores' order, so it is held to this
    at a tolerance, not bit for bit; on the CPU the port keeps IEEE fp32
    (:func:`mxu_matmul_plain`).  Either operand may be bfloat16 / float16
    (:data:`TF32_SOURCES`), split as it is."""
    wa = tf32_operand_plain(a, transpose_a, passes, "a").double()
    wb = tf32_operand_plain(b, not transpose_b, passes, "b").double()
    out = torch.matmul(wa, wb.transpose(-1, -2)).to(torch.float32)
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    return out.expand(*lead, *out.shape[-2:])


# ---- B1 / B2's integers on the engine: byte planes ------------------------

def _byte_planes(x):
    """x's byte planes, lowest first, as int64 tensors: each byte of its
    bit pattern unsigned, but int16's high byte signed (an unsigned one
    would be 2^16 off, which is not 0 modulo 2^32; a 32-bit operand's top
    byte may be read unsigned, 2^32 off).  sum_i plane_i 2^(8 i) is x
    itself for int16 and the unsigned types, x modulo 2^32 for int32."""
    planes = INT_PLANES[dtype_name(x.dtype)]
    u = x.to(torch.int64) & ((1 << (8 * x.element_size())) - 1)
    out = [(u >> (8 * i)) & 0xFF for i in range(planes)]
    if x.dtype == torch.int16:
        out[1] = out[1] - ((out[1] >> 7) << 8)
    return out


def int_diagonals(planes: int):
    """The engine's walk over byte-plane pairs: for each diagonal d = i + j
    <= 3, highest first, its pairs (i, j), i rising.  The int32 sum is C =
    ((P_3 2^8 + P_2) 2^8 + P_1) 2^8 + P_0 wrapping, P_d the diagonal's
    products (Horner: one accumulator, shifted 8 bits between diagonals)."""
    top = min(3, 2 * (planes - 1))
    return [(d, [(i, d - i) for i in range(max(0, d - planes + 1), min(d, planes - 1) + 1)])
            for d in range(top, -1, -1)]


def _int_kp(x, mn_major):
    """(batch, rows, K, kp, planes) of a split: kp = K rounded up to the
    engine's K step (``config.INT_PLANE_K``)."""
    # uint8 is one plane as it is: the pack pass takes it where the engine's
    # maps cannot read it.
    planes = INT_PLANES.get(dtype_name(x.dtype), 1)
    if planes == 1:
        raise TypeError(f"the byte-plane split takes int16, uint16, uint32 or int32, got "
                        f"{x.dtype}")
    bsz, rows, k = _operand_layout(x, mn_major)
    return bsz, rows, k, round_up(k, INT_PLANE_K), planes


def int_split_operand_plain(x, mn_major: bool):
    """Plain version of :func:`int_split_operand`, on ``x``'s own device:
    the bytes of x (or of its transpose, with ``mn_major``), plane i of a
    row at [i kp, i kp + K), zeros to kp, as uint8 (int16's high plane
    holds the signed byte's bits); a batch read with a stride of 0 (a
    broadcast, or a batch of one) 2-D."""
    _, _, k, kp, _ = _int_kp(x, mn_major)
    xr = x.transpose(-1, -2) if mn_major else x
    out = torch.cat([torch.nn.functional.pad(p & 0xFF, (0, kp - k)) for p in _byte_planes(xr)],
                    dim=-1).to(torch.uint8)
    if out.ndim == 3 and _strides(x)[1] == 0:
        out = out[0]
    return out.contiguous()


def int_split_operand(x, mn_major: bool):
    """The K-major byte planes the engine reads for int16 / uint16 / uint32 /
    int32 operand ``x`` on the card (held (rows, K), or (K, rows) with
    ``mn_major``; 2-D, or 3-D with the batch first; any base, row pitch and
    batch stride): uint8 (rows, planes * kp), or (batch, rows, planes * kp)
    for a batch read with a stride other than 0, plane i of a row at [i kp,
    (i + 1) kp), kp = K rounded up to ``config.INT_PLANE_K``, every byte
    past K zero (a broadcast batch is split once, 2-D).  Launches
    ``csrc/int_split.cu`` (counted by dtype in
    ``int_split_operand.launches``); only the card's engine route calls it,
    so a tensor off the card raises."""
    bsz, rows, k, kp, planes = _int_kp(x, mn_major)
    if not x.is_cuda:
        raise ValueError(f"the byte-plane split runs on the card, got a tensor on {x.device}")
    x = _row_major(x)
    ld, bs = _strides(x)  # bs 0: one example (a broadcast batch is split once)
    out = torch.empty(((bsz,) if bs else ()) + (rows, planes * kp), dtype=torch.uint8,
                      device=x.device)
    with torch.cuda.device(x.device):
        rc = _build.library().int_split(
            x.data_ptr(), out.data_ptr(), bsz if bs else 1, rows, k, ld, bs, int(mn_major), kp,
            x.element_size(), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "the byte-plane split pass")
    int_split_operand.launches[dtype_name(x.dtype)] += 1
    return out


def int_planes_matmul_plain(a, b, *ep_operands, cfg: GemmConfig, transpose_a=False,
                            transpose_b=False, epilogue: Optional[Epilogue] = None):
    """Plain version of the engine's integer route, on the operands' device:
    the int32 sum of every byte-plane pair's products (each exact in
    float64: |sum| < K 2^16), combined diagonal by diagonal, highest first,
    with 8-bit shifts that wrap modulo 2^32 (:func:`int_diagonals`); then
    the epilogue on the sum widened to fp32 and the cast, as
    :func:`mxu_matmul_plain`.  Equal to it, and to the reference, bit for
    bit."""
    _mnk(a, b, transpose_a, transpose_b)
    a_l = a.transpose(-1, -2) if transpose_a else a
    b_l = b.transpose(-1, -2) if transpose_b else b
    pa, pb = _byte_planes(a_l), _byte_planes(b_l)
    acc = None
    for _, pairs in int_diagonals(INT_PLANES[dtype_name(a.dtype)]):
        part = sum(torch.matmul(pa[i].double(), pb[j].double()) for i, j in pairs)
        part = part.to(torch.int64)
        acc = part if acc is None else (acc << 8) + part
        acc = acc & 0xFFFFFFFF
    out = (acc - ((acc >> 31) << 32)).to(torch.int32).to(cfg.tacc_dtype)
    if epilogue is not None:
        out = epilogue.fn(out, *ep_operands)
    return out.to(cfg.tout_dtype)


# ---- B1 / B2 on the engine at any layout and alignment: the pack pass ------

PACK_DTYPES = (torch.bfloat16, torch.float16, torch.int8, torch.uint8)


def _pack_kp(x, mn_major):
    """(batch, rows, K, kp) of a pack: kp = K rounded up to whole 16-byte
    units of ``x``'s type."""
    if x.dtype not in PACK_DTYPES:
        raise TypeError(f"the pack pass takes bfloat16, float16 or int8 (or uint8), got "
                        f"{x.dtype}")
    bsz, rows, k = _operand_layout(x, mn_major)
    return bsz, rows, k, round_up(k, 16 // x.element_size())


def pack_operand_plain(x, mn_major: bool):
    """Plain version of :func:`pack_operand`, on ``x``'s own device: x (or
    its transpose, with ``mn_major``) zero-padded along K to whole 16-byte
    units, contiguous; a batch read with a stride of 0 (a broadcast, or a
    batch of one) 2-D."""
    _, _, k, kp = _pack_kp(x, mn_major)
    xr = x.transpose(-1, -2) if mn_major else x
    out = torch.nn.functional.pad(xr, (0, kp - k))
    if out.ndim == 3 and _strides(x)[1] == 0:
        out = out[0]
    return out.contiguous()


def pack_operand(x, mn_major: bool):
    """The K-major workspace the engine reads for bf16 / fp16 / int8 / uint8 operand
    ``x`` on the card (held (rows, K), or (K, rows) with ``mn_major``; 2-D,
    or 3-D with the batch first; any base, row pitch and batch stride):
    (rows, kp), or (batch, rows, kp) for a batch read with a stride other
    than 0, kp = K rounded up to whole 16-byte units, every value past K
    zero (a broadcast batch is packed once, 2-D).  Launches
    ``csrc/operand_pack.cu`` (counted by dtype in
    ``pack_operand.launches``).  The workspace is the operand's size again
    (a call that cannot hold it raises torch's out-of-memory error); only
    the card's engine route calls it, so a tensor off the card raises."""
    bsz, rows, k, kp = _pack_kp(x, mn_major)
    if not x.is_cuda:
        raise ValueError(f"the pack pass runs on the card, got a tensor on {x.device}")
    x = _row_major(x)
    ld, bs = _strides(x)  # bs 0: one example (a broadcast batch is packed once)
    out = torch.empty(((bsz,) if bs else ()) + (rows, kp), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _build.library().operand_pack(
            x.data_ptr(), out.data_ptr(), bsz if bs else 1, rows, k, ld, bs, int(mn_major), kp,
            x.element_size(), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "the pack pass")
    pack_operand.launches[dtype_name(x.dtype)] += 1
    return out


def _packed(a, b, ta, tb, pack_a, pack_b, pack):
    """(a, b, ta, tb, K) with each operand flagged ``pack_a`` / ``pack_b``
    replaced by ``pack``'s K-major workspace, whose rows run to kp: the
    engine's maps end at K, so its zeros past K are never read."""
    k = a.shape[-2] if ta else a.shape[-1]
    if pack_a:
        a, ta = pack(a, ta), False
    if pack_b:
        b, tb = pack(b, not tb), True
    return a, b, ta, tb, k


def packed_matmul_plain(a, b, *ep_operands, cfg: GemmConfig, transpose_a=False,
                        transpose_b=False, epilogue: Optional[Epilogue] = None):
    """Plain version of the engine route on packed operands, on the
    operands' device: each operand ``config.packed_operands`` packs (from
    its dtype, layout and 16-byte alignment, :func:`_vec_ok`) replaced by
    :func:`pack_operand_plain`'s workspace, then :func:`mxu_matmul_plain`
    over K on the layouts the engine then reads."""
    pa, pb = packed_operands(a.dtype, transpose_a, transpose_b, _vec_ok(_row_major(a)),
                             _vec_ok(_row_major(b)))
    a, b, ta, tb, k = _packed(a, b, transpose_a, transpose_b, pa, pb, pack_operand_plain)
    a = a[..., :k] if pa else a
    b = b[..., :k] if pb else b
    return mxu_matmul_plain(a, b, *ep_operands, cfg=cfg, transpose_a=ta, transpose_b=tb,
                            epilogue=epilogue)


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
            and b.dtype == a.dtype and cfg.tout_dtype == a.dtype):
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
    one; returns (bsz, M, N).  On the engine, an operand its TMA maps
    cannot read in place (``config.packed_operands``: a base, row pitch or
    batch stride off 16 bytes, int8 / uint8 not K-major) is packed first
    (:func:`pack_operand`); fp32 is split (:func:`tf32_operand`), and so
    are int16, uint16, uint32 and int32, into byte planes
    (:func:`int_split_operand`).  A call
    named to the tile engine that the route rule does not give the engine
    (fp32 into float64, a row softmax past its bounds) raises.  float64
    runs :func:`dmma_tile`'s tile;
    ``dmma_tile_="cp_async"`` runs the cp.async tile on aligned operands
    too (a comparison in turns), and naming the TMA tile for operands it
    cannot describe raises."""
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError(f"operands on {a.device} and {b.device}")
    # Two different float types (an fp32 cotangent against a bf16 operand in
    # a backward, ops/matmul.py::_mxu_bwd) meet as fp32 on the engine's
    # TF32 route, the split pass reading each in its own type.
    dt = a.dtype if a.dtype == b.dtype else torch.float32
    if a.dtype != b.dtype and not {a.dtype, b.dtype} <= set(TF32_SOURCES):
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
    in_dtype = dt  # a split operand's workspace holds bytes
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
        rule = mxu_route(dt, out_dtype)
    route = named_route(route, rule, what, dt if not rows else None)
    if a.dtype != b.dtype and (rows or route != "wgmma"):
        raise ValueError(f"{what}: {a.dtype} against {b.dtype} runs on the engine's TF32 "
                         f"route only")
    # fp32 on the engine: TF32 passes on K-major workspaces (below).
    passes = tf32_passes(cfg.precision) if route == "wgmma" and dt == torch.float32 else None
    # bf16 / fp16 / int8 / uint8 on the engine: each operand its maps
    # cannot read in place is packed into a K-major workspace first (below).
    pack_a, pack_b = packed_operands(dt, ta, tb, vec_a, vec_b) \
        if route == "wgmma" and not rows else (False, False)
    # The integers but int8 on the engine: byte planes, each pair's
    # products on the int8 tensor cores (csrc/mxu_wgmma_int.cu); int16,
    # uint16, uint32 and int32 split into planes first (below).
    int_walk = route == "wgmma" and not rows and dtype_name(dt) in INT_PLANES
    planes = INT_PLANES[dtype_name(dt)] if int_walk else None
    engine_int = route == "wgmma" and not rows and not dt.is_floating_point
    if engine_int and dtype_name(out_dtype) not in ENGINE_INT_OUTPUTS:
        raise NotImplementedError(
            f"{what}: the tile engine stores no {dtype_name(out_dtype)} output of "
            f"{dtype_name(dt)} inputs (ROADMAP B coverage item 17)")
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
        split = passes or (planes and planes > 1)
        fn = codegen.epilogue_kernel(
            gen.fn, route, dt, cfg.tacc_dtype,
            [e.dtype if e.dtype in kept else ep_dt for e in eps],
            *((False, True) if split else (ta and not pack_a, tb or pack_b)), gen.name,
            tile=f"tf32x{passes}" if passes else f"planes{planes}" if planes else tile)
    if bsz == 0:  # no block is launched and nothing is written
        return torch.empty((0, m, n), dtype=out_dtype, device=a.device)
    if pack_a or pack_b:
        # Copied once into K-major workspaces (csrc/operand_pack.cu), read
        # over K (their zeros past it never reach a sum).
        a, b, ta, tb, k = _packed(a, b, ta, tb, pack_a, pack_b, pack_operand)
        (lda, sa), (ldb, sb) = _strides(a), _strides(b)
        vec_a = vec_b = 1
    if passes:
        # The fp32 route: each operand split once into a K-major TF32
        # workspace (csrc/tf32_split.cu), then the engine's K-major kernel
        # over the passes laid along K.
        a = tf32_operand(a, ta, passes, "a")
        b = tf32_operand(b, not tb, passes, "b")
        ta, tb, k = False, True, a.shape[-1]
        (lda, sa), (ldb, sb) = _strides(a), _strides(b)
    if planes and planes > 1:
        # int16 / uint16 / uint32 / int32: each operand split once into
        # K-major byte planes (csrc/int_split.cu), each plane's rows run to
        # kp, a whole number of the engine's K steps, zeros past K.
        a = int_split_operand(a, ta)
        b = int_split_operand(b, not tb)
        ta, tb, k = False, True, a.shape[-1] // planes
        (lda, sa), (ldb, sb) = _strides(a), _strides(b)
    out = torch.empty((bsz, m, n), dtype=out_dtype, device=a.device)
    # The CUDA-core and float64 tiles store every type; the engine the base
    # five, and for integer inputs int16 and the unsigned ints too; WMMA and
    # the row softmax the base five (ROADMAP B coverage item 17).
    wide = not rows and (route in ("simt", "dmma") or engine_int)
    codes = (_build.dtype_code(in_dtype, wide), _build.dtype_code(out_dtype, wide))
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
        elif passes:
            rc = lib.mxu_wgmma_tf32(*args[:11], passes, codes[1], *ep_args)
        elif int_walk:
            rc = lib.mxu_wgmma_int(*args[:11], *codes, *ep_args)
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
    name = dtype_name(in_dtype)
    route_launches[route, name] += 1
    if fn is not None:
        generated_launches[route, name] += 1
    if tile is not None:
        dmma_tile_launches[tile] += 1
    if passes is not None:
        tf32_launches[passes] += 1
    if planes is not None:
        int_plane_launches[name] += 1
    if pack_a or pack_b:
        packed_launches[name] += 1
    if rows:
        mxu_matmul_batched.row_softmax_route = route
    else:
        entry = mxu_matmul if what == "kernel B1" else mxu_matmul_batched
        entry.last_route, entry.last_dmma_tile = route, tile
        entry.last_tf32_passes, entry.last_int_planes = passes, planes
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
# B2's and of B2's row softmax's last launch, the float64 tile of B1's and
# B2's last launch, and the TF32 passes of their last fp32 engine launch
# (None for the other types and routes), and the byte planes of their last
# integer engine launch (1 uint8, 2 int16 / uint16, 4 uint32 / int32).
mxu_matmul.launches = 0
mxu_matmul.last_route = None
mxu_matmul.last_dmma_tile = None
mxu_matmul.last_tf32_passes = None
mxu_matmul.last_int_planes = None
mxu_matmul.epilogue_launches = 0
mxu_matmul_batched.launches = 0
mxu_matmul_batched.last_route = None
mxu_matmul_batched.last_dmma_tile = None
mxu_matmul_batched.last_tf32_passes = None
mxu_matmul_batched.last_int_planes = None
mxu_matmul_batched.row_softmax_launches = 0
mxu_matmul_batched.row_softmax_route = None
# Launches of B1 and B2 together (the row softmax's too) by (route, input
# dtype): the kernel source each reached, "dmma" csrc/dmma_gemm.cu,
# ("wgmma", "int16" / "uint8" / "uint16" / "uint32" / "int32")
# csrc/mxu_wgmma_int.cu and ("simt", the same types) csrc/mxu_simt_int.cu
# (int32: csrc/mxu_gemm.cu).
route_launches = collections.Counter()
# The same for the launches with a generated epilogue (a Python callable,
# ops/codegen.py: the route's tile in a library of its own).
generated_launches = collections.Counter()
# float64 launches of B1 and B2 by tile: "tma" csrc/dmma_tma.cu (or its
# generated epilogue's library), "cp_async" csrc/dmma_gemm.cu.
dmma_tile_launches = collections.Counter()
# fp32 launches of B1 and B2 on the engine by TF32 passes (1: "default",
# 3: "high" / "highest"), and the split pass's launches (two a GEMM), all
# and by source type ("float32", or a 16-bit operand read as it is).
tf32_launches = collections.Counter()
tf32_operand.launches = 0
tf32_operand.source_launches = collections.Counter()
# B1 / B2 engine launches with at least one packed operand, and the pack
# pass's launches (one a packed operand), each by input dtype.
packed_launches = collections.Counter()
pack_operand.launches = collections.Counter()
# Integer engine launches of B1 and B2 on byte planes by input dtype, and
# the split pass's launches (one an operand of int16 / uint16 / uint32 /
# int32) by dtype.
int_plane_launches = collections.Counter()
int_split_operand.launches = collections.Counter()
# Plain-version calls on CUDA tensors (the front door's backend="torch", or
# a comparison): a callable epilogue on the card never falls back to it.
mxu_matmul_plain.cuda_calls = 0
