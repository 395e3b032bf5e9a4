"""Quantized GEMMs: the wrappers of the Hopper kernels that replace TPU
kernels B13-B15, their plain PyTorch versions, and
:func:`quantize_activations`.

Counterpart of ``gemm_hls_tpu/ops/pallas_dequant.py``:

* :func:`dequant_matmul` (B13 ``_dequant_kernel``): y = x . dequant(w_q,
  s), int8 or planar int4 weights expanded in the kernel, on the route
  :func:`dequant_route` gives: ``csrc/dequant_wgmma.cu`` (the Hopper tile
  engine, one launch, no workspace) for aligned bf16 / fp16, else
  ``csrc/dequant_gemm.cu``.  Group-wise scales are folded into the
  weights in the compute type (one rounding of q * s, none for fp32
  inputs); per-channel scales multiply the fp32 accumulator at the store.
* :func:`w8a8_matmul`: with ``fuse_quant`` (B14 ``_w8a8_fused_kernel``)
  x is quantized per (row, K-block) by a pass of its own, then multiplied
  on the int8 tensor cores with both scales folded into each block's fp32
  contribution; otherwise (B15 ``_w8a8_kernel``) x is quantized per row
  (:func:`quantize_activations`) and the int32 sum runs over all of K
  when the scales are per-channel and ``127^2 K < 2^31`` (``int_acc``),
  else it is scaled per K-block.  The JAX routing rule between the two
  (``pallas_dequant.py:380-382``) is kept as it is: it decides the
  numerics (ROADMAP C2; :func:`w8a8_schedule`).  The GEMM runs on the
  route :func:`w8a8_route` gives: ``csrc/w8a8_wgmma.cu`` (the Hopper tile
  engine) for 16-byte rows and whole 128-deep scale blocks, else
  ``csrc/w8a8_gemm.cu`` (mma.sync), which also holds the quantize pass.
  Both fold the int32 block products in the same fp32 steps
  (``csrc/w8a8.cuh``): the same bits.

The quantization formulas differ by route, and each is copied: the fused
route takes r = 127 / ax and round(x r), a zero block getting scale 0; the
two-pass route takes sx = ax / 127 and round(x / sx), a zero row getting
scale 1.  Both round half to even.  The int8 values and int32 products
are then bit-identical to the JAX package's.

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
version, which repeats the kernel's arithmetic (int32 products exactly,
through float64 matmuls; fp32 scaling in the kernel's order).
"""

from __future__ import annotations

import ctypes

import torch

from gemm_hls_tpu_torch import _build
from gemm_hls_tpu_torch.config import GemmConfig, cdiv, named_route, round_up

# The JAX fused route's VMEM bound on the quantized (block_m, K) strip,
# kept as a routing rule (it decides the activation-scale grid).
_FUSED_STRIP_ELEMS = 8 * 1024 * 1024
_KERNEL_X_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
# B13's mma.sync K step, in elements: it splits K into chunks of whole steps.
KERNEL_K_STEP = 64


def _refuse_interpret(interpret, what):
    if interpret:
        raise NotImplementedError(
            f"{what}: CUDA has no interpreter mode; pass CPU tensors for the "
            f"plain version")


def _same_device(x, *ts):
    for t in ts:
        if t.device != x.device:
            raise ValueError(f"operands on {x.device} and {t.device}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the kernels read
    weights and scales in 4- to 16-byte vectors); a copy only if needed."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


# ---------------------------------------------------------------------------
# B13: weight-only dequant GEMM
# ---------------------------------------------------------------------------

def unpack_weights(w_q: torch.Tensor, bits: int, group: int) -> torch.Tensor:
    """int8 / planar int4 ``w_q`` as int8 values (K, N), sign-extended."""
    if bits == 8:
        return w_q
    kh, n = w_q.shape
    k = 2 * kh
    packed = w_q.reshape(k // group, group // 2, n)
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(packed, 4), 4)
    hi = torch.bitwise_right_shift(packed, 4)
    return torch.cat([lo, hi], dim=1).reshape(k, n)


def dequant_matmul_plain(x, w_q, scales, *, bits=8, group_size=None,
                         out_dtype=None):
    """Plain version of ``dequant_matmul``: the weights expanded as the
    kernel expands them (group-wise: (q * s) rounded to x's type;
    per-channel: q in x's type), an fp32 product, per-channel scales on
    the fp32 result."""
    k = x.shape[1]
    g = group_size or k
    q = unpack_weights(w_q, bits, g).float()
    if scales.shape[0] > 1:
        w = (q.reshape(k // g, g, -1) * scales[:, None, :]).reshape(k, -1)
        y = x.float() @ w.to(x.dtype).float()
    else:
        y = (x.float() @ q.to(x.dtype).float()) * scales[0]
    return y.to(out_dtype or x.dtype)


# B13 on the tile engine (csrc/dequant_wgmma.cu): K values a step (128 int8
# rows or 64 planar int4 rows of packed weights), the row tile, the N tiles
# the kernel is built for (widest first), and the most K splits of one tile
# (a portable cluster).
DEQUANT_ENGINE_STEP = 128
DEQUANT_ENGINE_BM = 64
DEQUANT_ENGINE_BN = (128, 64, 32)
DEQUANT_ENGINE_MAX_SPLITS = 8


def dequant_route(x_dtype, n: int, k: int, group: int, aligned: bool) -> str:
    """The kernel a B13 launch takes: ``"wgmma"`` (``csrc/dequant_wgmma.cu``,
    the Hopper tile engine) for bf16 / fp16 x whose rows and packed weight
    rows are whole 16-byte units (K % 8 == 0, N % 16 == 0) with 16-byte
    bases (``aligned``), and whose scale groups tile the engine's 128-deep
    K step (``group`` divides it, at least 16, or is a multiple of it;
    ``group`` is K for per-channel scales); ``"mma.sync"``
    (``dequant_tc``) for the other bf16 / fp16 calls, ``"simt"``
    (``dequant_simt``) for fp32.  Chosen by shape, never as a fallback."""
    if x_dtype == torch.float32:
        return "simt"
    step = DEQUANT_ENGINE_STEP
    tiles = (16 <= group and step % group == 0) or group % step == 0
    if aligned and k % 8 == 0 and n % 16 == 0 and tiles:
        return "wgmma"
    return "mma.sync"


def dequant_engine_plan(m: int, n: int, k: int, sms: int, clusters=None) -> tuple:
    """(N tile, K splits) of a B13 engine launch on a card of ``sms`` SMs
    that holds ``clusters(bn, splits)`` clusters of a plan at once (default
    ``sms // splits``): the widest N tile whose (64-row, N) tiles, split
    ``DEQUANT_ENGINE_MAX_SPLITS`` ways, still fill three quarters of the
    card (the narrowest built, 32, otherwise); then K split into whole
    128-deep steps, none empty, as far as tiles x splits reach the SM count
    and the tiles' clusters fit the card at once.  A split is a block of a
    thread block cluster: the cluster sums its partials in shared memory."""
    tiles_m = cdiv(m, DEQUANT_ENGINE_BM)
    cap = DEQUANT_ENGINE_MAX_SPLITS
    bn = next((b for b in DEQUANT_ENGINE_BN if cdiv(n, b) * tiles_m * cap * 4 >= sms * 3),
              DEQUANT_ENGINE_BN[-1])
    return bn, _engine_splits(m, n, k, bn, sms, clusters)


def dequant_engine_plans(m: int, n: int, k: int, sms: int, clusters=None) -> list:
    """The plans a tuner may name for a B13 engine launch: one a built N
    tile (widest first), each with :func:`dequant_engine_plan`'s K splits
    for that tile, so every one fits the card at once as the rule's does."""
    return [(bn, _engine_splits(m, n, k, bn, sms, clusters)) for bn in DEQUANT_ENGINE_BN]


def _engine_splits(m: int, n: int, k: int, bn: int, sms: int, clusters=None) -> int:
    """K splits of N tile ``bn`` (see :func:`dequant_engine_plan`)."""
    tiles = cdiv(n, bn) * cdiv(m, DEQUANT_ENGINE_BM)
    steps = cdiv(k, DEQUANT_ENGINE_STEP)
    fits = clusters or (lambda bn, splits: sms // splits)
    for want in range(min(steps, DEQUANT_ENGINE_MAX_SPLITS, cdiv(sms, tiles)), 1, -1):
        splits = cdiv(steps, cdiv(steps, want))
        if tiles <= fits(bn, splits):
            return splits
    return 1


def sm_count(device) -> int:
    """The SM count of ``device``, read once per device."""
    idx = _index(device)
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _engine_plan(device, m: int, n: int, k: int) -> tuple:
    """:func:`dequant_engine_plan` for ``device``, found once per shape."""
    key = (_index(device), m, n, k)
    if key not in _PLANS:
        _PLANS[key] = dequant_engine_plan(m, n, k, sm_count(device), engine_clusters(device))
    return _PLANS[key]


def engine_plans(device, m: int, n: int, k: int) -> list:
    """:func:`dequant_engine_plans` for ``device``, found once per shape."""
    key = (_index(device), m, n, k, "all")
    if key not in _PLANS:
        _PLANS[key] = dequant_engine_plans(m, n, k, sm_count(device), engine_clusters(device))
    return _PLANS[key]


def engine_clusters(device):
    """``clusters(bn, splits)`` of :func:`dequant_engine_plan` for
    ``device``: how many clusters of the plan the card holds at once
    (cudaOccupancyMaxActiveClusters), read once per device and plan."""
    idx = _index(device)

    def clusters(bn: int, splits: int) -> int:
        key = (idx, bn, splits)
        if key not in _CLUSTERS:
            got = ctypes.c_int(0)
            with torch.cuda.device(idx):
                rc = _build.library().dequant_wgmma_clusters(bn, splits, ctypes.byref(got))
            _build.check(rc, "dequant_wgmma_clusters")
            _CLUSTERS[key] = got.value
        return _CLUSTERS[key]
    return clusters


def _index(device) -> int:
    idx = torch.device(device).index
    return torch.cuda.current_device() if idx is None else idx


_SMS, _CLUSTERS, _PLANS = {}, {}, {}


def _dequant_splits(m: int, n: int, k: int, sms: int) -> int:
    """K splits of one B13 launch: enough (m, n) tiles x splits for two
    blocks on each of the card's ``sms`` SMs, each split a whole number of
    K steps (at most 16 splits)."""
    tiles = cdiv(m, 64) * cdiv(n, 64)
    steps = cdiv(k, KERNEL_K_STEP)
    if tiles >= 2 * sms:
        return 1
    per = cdiv(steps, min(steps, cdiv(2 * sms, tiles), 16))
    return cdiv(steps, per)


def dequant_matmul(x, w_q, scales, *, cfg: GemmConfig, bits: int = 8,
                   group_size=None, interpret=None, route=None, plan=None):
    """y[M, N] = x[M, K] . dequant(w_q, scales) (kernel B13).

    Args:
      x: (M, K) activations (bf16 / fp16 / fp32: the compute type).
      w_q: int8 weights from ``quantize_weights``: (K, N) for bits=8,
        (K//2, N) planar-packed for bits=4.
      scales: f32 (K/group_size, N); (1, N) for per-channel.
      cfg: its ``block_k`` is semantic (see ``ops/quant.py``); the output
        type is ``cfg.out_dtype``, else ``cfg.dtype`` (the JAX rule:
        ``matmul_quantized`` sets ``dtype`` to x's).

    The JAX wrapper's checks: K a multiple of block_k; group-wise scales
    need block_k a whole multiple of group_size; the packed row count.
    The kernel is :func:`dequant_route`'s, recorded as
    ``dequant_matmul.last_route``; ``route`` names one (a tuned winner, a
    comparison).  On the engine the plan (N tile, K splits) is
    :func:`dequant_engine_plan`'s, recorded as ``dequant_matmul.last_plan``;
    ``plan`` names one of :func:`dequant_engine_plans`'.  A route or plan
    named that cannot run the call raises.
    """
    m, k = x.shape
    n = w_q.shape[1]
    bk = min(cfg.block_k, k)
    if w_q.dtype != torch.int8:
        raise ValueError(f"w_q must be int8, got {w_q.dtype}")
    if k % bk:
        raise ValueError(f"K={k} must be a multiple of block_k={bk} "
                         "on the quantized path")
    n_groups = scales.shape[0]
    g = group_size or k
    if n_groups != k // g or scales.shape[1] != n:
        raise ValueError(f"scales shape {tuple(scales.shape)} inconsistent "
                         f"with K={k}, group_size={g}, N={n}")
    if n_groups > 1 and (g > bk or bk % g):
        raise ValueError(
            f"block_k {bk} must be a whole multiple of group_size {g} "
            "(scales cannot straddle K-blocks; matmul_quantized aligns "
            "this automatically)")
    packed_rows = k // 2 if bits == 4 else k
    if w_q.shape[0] != packed_rows:
        raise ValueError(f"w_q rows {w_q.shape[0]} != expected "
                         f"{packed_rows} for bits={bits}")
    out_dtype = cfg.tout_dtype
    if x.device.type == "cpu":
        return dequant_matmul_plain(x, w_q, scales, bits=bits,
                                    group_size=group_size, out_dtype=out_dtype)
    _same_device(x, w_q, scales)
    _refuse_interpret(interpret, "dequant_matmul")
    if x.dtype not in _KERNEL_X_DTYPES:
        raise NotImplementedError(
            f"dequant_matmul: no kernel takes x of {x.dtype} (bf16, fp16, fp32; "
            f"ROADMAP B coverage item 13)")
    x, w_q, scales = x.contiguous(), _aligned(w_q), _aligned(scales.float())
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    route = named_route(route, dequant_route(x.dtype, n, k, g, x.data_ptr() % 16 == 0),
                        "dequant_matmul")
    if plan is not None and (route != "wgmma" or tuple(plan) not in engine_plans(
            x.device, m, n, k)):
        raise ValueError(f"dequant_matmul: plan {plan} is not one of the engine's plans "
                         f"{engine_plans(x.device, m, n, k)} on route {route!r}")
    lib = _build.library()
    ptrs = (x.data_ptr(), w_q.data_ptr(), scales.data_ptr(), out.data_ptr())
    codes = (_build.dtype_code(x.dtype), _build.dtype_code(out_dtype))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "wgmma":
            bn, splits = tuple(plan) if plan is not None else _engine_plan(x.device, m, n, k)
            dequant_matmul.last_plan = (bn, splits)
            rc = lib.dequant_wgmma(*ptrs, m, n, k, bits, g, n_groups, bn, splits, *codes,
                                   stream)
        else:
            dequant_matmul.last_plan = None
            splits = _dequant_splits(m, n, k, sm_count(x.device))
            ws = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
                  if splits > 1 else None)
            rc = lib.dequant_gemm(
                *ptrs, None if ws is None else ws.data_ptr(), m, n, k, bits, g,
                n_groups, splits, *codes, int(x.data_ptr() % 16 == 0 and k % 8 == 0),
                stream)
    _build.check(rc, "dequant_matmul")
    dequant_matmul.launches += 1
    dequant_matmul.last_route = route
    return out


# ---------------------------------------------------------------------------
# B14 / B15: W8A8
# ---------------------------------------------------------------------------

# csrc/w8a8.cuh's modes.
W8A8_MODES = {"fused": 0, "int_acc": 1, "per_block": 2}
# The mma.sync tile (csrc/w8a8_gemm.cu) folds a scale block at the end of a
# 32-deep sub-step, so its scale blocks are whole sub-steps.
W8A8_FOLD_STEP = 32
# B14 / B15 on the tile engine (csrc/w8a8_wgmma.cu): K bytes a step, the row
# tile, the N tiles the kernel is built for (widest first).
W8A8_ENGINE_STEP = 128
W8A8_ENGINE_BM = 256
W8A8_ENGINE_BN = (128, 64)


def w8a8_schedule(m: int, n: int, k: int, cfg: GemmConfig, n_groups: int,
                  fuse_quant: bool) -> tuple:
    """(fused, mode, block_k) of a W8A8 call.  The JAX rule sends a fused
    request to the two-pass route when the (block_m, K) strip is over 8 Mi
    elements or K, block_k or the N tile is not a multiple of 128.  The
    mode is ``"fused"`` on B14; on B15 ``"int_acc"`` (one int32 sum over
    all of K) where the scales are per-channel and 127^2 K < 2^31, else
    ``"per_block"``."""
    bm = min(cfg.block_m, round_up(m, 32))
    bn, bk = min(cfg.block_n, n), min(cfg.block_k, k)
    if fuse_quant and (bm * k > _FUSED_STRIP_ELEMS or k % 128 or bk % 128
                       or bn % 128):
        fuse_quant = False
    if fuse_quant:
        return True, "fused", bk
    if n_groups == 1 and 16129 * k < 2 ** 31:
        return False, "int_acc", bk
    return False, "per_block", bk


def _scale_blocks(k: int, bk: int, mode: str) -> bool:
    """Whether a mode's scale blocks end inside K (an int32 partial folded
    into an fp32 sum at each block's end)."""
    return mode == "per_block" or (mode == "fused" and bk < k)


def w8a8_route(n: int, k: int, bk: int, mode: str, aligned: bool) -> str:
    """The kernel a B14 / B15 GEMM takes: ``"wgmma"`` (``csrc/w8a8_wgmma.cu``,
    the Hopper tile engine) where xq's and w_q's rows are whole 16-byte
    units (K % 16 == 0, N % 16 == 0) with 16-byte bases (``aligned``: x's
    and w_q's data pointers), and where scale blocks that end inside K
    are whole 128-deep engine steps (bk % 128 == 0); ``"mma.sync"``
    (``csrc/w8a8_gemm.cu``) for the rest.  Any M goes.  Chosen by shape,
    never as a fallback."""
    steps = not _scale_blocks(k, bk, mode) or bk % W8A8_ENGINE_STEP == 0
    if aligned and k % 16 == 0 and n % 16 == 0 and steps:
        return "wgmma"
    return "mma.sync"


def w8a8_engine_plans(k: int, bk: int, mode: str) -> tuple:
    """The N tiles a B14 / B15 engine launch may take: 64 alone where scale
    blocks end inside K (see :func:`w8a8_engine_plan`), else both."""
    return W8A8_ENGINE_BN[1:] if _scale_blocks(k, bk, mode) else W8A8_ENGINE_BN


def w8a8_engine_plan(m: int, n: int, k: int, bk: int, mode: str, sms: int) -> int:
    """The N tile of a B14 / B15 engine launch on a card of ``sms`` SMs:
    64 where scale blocks end inside K (the int32 partial and the fp32 sum
    take 32 + 32 registers a thread at 64); else 128 where the (256, 128)
    tiles fill a wave of the card (the prefill's q / o projection: 256
    tiles), else 64 (k / v, N 512: 128 tiles)."""
    wide, narrow = W8A8_ENGINE_BN
    if _scale_blocks(k, bk, mode):
        return narrow
    return wide if cdiv(m, W8A8_ENGINE_BM) * cdiv(n, wide) >= sms else narrow


def quantize_activations(x):
    """Per-row symmetric dynamic int8 quantization: (x_q, sx) with
    x ~ x_q . sx, sx (M, 1) f32; a zero row gets sx = 1.  On the card the
    quantize kernel of ``csrc/w8a8_gemm.cu``, else plain torch."""
    if x.device.type == "cpu":
        return _quantize_plain(x, x.shape[1], fused=False)
    xq, sx = _quantize_kernel(x, x.shape[1], fused=False)
    return xq, sx.reshape(-1, 1)


def _quantize_plain(x, bk: int, fused: bool):
    """(x_q int8 (M, K), scales): fused -> per (row, K-block) scales
    (n_kb, M), r = 127 / ax, zero block scale 0; otherwise per-row (M, 1),
    sx = ax / 127, zero row scale 1."""
    xf = x.float()
    if not fused:
        ax = xf.abs().amax(dim=1, keepdim=True)
        # Tensor / tensor: a true division on the card too (torch divides
        # a CUDA tensor by a Python scalar through its reciprocal).
        sx = torch.where(ax == 0, 1.0, ax / torch.full_like(ax, 127.0))
        return torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8), sx
    m, k = x.shape
    xb = xf.reshape(m, k // bk, bk)
    ax = xb.abs().amax(dim=2, keepdim=True)
    r = torch.where(ax == 0, 0.0, torch.full_like(ax, 127.0) / ax)
    xq = torch.clamp(torch.round(xb * r), -127, 127).to(torch.int8)
    sxb = ax * (1.0 / 127.0)
    return xq.reshape(m, k), sxb[..., 0].T.contiguous()


def _int_dot(a, b):
    """Exact int32 product of int8 matrices (a float64 matmul: every
    partial sum below 2^53)."""
    return (a.double() @ b.double()).to(torch.int32)


def w8a8_plain(x, w_q, scales, *, bk: int, fused: bool, out_dtype):
    """Plain version of ``w8a8_matmul`` on the route and block the wrapper
    chose: B14 (``fused``) or B15 (``int_acc`` when the scales are
    per-channel and 127^2 K < 2^31)."""
    m, k = x.shape
    n_groups = scales.shape[0]
    n_kb = k // bk
    xq, sx = _quantize_plain(x, bk, fused)
    acc = torch.zeros((m, w_q.shape[1]), dtype=torch.float32, device=x.device)
    if fused:
        for b in range(n_kb):
            sl = slice(b * bk, (b + 1) * bk)
            c = _int_dot(xq[:, sl], w_q[sl]).float() * sx[b][:, None]
            if n_groups > 1:
                c = c * scales[b]
            acc = acc + c
        if n_groups == 1:
            acc = acc * scales[0]
        return acc.to(out_dtype)
    if n_groups == 1 and 16129 * k < 2 ** 31:
        return ((_int_dot(xq, w_q).float() * scales[0]) * sx).to(out_dtype)
    for b in range(n_kb):
        sl = slice(b * bk, (b + 1) * bk)
        acc = acc + _int_dot(xq[:, sl], w_q[sl]).float() * scales[
            b if n_groups > 1 else 0]
    return (acc * sx).to(out_dtype)


def _quantize_kernel(x, bk: int, fused: bool):
    """The quantize kernel: (x_q (M, K) int8, scales (n_kb, M) f32)."""
    m, k = x.shape
    x = x.contiguous()
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((cdiv(k, bk), m), dtype=torch.float32, device=x.device)
    if m and k:
        lib = _build.library()
        with torch.cuda.device(x.device):
            rc = lib.w8a8_quantize(
                x.data_ptr(), xq.data_ptr(), sx.data_ptr(), m, k, bk,
                int(fused), _build.dtype_code(x.dtype),
                torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "w8a8 quantize")
    return xq, sx


def _w8a8_launch(xq, sx, w_q, scales, out, *, bk: int, mode: str, route: str,
                 bn=None):
    """The GEMM of ``w8a8_matmul`` on ``route`` into ``out``, over the
    quantize pass's int8 ``xq`` and scales ``sx``; on the engine, N tile
    ``bn`` (default :func:`w8a8_engine_plan`'s)."""
    m, k = xq.shape
    n = w_q.shape[1]
    w_q, scales = _aligned(w_q), _aligned(scales.float())
    args = (xq.data_ptr(), w_q.data_ptr(), scales.data_ptr(), sx.data_ptr(), out.data_ptr(),
            m, n, k, bk, scales.shape[0], W8A8_MODES[mode], _build.dtype_code(out.dtype))
    lib = _build.library()
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "wgmma":
            bn = bn or w8a8_engine_plan(m, n, k, bk, mode, sm_count(xq.device))
            w8a8_matmul.last_plan = bn
            rc = lib.w8a8_wgmma(*args, bn, stream)
        else:
            w8a8_matmul.last_plan = None
            rc = lib.w8a8_gemm(*args, int(k % 16 == 0), stream)
    _build.check(rc, f"w8a8_matmul ({route})")


def w8a8_matmul(x, w_q, scales, *, cfg: GemmConfig, group_size=None,
                interpret=None, fuse_quant: bool = True, route=None, plan=None):
    """y = (x quantized) . dequant(w_q, scales) on the int8 tensor cores.

    ``fuse_quant=True`` (default) quantizes x per (row, K-block of
    ``block_k``) and folds both scales into each block (kernel B14);
    ``fuse_quant=False`` runs the two-pass schedule (per-row
    :func:`quantize_activations`, kernel B15).  The JAX rule that sends a
    fused request to the two-pass route is kept (:func:`w8a8_schedule`).
    Output type ``cfg.out_dtype`` (default float32).  The GEMM's kernel is
    :func:`w8a8_route`'s, recorded as ``w8a8_matmul.last_route`` and
    counted in ``w8a8_matmul.routes``; ``route`` names one (a tuned winner,
    a comparison).  On the engine the N tile is :func:`w8a8_engine_plan`'s,
    recorded as ``w8a8_matmul.last_plan``; ``plan`` names one of
    :func:`w8a8_engine_plans`'.  A route or plan named that cannot run the
    call raises.
    """
    m, k = x.shape
    n = w_q.shape[1]
    bk = min(cfg.block_k, k)
    if w_q.dtype != torch.int8:
        raise ValueError(f"w_q must be int8, got {w_q.dtype}")
    if k % bk:
        raise ValueError(f"K={k} must be a multiple of block_k={bk}")
    n_groups = scales.shape[0]
    g = group_size or k
    if n_groups != k // g or scales.shape[1] != n:
        raise ValueError(f"scales shape {tuple(scales.shape)} inconsistent "
                         f"with K={k}, group_size={g}, N={n}")
    if n_groups > 1 and g != bk:
        raise ValueError(f"W8A8 group-wise scales need group_size == "
                         f"block_k ({g} != {bk}): int32 contributions "
                         "are per-block")
    fuse_quant, mode, bk = w8a8_schedule(m, n, k, cfg, n_groups, fuse_quant)
    out_dtype = cfg.tout_dtype if cfg.out_dtype is not None else torch.float32
    if x.device.type == "cpu":
        return w8a8_plain(x, w_q, scales.float(), bk=bk, fused=fuse_quant,
                          out_dtype=out_dtype)
    _same_device(x, w_q, scales)
    _refuse_interpret(interpret, "w8a8_matmul")
    if x.dtype not in _KERNEL_X_DTYPES:
        raise NotImplementedError(
            f"w8a8_matmul: no kernel takes x of {x.dtype} (bf16, fp16, fp32; "
            f"ROADMAP B coverage item 14)")
    if mode != "int_acc" and bk % W8A8_FOLD_STEP:
        raise NotImplementedError(
            f"w8a8_matmul: block_k {bk} is not a multiple of {W8A8_FOLD_STEP}, the "
            f"depth of an int8 tensor-core step, where its scales change")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    route = named_route(route, w8a8_route(n, k, bk, mode, x.data_ptr() % 16 == 0
                                          and w_q.data_ptr() % 16 == 0), "w8a8_matmul")
    if plan is not None and (route != "wgmma" or plan not in w8a8_engine_plans(k, bk, mode)):
        raise ValueError(f"w8a8_matmul: N tile {plan} is not one of the engine's "
                         f"{w8a8_engine_plans(k, bk, mode)} on route {route!r}")
    xq, sx = _quantize_kernel(x, bk if fuse_quant else k, fuse_quant)
    _w8a8_launch(xq, sx, w_q, scales, out, bk=bk, mode=mode, route=route, bn=plan)
    if fuse_quant:
        w8a8_matmul.fused_launches += 1
    else:
        w8a8_matmul.launches += 1
    w8a8_matmul.last_route = route
    w8a8_matmul.routes[route] = w8a8_matmul.routes.get(route, 0) + 1
    return out


# Kernel launches since the counts were last reset (plain calls not
# counted): B13; B14 (quantize + GEMM, counted once a call); B15; the
# W8A8 GEMMs by route.  The route of B13's and of W8A8's last launch.
dequant_matmul.launches = 0
dequant_matmul.last_route = None
dequant_matmul.last_plan = None
w8a8_matmul.fused_launches = 0
w8a8_matmul.launches = 0
w8a8_matmul.routes = {}
w8a8_matmul.last_route = None
w8a8_matmul.last_plan = None
