"""Integer-slice GEMMs: the wrappers of kernels B4 and B5
(``csrc/int8_slices.cu``) and their plain PyTorch versions.

Counterpart of ``gemm_hls_tpu/ops/pallas_ozaki.py`` (as ``ops/mxu.py`` is
of ``pallas_mxu.py``).  Both compute the slice triangle of n int8 slices per
operand: diagonal d is the exact int32 sum P_d = sum_{i+j=d} sa_i . sb_j.

* :func:`fused_int8_fp32` (B4): P_d over all of K, combined as
  sum_d P_d * 2^(-7d) in fp32 (d ascending), times the row / column ulps
  when given; :func:`diag_route` sends it to the Hopper tile engine
  (``csrc/diag_wgmma.cu``) or to the ``mma.sync`` kernel by shape.
* :func:`fused_ozaki_int8` (B5): P_d per K block of ``block_k``, split into
  fp32-exact halves and TwoSum-flushed into (hi, lo).

A CUDA tensor launches the kernel or raises; CPU tensors run the plain
version, which computes each slice pair with float64 ``torch.matmul``
(exact: every sum is below 2^31 < 2^53), casts the diagonal to int32 and
combines in the kernel's order.  Unlike the TPU entries, whole unpadded
operands are taken (the kernel masks the M, N and K edges itself); the
TPU's ``block_m`` / ``block_n`` are VMEM tile choices, accepted and checked
for the signature's sake while the card runs its compiled tile
(``config.SLICE_TILES``).  B5's ``block_k`` is the flush period and a
multiple of the kernel's 64-deep K step; :func:`ozaki_route` sends it to
the Hopper tile engine or to the ``mma.sync`` kernel by shape.  The
kernels read B's slices K-contiguous, as B_j^T: transposed views of (N, K)
storage cost nothing, a row-major (K, N) slice one int8 transposed copy.
"""

from __future__ import annotations

import ctypes

import torch

from gemm_hls_tpu_torch import _build
from gemm_hls_tpu_torch.config import OZAKI_ENGINE_TILE, SLICE_TILES, slice_route
from gemm_hls_tpu_torch.ops.mxu import _INT_MAX

# Magnitude bits per int8 slice: x ~= ulp * sum_i s_i * 2^(-7 i).
SLICE_BITS = 7

_INT32_BOUND = 1 << 31
_K_STEP = 64  # the kernel's K step: B5 flushes on multiples of it
_MAX_DIAGS = max(SLICE_TILES)
# The tile engine's K slab for int8 (csrc/int8_slices.cu: kOzBK): B5 on the
# engine flushes on multiples of it.
OZ_ENGINE_SLAB = OZAKI_ENGINE_TILE[2]


def ozaki_route(lda: int, ldb: int, block_k: int, aligned: bool) -> str:
    """The kernel a B5 launch takes: ``"wgmma"`` (the Hopper tile engine,
    ``ozaki_wg_kernel``: TMA and warp-specialised wgmma, diagonal-major)
    where every slice row is a whole number of 16-byte units (the row
    pitches ``lda`` of A_i and ``ldb`` of B_j^T, in int8 elements, and the
    bases ``aligned``: what a TMA map describes) and ``block_k`` is a
    multiple of the engine's 128-deep slab, so that no slab straddles a
    flush; ``"mma.sync"`` (``slice_gemm_kernel``) otherwise.  Chosen by
    shape, never as a fallback: a kernel that fails to build or launch
    raises."""
    if aligned and lda % 16 == 0 and ldb % 16 == 0 and block_k % OZ_ENGINE_SLAB == 0:
        return "wgmma"
    return "mma.sync"


# B4 on the Hopper tile engine (csrc/diag_wgmma.cu): the most diagonals it
# keeps in registers (4, on a 128 x 64 tile; up to 3 on 128 x 128).
DIAG_ENGINE_MAX_DIAGS = 4


def diag_route(n_diags: int, lda: int, ldb: int, aligned: bool) -> str:
    """The kernel a B4 launch takes: ``"wgmma"`` (the Hopper tile engine,
    ``diag_wg_kernel``: every used slice's A and B^T slab of a K step
    landed once by TMA, every diagonal's int32 accumulator in registers)
    for at most ``DIAG_ENGINE_MAX_DIAGS`` diagonals where every slice row is
    a whole number of 16-byte units (the row pitches ``lda`` of A_i and
    ``ldb`` of B_j^T, in int8 elements, and the bases ``aligned``: what a
    TMA map describes); ``"mma.sync"`` (``slice_gemm_kernel``) otherwise.
    Chosen by shape, never as a fallback."""
    if (n_diags <= DIAG_ENGINE_MAX_DIAGS and aligned and lda % 16 == 0
            and ldb % 16 == 0):
        return "wgmma"
    return "mma.sync"


def _split_operands(sa, sb):
    """(n_slices, M, N, K, [sa_i], [sb_j]) of the stacked (n, M, K) /
    (n, K, N) form or the split form (tuples of n (M, K) / (K, N))."""
    split = isinstance(sa, (tuple, list))
    if split != isinstance(sb, (tuple, list)):
        raise ValueError("sa and sb must both be stacked or both be tuples")
    if split:
        n_slices, (m, k) = len(sa), tuple(sa[0].shape)
        n = sb[0].shape[1]
        if (len(sb) != n_slices or any(tuple(s.shape) != (m, k) for s in sa)
                or any(tuple(s.shape) != (k, n) for s in sb)):
            raise ValueError("per-slice operand shapes disagree")
        sa, sb = list(sa), list(sb)
    else:
        n_slices, m, k = sa.shape
        n = sb.shape[2]
        if tuple(sb.shape[:2]) != (n_slices, k):
            raise ValueError(f"stacked operands disagree: {tuple(sa.shape)} x "
                             f"{tuple(sb.shape)}")
        sa, sb = list(sa.unbind(0)), list(sb.unbind(0))
    if any(s.dtype != torch.int8 for s in sa + sb):
        raise ValueError("slices must be int8")
    return n_slices, m, n, k, sa, sb


def _check_blocks(**blocks):
    for name, v in blocks.items():
        if not (isinstance(v, int) and v > 0):
            raise ValueError(f"{name} must be a positive int, got {v!r}")


def _on_cpu(xs) -> bool:
    return all(x.device.type == "cpu" for x in xs)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _diagonal(sa, sb, d, n_slices, k0=0, k1=None):
    """Exact int32 P_d over K in [k0, k1), or None if no pair lies on d."""
    p = None
    for i in range(d + 1):
        j = d - i
        if i >= n_slices or j >= n_slices:
            continue
        prod = torch.matmul(sa[i][:, k0:k1].to(torch.float64),
                            sb[j][k0:k1].to(torch.float64))
        p = prod if p is None else p + prod
    return None if p is None else p.to(torch.int32)


def _two_sum(a, b):
    """Knuth TwoSum: s + err == a + b exactly."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def fused_int8_fp32_plain(sa, sb, ulp_a=None, ulp_b=None, *, n_diags=None):
    """Plain version of B4 on lists of per-slice tensors."""
    n_slices = len(sa)
    n_diags = n_slices if n_diags is None else n_diags
    out = _diagonal(sa, sb, 0, n_slices).to(torch.float32)
    for d in range(1, n_diags):
        p = _diagonal(sa, sb, d, n_slices)
        if p is not None:
            out = out + p.to(torch.float32) * (2.0 ** (-SLICE_BITS * d))
    if ulp_a is not None:
        out = out * ulp_a * ulp_b
    return out


def fused_ozaki_int8_plain(sa, sb, *, block_k, n_diags):
    """Plain version of B5 on lists of per-slice tensors: the same K blocks
    and the same flush order as the kernel."""
    n_slices = len(sa)
    m, k = sa[0].shape
    n = sb[0].shape[1]
    hi = torch.zeros((m, n), dtype=torch.float32, device=sa[0].device)
    lo = torch.zeros_like(hi)
    for k0 in range(0, k, block_k):
        for d in range(n_diags):
            p = _diagonal(sa, sb, d, n_slices, k0, k0 + block_k)
            if p is None:
                continue
            w = 2.0 ** (-SLICE_BITS * d)
            p_hi = (p >> 12).to(torch.float32) * 4096.0 * w
            p_lo = (p & 4095).to(torch.float32) * w
            hi, err = _two_sum(hi, p_hi)
            lo = lo + err
            hi, err = _two_sum(hi, p_lo)
            lo = lo + err
    return hi, lo


# ---------------------------------------------------------------------------
# Kernel launch
# ---------------------------------------------------------------------------

def _k_rows(slices, what):
    """K-contiguous row views sharing one row pitch (a copy only where
    needed): A slices as given ((M, K)); B slices as B_j^T ((N, K)), since
    both int8 MMA operands are K-major, so a row-major (K, N) slice is
    transposed once and a transposed view passes through as it is."""
    slices = [s if s.stride(-1) == 1 or s.shape[-1] == 1 else s.contiguous()
              for s in slices]
    if len({s.stride(0) for s in slices}) > 1:
        slices = [s.contiguous() for s in slices]
    dev = slices[0].device
    if not all(s.is_cuda and s.device == dev for s in slices):
        raise ValueError(f"{what}: slices on {[str(s.device) for s in slices]}")
    return slices, slices[0].stride(0)


def _launch(sa, sb, m, n, k, n_diags, outs, ulps, flush_steps, what, route=None):
    n_used = min(len(sa), n_diags)
    if n_diags > _MAX_DIAGS:
        raise NotImplementedError(
            f"{what} is built for at most {_MAX_DIAGS} diagonals, got "
            f"{n_diags}")
    bm, bn, _ = SLICE_TILES[slice_route(n_diags, flush=flush_steps > 0)]
    if (min(m, n, k) < 1 or max(m, n, k) > _INT_MAX
            or -(-m // bm) * -(-n // bn) > _INT_MAX):
        raise ValueError(f"{what} takes 1 <= M, N, K < 2^31 and fewer than "
                         f"2^31 blocks, got ({m}, {n}, {k})")
    sa, lda = _k_rows(sa[:n_used], what)
    sbt, ldb = _k_rows([s.T for s in sb[:n_used]], what)
    if sa[0].device != sbt[0].device:
        raise ValueError(f"{what}: operands on {sa[0].device} and "
                         f"{sbt[0].device}")
    aligned = all(s.data_ptr() % 16 == 0 for s in sa + sbt)
    vec = int(lda % 16 == 0 and ldb % 16 == 0 and aligned)
    route = route or (ozaki_route(lda, ldb, flush_steps * _K_STEP, aligned)
                      if flush_steps else diag_route(n_diags, lda, ldb, aligned))
    pa = (ctypes.c_void_p * n_used)(*(s.data_ptr() for s in sa))
    pb = (ctypes.c_void_p * n_used)(*(s.data_ptr() for s in sbt))
    c, c2 = (outs + [None])[:2]
    ua, ub = ulps if ulps is not None else (None, None)
    ua, ub = (None if u is None else u.data_ptr() for u in (ua, ub))
    lib = _build.library()
    with torch.cuda.device(sa[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "wgmma" and not flush_steps:
            rc = lib.slice_diag_wgmma(pa, pb, n_used, c.data_ptr(), ua, ub, m, n,
                                      k, lda, ldb, n_diags, stream)
        else:
            rc = lib.slice_gemm(
                pa, pb, n_used, c.data_ptr(), None if c2 is None else c2.data_ptr(),
                ua, ub, m, n, k, lda, ldb, n_diags, flush_steps, vec,
                int(route == "wgmma"), stream)
    _build.check(rc, what)
    return route


def _ulp_vector(u, length, device):
    if u.device != device:
        raise ValueError(f"ulps on {u.device}, slices on {device}")
    return u.reshape(length).to(torch.float32).contiguous()


# ---------------------------------------------------------------------------
# Public entries
# ---------------------------------------------------------------------------

def fused_int8_fp32(sa, sb, ulp_a=None, ulp_b=None, *, block_m: int = 512,
                    block_n: int = 1024, block_k: int = 4096,
                    n_diags: int = None, route=None):
    """fp32-class slice-triangle GEMM (kernel B4): (n, M, K) int8 x
    (n, K, N) int8 -> (M, N) float32.

    ``sa`` / ``sb`` are each a stacked tensor or a tuple of n per-slice
    (M, K) / (K, N) tensors (the kernel reads each slice through its own
    pointer, so the tuple form costs no stacked copy).  With ``ulp_a``
    (M, 1) and ``ulp_b`` (1, N) (both or neither) the ulp rescale is fused
    into the store; otherwise the result is unscaled.  Requires
    ``n_slices * 127^2 * K < 2^31`` (K <= 44380 for 3 slices); beyond it,
    use :func:`fused_ozaki_int8`.  The kernel is :func:`diag_route`'s,
    recorded as ``fused_int8_fp32.last_route``; ``route`` names one for
    comparisons.
    """
    n_slices, m, n, k, sa_l, sb_l = _split_operands(sa, sb)
    if n_diags is None:
        n_diags = n_slices
    scaled = ulp_a is not None
    if scaled != (ulp_b is not None):
        raise ValueError("pass both ulp_a and ulp_b, or neither")
    if scaled and (tuple(ulp_a.shape) != (m, 1)
                   or tuple(ulp_b.shape) != (1, n)):
        raise ValueError(f"ulp shapes must be ({m},1) and (1,{n}), got "
                         f"{tuple(ulp_a.shape)} and {tuple(ulp_b.shape)}")
    _check_blocks(block_m=block_m, block_n=block_n, block_k=block_k,
                  n_diags=n_diags)
    if n_slices * (127 ** 2) * k >= _INT32_BOUND:
        raise ValueError(
            f"K={k} exceeds the whole-K int32 exactness bound for "
            f"{n_slices} slices; use fused_ozaki_int8 instead")
    if _on_cpu(sa_l + sb_l):
        return fused_int8_fp32_plain(sa_l, sb_l, ulp_a, ulp_b,
                                     n_diags=n_diags)
    dev = sa_l[0].device
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    ulps = ((_ulp_vector(ulp_a, m, dev), _ulp_vector(ulp_b, n, dev))
            if scaled else None)
    fused_int8_fp32.last_route = _launch(sa_l, sb_l, m, n, k, n_diags, [out],
                                         ulps, 0, "kernel B4", route)
    fused_int8_fp32.launches += 1
    return out


def fused_ozaki_int8(sa, sb, *, block_m: int = 128, block_n: int = 512,
                     block_k: int = 2048, n_diags: int = None):
    """All-slices GEMM (kernel B5): (n, M, K) int8 x (n, K, N) int8 ->
    (hi, lo) float32, with C ~= hi + lo.

    ``n_diags`` truncates the slice triangle: diagonals d = i + j with
    d < n_diags are computed (default ``n_slices + 1``).  Each diagonal is
    summed exactly per K block of ``block_k`` (bounded by
    ``n_slices * 127^2 * block_k < 2^31``) and flushed error-free into the
    (hi, lo) accumulators, so K is unbounded.  The kernel is
    :func:`ozaki_route`'s, recorded as ``fused_ozaki_int8.last_route``.
    """
    n_slices, m, n, k, sa_l, sb_l = _split_operands(sa, sb)
    if n_diags is None:
        n_diags = n_slices + 1
    _check_blocks(block_m=block_m, block_n=block_n, block_k=block_k,
                  n_diags=n_diags)
    if n_slices * (127 ** 2) * block_k >= _INT32_BOUND:
        raise ValueError(f"block_k={block_k} too large for exact int32 "
                         f"diagonal accumulation with {n_slices} slices")
    if block_k % _K_STEP:
        raise ValueError(f"block_k={block_k} is not a multiple of the "
                         f"kernel's K step {_K_STEP}")
    if _on_cpu(sa_l + sb_l):
        return fused_ozaki_int8_plain(sa_l, sb_l, block_k=block_k,
                                      n_diags=n_diags)
    dev = sa_l[0].device
    hi = torch.empty((m, n), dtype=torch.float32, device=dev)
    lo = torch.empty_like(hi)
    fused_ozaki_int8.last_route = _launch(
        sa_l, sb_l, m, n, k, n_diags, [hi, lo], None, block_k // _K_STEP,
        "kernel B5")
    fused_ozaki_int8.launches += 1
    return hi, lo


# Kernel launches since the counts were last reset (plain calls not
# counted), and the route of each kernel's last launch.
fused_int8_fp32.launches = 0
fused_int8_fp32.last_route = None
fused_ozaki_int8.launches = 0
fused_ozaki_int8.last_route = None
