"""Flash attention: the wrappers of the Hopper kernels that replace TPU
kernels B6-B12, their plain PyTorch versions, and the differentiable
front ``flash_mha_diff``.

Counterpart of ``gemm_hls_tpu/ops/pallas_flash.py``:

* :func:`flash_mha` -> ``csrc/flash_wgmma.cu`` or ``csrc/flash_fwd.cu``
  by shape (:func:`flash_route`; B6 ``_flash_kernel``, B7
  ``_flash_kernel_tri``, B8 ``_flash_kernel_onepass``): o = softmax(scale
  q k^T) v per head, optional lse;
* :func:`flash_mha_bwd_dq` -> ``csrc/flash_bwd_wgmma.cu`` or
  ``csrc/flash_bwd_dq.cu`` by shape (:func:`flash_bwd_route`; B9, B11);
* :func:`flash_mha_bwd_dkv` -> ``csrc/flash_bwd_wgmma.cu`` or
  ``csrc/flash_bwd_dkv.cu`` (B10, B12); dk and dv come back per kv head
  (the kernel sums a GQA group's q heads itself; the TPU kernel returned
  per-q-head tiles that its caller folded);
* :func:`flash_mha_diff`, a ``torch.autograd.Function`` whose backward is
  the two kernels above, Delta = sum_d dO * O taken in fp32.

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
version.  The plain versions compute the JAX kernels' function with their
conventions: a masked score is the finite ``_MASK``; a masked probability
is exactly 0, so a row that every position masks (segment ids, offsets)
gives o = 0 and lse = -inf; v rows past a kv length are zeroed before
p v; with ``kv_lengths`` and ``causal`` the queries are anchored at the
cache end; the probabilities (and ds) are rounded to the input type before
their second product, as the kernels do; ``ds`` carries the soft cap's
tanh derivative.  They walk the queries in tiles of ``block_q`` rows (the
TPU kernels' q tiles), so the score matrix held at once is (heads,
block_q, S_kv).

Layouts: every tensor is (B, S, D) or (batch, S, H, D) (B = batch * H);
the kernels read both in place through strides, so the 4-D layout and the
padded-cache decode path never transpose a cache.  kv head ``b // group``
serves q head ``b`` (GQA), never a broadcast copy.
"""

from __future__ import annotations

import ctypes

import torch

from gemm_hls_tpu_torch import _build
from gemm_hls_tpu_torch.config import named_route

# Large finite "minus infinity" for masked scores (pallas_flash.py:47).
_MASK = -0.7 * float(torch.finfo(torch.float32).max)

# Largest head dim the kernels are compiled for (csrc/flash_*.cu: DMAX 64
# and 128; a smaller D is zero-filled at load).
MAX_KERNEL_D = 128
_KERNEL_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
# What the wgmma routes take (csrc/flash_wgmma.cu, csrc/flash_bwd_wgmma.cu):
# their head dims (one instantiation each, the TMA box a whole 64-column
# chunk) and the fewest rows a head (one consumer warpgroup's 64): q rows
# for the forward and dq, kv rows for dk / dv.
WGMMA_HEAD_DIMS = (64, 128)
WGMMA_MIN_ROWS = 64


def _heads(x) -> int:
    """Heads of a (B, S, D) or (batch, S, H, D) tensor: B, or batch * H."""
    return x.shape[0] * (x.shape[2] if x.ndim == 4 else 1)


def _pack(x):
    """(batch, S, H, D) -> (batch * H, S, D); a 3-D tensor as it is."""
    if x.ndim == 3:
        return x
    return x.permute(0, 2, 1, 3).reshape(_heads(x), x.shape[1], x.shape[3])


def _unpack(x, like):
    """Inverse of :func:`_pack` for a tensor shaped like ``like``."""
    if like.ndim == 3:
        return x
    nb, s, h, _ = like.shape
    return x.reshape(nb, h, s, x.shape[-1]).permute(0, 2, 1, 3)


def _ints(x, device, shape=None):
    """An int array argument as a contiguous int32 tensor on ``device``."""
    if x is None:
        return None
    t = torch.as_tensor(x, device=device).to(torch.int32)
    return (t.reshape(shape) if shape is not None else t).contiguous()


def _check(q, k, v, kv_lengths, q_seg, kv_seg, offsets, causal, window):
    """The JAX wrapper's validation (pallas_flash.py:612-663), for 3-D or
    4-D operands.  Returns (B, S_q, D, B_kv, S_kv, group)."""
    if q.ndim not in (3, 4) or k.ndim not in (3, 4) or v.ndim != k.ndim:
        raise ValueError(f"flash_mha shapes: {tuple(q.shape)} x "
                         f"{tuple(k.shape)} x {tuple(v.shape)}")
    bsz, s_q, d = _heads(q), q.shape[1], q.shape[-1]
    b_kv, s_kv = _heads(k), k.shape[1]
    if k.shape != v.shape or k.shape[-1] != d or bsz % b_kv:
        raise ValueError(f"flash_mha shapes: {tuple(q.shape)} x "
                         f"{tuple(k.shape)} x {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_mha dtype mismatch: {q.dtype} x "
                         f"{k.dtype} x {v.dtype}")
    if window is not None and not causal:
        raise ValueError("window requires causal=True (sliding-window "
                         "attention is an autoregressive mask)")
    if kv_lengths is not None and tuple(kv_lengths.shape) != (b_kv,):
        raise ValueError(f"kv_lengths must be ({b_kv},), got "
                         f"{tuple(kv_lengths.shape)}")
    if offsets is not None:
        if not causal:
            raise ValueError("offsets only shift the causal/window masks; "
                             "they require causal=True")
        if kv_lengths is not None:
            raise ValueError("offsets are incompatible with kv_lengths "
                             "(which carries its own decode anchoring)")
    if (q_seg is None) != (kv_seg is None):
        raise ValueError("q_segment_ids and kv_segment_ids must be passed "
                         "together")
    if q_seg is not None and (tuple(q_seg.shape) != (bsz, s_q)
                              or tuple(kv_seg.shape) != (b_kv, s_kv)):
        raise ValueError(f"segment ids must be ({bsz},{s_q}) / "
                         f"({b_kv},{s_kv}), got {tuple(q_seg.shape)} / "
                         f"{tuple(kv_seg.shape)}")
    return bsz, s_q, d, b_kv, s_kv, bsz // b_kv


# ---------------------------------------------------------------------------
# Plain versions (3-D operands; int arguments as int32 tensors)
# ---------------------------------------------------------------------------

def _valid(b_kv, group, s_q, r0, r1, s_kv, device, causal, window,
           kv_lengths, q_seg, kv_seg, offsets):
    """Bool mask of q rows [r0, r1) against every kv column, broadcastable
    to (B_kv, group, r1 - r0, S_kv), or None when nothing is masked."""
    c = torch.arange(s_kv, device=device).view(1, 1, 1, s_kv)
    valid, anchor = None, 0
    if kv_lengths is not None:
        lens = kv_lengths.view(b_kv, 1, 1, 1)
        valid = c < lens
        if causal:
            anchor = lens - s_q
    if causal:
        r = torch.arange(r0, r1, device=device).view(1, 1, -1, 1)
        qp0 = anchor
        if offsets is not None:
            qp0 = qp0 + (offsets[0] - offsets[1])
        dpos = qp0 + r - c
        keep = dpos >= 0
        if window is not None:
            keep = keep & (dpos < window)
        valid = keep if valid is None else valid & keep
    if q_seg is not None:
        seg = (q_seg.view(b_kv, group, s_q)[:, :, r0:r1, None]
               == kv_seg.view(b_kv, 1, 1, s_kv))
        valid = seg if valid is None else valid & seg
    return valid


def _scores(qf, kf, scale, logit_cap):
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if logit_cap is not None:
        s = logit_cap * torch.tanh(s / logit_cap)
    return s


def flash_fwd_plain(q, k, v, kv_lengths=None, q_seg=None, kv_seg=None,
                    offsets=None, *, causal=False, window=None,
                    logit_cap=None, scale=1.0, block_q=512, out_dtype=None):
    """Plain version of ``flash_fwd``: (o in ``out_dtype``, default q's,
    lse (B, S_q) fp32) for 3-D q (B, S_q, D) and k, v (B_kv, S_kv, D)."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    bsz, s_q, d = q.shape
    b_kv, s_kv = k.shape[:2]
    group = bsz // b_kv
    kf = k.float().view(b_kv, 1, s_kv, d)
    vf = v.float()
    if kv_lengths is not None:
        # Rows past the length are zeroed: 0 * NaN would poison p v.
        live = torch.arange(s_kv, device=v.device).view(1, s_kv, 1) \
            < kv_lengths.view(b_kv, 1, 1)
        vf = torch.where(live, vf, 0.0)
    vf = vf.view(b_kv, 1, s_kv, d)
    qv = q.view(b_kv, group, s_q, d)
    o = torch.empty(q.shape, dtype=out_dtype or q.dtype, device=q.device)
    lse = torch.empty((bsz, s_q), dtype=torch.float32, device=q.device)
    ov, lv = o.view(b_kv, group, s_q, d), lse.view(b_kv, group, s_q)
    for r0 in range(0, s_q, max(1, block_q)):
        r1 = min(s_q, r0 + block_q)
        s = _scores(qv[:, :, r0:r1].float(), kf, scale, logit_cap)
        valid = _valid(b_kv, group, s_q, r0, r1, s_kv, q.device, causal,
                       window, kv_lengths, q_seg, kv_seg, offsets)
        if valid is not None:
            s = torch.where(valid, s, _MASK)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        if valid is not None:
            p = torch.where(valid, p, 0.0)
        l = p.sum(-1, keepdim=True)
        pv = torch.matmul(p.to(v.dtype).float(), vf)
        ov[:, :, r0:r1] = (pv / torch.where(l == 0, 1.0, l)).to(o.dtype)
        lv[:, :, r0:r1] = (m + torch.log(l))[..., 0]
    return o, lse


def _bwd_tiles(q, k, v, do, lse, delta, q_seg, kv_seg, offsets, causal,
               window, logit_cap, scale, block_q):
    """Yields (r0, r1, p, ds, q tile, dO tile) per q tile, p and ds fp32
    (B_kv, group, rows, S_kv): the recompute shared by both backward plain
    versions (pallas_flash.py::_recompute_p_ds)."""
    q, k, v, do = (x.contiguous() for x in (q, k, v, do))
    bsz, s_q, d = q.shape
    b_kv, s_kv = k.shape[:2]
    group = bsz // b_kv
    kf = k.float().view(b_kv, 1, s_kv, d)
    vf = v.float().view(b_kv, 1, s_kv, d)
    qv, dv_ = q.view(b_kv, group, s_q, d), do.view(b_kv, group, s_q, d)
    lv = lse.reshape(b_kv, group, s_q, 1)
    dl = delta.reshape(b_kv, group, s_q, 1)
    for r0 in range(0, s_q, max(1, block_q)):
        r1 = min(s_q, r0 + block_q)
        qt, dt = qv[:, :, r0:r1].float(), dv_[:, :, r0:r1].float()
        s = _scores(qt, kf, scale, logit_cap)
        valid = _valid(b_kv, group, s_q, r0, r1, s_kv, q.device, causal,
                       window, None, q_seg, kv_seg, offsets)
        p = torch.exp(s - lv[:, :, r0:r1])
        if valid is not None:
            p = torch.where(valid, p, 0.0)
        ds = p * (torch.matmul(dt, vf.transpose(-1, -2)) - dl[:, :, r0:r1])
        if logit_cap is not None:
            ds = ds * (1.0 - torch.square(s / logit_cap))
        yield r0, r1, p, ds, qt, dt


def flash_bwd_dq_plain(q, k, v, do, lse, delta, q_seg=None, kv_seg=None,
                       offsets=None, *, causal=False, window=None,
                       logit_cap=None, scale=1.0, block_q=512):
    """Plain version of ``flash_bwd_dq``: dq = scale ds k, in q's dtype."""
    bsz, s_q, d = q.shape
    b_kv, s_kv = k.shape[:2]
    kf = k.float().reshape(b_kv, 1, s_kv, d)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dqv = dq.view(b_kv, bsz // b_kv, s_q, d)
    for r0, r1, _, ds, _, _ in _bwd_tiles(q, k, v, do, lse, delta, q_seg,
                                          kv_seg, offsets, causal, window,
                                          logit_cap, scale, block_q):
        dqv[:, :, r0:r1] = (torch.matmul(ds.to(k.dtype).float(), kf)
                            * scale).to(q.dtype)
    return dq


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, q_seg=None, kv_seg=None,
                        offsets=None, *, causal=False, window=None,
                        logit_cap=None, scale=1.0, block_q=512):
    """Plain version of ``flash_bwd_dkv``: (dk, dv) per kv head, each
    summed in fp32 over the q heads of its group and the q tiles."""
    b_kv, s_kv, d = k.shape
    dk = torch.zeros((b_kv, s_kv, d), dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    for r0, r1, p, ds, qt, dt in _bwd_tiles(q, k, v, do, lse, delta, q_seg,
                                            kv_seg, offsets, causal, window,
                                            logit_cap, scale, block_q):
        rows = p.shape[1] * (r1 - r0)   # group x tile rows, contracted
        pt = p.to(do.dtype).float().reshape(b_kv, rows, s_kv)
        dst = ds.to(q.dtype).float().reshape(b_kv, rows, s_kv)
        dv += torch.matmul(pt.transpose(1, 2), dt.reshape(b_kv, rows, d))
        dk += torch.matmul(dst.transpose(1, 2), qt.reshape(b_kv, rows, d))
    return (dk * scale).to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Kernel launches (CUDA operands, 3-D or 4-D in place)
# ---------------------------------------------------------------------------

def _strided(x):
    """``x`` with a unit-stride last axis (a copy only if it has none)."""
    return x if x.stride(-1) == 1 else x.contiguous()


def _seq(x):
    """(pointer, heads, sb, sh, ss) of a (B, S, D) or (batch, S, H, D)
    tensor: element (b, s, d) at p + (b // heads) sb + (b % heads) sh +
    s ss + d (csrc/flash_common.cuh::Seq)."""
    if x.ndim == 3:
        return [x.data_ptr(), 1, x.stride(0), 0, x.stride(1)]
    return [x.data_ptr(), x.shape[2], x.stride(0), x.stride(2), x.stride(1)]


def _vec(*xs) -> int:
    """Every row start of every operand is 16-byte aligned (cp.async)."""
    for x in xs:
        step = 16 // x.element_size()
        if x.data_ptr() % 16 or any(s % step for s in x.stride()[:-1]):
            return 0
    return 1


def flash_route(dtype, d: int, s_q: int, aligned: bool) -> str:
    """The kernel a forward launch takes: ``"wgmma"`` (``csrc/flash_wgmma.cu``:
    TMA and warp-specialised wgmma, one persistent block a SM) for bf16 /
    fp16 with a head dim of 64 or 128 and at least 64 query rows a head,
    whose q, k and v are ``aligned`` (16-byte bases, every row, head and
    batch stride whole 16-byte units: what a TMA map describes);
    ``"mma.sync"`` (``csrc/flash_fwd.cu``'s tensor-core tile) for the other
    bf16 / fp16 calls (other head dims, decode's few rows a head, unaligned
    rows); ``"simt"`` (IEEE fp32 on the CUDA cores) for fp32.  Chosen by
    shape, never as a fallback: a kernel that fails to build or launch
    raises."""
    if dtype == torch.float32:
        return "simt"
    if d in WGMMA_HEAD_DIMS and s_q >= WGMMA_MIN_ROWS and aligned:
        return "wgmma"
    return "mma.sync"


def flash_bwd_route(dtype, d: int, rows: int, aligned: bool) -> str:
    """The kernel a backward launch takes, by :func:`flash_route`'s rule:
    ``"wgmma"`` (``csrc/flash_bwd_wgmma.cu``: TMA and warp-specialised
    wgmma, one persistent block a SM) for bf16 / fp16 with a head dim of 64
    or 128 and at least 64 ``rows`` a head (S_q for dq, S_kv for dk / dv),
    whose q, k, v, dO and outputs are ``aligned`` (16-byte bases and
    strides); ``"mma.sync"`` (``csrc/flash_bwd_dq.cu`` /
    ``flash_bwd_dkv.cu``'s tensor-core tile) for the other bf16 / fp16
    calls; ``"simt"`` (IEEE fp32 on the CUDA cores) for fp32.  Chosen by
    shape, never as a fallback."""
    return flash_route(dtype, d, rows, aligned)


def _kernel_ok(q, what, interpret):
    """Refuse what no kernel takes, on a CUDA operand."""
    if interpret:
        raise NotImplementedError(
            f"{what}: CUDA has no interpreter mode; pass CPU tensors for the "
            f"plain version")
    if q.dtype not in _KERNEL_DTYPES:
        raise NotImplementedError(
            f"{what}: no kernel takes {q.dtype} (bf16, fp16, fp32; ROADMAP B "
            f"coverage item 12)")
    if q.shape[-1] > MAX_KERNEL_D:
        raise NotImplementedError(
            f"{what}: head dim {q.shape[-1]} > {MAX_KERNEL_D}, the largest "
            f"the kernels are compiled for (ROADMAP B coverage item 3)")


def _same_device(q, *xs):
    for x in xs:
        if x is not None and x.device != q.device:
            raise ValueError(f"operands on {q.device} and {x.device}")


def _launch(entry, seqs, ptrs, dims, cap, scale, dtype, device, what):
    arr = (ctypes.c_int64 * len(seqs))(*seqs)
    dim = (ctypes.c_int * len(dims))(*dims)
    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(arr, *ptrs, dim, float(cap or 0.0),
                                 float(scale), _build.dtype_code(dtype),
                                 stream)
    _build.check(rc, what)


def _ptr(x):
    return None if x is None else x.data_ptr()


def _dims(q, k, causal, window, vec):
    return [_heads(q), _heads(q) // _heads(k), q.shape[1], k.shape[1],
            q.shape[-1], int(bool(causal)), int(window or 0), vec]


def _out_dtype(q, out_dtype):
    """o's type: q's (None), or fp32 (the ring's partials, JAX's
    ``cfg.out_dtype="float32"``); the kernels store no other."""
    if out_dtype is None or out_dtype == q.dtype:
        return q.dtype
    if out_dtype != torch.float32:
        raise ValueError(f"flash_mha out_dtype {out_dtype}: q's type "
                         f"({q.dtype}) or torch.float32")
    return out_dtype


def _forward(q, k, v, kv_lengths, q_seg, kv_seg, offsets, causal, window,
             logit_cap, scale, block_q, interpret=None, route=None,
             out_dtype=None):
    """(o in q's layout and ``out_dtype`` (default q's), lse (B, S_q) fp32):
    the kernel on CUDA operands (``flash_route``'s, or ``route`` where a
    comparison names one), the plain version on CPU ones.  q, k, v each 3-D
    or 4-D."""
    _check(q, k, v, kv_lengths, q_seg, kv_seg, offsets, causal, window)
    odt = _out_dtype(q, out_dtype)
    if q.device.type == "cpu":
        with torch.no_grad():
            o, lse = flash_fwd_plain(
                _pack(q), _pack(k), _pack(v), kv_lengths, q_seg, kv_seg,
                offsets, causal=causal, window=window, logit_cap=logit_cap,
                scale=scale, block_q=block_q, out_dtype=odt)
        return _unpack(o, q), lse
    _same_device(q, k, v, kv_lengths, q_seg, kv_seg, offsets)
    _kernel_ok(q, "flash_fwd", interpret)
    q, k, v = _strided(q), _strided(k), _strided(v)
    o = torch.empty(q.shape, dtype=odt, device=q.device)
    lse = torch.empty((_heads(q), q.shape[1]), dtype=torch.float32,
                      device=q.device)
    aligned = _vec(q, k, v)
    route = named_route(route, flash_route(q.dtype, q.shape[-1], q.shape[1], bool(aligned)),
                   "flash_fwd")
    _launch("flash_wgmma" if route == "wgmma" else "flash_fwd",
            _seq(q) + _seq(k) + _seq(v) + _seq(o),
            [lse.data_ptr(), _ptr(kv_lengths), _ptr(q_seg), _ptr(kv_seg),
             _ptr(offsets)],
            _dims(q, k, causal, window, aligned and _vec(o))
            + [int(odt == torch.float32)], logit_cap, scale,
            q.dtype, q.device, "flash_fwd")
    flash_mha.launches += 1
    flash_mha.last_route = route
    return o, lse


def _backward(q, k, v, do, lse, delta, q_seg, kv_seg, offsets, causal,
              window, logit_cap, scale, block_q, which, interpret=None,
              route=None):
    """dq (``which`` = "dq") or (dk, dv) per kv head ("dkv") in the
    operands' layouts: the kernel on CUDA operands (``flash_bwd_route``'s,
    or ``route`` where a comparison names one), the plain version on CPU
    ones.  lse, delta: (B, S_q) fp32."""
    _check(q, k, v, None, q_seg, kv_seg, offsets, causal, window)
    lse = lse.reshape(_heads(q), q.shape[1]).float().contiguous()
    delta = delta.reshape(_heads(q), q.shape[1]).float().contiguous()
    if q.device.type == "cpu":
        plain = flash_bwd_dq_plain if which == "dq" else flash_bwd_dkv_plain
        with torch.no_grad():
            out = plain(_pack(q), _pack(k), _pack(v), _pack(do), lse, delta,
                        q_seg, kv_seg, offsets, causal=causal, window=window,
                        logit_cap=logit_cap, scale=scale, block_q=block_q)
        if which == "dq":
            return _unpack(out, q)
        return _unpack(out[0], k), _unpack(out[1], v)
    what = f"flash_bwd_{which}"
    _same_device(q, k, v, do, lse, q_seg, kv_seg, offsets)
    _kernel_ok(q, what, interpret)
    if do.dtype != q.dtype or do.shape != q.shape:
        raise ValueError(f"{what}: dO {tuple(do.shape)} {do.dtype} vs q "
                         f"{tuple(q.shape)} {q.dtype}")
    q, k, v, do = (_strided(x) for x in (q, k, v, do))
    outs = ([torch.empty(q.shape, dtype=q.dtype, device=q.device)]
            if which == "dq" else
            [torch.empty(k.shape, dtype=k.dtype, device=k.device)
             for _ in range(2)])
    seqs = _seq(q) + _seq(k) + _seq(v) + _seq(do)
    for x in outs:
        seqs += _seq(x)
    aligned = _vec(q, k, v, do, *outs)
    rows = q.shape[1] if which == "dq" else k.shape[1]
    route = named_route(route, flash_bwd_route(q.dtype, q.shape[-1], rows, bool(aligned)), what)
    _launch(what + "_wgmma" if route == "wgmma" else what, seqs,
            [lse.data_ptr(), delta.data_ptr(), _ptr(q_seg), _ptr(kv_seg),
             _ptr(offsets)],
            _dims(q, k, causal, window, aligned), logit_cap,
            scale, q.dtype, q.device, what)
    wrapper = flash_mha_bwd_dq if which == "dq" else flash_mha_bwd_dkv
    wrapper.launches += 1
    wrapper.last_route = route
    return outs[0] if which == "dq" else (outs[0], outs[1])


# ---------------------------------------------------------------------------
# Public surface: pallas_flash.py's flash_mha, flash_mha_bwd_dq / _dkv and
# flash_mha_diff
# ---------------------------------------------------------------------------

def _seg2(seg, rows, device):
    """Segment ids in any of the JAX layouts ((B, S), (B, S, 1),
    (B, 1, S)) as contiguous int32 (B, S)."""
    return _ints(seg, device, None if seg is None else (rows, -1))


def flash_mha(q, k, v, kv_lengths=None, q_segment_ids=None,
              kv_segment_ids=None, offsets=None, *, causal=False,
              block_q=512, block_kv=2048, block_kv_compute=None,
              block_q_compute=None, interpret=None, window=None,
              logit_cap=None, save_lse=False, scale=1.0, route=None,
              out_dtype=None):
    """o = softmax(scale q k^T) v per head (kernel ``flash_fwd``).

    Args:
      q: (B, S_q, D); k, v: (B_kv, S_kv, D) with B_kv dividing B (GQA:
        q head b reads kv head b // (B / B_kv)).
      kv_lengths: (B_kv,) int, per-kv-head logical lengths (padded-cache
        decode); with ``causal`` the queries sit at the cache end.
      q_segment_ids / kv_segment_ids: (B, S_q) / (B_kv, S_kv) int;
        only same-segment pairs interact.
      offsets: (2,) int (q_offset, kv_offset), absolute positions of the
        first q / kv row for the causal / window masks; requires causal.
      scale: folded into the fp32 scores in the kernel.
      block_q: the plain version's q tile; ``block_kv``,
        ``block_kv_compute`` and ``block_q_compute`` are accepted for the
        JAX signature: the CUDA kernels' tiles are their own.  The kernel
        is :func:`flash_route`'s, recorded as ``flash_mha.last_route``;
        ``route`` names one (a tuned winner, a comparison).
      out_dtype: None (q's type) or ``torch.float32``: o stored unrounded in
        fp32 from the same kernel arithmetic (JAX's ``cfg.out_dtype``; the
        ring's partials, merged in fp32 before one rounding).

    Returns o (B, S_q, D) in ``out_dtype``, and with ``save_lse`` also lse
    (B, S_q, 1) fp32 (-inf on a fully masked row, where o = 0).
    """
    del block_kv, block_kv_compute, block_q_compute
    dev = q.device
    o, lse = _forward(q, k, v, _ints(kv_lengths, dev),
                      _seg2(q_segment_ids, _heads(q), dev),
                      _seg2(kv_segment_ids, _heads(k), dev),
                      _ints(offsets, dev, (2,)), causal, window, logit_cap,
                      scale, block_q, interpret, route, out_dtype)
    if save_lse:
        return o, lse[..., None]
    return o


def flash_mha_bwd_dq(qs, k, v, do, lse, delta, q_segment_ids=None,
                     kv_segment_ids=None, offsets=None, *, causal=False,
                     block_q=512, block_kv=2048, interpret=None, window=None,
                     logit_cap=None, scale=1.0):
    """dL/dq (kernel ``flash_bwd_dq``) from the forward's lse and
    delta = sum_d dO * O, each (B, S_q) or (B, S_q, 1) fp32.  ``scale``
    must match the forward's.  The kernel is :func:`flash_bwd_route`'s,
    recorded as ``flash_mha_bwd_dq.last_route``."""
    del block_kv
    dev = qs.device
    return _backward(qs, k, v, do, lse, delta,
                     _seg2(q_segment_ids, _heads(qs), dev),
                     _seg2(kv_segment_ids, _heads(k), dev),
                     _ints(offsets, dev, (2,)), causal, window, logit_cap,
                     scale, block_q, "dq", interpret)


def flash_mha_bwd_dkv(qs, k, v, do, lse, delta, q_segment_ids=None,
                      kv_segment_ids=None, offsets=None, *, causal=False,
                      block_q=512, block_kv=2048, interpret=None,
                      window=None, logit_cap=None, scale=1.0):
    """(dL/dk, dL/dv) per kv head (kernel ``flash_bwd_dkv``), shaped like
    k and v: a GQA group's q heads are summed in the kernel, in fp32.  The
    kernel is :func:`flash_bwd_route`'s for S_kv rows, recorded as
    ``flash_mha_bwd_dkv.last_route``."""
    del block_kv
    dev = qs.device
    return _backward(qs, k, v, do, lse, delta,
                     _seg2(q_segment_ids, _heads(qs), dev),
                     _seg2(kv_segment_ids, _heads(k), dev),
                     _ints(offsets, dev, (2,)), causal, window, logit_cap,
                     scale, block_q, "dkv", interpret)


# Kernel launches since the counts were last reset (plain calls not
# counted), and the route of each wrapper's last launch.
flash_mha.launches = 0
flash_mha.last_route = None
flash_mha_bwd_dq.launches = 0
flash_mha_bwd_dq.last_route = None
flash_mha_bwd_dkv.launches = 0
flash_mha_bwd_dkv.last_route = None


class _FlashDiff(torch.autograd.Function):
    """Custom VJP of pallas_flash.py:1610-1685: the forward saves lse, the
    backward runs the dq and dkv kernels."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, opts):
        o, lse = _forward(q, k, v, None, q_seg, kv_seg, None, opts["causal"],
                          opts["window"], opts["logit_cap"], opts["scale"],
                          opts["block_q"], opts["interpret"], opts["route"])
        ctx.save_for_backward(q, k, v, o, lse, q_seg, kv_seg)
        ctx.opts = opts
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, q_seg, kv_seg = ctx.saved_tensors
        opts = ctx.opts
        # Softmax-Jacobian row term, in fp32, packed (B, S_q) like lse.
        delta = _pack((do.float() * o.float()).sum(-1, keepdim=True))[..., 0]
        do = do.to(q.dtype)
        kw = dict(causal=opts["causal"], window=opts["window"],
                  logit_cap=opts["logit_cap"], scale=opts["scale"],
                  block_q=opts["bwd_block_q"], interpret=opts["interpret"],
                  route=opts["bwd_route"])
        dq = _backward(q, k, v, do, lse, delta, q_seg, kv_seg, None,
                       which="dq", **kw)
        dk, dv = _backward(q, k, v, do, lse, delta, q_seg, kv_seg, None,
                           which="dkv", **kw)
        return dq, dk, dv, None, None, None


def flash_mha_diff(qs, k, v, q_seg=None, kv_seg=None, *, causal=False,
                   block_q=512, block_kv=2048, interpret=None, window=None,
                   logit_cap=None, block_kv_compute=None,
                   block_q_compute=None, bwd_block_q=None, bwd_block_kv=None,
                   scale=1.0, route=None, bwd_route=None):
    """Differentiable flash attention: :func:`flash_mha`'s forward (with
    lse saved) and a backward on the dq and dkv kernels.  q, k, v are 3-D,
    or 4-D (batch, S, H, D) read in place; segment ids are (B, S) per
    packed head.  ``bwd_block_q`` is the plain backward's q tile.
    ``route`` / ``bwd_route`` name the forward's / the backward pair's
    kernel (a tuned winner); None takes :func:`flash_route`'s /
    :func:`flash_bwd_route`'s."""
    del block_kv, block_kv_compute, block_q_compute, bwd_block_kv
    dev = qs.device
    opts = dict(causal=causal, window=window, logit_cap=logit_cap,
                scale=scale, block_q=block_q, interpret=interpret,
                bwd_block_q=bwd_block_q or block_q, route=route,
                bwd_route=bwd_route)
    return _FlashDiff.apply(qs, k, v, _seg2(q_seg, _heads(qs), dev),
                            _seg2(kv_seg, _heads(k), dev), opts)
