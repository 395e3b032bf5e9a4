"""Ring flash attention: sequence-parallel attention over a mesh of ranks.

Counterpart of ``gemm_hls_tpu/parallel/ring_attention.py``.  Q, K and V
are sharded over the sequence axis of one mesh axis; each rank runs the
flash forward (kernels B6-B8, ``ops/flash.py::flash_mha``) against the KV
shard it holds, and the KV shards rotate one hop a step around the ring
(``parallel/sharding.py::ppermute``, copies between the ranks' buffers).
Each step's partial is a normalized output with its per-row log-sum-exp,
stored in fp32 (``flash_mha(out_dtype=torch.float32)``) and merged in fp32
by the associative log-sum-exp combine

    lse = logaddexp(lse_a, lse_b)
    o   = o_a exp(lse_a - lse) + o_b exp(lse_b - lse)

and rounded to q's type once at the end, as the JAX ring does.

One process drives every rank (``parallel/sharding.py``).  A rank's
position on the ring is a host integer, so the branches JAX takes with
``lax.switch`` / ``jnp.where`` are host branches here: a causal step on a
shard wholly in the rank's future (or, with ``window``, wholly older than
every query's window) launches nothing and leaves the merge as it was (the
JAX ring's -inf partial is a no-op in the combine), and zigzag launches its
one live conditional pair.

Differentiable: the gradient is a second ring (``_RingCore.backward``) on
the flash backward kernels (B9-B12, ``flash_mha_bwd_dq`` /
``flash_mha_bwd_dkv``) fed the forward's global lse, in which each KV
shard's accumulating (dk, dv), fp32, travels with it and comes home after
one last hop; dq accumulates on its rank in fp32.  Every cast to the
operands' types happens once, at the end.  q is pre-scaled as JAX does,
``(q * scale).to(q.dtype)`` with the scale in q's type, and the kernels run
with scale 1, so autograd carries the scale into dq.

Bytes (``sharding.BYTES``): the forward's rotations count under
``"ring_attention"``, (n - 1) 2 |KV shard| a rank; the backward's under
``"ring_attention_bwd"``, that again plus n 2 |KV shard in fp32|;
``ring_decode_attention``'s gather under ``"ring_decode"``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from gemm_hls_tpu_torch.ops.flash import (
    flash_mha, flash_mha_bwd_dkv, flash_mha_bwd_dq,
)
from gemm_hls_tpu_torch.parallel.mesh import Mesh
from gemm_hls_tpu_torch.parallel.sharding import (
    P, Sharded, _unflat, all_gather, device_put, global_tensor, on_device, ppermute,
    rank_array,
)

FWD_TAG, BWD_TAG, DECODE_TAG = "ring_attention", "ring_attention_bwd", "ring_decode"


def _check_shapes(what, q, k, v, kv_lengths):
    """q (B, S_q, D) against k, v (B_kv, S_kv, D), B_kv dividing B, and
    kv_lengths (B_kv,) where given."""
    if q.ndim != 3 or k.shape != v.shape or q.shape[0] % k.shape[0] or \
            k.shape[2] != q.shape[2]:
        raise ValueError(f"{what} shapes: {tuple(q.shape)} x "
                         f"{tuple(k.shape)} x {tuple(v.shape)}")
    if kv_lengths is not None and tuple(kv_lengths.shape) != (k.shape[0],):
        raise ValueError(f"kv_lengths must be ({k.shape[0]},), got "
                         f"{tuple(kv_lengths.shape)}")


def _validate(q, k, v, n_ring, causal, window, q_seg, kv_seg, kv_lengths, zigzag):
    """The JAX ring's checks (ring_attention.py:110-156)."""
    _check_shapes("ring_flash_attention", q, k, v, kv_lengths)
    s_q, s_kv = q.shape[1], k.shape[1]
    if s_q % n_ring or s_kv % n_ring:
        raise ValueError(f"the ring size {n_ring} must divide both "
                         f"sequence lengths ({s_q}, {s_kv})")
    if causal and s_q != s_kv:
        raise ValueError(f"causal ring attention needs S_q == S_kv, got {s_q} vs {s_kv}")
    if window is not None and not causal:
        raise ValueError("window requires causal=True (sliding-window "
                         "attention is an autoregressive mask)")
    if (q_seg is None) != (kv_seg is None):
        raise ValueError("q_segment_ids and kv_segment_ids must be passed together")
    if q_seg is not None and (tuple(q_seg.shape) != (q.shape[0], s_q)
                              or tuple(kv_seg.shape) != (k.shape[0], s_kv)):
        raise ValueError(f"segment ids must be ({q.shape[0]},{s_q}) / "
                         f"({k.shape[0]},{s_kv}), got {tuple(q_seg.shape)} / "
                         f"{tuple(kv_seg.shape)}")
    if kv_lengths is not None and causal:
        raise ValueError(
            "kv_lengths over the ring is a padded-batch (non-causal) feature; "
            "causal decode anchoring is single-card (ops/flash.py)")
    if zigzag:
        if not causal:
            raise ValueError("zigzag=True is a causal load-balancing layout; it "
                             "requires causal=True")
        if s_q % (2 * n_ring):
            raise ValueError(f"zigzag needs 2*ring_size ({2 * n_ring}) to divide "
                             f"the sequence length ({s_q})")
        if window is not None or q_seg is not None:
            raise ValueError("zigzag supports GQA/logit_cap; windows and segment "
                             "ids run on the plain ring (zigzag=False)")


def _prescaled(q, scale):
    """``(q * scale).astype(q.dtype)`` with the scale in q's type, as JAX
    computes it (ring_attention.py:166)."""
    return q * torch.tensor(scale, dtype=q.dtype, device=q.device)


def zigzag_indices(s: int, n_ring: int) -> torch.Tensor:
    """Token permutation from natural order to the zigzag ring layout: the
    sequence splits into ``2 n_ring`` chunks and rank d holds chunks d and
    ``2 n_ring - 1 - d``.  ``x_zigzag = x[:, order]``; invert with
    ``torch.argsort(order)``.  (int64, the port's index type; JAX's int32.)"""
    if s % (2 * n_ring):
        raise ValueError(f"2*ring_size ({2 * n_ring}) must divide the sequence "
                         f"length ({s})")
    c = s // (2 * n_ring)
    chunks = []
    for d in range(n_ring):
        chunks.extend([d, 2 * n_ring - 1 - d])
    return (torch.tensor(chunks)[:, None] * c + torch.arange(c)[None, :]).reshape(-1)


def _ring_perm(n_ring):
    return [(i, (i + 1) % n_ring) for i in range(n_ring)]


def _lse_combine(o, lse, o_p, lse_p):
    """Associative log-sum-exp merge of two normalized fp32 partials; a row
    whose lse is -inf (empty so far, or fully masked in the partial) has
    weight 0, never exp(-inf - -inf) = nan."""
    lse_new = torch.logaddexp(lse, lse_p)
    fin, fin_p = torch.isfinite(lse), torch.isfinite(lse_p)
    w_old = torch.where(fin, torch.exp(lse - lse_new), 0.0)
    w_new = torch.where(fin_p, torch.exp(lse_p - lse_new), 0.0)
    return (torch.where(fin, o * w_old, 0.0)
            + torch.where(fin_p, o_p * w_new, 0.0), lse_new)


def _merge(acc, part):
    """``acc`` merged with ``part`` ((o, lse), or None for a skipped step)."""
    if part is None:
        return acc
    if acc is None:
        return part
    return _lse_combine(acc[0], acc[1], part[0], part[1])


def _flat(arr, mesh):
    return [arr[c] for c in mesh.coords()]


def _half(n_rows, halves, i):
    h = n_rows // halves
    return slice(i * h, (i + 1) * h)


class _Ring:
    """The ring's forward and backward on every rank at once: one loop each
    (the JAX ring's ``_ring_fwd_impl`` / ``_ring_core_bwd`` and zigzag's
    ``_zz_fwd_impl`` / ``_zz_core_bwd``); a subclass's ``_calls`` says which
    flash calls a rank makes at a step.  A rank's rows (and a shard's) are
    ``halves`` equal chunks, each merged apart."""

    halves = 1

    def __init__(self, mesh, axis, causal, window, logit_cap, q_seg, kv_seg,
                 kv_len, block_q, block_kv, interpret):
        self.mesh, self.axis, self.n = mesh, axis, mesh.shape[axis]
        self.causal, self.window = causal, window
        self.q_seg, self.kv_seg, self.kv_len = q_seg, kv_seg, kv_len
        self.kw = dict(block_q=block_q, block_kv=block_kv, interpret=interpret,
                       window=window, logit_cap=logit_cap, scale=1.0)
        self._offsets = {}

    def _calls(self, c, t, s_loc, s_kv_loc, device):
        """Rank ``c``'s flash calls at step t, each (q chunk, kv chunk,
        causal, offsets, kv_lengths); at step t the rank holds shard
        (my - t) mod n."""
        raise NotImplementedError

    def _views(self, c, call, qs, kv, seg, *rows_of):
        """(q, k, v, q_seg, kv_seg, offsets) of one call, and each of
        ``rows_of``'s tensors cut to its q rows."""
        qi, ki, _, offsets, _ = call
        rows = _half(qs[c].shape[1], self.halves, qi)
        cols = _half(kv[0][c].shape[1], self.halves, ki)
        return ((qs[c][:, rows], kv[0][c][:, cols], kv[1][c][:, cols],
                 None if seg is None else self.q_seg[c][:, rows],
                 None if seg is None else seg[c][:, cols], offsets),
                rows, cols, [x[c][:, rows] for x in rows_of])

    def _rotate(self, xs, tag):
        return tuple(None if x is None else
                     ppermute(x, self.mesh, self.axis, _ring_perm(self.n), tag=tag) for x in xs)

    def forward(self, qs, k, v):
        mesh = self.mesh
        acc = {c: [None] * self.halves for c in mesh.coords()}
        seg = self.kv_seg
        for t in range(self.n):
            if t:  # rotate before compute: step t works on shard (my - t)
                k, v, seg = self._rotate((k, v, seg), FWD_TAG)
            for c in mesh.coords():
                with on_device(mesh.devices[c]):
                    for call in self._calls(c, t, qs[c].shape[1], k[c].shape[1], qs[c].device):
                        (q_c, k_c, v_c, q_sg, kv_sg, offsets), _, _, _ = self._views(
                            c, call, qs, (k, v), seg)
                        part = flash_mha(q_c, k_c, v_c, kv_lengths=call[4],
                                         q_segment_ids=q_sg, kv_segment_ids=kv_sg,
                                         offsets=offsets, causal=call[2], save_lse=True,
                                         out_dtype=torch.float32, **self.kw)
                        acc[c][call[0]] = _merge(acc[c][call[0]], part)
        o, lse = rank_array(mesh), rank_array(mesh)
        for c in mesh.coords():
            os_, ls = zip(*acc[c])
            o[c] = (os_[0] if self.halves == 1 else torch.cat(os_, 1)).to(qs[c].dtype)
            lse[c] = ls[0] if self.halves == 1 else torch.cat(ls, 1)
        return o, lse

    def backward(self, qs, k, v, do, o, lse):
        mesh = self.mesh
        dq, dk, dv, delta, do_c = (rank_array(mesh) for _ in range(5))
        for c in mesh.coords():
            with on_device(mesh.devices[c]):
                delta[c] = (do[c].float() * o[c].float()).sum(-1)
                do_c[c] = do[c].to(qs[c].dtype)
                dq[c] = torch.zeros(qs[c].shape, dtype=torch.float32, device=qs[c].device)
                dk[c] = torch.zeros(k[c].shape, dtype=torch.float32, device=k[c].device)
                dv[c] = torch.zeros_like(dk[c])
        kk, vv, seg = k, v, self.kv_seg
        for t in range(self.n):
            if t:  # each shard travels with its accumulating (dk, dv)
                kk, vv, seg, dk, dv = self._rotate((kk, vv, seg, dk, dv), BWD_TAG)
            for c in mesh.coords():
                with on_device(mesh.devices[c]):
                    for call in self._calls(c, t, qs[c].shape[1], kk[c].shape[1], qs[c].device):
                        ops, rows, cols, (do_r, lse_r, delta_r) = self._views(
                            c, call, qs, (kk, vv), seg, do_c, lse, delta)
                        args = ops[:3] + (do_r, lse_r, delta_r) + ops[3:]
                        kw = dict(self.kw, causal=call[2])
                        dq[c][:, rows] += flash_mha_bwd_dq(*args, **kw).float()
                        dkc, dvc = flash_mha_bwd_dkv(*args, **kw)
                        dk[c][:, cols] += dkc.float()
                        dv[c][:, cols] += dvc.float()
        # One last gradient-only hop sends each shard's (dk, dv) home.
        dk, dv = self._rotate((dk, dv), BWD_TAG)
        for c in mesh.coords():
            dq[c], dk[c], dv[c] = dq[c].to(qs[c].dtype), dk[c].to(k[c].dtype), dv[c].to(v[c].dtype)
        return dq, dk, dv


class _Plain(_Ring):
    """The plain (contiguous) ring: one call a step, or none where the
    shard is wholly in the rank's future or older than every query's
    window."""

    def _offs(self, device, my, shard, s_loc, s_kv_loc):
        """(my S_loc, shard S_kv_loc) as a view of one int32 table a device,
        copied there once a call: a list would be a host-to-device copy, and
        a host wait, every step."""
        table = self._offsets.get(device)
        if table is None:
            idx = torch.arange(self.n)
            table = torch.stack([(idx * s_loc)[:, None].expand(self.n, self.n),
                                 (idx * s_kv_loc)[None, :].expand(self.n, self.n)], -1)
            table = self._offsets[device] = table.to(torch.int32).to(device)
        return table[my, shard]

    def _calls(self, c, t, s_loc, s_kv_loc, device):
        my = self.mesh.axis_index(c, self.axis)
        shard, offsets, lens = (my - t) % self.n, None, None
        if self.causal and self.window is not None:
            if shard > my or (shard + 1) * s_kv_loc <= my * s_loc - self.window + 1:
                return []
            causal, offsets = True, self._offs(device, my, shard, s_loc, s_kv_loc)
        elif self.causal:
            if shard > my:
                return []
            causal = shard == my
        else:
            causal = False
        if self.kv_len is not None:
            lens = (self.kv_len[c] - shard * s_kv_loc).clamp(0, s_kv_loc)
        return [(0, 0, causal, offsets, lens)]


class _Zigzag(_Ring):
    """The zigzag ring: rank d holds q chunks lo = d and hi = 2n - 1 - d;
    at step t >= 1 the pair (q_hi, kv_lo) is always past and exactly one of
    (q_lo, kv_lo) (when the source rank is below d) and (q_hi, kv_hi) is
    live, so every rank runs 3 flash calls at step 0 and 2 at each later
    step.  Chunk 0 is the lo chunk, 1 the hi chunk."""

    halves = 2

    def _calls(self, c, t, s_loc, s_kv_loc, device):
        my = self.mesh.axis_index(c, self.axis)
        if t == 0:  # both diagonals and the always-past pair
            pairs = [(0, 0, True), (1, 0, False), (1, 1, True)]
        else:
            pairs = [(1, 0, False),
                     (0, 0, False) if (my - t) % self.n < my else (1, 1, False)]
        return [(qi, ki, causal, None, None) for qi, ki, causal in pairs]


class _RingCore(torch.autograd.Function):
    """The ring's custom VJP (``_ring_core`` / ``_zz_core``): the forward
    keeps every rank's fp32 lse; the backward runs ``ring.backward``."""

    @staticmethod
    def forward(ctx, ring, *flat):
        mesh, n = ring.mesh, len(flat) // 3
        qs, k, v = (_unflat(flat[i * n:(i + 1) * n], mesh) for i in range(3))
        o, lse = ring.forward(qs, k, v)
        ctx.ring = ring
        ctx.save_for_backward(*flat, *_flat(o, mesh), *_flat(lse, mesh))
        return tuple(_flat(o, mesh))

    @staticmethod
    def backward(ctx, *grads):
        ring = ctx.ring
        mesh, n = ring.mesh, len(grads)
        saved = ctx.saved_tensors
        qs, k, v, o, lse = (_unflat(saved[i * n:(i + 1) * n], mesh) for i in range(5))
        do = _unflat([torch.zeros_like(o[c]) if g is None else g
                      for c, g in zip(mesh.coords(), grads)], mesh)
        dq, dk, dv = ring.backward(qs, k, v, do, o, lse)
        return (None, *_flat(dq, mesh), *_flat(dk, mesh), *_flat(dv, mesh))


def ring_flash_attention(q, k, v, mesh: Mesh, *, axis: str = "x",
                         causal: bool = False, zigzag: bool = False,
                         scale: Optional[float] = None,
                         window: Optional[int] = None,
                         logit_cap: Optional[float] = None,
                         q_segment_ids=None, kv_segment_ids=None,
                         kv_lengths=None, block_q: int = 512, block_kv: int = 2048,
                         config=None, interpret: Optional[bool] = None) -> Sharded:
    """softmax(q k^T scale) v with the sequence axis sharded over ``axis``.

    Args:
      q: (B, S_q, D) global tensor (or :class:`Sharded`); B = batch * heads.
      k, v: (B_kv, S_kv, D), B_kv dividing B (GQA: q head b reads kv head
        b // (B / B_kv); the smaller KV shards rotate as they are).
      mesh: the ranks; ``axis`` names the ring.  Ranks on the CPU run the
        kernels' plain versions.
      scale: score scale, default 1/sqrt(D), folded into q in q's type.
      window: sliding window (causal only), masked against absolute
        positions through the kernels' ``offsets``.
      logit_cap: tanh soft cap on the scores.
      q_segment_ids / kv_segment_ids: (B, S_q) / (B_kv, S_kv) int packed
        sequence ids; the kv ids travel with their shard.
      kv_lengths: (B_kv,) int lengths of a padded non-causal batch;
        forward only (no gradient), as in JAX.
      zigzag: causal load balancing, rank d holding sequence chunks d and
        2n - 1 - d of 2n; inputs and output stay in natural order.  Takes
        GQA and ``logit_cap``; windows and segment ids run on the plain
        ring.
      block_q: the plain versions' q tile; ``block_kv`` and ``config`` are
        accepted for the JAX signature (the kernels' tiles are their own).

    Returns a :class:`Sharded` (B, S_q, D) in q's type, laid out
    ``P(None, axis, None)``.  Differentiable through ``.full()`` (or the
    shards) back to q, k and v.
    """
    del config
    q, k, v = (global_tensor(x) for x in (q, k, v))
    n = mesh.shape[axis]
    _validate(q, k, v, n, causal, window, q_segment_ids, kv_segment_ids, kv_lengths, zigzag)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    spec = P(None, axis, None)
    qs = _prescaled(q, scale)
    if zigzag:
        order = zigzag_indices(q.shape[1], n).to(q.device)
        qs, k, v = (x[:, order.to(x.device)] for x in (qs, k, v))
    shards = [device_put(x, mesh, spec) for x in (qs, k, v)]
    seg = [None, None]
    if q_segment_ids is not None:
        seg = [device_put(torch.as_tensor(s).to(torch.int32), mesh, P(None, axis)).shards
               for s in (q_segment_ids, kv_segment_ids)]
    lens = None
    if kv_lengths is not None:
        lens = device_put(torch.as_tensor(kv_lengths).to(torch.int32), mesh, P(None)).shards
    ring = (_Zigzag if zigzag else _Plain)(mesh, axis, causal, window, logit_cap, seg[0],
                                           seg[1], lens, block_q, block_kv, interpret)
    if lens is not None:  # inference only: the backward kernels take no lengths
        with torch.no_grad():
            o, _ = ring.forward(*(s.shards for s in shards))
    else:
        o = _unflat(_RingCore.apply(ring, *(t for s in shards for t in _flat(s.shards, mesh))),
                    mesh)
    out = Sharded(mesh, spec, q.shape, o)
    if zigzag:
        full = out.full()
        out = device_put(full[:, torch.argsort(order).to(full.device)], mesh, spec)
    return out


def ring_decode_attention(q, k, v, kv_lengths, mesh: Mesh, *, axis: str = "x",
                          window: Optional[int] = None,
                          logit_cap: Optional[float] = None,
                          scale: Optional[float] = None,
                          block_q: int = 512, block_kv: int = 2048,
                          config=None, interpret: Optional[bool] = None) -> Sharded:
    """Context-parallel decode: causal queries at the end of a ragged KV
    cache whose sequence axis is sharded over ``axis``.

    The cache never moves.  The queries (few, replicated) meet each rank's
    resident shard in one flash call whose lengths are re-anchored to the
    shard, ``length - rank * S_loc`` (<= 0: the shard lies past the cache
    end and its partial is empty, lse = -inf; > S_loc: wholly valid); the
    fp32 partials and their lse, O(B S_q D), are all-gathered over ``axis``
    and lse-merged on every rank.

    Args:
      q: (B, S_q, D) queries; k, v: (B_kv, S_kv, D) global cache (B_kv
        dividing B: GQA); kv_lengths: (B_kv,) int logical lengths >= S_q;
        window: sliding window (positions (p - window, p] of query p).

    Returns a :class:`Sharded` (B, S_q, D) in q's type, replicated over the
    mesh.  Inference only (no gradient), like the single-card decode path.
    """
    del config
    q, k, v = (global_tensor(x) for x in (q, k, v))
    kv_lengths = torch.as_tensor(kv_lengths)
    _check_shapes("ring_decode_attention", q, k, v, kv_lengths)
    n = mesh.shape[axis]
    if k.shape[1] % n:
        raise ValueError(f"the ring size {n} must divide the KV length ({k.shape[1]})")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s_loc, group = k.shape[1] // n, q.shape[0] // k.shape[0]
    with torch.no_grad():
        rep = P(None, None, None)
        qs = device_put(_prescaled(q, scale), mesh, rep).shards
        kd, vd = (device_put(x, mesh, P(None, axis, None)).shards for x in (k, v))
        lens = device_put(kv_lengths.to(torch.int32), mesh, P(None)).shards
        o_p, lse_p = rank_array(mesh), rank_array(mesh)
        for c in mesh.coords():
            with on_device(mesh.devices[c]):
                len_eff = lens[c] - mesh.axis_index(c, axis) * s_loc
                o_p[c], lse = flash_mha(
                    qs[c], kd[c], vd[c], kv_lengths=len_eff, causal=True, window=window,
                    logit_cap=logit_cap, block_q=block_q, block_kv=block_kv,
                    interpret=interpret, save_lse=True, scale=1.0,
                    out_dtype=torch.float32)
                # A shard wholly past the cache end drops out of the merge.
                dead = (len_eff <= 0).repeat_interleave(group)[:, None, None]
                lse_p[c] = torch.where(dead, -torch.inf, lse)
        o_all = all_gather(o_p, mesh, axis, dim=0, tiled=False, tag=DECODE_TAG)
        lse_all = all_gather(lse_p, mesh, axis, dim=0, tiled=False, tag=DECODE_TAG)
        out = rank_array(mesh)
        for c in mesh.coords():
            with on_device(mesh.devices[c]):
                m = lse_all[c].amax(0)
                m = torch.where(torch.isfinite(m), m, 0.0)
                w = torch.where(torch.isfinite(lse_all[c]), torch.exp(lse_all[c] - m[None]), 0.0)
                den = w.sum(0)
                out[c] = ((o_all[c] * w).sum(0) / torch.where(den == 0, 1.0, den)).to(q.dtype)
    return Sharded(mesh, rep, q.shape, out)
