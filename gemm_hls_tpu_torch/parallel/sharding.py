"""Sharded tensors over a :class:`~gemm_hls_tpu_torch.parallel.mesh.Mesh`
and the collectives that move their shards: the port's counterpart of
``jax.sharding.NamedSharding`` / ``PartitionSpec``, ``jax.device_put`` and
the ``jax.lax`` collectives that ``gemm_hls_tpu/parallel/summa.py``,
``grid25d.py`` and ``ops/ozaki.py`` call inside ``shard_map``.

One process drives every rank (single controller, as JAX drives every
device).  A :class:`Sharded` holds one tensor per rank, on the rank's
device.  The collectives are written in bulk-synchronous form: each takes
the per-rank tensors of every rank at once (a numpy object array of the
mesh's shape) and returns the new ones.  They move data by copies into the
destination rank's buffer (``copy_(..., non_blocking=True)``): a
device-to-device copy where two ranks share a card, a peer copy between
two cards; nothing of ``torch.distributed`` is used.

Every byte a rank receives from another rank is counted in :data:`BYTES`
(``{tag: {rank coordinate: bytes}}``, the tag the collective's name unless
the caller names another), as the kernels count their launches; a rank's
copy of its own shard is not a transfer and is not counted.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Tuple

import numpy as np
import torch

from gemm_hls_tpu_torch.parallel.mesh import Mesh, _axes

# {tag: {rank coordinate: bytes received from other ranks}}.
BYTES: Dict[str, Dict[tuple, int]] = {}


def reset_bytes() -> None:
    """Set every byte count to 0."""
    BYTES.clear()


def bytes_received(mesh: Mesh, tags=None) -> np.ndarray:
    """Bytes each rank of ``mesh`` received since :func:`reset_bytes`
    (which a caller runs before it moves to another mesh), summed over
    ``tags`` (default: every tag), as an int array of the mesh's shape."""
    out = np.zeros(mesh.devices.shape, dtype=np.int64)
    for tag, per_rank in BYTES.items():
        if tags is None or tag in tags:
            for coord, n in per_rank.items():
                out[coord] += n
    return out


class P(tuple):
    """A partition spec, as ``jax.sharding.PartitionSpec``: one entry per
    tensor dim, ``None`` (not split), an axis name, or a tuple of axis
    names (the dim split over their product, major first)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "PartitionSpec" + tuple.__repr__(self)


def _normalized(spec: P) -> P:
    """``spec`` without trailing ``None`` entries (the form GSPMD gives an
    array it lays out itself)."""
    entries = list(spec)
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def shard_slices(shape, mesh: Mesh, spec: P, coord) -> Tuple[slice, ...]:
    """The global index range rank ``coord`` holds of a ``shape`` tensor
    laid out by ``spec``: a dim split n ways in chunks of ceil(size / n),
    the rank's chunk numbered by :meth:`Mesh.axis_index`."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {tuple(shape)}")
    out = []
    for d, size in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        if entry is None:
            out.append(slice(0, size))
            continue
        n = math.prod(mesh.shape[a] for a in _axes(entry))
        chunk = -(-size // n)
        i = mesh.axis_index(coord, entry)
        out.append(slice(min(size, i * chunk), min(size, (i + 1) * chunk)))
    return tuple(out)


def on_device(device):
    """A context that makes ``device`` the current card (a no-op off CUDA),
    so a rank's kernels launch on its own card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is not None:
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


class Sharded:
    """A global tensor laid out over a mesh: ``shards`` (a numpy object
    array of the mesh's shape) holds each rank's tensor on its device.
    ``spec`` prints as JAX's ``array.sharding.spec``."""

    def __init__(self, mesh: Mesh, spec: P, shape, shards: np.ndarray):
        self.mesh = mesh
        self.spec = P(*spec)
        self.shape = tuple(int(s) for s in shape)
        self.shards = shards

    @property
    def dtype(self) -> torch.dtype:
        return self.shards.flat[0].dtype

    def shard(self, coord) -> torch.Tensor:
        return self.shards[tuple(coord)]

    def full(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (default: the first rank's),
        each region copied from the first rank that holds it."""
        device = torch.device(device if device is not None else self.mesh.devices.flat[0])
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        seen = set()
        for coord in self.mesh.coords():
            sl = shard_slices(self.shape, self.mesh, self.spec, coord)
            key = tuple((s.start, s.stop) for s in sl)
            if key not in seen:
                seen.add(key)
                out[sl].copy_(self.shards[coord], non_blocking=device.type == "cuda")
        return out

    def __repr__(self):
        return (f"Sharded(shape={self.shape}, dtype={self.dtype}, spec={self.spec}, "
                f"mesh={dict(self.mesh.shape)})")


def global_tensor(x) -> torch.Tensor:
    """``x`` (a tensor, a numpy array or a :class:`Sharded`) as one tensor."""
    if isinstance(x, Sharded):
        return x.full()
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def pad_to(x: torch.Tensor, shape, value=0) -> torch.Tensor:
    """``x`` padded with ``value`` at the end of each dim to ``shape`` (``x``
    itself where it has that shape already)."""
    if tuple(x.shape) == tuple(shape):
        return x
    out = torch.full(tuple(shape), value, dtype=x.dtype, device=x.device)
    out[tuple(slice(0, s) for s in x.shape)] = x
    return out


def device_put(x, mesh: Mesh, spec: P) -> Sharded:
    """``x`` (a tensor, a numpy array or a :class:`Sharded`) laid out over
    ``mesh`` by ``spec``: each rank gets a copy of its range on its device
    (a range replicated over an axis the spec does not name goes to every
    rank along it).  A :class:`Sharded` already laid out so comes back as
    it is; one laid out otherwise is resharded through its global tensor,
    as ``shard_map`` reshards an input whose sharding is not its spec."""
    spec = P(*spec)
    if (isinstance(x, Sharded) and x.mesh is mesh
            and _normalized(x.spec) == _normalized(spec)):
        return x
    t = global_tensor(x)
    shards = rank_array(mesh)
    for coord in mesh.coords():
        part = t[shard_slices(t.shape, mesh, spec, coord)]
        buf = torch.empty(part.shape, dtype=t.dtype, device=mesh.devices[coord])
        shards[coord] = buf.copy_(part, non_blocking=True)
    return Sharded(mesh, spec, t.shape, shards)


def rank_array(mesh: Mesh) -> np.ndarray:
    """An empty object array of the mesh's shape: a slot for each rank's
    tensor."""
    return np.empty(mesh.devices.shape, dtype=object)


def _record(tag: str, dst, src, nbytes: int) -> None:
    if dst != src:
        per_rank = BYTES.setdefault(tag, {})
        per_rank[dst] = per_rank.get(dst, 0) + nbytes


def _send(x: torch.Tensor, mesh: Mesh, src, dst, tag: str) -> torch.Tensor:
    """A copy of rank ``src``'s ``x`` in a new buffer of rank ``dst``."""
    buf = torch.empty(x.shape, dtype=x.dtype, device=mesh.devices[dst])
    buf.copy_(x, non_blocking=True)
    _record(tag, dst, src, x.numel() * x.element_size())
    return buf


def _all_gather(x, mesh, axis, dim, tiled, tag):
    out = rank_array(mesh)
    for group in mesh.groups(axis):
        parts = [x[c] for c in group]
        shape = list(parts[0].shape)
        if tiled:
            shape[dim] = sum(p.shape[dim] for p in parts)
        else:
            shape.insert(dim, len(parts))
        for dst in group:
            buf = torch.empty(shape, dtype=parts[0].dtype, device=mesh.devices[dst])
            off = 0
            for src, p in zip(group, parts):
                if tiled:
                    view = buf.narrow(dim, off, p.shape[dim])
                    off += p.shape[dim]
                else:
                    view = buf.select(dim, off)
                    off += 1
                view.copy_(p, non_blocking=True)
                _record(tag, dst, src, p.numel() * p.element_size())
            out[dst] = buf
    return out


def _all_gather_adjoint(g, x_like, mesh, axis, dim, tiled, tag):
    """The reduce-scatter back to the source ranks: rank ``src`` gets the sum,
    over its group in order, of every rank's cotangent slice that holds its
    part (sent from each other rank to ``src``)."""
    out = rank_array(mesh)
    for group in mesh.groups(axis):
        off = 0
        for src in group:
            width = x_like[src].shape[dim] if tiled else 1
            acc = None
            for dst in group:
                part = (g[dst].narrow(dim, off, width) if tiled
                        else g[dst].select(dim, off))
                if dst != src:
                    part = _send(part, mesh, dst, src, tag)
                acc = part.clone() if acc is None else acc.add_(part)
            out[src] = acc
            off += width
    return out


def _psum(x, mesh, axis, tag):
    out = rank_array(mesh)
    for group in mesh.groups(axis):
        g = len(group)
        if g == 1:
            out[group[0]] = x[group[0]]
            continue
        work = [x[c].clone().reshape(-1) for c in group]
        bounds = np.linspace(0, work[0].numel(), g + 1).round().astype(int)

        def chunk(r, ci):
            return work[r][bounds[ci]:bounds[ci + 1]]

        for s in range(g - 1):  # reduce-scatter: rank r ends with chunk r + 1 summed
            for r in range(g):
                ci, nxt = (r - s) % g, (r + 1) % g
                recv = _send(chunk(r, ci), mesh, group[r], group[nxt], tag)
                chunk(nxt, ci).add_(recv)
        for s in range(g - 1):  # all-gather of the summed chunks
            for r in range(g):
                ci, nxt = (r + 1 - s) % g, (r + 1) % g
                src = chunk(r, ci)
                chunk(nxt, ci).copy_(src, non_blocking=True)
                _record(tag, group[nxt], group[r], src.numel() * src.element_size())
        for r, c in enumerate(group):
            out[c] = work[r].reshape(x[c].shape)
    return out


def _ppermute(x, zeros, mesh, axes, perm, tag):
    """Rank ``dst`` of each pair gets rank ``src``'s ``x``; every other rank
    ``zeros(coord)``."""
    out = rank_array(mesh)
    for group in mesh.groups(axes):
        for s, d in perm:
            src, dst = group[s], group[d]
            out[dst] = x[src] if src == dst else _send(x[src], mesh, src, dst, tag)
        for c in group:
            if out[c] is None:
                out[c] = zeros(c)
    return out


def _all_to_all(x, mesh, axis, split_dim, concat_dim, tiled, tag):
    out = rank_array(mesh)
    for group in mesh.groups(axis):
        n = len(group)
        size = x[group[0]].shape[split_dim]
        if (size % n) if tiled else (size != n):
            raise ValueError(f"all_to_all: dim {split_dim} of size {size} over "
                             f"{n} ranks ({'tiled' if tiled else 'untiled'})")
        for j, dst in enumerate(group):
            parts = []
            for src in group:
                part = (x[src].narrow(split_dim, j * (size // n), size // n) if tiled
                        else x[src].select(split_dim, j))
                parts.append(part if src == dst else _send(part, mesh, src, dst, tag))
            out[dst] = torch.cat(parts, concat_dim) if tiled else torch.stack(parts, concat_dim)
    return out


class _Like:
    """A tensor's shape, type and device, without its storage."""

    def __init__(self, t: torch.Tensor):
        self.shape, self.dtype, self.device = tuple(t.shape), t.dtype, t.device

    def zeros(self) -> torch.Tensor:
        return torch.zeros(self.shape, dtype=self.dtype, device=self.device)


def _zeros_for(g, like):
    """``g`` with each missing (None) cotangent as zeros shaped like ``like``."""
    out = np.empty(g.shape, dtype=object)
    for c in np.ndindex(g.shape):
        out[c] = like[c].zeros() if g[c] is None else g[c]
    return out


class _Collective(torch.autograd.Function):
    """A collective over every rank's tensor at once, differentiable: the
    backward is the adjoint of the copies the forward made (``adjoint``,
    counted under the forward's tag + ``"_bwd"``), so gradients are those of
    the global function of the per-rank tensors.  Integer tensors pass
    through without gradients."""

    @staticmethod
    def forward(ctx, fwd, adjoint, mesh, *flat):
        out = fwd(_unflat(flat, mesh))
        ctx.adjoint, ctx.mesh = adjoint, mesh
        ctx.x_like = _unflat([_Like(t) for t in flat], mesh)
        ctx.out_like = _unflat([_Like(out[c]) for c in mesh.coords()], mesh)
        ctx.set_materialize_grads(False)
        return tuple(out[c] for c in mesh.coords())

    @staticmethod
    def backward(ctx, *grads):
        mesh = ctx.mesh
        gx = ctx.adjoint(_zeros_for(_unflat(grads, mesh), ctx.out_like), ctx.x_like)
        return (None, None, None) + tuple(
            gx[c] if ctx.x_like[c].dtype.is_floating_point else None
            for c in mesh.coords())


def _unflat(flat, mesh: Mesh) -> np.ndarray:
    out = rank_array(mesh)
    for c, t in zip(mesh.coords(), flat):
        out[c] = t
    return out


def _apply(fwd, adjoint, x: np.ndarray, mesh: Mesh) -> np.ndarray:
    return _unflat(_Collective.apply(fwd, adjoint, mesh, *(x[c] for c in mesh.coords())),
                   mesh)


def all_gather(x: np.ndarray, mesh: Mesh, axis, *, dim: int, tiled: bool = True,
               tag: str = "all_gather") -> np.ndarray:
    """``jax.lax.all_gather(x, axis, axis=dim, tiled=tiled)`` on every rank:
    each rank of a group over ``axis`` (a name, or a tuple major first) gets
    the group's tensors in :meth:`Mesh.axis_index` order, concatenated
    along ``dim`` (``tiled``) or stacked at ``dim``.  Differentiable: the
    backward reduce-scatters the cotangents back to the source ranks."""
    return _apply(
        lambda t: _all_gather(t, mesh, axis, dim, tiled, tag),
        lambda g, like: _all_gather_adjoint(g, like, mesh, axis, dim, tiled, tag + "_bwd"),
        x, mesh)


def psum(x: np.ndarray, mesh: Mesh, axis, *, tag: str = "psum") -> np.ndarray:
    """``jax.lax.psum(x, axis)`` on every rank, as a ring reduce-scatter
    then a ring all-gather over each group: g - 1 steps each, every rank
    sending one of g chunks a step to the next rank of the ring, so each
    rank receives 2 (g - 1) / g of its tensor.  Differentiable: every
    contributor's gradient is the sum of its group's cotangents (a psum of
    them)."""
    return _apply(lambda t: _psum(t, mesh, axis, tag),
                  lambda g, like: _psum(g, mesh, axis, tag + "_bwd"), x, mesh)


def ppermute(x: np.ndarray, mesh: Mesh, axes, perm, *,
             tag: str = "ppermute") -> np.ndarray:
    """``jax.lax.ppermute(x, axes, perm)`` on every rank: within each group
    over ``axes``, rank ``dst`` of each ``(src, dst)`` pair (indices over
    ``axes`` major first, ``i * p + j`` for two axes) gets rank ``src``'s
    tensor; a rank no pair names gets zeros.  Differentiable: the backward
    is the inverse permutation of the cotangents (zeros to a rank that sent
    nothing)."""
    perm = [tuple(p) for p in perm]
    inverse = [(d, s) for s, d in perm]
    return _apply(lambda t: _ppermute(t, lambda c: torch.zeros_like(t[c]), mesh, axes, perm, tag),
                  lambda g, like: _ppermute(g, lambda c: like[c].zeros(), mesh, axes, inverse,
                                            tag + "_bwd"),
                  x, mesh)


def all_to_all(x: np.ndarray, mesh: Mesh, axis, split_dim: int, concat_dim: int, *,
               tiled: bool = False, tag: str = "all_to_all") -> np.ndarray:
    """``jax.lax.all_to_all(x, axis, split_dim, concat_dim, tiled=tiled)`` on
    every rank: rank j of a group gets chunk j of every rank's ``x`` along
    ``split_dim``, in rank order along ``concat_dim``.  Untiled, dim
    ``split_dim`` must have the group's size and is replaced by a new dim of
    that size at ``concat_dim``; tiled, it is cut into equal chunks that are
    concatenated along ``concat_dim``.  Differentiable: the backward is the
    reverse ``all_to_all`` (the two dims swapped)."""
    return _apply(
        lambda t: _all_to_all(t, mesh, axis, split_dim, concat_dim, tiled, tag),
        lambda g, like: _all_to_all(g, mesh, axis, concat_dim, split_dim, tiled, tag + "_bwd"),
        x, mesh)


def rank_coords(mesh: Mesh) -> np.ndarray:
    """Each rank's coordinate, as an object array of the mesh's shape (for
    :func:`map_shards` callables that need their rank)."""
    out = rank_array(mesh)
    for coord in mesh.coords():
        out[coord] = coord
    return out


def map_shards(fn, *xs: np.ndarray, mesh: Mesh) -> np.ndarray:
    """``fn(*rank's tensors)`` on every rank, each on its own device."""
    out = rank_array(mesh)
    for coord in mesh.coords():
        with on_device(mesh.devices[coord]):
            out[coord] = fn(*(x[coord] for x in xs))
    return out

