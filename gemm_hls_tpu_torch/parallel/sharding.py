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
    shards = np.empty(mesh.devices.shape, dtype=object)
    for coord in mesh.coords():
        part = t[shard_slices(t.shape, mesh, spec, coord)]
        buf = torch.empty(part.shape, dtype=t.dtype, device=mesh.devices[coord])
        shards[coord] = buf.copy_(part, non_blocking=True)
    return Sharded(mesh, spec, t.shape, shards)


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


def all_gather(x: np.ndarray, mesh: Mesh, axis, *, dim: int, tiled: bool = True,
               tag: str = "all_gather") -> np.ndarray:
    """``jax.lax.all_gather(x, axis, axis=dim, tiled=tiled)`` on every rank:
    each rank of a group over ``axis`` (a name, or a tuple major first) gets
    the group's tensors in :meth:`Mesh.axis_index` order, concatenated
    along ``dim`` (``tiled``) or stacked at ``dim``."""
    out = np.empty(mesh.devices.shape, dtype=object)
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


def psum(x: np.ndarray, mesh: Mesh, axis, *, tag: str = "psum") -> np.ndarray:
    """``jax.lax.psum(x, axis)`` on every rank, as a ring reduce-scatter
    then a ring all-gather over each group: g - 1 steps each, every rank
    sending one of g chunks a step to the next rank of the ring, so each
    rank receives 2 (g - 1) / g of its tensor."""
    out = np.empty(mesh.devices.shape, dtype=object)
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


def ppermute(x: np.ndarray, mesh: Mesh, axes, perm, *,
             tag: str = "ppermute") -> np.ndarray:
    """``jax.lax.ppermute(x, axes, perm)`` on every rank: within each group
    over ``axes``, rank ``dst`` of each ``(src, dst)`` pair (indices over
    ``axes`` major first, ``i * p + j`` for two axes) gets rank ``src``'s
    tensor; a rank no pair names gets zeros."""
    out = np.empty(mesh.devices.shape, dtype=object)
    for group in mesh.groups(axes):
        for s, d in perm:
            src, dst = group[s], group[d]
            out[dst] = x[src] if src == dst else _send(x[src], mesh, src, dst, tag)
        for c in group:
            if out[c] is None:
                out[c] = torch.zeros_like(x[c])
    return out


def rank_coords(mesh: Mesh) -> np.ndarray:
    """Each rank's coordinate, as an object array of the mesh's shape (for
    :func:`map_shards` callables that need their rank)."""
    out = np.empty(mesh.devices.shape, dtype=object)
    for coord in mesh.coords():
        out[coord] = coord
    return out


def map_shards(fn, *xs: np.ndarray, mesh: Mesh) -> np.ndarray:
    """``fn(*rank's tensors)`` on every rank, each on its own device."""
    out = np.empty(mesh.devices.shape, dtype=object)
    for coord in mesh.coords():
        with on_device(mesh.devices[coord]):
            out[coord] = fn(*(x[coord] for x in xs))
    return out

