"""Device meshes: the ``make_mesh`` / ``mesh_25d`` of
``gemm_hls_tpu/parallel/mesh.py`` over torch devices.

A :class:`Mesh` is a plain array of ``torch.device`` with named axes, as
``jax.sharding.Mesh`` is one of JAX devices; a rank is a coordinate of that
array.  A device may repeat: ``[torch.device("cuda")] * 4`` is four ranks
that all live on one card, each with its own buffers, and ``["cpu"] * 4``
the same ranks on the CPU, where the kernels run their plain versions.

One process drives every rank.  The collective GEMMs (SUMMA, Cannon, 2.5D:
``parallel/summa.py``, ``parallel/grid25d.py``) move shards between ranks
as copies (``parallel/sharding.py``), on one card or between cards.  The
fused kernels B18 / B19 (``ops/ring.py``, ``ops/cannon.py``) run all their
ranks in one launch on one card and refuse ranks on distinct cards
(:func:`one_device`): that needs peer pointers and system-scope fences in
the kernels (ROADMAP A7).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """``devices``: a numpy object array of ``torch.device`` of the mesh's
    shape; ``axis_names``; ``shape``: axis name -> size, as
    ``jax.sharding.Mesh.shape``."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.array(devices, dtype=object)
        self.devices = np.array([torch.device(d) for d in arr.flat],
                                dtype=object).reshape(arr.shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{self.devices.ndim}-D device array")
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    def along(self, axis: str):
        """The devices along ``axis`` (at index 0 of every other axis)."""
        idx = self.axis_names.index(axis)
        return list(np.moveaxis(self.devices, idx, 0).reshape(self.shape[axis], -1)[:, 0])

    def coords(self):
        """Every rank's coordinate, in row-major order."""
        return list(np.ndindex(self.devices.shape))

    def axis_index(self, coord, axes) -> int:
        """The rank's index over ``axes`` (one axis name, or a tuple taken
        major first, as ``jax.lax.axis_index`` numbers a joint axis)."""
        idx = 0
        for name in _axes(axes):
            i = self.axis_names.index(name)
            idx = idx * self.devices.shape[i] + coord[i]
        return idx

    def groups(self, axes):
        """The ranks that a collective over ``axes`` joins: one list per
        coordinate of the other axes, each ordered by :meth:`axis_index`."""
        over = [self.axis_names.index(name) for name in _axes(axes)]
        rest = [i for i in range(self.devices.ndim) if i not in over]
        sizes = [self.devices.shape[i] for i in over]
        out = []
        for fixed in np.ndindex(*[self.devices.shape[i] for i in rest]):
            group = []
            for moving in np.ndindex(*sizes):
                coord = [0] * self.devices.ndim
                for i, v in zip(rest, fixed):
                    coord[i] = v
                for i, v in zip(over, moving):
                    coord[i] = v
                group.append(tuple(coord))
            out.append(group)
        return out


def _axes(axes) -> Tuple[str, ...]:
    """An axis name or a tuple of them, as a tuple."""
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _default_devices():
    """Every visible card; no CPU fallback."""
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device: pass devices=[...] (e.g. ['cpu'] * n "
                           "for the plain versions)")
    return [torch.device("cuda", i) for i in range(count)]


def _grid_2d(n: int) -> Tuple[int, int]:
    """Most-square (px, py) factorization of n."""
    best = (1, n)
    for px in range(1, int(math.isqrt(n)) + 1):
        if n % px == 0:
            best = (px, n // px)
    return best


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("x", "y"), devices=None) -> Mesh:
    """Build a mesh over ``devices`` (default: the visible cards).

    With no ``shape``, factors the device count into the most-square 2-D
    grid, as the JAX package does.
    """
    devices = list(devices if devices is not None else _default_devices())
    if shape is None:
        if len(axis_names) != 2:
            raise ValueError("auto shape only supported for 2 axes")
        shape = _grid_2d(len(devices))
    shape = tuple(shape)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh shape {shape} needs {n} devices, "
                         f"have {len(devices)}")
    return Mesh(np.array(devices[:n], dtype=object).reshape(shape), axis_names)


def mesh_25d(c: int = 2, axis_names: Sequence[str] = ("z", "x", "y"),
             devices=None) -> Mesh:
    """(z=c, x, y) mesh for the 2.5D decomposition: p = c * q^2 devices with
    replication factor c over the ``z`` axis."""
    devices = list(devices if devices is not None else _default_devices())
    p = len(devices)
    if p % c:
        raise ValueError(f"{p} devices not divisible by replication c={c}")
    q2 = p // c
    q = int(math.isqrt(q2))
    if q * q != q2:
        # Fall back to a rectangular (x, y) grid within each slice.
        px, py = _grid_2d(q2)
    else:
        px = py = q
    return Mesh(np.array(devices, dtype=object).reshape((c, px, py)), axis_names)


def one_device(devices) -> torch.device:
    """The one device every rank of ``devices`` lives on.

    Raises ValueError for ranks on both the CPU and CUDA, and
    NotImplementedError for ranks on two or more distinct cards (the
    multi-card transport, ROADMAP A7).  Decided from the device names
    alone: ``cuda`` (the current card) meets an explicit index only through
    ``torch.cuda.current_device()``.
    """
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("no devices")
    kinds = {d.type for d in devs}
    if len(kinds) > 1:
        raise ValueError(f"ranks on {sorted(kinds)}: a mesh mixes device kinds")
    if devs[0].type != "cuda":
        return devs[0]
    indices = {d.index for d in devs}
    named = indices - {None}
    if len(named) > 1:
        raise NotImplementedError(
            f"ranks on cards {sorted(named)}: ranks on distinct cards need the "
            "multi-card transport (peer pointers, system-scope fences, one launch "
            "per card: ROADMAP A7); put every rank on one card")
    if None in indices and named and named != {torch.cuda.current_device()}:
        raise NotImplementedError(
            f"ranks on the current card and on cuda:{named.pop()}: ranks on "
            "distinct cards need the multi-card transport (ROADMAP A7)")
    index = named.pop() if named else torch.cuda.current_device()
    return torch.device("cuda", index)
