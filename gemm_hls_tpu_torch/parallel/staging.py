"""Out-of-device-memory GEMM with host-memory tile staging: the port of
``gemm_hls_tpu/parallel/staging.py``.

The communication-avoiding memory tile one level up the hierarchy: device
memory is the fast memory and host memory (or disk) the slow one.  C is
computed one host tile at a time; each (tile_m, tile_n) C tile stays on the
card while K streams in tile_k panels of A and B, so the host -> device
traffic follows the CA law ``M*N*(1 + K/tile_n + K/tile_m)`` words
(``src/PrintSpecifications.cpp:72-75``).

On the card a panel travels through a ring of pinned host buffers: the
host copies the strided panel into a pinned slot (on a worker thread,
while the card computes the previous panel), the slot goes host -> device
on a copy stream, and the compute stream waits on the slot's copy event
before its GEMM reads it.  A slot is refilled only after the event of the
GEMM that read it.  Each finished C tile comes back through a pinned
buffer before it is scattered into the host output.  Panel products run
with the accumulator as their output type (kernel B1's engine route with
fp32 output for bf16 panels; B3 for the other semirings), and the
cross-panel sums stay in the accumulator type on the card.  On the CPU the
same schedule runs the plain versions.

:func:`distributed_streamed_matmul` runs the same schedule with each panel
product over a mesh of ranks (the distributed CA-GEMM of
``parallel/dispatch.py`` / ``parallel/grid25d.py``).
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from gemm_hls_tpu_torch.config import (
    GemmConfig, cdiv, default_config, dtype_name, torch_dtype,
)
from gemm_hls_tpu_torch.ops import mxu
from gemm_hls_tpu_torch.ops.matmul import matmul
from gemm_hls_tpu_torch.ops.semiring import get_semiring

# Panels staged ahead of the one being computed when prefetching (classic
# double buffering: one panel computing, one staging); a card's ring holds
# PREFETCH_DEPTH + 1 pinned slots.
PREFETCH_DEPTH = 2


def _device(device) -> torch.device:
    """``device`` (default: the current card) with its index resolved."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _device_bytes_limit(device) -> int:
    """Device memory in bytes: the card's total memory, or the reference's
    16 GiB where there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return int(torch.cuda.mem_get_info(dev)[1])
    return 16 * 1024**3


def _prefetch_fits(panel_bytes: int, acc_bytes: int, device,
                   depth: int = 2) -> bool:
    """Whether prefetched staging fits the device memory budget.

    Prefetch keeps up to ``depth`` staged panel pairs on the device *in
    addition to* the pair being consumed and the accumulator, about
    ``(depth + 1) x`` the sequential path's panels.  These paths exist for
    problems near or over device memory, so a workload that fits under
    sequential staging must not run out of memory because prefetch tripled
    its panels: staging falls back to sequential when the prefetched
    residency would exceed 60% of device memory.
    """
    resident = (depth + 1) * panel_bytes + acc_bytes
    return resident <= 0.6 * _device_bytes_limit(device)


def _prefetched(jobs, stage, *, depth: int = 2, enabled: bool = True):
    """Yield ``(job, stage(job))`` with up to ``depth`` stages in flight.

    The staging callable (the host slice or disk read, then the copy to the
    card) runs on a worker thread while the consumer's device work is in
    flight: buffer s + 1 fills while buffer s drains (the PE's A double
    buffer, ``kernel/Compute.cpp:19-26``).  Callers gate ``enabled``
    through :func:`_prefetch_fits`.
    """
    jobs = list(jobs)
    if not enabled or len(jobs) <= 1:
        for job in jobs:
            yield job, stage(job)
        return
    with ThreadPoolExecutor(max_workers=1) as pool:
        inflight = deque()
        for job in jobs[:depth]:
            inflight.append((job, pool.submit(stage, job)))
        next_i = depth
        while inflight:
            job, fut = inflight.popleft()
            yield job, fut.result()
            if next_i < len(jobs):
                inflight.append((jobs[next_i], pool.submit(stage,
                                                           jobs[next_i])))
                next_i += 1


class _Slot:
    """Pinned host buffers and device buffers for one job's panels, the
    event of their host -> device copy and of the GEMM that read them."""

    def __init__(self, device, dtype, sizes):
        self.host = [torch.empty(n, dtype=dtype, pin_memory=True) for n in sizes]
        self.dev = [torch.empty(n, dtype=dtype, device=device) for n in sizes]
        self.copied = torch.cuda.Event()
        self.read = torch.cuda.Event()


class _Stager:
    """Host panels to the device: on a card through a ring of ``slots``
    :class:`_Slot`s and a copy stream, on the CPU as contiguous copies.
    ``h2d_bytes`` counts the panels' bytes either way, ``fill_s`` the host
    seconds spent copying them into place."""

    def __init__(self, device, dtype, sizes, slots):
        self.device, self.dtype = device, dtype
        self.h2d_bytes = 0
        self.fill_s = 0.0
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.copy_stream = torch.cuda.Stream(device)
            self.ring = [_Slot(device, dtype, sizes) for _ in range(slots)]
            self.next = 0

    def stage(self, shapes, fills):
        """Fill each panel of ``shapes`` on the host (``fill(view)`` writes
        it into a C-contiguous CPU tensor) and send it to the device;
        returns (slot, device panels)."""
        t0 = time.perf_counter()
        if not self.cuda:
            panels = [torch.empty(shape, dtype=self.dtype) for shape in shapes]
            for panel, fill in zip(panels, fills):
                fill(panel)
            self.fill_s += time.perf_counter() - t0
            self.h2d_bytes += sum(x.numel() * x.element_size() for x in panels)
            return None, panels
        slot = self.ring[self.next % len(self.ring)]
        self.next += 1
        slot.copied.synchronize()  # the slot's last copy has read its host buffers
        t0 = time.perf_counter()
        pairs = []
        for host, dev, (rows, cols), fill in zip(slot.host, slot.dev, shapes, fills):
            h = host[:rows * cols].view(rows, cols)
            fill(h)
            pairs.append((h, dev[:rows * cols].view(rows, cols)))
        self.fill_s += time.perf_counter() - t0
        with torch.cuda.stream(self.copy_stream):
            self.copy_stream.wait_event(slot.read)  # the GEMM that read them is done
            for h, d in pairs:
                d.copy_(h, non_blocking=True)
            slot.copied.record(self.copy_stream)
        self.h2d_bytes += sum(h.numel() * h.element_size() for h, _ in pairs)
        return slot, [d for _, d in pairs]

    def consume(self, slot):
        """Before the first kernel that reads ``slot``'s panels."""
        if slot is not None:
            torch.cuda.current_stream(self.device).wait_event(slot.copied)

    def release(self, slot):
        """After the last kernel that reads ``slot``'s panels is enqueued."""
        if slot is not None:
            slot.read.record(torch.cuda.current_stream(self.device))


class _Drain:
    """C tiles device -> host: on a card through two pinned buffers, each
    tile's scatter into the host output deferred until its buffer is
    needed again, so it overlaps the next tile's GEMMs.  ``drain_s``: host
    seconds waiting for the copies and scattering."""

    def __init__(self, device, dtype, elems):
        self.d2h_bytes = 0
        self.drain_s = 0.0
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.bufs = [torch.empty(elems, dtype=dtype, pin_memory=True) for _ in range(2)]
            self.events = [torch.cuda.Event() for _ in range(2)]
            self.pending = [None, None]
            self.n = 0

    def put(self, tile, sink):
        """Hand the device tile ``tile`` to ``sink(host_tensor)``."""
        self.d2h_bytes += tile.numel() * tile.element_size()
        if not self.cuda:
            t0 = time.perf_counter()
            sink(tile)
            self.drain_s += time.perf_counter() - t0
            return
        i = self.n % 2
        self.n += 1
        self._finish(i)
        h = self.bufs[i][:tile.numel()].view(tile.shape)
        h.copy_(tile, non_blocking=True)
        self.events[i].record()
        self.pending[i] = (h, sink)

    def _finish(self, i):
        if self.pending[i] is not None:
            t0 = time.perf_counter()
            h, sink = self.pending[i]
            self.pending[i] = None
            self.events[i].synchronize()
            sink(h)
            self.drain_s += time.perf_counter() - t0

    def close(self):
        if self.cuda:
            for i in (self.n % 2, (self.n + 1) % 2):  # the older tile first
                self._finish(i)


def _local_product(sr, config: GemmConfig):
    """Each panel product on the device's front door (kernel B1 for
    plus_times, with the accumulator as its output type; B3 for the other
    semirings); returns (partial, the kernel route, None on the CPU)."""
    cfg_acc = config.replace(out_dtype=dtype_name(config.tacc_dtype))

    def product(a_panel, b_panel):
        partial = matmul(a_panel, b_panel, semiring=sr, config=cfg_acc)
        if not a_panel.is_cuda:
            return partial, None
        return partial, (mxu.mxu_matmul.last_route if sr.is_mxu else "semiring_gemm")
    return product


def _stream(m, n, k, *, sr, acc_dtype, product, tile_m, tile_n, tile_k,
            in_dtype, out_dtype, device, prefetch, fill_a, fill_b, sink):
    """The staged schedule shared by the in-memory, the file and the
    distributed GEMMs: ``product(a_panel, b_panel)`` returns a panel's
    partial on ``device`` in ``acc_dtype`` and the routes its kernels took.
    Returns what the schedule moved, each panel's routes and where the
    host's time went (``last_stats``: ``stage_wait_s`` is the compute
    thread's wait for staged panels)."""
    ident = sr.identity_for(acc_dtype)
    kp = cdiv(k, tile_k)
    jobs = [(i0, j0, kk)
            for i0 in range(0, m, tile_m)
            for j0 in range(0, n, tile_n)
            for kk in range(kp)]
    tm, tn, tk = min(tile_m, m), min(tile_n, n), min(tile_k, k)
    panel_bytes = (tm + tn) * tk * in_dtype.itemsize
    acc_bytes = tm * tn * acc_dtype.itemsize
    depth = PREFETCH_DEPTH
    prefetch = prefetch and _prefetch_fits(panel_bytes, acc_bytes, device, depth)
    slots = depth + 1 if prefetch else 1
    stager = _Stager(device, in_dtype, (tm * tk, tk * tn), slots)
    drain = _Drain(device, out_dtype, tm * tn)

    def stage(job):
        i0, j0, kk = job
        i1, j1 = min(m, i0 + tile_m), min(n, j0 + tile_n)
        k0, k1 = kk * tile_k, min(k, (kk + 1) * tile_k)
        return stager.stage(((i1 - i0, k1 - k0), (k1 - k0, j1 - j0)),
                            (lambda h: fill_a(h, i0, i1, k0, k1),
                             lambda h: fill_b(h, k0, k1, j0, j1)))

    routes = []
    wait_s = 0.0
    ctx = torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
    with ctx:
        acc = None
        t_next = time.perf_counter()
        for (i0, j0, kk), (slot, (a_panel, b_panel)) in _prefetched(
                jobs, stage, depth=depth, enabled=prefetch):
            wait_s += time.perf_counter() - t_next
            i1, j1 = min(m, i0 + tile_m), min(n, j0 + tile_n)
            stager.consume(slot)
            if kk == 0:
                acc = torch.full((i1 - i0, j1 - j0), ident, dtype=acc_dtype,
                                 device=device)
            partial, route = product(a_panel, b_panel)
            stager.release(slot)
            if route is not None:
                routes.append(route)
            acc = sr.reduce_op(acc, partial)
            if kk == kp - 1:
                drain.put(acc if acc.dtype == out_dtype else acc.to(out_dtype),
                          lambda h, i0=i0, i1=i1, j0=j0, j1=j1: sink(h, i0, i1, j0, j1))
            t_next = time.perf_counter()
        drain.close()
    return {"jobs": len(jobs), "prefetch": prefetch, "slots": slots,
            "h2d_bytes": stager.h2d_bytes, "d2h_bytes": drain.d2h_bytes,
            "routes": routes, "fill_s": stager.fill_s, "stage_wait_s": wait_s,
            "drain_s": drain.drain_s}


def _torch_dtype(d) -> torch.dtype:
    """A torch dtype from a torch dtype, a name or a numpy dtype."""
    return torch_dtype(d if isinstance(d, (torch.dtype, str)) else np.dtype(d).name)


def _host_tensor(x) -> torch.Tensor:
    """A host operand as a CPU tensor sharing its memory."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(f"host operands (numpy arrays or CPU tensors) are "
                             f"staged; got a tensor on {x.device}")
        return x
    return torch.from_numpy(np.asarray(x))


def streamed_matmul_files(a_file, b_file, c_file, *, semiring="plus_times",
                          config: Optional[GemmConfig] = None,
                          tile_m: int = 8192, tile_n: int = 8192,
                          tile_k: int = 8192, device=None,
                          prefetch: bool = True) -> None:
    """Disk-resident GEMM: operands and result live in files
    (``utils.tileio.MatrixFile``), streamed disk -> host -> device per
    tile, each panel read straight into a pinned staging slot.  With
    ``prefetch`` (default) the next panel's disk read and copy overlap the
    current panel's device compute, ``PREFETCH_DEPTH`` panels ahead.

    Args:
      a_file: MatrixFile (M, K); b_file: MatrixFile (K, N);
      c_file: writable MatrixFile (M, N).
      device: where the products run (default: the current card; "cpu"
        runs the plain versions).

    What the call moved and which kernels ran are left in
    ``streamed_matmul_files.last_stats``.
    """
    sr = get_semiring(semiring)
    m, k = a_file.shape
    k2, n = b_file.shape
    if k != k2 or c_file.shape != (m, n):
        raise ValueError(f"shape mismatch: {a_file.shape} x {b_file.shape} "
                         f"-> {c_file.shape}")
    in_dtype = _torch_dtype(a_file.dtype)
    if config is None:
        config = default_config(in_dtype, semiring=sr.name)

    def read(f):
        return lambda h, r0, r1, c0, c1: f.read_tile(r0, r1, c0, c1, out=h.numpy())

    streamed_matmul_files.last_stats = _stream(
        m, n, k, sr=sr, acc_dtype=config.tacc_dtype,
        product=_local_product(sr, config), tile_m=tile_m, tile_n=tile_n,
        tile_k=tile_k, in_dtype=in_dtype, out_dtype=_torch_dtype(c_file.dtype),
        device=_device(device), prefetch=prefetch,
        fill_a=read(a_file), fill_b=read(b_file),
        sink=lambda h, i0, i1, j0, j1: c_file.write_tile(i0, j0, h.numpy()))


def streamed_matmul(a, b, *, semiring="plus_times",
                    config: Optional[GemmConfig] = None,
                    tile_m: int = 8192, tile_n: int = 8192,
                    tile_k: int = 8192, out_dtype=None,
                    device=None, prefetch: bool = True):
    """C = A . B for problems larger than device memory; A, B and C live in
    host memory.

    Args:
      a: (M, K) numpy array or CPU tensor (a CPU tensor for bf16, which
        numpy lacks); b: (K, N), the same kind.  The result comes back as
        the same kind, in ``out_dtype`` (default: a's type).
      tile_m/tile_n/tile_k: host-tile sizes, the outer memory tile at the
        device level (each (tile_m, tile_n) C tile stays on the device
        while K streams in tile_k panels).
      device: where the products run (default: the current card; "cpu"
        runs the plain versions).
      prefetch: overlap the next panel's host slice and copy with the
        current panel's compute, ``PREFETCH_DEPTH`` panels ahead (a ring
        of ``PREFETCH_DEPTH + 1`` pinned slots on a card).

    What the call moved and which kernels ran are left in
    ``streamed_matmul.last_stats``.
    """
    sr = get_semiring(semiring)
    at, bt = _host_tensor(a), _host_tensor(b)
    if config is None:
        config = default_config(at.dtype, semiring=sr.name)
    out, streamed_matmul.last_stats = _stream_host(
        at, bt, as_numpy=not isinstance(a, torch.Tensor), out_dtype=out_dtype,
        sr=sr, acc_dtype=config.tacc_dtype, product=_local_product(sr, config),
        tile_m=tile_m, tile_n=tile_n, tile_k=tile_k, device=_device(device),
        prefetch=prefetch)
    return out


def _stream_host(at, bt, *, as_numpy, out_dtype, **schedule):
    """:func:`_stream` over host operands (CPU tensors): the result in
    ``out_dtype`` (default: A's type) as a CPU tensor, or as a numpy array
    where the caller passed numpy (``as_numpy``); returns (result,
    ``last_stats``)."""
    m, k = at.shape
    k2, n = bt.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: {tuple(at.shape)} x "
                         f"{tuple(bt.shape)}")
    out_dt = at.dtype if out_dtype is None else _torch_dtype(out_dtype)
    if as_numpy and out_dt == torch.bfloat16:
        raise ValueError("numpy has no bfloat16: pass CPU tensors for a "
                         "bfloat16 result")
    out = torch.empty((m, n), dtype=out_dt)

    def panel(src):
        return lambda h, r0, r1, c0, c1: h.copy_(src[r0:r1, c0:c1])

    def sink(h, i0, i1, j0, j1):
        out[i0:i1, j0:j1].copy_(h)

    stats = _stream(m, n, k, in_dtype=at.dtype, out_dtype=out_dt,
                    fill_a=panel(at), fill_b=panel(bt), sink=sink, **schedule)
    return (out.numpy() if as_numpy else out), stats


def distributed_streamed_matmul(a, b, mesh, *, semiring="plus_times",
                                config: Optional[GemmConfig] = None,
                                tile_m: int = 16384, tile_n: int = 16384,
                                tile_k: int = 16384, algorithm: str = "summa",
                                out_dtype=None):
    """Out-of-device-memory GEMM over a mesh of ranks: host memory holds the
    problem, and each stationary C host tile is computed by the distributed
    CA-GEMM (``algorithm`` "summa": ``distributed_matmul``, or "25d":
    ``matmul_25d`` on a (z, x, y) mesh).

    The schedule is :func:`streamed_matmul`'s: each K panel goes host -> the
    first rank's device through the pinned slot ring, prefetched where it
    fits, the panel product spreads it over the ranks and brings the
    partial back to that device in the accumulator type, where the
    cross-panel partials accumulate (one rounding per panel in the input
    type would breach bf16's 1e-3 contract); the cast to ``out_dtype``
    happens once per C tile, on its way to host memory.  Ragged remainder
    panels are padded to the mesh (K with the semiring's absorbing pair).

    Args:
      a: (M, K) numpy array or CPU tensor (a CPU tensor for bf16); b:
        (K, N), the same kind.  The result comes back as the same kind, in
        ``out_dtype`` (default: a's type).

    What the call moved is left in ``distributed_streamed_matmul.last_stats``
    (its ``routes``: each panel's {rank: [route]} where the ranks are on a
    card).
    """
    import math

    from gemm_hls_tpu_torch.config import round_up
    from gemm_hls_tpu_torch.parallel.dispatch import _pad_for_mesh, distributed_matmul
    from gemm_hls_tpu_torch.parallel.grid25d import matmul_25d
    from gemm_hls_tpu_torch.parallel.summa import summa_matmul

    sr = get_semiring(semiring)
    at, bt = _host_tensor(a), _host_tensor(b)
    acc_dt = (config or default_config(at.dtype, semiring=sr.name)).tacc_dtype
    home = _device(mesh.devices.flat[0])

    if algorithm == "summa":
        def product(ap, bp):
            res = distributed_matmul(ap, bp, mesh, algorithm="summa", semiring=sr,
                                     config=config, out_dtype=acc_dt)
            return res.full(home), dict(summa_matmul.last_routes) or None
    elif algorithm == "25d":
        cz, px, py = mesh.shape["z"], mesh.shape["x"], mesh.shape["y"]

        def product(ap, bp):
            mp_, kp_ = ap.shape
            np_ = bp.shape[1]
            # K split c * px ways for B and c * py ways for A.
            kpad = round_up(kp_, cz * px * py // math.gcd(px, py))
            ap, bp = _pad_for_mesh(ap, bp, sr, round_up(mp_, px), kpad, round_up(np_, py))
            res = matmul_25d(ap, bp, mesh, semiring=sr, config=config, out_dtype=acc_dt)
            return res.full(home)[:mp_, :np_], dict(matmul_25d.last_routes) or None
    else:
        raise ValueError(f"unknown algorithm {algorithm!r}")

    out, distributed_streamed_matmul.last_stats = _stream_host(
        at, bt, as_numpy=not isinstance(a, torch.Tensor), out_dtype=out_dtype,
        sr=sr, acc_dtype=acc_dt, product=product, tile_m=tile_m, tile_n=tile_n,
        tile_k=tile_k, device=home, prefetch=True)
    return out


def streamed_ozaki_matmul(a: np.ndarray, b: np.ndarray, *,
                          tile_m: int = 4096, tile_n: int = 4096,
                          tile_k: int = 16384,
                          target_rel: float = 1e-14, device=None) -> np.ndarray:
    """f64-class C = A . B for problems larger than device memory.

    The host-tile schedule of :func:`streamed_matmul`, each (tile_m,
    tile_n) x tile_k panel product through the fused Ozaki-int8 GEMM
    (``ops.ozaki.ozaki_matmul_int8``, kernel B5), so double-precision-class
    problems are bounded by host memory, not device memory.  Panel results
    are exact to ~1e-15 normwise; the cross-panel sum accumulates in host
    float64 (one rounding per panel).  ``device``: where the panels run
    (default: the card; "cpu" runs the plain versions).
    """
    from gemm_hls_tpu_torch.ops.ozaki import ozaki_matmul_int8

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: {a.shape} x {b.shape}")
    out = np.zeros((m, n), np.float64)
    for i0 in range(0, m, tile_m):
        i1 = min(m, i0 + tile_m)
        for j0 in range(0, n, tile_n):
            j1 = min(n, j0 + tile_n)
            for k0 in range(0, k, tile_k):
                k1 = min(k, k0 + tile_k)
                out[i0:i1, j0:j1] += ozaki_matmul_int8(
                    a[i0:i1, k0:k1], b[k0:k1, j0:j1],
                    target_rel=target_rel, device=device)
    return out


streamed_matmul.last_stats = None
streamed_matmul_files.last_stats = None
distributed_streamed_matmul.last_stats = None
