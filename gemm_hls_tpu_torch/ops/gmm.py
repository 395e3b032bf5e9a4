"""The grouped (ragged) GEMM and its weight gradient: the wrappers of the
Hopper kernels that replace TPU kernels B16 and B17, and their plain
PyTorch versions.

Counterpart of ``gemm_hls_tpu/ops/pallas_grouped.py::grouped_mxu``:
out[rows(g)] = lhs[rows(g)] . rhs[g] over a contiguous row partition
given by ``group_sizes``, rows past ``sum(group_sizes)`` zero, with
``transpose_rhs`` reading each expert as (N, K) in place
(``csrc/grouped_wgmma.cu`` or ``csrc/grouped_gemm.cu`` by
:func:`grouped_route`).  Group g's rows are [min(S_g, M),
min(S_{g+1}, M)) with S the exclusive cumulative sizes: routing past M
drops the trailing rows (the documented semantics of ``grouped_matmul``;
ROADMAP C2 notes where the JAX schedule departs from it).

Counterpart of ``pallas_grouped.py::grouped_update_mxu`` (B17, the
gradient of the experts): out[g] = lhs[rows(g)]^T . gbar[rows(g)], (M, K)
and (M, N) in, (G, K, N) out, over the same clamped row spans; a group
with no rows gets a zero block, and rows outside every span reach no
output (``csrc/grouped_update_wgmma.cu`` or ``csrc/grouped_update.cu`` by
:func:`grouped_update_route`).

The kernels read the group ends on the card: the wrappers never move the
routing to the host (no ``.item()``, no ``.tolist()``), so a MoE step
runs without a host synchronisation.  A CUDA tensor launches the kernel
or raises; a CPU tensor runs the plain version, which multiplies each
group's rows in fp32 (and reads the sizes on the host).
"""

from __future__ import annotations

import torch

from gemm_hls_tpu_torch import _build

_KERNEL_DTYPES = (torch.bfloat16, torch.float16, torch.float32)


def _check(lhs, rhs, group_sizes, transpose_rhs):
    """The JAX kernel's checks; returns (M, K, N, G)."""
    m, k = lhs.shape
    num_groups = rhs.shape[0]
    if tuple(group_sizes.shape) != (num_groups,):
        raise ValueError(
            f"group_sizes {tuple(group_sizes.shape)} != ({num_groups},)")
    kb, n = (rhs.shape[2], rhs.shape[1]) if transpose_rhs else rhs.shape[1:]
    if kb != k:
        raise ValueError(f"contraction mismatch: {tuple(lhs.shape)} x "
                         f"{tuple(rhs.shape)}")
    return m, k, n, num_groups


def _kernel_operands(what, a, b, group_sizes, interpret):
    """The card-side checks of both wrappers (no interpreter, one device, a
    type some kernel takes); returns (a, b) promoted, exactly, to that
    type and contiguous."""
    if interpret:
        raise NotImplementedError(
            f"{what}: CUDA has no interpreter mode; pass CPU tensors for "
            "the plain version")
    for t in (b, group_sizes):
        if t.device != a.device:
            raise ValueError(f"operands on {a.device} and {t.device}")
    in_dtype = torch.promote_types(a.dtype, b.dtype)
    if in_dtype not in _KERNEL_DTYPES:
        raise NotImplementedError(
            f"{what}: no kernel takes {in_dtype} (bf16, fp16, fp32)")
    return a.to(in_dtype).contiguous(), b.to(in_dtype).contiguous()


def _vec(t: torch.Tensor, row: int) -> int:
    """1 if ``t``'s rows of ``row`` elements are whole 16-byte vectors at a
    16-byte aligned base (the mma.sync routes' cp.async loads, and what the
    engine routes' TMA maps describe)."""
    return int(t.data_ptr() % 16 == 0 and row * t.element_size() % 16 == 0)


def grouped_route(dtype, aligned: bool) -> str:
    """The kernel a B16 launch takes: ``"wgmma"`` (``csrc/grouped_wgmma.cu``:
    the Hopper tile engine, TMA and warp-specialised wgmma, one persistent
    block a SM) for bf16 / fp16 whose operands are ``aligned`` (16-byte
    bases, K and, without ``transpose_rhs``, N rows whole 16-byte units:
    what a TMA map describes); ``"mma.sync"`` (``csrc/grouped_gemm.cu``'s
    tensor-core tile) for the other bf16 / fp16 calls; ``"simt"`` (IEEE
    fp32 on the CUDA cores) for fp32.  M needs no threshold: the engine
    measured no slower than mma.sync from decode's 128 routed slots up
    (PERF.md §6).  Chosen by dtype and alignment, never by the group
    sizes (they live on the card), and never as a fallback: a kernel that
    fails to build or launch raises."""
    if dtype == torch.float32:
        return "simt"
    return "wgmma" if aligned else "mma.sync"


def grouped_update_route(dtype, aligned: bool) -> str:
    """The kernel a B17 launch takes: ``"wgmma"``
    (``csrc/grouped_update_wgmma.cu``: the Hopper tile engine, TMA and
    warp-specialised wgmma, one persistent block a SM) for bf16 / fp16
    whose operands are ``aligned`` (16-byte bases, K and N whole 16-byte
    units, at least one row: what a TMA map describes); ``"mma.sync"``
    (``csrc/grouped_update.cu``'s tensor-core blocks) for the other bf16 /
    fp16 calls; ``"simt"`` (IEEE fp32 on the CUDA cores) for fp32.  Chosen
    by dtype and alignment, never by the group sizes (they live on the
    card), and never as a fallback."""
    if dtype == torch.float32:
        return "simt"
    return "wgmma" if aligned else "mma.sync"


def group_ends(group_sizes, m: int) -> torch.Tensor:
    """Cumulative group ends clamped to [0, M], int32, on the sizes'
    device (no host round trip)."""
    return torch.cumsum(group_sizes.to(torch.int64), 0).clamp(0, m).to(torch.int32)


def grouped_mxu_plain(lhs, rhs, group_sizes, *, transpose_rhs=False,
                      out_dtype=None):
    """Plain version of ``grouped_mxu``: each group's rows times its expert,
    summed in fp32; the zero tail; rows clamped to [0, M)."""
    m, _, n, _ = _check(lhs, rhs, group_sizes, transpose_rhs)
    out = torch.zeros((m, n), dtype=torch.float32, device=lhs.device)
    start = 0
    for g, end in enumerate(group_ends(group_sizes, m).tolist()):
        if end > start:
            w = rhs[g].float()
            out[start:end] = lhs[start:end].float() @ (w.T if transpose_rhs else w)
        start = max(start, end)
    return out.to(out_dtype or torch.promote_types(lhs.dtype, rhs.dtype))


def grouped_mxu(lhs, rhs, group_sizes, *, transpose_rhs=False, out_dtype=None,
                interpret=None):
    """Ragged grouped matmul (kernel B16): (M, K) x (G, K, N) -> (M, N).

    ``group_sizes`` (G,) int partitions the M rows contiguously; row block
    g multiplies ``rhs[g]`` ((G, N, K) with ``transpose_rhs``, contracted
    over its last axis without a copy).  Rows past ``sum(group_sizes)``
    come back zero.  The output type is ``out_dtype`` (default: the
    promoted input type); the kernel takes operands of one type, so a
    mixed pair is promoted (exactly) first.  The kernel is
    :func:`grouped_route`'s, recorded as ``grouped_mxu.last_route``.
    """
    m, k, n, num_groups = _check(lhs, rhs, group_sizes, transpose_rhs)
    out_dtype = out_dtype or torch.promote_types(lhs.dtype, rhs.dtype)
    if lhs.device.type == "cpu":
        return grouped_mxu_plain(lhs, rhs, group_sizes,
                                 transpose_rhs=transpose_rhs,
                                 out_dtype=out_dtype)
    lhs, rhs = _kernel_operands("grouped_mxu", lhs, rhs, group_sizes, interpret)
    return _grouped_launch(lhs, rhs, group_sizes, m, k, n, num_groups,
                           bool(transpose_rhs), out_dtype)


def _grouped_launch(lhs, rhs, group_sizes, m, k, n, num_groups, trb, out_dtype,
                    route=None):
    """B16 on CUDA operands of one type, contiguous: ``grouped_route``'s
    kernel, or ``route`` where a comparison names one."""
    out = torch.empty((m, n), dtype=out_dtype, device=lhs.device)
    if m == 0 or n == 0:
        return out
    vec_a, vec_b = _vec(lhs, k), _vec(rhs, k if trb else n)
    route = route or grouped_route(lhs.dtype, bool(k and vec_a and vec_b))
    ends = group_ends(group_sizes, m)
    lib = _build.library()
    ptrs = (lhs.data_ptr(), rhs.data_ptr(), ends.data_ptr(), out.data_ptr())
    codes = (_build.dtype_code(lhs.dtype), _build.dtype_code(out_dtype))
    with torch.cuda.device(lhs.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "wgmma":
            rc = lib.grouped_wgmma(*ptrs, m, n, k, num_groups, int(trb), *codes,
                                   stream)
        else:
            rc = lib.grouped_gemm(*ptrs, m, n, k, num_groups, int(trb), *codes,
                                  vec_a, vec_b, stream)
    _build.check(rc, "grouped_mxu")
    grouped_mxu.launches += 1
    grouped_mxu.last_route = route
    return out


def _check_update(lhs, g, group_sizes, num_groups):
    """The JAX kernel's checks; returns (M, K, N)."""
    m, k = lhs.shape
    if g.ndim != 2 or g.shape[0] != m:
        raise ValueError(f"row mismatch: {tuple(lhs.shape)} x {tuple(g.shape)}")
    if tuple(group_sizes.shape) != (num_groups,):
        raise ValueError(
            f"group_sizes {tuple(group_sizes.shape)} != ({num_groups},)")
    return m, k, g.shape[1]


def grouped_update_mxu_plain(lhs, g, group_sizes, *, num_groups: int,
                             out_dtype=None):
    """Plain version of ``grouped_update_mxu``: each group's
    ``lhs[rows].T @ g[rows]`` in fp32, empty groups zero, rows clamped to
    [0, M)."""
    m, k, n = _check_update(lhs, g, group_sizes, num_groups)
    out = torch.zeros((num_groups, k, n), dtype=torch.float32, device=lhs.device)
    start = 0
    for grp, end in enumerate(group_ends(group_sizes, m).tolist()):
        if end > start:
            out[grp] = lhs[start:end].float().T @ g[start:end].float()
        start = max(start, end)
    return out.to(out_dtype or torch.promote_types(lhs.dtype, g.dtype))


def grouped_update_mxu(lhs, g, group_sizes, *, num_groups: int,
                       out_dtype=None, interpret=None):
    """Per-group outer-product GEMM (kernel B17): out[gg] =
    lhs[rows(gg)].T @ g[rows(gg)], (M, K) x (M, N) -> (G, K, N).

    The gradient of ``grouped_mxu``'s rhs.  ``group_sizes`` (G,) int
    partitions the rows as in ``grouped_mxu``; groups with no rows get
    zero blocks, and rows outside every group reach no output (a NaN there
    neither).  The output type is ``out_dtype`` (default: the promoted
    input type); a mixed pair is promoted (exactly) first.  The kernel is
    :func:`grouped_update_route`'s, recorded as
    ``grouped_update_mxu.last_route``.
    """
    m, k, n = _check_update(lhs, g, group_sizes, num_groups)
    out_dtype = out_dtype or torch.promote_types(lhs.dtype, g.dtype)
    if lhs.device.type == "cpu":
        return grouped_update_mxu_plain(lhs, g, group_sizes,
                                        num_groups=num_groups,
                                        out_dtype=out_dtype)
    lhs, g = _kernel_operands("grouped_update_mxu", lhs, g, group_sizes,
                              interpret)
    return _update_launch(lhs, g, group_sizes, m, k, n, num_groups, out_dtype)


def _update_launch(lhs, g, group_sizes, m, k, n, num_groups, out_dtype,
                   route=None):
    """B17 on CUDA operands of one type, contiguous:
    ``grouped_update_route``'s kernel, or ``route`` where a comparison
    names one."""
    out = torch.empty((num_groups, k, n), dtype=out_dtype, device=lhs.device)
    if out.numel() == 0:
        return out
    vec_a, vec_b = _vec(lhs, k), _vec(g, n)
    route = route or grouped_update_route(lhs.dtype, bool(m and vec_a and vec_b))
    ends = group_ends(group_sizes, m)
    lib = _build.library()
    ptrs = (lhs.data_ptr(), g.data_ptr(), ends.data_ptr(), out.data_ptr())
    codes = (_build.dtype_code(lhs.dtype), _build.dtype_code(out_dtype))
    with torch.cuda.device(lhs.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "wgmma":
            rc = lib.grouped_update_wgmma(*ptrs, m, k, n, num_groups, *codes, stream)
        else:
            rc = lib.grouped_update(*ptrs, m, k, n, num_groups, *codes, vec_a,
                                    vec_b, stream)
    _build.check(rc, "grouped_update_mxu")
    grouped_update_mxu.launches += 1
    grouped_update_mxu.last_route = route
    return out


# Kernel launches since the counts were last reset (plain calls not
# counted), and the route of B16's and of B17's last launch.
grouped_mxu.launches = 0
grouped_mxu.last_route = None
grouped_update_mxu.launches = 0
grouped_update_mxu.last_route = None
