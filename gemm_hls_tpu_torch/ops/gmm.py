"""The grouped (ragged) GEMM: the wrapper of the Hopper kernel that
replaces TPU kernel B16, and its plain PyTorch version.

Counterpart of ``gemm_hls_tpu/ops/pallas_grouped.py::grouped_mxu``:
out[rows(g)] = lhs[rows(g)] . rhs[g] over a contiguous row partition
given by ``group_sizes``, rows past ``sum(group_sizes)`` zero, with
``transpose_rhs`` reading each expert as (N, K) in place
(``csrc/grouped_gemm.cu``).  Group g's rows are [min(S_g, M),
min(S_{g+1}, M)) with S the exclusive cumulative sizes: routing past M
drops the trailing rows (the documented semantics of ``grouped_matmul``;
ROADMAP C2 notes where the JAX schedule departs from it).

The kernel reads the group ends on the card: the wrapper never moves the
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
    mixed pair is promoted (exactly) first.
    """
    m, k, n, num_groups = _check(lhs, rhs, group_sizes, transpose_rhs)
    out_dtype = out_dtype or torch.promote_types(lhs.dtype, rhs.dtype)
    if lhs.device.type == "cpu":
        return grouped_mxu_plain(lhs, rhs, group_sizes,
                                 transpose_rhs=transpose_rhs,
                                 out_dtype=out_dtype)
    if interpret:
        raise NotImplementedError(
            "grouped_mxu: CUDA has no interpreter mode; pass CPU tensors for "
            "the plain version")
    for t in (rhs, group_sizes):
        if t.device != lhs.device:
            raise ValueError(f"operands on {lhs.device} and {t.device}")
    in_dtype = torch.promote_types(lhs.dtype, rhs.dtype)
    if in_dtype not in _KERNEL_DTYPES:
        raise NotImplementedError(
            f"grouped_mxu: no kernel takes {in_dtype} (bf16, fp16, fp32)")
    lhs = lhs.to(in_dtype).contiguous()
    rhs = rhs.to(in_dtype).contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=lhs.device)
    if m == 0 or n == 0:
        return out
    ends = group_ends(group_sizes, m)
    step = 16 // lhs.element_size()
    lib = _build.library()
    with torch.cuda.device(lhs.device):
        rc = lib.grouped_gemm(
            lhs.data_ptr(), rhs.data_ptr(), ends.data_ptr(), out.data_ptr(),
            m, n, k, num_groups, int(bool(transpose_rhs)),
            _build.dtype_code(in_dtype), _build.dtype_code(out_dtype),
            int(lhs.data_ptr() % 16 == 0 and k % step == 0),
            int(rhs.data_ptr() % 16 == 0
                and (k if transpose_rhs else n) % step == 0),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "grouped_mxu")
    grouped_mxu.launches += 1
    return out


# Kernel launches since the count was last reset (plain calls not counted).
grouped_mxu.launches = 0
