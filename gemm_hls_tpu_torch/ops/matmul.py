"""Public matmul API: dispatch, shape policy and autodiff, in PyTorch.

Counterpart of ``gemm_hls_tpu/ops/matmul.py`` for 2-D operands.  Dispatch:

* ``plus_times``                 -> kernel B1 (``ops/mxu.py``), differentiable
  through :class:`_MxuPadded`, whose backward is B1 again.
* bool ``or_and``                -> B1 on int8 -> int32 counts.
* any other semiring             -> kernel B3 (``ops/vpu.py``).
* ``backend="vpu"``              -> B3 for every semiring, bool ``or_and``
  bit-packed (the JAX package's ``backend="pallas-vpu"``).
* ``backend="torch"``            -> the plain PyTorch versions (the JAX
  package's ``backend="xla"``), on any device.

CPU tensors run the plain versions on every backend; CUDA tensors launch
a kernel or raise.  Requests no kernel takes yet raise NotImplementedError
naming the ROADMAP item.
"""

from __future__ import annotations

from typing import Optional

import torch

from gemm_hls_tpu_torch.config import (
    KERNEL_TILES, GemmConfig, default_config, dtype_name, kernel_route,
    round_up,
)
from gemm_hls_tpu_torch.ops import mxu, vpu
from gemm_hls_tpu_torch.ops.semiring import Semiring, get_semiring

_BACKENDS = ("cuda", "vpu", "torch")


# ---------------------------------------------------------------------------
# plus_times with autograd: dA = g . op(B)^T, dB = op(A)^T . g as two more B1
# calls with flipped transpose flags (no materialised transposes).
# ---------------------------------------------------------------------------

class _MxuPadded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, cfg: GemmConfig):
        ctx.save_for_backward(a, b)
        ctx.cfg = cfg
        out = mxu.mxu_matmul(a, b, cfg=cfg, transpose_a=cfg.transpose_a,
                             transpose_b=cfg.transpose_b)
        if not out.is_floating_point():
            ctx.mark_non_differentiable(out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da, db = _mxu_bwd(ctx.cfg, (a, b), g)
        return da, db, None


def _mxu_bwd(cfg: GemmConfig, res, g):
    a, b = res
    ta, tb = cfg.transpose_a, cfg.transpose_b
    g = g.to(cfg.tacc_dtype)

    def run(x, y, tx, ty, out_dtype):
        # The cotangent is fp32 while a bf16 operand stays bf16: promote the
        # pair, as the reference's dot does.
        dt = torch.promote_types(x.dtype, y.dtype)
        c = default_config(dt).replace(
            transpose_a=tx, transpose_b=ty, out_dtype=dtype_name(out_dtype),
            precision=cfg.precision)
        return _MxuPadded.apply(x.to(dt), y.to(dt), c)

    if not ta:
        da = run(g, b, False, not tb, a.dtype)      # g . op(B)^T
    else:
        da = run(b, g, tb, True, a.dtype)           # op(B) . g^T
    if not tb:
        db = run(a, g, not ta, False, b.dtype)      # op(A)^T . g
    else:
        db = run(g, a, True, ta, b.dtype)           # g^T . op(A)
    return da.to(a.dtype), db.to(b.dtype)


# ---------------------------------------------------------------------------
# Plain backend (backend="torch")
# ---------------------------------------------------------------------------

def _torch_matmul(a, b, cfg: GemmConfig, sr: Semiring):
    if sr.is_mxu:
        return mxu.mxu_matmul_plain(a, b, cfg=cfg, transpose_a=cfg.transpose_a,
                                    transpose_b=cfg.transpose_b)
    return vpu.vpu_matmul_plain(a, b, cfg=cfg, sr=sr,
                                transpose_a=cfg.transpose_a,
                                transpose_b=cfg.transpose_b)


# ---------------------------------------------------------------------------
# Semiring paths
# ---------------------------------------------------------------------------

def _pack_bits_rows(x):
    """(M, K) bool -> (M, ceil(K/32)) int32, bit j of word w = x[:, 32w + j];
    the K tail pads with False, absorbing for the AND map."""
    m, k = x.shape
    kp = round_up(k, 32)
    w = torch.zeros((m, kp), dtype=torch.int64, device=x.device)
    w[:, :k] = x
    shifts = torch.arange(32, dtype=torch.int64, device=x.device)
    words = (w.reshape(m, kp // 32, 32) << shifts).sum(dim=-1)
    return _as_int32(words)


def _pack_bits_cols(x):
    """(K, N) bool -> (ceil(K/32), N) int32, packed along K, same bit order."""
    k, n = x.shape
    kp = round_up(k, 32)
    w = torch.zeros((kp, n), dtype=torch.int64, device=x.device)
    w[:k] = x
    shifts = torch.arange(32, dtype=torch.int64, device=x.device)[:, None]
    words = (w.reshape(kp // 32, 32, n) << shifts).sum(dim=1)
    return _as_int32(words)


def _as_int32(words):
    """uint32 bit patterns held in int64 -> the same bits as int32."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _bitand_nonzero(aw, bw):
    return (torch.bitwise_and(aw, bw) != 0).to(torch.int32)


# Bool or_and on 32-bit words; its kernel functor is op code 9.
_OR_AND_BITS = Semiring(
    name="or_and_bits", map_op=_bitand_nonzero, reduce_op=torch.maximum,
    identity=0, np_map=None, np_reduce=None,
    reduce_axis=lambda x, dim: torch.amax(x, dim=dim), op_code=9)


def _or_and_mxu(a, b, cfg: GemmConfig):
    """Bool reachability on the tensor cores: 0/1 operands as int8, counted
    by B1 into int32 (exact: a count is at most K < 2^31), then != 0.  The
    counts stay int32; the reference casts them to int8, so a count that is
    a multiple of 256 reads as False there (ROADMAP C2)."""
    cfg8 = default_config("int8", out_dtype="int32",
                          transpose_a=cfg.transpose_a,
                          transpose_b=cfg.transpose_b)
    counts = mxu.mxu_matmul(a.to(torch.int8), b.to(torch.int8), cfg=cfg8,
                            transpose_a=cfg.transpose_a,
                            transpose_b=cfg.transpose_b)
    return counts != 0


def _vpu_dispatch(a, b, cfg: GemmConfig, sr: Semiring):
    if a.dtype == torch.bool:
        # Bit-packed: 32 contraction steps per int32 word op.
        a_l = a.T if cfg.transpose_a else a
        b_l = b.T if cfg.transpose_b else b
        cfg32 = default_config("int32", semiring=_OR_AND_BITS.name)
        out = vpu.vpu_matmul(_pack_bits_rows(a_l), _pack_bits_cols(b_l),
                             cfg=cfg32, sr=_OR_AND_BITS)
        return out != 0
    return vpu.vpu_matmul(a, b, cfg=cfg, sr=sr, transpose_a=cfg.transpose_a,
                          transpose_b=cfg.transpose_b)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def matmul(
    a,
    b,
    *,
    semiring="plus_times",
    config: Optional[GemmConfig] = None,
    transpose_a: Optional[bool] = None,
    transpose_b: Optional[bool] = None,
    out_dtype=None,
    backend: Optional[str] = None,
    interpret: Optional[bool] = None,
    precision: Optional[str] = None,
    epilogue=None,
    epilogue_operands=(),
    epilogue_bwd=None,
):
    """Communication-avoiding semiring matmul: C = reduce_k map(op(A), op(B)).

    Args:
      a: (M, K) tensor, or (K, M) with ``transpose_a``.
      b: (K, N) tensor, or (N, K) with ``transpose_b``.
      semiring: registry name or :class:`Semiring`.
      config: a :class:`GemmConfig`; defaults to :func:`default_config`.
      backend: "cuda" (default: kernel B1 / B3 by semiring), "vpu" (B3 for
        every semiring) or "torch" (the plain versions).
      interpret: accepted for the reference's signature; there is no
        interpreter on CUDA, so only None / False are taken.
      precision: float32 plus_times precision ("default"|"high"|"highest").
      epilogue, epilogue_operands, epilogue_bwd: not ported yet.

    Returns (M, N) in ``config.out_dtype``.
    """
    sr = get_semiring(semiring)
    if epilogue is not None or epilogue_operands or epilogue_bwd is not None:
        raise NotImplementedError(
            "fused epilogues are not ported yet (ROADMAP A, slice 2: "
            "epilogue + fused_linear)")
    if interpret:
        raise NotImplementedError(
            "CUDA has no interpreter mode; pass backend='torch' for the "
            "plain PyTorch version")
    if a.ndim > 2 or b.ndim > 2:
        raise NotImplementedError(
            "3-D/N-D batching is not ported yet (ROADMAP A, slice 2: "
            "batching, kernel B2)")
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(
            f"matmul expects operands of ndim >= 2, got {tuple(a.shape)}, "
            f"{tuple(b.shape)}")
    if backend is None:
        backend = "cuda"
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    # The compiled tile that will run: B3's for backend="vpu".
    route = "simt" if backend == "vpu" else kernel_route(a.dtype, sr.name)
    if config is None:
        bm, bn, bk = KERNEL_TILES[route]
        config = default_config(a.dtype, semiring=sr.name, block_m=bm,
                                block_n=bn, block_k=bk)
    overrides = {}
    if transpose_a is not None:
        overrides["transpose_a"] = transpose_a
    if transpose_b is not None:
        overrides["transpose_b"] = transpose_b
    if out_dtype is not None:
        overrides["out_dtype"] = dtype_name(out_dtype)
    if precision is not None:
        overrides["precision"] = precision
    if dtype_name(a.dtype) != config.dtype:
        overrides["dtype"] = dtype_name(a.dtype)
    if config.semiring != sr.name:
        overrides["semiring"] = sr.name
    if overrides:
        config = config.replace(**overrides)

    ka = a.shape[0] if config.transpose_a else a.shape[1]
    kb = b.shape[1] if config.transpose_b else b.shape[0]
    if ka != kb:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    m_out = a.shape[1] if config.transpose_a else a.shape[0]
    n_out = b.shape[0] if config.transpose_b else b.shape[1]
    if m_out == 0 or n_out == 0 or ka == 0:
        # Degenerate shapes: empty result / pure-identity fill.
        ident = sr.identity_for(config.tacc_dtype) if ka == 0 else 0
        return torch.full((m_out, n_out), ident, dtype=config.tout_dtype,
                          device=a.device)
    if a.dtype != b.dtype:
        raise ValueError(f"dtype mismatch: {a.dtype} vs {b.dtype}")
    if not sr.supports_dtype(a.dtype):
        raise ValueError(f"semiring {sr.name} does not support dtype {a.dtype}")

    # Bool operands run on internal int8 / bit-packed configs.
    config.validate(
        strict_alignment=(backend != "torch" and a.is_cuda
                          and a.dtype != torch.bool),
        route=route)

    if config.pad_policy == "strict":
        if (m_out % config.block_m or n_out % config.block_n
                or ka % config.block_k):
            raise ValueError(
                f"pad_policy='strict': shape ({m_out},{n_out},{ka}) not "
                f"divisible by blocks ({config.block_m},{config.block_n},"
                f"{config.block_k})")

    if backend == "torch":
        return _torch_matmul(a, b, config, sr)
    if sr.is_mxu and config.precision in ("i8x2", "i8x3", "i8x4"):
        raise NotImplementedError(
            "precision='i8x*' is not ported yet (ROADMAP A, slice 2: i8x*, "
            "kernel B4)")
    if backend == "vpu":
        return _vpu_dispatch(a, b, config, sr)
    if sr.name == "or_and" and a.dtype == torch.bool:
        return _or_and_mxu(a, b, config)
    if sr.is_mxu:
        return _MxuPadded.apply(a, b, config)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        raise NotImplementedError(
            f"gradients of {sr.name} are not ported yet (ROADMAP A, slice 2: "
            f"tropical gradients)")
    return _vpu_dispatch(a, b, config, sr)

