"""Public matmul API: dispatch, shape policy and autodiff, in PyTorch.

Counterpart of ``gemm_hls_tpu/ops/matmul.py``.  Dispatch:

* ``plus_times``                 -> kernel B1 (2-D) or B2 (batched)
  (``ops/mxu.py``; bf16 / fp16 / int8 on the tile engine in any layout and
  at any alignment, an operand its TMA maps cannot read in place packed
  first; fp32 as TF32 passes on the tile engine, float64
  on the FP64 tensor cores, int16 and the unsigned ints on the CUDA
  cores), differentiable through :class:`_MxuPadded` /
  :class:`_MxuBatched`, whose backward is B1 / B2 again: on the 16-bit
  engine where a bf16 / fp16 layer's cotangent arrives in its own type
  (:func:`backward_on_16_bits`), else at the precision the reference
  resolves for the forward (:func:`backward_precision`);
  with a fused ``epilogue``, through :class:`_MxuEpilogue` (a Python
  callable epilogue compiled at first use into a functor at the store,
  ``ops/codegen.py``).  int64 plus_times raises TypeError, as in
  the JAX package.
* bool ``or_and``                -> B1 / B2 on int8 -> int32 counts.
* any other semiring             -> kernel B3 (``ops/vpu.py``), 2-D or batched;
  a user-defined one through a functor generated from its map and reduce.
* ``backend="vpu"``              -> B3 for every semiring, bool ``or_and``
  bit-packed (the JAX package's ``backend="pallas-vpu"``).
* ``backend="torch"``            -> the plain PyTorch versions (the JAX
  package's ``backend="xla"``), on any device.
* ``precision="i8x2"|"i8x3"|"i8x4"`` (float32 plus_times) -> the int8
  slices (``ops/int8_slices.py``): kernel B4, or B5 past the whole-K bound.
* min_plus, max_plus, log_plus, max_min, min_max (untransposed) ->
  :func:`~gemm_hls_tpu_torch.ops.tropical_grad.tropical_matmul`: B3 with
  subgradients.

Batching follows the JAX front door: N-D operands flatten their identical
leading dims (or one operand is 2-D and broadcast); a 3-D call runs one
batched launch where the JAX package ran its batched kernel or a
``jax.vmap`` of the 2-D one.

CPU tensors run the plain versions on every backend; CUDA tensors launch
a kernel or raise.  Requests no kernel takes yet raise NotImplementedError
naming the ROADMAP item.
"""

from __future__ import annotations

from typing import Optional

import torch

from gemm_hls_tpu_torch.config import (
    KERNEL_TILES, GemmConfig, default_config, dtype_name, kernel_route,
    round_up, torch_dtype,
)
from gemm_hls_tpu_torch.ops import codegen, int8_slices, mxu, tropical_grad, vpu
from gemm_hls_tpu_torch.ops.epilogue import get_epilogue
from gemm_hls_tpu_torch.ops.semiring import Semiring, get_semiring

_BACKENDS = ("cuda", "vpu", "torch")
_I8X = ("i8x2", "i8x3", "i8x4")


# ---------------------------------------------------------------------------
# plus_times with autograd: dA = g . op(B)^T, dB = op(A)^T . g as two more
# GEMM calls with flipped transpose flags (no materialised transposes).  The
# batched backward is the same flag algebra on B2; the gradient of a 2-D
# operand broadcast over the batch is the sum over the batch, as the
# transpose of ``jax.vmap`` gives.
# ---------------------------------------------------------------------------

class _MxuPadded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, cfg: GemmConfig, route=None):
        ctx.save_for_backward(a, b)
        ctx.cfg = cfg
        out = mxu.mxu_matmul(a, b, cfg=cfg, transpose_a=cfg.transpose_a,
                             transpose_b=cfg.transpose_b, route=route)
        if not out.is_floating_point():
            ctx.mark_non_differentiable(out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da, db = _mxu_bwd(ctx.cfg, (a, b), g, ctx.needs_input_grad[:2])
        return da, db, None, None


class _MxuBatched(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, cfg: GemmConfig, route=None):
        ctx.save_for_backward(a, b)
        ctx.cfg = cfg
        out = mxu.mxu_matmul_batched(a, b, cfg=cfg,
                                     transpose_a=cfg.transpose_a,
                                     transpose_b=cfg.transpose_b, route=route)
        if not out.is_floating_point():
            ctx.mark_non_differentiable(out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da, db = _mxu_bwd(ctx.cfg, (a, b), g, ctx.needs_input_grad[:2])
        return da, db, None, None


def _flattens(a, b, cfg: GemmConfig) -> bool:
    """A 3-D ``a`` (untransposed) against a 2-D ``b`` is one 2-D GEMM over
    B*M rows: the same numbers as the reference's vmap, and one B1 launch
    instead of a B2 one.  Epilogues are row-local, so they flatten too."""
    return (a.ndim == 3 and b.ndim == 2 and not cfg.transpose_a
            and a.shape[0] * a.shape[1] <= mxu._MAX_M)


def _plus_times(a, b, cfg: GemmConfig, route=None):
    """Differentiable plus_times on B1 (2-D) or B2 (batched), on ``route``
    where one is named (the backward keeps the route rule)."""
    if a.ndim == 2 and b.ndim == 2:
        return _MxuPadded.apply(a, b, cfg, route)
    if _flattens(a, b, cfg):
        bsz, m, k = a.shape
        return _MxuPadded.apply(a.reshape(bsz * m, k), b, cfg, route).reshape(
            bsz, m, -1)
    return _MxuBatched.apply(a, b, cfg, route)


def backward_precision(cfg: GemmConfig) -> str:
    """The precision of the backward GEMMs of a forward under ``cfg``: the
    reference keeps the forward's config (``gemm_hls_tpu/ops/matmul.py``'s
    ``_mxu_bwd``, ``cfg.replace``), whose ``_resolve_precision``
    (``ops/pallas_mxu.py``) gives DEFAULT for any input narrower than 4
    bytes or not floating, so a bf16 / fp16 layer's cotangent meets the
    MXU at DEFAULT: "default" there (its products exact in fp32: the
    16-bit engine for a 16-bit cotangent, :func:`backward_on_16_bits`, one
    TF32 pass for any other), the config's own precision otherwise."""
    d = torch_dtype(cfg.dtype)
    if not d.is_floating_point or d.itemsize < 4:
        return "default"
    return cfg.precision


def backward_on_16_bits(cfg: GemmConfig, g) -> bool:
    """Whether the backward GEMMs of a forward under ``cfg`` run on the
    layer's own 16-bit type (B1 / B2's 16-bit engine route, an fp32
    accumulator): a bfloat16 / float16 layer whose cotangent ``g`` arrives
    in that type.  Every value that meets the products is then a 16-bit
    value, so each product is exact in fp32, as at the reference's DEFAULT
    on an fp32 cotangent holding the same values (only the order of the
    sums differs).  Otherwise (an fp32 cotangent from a gelu / sigmoid /
    tanh derivative or an epilogue's recomputed one, another type) the
    pair meets as fp32 on the TF32 route, a 16-bit operand read by the
    split pass as it is."""
    d = torch_dtype(cfg.dtype)
    return d in (torch.bfloat16, torch.float16) and g.dtype == d


def _mxu_bwd(cfg: GemmConfig, res, g, need=(True, True)):
    """(dA, dB) for the cotangent ``g``; None where ``need`` says no
    gradient is wanted (no GEMM is run for it)."""
    a, b = res
    ta, tb = cfg.transpose_a, cfg.transpose_b
    half = backward_on_16_bits(cfg, g)
    if not half and not (cfg.tacc_dtype == torch.float32 and g.dtype in mxu.TF32_SOURCES):
        g = g.to(cfg.tacc_dtype)
    precision = backward_precision(cfg)

    def run(x, y, tx, ty, like):
        # A 16-bit cotangent of a 16-bit layer: the pair in that type.  Else
        # the pair promoted, as the reference's dot does, at the precision
        # the reference resolves for the forward's config: an fp32 pair on
        # the TF32 route reads a 16-bit member as it is (the split pass),
        # any other pair is cast.
        dt = x.dtype if half else torch.promote_types(x.dtype, y.dtype)
        c = default_config(dt).replace(
            transpose_a=tx, transpose_b=ty, out_dtype=dtype_name(like.dtype),
            precision=precision)
        if dt != torch.float32:
            x, y = x.to(dt), y.to(dt)
        out = _plus_times(x, y, c)
        if out.ndim > like.ndim:  # a broadcast 2-D operand: sum the batch
            out = out.sum(0)
        return out.to(like.dtype)

    da = db = None
    if need[0]:
        if not ta:
            da = run(g, b, False, not tb, a)      # g . op(B)^T
        else:
            da = run(b, g, tb, True, a)           # op(B) . g^T
    if need[1]:
        if not tb:
            db = run(a, g, not ta, False, b)      # op(A)^T . g
        else:
            db = run(g, a, True, ta, b)           # g^T . op(A)
    return da, db


# ---------------------------------------------------------------------------
# Differentiable fused-epilogue path (reference matmul.py:206-312).  The
# forward fuses the epilogue into the kernel's store; the backward recovers
# the accumulator cotangent dacc from the output cotangent g, then reuses
# the plain paths' flag algebra for da / db.  Two ways to get dacc:
#
#   * ``epilogue_bwd(y, g, *eps) -> (dacc, *deps)``, from the saved output
#     y (no recompute; ``ops/fused_linear.py`` passes the registry's
#     output-form derivatives);
#   * default: recompute the fp32 accumulator with one unfused GEMM on
#     B1 / B2 and pull g back through ``torch.func.vjp`` of the epilogue's
#     torch function.
# ---------------------------------------------------------------------------

def _epilogue_cotangents(ep, epilogue_bwd, y, g, eps, recompute_acc):
    if epilogue_bwd is not None:
        out = epilogue_bwd(y, g, *eps)
        return out[0], tuple(out[1:])
    yv, pull = torch.func.vjp(ep.fn, recompute_acc(), *eps)
    dacc, *deps = pull(g.to(yv.dtype))
    return dacc, tuple(deps)


class _MxuEpilogue(torch.autograd.Function):
    """Fused epilogue on B1 (2-D operands) or B2 (batched ones)."""

    @staticmethod
    def forward(ctx, a, b, cfg: GemmConfig, ep, epilogue_bwd, route, *eps):
        gemm = (mxu.mxu_matmul if a.ndim == 2 and b.ndim == 2
                else mxu.mxu_matmul_batched)
        y = gemm(a, b, *eps, cfg=cfg, transpose_a=cfg.transpose_a,
                 transpose_b=cfg.transpose_b, epilogue=ep, route=route)
        ctx.save_for_backward(a, b, y, *eps)
        ctx.cfg, ctx.ep, ctx.epilogue_bwd, ctx.gemm = cfg, ep, epilogue_bwd, gemm
        if not y.is_floating_point():
            ctx.mark_non_differentiable(y)
        return y

    @staticmethod
    def backward(ctx, g):
        a, b, y, *eps = ctx.saved_tensors
        cfg = ctx.cfg

        def recompute_acc():
            return ctx.gemm(a, b, cfg=cfg.replace(out_dtype=dtype_name(
                cfg.tacc_dtype)), transpose_a=cfg.transpose_a,
                transpose_b=cfg.transpose_b)

        dacc, deps = _epilogue_cotangents(ctx.ep, ctx.epilogue_bwd, y, g,
                                          eps, recompute_acc)
        da, db = _mxu_bwd(cfg, (a, b), dacc, ctx.needs_input_grad[:2])
        return (da, db, None, None, None, None,
                *(d.to(e.dtype) for d, e in zip(deps, eps)))


def _check_ep_operands(b, cfg: GemmConfig, ep_operands):
    n = b.shape[-2] if cfg.transpose_b else b.shape[-1]
    eps = []
    for ep in ep_operands:
        if ep.ndim != 1 or ep.shape[0] != n:
            raise ValueError(f"epilogue operands must be (N,)=({n},), "
                             f"got {tuple(ep.shape)}")
        eps.append(ep.reshape(1, n))
    return tuple(eps)


def _mxu_with_epilogue(a, b, cfg: GemmConfig, epilogue, ep_operands,
                       epilogue_bwd=None, route=None):
    """Differentiable plus_times with a fused output epilogue, on ``route``
    where one is named."""
    if cfg.precision in _I8X:
        raise ValueError("epilogue fusion is not supported with the "
                         "int8-slice precision tiers")
    ep = get_epilogue(epilogue)
    if (ep.code is None and not ep.rows and not (a.is_cuda and b.is_cuda)
            and not (a.device.type == "cpu" and b.device.type == "cpu")):
        # A callable runs as it is on the CPU and compiles into a functor
        # for CUDA (the launch lowers it); no other device runs it unfused.
        raise NotImplementedError(
            f"callable epilogues run on CPU tensors or compile for CUDA ones, "
            f"not on {a.device} / {b.device} ({codegen.ITEM})")
    eps = _check_ep_operands(b, cfg, ep_operands)
    if (ep.code is not None or ep.rows) and len(eps) != ep.n_operands:
        raise ValueError(f"epilogue {ep.name!r} takes {ep.n_operands} "
                         f"operands, got {len(eps)}")
    if _flattens(a, b, cfg):
        bsz, m, k = a.shape
        out = _MxuEpilogue.apply(a.reshape(bsz * m, k), b, cfg, ep,
                                 epilogue_bwd, route, *eps)
        return out.reshape(bsz, m, -1)
    return _MxuEpilogue.apply(a, b, cfg, ep, epilogue_bwd, route, *eps)


def _i8x(a, b, n_slices: int):
    """The int8-slice tiers (``ops/int8_slices.py``; kernel B4, or B5 past
    the whole-K bound).  Batched operands give what the JAX front door's
    vmap of the 2-D route gives: ulps per row of each example and per
    column of each example's B.  A 3-D ``a`` against a 2-D ``b`` is one
    call over B*M rows (per-row ulps are unchanged by the flattening)."""
    def run(x, y):
        return int8_slices.fp32_matmul_int8(x, y, block_m=512, block_n=1024,
                                            block_k=8192, n_slices=n_slices)

    if a.ndim == 2 and b.ndim == 2:
        return run(a, b)
    if b.ndim == 2:
        bsz, m, k = a.shape
        return run(a.reshape(bsz * m, k), b).reshape(bsz, m, -1)
    return torch.stack([run(a[z] if a.ndim == 3 else a, b[z])
                        for z in range(b.shape[0])])


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
# Semiring paths (2-D or batched: leading dims pass through)
# ---------------------------------------------------------------------------

def _pack_bits_rows(x):
    """(..., M, K) bool -> (..., M, ceil(K/32)) int32, bit j of word w =
    x[..., 32w + j]; the K tail pads with False, absorbing for the AND map."""
    *lead, m, k = x.shape
    kp = round_up(k, 32)
    w = torch.zeros((*lead, m, kp), dtype=torch.int64, device=x.device)
    w[..., :k] = x
    shifts = torch.arange(32, dtype=torch.int64, device=x.device)
    words = (w.reshape(*lead, m, kp // 32, 32) << shifts).sum(dim=-1)
    return _as_int32(words)


def _pack_bits_cols(x):
    """(..., K, N) bool -> (..., ceil(K/32), N) int32, packed along K, same
    bit order."""
    *lead, k, n = x.shape
    kp = round_up(k, 32)
    w = torch.zeros((*lead, kp, n), dtype=torch.int64, device=x.device)
    w[..., :k, :] = x
    shifts = torch.arange(32, dtype=torch.int64, device=x.device)[:, None]
    words = (w.reshape(*lead, kp // 32, 32, n) << shifts).sum(dim=-2)
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
    by B1 / B2 into int32 (exact: a count is at most K < 2^31), then != 0.
    The counts stay int32; the reference casts them to int8, so a count
    that is a multiple of 256 reads as False there (ROADMAP C2)."""
    cfg8 = default_config("int8", out_dtype="int32",
                          transpose_a=cfg.transpose_a,
                          transpose_b=cfg.transpose_b)
    gemm = (mxu.mxu_matmul if a.ndim == 2 and b.ndim == 2
            else mxu.mxu_matmul_batched)
    counts = gemm(a.to(torch.int8), b.to(torch.int8), cfg=cfg8,
                  transpose_a=cfg.transpose_a, transpose_b=cfg.transpose_b)
    return counts != 0


def _vpu_dispatch(a, b, cfg: GemmConfig, sr: Semiring):
    if a.dtype == torch.bool:
        # Bit-packed: 32 contraction steps per int32 word op.
        a_l = a.transpose(-1, -2) if cfg.transpose_a else a
        b_l = b.transpose(-1, -2) if cfg.transpose_b else b
        cfg32 = default_config("int32", semiring=_OR_AND_BITS.name)
        out = vpu.vpu_matmul(_pack_bits_rows(a_l), _pack_bits_cols(b_l),
                             cfg=cfg32, sr=_OR_AND_BITS)
        return out != 0
    return vpu.vpu_matmul(a, b, cfg=cfg, sr=sr, transpose_a=cfg.transpose_a,
                          transpose_b=cfg.transpose_b)


# ---------------------------------------------------------------------------
# Tuned winners (tools/autotune.py), adopted by the front door without a
# config: the JAX package's ``cached_config`` / ``cached_batch_block`` steps
# (gemm_hls_tpu/ops/matmul.py:631-647, :127-141).
# ---------------------------------------------------------------------------

def _cached_winner(a, b, ta: bool, tb: bool, out_dtype=None):
    """(config, route) of the cached winner for this plus_times call into
    ``out_dtype`` (None: the inputs' type), or (None, None) on a miss.
    2-D operands read the dense entry (``cached_config``: the winner's
    blocks and the route they name); batched ones the batched entry
    (``cached_batch_block``: the B2 route).  The lookup never measures, and
    an entry whose route the rule cannot run into this output type is a
    miss (``tools/autotune.py``)."""
    from gemm_hls_tpu_torch.tools import autotune

    m, k = (a.shape[-1], a.shape[-2]) if ta else (a.shape[-2], a.shape[-1])
    n = b.shape[-2] if tb else b.shape[-1]
    dtype = dtype_name(a.dtype)
    if a.ndim == 2 and b.ndim == 2:
        hit = autotune.cached_winner(m, n, k, dtype=dtype,
                                     layout=autotune.layout_of(ta, tb),
                                     device=a.device, out_dtype=out_dtype)
        return hit if hit is not None else (None, None)
    bsz = a.shape[0] if a.ndim == 3 else b.shape[0]
    route = autotune.cached_batch_block(bsz, m, n, k, dtype=dtype,
                                        layout=autotune.layout_of(ta, tb),
                                        device=a.device, out_dtype=out_dtype)
    return None, route


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
      a: (M, K) tensor, or (K, M) with ``transpose_a``; or batched:
        (..., M, K).
      b: (K, N) tensor, or (N, K) with ``transpose_b``; or batched.  N-D
        operands must carry identical leading dims, or one operand may be
        2-D (broadcast over the other's batch).
      semiring: registry name or :class:`Semiring`.
      config: a :class:`GemmConfig`.  Its blocks name the compiled tile of a
        route (``config.GemmConfig.route``).  The tile engine's
        (``config.ENGINE_TILES``; :func:`~gemm_hls_tpu_torch.config.route_config`
        of a bf16 / fp16 call) runs a plus_times call on the engine (an
        operand its TMA maps cannot read in place packed first), and raises
        where the engine cannot run the call (fp32 or an integer into
        float64).  The WMMA tile (``default_config``'s, which internal
        callers pass) and the CUDA-core tile keep the route rule by shape
        (``ops/mxu.py::mxu_route``: the engine for bf16 / fp16 / int8 /
        fp32, and int16 / uint8 / uint16 / uint32 / int32 as byte planes,
        in every layout and at every alignment).  None: a tuned winner
        for this shape bucket if one is cached
        (``tools/autotune.py``: the user cache, then the packaged H100
        seed; a plain plus_times call without an epilogue), its route named
        to the kernel, else :func:`default_config` and the route rule.
      backend: "cuda" (default: kernel B1 / B2 / B3 by semiring), "vpu" (B3
        for every semiring) or "torch" (the plain versions).
      interpret: accepted for the reference's signature; there is no
        interpreter on CUDA, so only None / False are taken.
      precision: float32 plus_times precision ("default"|"high"|"highest",
        or the int8-slice tiers "i8x2"|"i8x3"|"i8x4": float32 operands
        without transpose flags).
      epilogue: fused output transform (plus_times, default backend): a
        registry name of ``ops/epilogue.py`` ("bias", "bias_relu",
        "bias_sigmoid", "bias_tanh", "bias_gelu", "col_scale", "scale_bias",
        "softmax"), an :class:`~gemm_hls_tpu_torch.ops.epilogue.Epilogue`, or
        a per-element callable ``f(acc, *operands)`` of up to four operands
        (``acc`` in the accumulator dtype).  A callable runs as it is on CPU
        tensors; on CUDA ones it is traced and compiled at first use into a
        functor at the store of the call's route (``ops/codegen.py``; one it
        cannot translate raises NotImplementedError, never runs unfused).
        Differentiable: the backward recomputes the accumulator and pulls
        the cotangent back through ``torch.func.vjp`` of the epilogue, or
        uses ``epilogue_bwd``.
      epilogue_operands: per-output-column (N,) tensors, seen by the
        epilogue as (1, N).
      epilogue_bwd: optional ``(y, g, *eps) -> (dacc, *deps)`` from the
        saved output (skips the recompute GEMM); ``eps`` are (1, N).

    Returns (..., M, N) in ``config.out_dtype``.
    """
    sr = get_semiring(semiring)
    if interpret:
        raise NotImplementedError(
            "CUDA has no interpreter mode; pass backend='torch' for the "
            "plain PyTorch version")
    kw = dict(semiring=semiring, config=config, transpose_a=transpose_a,
              transpose_b=transpose_b, out_dtype=out_dtype, backend=backend,
              precision=precision, epilogue=epilogue,
              epilogue_operands=epilogue_operands, epilogue_bwd=epilogue_bwd)
    if a.ndim > 3 or b.ndim > 3:
        # N-D batching (reference matmul.py:542-563): identical leading dims
        # (no broadcasting of unequal ones), or one operand 2-D.  Flatten
        # them to one axis, run the 3-D path, restore the shape.
        lead_a = tuple(a.shape[:-2]) if a.ndim > 2 else ()
        lead_b = tuple(b.shape[:-2]) if b.ndim > 2 else ()
        if lead_a and lead_b and lead_a != lead_b:
            raise ValueError(
                f"batch dims must match (or one operand be 2-D): "
                f"{tuple(a.shape)} x {tuple(b.shape)}")
        lead = lead_a or lead_b
        a3 = a.reshape((-1,) + tuple(a.shape[-2:])) if lead_a else a
        b3 = b.reshape((-1,) + tuple(b.shape[-2:])) if lead_b else b
        out = matmul(a3, b3, **kw)
        return out.reshape(lead + tuple(out.shape[-2:]))
    if a.ndim < 2 or b.ndim < 2:
        raise ValueError(
            f"matmul expects operands of ndim >= 2, got {tuple(a.shape)}, "
            f"{tuple(b.shape)}")
    batched = a.ndim == 3 or b.ndim == 3
    if a.ndim == b.ndim == 3 and a.shape[0] != b.shape[0]:
        raise ValueError(f"batch dims must match: {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    lead = ((a.shape[0] if a.ndim == 3 else b.shape[0]),) if batched else ()
    if backend is None:
        backend = "cuda"
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    # The route a tuned winner or an engine-tile config names (None: the
    # route rule by shape decides at the launch).
    force = None
    if (config is None and backend == "cuda" and sr.name == "plus_times"
            and epilogue is None and a.dtype == b.dtype
            and precision not in _I8X):
        config, force = _cached_winner(a, b, bool(transpose_a),
                                       bool(transpose_b), out_dtype)
    if config is None:
        bm, bn, bk = KERNEL_TILES["simt" if backend == "vpu"
                                  else kernel_route(a.dtype, sr.name)]
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

    a2, b2 = a.shape[-2:], b.shape[-2:]
    ka = a2[0] if config.transpose_a else a2[1]
    kb = b2[1] if config.transpose_b else b2[0]
    m_out = a2[1] if config.transpose_a else a2[0]
    n_out = b2[0] if config.transpose_b else b2[1]
    if lead == (0,):
        # Empty batch (reference matmul.py:564-591): the same error surface
        # as a non-empty one, then the empty result.
        if a.dtype != b.dtype:
            raise ValueError(f"dtype mismatch: {a.dtype} vs {b.dtype}")
        if not sr.supports_dtype(a.dtype):
            raise ValueError(
                f"semiring {sr.name} does not support dtype {a.dtype}")
        if ka != kb:
            raise ValueError(f"contraction mismatch: {tuple(a.shape)} x "
                             f"{tuple(b.shape)}")
        od = torch_dtype(out_dtype) if out_dtype is not None else (
            config.tout_dtype)
        return torch.zeros((0, m_out, n_out), dtype=od, device=a.device)
    if ka != kb:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if m_out == 0 or n_out == 0 or ka == 0:
        # Degenerate shapes: empty result / pure-identity fill.
        ident = sr.identity_for(config.tacc_dtype) if ka == 0 else 0
        return torch.full(lead + (m_out, n_out), ident,
                          dtype=config.tout_dtype, device=a.device)
    if a.dtype != b.dtype:
        raise ValueError(f"dtype mismatch: {a.dtype} vs {b.dtype}")
    if not sr.supports_dtype(a.dtype):
        raise ValueError(f"semiring {sr.name} does not support dtype {a.dtype}")
    if sr.is_mxu and a.dtype in mxu._NO_PLUS_TIMES:
        # The reference's dot refuses an int32 accumulator narrower than its
        # int64 inputs, on every backend.
        raise TypeError(f"{dtype_name(a.dtype)} plus_times: the int32 "
                        f"accumulator is narrower than the inputs")

    # Bool operands run on internal int8 / bit-packed configs; the compiled
    # tile that will run is B3's for backend="vpu", else the config's.
    route = "simt" if backend == "vpu" else config.route()
    config.validate(
        strict_alignment=(backend != "torch" and a.is_cuda
                          and a.dtype != torch.bool),
        route=route)
    if route == "wgmma":
        force = "wgmma"

    if config.pad_policy == "strict":
        if (m_out % config.block_m or n_out % config.block_n
                or ka % config.block_k):
            raise ValueError(
                f"pad_policy='strict': shape ({m_out},{n_out},{ka}) not "
                f"divisible by blocks ({config.block_m},{config.block_n},"
                f"{config.block_k})")

    if epilogue is not None:
        if backend != "cuda" or not sr.is_mxu:
            raise ValueError("epilogue fusion requires the plus_times "
                             "semiring on the cuda backend")
        return _mxu_with_epilogue(a, b, config, epilogue,
                                  tuple(epilogue_operands), epilogue_bwd,
                                  force)
    if backend == "torch":
        return _torch_matmul(a, b, config, sr)
    if backend == "vpu":
        return _vpu_dispatch(a, b, config, sr)
    if sr.name == "or_and" and a.dtype == torch.bool:
        return _or_and_mxu(a, b, config)
    if sr.is_mxu and config.precision in _I8X:
        if (config.transpose_a or config.transpose_b
                or config.dtype != "float32"):
            raise ValueError("precision='i8x*' requires float32 operands "
                             "without transpose flags")
        return _i8x(a, b, int(config.precision[-1])).to(config.tout_dtype)
    if sr.is_mxu:
        return _plus_times(a, b, config, force)
    if (sr.name in tropical_grad._SUPPORTED and not config.transpose_a
            and not config.transpose_b):
        # Differentiable additive-map path: argmin / argmax subgradients,
        # or softmax weights for log_plus; the forward is the same B3 launch.
        return tropical_grad.tropical_matmul(a, b, sr.name, config)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        raise NotImplementedError(
            f"no gradient for semiring {sr.name!r} with these flags, as in the "
            f"JAX package: gradients run for plus_times and for untransposed "
            f"{', '.join(tropical_grad._SUPPORTED)}")
    return _vpu_dispatch(a, b, config, sr)
