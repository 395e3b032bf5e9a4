"""Analytical runtime model of the flash-attention kernels on the card: the
port of ``gemm_hls_tpu/models/attn_model.py`` (the ``PrintSpecifications``
analogue for attention, ``src/PrintSpecifications.cpp:45-78``), with its
legs re-derived for the Hopper engine kernels (``csrc/flash_wgmma.cu``,
``csrc/flash_bwd_wgmma.cu``).

The dicts keep the reference's keys and its closed-form legs, summed over
the live blocks:

* **MXU** (``mxu_s``): ``4 B S_q S_kv D`` operations for the forward (q kᵀ
  and p v), 3 or 4 products of ``2 B S_q S_kv D`` for dq or dk / dv, scaled
  by the live fraction at block granularity, at the tensor cores' rate.
* **Softmax** (``vpu_softmax_s``, ``vpu_recompute_s``): the live score
  elements times a per-chip count of CUDA-core instruction slots per score
  (:data:`ENGINE_CONSTANTS`), at the CUDA cores' issue rate
  (``ChipSpec.vpu_ops``).  ``exp`` issues on the MUFU, 16 a clock per SM
  against 128 FMA lanes: one eighth of the FMA rate, so an ``exp2`` costs 8
  slots before the max, scale, subtract, sum, rounding and packing.
* **HBM** (``hbm_s``): the forward reads q, k, v and writes o once.  The
  backward's outer loop re-reads its inner operands on every outer trip:
  dq reads K and V once per q tile (``n_q`` times), dk / dv read q, dO, lse
  and delta once per kv tile (``n_kv`` times), each trip over its live
  blocks only (under causal, ``n_q * live_fraction`` trips' worth); the
  reference counts each once (its C2 fault,
  ``gemm_hls_tpu/models/attn_model.py:179-182``).  The
  H100's 50 MB L2 serves many of those re-reads (a q tile's neighbours read
  the same K / V in the same round), as ``perf_model.specifications``
  notes for the GEMM's slabs, so this leg is an upper bound on the
  device-memory traffic.
* **Latch** (``latch_s``): ``ChipSpec.grid_step_overhead_s`` per live block
  step, in both directions: dead causal blocks cost nothing (the reference's
  forward charges them, ``:90``).  The H100's is 0 (``perf_model``).

**The Hopper law** (``expected_runtime_s``), from the kernels' structure:
one persistent block a SM (``sms``) walks the items in rounds of
alternating direction, the longest causal items first
(``flash_wgmma.cuh::fw_round_item``): the forward's and dq's items are
(128-row q tile, head), over kv tiles of 128 rows (forward) or 64 (dq);
dk / dv's are (kv tile, head) over q tiles of 64 rows, kv tiles of 128 rows
unless ``B ceil(S_kv / 128)`` fills at most one round of the SMs, then 64
(the split mode).  A block's time is the sum over its items of

* an item's fixed cost: its tiles that no step overlaps (forward: q, o and
  the first K / V tiles; dq: q, dO, dq and the first K / V; dk / dv: K, V,
  dk, dv and the first q / dO), over the block's share of the HBM rate
  (``hbm_bandwidth / sms``); nothing fitted;
* its live steps, each ``max(m, s) + overlap * min(m, s)``: m the step's
  products at the block's share of the tensor-core rate, s its scores at
  the block's share of the CUDA-core rate.  Two consumer warpgroups share
  the tensor cores, so one's softmax can run under the other's products:
  the longer leg bounds a step, and ``overlap`` is the share of the shorter
  one that stays outside it (fitted: about half in the forward; all of it
  in the backward, whose consumers fall into step with each other);

and the kernel takes ``launch_s`` plus the busiest block's time (the last
round's tail included).  ``expected_runtime_s`` is the larger of that and
the HBM leg, plus the latch.

Fitted on the card (NVIDIA H100 80GB HBM3, 700 W, ``chip_smoke.py`` phase
27c, which prints the fit of each run in this form): per kernel the slots
and the overlap, and one ``launch_s``, over the 46 shapes of the engine
route that it times in 3-D (S 256-16384, 1-67 heads, D 64 / 128, full and
causal).  Model over measured in a later run (another machine, the same
card name and power limit): the forward x0.93-1.09, dq x0.91-1.14, dk / dv x0.85-1.25;
at phase 15's anchors x0.946-1.057 (forward / dq / dk and dv at full 32 x
1024 x 128: x1.032 / x0.946 / x0.976; at D 64: x1.009 / x1.050 / x1.029;
causal 32 x 1024 and 8 x 8192: x0.979-1.057).  Where it misses:

* dk / dv at 1-2 heads of 8192-16384 rows (x1.19-1.25): the re-read HBM
  leg binds there, but one head's q and dO (4-8 MB) stay in L2;
* the forward's causal shapes run up to 7% slower than the law: a tile on
  the mask's diagonal compares every column with two bounds a row, which
  the law does not charge;
* the GQA prefill (16 q heads on 4 kv heads), held out (x1.07 / x1.10 /
  x1.15 causal): the reference's signature has no kv-head count, so dk /
  dv's items are modelled one kv head per q head, where the kernel walks
  16 kv heads' 64-row items over the group's 4 q heads.

Only the engine route is modelled: fp32, head dims other than 64 / 128 and
decode's few rows a head run on ``flash_fwd.cu`` and its backward pair
(``ops/flash.py::flash_route``), whose times this law does not describe.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from gemm_hls_tpu_torch.config import itemsize
from gemm_hls_tpu_torch.models.perf_model import ChipSpec, detect_chip

# Fitted per chip (chip_smoke.py phase 27c prints a fit of its readings in
# this form): CUDA-core instruction slots per score element of each kernel
# (the forward's online softmax; dq's p and ds; dk / dv's p^T and ds^T), the
# share of the shorter leg a step does not overlap, and the launch's fixed
# seconds.  ``sms``: the chip's streaming multiprocessors, one persistent
# block each.
ENGINE_CONSTANTS: Dict[str, dict] = {
    "h100": dict(
        sms=132,
        slots={"fwd": 19.11, "dq": 17.81, "dkv": 30.23},
        overlap={"fwd": 0.579, "dq": 1.0, "dkv": 0.858},
        launch_s=2.38e-6,
    ),
}

# The engine kernels' tiles (rows of q, rows of kv a step).
FWD_TILES = (128, 128)    # csrc/flash_wgmma.cu: kFwBQ, kFwBKV
DQ_TILES = (128, 64)      # csrc/flash_bwd_wgmma.cu: kDqBQ, kDqBKV
DKV_Q_ROWS = 64           # csrc/flash_bwd_wgmma.cu: kKvBQ
_PRODUCTS = {"fwd": 2, "dq": 3, "dkv": 4}


def engine_constants(chip: ChipSpec) -> dict:
    """The fitted constants of ``chip`` (a calibrated card without an entry
    takes the H100's, whose rates ``chip`` already scales)."""
    return ENGINE_CONSTANTS.get(chip.name, ENGINE_CONSTANTS["h100"])


def _rounds(items: int, grid: int):
    """Each block's items: block c takes items c, 2 grid - 1 - c, 2 grid +
    c, ... (``fw_round_item``)."""
    blocks = [[] for _ in range(grid)]
    for r in range(math.ceil(items / grid)):
        for c in range(grid):
            i = r * grid + (grid - 1 - c if r & 1 else c)
            if i < items:
                blocks[c].append(i)
    return blocks


def _schedule(step_counts, item_s: float, step_s: float, sms: int):
    """(seconds of the busiest block, seconds of its steps alone) of the
    items in walk order, each ``item_s + steps * step_s``."""
    if not step_counts:
        return 0.0, 0.0
    best = (0.0, 0.0)
    for blk in _rounds(len(step_counts), min(len(step_counts), sms)):
        steps = sum(step_counts[i] for i in blk)
        t = len(blk) * item_s + steps * step_s
        if t > best[0]:
            best = (t, steps * step_s)
    return best


def _step_s(kernel: str, rows_a: int, rows_b: int, d: int, dtype, chip: ChipSpec,
            const: dict):
    """(step seconds, product seconds m, softmax seconds s) of one block
    step of ``rows_a`` x ``rows_b`` scores on one SM."""
    sms = const["sms"]
    m = _PRODUCTS[kernel] * 2.0 * rows_a * rows_b * d / (chip.peak_for(dtype) / sms)
    s = rows_a * rows_b * const["slots"][kernel] / (chip.vpu_ops / sms)
    return max(m, s) + const["overlap"][kernel] * min(m, s), m, s


def _live_q_major(n_q, n_kv, block_q, block_kv, s_kv, causal, window):
    """Live kv steps of each q tile (the reference's block-granular count)."""
    if not causal:
        return [n_kv] * n_q
    return [max(0, min(n_kv, math.ceil(min((i + 1) * block_q, s_kv) / block_kv))
                - (0 if window is None else
                   max(0, (i * block_q - window + 1) // block_kv)))
            for i in range(n_q)]


def _bound(t_hbm, t_compute, t_latch, m, s):
    return ("latch" if t_latch > max(t_compute, t_hbm) else
            "memory" if t_hbm > t_compute else
            "vpu" if s > m else "mxu")


def attention_specifications(
        batch: int, s_q: int, s_kv: int, d: int, *,
        causal: bool = False, window: Optional[int] = None,
        dtype: str = "bfloat16", block_q: int = FWD_TILES[0],
        block_kv: int = FWD_TILES[1], chip: Optional[ChipSpec] = None) -> dict:
    """Closed-form expectations for one flash-attention forward of ``batch``
    heads of (S_q, S_kv, D): the legs, the expected runtime and TFLOP/s
    under the Hopper law (module docstring), and which resource bounds it.
    FLOPs are counted as ``4 B S_q S_kv D``, halved under causal (the
    reference's convention); the default blocks are the engine kernel's."""
    chip = chip or detect_chip()
    const = engine_constants(chip)
    block_q = min(block_q, s_q)
    block_kv = min(block_kv, s_kv)
    n_q = math.ceil(s_q / block_q)
    n_kv = math.ceil(s_kv / block_kv)

    per_tile = _live_q_major(n_q, n_kv, block_q, block_kv, s_kv, causal, window)
    live_steps = sum(per_tile)
    live_frac = live_steps / (n_q * n_kv)

    flops_full = 4 * batch * s_q * s_kv * d
    flops_live = flops_full * live_frac
    scores_live = batch * s_q * s_kv * live_frac

    in_b = itemsize(dtype)
    hbm_bytes = (batch * s_q * d + 2 * batch * s_kv * d) * in_b \
        + batch * s_q * d * in_b              # O written once
    t_mxu = flops_live / chip.peak_for(dtype)
    t_vpu = scores_live * const["slots"]["fwd"] / chip.vpu_ops
    t_hbm = hbm_bytes / chip.hbm_bandwidth
    t_latch = batch * live_steps * chip.grid_step_overhead_s

    # Items in walk order: the last q tile of every head first.
    order = [per_tile[n_q - 1 - i // batch] for i in range(batch * n_q)]
    step, m, s = _step_s("fwd", block_q, block_kv, d, dtype, chip, const)
    item = (2 * block_q + 2 * block_kv) * d * in_b / (chip.hbm_bandwidth / const["sms"])
    t_block, t_compute = _schedule(order, item, step, const["sms"])
    t_expected = max(const["launch_s"] + t_block, t_hbm) + t_latch

    flops_counted = flops_full / (2 if causal else 1)
    return {
        "chip": chip.name,
        "problem": (batch, s_q, s_kv, d),
        "blocks": (block_q, block_kv),
        "grid": (batch, n_q, n_kv),
        "causal": causal,
        "window": window,
        "live_fraction": live_frac,
        "flops": flops_counted,
        "mxu_s": t_mxu,
        "vpu_softmax_s": t_vpu,
        "hbm_s": t_hbm,
        "latch_s": t_latch,
        "expected_runtime_s": t_expected,
        "expected_tflops": flops_counted / t_expected / 1e12,
        "bound": _bound(t_hbm, t_compute, t_latch, m, s),
        "probability_bytes_saved": 2 * batch * s_q * s_kv * in_b,
    }


def attention_bwd_specifications(
        batch: int, s_q: int, s_kv: int, d: int, *, kernel: str = "dq",
        causal: bool = False, dtype: str = "bfloat16",
        block_q: Optional[int] = None, block_kv: Optional[int] = None,
        chip: Optional[ChipSpec] = None) -> dict:
    """Closed-form legs for one flash BACKWARD kernel (``dq`` or ``dkv``):
    ``dq`` recomputes the scores, forms ds and contracts ds k (3
    contractions over the live score area); ``dkv`` recomputes p and ds and
    contracts pᵀ dO and dsᵀ q (4).  ``expected_tflops`` is ``n_contractions
    x live-area FLOPs / t``.  Default blocks: the engine kernel's (dq: 128
    q rows over 64-row kv tiles; dk / dv: 128 kv rows, 64 in the split
    mode, over 64-row q tiles).  The HBM leg re-reads the inner operands
    once per outer trip (module docstring); only live blocks latch."""
    chip = chip or detect_chip()
    const = engine_constants(chip)
    if kernel not in ("dq", "dkv"):
        raise ValueError(f"kernel must be dq|dkv, got {kernel!r}")
    if kernel == "dq":
        block_q = block_q or DQ_TILES[0]
        block_kv = block_kv or DQ_TILES[1]
    else:
        block_q = block_q or DKV_Q_ROWS
        # The split mode: 128-row items would fill at most one round.
        block_kv = block_kv or (64 if batch * math.ceil(s_kv / 128) <= const["sms"] else 128)
    block_q = min(block_q, s_q)
    block_kv = min(block_kv, s_kv)
    n_q = math.ceil(s_q / block_q)
    n_kv = math.ceil(s_kv / block_kv)
    n_con = _PRODUCTS[kernel]

    per_q = _live_q_major(n_q, n_kv, block_q, block_kv, s_kv, causal, None)
    live_steps = sum(per_q)
    live_frac = live_steps / (n_q * n_kv)
    total_steps = batch * live_steps          # only live blocks latch

    area = 2.0 * batch * s_q * s_kv * d
    flops_live = n_con * area * live_frac
    scores_live = batch * s_q * s_kv * live_frac

    in_b = itemsize(dtype)
    q_side = 2 * batch * s_q * d * in_b + 2 * batch * s_q * 4   # q, dO; lse, delta (f32)
    kv_side = 2 * batch * s_kv * d * in_b                        # k, v
    # The inner operands once per outer trip, over the live blocks only
    # (the producers load live tiles only): n_q (n_kv) trips when every
    # block is live.
    if kernel == "dq":
        reads = q_side + n_q * live_frac * kv_side
        writes = batch * s_q * d * in_b
    else:
        reads = kv_side + n_kv * live_frac * q_side
        writes = 2 * batch * s_kv * d * in_b
    hbm_bytes = reads + writes
    t_mxu = flops_live / chip.peak_for(dtype)
    t_vpu = scores_live * const["slots"][kernel] / chip.vpu_ops
    t_hbm = hbm_bytes / chip.hbm_bandwidth
    t_latch = total_steps * chip.grid_step_overhead_s

    share = chip.hbm_bandwidth / const["sms"]
    if kernel == "dq":
        order = [per_q[n_q - 1 - i // batch] for i in range(batch * n_q)]
        step, m, s = _step_s("dq", block_q, block_kv, d, dtype, chip, const)
        item = ((3 * block_q + 2 * block_kv) * d * in_b + 8 * block_q) / share
    else:
        # Kv tile t's live q tiles: those at or past its first row.
        live_kv = [n_q - (t * block_kv // block_q if causal else 0) for t in range(n_kv)]
        order = [live_kv[i // batch] for i in range(batch * n_kv)]
        step, m, s = _step_s("dkv", block_kv, block_q, d, dtype, chip, const)
        item = (4 * block_kv + 2 * block_q) * d * in_b / share
    t_block, t_compute = _schedule(order, item, step, const["sms"])
    t_expected = max(const["launch_s"] + t_block, t_hbm) + t_latch

    flops_counted = n_con * area / (2 if causal else 1)
    return {
        "chip": chip.name,
        "problem": (batch, s_q, s_kv, d),
        "kernel": kernel,
        "contractions": n_con,
        "blocks": (block_q, block_kv),
        "causal": causal,
        "live_fraction": live_frac,
        "flops": flops_counted,
        "mxu_s": t_mxu,
        "vpu_recompute_s": t_vpu,
        "hbm_s": t_hbm,
        "latch_s": t_latch,
        "expected_runtime_s": t_expected,
        "expected_tflops": flops_counted / t_expected / 1e12,
        "bound": _bound(t_hbm, t_compute, t_latch, m, s),
    }


def predict_s(kernel: str, batch: int, s: int, d: int, causal: bool, *,
              dtype: str = "bfloat16", chip: Optional[ChipSpec] = None) -> float:
    """Expected seconds of one engine kernel ("fwd", "dq" or "dkv") on
    ``batch`` heads of (S, S, D), at its default blocks."""
    if kernel == "fwd":
        spec = attention_specifications(batch, s, s, d, causal=causal, dtype=dtype, chip=chip)
    else:
        spec = attention_bwd_specifications(batch, s, s, d, kernel=kernel, causal=causal,
                                            dtype=dtype, chip=chip)
    return spec["expected_runtime_s"]


def fit_constants(readings, chip: Optional[ChipSpec] = None, sms: int = 132) -> dict:
    """A table entry of :data:`ENGINE_CONSTANTS` fitted to ``readings``
    [(kernel, batch, S, D, causal, measured seconds)] of the engine kernels
    on one card: least squares of the relative errors over every reading,
    the slots and overlap per kernel, one launch cost (``scipy``; the
    table entry is read under a name of its own while the fit runs)."""
    from scipy.optimize import least_squares

    fit_chip = dataclasses.replace(chip or detect_chip(), name="_fit")
    kernels = ("fwd", "dq", "dkv")

    def entry(p):
        return dict(sms=sms, slots=dict(zip(kernels, p[:3])),
                    overlap=dict(zip(kernels, p[3:6])), launch_s=p[6] * 1e-6)

    def residuals(p):
        ENGINE_CONSTANTS[fit_chip.name] = entry(p)
        return [predict_s(k, b, s, d, c, chip=fit_chip) / t - 1.0
                for k, b, s, d, c, t in readings]

    try:
        fit = least_squares(residuals, [20.0, 20.0, 25.0, 0.5, 0.5, 0.5, 2.0],
                            bounds=([0.0] * 7, [200.0] * 3 + [1.0] * 3 + [50.0]))
    finally:
        ENGINE_CONSTANTS.pop(fit_chip.name, None)
    out = entry(fit.x)
    out["slots"] = {k: round(float(v), 2) for k, v in out["slots"].items()}
    out["overlap"] = {k: round(float(v), 3) for k, v in out["overlap"].items()}
    out["launch_s"] = round(float(out["launch_s"]), 8)
    return out
