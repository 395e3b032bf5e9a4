"""Analytical performance model of the card: the port of
``gemm_hls_tpu/models/perf_model.py`` (``PrintSpecifications``,
``src/PrintSpecifications.cpp``) for an NVIDIA H100, plus the bounds
``chip_smoke.py`` holds each kernel to.

Rates are NVIDIA's published dense peaks for the H100 SXM at its full
700 W power limit (NVIDIA H100 data sheet).  A card set to a
lower limit runs slower under load, so every measurement states the limit
beside it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from gemm_hls_tpu_torch.config import SMEM_LIMIT_BYTES, GemmConfig, itemsize


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """One accelerator's roofline constants, under the reference's field
    names.

    ``peak_flops`` maps dtype name -> peak FLOP/s of the tensor cores
    for the type (float32, and the integer types the tensor cores do not
    take: the CUDA cores' FMA / multiply-add rate, one counted as 2 ops);
    ``vpu_ops`` is the CUDA-core instruction rate that bounds the
    generic-semiring kernel, whose (map, reduce) pair is two instructions.
    ``vmem_bytes``: the shared memory one thread block may use (the
    reference's VMEM, the fast memory a block's tiles live in).
    ``ici_bandwidth`` / ``ici_links``: the card-to-card links (NVLink on
    the H100), bytes/s per link in one direction, and their count.
    ``grid_step_overhead_s``: the fixed cost of one block step in the
    runtime estimate (the reference's Mosaic latch).
    """

    name: str
    peak_flops: Dict[str, float]
    vpu_ops: float                # CUDA-core instructions/s
    hbm_bandwidth: float          # device-memory bytes/s
    vmem_bytes: int = 0
    ici_bandwidth: float = 0.0
    ici_links: int = 0
    clock_hz: float = 0.0
    tdp_watts: float = 0.0
    grid_step_overhead_s: float = 0.0

    def peak_for(self, dtype) -> float:
        d = str(dtype).removeprefix("torch.")
        return self.peak_flops.get(d, self.peak_flops["float32"])

    def vpu_ops_for(self, dtype, semiring=None) -> float:
        """The generic-semiring rate (kernel B3) for ``dtype`` inputs, in
        2*M*N*K ops a second: ``vpu_ops`` for every type but float64, half
        of it for float64.  A term is a (map, reduce) pair: two fp32
        instructions on 128 lanes a clock an SM (fp32, bf16 and fp16 inputs,
        an fp32 accumulator); one instruction on 64 lanes for the int32
        accumulator of every integer type, where sm_90's DPX fuses the add
        with the min / max (``VIADDMNMX`` in the built min_plus kernels'
        SASS), the same term rate; two on 64 lanes for float64 (64-bit
        add, and compare and select: sm_90 has no float64 min / max
        instruction).  ``semiring="plus_times"`` on a floating type is one
        fused multiply-add a term (FFMA, DFMA), so twice that rate (the
        integers' IMAD keeps their one instruction a term).  Lanes a clock:
        the CUDA C++ Programming Guide's arithmetic-throughput table,
        compute capability 9.0."""
        d = str(dtype).removeprefix("torch.")
        rate = self.vpu_ops / 2 if d == "float64" else self.vpu_ops
        fused = semiring == "plus_times" and d in ("float64", "float32", "bfloat16", "float16")
        return 2 * rate if fused else rate

    def bound(self, ops: float, peak: float, bytes_moved: float):
        """(seconds, "operations" | "bytes"): the least time the card could
        take for ``ops`` operations at ``peak`` per second that must move
        ``bytes_moved`` bytes (each input read once, each output written
        once), and which of the two sets it."""
        t_ops, t_bytes = ops / peak, bytes_moved / self.hbm_bandwidth
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


_CHIPS: Dict[str, ChipSpec] = {}


def _register(c: ChipSpec) -> ChipSpec:
    _CHIPS[c.name] = c
    return c


H100 = _register(ChipSpec(
    name="h100",
    # bf16/fp16 989 TFLOP/s, int8 1979 TOP/s, tf32 495 TFLOP/s dense; fp64
    # on the tensor cores and fp32 outside them 67 TFLOP/s (NVIDIA H100 SXM
    # data sheet).
    # The tensor cores take uint8 at the int8 rate (mma / wgmma .u8).
    peak_flops={"bfloat16": 989e12, "float16": 989e12, "int8": 1979e12,
                "uint8": 1979e12, "tfloat32": 495e12, "float32": 67e12,
                "float64": 67e12,
                # The tensor cores take no int16, uint16, uint32 or int32:
                # plus_times of these runs on the CUDA cores' int32
                # multiply-add, 64 a clock an SM (the CUDA C++ Programming
                # Guide's throughput table, compute capability 9.0), counted
                # as 2 ops: 132 x 64 x 2 x 1.98e9.
                **dict.fromkeys(("int32", "int16", "uint16", "uint32"),
                                132 * 64 * 2 * 1.98e9)},
    # The fp32 67e12 counts an FMA as 2 ops: 132 SMs x 128 fp32 lanes x 2 x
    # 1.98 GHz (H100 SXM boost clock).  The CUDA cores issue one instruction
    # per lane per clock, 132 x 128 x 1.98e9 = 33.45e12 a second, and a
    # semiring term is two of them (map, then reduce: add and min for
    # min_plus), counted as 2 ops: so the generic-semiring ceiling in
    # 2*M*N*K ops is 33.45e12, half the FMA figure (the reference draws its
    # VPU bound from an elementwise rate too, gemm_hls_tpu/models/
    # perf_model.py).
    vpu_ops=132 * 128 * 1.98e9,
    hbm_bandwidth=3.35e12,
    vmem_bytes=SMEM_LIMIT_BYTES,
    # NVLink 4: 18 links, 450 GB/s each way per card (data sheet).
    ici_bandwidth=450e9 / 18,
    ici_links=18,
    clock_hz=1.98e9,
    tdp_watts=700.0,
    # Not fitted, and 0 for that reason: ``calibrate.fit_latch`` times the
    # same work at two grid densities, and the card's kernels run one
    # compiled tile each, so the same work always takes the same number of
    # block steps.  A step's fixed cost stays inside the measured rates.
    grid_step_overhead_s=0.0,
))

# The CPU, where the plain versions run: the reference's rough laptop-class
# numbers, kept only so the model runs without a card.
CPU = _register(ChipSpec(
    name="cpu",
    peak_flops={"bfloat16": 2e11, "float32": 2e11, "int8": 4e11},
    vpu_ops=1e11,
    hbm_bandwidth=50e9,
    vmem_bytes=32 * 1024 * 1024,
    tdp_watts=65.0,
))


def get_chip(name: str) -> ChipSpec:
    try:
        return _CHIPS[name]
    except KeyError:
        raise KeyError(f"unknown chip {name!r}; available: {sorted(_CHIPS)}") from None


def available_chips():
    return sorted(_CHIPS)


def _calibrated_spec(kind: str) -> Optional[ChipSpec]:
    """ChipSpec for a card without an entry, from its persisted
    self-calibration (``tools/calibrate.py``): the H100's data-sheet
    roofline scaled by the measured bf16 engine rate over the H100's, with
    the calibration's block-step cost (0: see ``calibrate.run_calibration``).
    None when no calibration exists (the reference's ``_calibrated_spec``,
    which scales its v5e table)."""
    from gemm_hls_tpu_torch.tools.calibrate import load_calibration

    e = load_calibration(kind)
    if not e:
        return None
    scale = e["measured_bf16_flops"] / H100.peak_flops["bfloat16"]
    return dataclasses.replace(
        H100,
        name=kind,
        peak_flops={d: p * scale for d, p in H100.peak_flops.items()},
        vpu_ops=H100.vpu_ops * scale,
        grid_step_overhead_s=e["grid_step_overhead_s"],
    )


def detect_chip(device=None) -> ChipSpec:
    """The constants of ``device`` (default: CUDA device 0 when there is
    one, else the CPU).  A card without an entry takes its persisted
    self-calibration (``python -m gemm_hls_tpu_torch.tools.calibrate``);
    without one it raises, naming that command."""
    dev = torch.device(device if device is not None else
                       ("cuda" if torch.cuda.is_available() else "cpu"))
    if dev.type == "cpu":
        return CPU
    name = torch.cuda.get_device_name(dev)
    if "H100" in name:
        return H100
    cal = _calibrated_spec(name.lower())
    if cal is not None:
        return cal
    raise NotImplementedError(
        f"no roofline constants for {name!r}: run `python -m "
        f"gemm_hls_tpu_torch.tools.calibrate` on it for a self-calibration "
        f"(the bf16 engine rate scales the H100's table)")


def specifications(cfg: GemmConfig, m: int, n: int, k: int,
                   chip: Optional[ChipSpec] = None,
                   semiring_is_mxu: bool = True) -> dict:
    """Closed-form expectations for one (config, problem, chip) triple,
    the reference's dict key for key (``PrintSpecifications``): peak and
    expected performance, runtime, tile census, communication volume and
    I/O fraction, from ``cfg``'s blocks.  :func:`~gemm_hls_tpu_torch.config.route_config`
    gives the blocks of the kernel a call runs.

    ``vmem_bytes`` is the shared memory of one thread block of the tile
    (``GemmConfig.smem_bytes``) and ``vmem_budget`` the card's limit a
    block (``config.SMEM_LIMIT_BYTES`` on the H100).
    """
    chip = chip or detect_chip()
    flops = cfg.flops(m, n, k)
    # The schedule-law volume is what the reference's comm-volume printout
    # reports; the runtime estimate uses the refined traffic.
    io_bytes = cfg.hbm_traffic_bytes(m, n, k)
    # The reference's one VPU rate for every dtype (the dict is its, key for
    # key); kernel B3's bound by dtype is ``ChipSpec.vpu_ops_for``.
    peak = chip.peak_for(cfg.dtype) if semiring_is_mxu else chip.vpu_ops

    t_compute = flops / peak
    t_memory = io_bytes / chip.hbm_bandwidth
    gm, gn, gk = cfg.grid(m, n, k)
    # Beyond the roofline (PrintSpecifications.cpp:45-50's drain model): the
    # first A / B blocks' fill before the tensor cores start, the last C
    # tile's store, and a fixed cost a block step; the fill and the store
    # extend the compute leg only (their bytes are in io_bytes already).
    in_b = itemsize(cfg.dtype)
    out_b = itemsize(cfg.tout_dtype)
    t_prologue = ((cfg.block_m * cfg.block_k + cfg.block_k * cfg.block_n)
                  * in_b / chip.hbm_bandwidth)
    t_drain = cfg.block_m * cfg.block_n * out_b / chip.hbm_bandwidth
    t_steps = gm * gn * gk * chip.grid_step_overhead_s
    t_expected = max(t_compute + t_prologue + t_drain, t_memory) + t_steps

    total_elems = m * k + k * n + m * n
    return {
        "chip": chip.name,
        "dtype": cfg.dtype,
        "problem": (m, n, k),
        "blocks": (cfg.block_m, cfg.block_n, cfg.block_k),
        "grid": (gm, gn, gk),
        "num_output_tiles": gm * gn,
        "num_k_steps": gk,
        "flops": flops,
        "peak_flops": peak,
        "ideal_runtime_s": t_compute,
        "expected_runtime_s": t_expected,
        "prologue_s": t_prologue,
        "drain_s": t_drain,
        "step_overhead_s": t_steps,
        "expected_gflops": flops / t_expected / 1e9,
        "percent_of_peak": 100.0 * t_compute / t_expected,
        "io_volume_words": cfg.io_volume_words(m, n, k),
        "io_volume_bytes": io_bytes,
        "io_fraction": cfg.io_volume_words(m, n, k) / total_elems,
        "arithmetic_intensity": flops / io_bytes,
        "ridge_intensity": peak / chip.hbm_bandwidth,
        "bound": "compute" if t_compute >= t_memory else "memory",
        "vmem_bytes": cfg.smem_bytes(),
        "vmem_budget": chip.vmem_bytes,
    }


def format_specifications(spec: dict) -> str:
    """Human-readable report, the reference CLI's printout."""
    m, n, k = spec["problem"]
    lines = [
        f"Problem: C[{m},{n}] = A[{m},{k}] . B[{k},{n}]  ({spec['dtype']}, {spec['chip']})",
        f"Blocks (outer/memory tiles): {spec['blocks']}  grid {spec['grid']}"
        f"  -> {spec['num_output_tiles']} output tiles x {spec['num_k_steps']} K-steps",
        f"Total ops: {spec['flops']:.4g}  (2*M*N*K)",
        f"Peak performance: {spec['peak_flops'] / 1e9:.1f} GOp/s",
        f"Ideal runtime: {spec['ideal_runtime_s'] * 1e3:.3f} ms",
        f"Expected runtime (roofline + overheads): "
        f"{spec['expected_runtime_s'] * 1e3:.3f} ms  [{spec['bound']}-bound]",
        f"  non-overlapped: prologue {spec['prologue_s'] * 1e6:.1f} us, "
        f"drain {spec['drain_s'] * 1e6:.1f} us, "
        f"block-step cost {spec['step_overhead_s'] * 1e6:.1f} us",
        f"Expected performance: {spec['expected_gflops']:.1f} GOp/s"
        f" ({spec['percent_of_peak']:.1f}% of peak)",
        f"Communication volume: {spec['io_volume_words']:.4g} words"
        f" ({spec['io_volume_bytes'] / 1e9:.3f} GB)",
        f"I/O fraction (vs single-read/write minimum): {spec['io_fraction']:.2f}x",
        f"Arithmetic intensity: {spec['arithmetic_intensity']:.1f} op/B"
        f" (ridge {spec['ridge_intensity']:.1f})",
        f"Shared memory a block: {spec['vmem_bytes'] / 1e3:.1f} KB"
        f" of {spec['vmem_budget'] / 1e3:.1f} KB",
    ]
    return "\n".join(lines)


def slice_passes(n_slices: int, n_diags: int) -> int:
    """int8 products per output element of the integer-slice schemes: the
    slice pairs (i, j), i, j < n_slices, on the diagonals i + j < n_diags
    (bench.py:269-272): 3 / 6 / 10 for i8x2 / i8x3 / i8x4 (n_diags =
    n_slices), 36 for the 8-slice Ozaki GEMM (8 diagonals)."""
    return sum(1 for i in range(n_slices) for j in range(n_slices)
               if i + j < n_diags)


def slice_gemm_bound(chip: ChipSpec, m: int, n: int, k: int, n_slices: int,
                     n_diags: int, n_outputs: int = 1):
    """Bound of kernels B4 (one fp32 output) and B5 (``n_outputs`` = 2: hi,
    lo): every slice pair on the int8 tensor cores, the slices read once."""
    ops = slice_passes(n_slices, n_diags) * 2.0 * m * n * k
    bytes_moved = n_slices * (m * k + k * n) + 4 * n_outputs * m * n
    return chip.bound(ops, chip.peak_for("int8"), bytes_moved)


def _esize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def flash_bound(chip: ChipSpec, bh: int, s_q: int, s_kv: int, d: int,
                dtype: torch.dtype, causal: bool, which: str = "fwd"):
    """Bound of the flash kernels on ``bh`` heads of (S_q, S_kv, D):
    ``which`` = "fwd" (4 B S_q S_kv D operations: q k^T and p v), "dq" (6:
    q k^T, dO v^T, ds k) or "dkv" (8: q k^T, dO v^T, p^T dO, ds^T q),
    halved under causal at S_q = S_kv (the live half).  Bytes: q, k, v
    (and for the backward dO, lse and delta) read once, the outputs (o and
    lse; dq; dk and dv) written once.  Rate: the tensor cores' for bf16 /
    fp16, the CUDA cores' 67 TFLOP/s for fp32."""
    esize = _esize(dtype)
    per = {"fwd": 4.0, "dq": 6.0, "dkv": 8.0}[which]
    ops = per * bh * s_q * s_kv * d * (0.5 if causal else 1.0)
    q_elems, kv_elems = bh * s_q * d, bh * s_kv * d
    rows = bh * s_q * 4                      # one fp32 per q row
    if which == "fwd":
        moved = esize * (2 * q_elems + 2 * kv_elems) + rows
    elif which == "dq":
        moved = esize * (3 * q_elems + 2 * kv_elems) + 2 * rows
    else:
        moved = esize * (2 * q_elems + 4 * kv_elems) + 2 * rows
    return chip.bound(ops, chip.peak_for(dtype), moved)


def dequant_bound(chip: ChipSpec, m: int, n: int, k: int, bits: int,
                  group_size, x_dtype: torch.dtype, out_dtype: torch.dtype):
    """Bound of kernel B13 on (M, K) x (K, N): 2 M N K operations at x's
    tensor-core rate (the CUDA cores' for fp32); bytes: x, the packed
    weights (``bits`` per element), the fp32 scales (K / group_size rows,
    one for per-channel) and y, each once."""
    groups = k // (group_size or k)
    moved = (m * k * _esize(x_dtype) + k * n * bits // 8 + 4 * groups * n
             + m * n * _esize(out_dtype))
    return chip.bound(2.0 * m * n * k, chip.peak_for(x_dtype), moved)


def w8a8_bound(chip: ChipSpec, m: int, n: int, k: int, group_size,
               x_dtype: torch.dtype, out_dtype: torch.dtype):
    """Bound of kernels B14 / B15 on (M, K) x (K, N): 2 M N K operations at
    the int8 tensor-core rate; bytes: x in its own type (the function
    quantizes it), the int8 weights, their fp32 scales and y, each once."""
    groups = k // (group_size or k)
    moved = (m * k * _esize(x_dtype) + k * n + 4 * groups * n
             + m * n * _esize(out_dtype))
    return chip.bound(2.0 * m * n * k, chip.peak_for("int8"), moved)


def grouped_bound(chip: ChipSpec, m: int, k: int, n: int, rows: int,
                  live_groups: int, dtype: torch.dtype, out_dtype=None):
    """Bound of kernel B16 on an (M, K) lhs and G experts of (K, N): 2 rows
    K N operations for the ``rows`` routed rows (sum of the group sizes,
    at most M); bytes: lhs, the weights of the ``live_groups`` experts
    that received rows, and the (M, N) output (zero tail included), each
    once."""
    moved = ((m * k + live_groups * k * n) * _esize(dtype)
             + m * n * _esize(out_dtype or dtype))
    return chip.bound(2.0 * rows * k * n, chip.peak_for(dtype), moved)


def grouped_update_bound(chip: ChipSpec, k: int, n: int, rows: int,
                         num_groups: int, dtype: torch.dtype, out_dtype=None):
    """Bound of kernel B17, (M, K) and (M, N) -> (G, K, N): 2 rows K N
    operations for the ``rows`` routed rows (sum of the group sizes, at
    most M); bytes: those rows of lhs and of the cotangent, read once, and
    the G (K, N) blocks (empty groups' zeros included), written once."""
    moved = (rows * (k + n) * _esize(dtype)
             + num_groups * k * n * _esize(out_dtype or dtype))
    return chip.bound(2.0 * rows * k * n, chip.peak_for(dtype), moved)


def ring_bound(chip: ChipSpec, m: int, n: int, k: int, n_dev: int, dtype: torch.dtype,
               out_dtype: torch.dtype = torch.float32):
    """Bound of kernel B18, the ring GEMM of ``n_dev`` ranks on one card: 2
    M N K operations at the input type's rate (int8: the int8 tensor
    cores, fp32: the CUDA cores); bytes: A, B and C once, plus the ring's
    (n_dev - 1) copies of |B|, each read once and written once.

    Over ``n_dev`` cards (not used yet: ROADMAP A7) each card does 2 M N K
    / n_dev operations while (n_dev - 1) |B| / n_dev crosses its NVLink at
    450 GB/s each way; the ring hides the transfer when that time is below
    the card's compute time.
    """
    es = _esize(dtype)
    moved = (m * k + k * n) * es + m * n * _esize(out_dtype) + 2 * (n_dev - 1) * k * n * es
    return chip.bound(2.0 * m * n * k, chip.peak_for(dtype), moved)


def cannon_bound(chip: ChipSpec, m: int, n: int, k: int, p: int, dtype: torch.dtype,
                 out_dtype: torch.dtype = torch.float32):
    """Bound of kernel B19, Cannon on a p x p grid on one card: 2 M N K
    operations; bytes: A, B and C once, the skew (|A| + |B| read and
    written) and (p - 1) shifts of |A| / p and |B| / p per grid row and
    column (|A| + |B| a step, read and written).

    Over p^2 cards (not used yet: ROADMAP A7) each card does 2 M N K / p^3
    operations a step while it sends |A| / p^2 and |B| / p^2 over NVLink at
    450 GB/s each way.
    """
    es = _esize(dtype)
    ab = (m * k + k * n) * es
    moved = ab + m * n * _esize(out_dtype) + 2 * ab + 2 * (p - 1) * ab
    return chip.bound(2.0 * m * n * k, chip.peak_for(dtype), moved)
