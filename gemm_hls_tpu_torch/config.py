"""Configuration and tiling math for the PyTorch / Hopper port.

Counterpart of ``gemm_hls_tpu/config.py`` with the same ``GemmConfig`` field
names, the same tiling and communication-avoiding I/O law (``grid``,
``padded_shape``, ``io_volume_*``, ``flops``), and Hopper limits in place of
the TPU's lane/sublane/VMEM checks.

The blocks describe one CUDA thread block's C tile (``block_m x block_n``)
and its K step (``block_k``).  The kernels in ``csrc/`` are compiled for
fixed tiles.  The front door's config names the tile of :func:`kernel_route`
(``KERNEL_TILES``: the WMMA tile for bf16 / fp16 / int8 plus_times, the
FP64 tensor-core tile for float64 plus_times, the CUDA-core tile for the
rest), and ``validate`` holds it to that.  A call whose operands a
TMA map describes runs on the Hopper tile engine's larger tile instead
(``ENGINE_TILES``; ``ops/mxu.py::mxu_route`` decides at the launch), so the
I/O law describes the kernel that runs only for the config of
:func:`route_config`, which names the tile of the route the call takes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# Hopper: shared memory one thread block may use (227 KB of the SM's 256 KB;
# NVIDIA Hopper tuning guide).
SMEM_LIMIT_BYTES = 232_448

# C tiles the kernels in csrc/ are compiled for, keyed by route:
#   "tc"   — csrc/mxu_gemm.cu, tensor-core tile (bf16 / fp16 / int8 inputs;
#            the 2-D calls whose operands a TMA map describes run on the
#            Hopper tile engine's 128 x 256 tile instead, ops/mxu.py::mxu_route);
#   "simt" — csrc/simt_gemm.cuh, CUDA-core tile (fp32 / int32 plus_times in
#            mxu_gemm.cu, int16 / uint8 / uint16 / uint32 plus_times in
#            mxu_simt_int.cu, and every semiring in semiring_gemm.cu);
#   "dmma" — csrc/dmma_gemm.cu, float64 plus_times on the FP64 tensor cores
#            (mma.sync m16n8k4 .f64), its K slices in a ring of DMMA_STAGES
#            cp.async stages.
KERNEL_TILES = {"tc": (128, 128, 32), "simt": (128, 128, 16),
                "dmma": (128, 128, 16)}
DMMA_STAGES = 3

# Kernel B1 / B2 on the Hopper tile engine (csrc/wgmma_tile.cuh,
# csrc/mxu_wgmma.cuh), route "wgmma": a 128 x 256 C tile and a K step of one
# 128-byte swizzle row of the input type, in a ring of ENGINE_STAGES TMA
# stages.  ENGINE_FIXED_SMEM: the swizzle's 1024 bytes of alignment slack,
# the stages' full / empty mbarriers and six send slots' (``WgBars``), and
# the epilogue's two staging rows of 2 x 256 floats (``kMxuWgSmem``).
ENGINE_TILES = {"bfloat16": (128, 256, 64), "float16": (128, 256, 64),
                "int8": (128, 256, 128)}
ENGINE_STAGES = 4
ENGINE_FIXED_SMEM = 1024 + 8 * (2 * ENGINE_STAGES + 6) + 2 * 2 * 256 * 4

# Kernels B4 / B5 (csrc/int8_slices.cu), keyed by the most diagonals an
# instantiation keeps in registers: (block_m, block_n, K step).  Each
# diagonal is a live int32 accumulator tile, so 2 to 4 diagonals (the
# i8x2..4 tiers) take a 128 x 64 block tile and up to 9 (the 8-slice Ozaki
# GEMM, and every B5 launch, which adds its fp32 (hi, lo) pair) a 64 x 32
# one.
SLICE_TILES = {2: (128, 64, 64), 3: (128, 64, 64), 4: (128, 64, 64),
               9: (64, 32, 64)}
# Row pitch, in bytes, of a K step of the kernel's [row][k] shared-memory
# slice tiles, and the number of K steps in flight (the cp.async ring).
SLICE_ROW_PITCH = 80
SLICE_STAGES = 3
# B5 on the Hopper tile engine (csrc/int8_slices.cu: ozaki_wg_kernel,
# ops/slice_kernels.py::ozaki_route): (block_m, block_n, K slab in bytes),
# one slice pair's A and B^T slabs a stage, and the stages of its TMA ring.
OZAKI_ENGINE_TILE = (128, 128, 128)
OZAKI_ENGINE_STAGES = 6


def ozaki_engine_smem_bytes() -> int:
    """Dynamic shared memory of one engine B5 block: 1024 bytes of
    alignment slack (the swizzle's period), the ring, a full and an empty
    mbarrier a stage."""
    bm, bn, slab = OZAKI_ENGINE_TILE
    return 1024 + OZAKI_ENGINE_STAGES * ((bm + bn) * slab + 16)


def slice_route(n_diags: int, flush: bool = False) -> int:
    """The ``SLICE_TILES`` key of the instantiation that runs ``n_diags``
    diagonals: B5 (``flush``) always runs the 9-diagonal one."""
    if flush:
        return max(SLICE_TILES)
    for d in sorted(SLICE_TILES):
        if n_diags <= d:
            return d
    raise ValueError(f"no slice kernel keeps {n_diags} diagonals "
                     f"(at most {max(SLICE_TILES)})")


def slice_smem_bytes(n_used: int, max_diags: int) -> int:
    """Dynamic shared memory of one B4 / B5 block: the ring of K steps of
    every used slice's A tile and B^T tile."""
    bm, bn, _ = SLICE_TILES[max_diags]
    return SLICE_STAGES * n_used * (bm + bn) * SLICE_ROW_PITCH

# Padded row length, in elements, of one 16-deep K plane of the tensor-core
# kernel's shared-memory tiles (``TcTraits::LDP`` in csrc/mxu_gemm.cu).
_TC_PLANE_LD = {2: 24, 1: 32}
_TC_WARPS = 8

_TENSOR_CORE_DTYPES = ("bfloat16", "float16", "int8")


def torch_dtype(name) -> torch.dtype:
    """``torch.dtype`` for a dtype name ("bfloat16", "int32", ...) or dtype."""
    if isinstance(name, torch.dtype):
        return name
    d = getattr(torch, str(name), None)
    if not isinstance(d, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return d


def dtype_name(d) -> str:
    """Canonical name of a torch dtype (``torch.bfloat16`` -> "bfloat16")."""
    return str(torch_dtype(d)).removeprefix("torch.")


def itemsize(d) -> int:
    return torch_dtype(d).itemsize


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def accumulator_for(dtype) -> str:
    """fp32 for floating inputs (fp64 for fp64), int32 for integers."""
    d = torch_dtype(dtype)
    if d == torch.float64:
        return "float64"
    if d.is_floating_point:
        return "float32"
    if d == torch.bool:
        return "bool"
    return "int32"


def kernel_route(dtype, semiring: str = "plus_times") -> str:
    """Which compiled tile runs this (dtype, semiring): "tc" (bf16 / fp16 /
    int8 plus_times), "dmma" (float64 plus_times) or "simt" (the rest)."""
    if semiring == "plus_times" and dtype_name(dtype) in _TENSOR_CORE_DTYPES:
        return "tc"
    if semiring == "plus_times" and dtype_name(dtype) == "float64":
        return "dmma"
    return "simt"


def call_route(dtype, semiring: str = "plus_times", transpose_a: bool = False,
               transpose_b: bool = False, aligned: bool = True) -> str:
    """The route a 2-D or batched call takes: ``ops/mxu.py::mxu_route``'s
    rule in this module's names.  "wgmma" (the tile engine) for bf16 /
    fp16 in any layout and int8 with A (M, K) and B held (N, K), when the
    operands are ``aligned`` (16-byte bases and row pitches); "tc" (the
    WMMA tile) for the other bf16 / fp16 / int8 plus_times calls; "dmma"
    (the FP64 tensor cores, any layout and alignment) for float64
    plus_times; "simt" for the rest."""
    route = kernel_route(dtype, semiring)
    if route != "tc" or not aligned:
        return route
    if dtype_name(dtype) != "int8" or (not transpose_a and transpose_b):
        return "wgmma"
    return "tc"


def named_route(route: Optional[str], rule: str, what: str) -> str:
    """The route a launch takes: ``route`` where a caller names one (a
    tuned winner, a comparison), else ``rule``, the route rule's.  Naming
    the tile engine ("wgmma") where the rule does not give it raises (its
    TMA maps cannot describe the call), and so does a CUDA-core route
    ("simt") for inputs the rule sends to the tensor cores, or the
    reverse, and any other route for float64 ("dmma", the one kernel that
    takes it) or "dmma" for another type."""
    if route is None or route == rule:
        return rule
    if (route == "wgmma" or (route == "simt") != (rule == "simt")
            or "dmma" in (route, rule)):
        raise ValueError(f"{what}: route {route!r} cannot run this call; the route "
                         f"rule gives {rule!r}")
    return route


def route_tile(route: str, dtype) -> Tuple[int, int, int]:
    """The compiled (block_m, block_n, block_k) of ``route`` for ``dtype``."""
    if route == "wgmma":
        return ENGINE_TILES[dtype_name(dtype)]
    return KERNEL_TILES[route]


# Kernel B2's row-softmax variant (csrc/row_softmax.cu): a block owns a strip
# of ROW_SOFTMAX_ROWS rows and every column, its fp32 scores in shared memory
# with a row pitch of whole 128-column tiles plus 4, beside the operand
# staging.  The strip must fit one block's shared memory, which bounds N.
ROW_SOFTMAX_ROWS = 16
ROW_SOFTMAX_TILE_N = 128
ROW_SOFTMAX_STAGE_BYTES = 19456
ROW_SOFTMAX_DTYPES = ("bfloat16", "float16", "float32")


def row_softmax_smem_bytes(n: int) -> int:
    """Shared memory of one row-softmax block for N columns."""
    pitch = cdiv(n, ROW_SOFTMAX_TILE_N) * ROW_SOFTMAX_TILE_N + 4
    return ROW_SOFTMAX_ROWS * pitch * 4 + ROW_SOFTMAX_STAGE_BYTES


def _row_softmax_max_n() -> int:
    n = ROW_SOFTMAX_TILE_N
    while row_softmax_smem_bytes(n + ROW_SOFTMAX_TILE_N) <= SMEM_LIMIT_BYTES:
        n += ROW_SOFTMAX_TILE_N
    return n


# Longest row the fused row softmax takes: 3200 columns.  The port's
# counterpart of the JAX package's VMEM rule ``_batched_fast_path_ok``
# (gemm_hls_tpu/ops/matmul.py:174-203); past it, attention takes the
# unfused branch.  The engine route (csrc/row_softmax_wgmma.cu) keeps no
# strip and takes the same bound.
ROW_SOFTMAX_MAX_N = _row_softmax_max_n()


def row_softmax_fusable(dtype, n: int) -> bool:
    """Whether kernel B2's row-softmax variant takes rows of ``n`` columns
    of ``dtype`` inputs."""
    return dtype_name(dtype) in ROW_SOFTMAX_DTYPES and 1 <= n <= ROW_SOFTMAX_MAX_N


@dataclasses.dataclass(frozen=True)
class GemmConfig:
    """One GEMM specialization, field for field the JAX ``GemmConfig``
    minus its three TPU-only fields (``interpret``, ``vmem_limit_bytes``,
    ``debug``), which :meth:`from_reference` drops.

    ``precision`` applies to float32 plus_times: "high" and "highest" run
    IEEE fp32 FMA on CUDA cores.  float64 plus_times runs IEEE float64 FMA
    on the FP64 tensor cores (``csrc/dmma_gemm.cu``) whatever the
    precision, as the reference's float64 dot does.  "default" (the TPU's bf16 multi-pass) has
    no Hopper counterpart yet and also runs IEEE fp32 (ROADMAP B
    coverage item 6: the TF32 decision).  "i8x2" / "i8x3" / "i8x4" run fp32 through 2 / 3
    / 4 int8 slices per operand on the int8 tensor cores
    (``ops/int8_slices.py``, kernels B4 / B5): 3 / 6 / 10 int8 products,
    about 2^-14 / 2^-21 normwise and the fp32 output floor.
    """

    dtype: str = "float32"
    out_dtype: Optional[str] = None
    acc_dtype: Optional[str] = None
    block_m: int = 128
    block_n: int = 128
    block_k: int = 16
    semiring: str = "plus_times"
    transpose_a: bool = False
    transpose_b: bool = False
    pad_policy: str = "pad"
    precision: str = "high"

    _TPU_ONLY = ("interpret", "vmem_limit_bytes", "debug")

    @classmethod
    def from_reference(cls, fields: dict) -> "GemmConfig":
        """Build from ``dataclasses.asdict`` of a ``gemm_hls_tpu`` config."""
        return cls(**{k: v for k, v in fields.items()
                      if k not in cls._TPU_ONLY})

    # ---- resolved dtypes -------------------------------------------------

    @property
    def tdtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def tout_dtype(self) -> torch.dtype:
        return torch_dtype(self.out_dtype if self.out_dtype is not None
                           else self.dtype)

    @property
    def tacc_dtype(self) -> torch.dtype:
        return torch_dtype(self.acc_dtype if self.acc_dtype is not None
                           else accumulator_for(self.dtype))

    # ---- validation ------------------------------------------------------

    def validate(self, strict_alignment: bool = False,
                 route: Optional[str] = None) -> "GemmConfig":
        """Eager checks.  ``strict_alignment`` (set when a kernel will run)
        adds the Hopper ones: the tile is the one the kernel of ``route``
        ("wgmma" / "tc" / "dmma" / "simt"; default: :meth:`route`) was
        compiled for,
        its shared memory fits a block, and tile rows are whole 16-byte
        vectors."""
        if self.pad_policy not in ("pad", "strict"):
            raise ValueError(
                f"pad_policy must be 'pad' or 'strict', got {self.pad_policy!r}")
        if self.precision not in ("default", "high", "highest",
                                  "i8x2", "i8x3", "i8x4"):
            raise ValueError(
                f"precision must be one of 'default', 'high', 'highest', "
                f"'i8x2', 'i8x3', 'i8x4', got {self.precision!r}")
        for name in ("block_m", "block_n", "block_k"):
            v = getattr(self, name)
            if not (isinstance(v, int) and v > 0):
                raise ValueError(f"{name} must be a positive int, got {v!r}")
        if strict_alignment:
            route = route or self.route()
            tile = (self.block_m, self.block_n, self.block_k)
            if tile != route_tile(route, self.dtype):
                raise ValueError(
                    f"blocks {tile} are not the {route!r} kernel's compiled "
                    f"tile {route_tile(route, self.dtype)} (Hopper tiling "
                    f"constraint)")
            in_b = itemsize(self.dtype)
            for name in ("block_n", "block_k"):
                if getattr(self, name) * in_b % 16:
                    raise ValueError(
                        f"{name}={getattr(self, name)} rows of {self.dtype} "
                        f"are not whole 16-byte vectors")
            need = self.smem_bytes(route)
            if need > SMEM_LIMIT_BYTES:
                raise ValueError(
                    f"tile config needs {need} B of shared memory "
                    f"(> {SMEM_LIMIT_BYTES} B per block)")
        return self

    # ---- derived tiling math (same law as the JAX package) ---------------

    def route(self) -> str:
        """The route whose compiled tile the blocks name: "wgmma" for the
        engine's tile of a plus_times dtype it runs, else
        :func:`kernel_route`'s."""
        if (self.semiring == "plus_times"
                and (self.block_m, self.block_n, self.block_k)
                == ENGINE_TILES.get(self.dtype)):
            return "wgmma"
        return kernel_route(self.dtype, self.semiring)

    def smem_bytes(self, route: Optional[str] = None) -> int:
        """Shared memory of one thread block, as the kernels lay it out
        (default route: :meth:`route`)."""
        acc_b = itemsize(self.tacc_dtype)
        route = route or self.route()
        if route == "wgmma":
            # One 128-byte row per K slab of each A and B row, a stage.
            per_row = self.block_k * itemsize(self.dtype)
            return (ENGINE_FIXED_SMEM
                    + ENGINE_STAGES * (self.block_m + self.block_n) * per_row)
        if route == "dmma":
            # A ring of stages, each operand's K slice in the larger of its
            # two layouts: [o][k] rows of block_k + 4, [k][o] of o + 4.
            return DMMA_STAGES * sum(
                max(o * (self.block_k + 4), self.block_k * (o + 4))
                for o in (self.block_m, self.block_n)) * 8
        if route == "tc":
            in_b = itemsize(self.dtype)
            planes = cdiv(self.block_k, 16)
            ld = _TC_PLANE_LD[in_b]
            return ((self.block_m + self.block_n) * planes * ld * in_b
                    + _TC_WARPS * 16 * 16 * acc_b)
        return self.block_k * (self.block_m + self.block_n + 2) * acc_b

    def grid(self, m: int, n: int, k: int) -> Tuple[int, int, int]:
        return (cdiv(m, self.block_m), cdiv(n, self.block_n),
                cdiv(k, self.block_k))

    def padded_shape(self, m: int, n: int, k: int) -> Tuple[int, int, int]:
        gm, gn, gk = self.grid(m, n, k)
        return (gm * self.block_m, gn * self.block_n, gk * self.block_k)

    def io_volume_words(self, m: int, n: int, k: int) -> int:
        """``M*N*(1 + K/block_n + K/block_m)`` words: each C tile streams an
        A slab and a B slab once (reference ``PrintSpecifications.cpp:72-75``)."""
        gm, gn, _ = self.grid(m, n, k)
        return self.block_m * k * gm * gn + k * self.block_n * gm * gn + m * n

    def io_volume_bytes(self, m: int, n: int, k: int) -> int:
        in_b = itemsize(self.dtype)
        out_b = itemsize(self.tout_dtype)
        gm, gn, _ = self.grid(m, n, k)
        return ((self.block_m * k * gm * gn + k * self.block_n * gm * gn)
                * in_b + m * n * out_b)

    def hbm_traffic_bytes(self, m: int, n: int, k: int) -> int:
        """:meth:`io_volume_bytes` with the JAX package's one refinement
        (``gemm_hls_tpu/config.py::hbm_traffic_bytes``): when the whole K
        is one block step, A's row of blocks is read ``gm`` times, not
        ``gm * gn`` (on the card: the blocks of a row share A's slab
        through L2).  The same numbers as the reference, for the runtime
        estimate of ``models.perf_model.specifications``."""
        in_b = itemsize(self.dtype)
        out_b = itemsize(self.tout_dtype)
        gm, gn, gk = self.grid(m, n, k)
        a_fetches = gm if gk == 1 else gm * gn
        return ((self.block_m * k * a_fetches + k * self.block_n * gm * gn)
                * in_b + m * n * out_b)

    def flops(self, m: int, n: int, k: int) -> int:
        """2*M*N*K, the reference's GOp/s accounting."""
        return 2 * m * n * k

    def arithmetic_intensity(self, m: int, n: int, k: int) -> float:
        return self.flops(m, n, k) / self.io_volume_bytes(m, n, k)

    def replace(self, **kw) -> "GemmConfig":
        return dataclasses.replace(self, **kw)


def route_config(dtype="float32", *, semiring: str = "plus_times",
                 transpose_a: bool = False, transpose_b: bool = False,
                 aligned: bool = True, **kw) -> GemmConfig:
    """The config of the tile a call of ``dtype`` runs on the card: the
    blocks of :func:`call_route`'s kernel (the engine's 128 x 256 tile for
    an aligned bf16 / fp16 call), so its I/O law and shared memory are
    those of the kernel that runs."""
    route = call_route(dtype, semiring, transpose_a, transpose_b, aligned)
    bm, bn, bk = route_tile(route, dtype)
    return GemmConfig(dtype=dtype_name(dtype), block_m=bm, block_n=bn,
                      block_k=bk, semiring=semiring, transpose_a=transpose_a,
                      transpose_b=transpose_b, **kw)


def default_config(dtype="float32", **kw) -> GemmConfig:
    """The compiled CTA tile of the kernel that runs ``dtype`` under
    ``kw['semiring']`` (plus_times by default)."""
    name = dtype_name(dtype)
    bm, bn, bk = KERNEL_TILES[kernel_route(name, kw.get("semiring",
                                                        "plus_times"))]
    base = dict(block_m=bm, block_n=bn, block_k=bk)
    base.update(kw)
    return GemmConfig(dtype=name, **base)
