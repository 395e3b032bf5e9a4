"""Verification harness: seeded operands, host oracle, exact comparison.

A numpy-only copy of ``gemm_hls_tpu/utils/verify.py`` (importing that
module pulls in jax).  Same semantics as the reference's tests: seed 5,
U(1, 10) operands; a float64 BLAS oracle for (+, x) and a blocked
map/reduce sweep (or the native C++ oracle) for every other semiring;
relative 1e-3 for float32, exact for integers and bool.

numpy has no bfloat16 without jax's ml_dtypes, so ``make_operands`` draws
bfloat16 operands as float32 from the same stream; the caller casts them
(``torch.from_numpy(a).to(torch.bfloat16)``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from gemm_hls_tpu_torch.config import GemmConfig
from gemm_hls_tpu_torch.ops.semiring import get_semiring

KSEED = 5  # reference kSeed (include/MatrixMultiplication.h:14)

# N overhang of ``unaligned_sizes``: half the TPU lane width plus 3, so both
# packages test the same shapes.
_N_OVERHANG = 64 + 3


def _np_dtype(dtype) -> np.dtype:
    name = str(dtype).removeprefix("torch.")
    return np.dtype("float32" if name == "bfloat16" else name)


def _kind(dtype) -> str:
    return _np_dtype(dtype).kind


def make_operands(m: int, n: int, k: int, dtype="float32", *, seed: int = KSEED,
                  low: float = 1.0, high: float = 10.0,
                  transpose_a: bool = False, transpose_b: bool = False):
    """Seeded random (A, B) with the reference's U(1,10) distribution."""
    rng = np.random.default_rng(seed)
    d = _np_dtype(dtype)
    a_shape = (k, m) if transpose_a else (m, k)
    b_shape = (n, k) if transpose_b else (k, n)

    def draw(shape):
        if d.kind == "f":
            return rng.uniform(low, high, shape).astype(d)
        if d.kind in "iu":
            return rng.integers(int(low), int(high), shape, endpoint=True).astype(d)
        if d.kind == "b":
            return rng.integers(0, 1, shape, endpoint=True).astype(bool)
        raise ValueError(f"unsupported dtype {d}")

    return draw(a_shape), draw(b_shape)


def reference_matmul(a: np.ndarray, b: np.ndarray, semiring="plus_times", *,
                     transpose_a: bool = False, transpose_b: bool = False,
                     block_bytes: int = 64 << 20) -> np.ndarray:
    """Host-side oracle in wide precision (float64 / int64 / bool)."""
    sr = get_semiring(semiring)
    a_l = np.asarray(a).T if transpose_a else np.asarray(a)
    b_l = np.asarray(b).T if transpose_b else np.asarray(b)
    k = _kind(a_l.dtype)
    if k == "f":
        wide = np.float64
    elif k in "iu":
        wide = np.int64
    else:
        wide = np.bool_
    if sr.is_mxu:
        return a_l.astype(wide) @ b_l.astype(wide)  # cblas_dgemm analogue

    from gemm_hls_tpu_torch.utils.native import native_reference_matmul
    native = native_reference_matmul(a_l, b_l, sr.name)
    if native is not None:
        return native

    a_w, b_w = a_l.astype(wide), b_l.astype(wide)
    m, k = a_w.shape
    n = b_w.shape[1]
    itemsize = np.dtype(wide).itemsize if wide is not np.bool_ else 1
    rows = max(1, min(m, block_bytes // max(1, k * n * itemsize)))
    out = np.empty((m, n), dtype=wide)
    for r0 in range(0, m, rows):
        r1 = min(m, r0 + rows)
        mapped = sr.np_map(a_w[r0:r1, :, None], b_w[None, :, :])
        out[r0:r1] = sr.np_reduce.reduce(mapped, axis=1)
    return out


def tolerance_for(dtype) -> float:
    """Per-dtype relative tolerance: float32 is the reference's 1e-3,
    integers and bool exact."""
    name = str(dtype).removeprefix("torch.")
    if name in ("bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
                "uint32"):
        return 0.0
    return {"float64": 1e-9, "float32": 1e-3, "float16": 1e-2}.get(name, 2e-2)


def check_result(result, expected, *, rtol: float = None) -> Tuple[bool, float]:
    """Element-wise comparison; returns (ok, max relative error).  Integers
    compare through a signed diff so unsigned types cannot wrap."""
    exp = np.asarray(expected)
    res = np.asarray(result,
                     dtype=np.float64 if _kind(exp.dtype) == "f" else np.int64)
    if rtol is None:
        rtol = tolerance_for(np.asarray(result).dtype)
    if _kind(exp.dtype) in "iub":
        diff = res.astype(np.int64) - exp.astype(np.int64)
        return bool(np.all(diff == 0)), float(np.max(np.abs(diff), initial=0))
    exp = exp.astype(np.float64)
    finite_mask = np.isfinite(exp)
    # +-inf entries (unreachable pairs in min_plus) must match exactly.
    inf_ok = bool(np.array_equal(res[~finite_mask], exp[~finite_mask]))
    denom = np.maximum(np.abs(exp[finite_mask]), 1e-30)
    rel = np.abs(res[finite_mask] - exp[finite_mask]) / denom
    max_rel = float(rel.max()) if rel.size else 0.0
    return inf_ok and max_rel <= rtol, max_rel


def verify_matmul(result, expected, *, rtol: float = None, what: str = "matmul"):
    ok, err = check_result(result, expected, rtol=rtol)
    if not ok:
        raise AssertionError(
            f"{what}: verification FAILED (max rel/abs err {err:.3e}, "
            f"rtol {rtol if rtol is not None else tolerance_for(np.asarray(result).dtype)})"
        )
    return err


def unaligned_sizes(cfg: GemmConfig) -> Tuple[int, int, int]:
    """Deliberately tile-unaligned (M, N, K) — reference ``CMakeLists.txt:155-159``."""
    return (2 * cfg.block_m + 1, 2 * cfg.block_n + _N_OVERHANG,
            2 * cfg.block_k + 7)
