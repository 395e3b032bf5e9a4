"""Kernel B1's module (``gemm_hls_tpu_torch/ops/mxu.py``) against the JAX
package's ``pallas_mxu.mxu_matmul``.

Each case feeds the same numpy arrays to both.  The JAX side runs its
Pallas kernel in interpret mode with the small blocks its own tests use;
the port's side runs the plain version, as a CPU tensor does.  The CUDA
kernel itself is checked on the card by ``tests/test_torch_kernels.py``
and ``chip_smoke.py``.

Tolerances: exact for integer outputs; relative 1e-5 for fp32 sums (the
two sum in different orders); bf16 inputs are rounded identically on both
sides and compared in fp32 at relative 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemm_hls_tpu import GemmConfig as JaxConfig
from gemm_hls_tpu.ops import pallas_mxu

from gemm_hls_tpu_torch.config import default_config, packed_operands
from gemm_hls_tpu_torch.ops import mxu
from gemm_hls_tpu_torch.utils import make_operands, reference_matmul, verify_matmul

torch.set_num_threads(1)

# (input dtype, output dtype, relative tolerance)
DTYPES = [("float32", "float32", 1e-5), ("bfloat16", "float32", 1e-5),
          ("int8", "int32", 0.0), ("int32", "int32", 0.0)]


def _inputs(m, n, k, dtype, ta, tb, seed=5):
    draw = "int32" if dtype.startswith("int") else "float32"
    return make_operands(m, n, k, draw, seed=seed, transpose_a=ta,
                         transpose_b=tb)


def _jax(a, b, dtype, out, ta, tb):
    cfg = JaxConfig(dtype=dtype, out_dtype=out, block_m=16, block_n=128,
                    block_k=64, interpret=True)
    return np.asarray(pallas_mxu.mxu_matmul(
        jnp.asarray(a, dtype), jnp.asarray(b, dtype), cfg=cfg,
        transpose_a=ta, transpose_b=tb, interpret=True)).astype(
            np.float32 if out.startswith("float") else np.int64)


def _port(a, b, dtype, out, ta, tb):
    dt = getattr(torch, dtype)
    cfg = default_config(dtype, out_dtype=out)
    got = mxu.mxu_matmul(torch.from_numpy(a).to(dt),
                         torch.from_numpy(b).to(dt), cfg=cfg,
                         transpose_a=ta, transpose_b=tb)
    assert got.dtype == getattr(torch, out)
    return got.cpu().numpy()


def _agree(got, exp, rtol):
    if rtol == 0.0:
        np.testing.assert_array_equal(got, exp)
    else:
        np.testing.assert_allclose(got, exp, rtol=rtol, atol=0)


@pytest.mark.parametrize("dtype,out,rtol", DTYPES)
@pytest.mark.parametrize("ta,tb", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_layouts_unaligned(dtype, out, rtol, ta, tb):
    a, b = _inputs(65, 140, 131, dtype, ta, tb)
    got = _port(a, b, dtype, out, ta, tb)
    _agree(got, _jax(a, b, dtype, out, ta, tb), rtol)
    # The repo's own contract against the float64 / int64 oracle.
    if out == "float32":
        rounded = torch.from_numpy(a).to(getattr(torch, dtype)).float().numpy()
        rounded_b = torch.from_numpy(b).to(getattr(torch, dtype)).float().numpy()
        verify_matmul(got, reference_matmul(rounded, rounded_b,
                                            transpose_a=ta, transpose_b=tb))


@pytest.mark.parametrize("dtype,out,rtol", DTYPES)
@pytest.mark.parametrize("m,n,k", [(1, 1, 1), (7, 13, 5), (33, 129, 130)])
def test_tiny_and_odd(dtype, out, rtol, m, n, k):
    a, b = _inputs(m, n, k, dtype, False, False, seed=9)
    _agree(_port(a, b, dtype, out, False, False),
           _jax(a, b, dtype, out, False, False), rtol)


def test_int8_output_wraps_like_reference():
    # int8 -> int8 output: the int32 sum is truncated at the store on both
    # sides (two's complement), as astype does.
    a, b = _inputs(9, 20, 40, "int8", False, False)
    np.testing.assert_array_equal(_port(a, b, "int8", "int8", False, False),
                                  _jax(a, b, "int8", "int8", False, False))


def test_transposed_operands_match_copies():
    # Transposed operands arrive as given; the result matches the copy.
    a, b = _inputs(40, 50, 60, "float32", True, True)
    cfg = default_config("float32")
    ta = torch.from_numpy(a)
    tb = torch.from_numpy(b)
    got = mxu.mxu_matmul(ta, tb, cfg=cfg, transpose_a=True, transpose_b=True)
    ref = mxu.mxu_matmul(ta.T.contiguous(), tb.T.contiguous(), cfg=cfg)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6)


def test_launch_counter_ignores_plain_calls():
    before = mxu.mxu_matmul.launches
    a, b = _inputs(8, 8, 8, "float32", False, False)
    mxu.mxu_matmul(torch.from_numpy(a), torch.from_numpy(b),
                   cfg=default_config("float32"))
    assert mxu.mxu_matmul.launches == before


@pytest.mark.parametrize("bad", ["shape", "mixed"])
def test_wrapper_rejects_bad_operands(bad):
    cfg = default_config("float32")
    a = torch.ones(4, 5)
    b = torch.ones(6, 3) if bad == "shape" else torch.ones(5, 3, device="meta")
    with pytest.raises(ValueError):
        mxu.mxu_matmul(a, b, cfg=cfg)


# ---- the kernel route (ops.mxu.mxu_route): pure, so it is checked here ------

@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("ta,tb", [(False, False), (True, False),
                                   (False, True), (True, True)])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("batched", [False, True])
def test_route_of_16_bit_inputs(dtype, ta, tb, aligned, batched):
    # Every layout reaches the engine (MN-major operands through wgmma's
    # transpose bits), 2-D (B1) and batched (B2) alike, at every alignment:
    # the wrapper's alignment test on operands of that rank (a batched
    # operand's batch stride included) decides only which operands the pack
    # pass copies K-major first.
    dt = getattr(torch, dtype)
    lead = (3,) if batched else ()
    cols = 64 if aligned else 60  # 128- or 120-byte rows
    a = torch.zeros(lead + (40, cols), dtype=dt)
    b = torch.zeros(lead + (cols, 64), dtype=dt)
    ok = bool(mxu._vec_ok(a) and mxu._vec_ok(b))
    assert ok == aligned
    assert mxu.mxu_route(dt) == "wgmma"
    packs = packed_operands(dt, ta, tb, mxu._vec_ok(a), mxu._vec_ok(b))
    assert packs == (not aligned, False)


@pytest.mark.parametrize("ta,tb", [(False, False), (True, False),
                                   (False, True), (True, True)])
@pytest.mark.parametrize("aligned", [True, False])
def test_route_of_int8_inputs(ta, tb, aligned):
    # int8 wgmma reads K-major operands only, A (M, K) and B held (N, K):
    # every other layout, and every unaligned operand, reaches the engine
    # after the pack pass turns it K-major.
    assert mxu.mxu_route(torch.int8) == "wgmma"
    assert packed_operands(torch.int8, ta, tb, aligned, aligned) == (
        ta or not aligned, not tb or not aligned)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("aligned", [True, False])
def test_route_of_cuda_core_inputs(dtype, aligned):
    # fp32 takes the engine's TF32 passes and wrapping int32 its byte
    # planes at every alignment (each split pass reads any pitch), packing
    # nothing.
    assert mxu.mxu_route(getattr(torch, dtype)) == "wgmma"
    assert packed_operands(dtype, False, True, aligned, aligned) == (False, False)


@pytest.mark.parametrize("shape,col0,dtype,aligned", [
    ((64, 1024), 0, "bfloat16", True),     # 2048-byte rows
    ((64, 1000), 0, "bfloat16", True),     # 2000-byte rows: whole 16-byte units
    ((64, 100), 0, "bfloat16", False),     # 200-byte rows
    ((64, 136), 8, "bfloat16", True),      # a view 16 bytes into its rows
    ((64, 136), 4, "bfloat16", False),     # a view 8 bytes in: the base is off
    ((64, 1100), 0, "int8", False),        # 1100-byte rows
    ((64, 1104), 0, "int8", True),
    ((64, 1104), 16, "int8", True),
])
def test_alignment_the_route_reads(shape, col0, dtype, aligned):
    # The wrapper's alignment test (bases and row pitches whole 16-byte
    # units), on storage the size of the operand and on views into it.
    x = torch.zeros(shape, dtype=getattr(torch, dtype))[:, col0:]
    assert bool(mxu._vec_ok(x)) == aligned


@pytest.mark.parametrize("shape,rows,aligned", [
    ((4, 40, 64), None, True),      # 128-byte rows, 5120-byte examples
    ((4, 3, 8), None, True),        # 16-byte rows, 48-byte examples
    ((4, 3, 68), 64, False),        # a view: 128-byte rows 136 bytes apart
    ((4, 5, 64), None, True),
    ((1, 3, 12), None, False),      # 24-byte rows
])
def test_alignment_of_batched_operands(shape, rows, aligned):
    # Base, row pitch and batch stride whole 16-byte units; a batch of one
    # has no batch stride to step.
    x = torch.zeros(shape, dtype=torch.bfloat16)
    x = x[..., :rows] if rows else x
    assert bool(mxu._vec_ok(x)) == aligned
    assert mxu._strides(x)[1] == (x.stride(0) if shape[0] > 1 else 0)


def test_batch_stride_of_a_single_example_is_unused():
    # (1, M, K) of a pitched view: its stride(0) is not a 16-byte unit,
    # but one example never steps it, so the engine can take it.
    x = torch.zeros((1, 3, 12), dtype=torch.bfloat16)[..., :8]
    assert mxu._strides(x) == (12, 0)
    y = torch.zeros((1, 3, 8), dtype=torch.bfloat16).as_strided((1, 3, 8), (25, 8, 1))
    assert bool(mxu._vec_ok(y))


def test_plain_calls_leave_the_route_alone():
    mxu.mxu_matmul.last_route = None
    a, b = _inputs(8, 8, 8, "float32", False, False)
    mxu.mxu_matmul(torch.from_numpy(a), torch.from_numpy(b),
                   cfg=default_config("float32"))
    assert mxu.mxu_matmul.last_route is None


def test_b2_card_table_takes_the_routes_it_names():
    # chip_smoke.py's B2_ROUTE_CASES (phase 6 and the card tests): the
    # route each case asserts is mxu_route's for its layout, pitches and
    # batch strides (the engine), and every tensor-core type has cases read
    # in place and cases the pack pass copies first (each of those again on
    # WMMA, named), fp32 an unaligned case (again on the CUDA cores).
    import chip_smoke

    seen = set()
    for case in list(chip_smoke.B2_ROUTE_CASES) + [chip_smoke.B2_REPEAT_CASE]:
        dt, _, ta, tb, bsz, m, n, k, pitch, bcast, _, route = case
        dtype = getattr(torch, dt)
        per = 16 // dtype.itemsize

        def ok(rows, cols, three_d):
            pitch_ = (cols + per - 1) // per * per + per if pitch else cols
            return pitch_ % per == 0 and (not three_d or bsz == 1 or rows * pitch_ % per == 0)

        al_a, al_b = ok(*((k, m) if ta else (m, k)), bcast != "a"), \
            ok(*((n, k) if tb else (k, n)), bcast != "b")
        assert mxu.mxu_route(dtype) == route == "wgmma", case
        assert chip_smoke.operands_aligned(*chip_smoke.b2_case_layout(case)) == (al_a, al_b)
        packs = packed_operands(dtype, ta, tb, al_a, al_b)
        assert chip_smoke.case_packs(*chip_smoke.b2_case_layout(case)) == packs, case
        old = chip_smoke.retired_route(*chip_smoke.b2_case_layout(case))
        seen.add((dt, old or ("packed" if any(packs) else "in place")))
    assert {(dt, r) for dt in ("bfloat16", "int8", "float16") for r in ("in place", "wmma")} \
        <= seen
    assert ("float32", "simt") in seen


def test_card_tables_take_the_routes_they_name():
    # chip_smoke.py's B1 route tables (phases 3a / 6a and the card tests):
    # the route each case asserts is mxu_route's for its layout and
    # pitches (the engine), and every tensor-core type has cases read in
    # place and cases the pack pass copies first (each again on WMMA,
    # named: their retired route).
    import chip_smoke

    seen = set()
    for case in chip_smoke.B1_ROUTE_CASES + chip_smoke.B1_EPILOGUE_ROUTE_CASES:
        dt, _, ta, tb, m, n, k, pitch, _, route = case
        dtype = getattr(torch, dt)
        per = 16 // dtype.itemsize

        def row(cols):
            return (cols + per - 1) // per * per + per if pitch else cols

        al_a, al_b = row(m if ta else k) % per == 0, row(k if tb else n) % per == 0
        assert mxu.mxu_route(dtype) == route == "wgmma", case
        packs = packed_operands(dtype, ta, tb, al_a, al_b)
        assert chip_smoke.case_packs(*chip_smoke.b1_case_layout(case)) == packs, case
        assert chip_smoke.retired_route(*chip_smoke.b1_case_layout(case)) == (
            "wmma" if any(packs) else None), case
        seen.add((dt, "packed" if any(packs) else "in place"))
    assert seen == {(dt, r) for dt in ("bfloat16", "float16", "int8")
                    for r in ("in place", "packed")}


def test_bias_gelu_card_tables_take_the_routes_they_name():
    # chip_smoke.py's phase 27b tables: the bias_gelu epilogue on B1's
    # engine (in place, after the pack pass, after the split of unaligned
    # fp32; the packed and unaligned cases again on WMMA and the CUDA
    # cores, named) and on B2's engine, each the route mxu_route gives its
    # layout and pitches.
    import chip_smoke

    seen = set()
    for case in chip_smoke.BIAS_GELU_ROUTE_CASES:
        dt, _, ta, tb, m, n, k, pitch, ep, route = case
        dtype = getattr(torch, dt)
        per = 16 // dtype.itemsize

        def row(cols):
            return (cols + per - 1) // per * per + per if pitch else cols

        aligned = row(m if ta else k) % per == 0 and row(k if tb else n) % per == 0
        assert ep == "bias_gelu" and mxu.mxu_route(dtype) == route, case
        seen.add(chip_smoke.retired_route(*chip_smoke.b1_case_layout(case)) or route)
    # The engine in place, and each retired route named again.
    assert seen == {"wgmma", "wmma", "simt"}
    for case in chip_smoke.BIAS_GELU_B2_CASES:
        dt, _, ta, tb, bsz, m, n, k, pitch, bcast, ep, route = case
        assert ep == "bias_gelu" and route == "wgmma" and pitch, case
        assert mxu.mxu_route(getattr(torch, dt)) == route, case
