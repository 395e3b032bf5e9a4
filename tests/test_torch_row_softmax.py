"""The route rule of kernel B2's row softmax (``ops.mxu.row_softmax_route``)
on the CPU: literal cases at each of its boundaries (input dtype,
alignment, the bytes of a row of P, the engine's K limit, N at and past
``ROW_SOFTMAX_MAX_N``), and ``chip_smoke.py``'s phase-6c table, which the
card tests run, held to the rule.  The numbers of the row softmax on the
CPU (the plain version) are held to the JAX package in
``tests/test_torch_attention.py``.
"""

import pytest
import torch

import chip_smoke
from gemm_hls_tpu_torch.config import ROW_SOFTMAX_MAX_N, row_softmax_fusable
from gemm_hls_tpu_torch.ops import mxu

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32


@pytest.mark.parametrize("dtype,out,n,k,aligned,route", [
    (BF16, BF16, 1024, 128, True, "wgmma"),     # attention's scores
    (F16, F16, 1024, 128, True, "wgmma"),
    (BF16, F32, 300, 64, True, "wgmma"),        # 1200-byte rows of P
    (F16, BF16, 200, 40, True, "wgmma"),
    (BF16, BF16, 300, 64, True, "wmma"),        # 600-byte rows of P
    (F16, F32, 129, 64, True, "wmma"),          # 516 bytes
    (BF16, BF16, 8, 8, True, "wgmma"),          # one 16-byte unit
    (BF16, F32, 4, 8, True, "wgmma"),
    (BF16, BF16, 4, 8, True, "wmma"),           # 8 bytes
    (BF16, BF16, 1024, 256, True, "wgmma"),     # the engine's K limit
    (F16, F32, 1024, 257, True, "wmma"),
    (BF16, BF16, 1024, 128, False, "wmma"),     # an unaligned operand
    (BF16, BF16, ROW_SOFTMAX_MAX_N, 64, True, "wgmma"),
    (F32, F32, 1024, 128, True, "simt"),        # fp32 stays on the CUDA cores
    (F32, F32, 1024, 128, False, "simt"),
    (F32, BF16, 1024, 64, True, "simt"),
])
def test_row_softmax_route(dtype, out, n, k, aligned, route):
    assert mxu.row_softmax_route(dtype, out, n, k, aligned) == route


@pytest.mark.parametrize("dtype", [BF16, F16, F32])
def test_rows_past_the_bound_reach_no_route(dtype):
    # The wrapper refuses N past ROW_SOFTMAX_MAX_N before any route is
    # chosen (attention takes its unfused branch there).
    assert row_softmax_fusable(dtype, ROW_SOFTMAX_MAX_N)
    assert not row_softmax_fusable(dtype, ROW_SOFTMAX_MAX_N + 1)


def test_row_softmax_card_table_takes_the_routes_it_names():
    # chip_smoke.py's ROW_SOFTMAX_ROUTE_CASES (phase 6c and the card tests):
    # the route each case asserts is the rule's for its dtypes, pitches,
    # batch strides, N and K, and the table reaches what the engine must
    # take: both input types, every output type, the four layouts, K at its
    # limit, N at ROW_SOFTMAX_MAX_N, batch 1 and past gridDim's 65535.
    seen, engine = set(), set()
    cases = list(chip_smoke.ROW_SOFTMAX_ROUTE_CASES) + [chip_smoke.ROW_SOFTMAX_REPEAT_CASE]
    for case in cases:
        dt, out, ta, tb, bsz, m, n, k, pitch, bcast, _, route = case
        dtype, out_dtype = getattr(torch, dt), getattr(torch, out)
        per = 16 // dtype.itemsize

        def ok(rows, cols, three_d):
            pitch_ = (cols + per - 1) // per * per + per if pitch else cols
            return pitch_ % per == 0 and (not three_d or bsz == 1 or rows * pitch_ % per == 0)

        aligned = (ok(*((k, m) if ta else (m, k)), bcast != "a")
                   and ok(*((n, k) if tb else (k, n)), bcast != "b"))
        assert row_softmax_fusable(dtype, n), case
        assert mxu.row_softmax_route(dtype, out_dtype, n, k, aligned) == route, case
        seen.add((dt, route))
        if route == "wgmma":
            engine.update({("in", dt), ("out", out), ("layout", ta, tb), ("batch", bsz),
                           ("n", n), ("k", k)})
    assert {("bfloat16", "wgmma"), ("float16", "wgmma"), ("bfloat16", "wmma"),
            ("float16", "wmma"), ("float32", "simt")} <= seen
    assert {("in", "bfloat16"), ("in", "float16"), ("out", "bfloat16"), ("out", "float16"),
            ("out", "float32"), ("k", mxu.ROW_SOFTMAX_ENGINE_MAX_K), ("n", ROW_SOFTMAX_MAX_N),
            ("batch", 1), ("batch", 70_000)} <= engine
    assert {("layout", ta, tb) for ta, tb in chip_smoke.LAYOUTS} <= engine
    # Scores large enough that exp underflows for most columns.
    assert any(case[-2] > 1 and case[-1] == "wgmma" for case in cases)
