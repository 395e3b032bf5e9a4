"""The float64 tiles of kernels B1 / B2 (``csrc/dmma_tma.cu``, the TMA tile;
``csrc/dmma_gemm.cu``, the cp.async tile) and B3 (``csrc/simt_gemm.cuh``'s
float64 tile), on the CPU, with no card.

* The tile rule (``ops/mxu.py::dmma_tile``): over every float64 case of
  ``chip_smoke.py``'s phase 30f (WIDE_B1_CASES) and phase 32f
  (DMMA_TMA_CASES), operands laid out in memory as the phase makes them
  take the TMA tile exactly where their bases, row pitches and batch
  strides are whole 16-byte units (``chip_smoke.aligned_case``), and every
  phase-32f case does.
* B3 float64's Num gate (``ops/vpu.py::num_gate``, the rule of
  ``csrc/semiring_ops.cuh``'s gate_sum / gate_minmax / gate_product) as a
  pure function on small numpy slices: never the Num form where a mapped
  value is NaN (a term-by-term reference), and the form phase 32f expects
  for each of its fills.
* JAX parity at the new tiles' edge shapes (M, N in {127, 129, 257}, K in
  {1, 17, 33}): float64 ``matmul`` with each registered epilogue (rtol
  1e-9, the reference's float64 tolerance, scaled by the largest output)
  and float64 B3 under every semiring, +-inf and NaN sprinkled in (exact
  for the min / max semirings, rtol 1e-9 for the sums), the port's plain
  versions against the JAX front door in interpret mode.
* The text ``ops/codegen.py`` emits for a float64 semiring and a float64
  epilogue names the new tiles' launches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gemm_hls_tpu import GemmConfig as JaxConfig
from gemm_hls_tpu import matmul as jax_matmul
from gemm_hls_tpu_torch import matmul
from gemm_hls_tpu_torch.ops import codegen, mxu, vpu
from gemm_hls_tpu_torch.ops.semiring import Semiring

torch.set_num_threads(1)

F64 = torch.float64
F64_B1_CASES = ([c for c in chip_smoke.WIDE_B1_CASES if c[0] == "float64"]
                + list(chip_smoke.DMMA_TMA_CASES))
TROPICAL = ["min_plus", "max_plus", "max_min", "min_max", "max_times"]
SUMS = ["plus_times", "plus_absdiff", "plus_sqdiff", "log_plus"]


# ---- the tile rule ----------------------------------------------------------

def _cpu_operand(rows, cols, layout, lead=()):
    """A float64 (*lead, rows, cols) operand laid out as
    ``chip_smoke.wide_operand`` lays it out on the card."""
    if layout == "pitched":
        width = (cols + 1) // 2 * 2 + 2
    else:
        width = cols + (layout == "odd")
    x = torch.zeros((*lead, rows, width), dtype=F64)
    return x[..., 1:] if layout == "odd" else x[..., :cols]


def _launch_aligned(case):
    """The ``aligned`` flag ``ops/mxu.py::_launch`` computes for a case's
    operands."""
    ta, tb, bsz, m, n, k, layout, bcast = case[2], case[3], case[4], *case[5:8], *case[9:11]
    a = _cpu_operand(*((k, m) if ta else (m, k)), layout,
                     () if bsz is None or bcast == "a" else (bsz,))
    b = _cpu_operand(*((n, k) if tb else (k, n)), layout,
                     () if bsz is None or bcast == "b" else (bsz,))
    return bool(mxu._vec_ok(mxu._row_major(a)) and mxu._vec_ok(mxu._row_major(b)))


@pytest.mark.parametrize("case", F64_B1_CASES, ids=str)
def test_float64_tile_rule_on_each_phase_case(case):
    aligned = _launch_aligned(case)
    assert aligned == chip_smoke.aligned_case(case)
    assert mxu.dmma_tile(aligned) == ("tma" if aligned else "cp_async")
    if case in chip_smoke.DMMA_TMA_CASES:
        assert mxu.dmma_tile(aligned) == "tma"


@pytest.mark.parametrize("case", chip_smoke.DMMA_TMA_REPEAT_CASES, ids=str)
def test_race_check_cases_take_the_tma_tile(case):
    m, n, k, ta, tb = case
    # Never written, so the pages of the large cases are not touched.
    a = torch.empty((k, m) if ta else (m, k), dtype=F64)
    b = torch.empty((n, k) if tb else (k, n), dtype=F64)
    assert mxu.dmma_tile(bool(mxu._vec_ok(a) and mxu._vec_ok(b))) == "tma"


def test_phase30_keeps_unaligned_float64_cases_on_the_cp_async_tile():
    tiles = {mxu.dmma_tile(chip_smoke.aligned_case(c)) for c in chip_smoke.WIDE_B1_CASES
             if c[0] == "float64"}
    assert tiles == {"tma", "cp_async"}
    assert mxu.DMMA_TILES == ("tma", "cp_async")


# ---- B3 float64's Num gate --------------------------------------------------

_MAPS = {"min_plus": np.add, "max_plus": np.add, "max_min": np.minimum,
         "min_max": np.maximum, "max_times": np.multiply}
# The form phase 32f expects for each fill (True: the Num form).
_EXPECTED = {
    "pos_inf": {sr: True for sr in TROPICAL},
    "neg_inf": {sr: True for sr in TROPICAL},
    "both": {"min_plus": False, "max_plus": False, "max_min": True, "min_max": True,
             "max_times": True},
    "nan": {sr: False for sr in TROPICAL},
    "inf_zero": {"min_plus": True, "max_plus": True, "max_min": True, "min_max": True,
                 "max_times": False},
}


def _fill_slices(fill, rng):
    """A (6, 5) slice of A and a (5, 7) slice of B, U(-1, 1), with phase
    32f's fill placed so that the term (0, 0, 0) meets it."""
    a, b = rng.uniform(-1, 1, (6, 5)), rng.uniform(-1, 1, (5, 7))
    inf = np.inf
    va, vb = {"pos_inf": (inf, inf), "neg_inf": (-inf, -inf), "both": (inf, -inf),
              "nan": (np.nan, None), "inf_zero": (inf, 0.0)}[fill]
    a[0, 0], a[3, 2] = va, va
    if vb is not None:
        b[0, 0], b[4, 6] = vb, vb
    return a, b


def _can_be_nan(semiring, a, b):
    """Whether any mapped term map(a[i, k], b[k, j]) is NaN."""
    with np.errstate(invalid="ignore"):
        return bool(np.isnan(_MAPS[semiring](a[:, :, None], b[None, :, :])).any())


@pytest.mark.parametrize("semiring,fill", chip_smoke.F64_GATE_CASES, ids=str)
def test_num_gate_names_the_phase_32_form(semiring, fill):
    a, b = _fill_slices(fill, np.random.default_rng(3))
    verdict = vpu.num_gate(semiring, a, b)
    assert verdict is _EXPECTED[fill][semiring]
    assert verdict is not _can_be_nan(semiring, a, b)


@pytest.mark.parametrize("seed", range(10))
@pytest.mark.parametrize("semiring", TROPICAL)
def test_num_gate_never_runs_num_where_a_term_is_nan(semiring, seed):
    # Random slices with +-inf, NaN and exact zeros sprinkled in: the Num
    # form only where no mapped term is NaN.
    rng = np.random.default_rng(seed)
    specials = np.array([np.inf, -np.inf, np.nan, 0.0])
    for _ in range(50):
        a, b = rng.uniform(-1, 1, (4, 3)), rng.uniform(-1, 1, (3, 5))
        for x in (a, b):
            pick = rng.random(x.shape) < rng.uniform(0, 0.3)
            x[pick] = specials[rng.integers(0, 4 - (seed % 2), pick.sum())]
        if vpu.num_gate(semiring, a, b):
            assert not _can_be_nan(semiring, a, b)


def test_num_gate_has_no_verdict_for_the_sums():
    a = np.ones((2, 2))
    for sr in SUMS:
        assert vpu.num_gate(sr, a, a) is None


# ---- JAX parity at the tiles' edge shapes ----------------------------------

EDGE_SHAPES = [(127, 129, 1), (129, 257, 17), (257, 127, 33)]
JCFG = JaxConfig(block_m=128, block_n=128, block_k=64, interpret=True)
JAX_EPILOGUES = {
    "bias": lambda acc, b: acc + b,
    "bias_relu": lambda acc, b: jax.nn.relu(acc + b),
    "bias_sigmoid": lambda acc, b: jax.nn.sigmoid(acc + b),
    "bias_tanh": lambda acc, b: jnp.tanh(acc + b),
    "col_scale": lambda acc, s: acc * s,
    "scale_bias": lambda acc, s, b: acc * s + b,
    "bias_gelu": lambda acc, b: jax.nn.gelu(acc + b),
}
_N_OPERANDS = {"scale_bias": 2}


def _draw(rng, shape, edge):
    x = rng.uniform(-1, 1, shape)
    if edge:
        pick = rng.random(shape) < 0.08
        x[pick] = np.array([np.inf, -np.inf, np.nan, 0.0])[rng.integers(0, 4, pick.sum())]
    return x


def _agree(got, want, rtol):
    assert got.dtype == want.dtype and got.shape == want.shape
    if rtol == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        scale = np.abs(want[np.isfinite(want)]).max(initial=0.0)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("m,n,k", EDGE_SHAPES)
@pytest.mark.parametrize("epilogue", [None, *sorted(JAX_EPILOGUES)])
def test_float64_matmul_at_edge_shapes_matches_jax(m, n, k, epilogue):
    rng = np.random.default_rng(m + n + k)
    a, b = _draw(rng, (m, k), False), _draw(rng, (k, n), False)
    eps = [rng.uniform(-1, 1, n) for _ in range(_N_OPERANDS.get(epilogue, 1) if epilogue else 0)]
    got = matmul(torch.from_numpy(a), torch.from_numpy(b), epilogue=epilogue,
                 epilogue_operands=[torch.from_numpy(e) for e in eps]).numpy()
    kw = dict(epilogue=JAX_EPILOGUES[epilogue],
              epilogue_operands=tuple(map(jnp.asarray, eps))) if epilogue else {}
    want = np.asarray(jax_matmul(jnp.asarray(a), jnp.asarray(b),
                                 config=JCFG.replace(dtype="float64"), **kw))
    _agree(got, want, 1e-9)


@pytest.mark.parametrize("edge", [False, True], ids=["rand", "inf_nan"])
@pytest.mark.parametrize("m,n,k", EDGE_SHAPES)
@pytest.mark.parametrize("semiring", TROPICAL + SUMS)
def test_float64_semirings_at_edge_shapes_match_jax(semiring, m, n, k, edge):
    rng = np.random.default_rng(m * n + k)
    a, b = _draw(rng, (m, k), edge), _draw(rng, (k, n), edge)
    got = matmul(torch.from_numpy(a), torch.from_numpy(b), semiring=semiring).numpy()
    want = np.asarray(jax_matmul(jnp.asarray(a), jnp.asarray(b), semiring=semiring,
                                 config=JCFG.replace(dtype="float64", semiring=semiring)))
    _agree(got, want, 0.0 if semiring in TROPICAL else 1e-9)


# ---- the generated text -----------------------------------------------------

def test_float64_semiring_source_names_the_float64_tile():
    sr = Semiring("user_min_plus", torch.add, torch.minimum, float("inf"), np.add, np.minimum)
    src = codegen.semiring_source(sr, F64, F64)
    assert "return launch_simt_f64<gen_" in src and "::Semiring>(g, batch," in src
    assert "float64 tile" in src
    src32 = codegen.semiring_source(sr, torch.float32, torch.float32)
    assert "launch_simt<float, float, gen_" in src32 and "launch_simt_f64" not in src32


@pytest.mark.parametrize("ta,tb", chip_smoke.LAYOUTS)
def test_float64_epilogue_sources_name_each_tile(ta, tb):
    prog = codegen.lower_epilogue(lambda acc, b: torch.relu(acc + b), F64, [F64])
    layout = f"<{str(not ta).lower()}, {str(tb).lower()}>"
    tma = codegen.epilogue_source(prog, "dmma", F64, ta, tb, "tma")
    assert '#include "dmma_tma.cuh"' in tma and f"launch_dmma_tma_ep{layout}(g, batch" in tma
    old = codegen.epilogue_source(prog, "dmma", F64, ta, tb, "cp_async")
    assert '#include "dmma_gemm.cuh"' in old and f"launch_dmma_ep{layout}(g, batch" in old
    assert "launch_dmma_tma_ep" not in old
    fn = lambda acc, b: torch.relu(acc + b)  # noqa: E731
    specs = {codegen.epilogue_spec(fn, "dmma", F64, F64, [F64], ta, tb, "relu", tile)[0]
             for tile in mxu.DMMA_TILES}
    assert len(specs) == 2  # one library a tile


def test_float64_epilogue_source_refuses_an_unknown_tile():
    prog = codegen.lower_epilogue(lambda acc: acc * 2, F64, [])
    with pytest.raises(NotImplementedError, match="float64 tile"):
        codegen.epilogue_source(prog, "dmma", F64, False, False, "wgmma")


# ---- the ptxas comparison's skipped sources -----------------------------------

def _ptxas_log(entries):
    lines = []
    for src, fns in entries.items():
        lines.append(f"== {src}: 1.0 s, rc 0")
        for fn, regs in fns.items():
            lines += [f"ptxas info    : Function properties for {fn}",
                      "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
                      f"ptxas info    : Used {regs} registers, used 1 barriers"]
    return "\n".join(lines)


def test_ptxas_compare_skips_the_rewritten_source(tmp_path, capsys):
    from gemm_hls_tpu_torch.tools import ptxas_compare
    parent = tmp_path / "parent.log"
    change = tmp_path / "change.log"
    parent.write_text(_ptxas_log({"semiring_f32.cu": {"k32": 128},
                                  "semiring_f64.cu": {"k64": 255}}))
    change.write_text(_ptxas_log({"semiring_f32.cu": {"k32": 128},
                                  "semiring_f64.cu": {"k64_new": 246}}))
    assert ptxas_compare.main([str(parent), str(change)]) == 1
    assert ptxas_compare.main([str(parent), str(change), "--skip", "semiring_f64.cu"]) == 0
    assert "semiring_f64.cu: skipped (1 functions in the first log, 1 in the second)" in (
        capsys.readouterr().out)
    change.write_text(_ptxas_log({"semiring_f32.cu": {"k32": 130},
                                  "semiring_f64.cu": {"k64_new": 246}}))
    assert ptxas_compare.main([str(parent), str(change), "--skip", "semiring_f64.cu"]) == 1


# ---- B3's bound by semiring, and the float64 A/B tool ------------------------

_B3_SEMIRINGS = ("plus_times", "min_plus", "max_plus", "max_min", "min_max", "max_times",
                 "plus_absdiff", "plus_sqdiff", "log_plus")


@pytest.mark.parametrize("semiring", _B3_SEMIRINGS)
def test_b3_float64_bound_counts_the_semirings_instructions(semiring):
    from gemm_hls_tpu_torch.models.perf_model import H100
    n = 4096
    ms = H100.bound(2.0 * n ** 3, H100.vpu_ops_for("float64", semiring), 3 * n * n * 8)[0] * 1e3
    # plus_times is one DFMA a term; the others two FP64 instructions (an add
    # or multiply, and a compare or a second add).
    assert ms == pytest.approx(4.108 if semiring == "plus_times" else 8.217, abs=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "int8", "int32", "uint16"])
def test_b3_plus_times_rate_is_twice_only_where_the_term_is_one_fused_instruction(dtype):
    from gemm_hls_tpu_torch.models.perf_model import H100
    fused = dtype in ("float32", "bfloat16", "float16")
    assert H100.vpu_ops_for(dtype, "plus_times") == H100.vpu_ops * (2 if fused else 1)
    # min_plus: an add and a min on the scalar tile (fp32 output), and for
    # float16 / bfloat16 into their own type two terms a pair (packed).
    packed = dtype in ("bfloat16", "float16")
    assert H100.vpu_ops_for(dtype, "min_plus", "float32") == H100.vpu_ops
    assert H100.vpu_ops_for(dtype, "min_plus") == H100.vpu_ops_for(dtype) == (
        H100.vpu_ops * (2 if packed else 1))


@pytest.mark.parametrize("semiring", _B3_SEMIRINGS)
def test_f64_ab_semiring_codes_are_the_librarys(semiring):
    from gemm_hls_tpu_torch.ops.semiring import get_semiring
    from gemm_hls_tpu_torch.tools import f64_ab
    assert f64_ab.SEMIRINGS.index(semiring) == get_semiring(semiring).op_code


def test_f64_ab_needs_the_card(capsys, tmp_path):
    from gemm_hls_tpu_torch.tools import f64_ab
    assert f64_ab.main([str(tmp_path)]) == 2
    assert "no CUDA device" in capsys.readouterr().err
