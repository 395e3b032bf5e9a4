"""Every operand type the reference's GEMM kernels take (float64, float16,
int8, int16, uint8, uint16, uint32, int64), the port against the JAX
package on the CPU.

For each type and each registered semiring the JAX front door computes for
it (in interpret mode, as ``tests/conftest.py`` runs it, x64 on), the same
seeded numpy operands go through ``gemm_hls_tpu.matmul`` and
``gemm_hls_tpu_torch.matmul``, 2-D at (64, 48, 40) and batched at
(3, 32, 24, 16); then the edge values of ``chip_smoke.py``'s phase 30 (f),
the float64 gradient against ``jax.grad``, the tropical subgradients on
float16 and float64, int64 plus_times refused by both, and the route rule
(``call_route``, ``mxu_route``, ``dtype_code``) for each new type, with no
card.  The CUDA kernels are held to their plain versions on the card by
``tests/test_torch_kernels.py`` and ``chip_smoke.py``.

Tolerances: exact for integer results and for the min / max semirings (the
same terms, min / max exact); rtol 1e-9 for float64 sums (the reference's
float64 tolerance, ``tests/test_matmul.py``); rtol 1e-2 for float16 sums
(its float16 tolerance); 1e-5 for the tropical subgradients, whose fp32
routing sums run in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gemm_hls_tpu import GemmConfig as JaxConfig
from gemm_hls_tpu import matmul as jax_matmul
from gemm_hls_tpu_torch import _build, matmul
from gemm_hls_tpu_torch.config import (
    ENGINE_TILES, KERNEL_TILES, GemmConfig, call_route, default_config, kernel_route, named_route,
    route_config,
)
from gemm_hls_tpu_torch.models.perf_model import H100
from gemm_hls_tpu_torch.ops import mxu, vpu
from gemm_hls_tpu_torch.tools import autotune

torch.set_num_threads(1)

FLOATS = ["float64", "float16"]
INTS = ["int8", "int16", "uint8", "uint16", "uint32", "int64"]
TROPICAL = ["min_plus", "max_plus", "max_min", "min_max", "max_times"]
SUMS = ["plus_times", "plus_absdiff", "plus_sqdiff", "log_plus"]
# The (dtype, semiring) pairs the JAX front door computes in interpret mode:
# every semiring on the floats; on the integers plus_times (not int64: its
# int32 accumulator is narrower than the inputs) and the min / max
# semirings (its int32 sums of plus_absdiff / plus_sqdiff widen to int64
# under x64 and fail, and logaddexp takes no integers).
PAIRS = ([(dt, sr) for dt in FLOATS for sr in TROPICAL + SUMS]
         + [(dt, sr) for dt in INTS for sr in TROPICAL + ["plus_times"]
            if (dt, sr) != ("int64", "plus_times")])
JCFG = JaxConfig(block_m=16, block_n=128, block_k=64, interpret=True)


def _draw(rng, shape, dtype, edge=False):
    """Seeded operands: floats U(-1, 1), integers over their whole range
    (int64 within 2^40: above 2^32, wrapped at the accumulator); ``edge``
    sprinkles in the type's extremes, and +-inf and NaN for floats."""
    d = np.dtype(dtype)
    if d.kind == "f":
        x = rng.uniform(-1, 1, shape)
        specials = [np.inf, -np.inf, np.nan, 0.0]
    else:
        info = np.iinfo(d)
        lo, hi = (-2**40, 2**40) if d == np.int64 else (int(info.min), int(info.max))
        x = rng.integers(lo, hi, shape, endpoint=True)
        specials = [int(info.min), int(info.max), 0, 1, int(info.max) // 2 + 1]
        if d == np.int64:
            specials += [2**32 + 5, -2**33 + 7]
    if edge:
        pick = rng.random(shape) < 0.1
        x = np.where(pick, np.asarray(specials, dtype=x.dtype)[
            rng.integers(0, len(specials), shape)], x)
    return x.astype(d)


def _tol(dtype, semiring):
    if np.dtype(dtype).kind != "f" or semiring in TROPICAL:
        return 0.0
    return 1e-9 if dtype == "float64" else 1e-2


def _agree(got, want, rtol):
    assert got.dtype == want.dtype and got.shape == want.shape
    if rtol == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        scale = np.abs(want).max(initial=0.0)
        np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64),
                                   rtol=rtol, atol=rtol * scale)


def _jax(a, b, semiring, **kw):
    cfg = JCFG.replace(dtype=str(a.dtype), semiring=semiring)
    return np.asarray(jax_matmul(jnp.asarray(a), jnp.asarray(b), semiring=semiring,
                                 config=cfg, **kw))


def _port(a, b, semiring, **kw):
    return matmul(torch.from_numpy(a), torch.from_numpy(b), semiring=semiring, **kw).numpy()


@pytest.mark.parametrize("dtype,semiring", PAIRS, ids=str)
def test_2d_matches_jax(dtype, semiring):
    rng = np.random.default_rng(21)
    a, b = _draw(rng, (64, 48), dtype), _draw(rng, (48, 40), dtype)
    _agree(_port(a, b, semiring), _jax(a, b, semiring), _tol(dtype, semiring))


@pytest.mark.parametrize("dtype,semiring", PAIRS, ids=str)
def test_batched_matches_jax(dtype, semiring):
    rng = np.random.default_rng(22)
    a, b = _draw(rng, (3, 32, 16), dtype), _draw(rng, (3, 16, 24), dtype)
    _agree(_port(a, b, semiring), _jax(a, b, semiring), _tol(dtype, semiring))


# Phase 30 (f)'s edges: int8 -128 / 127 on the tensor-core type, uint32
# above 2^31, int64 above 2^32, float16 / float64 +-inf and NaN under the
# min / max semirings, odd K (1, 3, 33) for the 1- and 2-byte types, both
# operands transposed.
EDGES = ([("int8", sr, k) for sr in ("plus_times", "min_plus") for k in (1, 33)]
         + [("uint32", sr, 33) for sr in ("plus_times", "max_min", "min_plus")]
         + [("int64", sr, 33) for sr in ("min_plus", "max_plus", "max_min")]
         + [(dt, sr, 33) for dt in FLOATS for sr in ("min_plus", "max_plus", "max_min",
                                                    "min_max")]
         + [(dt, sr, k) for dt in ("uint8", "int16", "uint16") for sr in ("plus_times", "min_max")
            for k in (3,)])


@pytest.mark.parametrize("dtype,semiring,k", EDGES, ids=str)
def test_edge_values_match_jax(dtype, semiring, k):
    rng = np.random.default_rng(23)
    a, b = _draw(rng, (k, 40), dtype, edge=True), _draw(rng, (24, k), dtype, edge=True)
    kw = dict(transpose_a=True, transpose_b=True)
    _agree(_port(a, b, semiring, **kw), _jax(a, b, semiring, **kw), _tol(dtype, semiring))


def test_float64_gradient_matches_jax_grad():
    rng = np.random.default_rng(24)
    a, b, g = rng.standard_normal((64, 48)), rng.standard_normal((48, 40)), \
        rng.standard_normal((64, 40))
    ja, jb = jax.grad(lambda x, y: (jax_matmul(x, y, config=JCFG.replace(dtype="float64"))
                                    * g).sum(), argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta, tb = torch.from_numpy(a).requires_grad_(), torch.from_numpy(b).requires_grad_()
    matmul(ta, tb).backward(torch.from_numpy(g))
    for got, want in ((ta.grad, ja), (tb.grad, jb)):
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                                   atol=1e-9 * np.abs(want).max())


@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("semiring", ["min_plus", "max_min"])
def test_tropical_subgradients_match_jax(dtype, semiring):
    rng = np.random.default_rng(25)
    a = rng.standard_normal((32, 24)).astype(dtype)
    b = rng.standard_normal((24, 16)).astype(dtype)
    g = rng.standard_normal((32, 16))

    def loss(x, y):
        out = jax_matmul(x, y, semiring=semiring,
                         config=JCFG.replace(dtype=dtype, semiring=semiring))
        return (out.astype(jnp.float64) * g).sum()

    ja, jb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta, tb = torch.from_numpy(a).requires_grad_(), torch.from_numpy(b).requires_grad_()
    (matmul(ta, tb, semiring=semiring).double() * torch.from_numpy(g)).sum().backward()
    rtol = 1e-5 if dtype == "float64" else 1e-2
    for got, want in ((ta.grad, ja), (tb.grad, jb)):
        assert got.dtype == getattr(torch, dtype)
        want = np.asarray(want, dtype=np.float64)
        np.testing.assert_allclose(got.double().numpy(), want, rtol=rtol,
                                   atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("batched", [False, True])
def test_int64_plus_times_raises_in_both(batched):
    shape_a, shape_b = ((3, 4, 5), (3, 5, 2)) if batched else ((4, 5), (5, 2))
    a, b = np.ones(shape_a, np.int64), np.ones(shape_b, np.int64)
    with pytest.raises(TypeError):
        jax_matmul(jnp.asarray(a), jnp.asarray(b))
    for backend in (None, "torch"):
        with pytest.raises(TypeError, match="int64 plus_times"):
            matmul(torch.from_numpy(a), torch.from_numpy(b), backend=backend)


# ---- the route rule, with no card ----------------------------------------

@pytest.mark.parametrize("dtype", ["float64", *INTS[1:4], "uint32"])
@pytest.mark.parametrize("ta,tb", chip_smoke.LAYOUTS)
@pytest.mark.parametrize("aligned", [False, True])
def test_plus_times_routes_of_the_new_types(dtype, ta, tb, aligned):
    # The same route in every layout and at every alignment: float64 on the
    # FP64 tensor cores, the integers on the engine as byte planes (the
    # front door's default config names the CUDA-core tile, as fp32's does,
    # and the launch takes the rule's route; route_config names the
    # engine's tile).
    want = "dmma" if dtype == "float64" else "wgmma"
    tile = "dmma" if dtype == "float64" else "simt"
    assert call_route(dtype, "plus_times") == want
    assert mxu.mxu_route(getattr(torch, dtype)) == want
    assert kernel_route(dtype) == tile
    cfg = default_config(dtype).validate(strict_alignment=True)
    assert cfg.route() == tile and (cfg.block_m, cfg.block_n, cfg.block_k) == KERNEL_TILES[tile]
    if want == "wgmma":
        cfg = route_config(dtype, transpose_a=ta, transpose_b=tb).validate(strict_alignment=True)
        assert cfg.route() == "wgmma"
        assert (cfg.block_m, cfg.block_n, cfg.block_k) == ENGINE_TILES[dtype]
        # Into float64 / int64, which the engine does not store: the CUDA cores.
        for out in ("float64", "int64"):
            assert call_route(dtype, "plus_times", out) == "simt"
            assert mxu.mxu_route(getattr(torch, dtype), getattr(torch, out)) == "simt"


@pytest.mark.parametrize("dtype", FLOATS + INTS)
def test_semiring_routes_and_codes_of_the_new_types(dtype):
    d = getattr(torch, dtype)
    assert call_route(dtype, "min_plus") == "simt"
    code = _build.dtype_code(d, wide=True)
    assert code == {"float64": 5, "float16": 2, "int8": 3, "int16": 6, "uint8": 7,
                    "uint16": 8, "uint32": 9, "int64": 10}[dtype]
    assert d in vpu._KERNEL_DTYPES
    assert GemmConfig(dtype=dtype).tacc_dtype == vpu._KERNEL_DTYPES[d]
    if code >= 5:  # the other kernels keep refusing the wide types
        with pytest.raises(NotImplementedError, match="ROADMAP B coverage item"):
            _build.dtype_code(d)


@pytest.mark.parametrize("route,rule", [("wmma", "dmma"), ("simt", "dmma"), ("dmma", "simt"),
                                        ("dmma", "wmma"), ("wgmma", "dmma")])
def test_no_other_route_runs_float64(route, rule):
    with pytest.raises(ValueError, match="cannot run"):
        named_route(route, rule, "B1")
    assert named_route("dmma", "dmma", "B1") == "dmma"


def test_cached_winner_never_names_a_route_that_cannot_run_float64(tmp_path):
    cache = tmp_path / "tune.json"
    key = autotune._key("cpu", "float64", "plus_times", 512, 512, 512)
    for route in ("wmma", "simt", "wgmma"):
        autotune._store(str(cache), {key: {"block_m": 128, "block_n": 128, "block_k": 16,
                                           "route": route}})
        assert autotune.cached_winner(512, 512, 512, dtype="float64", cache_path=str(cache),
                                      device="cpu") is None
    autotune._store(str(cache), {key: {"block_m": 128, "block_n": 128, "block_k": 16,
                                       "route": "dmma"}})
    cfg, route = autotune.cached_winner(512, 512, 512, dtype="float64", cache_path=str(cache),
                                        device="cpu")
    assert route == "dmma" and cfg.route() == "dmma"


@pytest.mark.parametrize("case", chip_smoke.WIDE_B1_CASES, ids=str)
def test_phase30_b1_cases_name_the_rule_route(case):
    # The rule reads the type alone: layout and alignment choose only what
    # an engine launch packs first.
    assert mxu.mxu_route(getattr(torch, case[0])) == case[-1]


def test_phase30_b3_cases_cover_every_type_and_semiring():
    pairs = {(c[0], c[1]) for c in chip_smoke.WIDE_B3_CASES}
    want = {(dt, sr) for dt in FLOATS + INTS for sr in TROPICAL + SUMS
            if sr != "log_plus" or dt in FLOATS}
    assert pairs >= want
    assert set(chip_smoke.B3_SOURCES) == set(FLOATS + INTS)


def test_bounds_of_the_new_kernels():
    # B1 float64 on the FP64 tensor cores: 67e12 FLOP/s (data sheet).
    t, by = H100.bound(2.0 * 8192 ** 3, H100.peak_for("float64"), 3 * 8192 ** 2 * 8)
    assert by == "operations" and t == pytest.approx(16.41e-3, rel=1e-3)
    # B3 min_plus: a term is an fp32 add and a min on 64 lanes an SM a clock,
    # or one fused int32 add-and-min on 64 (the same rate), or two float64
    # ones on 64 (half of it); float16 / bfloat16 into their own type issue
    # one instruction a term on pairs (twice it), into fp32 the scalar one.
    for dt in ("float16", "bfloat16"):
        assert H100.vpu_ops_for(dt) == 2 * H100.vpu_ops
        assert H100.vpu_ops_for(dt, "min_plus", "float32") == H100.vpu_ops
    for dt in ("float32", *INTS, "int32"):
        assert H100.vpu_ops_for(dt) == H100.vpu_ops
    assert H100.vpu_ops_for("float64") == H100.vpu_ops / 2
    # max_min: two min / max a term on 64 lanes (fp32), 1.5 with the int32
    # three-input max, two on pairs of two terms (packed).
    assert H100.vpu_ops_for("float32", "max_min") == H100.vpu_ops / 2
    assert H100.vpu_ops_for("uint32", "max_min") == pytest.approx(H100.vpu_ops * 2 / 3)
    assert H100.vpu_ops_for("float16", "max_min") == H100.vpu_ops
    # B1's integer CUDA-core route: the int32 multiply-add, 64 a clock an SM,
    # for the types the tensor cores do not take; uint8 is bound at the
    # tensor cores' int8 rate, which they also run uint8 at.
    for dt in ("int16", "uint16", "uint32"):
        assert H100.peak_for(dt) == pytest.approx(132 * 64 * 2 * 1.98e9)
    assert H100.peak_for("uint8") == H100.peak_for("int8") == 1979e12
