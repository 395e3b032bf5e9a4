"""User-defined semirings and Python-callable epilogues compiled for the card
(``gemm_hls_tpu_torch/ops/codegen.py``), on the CPU.

* The op table: for every op, the IR's torch evaluator equals the callable
  itself, bit for bit (NaN where it has NaN), in float32, float64 and
  int32, on inputs that hold NaN, +-inf, -0 and the int32 extremes.
* The C++ text: typed hex constants, no double arithmetic in a float
  functor, the built-ins' helpers (so a re-expressed built-in gives its
  bits on the card).
* Refusals: every callable the functor cannot express raises
  NotImplementedError naming the op and the ROADMAP item before any build
  or nvcc lookup.
* The generated library's name: stable across processes, different for two
  semirings that differ only in a constant or share a name.
* Parity with the JAX package: its ``matmul`` with a JAX custom semiring
  (Pallas in interpret mode, as ``tests/conftest.py`` runs it) against the
  port's plain version with the map and reduce taken from the IR evaluator;
  callable epilogues (bias-SiLU, a leaky ReLU through ``torch.where``, a
  two-operand clamp), forward and gradient, against ``jax_matmul(...,
  epilogue=...)``.  Tolerances: exact where map and reduce are exact (add,
  min, max, xor on integers or over identically rounded terms), relative
  1e-3 elsewhere (the log semiring's folds, sums over 77 terms in another
  order; the epilogues, as tests/test_matmul.py holds them); bf16 outputs
  relative 1e-2.

The generated kernels themselves run on the card: tests/test_torch_kernels.py
and ``chip_smoke.py`` phase 31.
"""

import inspect
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gemm_hls_tpu import GemmConfig as JaxConfig
from gemm_hls_tpu import matmul as jax_matmul
from gemm_hls_tpu.ops.semiring import Semiring as JaxSemiring

from gemm_hls_tpu_torch import Semiring, _build, matmul
from gemm_hls_tpu_torch.ops import codegen, vpu

torch.set_num_threads(1)

F32, F64, I32 = torch.float32, torch.float64, torch.int32
FLOATS = (F32, F64)
ALL = (F32, F64, I32)
INF = float("inf")


def _values(dtype, n=16, seed=0):
    """NaN, +-inf, -0 and small / large values for floats; the int32
    extremes for integers; then seeded random ones."""
    rng = np.random.default_rng(seed)
    if dtype.is_floating_point:
        edge = [float("nan"), INF, -INF, -0.0, 0.0, 1.5, -2.25, 1e-30, 3e38, -7.0]
        rand = rng.uniform(-4, 4, n).tolist()
    else:
        edge = [-2**31, 2**31 - 1, 0, -1, 1, 7, -12345, 65536]
        rand = rng.integers(-1000, 1000, n).tolist()
    return torch.tensor(edge + rand, dtype=dtype)


def _pairs(dtype, k=2):
    """``k`` broadcast operands over every combination of the values."""
    v = _values(dtype)
    shapes = [[-1 if i == j else 1 for i in range(k)] for j in range(k)]
    return [_values(dtype, seed=j).reshape(shapes[j]) for j in range(k)] if k > 1 else [v]


def _same(got, want):
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


# (op, callable, arity, dtypes): every op of the table, in each form a
# callable may write it, and the op it lowers to.
OP_CASES = [
    ("add", lambda x, y: x + y, 2, ALL), ("add", torch.add, 2, ALL),
    ("sub", lambda x, y: x - y, 2, ALL), ("sub", torch.sub, 2, ALL),
    ("mul", lambda x, y: x * y, 2, ALL), ("mul", lambda x, y: x.mul(y), 2, ALL),
    ("div", lambda x, y: x / y, 2, FLOATS), ("div", torch.div, 2, FLOATS),
    ("neg", lambda x: -x, 1, ALL), ("abs", lambda x: abs(x), 1, ALL),
    ("abs", torch.abs, 1, ALL),
    ("minimum", torch.minimum, 2, ALL), ("maximum", torch.maximum, 2, ALL),
    ("minimum", lambda x, y: torch.min(x, y), 2, ALL),
    ("maximum", lambda x, y: x.max(y), 2, ALL),
    ("clamp", lambda x: torch.clamp(x, -3, 5), 1, ALL),
    ("clamp", lambda x, lo, hi: torch.clamp(x, lo, hi), 3, ALL),
    ("clamp", lambda x: x.clamp_min(0), 1, ALL),
    ("clamp", lambda x: torch.clamp_max(x, 1), 1, ALL),
    ("clamp", lambda x: x.clip(min=-1), 1, ALL),
    ("gt", lambda x, y: x > y, 2, ALL), ("lt", lambda x, y: x < y, 2, ALL),
    ("ge", lambda x, y: torch.ge(x, y), 2, ALL), ("le", lambda x, y: x <= y, 2, ALL),
    ("eq", lambda x, y: x == y, 2, ALL), ("ne", lambda x, y: x != y, 2, ALL),
    ("where", lambda x, y: torch.where(x >= 0, x, y * 2), 2, ALL),
    ("where", lambda x: torch.where(x > 1, x, 0.0), 1, FLOATS),
    ("exp", torch.exp, 1, ALL), ("expm1", torch.expm1, 1, ALL), ("log", torch.log, 1, ALL),
    ("log1p", torch.log1p, 1, ALL), ("sqrt", torch.sqrt, 1, ALL),
    ("rsqrt", torch.rsqrt, 1, FLOATS), ("tanh", torch.tanh, 1, ALL),
    ("sigmoid", torch.sigmoid, 1, ALL), ("relu", torch.relu, 1, ALL),
    ("relu", F.relu, 1, ALL), ("silu", F.silu, 1, FLOATS),
    ("gelu", F.gelu, 1, FLOATS), ("gelu_tanh", lambda x: F.gelu(x, approximate="tanh"), 1, FLOATS),
    ("softplus", F.softplus, 1, FLOATS), ("logaddexp", torch.logaddexp, 2, FLOATS),
    ("pow", lambda x: x ** 2, 1, ALL), ("pow", lambda x: torch.pow(x, 3), 1, ALL),
    ("pow", lambda x: x ** 0.5, 1, FLOATS), ("pow", lambda x: x.pow(-1), 1, FLOATS),
    ("pow", lambda x: x ** 1.7, 1, FLOATS), ("square", torch.square, 1, ALL),
    ("and", lambda x, y: x & y, 2, (I32,)), ("or", lambda x, y: x | y, 2, (I32,)),
    ("xor", lambda x, y: x ^ y, 2, (I32,)), ("xor", torch.bitwise_xor, 2, (I32,)),
    ("not", lambda x: ~x, 1, (I32,)), ("shl", lambda x: x << 3, 1, (I32,)),
    ("shr", lambda x: x >> 5, 1, (I32,)),
    ("cast", lambda x: x.float(), 1, ALL), ("cast", lambda x: x.to(torch.float64), 1, ALL),
    ("cast", lambda x: x.to(torch.bfloat16) + 1, 1, ALL),
    ("cast", lambda x, y: x.type_as(y), 2, ALL),
]


@pytest.mark.parametrize("op,fn,arity,dtype", [
    (op, fn, arity, dt) for op, fn, arity, dtypes in OP_CASES for dt in dtypes],
    ids=[f"{c[0]}-{i}-{str(dt)[6:]}" for i, c in enumerate(OP_CASES) for dt in c[3]])
def test_evaluator_equals_the_callable(op, fn, arity, dtype):
    prog = codegen.lower(fn, (dtype,) * arity)
    assert op in {o for o, _, _ in prog.ops}
    xs = _pairs(dtype, arity)
    _same(codegen.evaluate(prog, *xs), fn(*xs))


def test_every_op_of_the_table_is_covered():
    covered = set()
    for _, fn, arity, dtypes in OP_CASES:
        covered |= {o for o, _, _ in codegen.lower(fn, (dtypes[0],) * arity).ops}
    assert covered == set(codegen.OPS)


def test_mixed_types_follow_torch_promotion():
    # An int32 accumulator meets a float operand as torch promotes it; a
    # bf16 operand's own ops round to bf16.
    fn = lambda acc, b, c: torch.relu(acc + b * 3) - c * 0.1  # noqa: E731
    prog = codegen.lower(fn, (I32, F32, torch.bfloat16))
    acc = _values(I32).reshape(-1, 1)
    b = _values(F32, seed=1).reshape(1, -1)
    c = _values(F32, seed=2).to(torch.bfloat16).reshape(1, -1)
    _same(codegen.evaluate(prog, acc, b, c), fn(acc, b, c))
    assert prog.out_dtype == F32 and torch.bfloat16 in prog.vdtypes


# ---- the C++ text -----------------------------------------------------------

def test_float_functor_has_typed_hex_constants_and_no_double():
    prog = codegen.lower_epilogue(lambda acc, b: torch.where(acc > 0.1, acc, 0.01 * acc) + b,
                                  F32, [F32])
    src = codegen.epilogue_source(prog, "simt", F32, False, False)
    body = src[src.index("struct Epilogue"):src.index("}  // namespace gen_")]
    assert "static_cast<float>(0x1.999999999999ap-4)" in body  # 0.1
    assert "static_cast<float>(0x1.47ae147ae147bp-7)" in body  # 0.01
    assert "double" not in body and "0.1" not in body and "0.01" not in body
    src64 = codegen.epilogue_source(
        codegen.lower_epilogue(lambda acc: acc * 0.1, F64, []), "dmma", F64, True, False)
    assert "static_cast<double>(0x1.999999999999ap-4)" in src64
    assert "launch_dmma_ep<false, false>" in src64  # A (K, M), B (K, N): one layout
    isrc = codegen.semiring_source(
        Semiring("imax", lambda x, y: x * 3 + y, torch.maximum, float("-inf"), None, None),
        torch.int8, I32)
    assert "(-2147483647 - 1)" in isrc and "dmul(a, (3))" in isrc
    assert "launch_simt<signed char, int," in isrc


def test_user_max_plus_is_the_builtin_functor():
    # The built-in max_plus steps rmax(acc, dadd(a, b)) = dmax(acc, a + b)
    # (semiring_ops.cuh): the user's map add / reduce maximum emits the same.
    sr = Semiring("user_max_plus", torch.add, torch.maximum, float("-inf"), np.add, np.maximum)
    src = codegen.semiring_source(sr, F32, F32)
    assert "const float m0 = dadd(a, b);" in src
    assert "const float r0 = dmax(acc, m0);" in src
    assert "static_cast<float>(-INFINITY)" in src
    log = codegen.semiring_source(
        Semiring("user_log", torch.add, torch.logaddexp, float("-inf"), np.add, np.logaddexp),
        F32, F32)
    assert "logaddexp(acc, m0)" in log


def test_epilogue_sources_name_one_route_and_layout():
    prog = codegen.lower_epilogue(lambda acc, b: F.silu(acc + b), F32, [torch.bfloat16])
    for route, dt, ta, tb, want in (
            ("wgmma", torch.bfloat16, False, False, "launch_mxu_wg_ep<__nv_bfloat16, false, true>"),
            ("wgmma", torch.bfloat16, True, True, "launch_mxu_wg_ep<__nv_bfloat16, true, false>"),
            ("wmma", torch.float16, False, False, "launch_tc_ep<__half, true>"),
            ("wmma", torch.bfloat16, False, True, "launch_tc_ep<__nv_bfloat16, false>"),
            ("simt", F32, True, False, "launch_simt_ep<float, float, PlusTimes<float>>")):
        src = codegen.epilogue_source(prog, route, dt, ta, tb)
        assert want in src and "g_silu(v0)" in src and "ep_add(acc, c.o0)" in src
    iprog = codegen.lower_epilogue(lambda acc, b: torch.relu(acc + b), I32, [F32])
    src = codegen.epilogue_source(iprog, "wgmma", torch.int8, False, True)
    assert "launch_mxu_wg_ep<signed char, false, false>" in src
    assert "float apply(int acc" in src and "static_cast<float>(acc)" in src
    with pytest.raises(NotImplementedError, match="row_softmax"):
        codegen.epilogue_source(prog, "row_softmax", torch.bfloat16, False, False)


# ---- refusals, before any build ---------------------------------------------

@pytest.fixture
def no_build(monkeypatch):
    def fail(*_a, **_k):
        raise AssertionError("a build or nvcc lookup ran")
    monkeypatch.setattr(_build, "generated_libraries", fail)
    monkeypatch.setattr(_build, "_nvcc", fail)


REFUSED_EPILOGUES = [
    ("'amax'", lambda acc: acc - torch.amax(acc, dim=-1, keepdim=True)),
    ("'sum'", lambda acc: acc / acc.sum()),
    ("'softmax'", lambda acc: torch.softmax(acc, -1)),
    ("'getitem'", lambda acc: acc[:, :1]),
    ("control flow", lambda acc: acc if acc.sum() > 0 else -acc),
    ("control flow", lambda acc: max(acc, acc)),
    ("tensor constant", lambda acc: acc + torch.ones(1)),
    ("'erf'", lambda acc: torch.erf(acc)),
    ("'floor'", lambda acc: torch.floor(acc)),
    ("approximate", lambda acc: F.gelu(acc, approximate="sigmoid")),
    ("beta", lambda acc: F.softplus(acc, beta=2.0)),
    ("alpha", lambda acc, b: torch.add(acc, b, alpha=2)),
    ("rounding_mode", lambda acc, b: torch.div(acc, b, rounding_mode="floor")),
]


@pytest.mark.parametrize("why,fn", REFUSED_EPILOGUES,
                         ids=[f"{w}-{i}" for i, (w, _) in enumerate(REFUSED_EPILOGUES)])
def test_untranslatable_epilogue_raises_before_any_build(no_build, why, fn):
    n = len(inspect.signature(fn).parameters) - 1
    with pytest.raises(NotImplementedError, match="ROADMAP B coverage item 5") as e:
        codegen.epilogue_kernel(fn, "simt", F32, F32, [F32] * n, False, False)
    assert why in str(e.value)


def test_other_epilogue_refusals(no_build):
    five = lambda acc, a, b, c, d, e: acc + a + b + c + d + e  # noqa: E731
    with pytest.raises(NotImplementedError, match="at most 4"):
        codegen.epilogue_kernel(five, "simt", F32, F32, [F32] * 5, False, False)
    with pytest.raises(NotImplementedError, match="true division"):
        codegen.epilogue_kernel(lambda acc: acc / 2, "wgmma", torch.int8, I32, [], False, True)
    with pytest.raises(NotImplementedError, match="float64"):
        codegen.epilogue_kernel(lambda acc: acc.double() + 1, "simt", F32, F32, [], False, False)


@pytest.mark.parametrize("why,sr", [
    ("bool", Semiring("cmp_map", lambda x, y: x > y, torch.add, 0, None, None)),
    ("float32", Semiring("half_map", lambda x, y: x * 0.5 + y, torch.maximum, 0, None, None)),
    ("amax", Semiring("amax_red", torch.add, lambda acc, x: torch.amax(x, -1) + acc, 0,
                      None, None)),
    ("true division", Semiring("div_map", lambda x, y: x / y, torch.add, 0, None, None)),
])
def test_untranslatable_semiring_raises_before_any_build(no_build, why, sr):
    with pytest.raises(NotImplementedError, match="ROADMAP B coverage item 5") as e:
        codegen.semiring_kernel(sr, torch.int32, I32)
    assert why in str(e.value)


def test_meta_device_callable_still_raises():
    a = torch.ones(8, 16, device="meta")
    with pytest.raises(NotImplementedError, match="callable epilogues"):
        matmul(a, torch.ones(16, 8, device="meta"), epilogue=lambda acc: acc)


# ---- the generated library's name ------------------------------------------

_HASH_SCRIPT = """
import torch
from gemm_hls_tpu_torch import Semiring, _build
from gemm_hls_tpu_torch.ops import codegen
sr = Semiring("plus_max", torch.maximum, torch.add, 0, None, None)
print(_build.generated_path(codegen.semiring_source(sr, torch.float32, torch.float32)).name)
"""


def test_library_name_is_stable_across_processes():
    sr = Semiring("plus_max", torch.maximum, torch.add, 0, None, None)
    here = _build.generated_path(codegen.semiring_source(sr, F32, F32)).name
    there = subprocess.run([sys.executable, "-c", _HASH_SCRIPT], capture_output=True,
                           text=True, check=True, timeout=300).stdout.strip()
    assert here == there and here.startswith("libgemm_hls_gen_")


def test_library_name_follows_the_text_not_the_name():
    def path(sr, dt=F32):
        return _build.generated_path(codegen.semiring_source(sr, dt, vpu._KERNEL_DTYPES[dt]))

    two = Semiring("scaled", lambda x, y: x + y * 2.0, torch.minimum, INF, None, None)
    three = Semiring("scaled", lambda x, y: x + y * 3.0, torch.minimum, INF, None, None)
    other_ops = Semiring("scaled", torch.add, torch.maximum, -INF, None, None)
    assert len({path(two), path(three), path(other_ops)}) == 3
    assert path(two) == path(Semiring("scaled", lambda x, y: x + y * 2.0, torch.minimum, INF,
                                      None, None))
    assert path(two, torch.bfloat16) != path(two)


# ---- parity with the JAX package -------------------------------------------

JCFG = JaxConfig(block_m=16, block_n=128, block_k=64, interpret=True)

# name -> (torch map, torch reduce, jax map, jax reduce, identity)
CUSTOM = {
    "plus_max": (torch.maximum, torch.add, jnp.maximum, jnp.add, 0),
    "user_max_plus": (torch.add, torch.maximum, jnp.add, jnp.maximum, float("-inf")),
    "user_log": (torch.add, torch.logaddexp, jnp.add, jnp.logaddexp, float("-inf")),
    "max_xor": (torch.bitwise_xor, torch.maximum, jnp.bitwise_xor, jnp.maximum, float("-inf")),
}
EXACT = {"user_max_plus", "max_xor"}
# (semiring, dtype, layout, batch): 2-D, transposed and batched.
PARITY_CASES = [
    ("plus_max", "float32", (False, False), None), ("plus_max", "bfloat16", (False, False), None),
    ("plus_max", "int8", (False, False), None), ("plus_max", "float32", (True, True), None),
    ("plus_max", "float32", (False, False), "both"),
    ("user_max_plus", "float32", (False, False), None), ("user_max_plus", "int32", (False, False), None),
    ("user_max_plus", "bfloat16", (True, False), None),
    ("user_max_plus", "float32", (False, True), "a"),
    ("user_log", "float32", (False, False), None), ("user_log", "bfloat16", (False, False), None),
    ("user_log", "float32", (False, True), None),
    ("max_xor", "int32", (False, False), None), ("max_xor", "int8", (True, False), None),
    ("max_xor", "int32", (False, False), "both"),
]


def _operands(dtype, ta, tb, batch, seed=3, m=21, n=130, k=77):
    rng = np.random.default_rng(seed)

    def draw(shape):
        if dtype.startswith("int"):
            return rng.integers(-60, 60, shape).astype(dtype)
        x = rng.uniform(-4, 4, shape).astype(np.float32)
        return x
    lead_a = (3,) if batch in ("both", "b") else ()
    lead_b = (3,) if batch in ("both", "a") else ()
    a = draw(lead_a + ((k, m) if ta else (m, k)))
    b = draw(lead_b + ((n, k) if tb else (k, n)))
    return a, b


def _port_semiring(name, dtype):
    """The port's Semiring whose map and reduce are the IR evaluator of the
    user's torch ops (what the generated functor computes)."""
    tmap, tred, _, _, ident = CUSTOM[name]
    acc = vpu._KERNEL_DTYPES[getattr(torch, dtype)]
    mp = codegen.lower(tmap, (acc, acc))
    rp = codegen.lower(tred, (acc, acc))
    return Semiring(name, lambda x, y: codegen.evaluate(mp, x, y),
                    lambda x, y: codegen.evaluate(rp, x, y), ident, None, None)


@pytest.mark.parametrize("name,dtype,layout,batch", PARITY_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}-{c[3]}" for c in PARITY_CASES])
def test_custom_semiring_matches_jax(name, dtype, layout, batch):
    ta, tb = layout
    a, b = _operands(dtype, ta, tb, batch)
    _, _, jmap, jred, ident = CUSTOM[name]
    jsr = JaxSemiring(name=name, map_op=jmap, reduce_op=jred, identity=ident,
                      np_map=None, np_reduce=None)
    jd = jnp.bfloat16 if dtype == "bfloat16" else dtype
    exp = jax_matmul(jnp.asarray(a, jd), jnp.asarray(b, jd), semiring=jsr, config=JCFG,
                     transpose_a=ta, transpose_b=tb)
    td = getattr(torch, dtype)
    got = matmul(torch.from_numpy(a).to(td), torch.from_numpy(b).to(td),
                 semiring=_port_semiring(name, dtype), transpose_a=ta, transpose_b=tb)
    exp = np.asarray(exp.astype(jnp.float32) if dtype == "bfloat16" else exp)
    got = (got.float() if dtype == "bfloat16" else got).numpy()
    assert got.shape == exp.shape
    if name in EXACT:
        np.testing.assert_array_equal(got, exp)
    else:
        np.testing.assert_allclose(got, exp, rtol=1e-2 if dtype == "bfloat16" else 1e-3)


JEPILOGUES = {
    "bias_silu": (lambda acc, b: F.silu(acc + b), lambda acc, b: jax.nn.silu(acc + b), 1),
    "leaky_relu": (lambda acc, b: torch.where(acc + b > 0, acc + b, 0.01 * (acc + b)),
                   lambda acc, b: jnp.where(acc + b > 0, acc + b, 0.01 * (acc + b)), 1),
    "clamp2": (lambda acc, lo, hi: torch.clamp(acc, lo, hi) * 0.5,
               lambda acc, lo, hi: jnp.clip(acc, lo, hi) * 0.5, 2),
}


def _u(shape, seed, lo=-2.0, hi=2.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


@pytest.mark.parametrize("name", sorted(JEPILOGUES))
@pytest.mark.parametrize("lead", [(), (3,)], ids=["2d", "batched"])
def test_callable_epilogue_matches_jax(name, lead):
    tfn, jfn, n_ops = JEPILOGUES[name]
    a, b = _u(lead + (40, 64), 1), _u((64, 129), 2)
    eps = [np.linspace(-3, 3, 129).astype(np.float32) * (1 - 2 * i) for i in range(n_ops)]
    if name == "clamp2":
        eps = [np.full(129, -0.5, np.float32) - eps[0] ** 2 / 9, eps[1] ** 2 / 9 + 0.5]
    g = _u(lead + (40, 129), 3, -1, 1)
    prog = codegen.lower(tfn, (F32,) * (1 + n_ops))
    port_fn = lambda acc, *ops: codegen.evaluate(prog, acc, *ops)  # noqa: E731
    xs = [torch.from_numpy(t).requires_grad_() for t in (a, b, *eps)]
    got = matmul(xs[0], xs[1], epilogue=port_fn, epilogue_operands=tuple(xs[2:]))
    got.backward(torch.from_numpy(g))

    def loss(x, w, *ops):
        return jnp.sum(jax_matmul(x, w, config=JCFG, epilogue=jfn,
                                  epilogue_operands=ops) * g)
    jx = [jnp.asarray(t) for t in (a, b, *eps)]
    exp = jax_matmul(jx[0], jx[1], config=JCFG, epilogue=jfn, epilogue_operands=tuple(jx[2:]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp), rtol=1e-3, atol=1e-5)
    grads = jax.grad(loss, argnums=tuple(range(len(jx))))(*jx)
    for x, e in zip(xs, grads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(e), rtol=1e-3, atol=1e-5)


def test_card_tables_take_the_routes_they_name():
    # chip_smoke.py's GEN_EPILOGUE_CASES (phase 31 and the card tests): the
    # route each case asserts is mxu_route's (the type's, in every layout
    # and at every alignment); every route takes a generated epilogue (WMMA and the
    # CUDA cores as each packed or unaligned-fp32 case's retired route,
    # named); and phase 31a builds the library of every case of both
    # tables ahead.
    import chip_smoke
    from gemm_hls_tpu_torch.ops import mxu

    seen = set()
    for case in chip_smoke.GEN_EPILOGUE_CASES:
        _, dt, _, ta, tb, bsz, m, n, k, layout, bcast, route = case
        dtype = getattr(torch, dt)
        per = 16 // dtype.itemsize

        def ok(rows, cols, three_d):
            if layout == "odd":
                return False
            width = (cols + per - 1) // per * per + per if layout == "pitched" else cols
            return width % per == 0 and (not three_d or rows * width % per == 0)

        aligned = (ok(*((k, m) if ta else (m, k)), bsz and bcast != "a")
                   and ok(*((n, k) if tb else (k, n)), bsz and bcast != "b"))
        assert mxu.mxu_route(dtype) == route, case
        seen.add(route)
        old = chip_smoke.retired_route(dt, ta, tb, bsz, m, n, k, layout, bcast)
        if dt == "float32":
            # fp32 retires the CUDA cores on exactly its unaligned cases.
            assert (old == "simt") == (route == "wgmma" and not aligned), case
        if old:
            assert route == "wgmma" and (old == "simt") == (dt == "float32"), case
            seen.add(old)
    assert seen == {"wgmma", "wmma", "simt", "dmma"}
    specs = {src for src, _ in chip_smoke.phase31_specs(torch)}
    for name, dt, *_ in chip_smoke.GEN_B3_CASES:
        dtype = getattr(torch, dt)
        assert codegen.semiring_spec(chip_smoke.user_semirings()[name], dtype,
                                     vpu._KERNEL_DTYPES[dtype])[0] in specs
