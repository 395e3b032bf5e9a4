"""The port's grouped GEMM and its weight gradient (``ops/gmm.py``,
``ops/grouped.py``) against the JAX package on the CPU, over
``tests/test_grouped.py``'s matrix.

The same numpy inputs go through ``gemm_hls_tpu.ops.grouped
.grouped_matmul`` / ``pallas_grouped.grouped_update_mxu`` (Pallas kernels
in interpret mode) and the port's plain versions (CPU tensors); the
gradients through ``jax.grad`` and the port's autograd Function, whose
backward on the CPU composes the plain versions of the kernels the card
runs.  Tolerance: relative error below 1e-5 of the largest output for
fp32 (both sum in fp32), 1e-2 for bf16 outputs (one bf16 ulp is 2^-8), and
the rows past ``sum(group_sizes)`` exactly zero.  The kernels run only on
the card (``tests/test_torch_kernels.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemm_hls_tpu.config import GemmConfig as JaxConfig
from gemm_hls_tpu.ops import pallas_dequant as jdq
from gemm_hls_tpu.ops.grouped import grouped_matmul as jax_grouped
from gemm_hls_tpu.ops.pallas_grouped import grouped_update_mxu as jax_update
from gemm_hls_tpu_torch import GemmConfig, grouped_matmul, quantize_weights
from gemm_hls_tpu_torch.ops import dequant, gmm
from gemm_hls_tpu_torch.ops import grouped as grouped_mod

torch.set_num_threads(1)

JCFG = JaxConfig(dtype="float32", block_m=32, block_n=32, block_k=16,
                 interpret=True)
# tests/test_grouped.py:40-48
CASES = [
    (64, 32, 48, [16, 16, 16, 16], 16),
    (100, 33, 48, [10, 0, 55, 35], 32),
    (100, 33, 48, [10, 7, 55, 8], 32),
    (7, 130, 129, [3, 3, 1], 8),
    (256, 64, 64, [256], 64),
    (50, 16, 16, [0, 0, 0, 0, 0], 16),
    (96, 24, 40, [1, 1, 1, 93], 32),
]


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def naive(lhs, rhs, gs, transpose_rhs=False):
    out = np.zeros((lhs.shape[0], rhs.shape[1] if transpose_rhs
                    else rhs.shape[2]), np.float64)
    s = 0
    for g, sz in enumerate(gs):
        w = rhs[g].T if transpose_rhs else rhs[g]
        out[s:s + sz] = lhs[s:s + sz].astype(np.float64) @ w.astype(np.float64)
        s += sz
    return out


@pytest.mark.parametrize("transpose_rhs", [False, True])
@pytest.mark.parametrize("m,k,n,gs,bm", CASES)
def test_forward_vs_jax(m, k, n, gs, bm, transpose_rhs):
    rng = np.random.default_rng(5)
    lhs = rng.uniform(1, 10, (m, k)).astype(np.float32)
    shape = (len(gs), n, k) if transpose_rhs else (len(gs), k, n)
    rhs = rng.uniform(1, 10, shape).astype(np.float32)
    want = np.asarray(jax_grouped(jnp.array(lhs), jnp.array(rhs),
                                  jnp.array(gs, jnp.int32),
                                  dataclasses.replace(JCFG, block_m=bm),
                                  transpose_rhs=transpose_rhs))
    got = grouped_matmul(torch.from_numpy(lhs), torch.from_numpy(rhs),
                         torch.tensor(gs, dtype=torch.int32),
                         transpose_rhs=transpose_rhs)
    assert got.dtype == torch.float32
    assert rel_err(got.numpy(), want) < 1e-5
    assert rel_err(got.numpy(), naive(lhs, rhs, gs, transpose_rhs)) < 1e-5
    total = int(np.sum(gs))
    assert not got[total:].any()


@pytest.mark.parametrize("dtype,jdt", [(torch.bfloat16, jnp.bfloat16),
                                       (torch.float16, jnp.float16)])
def test_half_types_vs_jax(dtype, jdt):
    rng = np.random.default_rng(9)
    m, k, n, gs = 64, 64, 64, [40, 24]
    lhs = rng.uniform(-1, 1, (m, k)).astype(np.float32)
    rhs = rng.uniform(-1, 1, (2, k, n)).astype(np.float32)
    jl, jr = jnp.array(lhs, jdt), jnp.array(rhs, jdt)
    cfg = dataclasses.replace(JCFG, dtype=str(jnp.dtype(jdt)), out_dtype="float32")
    want = np.asarray(jax_grouped(jl, jr, jnp.array(gs, jnp.int32), cfg))
    tl = torch.from_numpy(np.asarray(jl, np.float32)).to(dtype)
    tr = torch.from_numpy(np.asarray(jr, np.float32)).to(dtype)
    got = gmm.grouped_mxu(tl, tr, torch.tensor(gs), out_dtype=torch.float32)
    # Exact products of half-precision inputs, summed in fp32 on both sides.
    assert rel_err(got.numpy(), want) < 1e-5
    assert grouped_matmul(tl, tr, torch.tensor(gs)).dtype == dtype


def test_ragged_dot_on_assigned_rows():
    import jax
    rng = np.random.default_rng(11)
    m, k, n = 64, 32, 48
    gs = [20, 30, 14]
    lhs = rng.uniform(-1, 1, (m, k)).astype(np.float32)
    rhs = rng.uniform(-1, 1, (3, k, n)).astype(np.float32)
    want = np.asarray(jax.lax.ragged_dot(jnp.array(lhs), jnp.array(rhs),
                                         jnp.array(gs, jnp.int32)))
    got = grouped_matmul(torch.from_numpy(lhs), torch.from_numpy(rhs),
                         torch.tensor(gs))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_oversized_routing_drops_trailing_rows():
    # The documented clamp: groups laid end to end, rows past M dropped.
    lhs = torch.ones(12, 3)
    lhs[:, 0] = torch.arange(12.0)
    rhs = torch.stack([torch.eye(3), 2 * torch.eye(3)])
    got = grouped_matmul(lhs, rhs, torch.tensor([10, 10]))
    want = torch.cat([torch.arange(10.0), 2 * torch.arange(10.0, 12.0)])
    assert torch.equal(got[:, 0], want)


def test_gradient_on_cpu_is_plain_autograd():
    rng = np.random.default_rng(7)
    lhs = torch.from_numpy(rng.uniform(-1, 1, (30, 8)).astype(np.float32))
    rhs = torch.from_numpy(rng.uniform(-1, 1, (3, 8, 5)).astype(np.float32))
    gs = torch.tensor([10, 0, 15])
    a, b = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
    grouped_matmul(a, b, gs).sum().backward()
    assert not b.grad[1].any()
    assert torch.equal(a.grad[25:], torch.zeros(5, 8))
    # The Function's backward against plain autograd of the plain version.
    pa, pb = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
    gmm.grouped_mxu_plain(pa, pb, gs).sum().backward()
    assert rel_err(a.grad, pa.grad) < 1e-6 and rel_err(b.grad, pb.grad) < 1e-6


def test_lhs_cotangent_skipped_when_lhs_needs_none(monkeypatch):
    calls = []

    def counting(*args, **kw):
        calls.append(kw["transpose_rhs"])
        return gmm.grouped_mxu(*args, **kw)

    monkeypatch.setattr(grouped_mod, "grouped_mxu", counting)
    rhs = torch.ones(2, 4, 3, requires_grad=True)
    grouped_matmul(torch.ones(8, 4), rhs, torch.tensor([3, 5])).sum().backward()
    assert calls == [False]                      # the forward only
    assert torch.equal(rhs.grad[0], torch.full((4, 3), 3.0))
    assert torch.equal(rhs.grad[1], torch.full((4, 3), 5.0))


# ---- B17: the weight gradient ---------------------------------------------

def _jcfg(dtype, bm, out_dtype=None):
    return dataclasses.replace(JCFG, dtype=dtype, out_dtype=out_dtype,
                               block_m=bm)


def _t(x, dt):
    """A JAX or numpy array (any float type) as a torch tensor of ``dt``."""
    return torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, dt))


TYPES = [("float32", jnp.float32, 1e-5), ("bfloat16", jnp.bfloat16, 1e-2)]


@pytest.mark.parametrize("dt,jdt,tol", TYPES)
@pytest.mark.parametrize("m,k,n,gs,bm", CASES)
def test_grouped_update_vs_jax(m, k, n, gs, bm, dt, jdt, tol):
    rng = np.random.default_rng(13)
    lhs = jnp.asarray(rng.uniform(-1, 1, (m, k)), jdt)
    g = jnp.asarray(rng.uniform(-1, 1, (m, n)), jdt)
    want = np.asarray(jax_update(lhs, g, jnp.array(gs, jnp.int32),
                                 cfg=_jcfg(dt, bm), num_groups=len(gs),
                                 interpret=True), np.float32)
    got = gmm.grouped_update_mxu(_t(lhs, dt), _t(g, dt),
                                 torch.tensor(gs, dtype=torch.int32),
                                 num_groups=len(gs))
    assert got.dtype == getattr(torch, dt) and got.shape == (len(gs), k, n)
    assert rel_err(got.float().numpy(), want) < tol
    for grp, size in enumerate(gs):
        if size == 0:  # an expert that received no rows: a zero block
            assert not got[grp].any()


@pytest.mark.parametrize("dt,jdt,tol", TYPES)
def test_grouped_update_ignores_nan_rows_past_the_groups(dt, jdt, tol):
    # JAX masks the rows by ``where`` before the dot; the port never reads
    # them.  Both stay finite.
    rng = np.random.default_rng(17)
    m, k, n, gs = 96, 24, 40, [30, 0, 41]
    lhs = rng.uniform(-1, 1, (m, k)).astype(np.float32)
    g = rng.uniform(-1, 1, (m, n)).astype(np.float32)
    lhs[71:], g[71:] = np.nan, np.nan
    jl, jg = jnp.asarray(lhs, jdt), jnp.asarray(g, jdt)
    want = np.asarray(jax_update(jl, jg, jnp.array(gs, jnp.int32),
                                 cfg=_jcfg(dt, 32), num_groups=3,
                                 interpret=True), np.float32)
    got = gmm.grouped_update_mxu(_t(jl, dt), _t(jg, dt), torch.tensor(gs),
                                 num_groups=3).float()
    assert np.isfinite(want).all() and bool(torch.isfinite(got).all())
    assert rel_err(got.numpy(), want) < tol
    assert not got[1].any()


@pytest.mark.parametrize("dt,jdt,tol", TYPES)
@pytest.mark.parametrize("transpose_rhs", [False, True])
def test_vjp_vs_jax_grad(transpose_rhs, dt, jdt, tol):
    # tests/test_grouped.py:110-130 against the JAX custom VJP.
    rng = np.random.default_rng(7)
    m, k, n, gs = 96, 40, 56, [30, 0, 41, 25]
    shape = (4, n, k) if transpose_rhs else (4, k, n)
    lhs = jnp.asarray(rng.uniform(-1, 1, (m, k)), jdt)
    rhs = jnp.asarray(rng.uniform(-1, 1, shape), jdt)
    jcfg = _jcfg(dt, 32)

    def loss(a, b):
        out = jax_grouped(a, b, jnp.array(gs, jnp.int32), jcfg,
                          transpose_rhs=transpose_rhs)
        return jnp.sum(jnp.sin(out.astype(jnp.float32)))

    want = jax.grad(loss, argnums=(0, 1))(lhs, rhs)
    a = _t(lhs, dt).requires_grad_()
    b = _t(rhs, dt).requires_grad_()
    out = grouped_matmul(a, b, torch.tensor(gs),
                         GemmConfig.from_reference(dataclasses.asdict(jcfg)),
                         transpose_rhs=transpose_rhs)
    out.float().sin().sum().backward()
    assert a.grad.dtype == b.grad.dtype == getattr(torch, dt)
    assert rel_err(a.grad.float().numpy(), np.asarray(want[0], np.float32)) < tol
    assert rel_err(b.grad.float().numpy(), np.asarray(want[1], np.float32)) < tol
    # The empty group's weights get exactly zero gradient.
    assert not b.grad[1].any() and np.all(np.asarray(want[1])[1] == 0)


# ---- C1d: an explicit config sets the output type, as in JAX --------------

def test_explicit_config_outputs_its_dtype():
    rng = np.random.default_rng(19)
    gs = [16, 16, 16, 16]
    lhs = jnp.asarray(rng.uniform(-1, 1, (64, 32)), jnp.bfloat16)
    rhs = jnp.asarray(rng.uniform(-1, 1, (4, 32, 48)), jnp.bfloat16)
    want = jax_grouped(lhs, rhs, jnp.array(gs, jnp.int32),
                       JaxConfig(block_m=16, block_n=16, block_k=16))
    got = grouped_matmul(_t(lhs, "bfloat16"), _t(rhs, "bfloat16"),
                         torch.tensor(gs),
                         GemmConfig(block_m=16, block_n=16, block_k=16))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert rel_err(got.numpy(), np.asarray(want)) < 1e-3


def test_dequant_explicit_config_outputs_its_dtype():
    rng = np.random.default_rng(23)
    w = rng.standard_normal((256, 128)).astype(np.float32)
    wq, s = quantize_weights(w, bits=4, group_size=64)
    xb = jnp.asarray(rng.standard_normal((64, 256)), jnp.bfloat16)
    blocks = dict(block_m=64, block_n=128, block_k=128)
    want = jdq.dequant_matmul(xb, jnp.asarray(wq), jnp.asarray(s),
                              cfg=JaxConfig(**blocks), bits=4, group_size=64,
                              interpret=True)
    got = dequant.dequant_matmul(_t(xb, "bfloat16"), torch.from_numpy(wq),
                                 torch.from_numpy(s), cfg=GemmConfig(**blocks),
                                 bits=4, group_size=64)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert rel_err(got.numpy(), np.asarray(want)) < 1e-3


@pytest.mark.parametrize("transpose_rhs", [False, True])
def test_fp32_cotangent_against_bf16_weights_vs_jax(transpose_rhs):
    # bf16 operands, an explicit fp32 config: the output and its cotangent
    # are fp32, the gradients come back in the operands' bf16.
    rng = np.random.default_rng(29)
    m, k, n, gs = 80, 40, 33, [25, 25, 0, 30]
    shape = (4, n, k) if transpose_rhs else (4, k, n)
    lhs = jnp.asarray(rng.uniform(-1, 1, (m, k)), jnp.bfloat16)
    rhs = jnp.asarray(rng.uniform(-1, 1, shape), jnp.bfloat16)
    jcfg = _jcfg("float32", 16)

    def loss(a, b):
        return jnp.sum(jnp.sin(jax_grouped(a, b, jnp.array(gs, jnp.int32), jcfg,
                                           transpose_rhs=transpose_rhs)))

    want = jax.grad(loss, argnums=(0, 1))(lhs, rhs)
    a = _t(lhs, "bfloat16").requires_grad_()
    b = _t(rhs, "bfloat16").requires_grad_()
    out = grouped_matmul(a, b, torch.tensor(gs), GemmConfig(),
                         transpose_rhs=transpose_rhs)
    assert out.dtype == torch.float32
    out.sin().sum().backward()
    assert a.grad.dtype == b.grad.dtype == torch.bfloat16
    assert rel_err(a.grad.float().numpy(), np.asarray(want[0], np.float32)) < 1e-2
    assert rel_err(b.grad.float().numpy(), np.asarray(want[1], np.float32)) < 1e-2


@pytest.mark.parametrize("bad", ["groups", "float", "3d", "contraction"])
def test_validation_errors(bad):
    lhs = torch.zeros(8, 4)
    rhs = torch.zeros(2, 4, 4)
    gs = torch.tensor([4, 4])
    if bad == "groups":
        gs = torch.tensor([4, 4, 0])
    elif bad == "float":
        gs = torch.tensor([4.0, 4.0])
    elif bad == "3d":
        lhs = lhs[None]
    else:
        rhs = torch.zeros(2, 5, 4)
    with pytest.raises(ValueError):
        grouped_matmul(lhs, rhs, gs)


def test_grouped_bound_arithmetic():
    from gemm_hls_tpu_torch.models.perf_model import H100, grouped_bound
    # Prefill w1: 8192 slots x 2048 -> 4096 over 8 experts, bf16: operations.
    t, by = grouped_bound(H100, 8192, 2048, 4096, 8192, 8, torch.bfloat16)
    assert by == "operations" and t == pytest.approx(2 * 8192 * 2048 * 4096 / 989e12)
    # Decode: 128 slots; the 8 experts' 134 MB of weights dominate.
    t, by = grouped_bound(H100, 128, 2048, 4096, 128, 8, torch.bfloat16)
    moved = (128 * 2048 + 8 * 2048 * 4096) * 2 + 128 * 4096 * 2
    assert by == "bytes" and t == pytest.approx(moved / 3.35e12)
    # Experts that received no rows are not read.
    assert grouped_bound(H100, 128, 2048, 4096, 128, 2, torch.bfloat16)[0] < t


def test_grouped_update_bound_arithmetic():
    from gemm_hls_tpu_torch.models.perf_model import H100, grouped_update_bound
    # w1's gradient at serving_bench's prefill: 8192 slots, (2048, 4096)
    # per expert, 8 experts, bf16: operations (0.139 ms) over bytes (0.070).
    t, by = grouped_update_bound(H100, 2048, 4096, 8192, 8, torch.bfloat16)
    assert by == "operations" and t == pytest.approx(2 * 8192 * 2048 * 4096 / 989e12)
    # 128 decode slots: the (8, 2048, 4096) output dominates.
    t, by = grouped_update_bound(H100, 2048, 4096, 128, 8, torch.bfloat16)
    moved = 128 * (2048 + 4096) * 2 + 8 * 2048 * 4096 * 2
    assert by == "bytes" and t == pytest.approx(moved / 3.35e12)
    # An fp32 output doubles the bytes written; fp32 inputs run at the CUDA
    # cores' rate.
    assert grouped_update_bound(H100, 2048, 4096, 128, 8, torch.bfloat16,
                                torch.float32)[0] > t
    assert grouped_update_bound(H100, 1024, 1024, 8192, 1, torch.float32)[0] == \
        pytest.approx(2 * 8192 * 1024 * 1024 / 67e12)


@pytest.mark.parametrize("bad", ["rows", "groups"])
def test_grouped_update_validation_errors(bad):
    lhs, g, gs = torch.zeros(8, 4), torch.zeros(8, 5), torch.tensor([4, 4])
    if bad == "rows":
        g = torch.zeros(7, 5)
    else:
        gs = torch.tensor([4, 4, 0])
    with pytest.raises(ValueError):
        gmm.grouped_update_mxu(lhs, g, gs, num_groups=2)


# ---- B16's routes (ops.gmm.grouped_route) ----------------------------------


def test_route_rule():
    # By dtype and alignment alone (the group sizes live on the card; the
    # engine measured no slower down to decode's 128 slots): mma.sync for
    # rows that are not whole 16-byte units, fp32 on the CUDA cores.
    bf16 = torch.bfloat16
    assert gmm.grouped_route(bf16, True) == "wgmma"
    assert gmm.grouped_route(torch.float16, True) == "wgmma"
    assert gmm.grouped_route(bf16, False) == "mma.sync"
    assert gmm.grouped_route(torch.float32, True) == "simt"


def test_route_cases_take_the_routes_they_name():
    # chip_smoke.py's GROUPED_ROUTE_CASES (phase 16 and the card tests).
    import chip_smoke

    seen = set()
    for case in list(chip_smoke.GROUPED_ROUTE_CASES) + [chip_smoke.GROUPED_REPEAT_CASE]:
        dt, _, k, n, _, trb, _, _, route = case
        dtype = getattr(torch, dt)
        aligned = k * dtype.itemsize % 16 == 0 and (trb or n * dtype.itemsize % 16 == 0)
        assert gmm.grouped_route(dtype, aligned) == route, case
        seen.add((dt, route))
    assert {("bfloat16", "wgmma"), ("float16", "wgmma"), ("bfloat16", "mma.sync"),
            ("float32", "simt")} <= seen


def test_plain_calls_leave_the_route_alone():
    gmm.grouped_mxu.last_route = None
    gmm.grouped_mxu(torch.ones((4, 8)), torch.ones((2, 8, 8)), torch.tensor([2, 2]))
    assert gmm.grouped_mxu.last_route is None


@pytest.mark.parametrize("transpose_rhs", [False, True])
def test_engine_shape_vs_jax(transpose_rhs):
    # The engine route's shape at a small size: M 256 over 3 groups, one
    # empty, rows past the groups; relative 1e-5 (fp32 sums in two orders).
    rng = np.random.default_rng(13)
    m, k, n, gs = 256, 64, 64, [100, 0, 120]
    lhs = rng.uniform(-1, 1, (m, k)).astype(np.float32)
    rhs = rng.uniform(-1, 1, (3, n, k) if transpose_rhs else (3, k, n)).astype(np.float32)
    want = np.asarray(jax_grouped(jnp.array(lhs), jnp.array(rhs), jnp.array(gs, jnp.int32),
                                  dataclasses.replace(JCFG, block_m=64),
                                  transpose_rhs=transpose_rhs))
    got = grouped_matmul(torch.from_numpy(lhs), torch.from_numpy(rhs),
                         torch.tensor(gs, dtype=torch.int32), transpose_rhs=transpose_rhs)
    assert rel_err(got.numpy(), want) < 1e-5
    assert not got[sum(gs):].any()


# ---- B17's routes (ops.gmm.grouped_update_route) ----------------------------


def test_update_route_rule():
    # By dtype and alignment alone, as B16's: the engine for bf16 / fp16
    # whose K and N rows a TMA map describes, mma.sync for the rest, fp32
    # on the CUDA cores.
    bf16 = torch.bfloat16
    assert gmm.grouped_update_route(bf16, True) == "wgmma"
    assert gmm.grouped_update_route(torch.float16, True) == "wgmma"
    assert gmm.grouped_update_route(bf16, False) == "mma.sync"
    assert gmm.grouped_update_route(torch.float16, False) == "mma.sync"
    assert gmm.grouped_update_route(torch.float32, True) == "simt"


def test_update_route_cases_take_the_routes_they_name():
    # chip_smoke.py's GROUPED_UPDATE_ROUTE_CASES (phase 19 and the card
    # tests): the route each asserts is the rule's for its K, N and rows,
    # and both tensor-core routes and the CUDA cores are covered.
    import chip_smoke

    seen = set()
    cases = list(chip_smoke.GROUPED_UPDATE_ROUTE_CASES) + [chip_smoke.GROUPED_UPDATE_REPEAT_CASE]
    for case in cases:
        dt, m, k, n, _, _, _, route = case
        dtype = getattr(torch, dt)
        aligned = m > 0 and k * dtype.itemsize % 16 == 0 and n * dtype.itemsize % 16 == 0
        assert gmm.grouped_update_route(dtype, aligned) == route, case
        seen.add((dt, route))
    assert {("bfloat16", "wgmma"), ("float16", "wgmma"), ("bfloat16", "mma.sync"),
            ("float32", "simt")} <= seen


def test_plain_update_calls_leave_the_route_alone():
    gmm.grouped_update_mxu.last_route = None
    gmm.grouped_update_mxu(torch.ones((4, 8)), torch.ones((4, 8)), torch.tensor([2, 2]),
                           num_groups=2)
    assert gmm.grouped_update_mxu.last_route is None


@pytest.mark.parametrize("dt,jdt,tol", TYPES)
@pytest.mark.parametrize("gs", [
    [70, 0, 33, 101, 5, 47],     # spans starting off multiples of 64, one empty
    [10, 20, 1, 63, 30],         # every span shorter than 64
    [130, 64, 0, 60],            # a span over three 64-row slabs, rows past the groups
])
def test_engine_spans_vs_jax(gs, dt, jdt, tol):
    # The engine's slabs start at each group's first row and stop past its
    # last, the lines of the last slab past the span zeroed: at the engine
    # route's shapes (K and N whole 16-byte units) with NaN in the rows
    # past the groups, the plain version against JAX's kernel.
    rng = np.random.default_rng(19)
    m, k, n = 256, 64, 48
    lhs = rng.uniform(-1, 1, (m, k)).astype(np.float32)
    g = rng.uniform(-1, 1, (m, n)).astype(np.float32)
    lhs[sum(gs):], g[sum(gs):] = np.nan, np.nan
    jl, jg = jnp.asarray(lhs, jdt), jnp.asarray(g, jdt)
    want = np.asarray(jax_update(jl, jg, jnp.array(gs, jnp.int32), cfg=_jcfg(dt, 32),
                                 num_groups=len(gs), interpret=True), np.float32)
    got = gmm.grouped_update_mxu(_t(jl, dt), _t(jg, dt), torch.tensor(gs, dtype=torch.int32),
                                 num_groups=len(gs)).float()
    assert got.shape == (len(gs), k, n)
    assert np.isfinite(want).all() and bool(torch.isfinite(got).all())
    assert rel_err(got.numpy(), want) < tol
    for grp, size in enumerate(gs):
        if size == 0:
            assert not got[grp].any()

