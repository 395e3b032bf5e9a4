"""The port's batched front door (3-D / N-D ``matmul``, kernel B2's module
and B3's batch axis) against the JAX package's ``tests/test_batched.py``
cases.

The same numpy inputs go through ``gemm_hls_tpu.matmul`` (its batched
Pallas kernel, or the vmapped 2-D kernels, in interpret mode) and
``gemm_hls_tpu_torch.matmul`` (the plain versions, as CPU tensors run
them).  Tolerances: relative 1e-3 (absolute 1e-5 for the entries a
mixed-sign sum cancels) for fp32 outputs and gradients; one bf16 ulp
(relative 1e-2) for bf16 outputs; exact for int8 -> int32 and tropical
results.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemm_hls_tpu import GemmConfig as JaxConfig
from gemm_hls_tpu import matmul as jax_matmul

from gemm_hls_tpu_torch import GemmConfig, matmul
from gemm_hls_tpu_torch.config import packed_operands
from gemm_hls_tpu_torch.ops import mxu

torch.set_num_threads(1)

RTOL, ATOL = 1e-3, 1e-5
LAYOUTS = [(False, False), (True, False), (False, True), (True, True)]
JCFG_VPU = JaxConfig(block_m=8, block_n=128, block_k=16, interpret=True)


def _u(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(dtype)


def _shape(bsz, rows, cols, t):
    return (bsz, cols, rows) if t else (bsz, rows, cols)


def _both(a, b, dtype=None, **kw):
    """(port, jax) outputs of the front door on the same numpy inputs."""
    conv = (lambda x: torch.from_numpy(x)) if dtype is None else (
        lambda x: torch.from_numpy(x).to(getattr(torch, dtype)))
    got = matmul(conv(a), conv(b), **kw)
    jkw = dict(kw)
    if kw.get("semiring", "plus_times") != "plus_times":
        jkw["config"] = JCFG_VPU.replace(semiring=kw["semiring"])
    exp = jax_matmul(jnp.asarray(a, dtype), jnp.asarray(b, dtype), **jkw)
    got = got.float() if got.dtype == torch.bfloat16 else got
    return got.numpy(), np.asarray(exp).astype(got.numpy().dtype)


@pytest.mark.parametrize("bsz,m,n,k", [
    (7, 33, 65, 17),     # unaligned everything
    (4, 128, 128, 128),  # aligned per-head shape
    (3, 100, 200, 50),
    (1, 16, 128, 8),     # degenerate batch
])
def test_batched_matches_jax(bsz, m, n, k):
    got, exp = _both(_u((bsz, m, k), 1), _u((bsz, k, n), 2))
    assert got.shape == (bsz, m, n)
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ta,tb", LAYOUTS)
def test_batched_transposes(ta, tb):
    bsz, m, n, k = 5, 33, 65, 17
    got, exp = _both(_u(_shape(bsz, m, k, ta), 3), _u(_shape(bsz, k, n, tb), 4),
                     transpose_a=ta, transpose_b=tb)
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)


def test_batched_int8_exact():
    rng = np.random.default_rng(7)
    a = rng.integers(-20, 20, (3, 32, 16)).astype(np.int8)
    b = rng.integers(-20, 20, (3, 16, 64)).astype(np.int8)
    got, exp = _both(a, b, out_dtype="int32")
    np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(got, np.einsum(
        "bmk,bkn->bmn", a.astype(np.int64), b.astype(np.int64)))


@pytest.mark.parametrize("out,rtol", [("float32", RTOL), (None, 1e-2)])
def test_batched_bf16(out, rtol):
    got, exp = _both(_u((3, 40, 24), 5), _u((3, 24, 136), 6), dtype="bfloat16",
                     out_dtype=out)
    np.testing.assert_allclose(got, exp, rtol=rtol, atol=rtol * 1e-2)


# ---- B2 on the tile engine: the route (ops.mxu.mxu_route, one rule with
# B1's) and the engine's shapes through the plain path --------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "int8", "float32", "int32"])
@pytest.mark.parametrize("ta,tb", LAYOUTS)
@pytest.mark.parametrize("aligned", [True, False])
def test_batched_route_rule(dtype, ta, tb, aligned):
    # bf16 / fp16 / int8 / fp32 / int32 take the engine in every layout and
    # at every alignment: an operand TMA cannot describe (a base, row pitch
    # or batch stride off 16 bytes), or an int8 one that is not K-major, is
    # packed K-major first (fp32 is split into TF32, int32 into byte
    # planes: neither packs).
    dt = getattr(torch, dtype)
    per = 16 // dt.itemsize
    cols = 4 * per + (0 if aligned else 1)
    a = torch.zeros((3, 24, cols), dtype=dt)
    b = torch.zeros((3, cols, 8 * per), dtype=dt)
    ok = bool(mxu._vec_ok(a) and mxu._vec_ok(b))
    assert ok == aligned
    assert mxu.mxu_route(dt) == "wgmma"
    packs = packed_operands(dt, ta, tb, mxu._vec_ok(a), mxu._vec_ok(b))
    if dtype in ("float32", "int32"):
        assert packs == (False, False)
    else:
        int8 = dtype == "int8"
        assert packs == (not aligned or (int8 and ta), int8 and not tb)


def test_broadcast_operand_is_read_without_a_batch_stride():
    w = torch.zeros((64, 72), dtype=torch.bfloat16)
    assert mxu._strides(w) == (72, 0) and mxu._vec_ok(w)
    x = torch.zeros((3, 64, 72), dtype=torch.bfloat16)
    assert mxu._strides(x) == (72, 64 * 72)


@pytest.mark.parametrize("ta,tb", LAYOUTS)
@pytest.mark.parametrize("broadcast", [None, "a", "b"])
def test_engine_shapes_match_jax(ta, tb, broadcast):
    # The engine's tiles at a small size: M and N multiples of 64, K = 100
    # (not a whole 64-deep slab), bf16 operands to fp32, a 2-D operand
    # broadcast; relative 1e-3 (fp32 sums in two orders).
    bsz, m, n, k = 2, 128, 64, 100
    a = _u(_shape(bsz, m, k, ta), 20)
    b = _u(_shape(bsz, k, n, tb), 21)
    a = a[0] if broadcast == "a" else a
    b = b[0] if broadcast == "b" else b
    got, exp = _both(a, b, dtype="bfloat16", out_dtype="float32", transpose_a=ta,
                     transpose_b=tb)
    assert got.shape == (bsz, m, n)
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)


def test_engine_int8_shape_exact():
    # int8 on the engine: A (B, M, K) and B held (B, N, K), K = 144 (past
    # one 128-deep slab); exact int32.
    rng = np.random.default_rng(23)
    a = rng.integers(-100, 100, (2, 64, 144)).astype(np.int8)
    b = rng.integers(-100, 100, (2, 128, 144)).astype(np.int8)
    got, exp = _both(a, b, out_dtype="int32", transpose_b=True)
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("ta,tb", LAYOUTS)
def test_batched_gradients_match_jax(ta, tb):
    a = _u(_shape(2, 16, 24, ta), 8)
    b = _u(_shape(2, 24, 32, tb), 9)

    def loss(x, y):
        return jnp.sum(jax_matmul(x, y, transpose_a=ta, transpose_b=tb) ** 2)

    exp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    x = torch.from_numpy(a).requires_grad_()
    y = torch.from_numpy(b).requires_grad_()
    (matmul(x, y, transpose_a=ta, transpose_b=tb) ** 2).sum().backward()
    for got, e in zip((x.grad, y.grad), exp):
        assert got.shape == e.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(e), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("which", ["a", "b"])
@pytest.mark.parametrize("ta,tb", LAYOUTS)
def test_broadcast_2d_operand(which, ta, tb):
    a = _u(_shape(3, 16, 8, ta), 10)
    b = _u(_shape(3, 8, 24, tb), 11)
    a, b = (a[0], b) if which == "a" else (a, b[0])
    got, exp = _both(a, b, transpose_a=ta, transpose_b=tb)
    assert got.shape == (3, 16, 24)
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("which,ta", [("a", False), ("a", True), ("b", False),
                                      ("b", True)])
def test_broadcast_gradients_match_jax(which, ta):
    # The gradient of the broadcast 2-D operand is the sum over the batch.
    a = _u(_shape(3, 16, 8, ta), 12)
    b = _u((3, 8, 24), 13)
    a, b = (a[0], b) if which == "a" else (a, b[0])

    def loss(x, y):
        return jnp.sum(jnp.tanh(jax_matmul(x, y, transpose_a=ta)))

    exp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    x = torch.from_numpy(a).requires_grad_()
    y = torch.from_numpy(b).requires_grad_()
    torch.tanh(matmul(x, y, transpose_a=ta)).sum().backward()
    for got, e in zip((x.grad, y.grad), exp):
        assert got.shape == e.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(e), rtol=RTOL,
                                   atol=ATOL)


def test_nd_batching_flattens_leading_dims():
    a = _u((2, 3, 16, 8), 14)
    got, exp = _both(a, _u((2, 3, 8, 24), 15))
    assert got.shape == exp.shape == (2, 3, 16, 24)
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)
    # A 2-D weight broadcast across a 4-D activation batch.
    got, exp = _both(a, _u((8, 24), 16))
    assert got.shape == (2, 3, 16, 24)
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="batch dims"):
        matmul(torch.from_numpy(a), torch.zeros(5, 8, 24))


def test_zero_batch_returns_empty():
    got, exp = _both(np.zeros((0, 16, 8), np.float32),
                     np.zeros((0, 8, 24), np.float32))
    assert got.shape == exp.shape == (0, 16, 24)
    out = matmul(torch.zeros(0, 16, 8, dtype=torch.int8),
                 torch.zeros(0, 8, 24, dtype=torch.int8), out_dtype="int32")
    assert out.dtype == torch.int32 and out.shape == (0, 16, 24)


@pytest.mark.parametrize("case,match", [
    ("batch", "batch dims"), ("contraction", "contraction mismatch"),
    ("dtype", "dtype mismatch"), ("semiring", "does not support")])
def test_zero_batch_validates_like_nonempty(case, match):
    a = np.zeros((0, 16, 8), np.float32)
    b = np.zeros((0, 8, 24), np.float32)
    kw = {}
    if case == "batch":
        b = np.zeros((5, 8, 24), np.float32)
    elif case == "contraction":
        b = np.zeros((0, 9, 24), np.float32)
    elif case == "dtype":
        b = np.zeros((0, 8, 24), np.int32)
    else:
        a, b = a.astype(bool), b.astype(bool)
        kw["semiring"] = "min_plus"
    with pytest.raises(ValueError, match=match):
        matmul(torch.from_numpy(a), torch.from_numpy(b), **kw)
    with pytest.raises(ValueError, match=match):
        jax_matmul(jnp.asarray(a), jnp.asarray(b), **kw)


@pytest.mark.parametrize("name", ["min_plus", "max_plus", "max_min",
                                  "plus_absdiff"])
@pytest.mark.parametrize("broadcast", [False, True])
def test_semiring_batched_matches_jax(name, broadcast):
    a = _u((2, 24, 16), 17)
    b = _u((2, 16, 32), 18)
    if broadcast:
        b = b[1]
    got, exp = _both(a, b, semiring=name)
    if name == "plus_absdiff":
        np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(got, exp)
    forced = matmul(torch.from_numpy(a), torch.from_numpy(b), semiring=name,
                    backend="vpu").numpy()
    np.testing.assert_allclose(forced, exp, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("backend", [None, "vpu", "torch"])
def test_batched_bool_or_and(backend):
    rng = np.random.default_rng(19)
    a = rng.random((3, 20, 70)) < 0.05
    b = rng.random((3, 70, 30)) < 0.05
    exp = np.einsum("bmk,bkn->bmn", a.astype(np.int64), b.astype(np.int64)) > 0
    got = matmul(torch.from_numpy(a), torch.from_numpy(b), semiring="or_and",
                 backend=backend)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), exp)


def test_torch_backend_is_the_plain_version():
    a, b = torch.from_numpy(_u((4, 30, 40), 20)), torch.from_numpy(_u((4, 40, 50), 21))
    np.testing.assert_allclose(matmul(a, b, backend="torch").numpy(),
                               matmul(a, b).numpy(), rtol=1e-6)


def test_strict_pad_policy_holds_per_example():
    cfg = GemmConfig(block_m=32, block_n=128, block_k=128, pad_policy="strict")
    with pytest.raises(ValueError, match="pad_policy='strict'"):
        matmul(torch.zeros(2, 33, 128), torch.zeros(2, 128, 128), config=cfg)
    out = matmul(torch.ones(2, 32, 128), torch.ones(2, 128, 128), config=cfg)
    assert torch.equal(out, torch.full((2, 32, 128), 128.0))


def test_plain_calls_launch_nothing():
    before = (mxu.mxu_matmul.launches, mxu.mxu_matmul_batched.launches)
    matmul(torch.ones(3, 4, 5), torch.ones(3, 5, 6))
    matmul(torch.ones(3, 4, 5), torch.ones(5, 6))
    assert (mxu.mxu_matmul.launches, mxu.mxu_matmul_batched.launches) == before


def test_batched_module_rejects_bad_operands():
    cfg = GemmConfig()
    with pytest.raises(ValueError, match="3-D"):
        mxu.mxu_matmul_batched(torch.ones(4, 5), torch.ones(5, 3), cfg=cfg)
    with pytest.raises(ValueError, match="batch dims"):
        mxu.mxu_matmul_batched(torch.ones(2, 4, 5), torch.ones(3, 5, 3), cfg=cfg)
    with pytest.raises(ValueError, match="operands on"):
        mxu.mxu_matmul_batched(torch.ones(2, 4, 5),
                               torch.ones(2, 5, 3, device="meta"), cfg=cfg)
