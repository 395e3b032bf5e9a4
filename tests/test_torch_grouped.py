"""The port's grouped GEMM (``ops/gmm.py``, ``ops/grouped.py``) against
the JAX package on the CPU, over ``tests/test_grouped.py``'s matrix.

The same numpy inputs go through ``gemm_hls_tpu.ops.grouped
.grouped_matmul`` (its Pallas kernel in interpret mode) and the port's
plain version (CPU tensors).  Tolerance: relative error below 1e-5 of the
largest output (both sum in fp32), and the rows past ``sum(group_sizes)``
exactly zero.  The kernel runs only on the card
(``tests/test_torch_kernels.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemm_hls_tpu.config import GemmConfig as JaxConfig
from gemm_hls_tpu.ops.grouped import grouped_matmul as jax_grouped
from gemm_hls_tpu_torch import grouped_matmul
from gemm_hls_tpu_torch.ops import gmm

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


def test_cuda_gradient_is_refused_naming_b17():
    # Meta tensors stand in for a card: any non-CPU input that needs a
    # gradient is refused before a kernel is reached.
    lhs = torch.ones(8, 4, device="meta", requires_grad=True)
    rhs = torch.ones(2, 4, 4, device="meta")
    with pytest.raises(NotImplementedError, match="B17.*item 13"):
        grouped_matmul(lhs, rhs, torch.tensor([4, 4], device="meta"))


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
