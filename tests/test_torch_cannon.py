"""The port's fused Cannon (``gemm_hls_tpu_torch.parallel.cannon_matmul_fused``,
the plain schedule of kernel B19 on CPU ranks) against the JAX package's
``cannon_matmul_fused`` on the conftest's virtual mesh in interpret mode,
on the same numpy inputs.

p = 2 is the largest grid the 8-device mesh holds; p = 3 (9 ranks) runs
against the numpy float64 oracle only.  Tolerances as in
``test_torch_ring.py``: int8 exact, float32 relative 1e-5, bfloat16
inputs 1e-3.  A bfloat16 output is held to one rounding of bfloat16
(relative 2^-8): both sides keep the running sum in bfloat16, rounding
each step's product and partial sum, so only a step product that the
dot's summation order puts on the other side of a rounding boundary can
differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemm_hls_tpu.ops.pallas_cannon import cannon_matmul_fused as jax_cannon
from gemm_hls_tpu_torch.ops.cannon import assemble, cannon_blocks, cannon_gemm_plain
from gemm_hls_tpu_torch.parallel import cannon_matmul_fused

from test_torch_ring import RTOL, agree, operands


def torch_cannon(a, b, p, dtype, out_dtype="float32"):
    dt = getattr(torch, dtype)
    return cannon_matmul_fused(torch.from_numpy(a).to(dt), torch.from_numpy(b).to(dt), p,
                               devices=["cpu"] * (p * p),
                               out_dtype=getattr(torch, out_dtype)).float().numpy()


# (input dtype, M, N, K, permuted JAX mesh, output dtype)
VS_JAX = ([(dt, m, n, k, perm, "float32") for dt in RTOL
           for m, n, k, perm in ((32, 48, 64, False), (40, 24, 56, True))]
          + [("bfloat16", 32, 48, 64, False, "bfloat16"),
             ("float32", 40, 24, 56, True, "bfloat16")])


@pytest.mark.parametrize("dtype,m,n,k,permute,out_dtype", VS_JAX)
def test_cannon_fused_vs_jax(dtype, m, n, k, permute, out_dtype):
    a, b = operands(m, n, k, dtype, seed=900 + m)
    devices = list(jax.devices())[:4]
    if permute:
        devices = [devices[j] for j in np.random.default_rng(m).permutation(4)]
    want = np.asarray(jax_cannon(jnp.asarray(a, jnp.dtype(dtype)),
                                 jnp.asarray(b, jnp.dtype(dtype)), 2, devices=devices,
                                 out_dtype=jnp.dtype(out_dtype)))
    got = torch_cannon(a, b, 2, dtype, out_dtype)
    if out_dtype == "float32":
        agree(got, want, dtype)
    else:
        np.testing.assert_allclose(got, want.astype(np.float32), rtol=2.0 ** -8, atol=0)


@pytest.mark.parametrize("p", [2, 3])
def test_cannon_fused_identity_skew(p):
    # Structured data catches mis-skews that random data might mask: A of
    # constant blocks times I comes back exactly only if every block lands
    # at the right rank.
    ml = 8
    a = np.kron(np.arange(1, p * p + 1).reshape(p, p), np.ones((ml, ml))).astype(np.float32)
    b = np.eye(p * ml, dtype=np.float32)
    got = torch_cannon(a, b, p, "float32")
    np.testing.assert_array_equal(got, a)
    if p == 2:
        np.testing.assert_array_equal(
            got, np.asarray(jax_cannon(jnp.asarray(a), jnp.asarray(b), p=p)))


@pytest.mark.parametrize("dtype", list(RTOL))
def test_cannon_p3_vs_float64_oracle(dtype):
    # Nine ranks: more than the virtual mesh's 8 devices, so no JAX side.
    a, b = operands(27, 45, 63, dtype, seed=33)
    got = torch_cannon(a, b, 3, dtype)
    dt = getattr(torch, dtype)
    a64 = torch.from_numpy(a).to(dt).double().numpy()
    b64 = torch.from_numpy(b).to(dt).double().numpy()
    want = (a64 @ b64).astype(np.float32)
    if dtype == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL[dtype], atol=0)


def test_plain_schedule_returns_blocks_in_flat_order():
    # cannon_gemm_plain, the kernel's counterpart: block (i, j) of C at
    # flat index i p + j.
    p = 2
    a, b = (torch.from_numpy(t) for t in operands(8, 12, 16, "float32", seed=5))
    ab = [a[i * 4:(i + 1) * 4, j * 8:(j + 1) * 8] for i in range(p) for j in range(p)]
    bb = [b[i * 8:(i + 1) * 8, j * 6:(j + 1) * 6] for i in range(p) for j in range(p)]
    out = cannon_gemm_plain(ab, bb, p)
    full = a @ b
    for i in range(p):
        for j in range(p):
            torch.testing.assert_close(out[i * p + j], full[i * 4:(i + 1) * 4, j * 6:(j + 1) * 6])


def test_cannon_fused_rejects_bad_grid():
    with pytest.raises(ValueError, match="not divisible"):
        cannon_matmul_fused(torch.zeros((9, 8)), torch.zeros((8, 8)), p=2,
                            devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="need"):
        cannon_matmul_fused(torch.zeros((8, 8)), torch.zeros((8, 8)), p=2,
                            devices=["cpu"] * 3)


def test_cannon_on_four_cards_raises_before_any_cuda_call():
    devices = [torch.device("cuda", i) for i in range(4)]
    with pytest.raises(NotImplementedError, match="A7"):
        cannon_matmul_fused(torch.zeros((8, 8)), torch.zeros((8, 8)), p=2, devices=devices)


def test_interpret_and_precision_are_accepted():
    a, b = operands(16, 16, 16, "float32", seed=7)
    want = torch_cannon(a, b, 2, "float32")
    got = cannon_matmul_fused(torch.from_numpy(a), torch.from_numpy(b), 2,
                              devices=["cpu"] * 4, interpret=True, precision="highest")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("in_dtype", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("p", [2, 3])
def test_plain_schedule_rounds_per_step(in_dtype, p):
    # A bfloat16 output keeps the running sum in bfloat16 (ROADMAP C1f,
    # pallas_cannon.py's acc of out_dtype): each step's product rounded,
    # then each partial sum; the kernels do the same on the card.
    a, b = operands(8 * p, 8 * p, 16 * p, in_dtype, seed=40 + p)
    dt = getattr(torch, in_dtype)
    a, b = torch.from_numpy(a).to(dt), torch.from_numpy(b).to(dt)
    ab, bb = cannon_blocks(a, b, p)
    got = cannon_gemm_plain(ab, bb, p, out_dtype=torch.bfloat16)
    for i in range(p):
        for j in range(p):
            acc = None
            for s in range(p):
                l_ = (i + j + s) % p  # the A / B block pair rank (i, j) holds at step s
                x, y = ab[i * p + l_].double(), bb[l_ * p + j].double()
                part = (x @ y).to(torch.bfloat16)
                acc = part if acc is None else (acc.float() + part.float()).to(torch.bfloat16)
            assert torch.equal(got[i * p + j], acc)
    # float32 outputs still sum in fp32 and round once.
    once = cannon_gemm_plain(ab, bb, p, out_dtype=torch.float32)
    full = (a.double() @ b.double()).float()
    torch.testing.assert_close(assemble(once, p), full, rtol=1e-5 if dt.is_floating_point else 0,
                               atol=0 if not dt.is_floating_point else 1e-5)


def test_running_sum_buffers():
    # The kernel's running-sum buffer: fp32, or int32 for int8 summed
    # exactly; fp32 for any narrow float output (it holds the rounded sums).
    from gemm_hls_tpu_torch.ops.cannon import cannon_scratch, sum_dtype, tile_flags
    from gemm_hls_tpu_torch.ops.ring import flag_words
    assert sum_dtype(torch.int8, torch.float32) == torch.int32
    assert sum_dtype(torch.int8, torch.bfloat16) == torch.float32
    assert sum_dtype(torch.bfloat16, torch.float16) == torch.float32
    assert tile_flags(4096, 4096) == 32 * 16 and tile_flags(130, 260) == 4
    sc = cannon_scratch(2, 130, 260, 64, torch.int8, "cpu", torch.bfloat16)
    assert sc.sums[0].dtype == torch.float32
    assert sc.flags[0].numel() == flag_words(2, 3, 4) == 32
    assert flag_words(2, 3, 512) == 544
