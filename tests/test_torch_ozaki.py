"""The port's Ozaki f64-class GEMMs (``ops/ozaki.py``) against
``gemm_hls_tpu.ops.ozaki`` on the same numpy inputs.

The JAX side runs its Pallas kernels in interpret mode, as
``tests/test_ozaki.py`` does; the port runs with ``device="cpu"`` (the
plain versions of B1 and B5).  Tolerances: splits exact; ``ozaki_matmul``
1e-14 and ``ozaki_matmul_int8`` 1e-13 normwise against the float64 oracle
(the JAX tests' bounds) and within 1e-15 of the normwise scale of JAX's own
result.  The K > 2^17 case runs against the oracle only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemm_hls_tpu.ops import ozaki as jax_ozaki

from gemm_hls_tpu_torch.config import default_config
from gemm_hls_tpu_torch.ops import ozaki
from gemm_hls_tpu_torch.utils import make_operands

torch.set_num_threads(1)


def _scale(a, b):
    return (np.linalg.norm(a, axis=1)[:, None]
            * np.linalg.norm(b, axis=0)[None, :])


def _normwise(got, a, b):
    return (np.abs(got - a @ b) / _scale(a, b)).max()


def _near_jax(got, exp, a, b):
    assert (np.abs(got - exp) / _scale(a, b)).max() <= 1e-15


@pytest.mark.parametrize("k", [128, 1024, 8192, 65536, 1 << 22])
def test_slice_plan_matches_jax(k):
    assert ozaki.slice_plan(k) == jax_ozaki.slice_plan(k)
    bits, n = ozaki.slice_plan(k)
    assert 2 * bits + int(np.ceil(np.log2(k))) <= 24 and bits * n >= 40


def test_slice_plan_k_bound():
    with pytest.raises(ValueError, match="exactness bound"):
        ozaki.slice_plan(1 << 23)


@pytest.mark.parametrize("axis", [0, 1])
def test_host_splits_match_jax(axis):
    rng = np.random.default_rng(0)
    x = rng.uniform(-1e3, 1e3, (32, 40))
    bits, n = ozaki.slice_plan(1024)
    np.testing.assert_array_equal(ozaki.split_f64(x, bits, n, axis),
                                  jax_ozaki.split_f64(x, bits, n, axis))
    s, u = ozaki.split_f64_int8(x, 8, axis)
    js, ju = jax_ozaki.split_f64_int8(x, 8, axis)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(u, ju)
    for got, exp in zip(ozaki.f64_to_f32pair(x), jax_ozaki.f64_to_f32pair(x)):
        np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("axis", [0, 1])
def test_device_f64_split_equals_host(axis):
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (24, 40)) * 10.0 ** rng.integers(-6, 6, (24, 40))
    x[3] = 0.0
    s, u = ozaki.device_split_f64_int8(torch.from_numpy(x), 8, axis)
    hs, hu = ozaki.split_f64_int8(x, 8, axis)
    np.testing.assert_array_equal(s.numpy(), hs)
    np.testing.assert_array_equal(u.numpy(), hu)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("k", [128, 2048])
def test_device_f64_split_of_ozaki_matmul_equals_host(axis, k):
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (24, 40)) * 10.0 ** rng.integers(-6, 6, (24, 40))
    x[5] = 0.0
    bits, n = ozaki.slice_plan(k)
    np.testing.assert_array_equal(
        ozaki.device_split_f64(torch.from_numpy(x), bits, n, axis).numpy(),
        jax_ozaki.split_f64(x, bits, n, axis))


@pytest.mark.parametrize("axis", [0, 1])
def test_device_split_int8_matches_jax(axis):
    rng = np.random.default_rng(3)
    x = rng.uniform(-1e3, 1e3, (24, 40))
    hi, lo = ozaki.f64_to_f32pair(x)
    s, u = ozaki.device_split_int8(torch.from_numpy(hi), torch.from_numpy(lo),
                                   n_slices=8, axis=axis)
    js, ju = jax_ozaki.device_split_int8(jnp.asarray(hi), jnp.asarray(lo),
                                         n_slices=8, axis=axis)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    recon = sum(s[i].double().numpy() * 2.0 ** (-7 * i) for i in range(8))
    recon = recon * u.double().numpy()
    vmax = np.max(np.abs(x), axis=axis, keepdims=True)
    assert np.max(np.abs(recon - x) / vmax) < 2.0 ** -44


@pytest.mark.parametrize("mnk,check", [((64, 48, 128), "elementwise"),
                                       ((33, 65, 127), "elementwise"),
                                       ((64, 64, 256), "normwise")])
def test_ozaki_matmul_matches_jax(mnk, check):
    # The JAX tests' checks: elementwise relative 1e-12 (test_f64_accuracy)
    # and normwise 1e-14 (test_normwise_full_f64_accuracy).
    m, n, k = mnk
    a, b = make_operands(m, n, k, "float64", low=-5.0, high=5.0)
    got = ozaki.ozaki_matmul(a, b, device="cpu")
    assert got.dtype == np.float64 and got.shape == (m, n)
    if check == "normwise":
        assert _normwise(got, a, b) < 1e-14
    else:
        exp = a @ b
        assert (np.abs(got - exp) / np.abs(exp)).max() < 1e-12
    _near_jax(got, jax_ozaki.ozaki_matmul(a, b, interpret=True), a, b)


@pytest.mark.parametrize("mnk", [(64, 48, 128), (64, 64, 256), (40, 30, 2048)])
def test_ozaki_matmul_float64_sums(mnk):
    # The same exact partials summed in float64 (ozaki_matmul's sum on
    # CUDA): no float-float floor, no farther from the oracle than JAX's.
    m, n, k = mnk
    a, b = make_operands(m, n, k, "float64", low=-5.0, high=5.0)
    bits, n_slices = ozaki.slice_plan(k)
    sa = ozaki.device_split_f64(torch.from_numpy(a), bits, n_slices, 1)
    sb = ozaki.device_split_f64(torch.from_numpy(b), bits, n_slices, 0)
    cfg = default_config("bfloat16", out_dtype="float32")
    got = ozaki._f64_accumulate(sa.bfloat16(), sb.bfloat16(), config=cfg).numpy()
    assert _normwise(got, a, b) < 1e-15
    assert _normwise(got, a, b) <= _normwise(ozaki.ozaki_matmul(a, b, device="cpu"), a, b)


def test_beats_plain_f32_by_orders_of_magnitude():
    a, b = make_operands(48, 48, 96, "float64", low=1.0, high=10.0)
    exp = a @ b
    f32_err = np.abs(a.astype(np.float32) @ b.astype(np.float32) - exp) / exp
    ozaki_err = np.abs(ozaki.ozaki_matmul(a, b, device="cpu") - exp) / exp
    assert ozaki_err.max() < f32_err.max() * 1e-5


def test_wide_dynamic_range():
    rng = np.random.default_rng(1)
    a = rng.uniform(1, 2, (16, 64)) * 10.0 ** rng.integers(-8, 8, (16, 64))
    b = rng.uniform(1, 2, (64, 16)) * 10.0 ** rng.integers(-8, 8, (64, 16))
    exp = a @ b
    got = ozaki.ozaki_matmul(a, b, device="cpu")
    assert (np.abs(got - exp) / np.abs(exp)).max() < 1e-8


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("split", ["host", "device"])
def test_ozaki_matmul_int8_matches_jax(fused, split):
    a, b = make_operands(40, 70, 90, "float64", low=-5.0, high=5.0)
    got = ozaki.ozaki_matmul_int8(a, b, fused=fused, split=split, device="cpu")
    assert _normwise(got, a, b) < (1e-13 if split == "host" else 1e-12)
    _near_jax(got, jax_ozaki.ozaki_matmul_int8(a, b, fused=fused, split=split),
              a, b)


def test_ozaki_int8_auto_split_on_cpu_is_host():
    a, b = make_operands(24, 40, 56, "float64", low=-5.0, high=5.0)
    np.testing.assert_array_equal(
        ozaki.ozaki_matmul_int8(a, b, device="cpu"),
        ozaki.ozaki_matmul_int8(a, b, split="host", device="cpu"))


def test_int8_fused_matches_staged():
    a, b = make_operands(40, 70, 90, "float64", low=-5.0, high=5.0)
    fused = ozaki.ozaki_matmul_int8(a, b, fused=True, device="cpu")
    staged = ozaki.ozaki_matmul_int8(a, b, fused=False, device="cpu")
    np.testing.assert_allclose(fused, staged, rtol=1e-12)


def test_int8_fused_large_k():
    # K beyond the staged path's 2^17 bound: per-block flushes keep it
    # f64-accurate (against the oracle only).
    k = (1 << 17) + 256
    a, b = make_operands(8, 8, k, "float64", low=-2.0, high=2.0)
    assert _normwise(ozaki.ozaki_matmul_int8(a, b, device="cpu"), a, b) < 1e-13


@pytest.mark.parametrize("request_", ["staged_k_bound", "split", "shapes",
                                      "interpret", "distributed",
                                      "int8_distributed"])
def test_ozaki_refusals(request_):
    a, b = np.zeros((4, 8)), np.zeros((8, 4))
    calls = {
        "staged_k_bound": (lambda: ozaki.ozaki_matmul_int8(
            np.zeros((4, 1 << 18)), np.zeros((1 << 18, 4)), fused=False,
            device="cpu"), ValueError, "exactness bound"),
        "split": (lambda: ozaki.ozaki_matmul_int8(
            a, b, split="tpu", device="cpu"), ValueError, "split must be"),
        "shapes": (lambda: ozaki.ozaki_matmul(a, a, device="cpu"),
                   ValueError, "contraction mismatch"),
        "interpret": (lambda: ozaki.ozaki_matmul(a, b, interpret=True),
                      NotImplementedError, "interpreter"),
        "distributed": (lambda: ozaki.ozaki_matmul_distributed(a, b, None),
                        NotImplementedError, "A7"),
        "int8_distributed": (lambda: ozaki.ozaki_matmul_int8_distributed(
            a, b, None), NotImplementedError, "A7"),
    }
    fn, exc, match = calls[request_]
    with pytest.raises(exc, match=match):
        fn()
