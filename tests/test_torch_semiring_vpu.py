"""Kernel B3's module (``gemm_hls_tpu_torch/ops/vpu.py``) against the JAX
package's ``pallas_vpu.vpu_matmul`` and ``matmul(semiring=...)``.

The JAX side runs its Pallas kernel in interpret mode with the blocks of
``tests/test_vpu_semiring.py``; the port's side runs the plain version, as
a CPU tensor does.  The CUDA kernel is checked on the card by
``tests/test_torch_kernels.py`` and ``chip_smoke.py``.

Tolerances: exact for integer, bool and tropical results (min/max over
identically rounded terms); relative 1e-5 for sums (plus_times,
plus_absdiff, plus_sqdiff) and for log_plus, whose folds run in
different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemm_hls_tpu import GemmConfig as JaxConfig
from gemm_hls_tpu import matmul as jax_matmul
from gemm_hls_tpu.ops import pallas_vpu
from gemm_hls_tpu.ops.semiring import get_semiring as jax_get_semiring

from gemm_hls_tpu_torch import matmul
from gemm_hls_tpu_torch.config import default_config
from gemm_hls_tpu_torch.ops import vpu
from gemm_hls_tpu_torch.ops.semiring import get_semiring
from gemm_hls_tpu_torch.utils import make_operands, reference_matmul, verify_matmul

torch.set_num_threads(1)

JCFG = JaxConfig(block_m=16, block_n=128, block_k=64, interpret=True)

TROPICAL = ["min_plus", "max_plus", "max_min", "min_max", "max_times"]
SUMS = ["plus_times", "plus_absdiff", "plus_sqdiff", "log_plus"]
ALL = TROPICAL + SUMS


def _rtol(name, dtype="float32"):
    return 0.0 if (name in TROPICAL or dtype == "int32") else 1e-5


def _agree(got, exp, rtol):
    if rtol == 0.0:
        np.testing.assert_array_equal(got, exp)
    else:
        np.testing.assert_allclose(got, exp, rtol=rtol, atol=0)


def _jax_vpu(a, b, name, dtype, out=None):
    """``pallas_vpu.vpu_matmul`` on operands padded to its blocks."""
    cfg = JCFG.replace(dtype=dtype, out_dtype=out, semiring=name)
    m, k = a.shape
    n = b.shape[1]
    mp, np_, kp = cfg.padded_shape(m, n, k)
    aj = jnp.pad(jnp.asarray(a, dtype), ((0, mp - m), (0, kp - k)))
    bj = jnp.pad(jnp.asarray(b, dtype), ((0, kp - k), (0, np_ - n)))
    out = pallas_vpu.vpu_matmul(aj, bj, cfg=cfg, sr=jax_get_semiring(name),
                                k_actual=k, interpret=True)
    return np.asarray(out[:m, :n]).astype(np.float32 if dtype != "int32"
                                          else np.int64)


def _port_vpu(a, b, name, dtype, out=None, ta=False, tb=False):
    dt = getattr(torch, dtype)
    cfg = default_config(dtype, semiring=name, out_dtype=out)
    got = vpu.vpu_matmul(torch.from_numpy(a).to(dt),
                         torch.from_numpy(b).to(dt), cfg=cfg,
                         sr=get_semiring(name), transpose_a=ta, transpose_b=tb)
    return (got.float() if got.is_floating_point() else got).numpy()


@pytest.mark.parametrize("name", ALL)
@pytest.mark.parametrize("mnk", [(32, 256, 128), (21, 130, 77)],
                         ids=["aligned", "unaligned"])
def test_module_matches_pallas_vpu_f32(name, mnk):
    a, b = make_operands(*mnk, "float32")
    got = _port_vpu(a, b, name, "float32")
    _agree(got, _jax_vpu(a, b, name, "float32"), _rtol(name))
    verify_matmul(got, reference_matmul(a, b, semiring=name), what=name)


@pytest.mark.parametrize("name", TROPICAL)
def test_module_matches_pallas_vpu_int32(name):
    a, b = make_operands(17, 129, 33, "int32")
    got = _port_vpu(a, b, name, "int32")
    _agree(got, _jax_vpu(a, b, name, "int32"), 0.0)
    np.testing.assert_array_equal(got, reference_matmul(a, b, semiring=name))


@pytest.mark.parametrize("name", ["plus_times", "plus_absdiff", "plus_sqdiff"])
def test_module_int32_sums_match_oracle(name):
    # The reference's VPU kernel cannot run int32 sums under jax x64 (its
    # jnp.sum widens the carry to int64), so these hold against the oracle.
    a, b = make_operands(17, 129, 33, "int32")
    got = _port_vpu(a, b, name, "int32")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, reference_matmul(a, b, semiring=name))


@pytest.mark.parametrize("name", ALL)
def test_module_matches_pallas_vpu_bf16_inputs(name):
    # Identically rounded bf16 inputs, fp32 accumulation and output.
    a, b = make_operands(18, 140, 70, "float32", seed=8)
    got = _port_vpu(a, b, name, "bfloat16", out="float32")
    _agree(got, _jax_vpu(a, b, name, "bfloat16", out="float32"), _rtol(name))


@pytest.mark.parametrize("ta,tb", [(True, False), (False, True), (True, True)])
@pytest.mark.parametrize("name", ["min_plus", "plus_sqdiff"])
def test_module_transposes(name, ta, tb):
    a, b = make_operands(21, 130, 77, "float32", transpose_a=ta,
                         transpose_b=tb)
    got = _port_vpu(a, b, name, "float32", ta=ta, tb=tb)
    exp = _jax_vpu(a.T if ta else a, b.T if tb else b, name, "float32")
    _agree(got, exp, _rtol(name))


@pytest.mark.parametrize("name", ALL)
def test_front_door_matches_jax(name):
    a, b = make_operands(21, 130, 77, "float32", seed=2)
    got = matmul(torch.from_numpy(a), torch.from_numpy(b), semiring=name)
    exp = jax_matmul(jnp.asarray(a), jnp.asarray(b), semiring=name,
                     config=JCFG)
    _agree(got.numpy(), np.asarray(exp), _rtol(name))


@pytest.mark.parametrize("name", TROPICAL)
def test_nan_and_inf_inputs(name):
    # fminf/fmaxf would drop a NaN; the reference (jnp.minimum) and the
    # port propagate it.  Infinities are exact.
    a, b = make_operands(20, 130, 40, "float32", seed=4)
    a[3, 10] = np.nan
    b[20, 7] = np.nan
    a[5, :] = np.inf
    b[:, 9] = -np.inf
    a[11, 30] = -np.inf
    got = _port_vpu(a, b, name, "float32")
    exp = _jax_vpu(a, b, name, "float32")
    np.testing.assert_array_equal(got, exp)  # NaN == NaN here
    assert np.isnan(got[3]).all() and np.isnan(got[:, 7]).all()


def test_log_plus_all_neg_inf_rows():
    # logaddexp(-inf, -inf) must be -inf, not the naive form's NaN.
    a, b = make_operands(20, 130, 40, "float32", seed=6)
    a[7, :] = -np.inf
    b[:, 3] = -np.inf
    got = _port_vpu(a, b, "log_plus", "float32")
    exp = _jax_vpu(a, b, "log_plus", "float32")
    assert np.isneginf(got[7]).all() and np.isneginf(got[:, 3]).all()
    _agree(got, exp, 1e-5)


def test_int32_min_plus_identity_does_not_wrap():
    # K tail masked, not padded: INT_MAX + x is never formed.
    a = np.full((5, 37), 2**31 - 10, np.int32)
    b = np.full((37, 130), 3, np.int32)
    got = _port_vpu(a, b, "min_plus", "int32")
    np.testing.assert_array_equal(got, _jax_vpu(a, b, "min_plus", "int32"))


@pytest.mark.parametrize("backend,jax_backend", [(None, None),
                                                 ("vpu", "pallas-vpu")])
@pytest.mark.parametrize("k", [1, 31, 33, 100])
def test_bool_or_and_both_routes(backend, jax_backend, k):
    rng = np.random.default_rng(11 + k)
    a = rng.random((19, k)) < 0.1
    b = rng.random((k, 131)) < 0.1
    got = matmul(torch.from_numpy(a), torch.from_numpy(b), semiring="or_and",
                 backend=backend)
    assert got.dtype == torch.bool
    exp = jax_matmul(jnp.asarray(a), jnp.asarray(b), semiring="or_and",
                     config=JCFG, backend=jax_backend)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    np.testing.assert_array_equal(got.numpy(),
                                  reference_matmul(a, b, semiring="or_and"))


def test_bool_or_and_count_of_256_is_true():
    # The reference stores the int8 counts as int8, so 256 reads as 0
    # (ROADMAP C2); the port keeps int32 counts and agrees with the oracle.
    a = np.ones((3, 256), bool)
    b = np.ones((256, 2), bool)
    got = matmul(torch.from_numpy(a), torch.from_numpy(b), semiring="or_and")
    assert got.all()
    np.testing.assert_array_equal(got.numpy(),
                                  reference_matmul(a, b, semiring="or_and"))


@pytest.mark.parametrize("backend", [None, "vpu"])
def test_or_and_on_float32_operands_is_0_or_1(backend):
    # ROADMAP C2: the reference cannot trace or_and on non-bool operands
    # (its scan carry is float32 in, bool out); the port returns 0 / 1 in
    # the input dtype, held here to the numpy oracle.  Nonzero entries of
    # either sign count as true.
    rng = np.random.default_rng(29)
    a = np.where(rng.random((17, 40)) < 0.1, rng.uniform(-2, 2, (17, 40)), 0).astype(np.float32)
    b = np.where(rng.random((40, 23)) < 0.1, rng.uniform(-2, 2, (40, 23)), 0).astype(np.float32)
    got = matmul(torch.from_numpy(a), torch.from_numpy(b), semiring="or_and",
                 backend=backend)
    assert got.dtype == torch.float32
    assert set(np.unique(got.numpy())) <= {0.0, 1.0}
    want = reference_matmul(a, b, semiring="or_and")
    assert want.any() and not want.all()
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


def test_pack_bits_match_reference():
    import importlib
    jax_mm = importlib.import_module("gemm_hls_tpu.ops.matmul")
    port_mm = importlib.import_module("gemm_hls_tpu_torch.ops.matmul")
    rng = np.random.default_rng(3)
    x = rng.random((9, 70)) < 0.5
    np.testing.assert_array_equal(
        port_mm._pack_bits_rows(torch.from_numpy(x)).numpy(),
        np.asarray(jax_mm._pack_bits_rows(jnp.asarray(x))))
    np.testing.assert_array_equal(
        port_mm._pack_bits_cols(torch.from_numpy(x)).numpy(),
        np.asarray(jax_mm._pack_bits_cols(jnp.asarray(x))))


def test_custom_semiring_runs_plain_on_cpu():
    from gemm_hls_tpu_torch.ops.semiring import Semiring
    sr = Semiring(name="max_absdiff", map_op=lambda x, y: (x - y).abs(),
                  reduce_op=torch.maximum, identity=float("-inf"),
                  np_map=lambda x, y: np.abs(x - y), np_reduce=np.maximum)
    a, b = make_operands(10, 20, 30, "float32")
    got = matmul(torch.from_numpy(a), torch.from_numpy(b), semiring=sr)
    exp = np.abs(a[:, :, None] - b[None]).max(axis=1)
    np.testing.assert_array_equal(got.numpy(), exp)


def test_launch_counter_ignores_plain_calls():
    before = vpu.vpu_matmul.launches
    _port_vpu(*make_operands(8, 8, 8, "float32"), "min_plus", "float32")
    assert vpu.vpu_matmul.launches == before
