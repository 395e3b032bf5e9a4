"""The port's front door ``gemm_hls_tpu_torch.matmul`` (the whole slice)
against ``gemm_hls_tpu.matmul``: dispatch, shape policy, errors, gradients
and the host runner.

The JAX side runs its Pallas kernels in interpret mode with the blocks of
``tests/test_matmul.py``; the port runs its plain versions, as CPU tensors
do.  Tolerances: exact for integers and tropical results; relative 1e-5 for
fp32 sums (summation order); bf16 inputs are rounded identically on both
sides and compared in fp32 at relative 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemm_hls_tpu import GemmConfig as JaxConfig
from gemm_hls_tpu import matmul as jax_matmul
from gemm_hls_tpu.utils import unaligned_sizes as jax_unaligned_sizes

from gemm_hls_tpu_torch import GemmConfig, available_semirings, matmul
from gemm_hls_tpu_torch.tools import run
from gemm_hls_tpu_torch.utils import make_operands, reference_matmul, verify_matmul

torch.set_num_threads(1)

JCFG = JaxConfig(block_m=32, block_n=128, block_k=128, interpret=True)
JCFG_VPU = JaxConfig(block_m=16, block_n=128, block_k=64, interpret=True)


def _both(a, b, semiring="plus_times", dtype=None, **kw):
    """(port, jax) results of the front door on the same numpy inputs."""
    tdt = getattr(torch, dtype) if dtype else None
    ta = torch.from_numpy(a) if tdt is None else torch.from_numpy(a).to(tdt)
    tb = torch.from_numpy(b) if tdt is None else torch.from_numpy(b).to(tdt)
    got = matmul(ta, tb, semiring=semiring, **kw)
    jcfg = JCFG if semiring == "plus_times" else JCFG_VPU
    exp = jax_matmul(jnp.asarray(a, dtype), jnp.asarray(b, dtype),
                     semiring=semiring, config=jcfg, **kw)
    got = got.float() if got.dtype == torch.bfloat16 else got
    return got.numpy(), np.asarray(exp).astype(got.numpy().dtype)


@pytest.mark.parametrize("mnk", [(64, 256, 256), (32, 128, 128), (1, 1, 1),
                                 (7, 13, 5), (33, 129, 130)])
def test_plus_times_shapes(mnk):
    a, b = make_operands(*mnk, "float32")
    got, exp = _both(a, b)
    np.testing.assert_allclose(got, exp, rtol=1e-5)
    verify_matmul(got, reference_matmul(a, b))


def test_plus_times_unaligned_adversarial():
    m, n, k = jax_unaligned_sizes(JCFG)
    a, b = make_operands(m, n, k, "float32")
    got, exp = _both(a, b)
    np.testing.assert_allclose(got, exp, rtol=1e-5)


@pytest.mark.parametrize("ta,tb", [(True, False), (False, True), (True, True)])
def test_transposes(ta, tb):
    a, b = make_operands(65, 140, 131, "float32", transpose_a=ta,
                         transpose_b=tb)
    got, exp = _both(a, b, transpose_a=ta, transpose_b=tb)
    assert got.shape == (65, 140)
    np.testing.assert_allclose(got, exp, rtol=1e-5)


@pytest.mark.parametrize("dtype,out,rtol", [
    ("bfloat16", "float32", 1e-5), ("int32", None, 0.0),
    ("float64", None, 1e-12), ("int8", "int32", 0.0)])
def test_dtypes(dtype, out, rtol):
    draw = "float32" if dtype in ("bfloat16", "float64") else "int32"
    a, b = make_operands(48, 160, 200, draw)
    if dtype == "float64":
        a, b = a.astype(np.float64), b.astype(np.float64)
    got, exp = _both(a, b, dtype=dtype, out_dtype=out)
    if rtol:
        np.testing.assert_allclose(got, exp, rtol=rtol)
    else:
        np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("name", sorted(set(available_semirings()) - {"or_and"}))
def test_dispatch_every_semiring(name):
    a, b = make_operands(21, 130, 77, "float32", seed=1)
    got, exp = _both(a, b, semiring=name)
    tropical = name not in ("plus_times", "plus_absdiff", "plus_sqdiff",
                            "log_plus")
    if tropical:
        np.testing.assert_array_equal(got, exp)
    else:
        np.testing.assert_allclose(got, exp, rtol=1e-5)
    # The forced generic kernel (backend="vpu" / "pallas-vpu") agrees too.
    forced = matmul(torch.from_numpy(a), torch.from_numpy(b), semiring=name,
                    backend="vpu").numpy()
    np.testing.assert_allclose(forced, exp, rtol=0 if tropical else 1e-5)


@pytest.mark.parametrize("name", ["plus_times", "min_plus", "log_plus"])
def test_torch_backend_is_the_plain_version(name):
    a, b = make_operands(30, 40, 50, "float32")
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(
        matmul(ta, tb, semiring=name, backend="torch").numpy(),
        matmul(ta, tb, semiring=name).numpy(), rtol=1e-6)


@pytest.mark.parametrize("shape_a,shape_b", [((0, 5), (5, 3)), ((4, 5), (5, 0)),
                                             ((4, 0), (0, 3))])
@pytest.mark.parametrize("name", ["plus_times", "min_plus", "max_plus"])
def test_degenerate_shapes(shape_a, shape_b, name):
    a = np.ones(shape_a, np.float32)
    b = np.ones(shape_b, np.float32)
    got, exp = _both(a, b, semiring=name)
    assert got.shape == exp.shape == (shape_a[0], shape_b[1])
    np.testing.assert_array_equal(got, exp)


def test_strict_pad_policy():
    cfg = GemmConfig(block_m=32, block_n=128, block_k=128, pad_policy="strict")
    jcfg = JCFG.replace(pad_policy="strict")
    a, b = make_operands(33, 128, 128, "float32")
    msg = r"pad_policy='strict': shape \(33,128,128\) not divisible"
    with pytest.raises(ValueError, match=msg):
        matmul(torch.from_numpy(a), torch.from_numpy(b), config=cfg)
    with pytest.raises(ValueError, match=msg):
        jax_matmul(jnp.asarray(a), jnp.asarray(b), config=jcfg)
    a, b = make_operands(64, 128, 128, "float32")
    got = matmul(torch.from_numpy(a), torch.from_numpy(b), config=cfg)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_matmul(jnp.asarray(a), jnp.asarray(b),
                                           config=jcfg)), rtol=1e-5)


@pytest.mark.parametrize("case,match", [
    ("contraction", "contraction mismatch"),
    ("dtype", "dtype mismatch"),
    ("semiring_dtype", "does not support dtype"),
    ("backend", "unknown backend"),
    ("ndim", "ndim >= 2"),
    ("semiring_name", "unknown semiring"),
])
def test_errors_match_reference(case, match):
    a = np.ones((4, 5), np.float32)
    b = np.ones((5, 3), np.float32)
    kw = {}
    exc = ValueError
    if case == "contraction":
        b = np.ones((6, 3), np.float32)
    elif case == "dtype":
        b = np.ones((5, 3), np.int32)
    elif case == "semiring_dtype":
        a, b = a.astype(bool), b.astype(bool)
        kw["semiring"] = "min_plus"
    elif case == "backend":
        kw["backend"] = "tpu"
    elif case == "ndim":
        a = np.ones((5,), np.float32)
    else:
        kw["semiring"] = "no_such"
        exc = KeyError
    with pytest.raises(exc, match=match):
        matmul(torch.from_numpy(a), torch.from_numpy(b), **kw)
    with pytest.raises(exc, match=match):
        jax_matmul(jnp.asarray(a), jnp.asarray(b), **kw)


@pytest.mark.parametrize("request_", ["epilogue", "interpret",
                                      "ozaki_distributed"])
def test_unported_requests_name_roadmap(request_):
    # The i8x tiers and the (batched) tropical gradients, refused here until
    # slice 3, are held against the JAX package in test_torch_int8_slices.py
    # and test_torch_graph.py.
    from gemm_hls_tpu_torch.ops import ozaki

    a = torch.ones(8, 8)
    if request_ == "epilogue":
        # A callable epilogue on a device with neither the plain path nor a
        # compiler (the meta device; on CUDA it compiles into a functor,
        # ops/codegen.py) raises.
        a = a.to("meta")
        call = lambda: matmul(a, torch.ones(8, 8, device="meta"),  # noqa: E731
                              epilogue=lambda acc, bias: acc + bias,
                              epilogue_operands=(torch.ones(8, device="meta"),))
    elif request_ == "interpret":
        call = lambda: matmul(a, a, interpret=True)  # noqa: E731
    else:
        # Landed with the distributed CA-GEMM (ROADMAP A7's GEMM half): the
        # request now runs, here on four CPU ranks.
        from gemm_hls_tpu_torch.parallel import make_mesh

        x = np.random.default_rng(0).uniform(-5, 5, (8, 8))
        got = ozaki.ozaki_matmul_int8_distributed(
            x, x, make_mesh((2, 2), devices=["cpu"] * 4))
        scale = np.linalg.norm(x, axis=1)[:, None] * np.linalg.norm(x, axis=0)[None, :]
        assert (np.abs(got - x @ x) / scale).max() < 1e-13
        return
    with pytest.raises(NotImplementedError, match="ROADMAP|backend='torch'"):
        call()


@pytest.mark.parametrize("ta,tb", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_gradients_match_jax_grad(ta, tb):
    a, b = make_operands(33, 40, 50, "float32", transpose_a=ta,
                         transpose_b=tb)
    g = np.random.default_rng(4).uniform(-1, 1, (33, 40)).astype(np.float32)

    def loss(x, y):
        return jnp.sum(jax_matmul(x, y, config=JCFG, transpose_a=ta,
                                  transpose_b=tb) * g)

    da, db = jax.grad(loss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    x = torch.from_numpy(a).requires_grad_()
    y = torch.from_numpy(b).requires_grad_()
    matmul(x, y, transpose_a=ta, transpose_b=tb).backward(torch.from_numpy(g))
    assert x.grad.shape == a.shape and y.grad.shape == b.shape
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(da), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(y.grad.numpy(), np.asarray(db), rtol=1e-5,
                               atol=1e-5)


def test_bf16_gradients_keep_operand_dtypes():
    a, b = make_operands(16, 24, 32, "float32")
    x = torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
    y = torch.from_numpy(b).to(torch.bfloat16).requires_grad_()
    matmul(x, y, out_dtype="float32").sum().backward()
    assert x.grad.dtype == y.grad.dtype == torch.bfloat16
    ones = np.ones((16, 24))
    np.testing.assert_allclose(x.grad.float().numpy(),
                               ones @ y.detach().float().numpy().T, rtol=1e-2)


@pytest.mark.parametrize("argv", [
    ["64", "96", "80", "--device", "cpu"],
    ["64", "96", "80", "--dtype", "bfloat16", "--device", "cpu"],
    ["33", "70", "45", "--dtype", "int32", "--device", "cpu"],
    ["40", "50", "60", "--semiring", "min_plus", "--device", "cpu"],
    ["40", "50", "60", "--semiring", "log_plus", "--backend", "torch",
     "--device", "cpu"],
    ["33", "40", "70", "--dtype", "bool", "--semiring", "or_and",
     "--backend", "vpu", "--device", "cpu"],
])
def test_tools_run_main(argv, capsys):
    assert run.main(argv) == 0
    out = capsys.readouterr().out
    assert "Results verified" in out
    assert "not measured" in out  # no device time from a CPU run


def test_tools_run_refuses_without_a_card(capsys, monkeypatch):
    # The default device is the card: with none, the run says why and
    # fails instead of dropping to the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["64", "96", "80"]) != 0
    captured = capsys.readouterr()
    assert "no CUDA device" in captured.err and "--device cpu" in captured.err
    assert "Executing" not in captured.out
