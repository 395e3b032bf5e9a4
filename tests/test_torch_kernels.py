"""Kernels B1 and B3 on the card, each against its plain PyTorch version.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode).  This file imports neither jax nor ``gemm_hls_tpu``, so
it also runs on a machine without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

Tolerances (same inputs on both sides): exact for integer, bool and
tropical results; relative 1e-4 for fp32 sums, which the kernel and the
platform's matmul take in different orders; relative 1e-2 where the output
is rounded to bf16.
"""

import numpy as np
import pytest
import torch

from gemm_hls_tpu_torch import matmul
from gemm_hls_tpu_torch.config import default_config
from gemm_hls_tpu_torch.ops import mxu, vpu
from gemm_hls_tpu_torch.ops.semiring import Semiring, get_semiring
from gemm_hls_tpu_torch.utils import make_operands

pytestmark = pytest.mark.cuda

TROPICAL = ["min_plus", "max_plus", "max_min", "min_max", "max_times"]
SUMS = ["plus_times", "plus_absdiff", "plus_sqdiff", "log_plus"]
LAYOUTS = [(False, False), (True, False), (False, True), (True, True)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(m, n, k, dtype, ta=False, tb=False, device="cpu"):
    draw = "float32" if dtype.is_floating_point else "int32"
    a, b = make_operands(m, n, k, draw, transpose_a=ta, transpose_b=tb)
    return (torch.from_numpy(a).to(device, dtype),
            torch.from_numpy(b).to(device, dtype))


def _agree(got, ref, rtol):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if rtol == 0.0:
        assert torch.equal(got.cpu(), ref.cpu())
    else:
        np.testing.assert_allclose(got.double().cpu().numpy(),
                                   ref.double().cpu().numpy(), rtol=rtol,
                                   atol=0)


@pytest.mark.parametrize("dtype,out,rtol", [
    (torch.bfloat16, torch.float32, 1e-4), (torch.bfloat16, torch.bfloat16, 1e-2),
    (torch.float16, torch.float32, 1e-4), (torch.float32, torch.float32, 1e-4),
    (torch.int8, torch.int32, 0.0), (torch.int32, torch.int32, 0.0)])
@pytest.mark.parametrize("ta,tb", LAYOUTS)
@pytest.mark.parametrize("mnk", [(65, 140, 131), (1, 1, 1), (257, 130, 1000)])
def test_b1_matches_plain(cuda, dtype, out, rtol, ta, tb, mnk):
    a, b = _operands(*mnk, dtype, ta, tb, device=cuda)
    cfg = default_config(dtype, out_dtype=str(out).removeprefix("torch."))
    before = mxu.mxu_matmul.launches
    got = mxu.mxu_matmul(a, b, cfg=cfg, transpose_a=ta, transpose_b=tb)
    assert mxu.mxu_matmul.launches == before + 1
    ref = mxu.mxu_matmul_plain(a, b, cfg=cfg, transpose_a=ta, transpose_b=tb)
    _agree(got, ref, rtol)


def test_b1_k_tail_ignores_nan_past_the_edge(cuda):
    # Operands sliced out of NaN-filled storage: the kernel must zero-fill
    # its K tail, never read past K (0 * NaN would poison the sum).
    base_a = torch.full((70, 96), float("nan"), device=cuda, dtype=torch.bfloat16)
    base_b = torch.full((96, 80), float("nan"), device=cuda, dtype=torch.bfloat16)
    a = base_a[:, :37]
    b = base_b[:37]
    a.fill_(1.0)
    b.fill_(2.0)
    got = mxu.mxu_matmul(a, b, cfg=default_config("bfloat16", out_dtype="float32"))
    assert torch.equal(got, torch.full((70, 80), 74.0, device=cuda))


def test_b1_gradients_match_plain_autograd(cuda):
    for ta, tb in LAYOUTS:
        a, b = _operands(129, 70, 300, torch.float32, ta, tb, device=cuda)
        g = torch.rand(129, 70, device=cuda)
        grads = []
        for backend in (None, "torch"):
            x, y = a.clone().requires_grad_(), b.clone().requires_grad_()
            matmul(x, y, transpose_a=ta, transpose_b=tb,
                   backend=backend).backward(g)
            grads.append((x.grad, y.grad))
        _agree(grads[0][0], grads[1][0], 1e-4)
        _agree(grads[0][1], grads[1][1], 1e-4)


@pytest.mark.parametrize("name,dtype", [
    (name, dtype) for name in TROPICAL + SUMS
    for dtype in (torch.float32, torch.bfloat16, torch.int32)
    if not (name == "log_plus" and dtype == torch.int32)])
@pytest.mark.parametrize("ta,tb", [(False, False), (True, True)])
def test_b3_matches_plain(cuda, name, dtype, ta, tb):
    sr = get_semiring(name)
    cfg = default_config(dtype, semiring=name)
    a, b = _operands(130, 257, 77, dtype, ta, tb, device=cuda)
    before = vpu.vpu_matmul.launches
    got = vpu.vpu_matmul(a, b, cfg=cfg, sr=sr, transpose_a=ta, transpose_b=tb)
    assert vpu.vpu_matmul.launches == before + 1
    ref = vpu.vpu_matmul_plain(a, b, cfg=cfg, sr=sr, transpose_a=ta,
                               transpose_b=tb)
    exact = name in TROPICAL or dtype == torch.int32
    _agree(got, ref, 0.0 if exact else (1e-2 if dtype == torch.bfloat16 else 1e-4))


@pytest.mark.parametrize("name", TROPICAL)
def test_b3_propagates_nan(cuda, name):
    a, b = _operands(40, 50, 60, torch.float32, device=cuda)
    a[3, 10] = float("nan")
    a[5, :] = float("inf")
    b[:, 9] = float("-inf")
    cfg = default_config("float32", semiring=name)
    got = vpu.vpu_matmul(a, b, cfg=cfg, sr=get_semiring(name))
    ref = vpu.vpu_matmul_plain(a, b, cfg=cfg, sr=get_semiring(name))
    assert torch.isnan(got[3]).all()
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    fin = ~torch.isnan(ref)
    assert torch.equal(got[fin], ref[fin])


def test_b3_log_plus_neg_inf_row(cuda):
    a, b = _operands(40, 50, 60, torch.float32, device=cuda)
    a[7, :] = float("-inf")
    got = matmul(a, b, semiring="log_plus")
    assert torch.isneginf(got[7]).all()
    assert torch.isfinite(got[:7]).all()


@pytest.mark.parametrize("backend", [None, "vpu"])
def test_bool_or_and_routes(cuda, backend):
    gen = torch.Generator(device=cuda).manual_seed(1)
    for k in (1, 33, 256, 1000):
        a = torch.rand((50, k), generator=gen, device=cuda) < 0.05
        b = torch.rand((k, 70), generator=gen, device=cuda) < 0.05
        got = matmul(a, b, semiring="or_and", backend=backend)
        ref = matmul(a, b, semiring="or_and", backend="torch")
        assert torch.equal(got, ref)
    ones = torch.ones((2, 256), dtype=torch.bool, device=cuda)
    assert matmul(ones, ones.T, semiring="or_and", backend=backend).all()


@pytest.mark.parametrize("request_", ["float64", "custom", "epilogue", "3d",
                                      "i8x2", "interpret"])
def test_unported_requests_raise(cuda, request_):
    a = torch.ones(8, 8, device=cuda)
    kw = {}
    if request_ == "float64":
        a = a.double()
    elif request_ == "custom":
        kw["semiring"] = Semiring(name="lambda", map_op=torch.add,
                                  reduce_op=torch.minimum, identity=float("inf"),
                                  np_map=np.add, np_reduce=np.minimum)
    elif request_ == "epilogue":
        kw["epilogue"] = lambda acc: acc
    elif request_ == "3d":
        a = a[None]
    elif request_ == "i8x2":
        kw["precision"] = "i8x2"
    else:
        kw["interpret"] = True
    with pytest.raises(NotImplementedError):
        matmul(a, a if request_ != "3d" else a, **kw)
