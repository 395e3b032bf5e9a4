"""Kernels B1 (with and without its epilogue), B2 (plain, epilogue and
row-softmax variants; both tensor-core routes over ``chip_smoke.py``'s
phase-6 route tables), B3 (2-D and batched), B4 and B5 (the integer-slice
GEMMs), the flash kernels (B6-B12, over ``chip_smoke.py``'s phase-13
case tables), the quantized and grouped GEMMs (B13-B16, over its
phase-16 tables; B13 and B14 / B15 on both tensor-core routes, the W8A8
engine bitwise equal to its mma.sync tile) and the grouped GEMM's weight gradient (B17, both
tensor-core routes, over its phase-19 tables), the fused ring and Cannon (B18, B19, over its
phase-22 / 23 tables, ranks living on the card) on the card, each against
its plain PyTorch version; the distributed CA-GEMMs (SUMMA, Cannon, 2.5D,
``distributed_matmul``, the distributed int8 Ozaki GEMM) on virtual ranks
of the card, each rank's local kernel (B1, B3, B5) counted; the
gradients of the batched, epilogue, ``fused_linear``, ``attention``, i8x,
semiring and grouped paths against plain autograd; the i8x tiers, the
Ozaki GEMMs and the graph applications against float64 and
Floyd-Warshall references.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode).  This file imports neither jax nor ``gemm_hls_tpu``, so
it also runs on a machine without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

Tolerances (same inputs on both sides): exact for integer, bool and
tropical results; relative 1e-4 for fp32 sums, which the kernel and the
platform's matmul take in different orders; relative 1e-2 where the output
is rounded to bf16.  Epilogue and softmax outputs of mixed-sign operands can
cancel to near zero, so they are held to the same relative tolerance
scaled by the largest reference magnitude (``_close``).  B4 equals its
plain version exactly; B5's hi + lo is held to 1e-15 of the largest
output; the i8x tiers and Ozaki to the JAX tests' normwise bounds.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from gemm_hls_tpu_torch import attention, fused_linear, matmul
from gemm_hls_tpu_torch.config import ROW_SOFTMAX_MAX_N, default_config
from gemm_hls_tpu_torch.models import graph
from gemm_hls_tpu_torch.ops import mxu, ozaki, slice_kernels, vpu
from gemm_hls_tpu_torch.ops.int8_slices import fp32_matmul_int8
from gemm_hls_tpu_torch.ops.epilogue import get_epilogue
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


@pytest.mark.parametrize("request_", ["float64", "custom", "epilogue",
                                      "interpret", "ozaki_distributed"])
def test_unported_requests_raise(cuda, request_):
    # The i8x tiers and batched tropical gradients, refused until slice 3,
    # run below (test_i8x_tiers_on_the_card, test_semiring_gradients_*).
    a = torch.ones(8, 8, device=cuda)
    kw = {}
    if request_ == "float64":
        # Landed with the wide operand types: float64 runs on the FP64
        # tensor cores (csrc/dmma_gemm.cu), one launch.
        before = mxu.route_launches["dmma", "float64"]
        got = matmul(a.double(), a.double())
        assert mxu.route_launches["dmma", "float64"] - before == 1
        assert got.dtype == torch.float64 and torch.equal(got, torch.full_like(got, 8.0))
        return
    if request_ in ("custom", "epilogue"):
        # Landed with the generated functors (ops/codegen.py): a user
        # semiring runs B3, a callable epilogue B1, each compiled at first
        # use into a library of its own, one generated launch.
        before = (sum(vpu.vpu_matmul.generated_launches.values()),
                  sum(mxu.generated_launches.values()))
        if request_ == "custom":
            got = matmul(a, a, semiring=Semiring(
                name="lambda", map_op=torch.add, reduce_op=torch.minimum,
                identity=float("inf"), np_map=np.add, np_reduce=np.minimum))
            want = torch.full_like(got, 2.0)
        else:
            got = matmul(a, a, epilogue=lambda acc: acc * 0.5 - 1)
            want = torch.full_like(got, 3.0)
        after = (sum(vpu.vpu_matmul.generated_launches.values()),
                 sum(mxu.generated_launches.values()))
        assert after[request_ == "epilogue"] - before[request_ == "epilogue"] == 1
        assert torch.equal(got, want)
        return
    if request_ == "interpret":
        kw["interpret"] = True
    if request_ == "ozaki_distributed":
        # Landed with the distributed CA-GEMM (ROADMAP A7's GEMM half): it
        # now runs on ranks of the card, one B5 launch a rank.
        from gemm_hls_tpu_torch.parallel import make_mesh
        x = np.random.default_rng(0).uniform(-5, 5, (64, 64))
        before = slice_kernels.fused_ozaki_int8.launches
        got = ozaki.ozaki_matmul_int8_distributed(x, x, make_mesh((2, 2), devices=[cuda] * 4))
        assert slice_kernels.fused_ozaki_int8.launches - before == 4
        assert chip_smoke.normwise(torch, torch.from_numpy(got), torch.from_numpy(x),
                                   torch.from_numpy(x))[0] < 1e-13
        return
    with pytest.raises(NotImplementedError, match="ROADMAP|backend='torch'"):
        matmul(a, a, **kw)


# ---- B1's epilogue and B2 --------------------------------------------------

EPILOGUES = ["bias", "bias_relu", "bias_sigmoid", "bias_tanh", "col_scale",
             "scale_bias", "bias_gelu"]
FLOAT_CASES = [(torch.bfloat16, torch.bfloat16, 1e-2),
               (torch.bfloat16, torch.float32, 1e-4),
               (torch.float16, torch.float32, 1e-4),
               (torch.float32, torch.float32, 1e-4)]


def _close(got, ref, rtol):
    """|got - ref| <= rtol * (|ref| + max |ref|), NaN-free, same dtype."""
    assert got.dtype == ref.dtype and got.shape == ref.shape
    g, r = got.double(), ref.double()
    assert torch.isfinite(g).all() and torch.isfinite(r).all()
    bound = rtol * (r.abs() + r.abs().max())
    assert bool(((g - r).abs() <= bound).all()), float((g - r).abs().max())


def _signed(shape, dtype, device, seed):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return (torch.rand(shape, generator=gen) * 2 - 1).to(device, dtype)


def _ep_operands(name, n, device, dtype=torch.float32):
    ep = get_epilogue(name)
    return ep, [_signed((n,), dtype, device, 20 + i) for i in range(ep.n_operands)]


@pytest.mark.parametrize("dtype,out,rtol", FLOAT_CASES)
@pytest.mark.parametrize("ta,tb", LAYOUTS)
@pytest.mark.parametrize("name", EPILOGUES)
def test_b1_epilogue_matches_plain(cuda, dtype, out, rtol, ta, tb, name):
    m, n, k = 65, 140, 131  # N, K not multiples of the tile
    a = _signed((k, m) if ta else (m, k), dtype, cuda, 1)
    b = _signed((n, k) if tb else (k, n), dtype, cuda, 2)
    ep, eps = _ep_operands(name, n, cuda, torch.bfloat16 if dtype == torch.bfloat16
                           else torch.float32)
    cfg = default_config(dtype, out_dtype=str(out).removeprefix("torch."))
    before = mxu.mxu_matmul.epilogue_launches
    got = mxu.mxu_matmul(a, b, *eps, cfg=cfg, transpose_a=ta, transpose_b=tb,
                         epilogue=ep)
    assert mxu.mxu_matmul.epilogue_launches == before + 1
    ref = mxu.mxu_matmul_plain(a, b, *eps, cfg=cfg, transpose_a=ta,
                               transpose_b=tb, epilogue=ep)
    _close(got, ref, rtol)


@pytest.mark.parametrize("dtype,out,name", [
    (dtype, out, name)
    for dtype, out in ((torch.int8, torch.int32), (torch.int8, torch.float32),
                       (torch.int32, torch.float32))
    for name in EPILOGUES
    # sigmoid / tanh / gelu truncated to int32 would flip on a one-ulp difference
    # of values next to an integer: the exact epilogues only for an int32 output.
    if not (out == torch.int32 and name in ("bias_sigmoid", "bias_tanh", "bias_gelu"))])
@pytest.mark.parametrize("ta,tb", LAYOUTS)
def test_b1_epilogue_on_integer_inputs(cuda, dtype, out, name, ta, tb):
    # The int32 accumulator meets the epilogue widened to fp32, as the plain
    # version's int32 + fp32 promotes; the sum itself is exact.
    a, b = _operands(65, 140, 131, dtype, ta, tb, device=cuda)
    ep, eps = _ep_operands(name, 140, cuda)
    eps = [e * 4000 for e in eps]  # the sums are 131..13100: relu clips some
    cfg = default_config(dtype, out_dtype=str(out).removeprefix("torch."))
    got = mxu.mxu_matmul(a, b, *eps, cfg=cfg, transpose_a=ta, transpose_b=tb,
                         epilogue=ep)
    ref = mxu.mxu_matmul_plain(a, b, *eps, cfg=cfg, transpose_a=ta,
                               transpose_b=tb, epilogue=ep)
    if out == torch.int32:
        _agree(got, ref, 0.0)
    else:
        _close(got, ref, 1e-5)


def test_integer_epilogue_takes_fp32_operands(cuda):
    a = torch.ones(8, 8, dtype=torch.int8, device=cuda)
    bias = torch.ones(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="float32 operands"):
        mxu.mxu_matmul(a, a, bias, cfg=default_config("int8", out_dtype="int32"),
                       epilogue=get_epilogue("bias"))


BATCHED = [(7, 33, 65, 17), (3, 130, 257, 77), (1, 1, 1, 1)]


@pytest.mark.parametrize("dtype,out,rtol", FLOAT_CASES + [
    (torch.int8, torch.int32, 0.0)])
@pytest.mark.parametrize("ta,tb", LAYOUTS)
@pytest.mark.parametrize("shape", BATCHED)
def test_b2_matches_plain(cuda, dtype, out, rtol, ta, tb, shape):
    bsz, m, n, k = shape
    a, b = _operands(m, n, k, dtype, ta, tb, device=cuda)
    a = torch.stack([a * (i + 1) for i in range(bsz)]) if dtype != torch.int8 else (
        torch.stack([a] * bsz))
    b = torch.stack([b] * bsz)
    cfg = default_config(dtype, out_dtype=str(out).removeprefix("torch."))
    before = mxu.mxu_matmul_batched.launches
    got = mxu.mxu_matmul_batched(a, b, cfg=cfg, transpose_a=ta, transpose_b=tb)
    assert mxu.mxu_matmul_batched.launches == before + 1
    ref = mxu.mxu_matmul_plain(a, b, cfg=cfg, transpose_a=ta, transpose_b=tb)
    _agree(got, ref, rtol)


@pytest.mark.parametrize("which", ["a", "b"])
@pytest.mark.parametrize("ta,tb", LAYOUTS)
def test_b2_broadcasts_a_2d_operand(cuda, which, ta, tb):
    bsz, m, n, k = 5, 40, 70, 33
    a = _signed((bsz,) + ((k, m) if ta else (m, k)), torch.bfloat16, cuda, 3)
    b = _signed((bsz,) + ((n, k) if tb else (k, n)), torch.bfloat16, cuda, 4)
    if which == "a":
        a = a[0]
    else:
        b = b[0]
    cfg = default_config("bfloat16", out_dtype="float32")
    got = mxu.mxu_matmul_batched(a, b, cfg=cfg, transpose_a=ta, transpose_b=tb)
    ref = mxu.mxu_matmul_plain(a, b, cfg=cfg, transpose_a=ta, transpose_b=tb)
    _close(got, ref, 1e-4)


@pytest.mark.parametrize("name", EPILOGUES)
def test_b2_epilogue_matches_plain(cuda, name):
    bsz, m, n, k = 4, 50, 200, 64
    a = _signed((bsz, m, k), torch.bfloat16, cuda, 5)
    b = _signed((bsz, n, k), torch.bfloat16, cuda, 6)
    ep, eps = _ep_operands(name, n, cuda)
    cfg = default_config("bfloat16", out_dtype="float32")
    got = mxu.mxu_matmul_batched(a, b, *eps, cfg=cfg, transpose_b=True,
                                 epilogue=ep)
    ref = mxu.mxu_matmul_plain(a, b, *eps, cfg=cfg, transpose_b=True,
                               epilogue=ep)
    _close(got, ref, 1e-4)


@pytest.mark.parametrize("dtype,out,rtol", [
    (torch.bfloat16, torch.bfloat16, 1e-2), (torch.bfloat16, torch.float32, 1e-4),
    (torch.float16, torch.float16, 1e-2), (torch.float32, torch.float32, 1e-4)])
@pytest.mark.parametrize("ta,tb", LAYOUTS)
@pytest.mark.parametrize("shape", [(3, 33, 129, 40), (2, 17, ROW_SOFTMAX_MAX_N, 64),
                                   (1, 1, 1, 1)])
def test_b2_row_softmax_matches_plain(cuda, dtype, out, rtol, ta, tb, shape):
    bsz, m, n, k = shape
    a = _signed((bsz,) + ((k, m) if ta else (m, k)), dtype, cuda, 7) * 3
    b = _signed((bsz,) + ((n, k) if tb else (k, n)), dtype, cuda, 8)
    cfg = default_config(dtype, out_dtype=str(out).removeprefix("torch."))
    ep = get_epilogue("softmax")
    before = mxu.mxu_matmul_batched.row_softmax_launches
    got = mxu.mxu_matmul_batched(a, b, cfg=cfg, transpose_a=ta, transpose_b=tb,
                                 epilogue=ep)
    assert mxu.mxu_matmul_batched.row_softmax_launches == before + 1
    ref = mxu.mxu_matmul_plain(a, b, cfg=cfg, transpose_a=ta, transpose_b=tb,
                               epilogue=ep)
    _close(got, ref, rtol)
    assert torch.allclose(got.double().sum(-1), torch.ones((), device=cuda,
                          dtype=torch.float64), rtol=rtol * 4)


def test_b2_row_softmax_refuses_rows_past_its_bound(cuda):
    a = torch.ones(1, 4, 8, device=cuda)
    b = torch.ones(1, ROW_SOFTMAX_MAX_N + 1, 8, device=cuda)
    with pytest.raises(ValueError, match="at most"):
        mxu.mxu_matmul_batched(a, b, cfg=default_config("float32"),
                               transpose_b=True, epilogue=get_epilogue("softmax"))


def test_batch_above_the_grid_limit(cuda):
    # gridDim.z <= 65535: a bigger batch is launched in chunks.
    bsz = 70_000
    a = _signed((bsz, 3, 5), torch.float32, cuda, 9)
    b = _signed((bsz, 5, 4), torch.float32, cuda, 10)
    cfg = default_config("float32")
    _close(mxu.mxu_matmul_batched(a, b, cfg=cfg),
           mxu.mxu_matmul_plain(a, b, cfg=cfg), 1e-5)
    ep = get_epilogue("softmax")
    _close(mxu.mxu_matmul_batched(a, b, cfg=cfg, epilogue=ep),
           mxu.mxu_matmul_plain(a, b, cfg=cfg, epilogue=ep), 1e-5)
    sr = get_semiring("min_plus")
    scfg = default_config("float32", semiring="min_plus")
    assert torch.equal(vpu.vpu_matmul(a, b, cfg=scfg, sr=sr),
                       vpu.vpu_matmul_plain(a, b, cfg=scfg, sr=sr))


def test_wrappers_take_an_empty_batch(cuda):
    # No block is launched and nothing is written for a batch of 0.
    a = torch.ones(0, 3, 5, device=cuda)
    b = torch.ones(0, 5, 4, device=cuda)
    cfg = default_config("float32")
    assert mxu.mxu_matmul_batched(a, b, cfg=cfg).shape == (0, 3, 4)
    assert mxu.mxu_matmul_batched(a, b, cfg=cfg, epilogue=get_epilogue(
        "softmax")).shape == (0, 3, 4)
    scfg = default_config("float32", semiring="min_plus")
    assert vpu.vpu_matmul(a, b, cfg=scfg, sr=get_semiring("min_plus")).shape == (
        0, 3, 4)
    torch.cuda.synchronize()


@pytest.mark.parametrize("name,dtype", [("min_plus", torch.float32),
                                        ("max_plus", torch.int32),
                                        ("log_plus", torch.bfloat16)])
@pytest.mark.parametrize("broadcast", [None, "a", "b"])
def test_b3_batched_matches_plain(cuda, name, dtype, broadcast):
    sr = get_semiring(name)
    cfg = default_config(dtype, semiring=name)
    a, b = _operands(70, 130, 45, dtype, device=cuda)
    a = torch.stack([a, a + 1, a + 2])
    b = torch.stack([b, b, b + 3])
    if broadcast == "a":
        a = a[1]
    elif broadcast == "b":
        b = b[2]
    before = vpu.vpu_matmul.launches
    got = vpu.vpu_matmul(a, b, cfg=cfg, sr=sr)
    assert vpu.vpu_matmul.launches == before + 1
    ref = vpu.vpu_matmul_plain(a, b, cfg=cfg, sr=sr)
    _agree(got, ref, 1e-2 if dtype == torch.bfloat16 else (
        1e-4 if name == "log_plus" else 0.0))


# ---- gradients against plain autograd ---------------------------------------

def _grads(fn, *xs):
    xs = [x.detach().clone().requires_grad_() for x in xs]
    out = fn(*xs)
    g = _signed(out.shape, out.dtype, out.device, 99)
    torch.autograd.backward(out, g)
    return [x.grad for x in xs]


@pytest.mark.parametrize("ta,tb", LAYOUTS)
@pytest.mark.parametrize("broadcast", [None, "a", "b"])
def test_batched_gradients_match_plain_autograd(cuda, ta, tb, broadcast):
    bsz, m, n, k = 3, 70, 90, 50
    a = _signed((bsz,) + ((k, m) if ta else (m, k)), torch.float32, cuda, 11)
    b = _signed((bsz,) + ((n, k) if tb else (k, n)), torch.float32, cuda, 12)
    a = a[0] if broadcast == "a" else a
    b = b[0] if broadcast == "b" else b
    got = _grads(lambda x, y: matmul(x, y, transpose_a=ta, transpose_b=tb), a, b)
    ref = _grads(lambda x, y: matmul(x, y, transpose_a=ta, transpose_b=tb,
                                     backend="torch"), a, b)
    for g, r in zip(got, ref):
        _close(g, r, 1e-4)


@pytest.mark.parametrize("act", ["identity", "relu", "sigmoid", "tanh"])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_fused_linear_gradients_match_plain_autograd(cuda, act, lead):
    x = _signed(lead + (64, 96), torch.float32, cuda, 13)
    w = _signed((96, 130), torch.float32, cuda, 14)
    b = _signed((130,), torch.float32, cuda, 15)
    f = {"identity": lambda p: p, "relu": torch.relu, "sigmoid": torch.sigmoid,
         "tanh": torch.tanh}[act]
    before = mxu.mxu_matmul.epilogue_launches
    got = _grads(lambda *t: fused_linear(*t, act), x, w, b)
    assert mxu.mxu_matmul.epilogue_launches == before + 1
    ref = _grads(lambda x_, w_, b_: f(x_ @ w_ + b_), x, w, b)
    for g, r in zip(got, ref):
        _close(g, r, 1e-4)


def test_epilogue_gradient_via_recompute_matches_plain_autograd(cuda):
    a = _signed((3, 40, 64), torch.float32, cuda, 16)
    b = _signed((3, 64, 130), torch.float32, cuda, 17)
    bias = _signed((130,), torch.float32, cuda, 18)
    got = _grads(lambda x, y, z: matmul(x, y, epilogue="bias_tanh",
                                        epilogue_operands=(z,)), a, b, bias)
    ref = _grads(lambda x, y, z: torch.tanh(x @ y + z), a, b, bias)
    for g, r in zip(got, ref):
        _close(g, r, 1e-4)


@pytest.mark.parametrize("s_k", [96, ROW_SOFTMAX_MAX_N + 128])
def test_attention_and_gradient_match_plain(cuda, s_k):
    q = _signed((4, 64, 32), torch.float32, cuda, 19)
    k = _signed((4, s_k, 32), torch.float32, cuda, 20)
    v = _signed((4, s_k, 32), torch.float32, cuda, 21)

    def plain(q_, k_, v_):
        s = q_ @ k_.transpose(1, 2) / 32 ** 0.5
        return torch.softmax(s, -1) @ v_

    before = mxu.mxu_matmul_batched.row_softmax_launches
    _close(attention(q, k, v), plain(q, k, v), 1e-4)
    fused = mxu.mxu_matmul_batched.row_softmax_launches - before
    assert fused == (1 if s_k <= ROW_SOFTMAX_MAX_N else 0)
    for g, r in zip(_grads(attention, q, k, v), _grads(plain, q, k, v)):
        _close(g, r, 1e-4)


# ---- B4 / B5: the integer-slice kernels (slice 3) --------------------------

SLICE_SHAPES = [(1, 1, 1), (65, 140, 131), (33, 129, 4097)]


def _int8_slices(n, rows, cols, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-127, 128, (n, rows, cols), generator=gen,
                         device=device, dtype=torch.int8)


def _ulp_pair(m, n, device):
    gen = torch.Generator(device=device).manual_seed(9)
    return (torch.exp2(torch.randint(-9, 3, (m, 1), generator=gen, device=device).float()),
            torch.exp2(torch.randint(-9, 3, (1, n), generator=gen, device=device).float()))


@pytest.mark.parametrize("n_slices", [2, 3, 4, 8])
@pytest.mark.parametrize("form", ["stacked", "split", "kmajor"])
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("mnk", SLICE_SHAPES)
def test_b4_equals_plain(cuda, n_slices, form, scaled, mnk):
    # Every int32 diagonal is exact and the fp32 combine runs in the plain
    # version's order, so the kernel's output is bit-identical.  "kmajor":
    # B's slices as views of (N, K) storage, read without a copy.
    m, n, k = mnk
    sa, sb = _int8_slices(n_slices, m, k, cuda, 1), _int8_slices(n_slices, k, n, cuda, 2)
    ulps = _ulp_pair(m, n, cuda) if scaled else ()
    xa, xb = {"stacked": (sa, sb), "split": (tuple(sa), tuple(sb)),
              "kmajor": (tuple(sa), tuple(sb.transpose(1, 2).contiguous().transpose(1, 2)))}[form]
    before = slice_kernels.fused_int8_fp32.launches
    got = slice_kernels.fused_int8_fp32(xa, xb, *ulps)
    assert slice_kernels.fused_int8_fp32.launches == before + 1
    ref = slice_kernels.fused_int8_fp32_plain(list(sa), list(sb), *ulps)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("n_slices", [2, 3, 4, 8])
@pytest.mark.parametrize("extra_diag", [0, 1])
@pytest.mark.parametrize("block_k", [64, 2048])
@pytest.mark.parametrize("mnk", SLICE_SHAPES)
def test_b5_matches_plain(cuda, n_slices, extra_diag, block_k, mnk):
    m, n, k = mnk
    sa, sb = _int8_slices(n_slices, m, k, cuda, 3), _int8_slices(n_slices, k, n, cuda, 4)
    kw = dict(block_k=block_k, n_diags=n_slices + extra_diag)
    before = slice_kernels.fused_ozaki_int8.launches
    hi, lo = slice_kernels.fused_ozaki_int8(tuple(sa), tuple(sb), **kw)
    assert slice_kernels.fused_ozaki_int8.launches == before + 1
    rhi, rlo = slice_kernels.fused_ozaki_int8_plain(list(sa), list(sb), **kw)
    got, ref = hi.double() + lo.double(), rhi.double() + rlo.double()
    assert float((got - ref).abs().max()) <= 1e-15 * max(float(ref.abs().max()), 1.0)


# ---- both routes of B1 and B5 (the wgmma engine and the older tiles) -------
# chip_smoke.py's phase-3a / 6a / 10b tables and runners; each case checks
# the route its launch took.


@pytest.mark.parametrize("case", chip_smoke.B1_ROUTE_CASES + chip_smoke.B1_EPILOGUE_ROUTE_CASES,
                         ids=str)
def test_b1_routes_match_plain(cuda, case):
    chip_smoke.b1_route_case(torch, _gen(231), case)


def test_b1_engine_launches_repeat_bitwise(cuda):
    chip_smoke.b1_repeats(torch, _gen(232))


# B2's routes (chip_smoke.py phase 6): each case on the route it names, and
# every engine case again on WMMA (the route override).
_B2_RUNS = ([(case, None) for case in chip_smoke.B2_ROUTE_CASES]
            + [(case, "wmma") for case in chip_smoke.B2_ROUTE_CASES if case[-1] == "wgmma"])


@pytest.mark.parametrize("case,route", _B2_RUNS, ids=str)
def test_b2_routes_match_plain(cuda, case, route):
    chip_smoke.b2_route_case(torch, _gen(235), case, route)


def test_b2_engine_launches_repeat_bitwise(cuda):
    chip_smoke.b2_repeats(torch, _gen(236))


# B2's row-softmax routes (chip_smoke.py phase 6c): each case on the route
# it names, and every engine case again on row_softmax.cu (the override).
_ROW_SOFTMAX_RUNS = (
    [(case, None) for case in chip_smoke.ROW_SOFTMAX_ROUTE_CASES]
    + [(case, "wmma") for case in chip_smoke.ROW_SOFTMAX_ROUTE_CASES if case[-1] == "wgmma"])


@pytest.mark.parametrize("case,route", _ROW_SOFTMAX_RUNS, ids=str)
def test_b2_row_softmax_routes_match_plain(cuda, case, route):
    chip_smoke.row_softmax_route_case(torch, _gen(239), case, route)


def test_b2_row_softmax_engine_launches_repeat_bitwise(cuda):
    chip_smoke.row_softmax_repeats(torch, _gen(240))


@pytest.mark.parametrize("case", chip_smoke.OZAKI_ROUTE_CASES, ids=str)
def test_b5_routes_match_plain(cuda, case):
    # Every diagonal is exact and the flush order is the plain version's,
    # so hi and lo are bit-identical on either route.
    assert chip_smoke.b5_route_case(torch, _gen(233), case)[1]


def test_b5_engine_launches_repeat_bitwise(cuda):
    chip_smoke.b5_repeats(torch, _gen(234))


@pytest.mark.parametrize("case,route", chip_smoke.DIAG_RUNS, ids=str)
def test_b4_routes_equal_plain(cuda, case, route):
    # Each case on the route it names, every engine case again on mma.sync:
    # the exact diagonals and the plain combine order give the plain bits.
    chip_smoke.diag_route_case(torch, _gen(237), case, route)


def test_b4_engine_launches_repeat_bitwise(cuda):
    chip_smoke.diag_repeats(torch, _gen(238))


@pytest.mark.parametrize("case", ["whole_k", "block_k", "diagonals", "devices"])
def test_slice_kernel_refusals_on_the_card(cuda, case):
    sa, sb = _int8_slices(3, 8, 64, cuda, 5), _int8_slices(3, 64, 16, cuda, 6)
    calls = {
        "whole_k": (lambda: slice_kernels.fused_int8_fp32(
            _int8_slices(3, 8, 44400, cuda, 7), _int8_slices(3, 44400, 16, cuda, 8)),
            ValueError, "whole-K"),
        "block_k": (lambda: slice_kernels.fused_ozaki_int8(sa, sb, block_k=45056),
                    ValueError, "too large"),
        "diagonals": (lambda: slice_kernels.fused_ozaki_int8(
            _int8_slices(9, 8, 64, cuda, 7), _int8_slices(9, 64, 16, cuda, 8),
            n_diags=10), NotImplementedError, "at most"),
        "devices": (lambda: slice_kernels.fused_int8_fp32(sa, sb.cpu()),
                    ValueError, "on"),
    }
    fn, exc, match = calls[case]
    with pytest.raises(exc, match=match):
        fn()


def _normwise(got, a, b):
    a64, b64 = a.double(), b.double()
    scale = torch.outer(a64.norm(dim=1), b64.norm(dim=0))
    return float(((got.double() - a64 @ b64).abs() / scale).max())


@pytest.mark.parametrize("precision,bound", [("i8x2", 3e-4), ("i8x3", 2e-6),
                                             ("i8x4", 2e-7)])
@pytest.mark.parametrize("mnk,route", [((1024, 1000, 1100), "B4"),
                                       ((16, 128, 44000), "B5")])
def test_i8x_tiers_on_the_card(cuda, precision, bound, mnk, route):
    m, n, k = mnk
    gen = torch.Generator(device=cuda).manual_seed(11)
    a = torch.rand((m, k), generator=gen, device=cuda) * 10 - 5
    b = torch.rand((k, n), generator=gen, device=cuda) * 10 - 5
    b4, b5 = (slice_kernels.fused_int8_fp32.launches,
              slice_kernels.fused_ozaki_int8.launches)
    out = matmul(a, b, precision=precision)
    # The whole-K bound depends on the slice count: 2 slices keep B4 at
    # K = 44000.
    b5_route = route == "B5" and precision != "i8x2"
    assert slice_kernels.fused_int8_fp32.launches == b4 + (0 if b5_route else 1)
    assert slice_kernels.fused_ozaki_int8.launches == b5 + (1 if b5_route else 0)
    assert _normwise(out, a, b) < bound


def test_i8x_gradient_on_the_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(12)
    x = (torch.rand((300, 500), generator=gen, device=cuda) * 4 - 2).requires_grad_()
    y = (torch.rand((500, 200), generator=gen, device=cuda) * 4 - 2).requires_grad_()
    g = torch.rand((300, 200), generator=gen, device=cuda) * 2 - 1
    fp32_matmul_int8(x, y, n_slices=3).backward(g)
    assert _normwise(x.grad, g, y.detach().T) < 2e-6
    assert _normwise(y.grad, x.detach().T, g) < 2e-6


@pytest.mark.parametrize("split", ["auto", "host", "device"])
def test_ozaki_int8_on_the_card(cuda, split):
    rng = np.random.default_rng(13)
    a, b = rng.uniform(-5, 5, (300, 700)), rng.uniform(-5, 5, (700, 200))
    before = slice_kernels.fused_ozaki_int8.launches
    got = ozaki.ozaki_matmul_int8(a, b, split=split)
    assert slice_kernels.fused_ozaki_int8.launches == before + 1
    err = _normwise(torch.from_numpy(got), torch.from_numpy(a), torch.from_numpy(b))
    assert err < (1e-12 if split == "device" else 1e-13)


def test_ozaki_auto_split_equals_host_on_the_card(cuda):
    # On CUDA, split="auto" runs the float64 split on the card: the same
    # slices as the host's numpy split, so the same result.
    rng = np.random.default_rng(14)
    a, b = rng.uniform(-5, 5, (64, 300)), rng.uniform(-5, 5, (300, 48))
    assert np.array_equal(ozaki.ozaki_matmul_int8(a, b, split="auto"),
                          ozaki.ozaki_matmul_int8(a, b, split="host"))


def test_ozaki_bf16_on_the_card(cuda):
    rng = np.random.default_rng(15)
    a, b = rng.uniform(-5, 5, (128, 256)), rng.uniform(-5, 5, (256, 96))
    before = mxu.mxu_matmul.launches
    got = ozaki.ozaki_matmul(a, b)  # float64 sums on the card
    assert mxu.mxu_matmul.launches > before
    assert _normwise(torch.from_numpy(got), torch.from_numpy(a),
                     torch.from_numpy(b)) < 1e-15
    # The JAX package's float-float sum: B1's partials are exact and the
    # TwoSums run as separate IEEE ops, so the card equals the CPU bit for bit.
    bits, n = ozaki.slice_plan(256)
    cfg = default_config("bfloat16", out_dtype="float32")
    sums = []
    for dev in (cuda, "cpu"):
        sa = ozaki.device_split_f64(torch.from_numpy(a).to(dev), bits, n, 1)
        sb = ozaki.device_split_f64(torch.from_numpy(b).to(dev), bits, n, 0)
        hi, lo = ozaki.device_accumulate(sa.bfloat16(), sb.bfloat16(), config=cfg)
        sums.append((hi.cpu(), lo.cpu()))
    assert all(torch.equal(x, y) for x, y in zip(*sums))


def _dense_semiring(name, x, y):
    x3, y3 = x[:, :, None], y[None, :, :]
    if name == "log_plus":
        return torch.logsumexp(x3 + y3, dim=1)
    if name == "max_min":
        return torch.minimum(x3, y3).amax(1)
    if name == "min_max":
        return torch.maximum(x3, y3).amin(1)
    return (x3 + y3).amin(1) if name == "min_plus" else (x3 + y3).amax(1)


@pytest.mark.parametrize("name", ["min_plus", "max_plus", "log_plus", "max_min",
                                  "min_max"])
@pytest.mark.parametrize("data", ["continuous", "integer_ties"])
def test_semiring_gradients_match_plain_autograd(cuda, name, data):
    gen = torch.Generator(device=cuda).manual_seed(16)
    if data == "continuous":
        a = torch.rand((130, 257), generator=gen, device=cuda) * 4 - 2
        b = torch.rand((257, 77), generator=gen, device=cuda) * 4 - 2
    else:
        a = torch.randint(0, 5, (130, 257), generator=gen, device=cuda).float()
        b = torch.randint(0, 5, (257, 77), generator=gen, device=cuda).float()
    g = torch.rand((130, 77), generator=gen, device=cuda) * 2 - 1
    got = _grads(lambda x, y: matmul(x, y, semiring=name) * g, a, b)
    ref = _grads(lambda x, y: _dense_semiring(name, x, y) * g, a, b)
    for u, r in zip(got, ref):
        _close(u, r, 1e-5)


@pytest.mark.parametrize("layout", ["3d_x_3d", "3d_x_2d", "2d_x_3d"])
def test_batched_semiring_gradients_on_the_card(cuda, layout):
    gen = torch.Generator(device=cuda).manual_seed(17)
    a = torch.randint(0, 6, (3, 40, 70), generator=gen, device=cuda).float()
    b = torch.randint(0, 6, (3, 70, 50), generator=gen, device=cuda).float()
    a = a[0] if layout == "2d_x_3d" else a
    b = b[0] if layout == "3d_x_2d" else b

    def plain(x, y):
        x3 = x if x.ndim == 3 else x.expand(3, -1, -1)
        y3 = y if y.ndim == 3 else y.expand(3, -1, -1)
        return torch.stack([_dense_semiring("min_plus", u, v) for u, v in zip(x3, y3)])

    for u, r in zip(_grads(lambda x, y: matmul(x, y, semiring="min_plus"), a, b),
                    _grads(plain, a, b)):
        _close(u, r, 1e-5)


def test_graph_applications_on_the_card(cuda):
    n = 300
    gen = torch.Generator(device=cuda).manual_seed(18)
    w = torch.randint(1, 10, (n, n), generator=gen, device=cuda).float()
    keep = torch.rand((n, n), generator=gen, device=cuda) < 4.0 / n
    adj = torch.where(keep, w, float("inf"))
    d = adj.clone()
    d.fill_diagonal_(0.0)
    for k in range(n):
        d = torch.minimum(d, d[:, k:k + 1] + d[k:k + 1, :])
    assert torch.equal(graph.all_pairs_shortest_paths(adj), d)
    assert torch.equal(graph.transitive_closure(keep), torch.isfinite(d))
    cap = torch.where(keep, w, 0.0)
    c = cap.clone()
    c.fill_diagonal_(float("inf"))
    for k in range(n):
        c = torch.maximum(c, torch.minimum(c[:, k:k + 1], c[k:k + 1, :]))
    assert torch.equal(graph.widest_paths(cap), c)
    rank = graph.pagerank(keep.float(), iters=30)
    assert torch.isclose(rank.sum(), torch.tensor(1.0, device=cuda), rtol=1e-5)


# ---- flash attention: flash_fwd, flash_bwd_dq, flash_bwd_dkv --------------
# One case table and one runner per kind of case, shared with
# ``chip_smoke.py``'s phase 13 (its tolerances: relative 1e-2 scaled for
# bf16 / fp16 outputs, 1e-4 for fp32 and lse).


def _flash_id(case):
    dt, bh, bh_kv, s_q, s_kv, d, kw = case
    opts = [k if isinstance(x, list) else f"{k}={x}" for k, x in kw.items()]
    return "-".join([dt, f"{bh}x{bh_kv}", f"{s_q}x{s_kv}", f"d{d}", *opts])


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


@pytest.mark.parametrize("case", chip_smoke.FLASH_CASES,
                         ids=[_flash_id(c) for c in chip_smoke.FLASH_CASES])
def test_flash_kernels_vs_plain(cuda, case):
    chip_smoke.flash_case(torch, _gen(131), case)


@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", range(len(chip_smoke.FLASH_4D)))
def test_flash_attention_4d_layouts(cuda, dt, case):
    chip_smoke.flash_4d_case(torch, _gen(23), chip_smoke.FLASH_4D[case], dt)


@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
def test_flash_offsets_fully_future_shard(cuda, dt):
    chip_smoke.flash_future_shard(torch, _gen(20), dt)


@pytest.mark.parametrize("case", chip_smoke.FLASH_GRAD_CASES)
def test_flash_fp32_gradients_vs_float64(cuda, case):
    chip_smoke.flash_grad_case(torch, _gen(29), case)


@pytest.mark.parametrize("what", chip_smoke.FLASH_REFUSALS)
def test_flash_refuses_what_no_kernel_takes(cuda, what):
    chip_smoke.flash_refusal(torch, what)


@pytest.mark.parametrize("case", chip_smoke.FLASH_ROUTE_CASES, ids=str)
def test_flash_routes_match_plain(cuda, case):
    chip_smoke.flash_route_case(torch, _gen(31), case)


def test_flash_engine_launches_repeat_bitwise(cuda):
    chip_smoke.flash_repeats(torch, _gen(32))


# The backward's routes: each case on the route it names, and every engine
# case again on the mma.sync tile (the route override).
_BWD_RUNS = ([(case, None) for case in chip_smoke.FLASH_BWD_ROUTE_CASES]
             + [(case, "mma.sync") for case in chip_smoke.FLASH_BWD_ROUTE_CASES
                if case[-1] == "wgmma"])


@pytest.mark.parametrize("case,route", _BWD_RUNS, ids=str)
def test_flash_bwd_routes_match_plain(cuda, case, route):
    chip_smoke.flash_bwd_route_case(torch, _gen(33), case, route)


def test_flash_bwd_engine_launches_repeat_bitwise(cuda):
    chip_smoke.flash_bwd_repeats(torch, _gen(34))


# ---- slice 5: dequant (B13), W8A8 (B14 / B15), grouped (B16) ---------------
# chip_smoke.py's phase-16 case tables, one runner each (its tolerances:
# relative 1e-4 scaled for fp32 outputs, 1e-2 for bf16 / fp16; the W8A8
# int8 activations and B16's zero tail exactly).


@pytest.mark.parametrize("case", chip_smoke.DEQUANT_CASES, ids=str)
def test_dequant_kernel_vs_plain(cuda, case):
    chip_smoke.dequant_case(torch, _gen(37), case)


@pytest.mark.parametrize("case,route", chip_smoke.DEQUANT_RUNS, ids=str)
def test_dequant_routes_match_plain(cuda, case, route):
    chip_smoke.dequant_route_case(torch, _gen(38), case, route)


def test_dequant_engine_launches_repeat_bitwise(cuda):
    chip_smoke.dequant_repeats(torch, _gen(39))


@pytest.mark.parametrize("case", chip_smoke.W8A8_CASES, ids=str)
def test_w8a8_kernels_vs_plain(cuda, case):
    chip_smoke.w8a8_case(torch, _gen(41), case)


# B14 / B15's routes: each case on the route it names (the engine's cases
# again on mma.sync inside the runner, bitwise equal).
@pytest.mark.parametrize("case", chip_smoke.W8A8_ROUTE_CASES, ids=str)
def test_w8a8_routes_match_plain(cuda, case):
    chip_smoke.w8a8_route_case(torch, _gen(42), case)


def test_w8a8_engine_launches_repeat_bitwise(cuda):
    chip_smoke.w8a8_repeats(torch, _gen(46))


@pytest.mark.parametrize("case", chip_smoke.GROUPED_CASES, ids=str)
def test_grouped_kernel_vs_plain(cuda, case):
    chip_smoke.grouped_case(torch, _gen(43), case)


@pytest.mark.parametrize("case", chip_smoke.GROUPED_ROUTE_CASES, ids=str)
def test_grouped_routes_match_plain(cuda, case):
    chip_smoke.grouped_route_case(torch, _gen(44), case)


def test_grouped_engine_launches_repeat_bitwise(cuda):
    chip_smoke.grouped_repeats(torch, _gen(45))


def test_moe_forward_has_no_host_sync(cuda):
    # The routing never reaches the host: a sync under this mode raises.
    from gemm_hls_tpu_torch.models import moe
    cfg = moe.MoEConfig(d_model=64, d_ff=128, num_experts=8, top_k=2,
                        dtype="bfloat16")
    params = moe.init_moe_params(_gen(47), cfg)
    x = torch.randn((100, 64), generator=_gen(48), device=cuda).to(torch.bfloat16)
    ref = moe.moe_forward({k: v.cpu() for k, v in params.items()}, x.cpu(), cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = moe.moe_forward(params, x, cfg)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _close(y.float().cpu(), ref.float(), 2e-2)


# ---- slice 6: the grouped GEMM's weight gradient (B17) ---------------------
# chip_smoke.py's phase-19 tables and runners (phase 16's tolerances; the
# empty groups' blocks exactly zero).


@pytest.mark.parametrize("case", chip_smoke.GROUPED_UPDATE_CASES, ids=str)
def test_grouped_update_kernel_vs_plain(cuda, case):
    chip_smoke.grouped_update_case(torch, _gen(59), case)


def test_grouped_update_launches_repeat_bitwise(cuda):
    chip_smoke.grouped_update_repeats(torch, _gen(61))


# B17's routes (phase 19): each case on the route it names, and every
# engine case again on mma.sync (the route override).
_B17_RUNS = ([(case, None) for case in chip_smoke.GROUPED_UPDATE_ROUTE_CASES]
             + [(case, "mma.sync") for case in chip_smoke.GROUPED_UPDATE_ROUTE_CASES
                if case[-1] == "wgmma"])


@pytest.mark.parametrize("case,route", _B17_RUNS, ids=str)
def test_grouped_update_routes_match_plain(cuda, case, route):
    chip_smoke.grouped_update_route_case(torch, _gen(62), case, route)


def test_grouped_update_engine_launches_repeat_bitwise(cuda):
    chip_smoke.grouped_update_route_repeats(torch, _gen(63))


@pytest.mark.parametrize("case", chip_smoke.GROUPED_GRAD_CASES, ids=str)
def test_grouped_matmul_gradients_vs_plain_autograd(cuda, case):
    chip_smoke.grouped_grad_case(torch, _gen(67), case)


def test_moe_train_step_has_no_host_sync(cuda):
    # The backward reads no routing on the host either; one step against
    # the same step on CPU copies (the plain versions).
    from gemm_hls_tpu_torch.models import moe
    cfg = moe.MoEConfig(d_model=64, d_ff=128, num_experts=8, top_k=2,
                        dtype="bfloat16")
    params = moe.init_moe_params(_gen(71), cfg)
    x = torch.randn((100, 64), generator=_gen(72), device=cuda).to(torch.bfloat16)
    y = torch.randn((100, 64), generator=_gen(73), device=cuda).to(torch.bfloat16)
    want, wloss = moe.moe_train_step({k: v.cpu() for k, v in params.items()},
                                     (x.cpu(), y.cpu()), cfg, lr=1.0, aux_weight=0.01)
    lr = torch.tensor(1.0, device=cuda)  # the copy to the card syncs: made before
    new, loss = chip_smoke.no_sync(torch, lambda: moe.moe_train_step(
        params, (x, y), cfg, lr=lr, aux_weight=0.01))
    assert abs(float(loss) - float(wloss)) <= 1e-2 * abs(float(wloss))
    for k in want:
        _close(new[k].float().cpu(), want[k].float(), 2e-2)


@pytest.mark.parametrize("which", ["dequant", "w8a8"])
def test_quantized_weights_at_an_odd_address(cuda, which):
    # Weights viewed one byte into a buffer: the kernels' vector loads need
    # aligned rows, so the wrapper copies such a view once.
    from gemm_hls_tpu_torch import matmul_quantized, matmul_w8a8, quantize_weights
    from gemm_hls_tpu_torch.ops import dequant
    w = torch.randn((256, 128), generator=_gen(53), device=cuda)
    wq, s = (torch.from_numpy(a).to(cuda) for a in quantize_weights(w.cpu().numpy()))
    odd = torch.empty(wq.numel() + 1, dtype=torch.int8, device=cuda)[1:].view(wq.shape)
    odd.copy_(wq)
    x = torch.randn((64, 256), generator=_gen(54), device=cuda).to(torch.bfloat16)
    if which == "dequant":
        got = matmul_quantized(x, odd, s)
        ref = dequant.dequant_matmul_plain(x, wq, s)
    else:
        got = matmul_w8a8(x, odd, s)
        ref = matmul_w8a8(x, wq, s)
    torch.cuda.synchronize()
    _close(got.float(), ref.float(), 1e-2)


# ---- the fused distributed GEMMs: ring_gemm (B18), cannon_gemm (B19) -------
# chip_smoke.py's phase-22 / 23 tables and runners (exact for int8, phase
# 16's tolerances otherwise), ranks living on the one card.


@pytest.mark.parametrize("case", chip_smoke.RING_CASES, ids=str)
def test_ring_kernel_vs_plain(cuda, case):
    chip_smoke.ring_case(torch, _gen(221), case)


def test_ring_kernel_launches_repeat_bitwise(cuda):
    chip_smoke.ring_repeats(torch, _gen(222))


@pytest.mark.parametrize("case", chip_smoke.CANNON_CASES, ids=str)
def test_cannon_kernel_vs_plain(cuda, case):
    chip_smoke.cannon_case(torch, _gen(223), case)


def test_ring_matmul_front_door_on_the_card(cuda):
    # Four ranks on the card through the front door, against the plain
    # schedule on CPU copies.
    from gemm_hls_tpu_torch.parallel import make_mesh, ring_matmul
    a, b = _operands(96, 160, 192, torch.bfloat16, device=cuda)
    got = ring_matmul(a, b, make_mesh((4,), ("x",), devices=[cuda] * 4))
    want = ring_matmul(a.cpu(), b.cpu(), make_mesh((4,), ("x",), devices=["cpu"] * 4))
    _agree(torch.cat(got).cpu(), torch.cat(want), 1e-4)


# ---- slice 16: the host-staged GEMM (B1, B3, B5 per panel) -----------------

def _host_operands(m, n, k, dtype, seed=5):
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand((m, k), generator=gen).to(dtype),
            torch.rand((k, n), generator=gen).to(dtype))


@pytest.mark.parametrize("dtype,semiring", [(torch.bfloat16, "plus_times"),
                                            (torch.float32, "plus_times"),
                                            (torch.float32, "min_plus")])
def test_staged_prefetch_equals_sync_on_the_engine(cuda, dtype, semiring):
    from gemm_hls_tpu_torch.parallel import streamed_matmul
    a, b = _host_operands(1000, 704, 1504, dtype)
    kw = dict(semiring=semiring, tile_m=384, tile_n=256, tile_k=512, out_dtype=torch.float32)
    got = streamed_matmul(a, b, **kw)
    stats = streamed_matmul.last_stats
    assert stats["prefetch"] and stats["slots"] == 3 and stats["jobs"] == 3 * 3 * 3
    sync = streamed_matmul(a, b, prefetch=False, **kw)
    assert streamed_matmul.last_stats["slots"] == 1
    assert torch.equal(got, sync)
    if semiring == "plus_times" and dtype == torch.bfloat16:
        # The ragged panels' rows (480 of K, 192 of N) are whole 16-byte
        # units, so every panel takes the engine.
        assert stats["routes"] == ["wgmma"] * stats["jobs"]
    ref = matmul(a.to(cuda), b.to(cuda), semiring=semiring, out_dtype=torch.float32,
                 backend="torch").cpu()
    _agree(got, ref, 0.0 if semiring == "min_plus" else 1e-4)


def test_staged_ring_reuse_under_small_depth(cuda, monkeypatch):
    # depth 1: two pinned slots for 100 jobs, each refilled only after the
    # GEMM that read it; host bytes equal the panels' bytes.
    from gemm_hls_tpu_torch.parallel import staging, streamed_matmul
    monkeypatch.setattr(staging, "PREFETCH_DEPTH", 1)
    a, b = _host_operands(512, 640, 1280, torch.bfloat16, seed=7)
    got = streamed_matmul(a, b, tile_m=128, tile_n=128, tile_k=256)
    stats = streamed_matmul.last_stats
    assert stats["slots"] == 2 and stats["jobs"] == 4 * 5 * 5
    assert stats["h2d_bytes"] == (512 * 1280 * 5 + 1280 * 640 * 4) * 2
    assert stats["d2h_bytes"] == 512 * 640 * 2
    assert torch.equal(got, streamed_matmul(a, b, tile_m=128, tile_n=128, tile_k=256,
                                            prefetch=False))
    _agree(got.float(), (a.float() @ b.float()).to(torch.bfloat16).float(), 1e-2)


def test_staged_files_on_the_native_tileio(cuda, tmp_path):
    from gemm_hls_tpu_torch.parallel import streamed_matmul, streamed_matmul_files
    from gemm_hls_tpu_torch.utils.tileio import MatrixFile, native_tileio_available
    assert native_tileio_available()
    a, b = _host_operands(300, 260, 700, torch.float32, seed=9)
    with MatrixFile(tmp_path / "a.bin", 300, 700, np.float32, create=True) as fa, \
         MatrixFile(tmp_path / "b.bin", 700, 260, np.float32, create=True) as fb, \
         MatrixFile(tmp_path / "c.bin", 300, 260, np.float32, create=True) as fc:
        assert fa.native and fb.native and fc.native
        fa.write_tile(0, 0, a.numpy())
        fb.write_tile(0, 0, b.numpy())
        streamed_matmul_files(fa, fb, fc, tile_m=128, tile_n=128, tile_k=256)
        got = torch.from_numpy(fc.read_tile(0, 300, 0, 260))
    assert torch.equal(got, streamed_matmul(a, b, tile_m=128, tile_n=128, tile_k=256))


def test_staged_ozaki_on_the_card(cuda):
    from gemm_hls_tpu_torch.parallel.staging import streamed_ozaki_matmul
    rng = np.random.default_rng(11)
    a = rng.uniform(-5, 5, (300, 700))
    b = rng.uniform(-5, 5, (700, 260))
    slice_kernels.fused_ozaki_int8.launches = 0
    got = streamed_ozaki_matmul(a, b, tile_m=128, tile_n=128, tile_k=256)
    assert slice_kernels.fused_ozaki_int8.launches == 3 * 3 * 3
    normw = np.abs(got - a @ b) / (np.linalg.norm(a, axis=1)[:, None]
                                   * np.linalg.norm(b, axis=0)[None, :])
    assert normw.max() < 1e-13


# ---- slice 17: the front door's engine config, named routes, the tuner -----

@pytest.fixture(autouse=True)
def _no_autotune_cache(monkeypatch, tmp_path):
    """Every card test here holds the route rule: no user cache and no
    packaged seed (the tuner's own tests name their caches)."""
    from gemm_hls_tpu_torch.tools import autotune
    monkeypatch.setattr(autotune, "DEFAULT_CACHE", str(tmp_path / "absent.json"))
    monkeypatch.setattr(autotune, "SEED_CACHE", str(tmp_path / "absent.json"))


def test_engine_config_runs_on_the_engine(cuda):
    from gemm_hls_tpu_torch.config import route_config
    a, b = (torch.randn(1024, 1024, device=cuda).bfloat16() for _ in range(2))
    got = matmul(a, b, config=route_config("bfloat16"))
    assert mxu.mxu_matmul.last_route == "wgmma"
    ref = torch.matmul(a, b)
    assert float((got.float() - ref.float()).norm() / ref.float().norm()) <= 1e-3
    pitched = torch.randn(1024, 1025, device=cuda).bfloat16()[:, :1024]
    with pytest.raises(ValueError, match="cannot run"):
        matmul(pitched, b, config=route_config("bfloat16"))
    # The WMMA tile keeps the route rule: the engine for aligned operands,
    # WMMA for the pitched ones.
    matmul(a, b, config=default_config("bfloat16"))
    assert mxu.mxu_matmul.last_route == "wgmma"
    matmul(pitched, b, config=default_config("bfloat16"))
    assert mxu.mxu_matmul.last_route == "wmma"


def test_named_engine_route_raises_where_the_rule_refuses(cuda):
    from gemm_hls_tpu_torch.ops import flash
    q = torch.randn(2, 128, 80, device=cuda).bfloat16()  # no engine at D 80
    with pytest.raises(ValueError, match="cannot run"):
        flash.flash_mha(q, q, q, route="wgmma")
    a8 = torch.randint(-3, 4, (256, 256), device=cuda, dtype=torch.int8)
    cfg = default_config("int8", out_dtype="int32")
    with pytest.raises(ValueError, match="cannot run"):
        mxu.mxu_matmul(a8, a8, cfg=cfg, route="wgmma")  # int8 B not K-major


def test_tuned_batched_route_is_adopted(cuda, tmp_path, monkeypatch):
    from gemm_hls_tpu_torch.tools import autotune
    cache = str(tmp_path / "tuned.json")
    win = autotune.autotune_batched(8, 256, 256, 256, cache_path=cache, rounds=2)
    report = autotune.autotune_batched.last_report
    assert {r["entry"]["route"] for r in report} == {"wgmma", "wmma"}
    assert all(r["status"] == "ok" and len(r["samples_ms"]) == 2 for r in report)
    monkeypatch.setattr(autotune, "DEFAULT_CACHE", cache)
    a, b = (torch.randn(8, 256, 256, device=cuda).bfloat16() for _ in range(2))
    got = matmul(a, b)
    assert mxu.mxu_matmul_batched.last_route == win
    assert torch.allclose(got.float(), torch.matmul(a, b).float(), rtol=1e-2, atol=1e-1)


# ---- the distributed CA-GEMMs on virtual ranks of the card ------------------

def _mesh_of(cuda, shape, names=("x", "y")):
    from gemm_hls_tpu_torch.parallel import make_mesh, mesh_25d
    if len(shape) == 3:
        return mesh_25d(c=shape[0], devices=[cuda] * int(np.prod(shape)))
    return make_mesh(shape, names, devices=[cuda] * int(np.prod(shape)))


def _launches():
    return {"B1": mxu.mxu_matmul.launches, "B3": vpu.vpu_matmul.launches,
            "B5": slice_kernels.fused_ozaki_int8.launches}


def _launched(before):
    return {k: v - before[k] for k, v in _launches().items() if v - before[k]}


@pytest.mark.parametrize("ta,tb", LAYOUTS)
def test_summa_bf16_on_ranks_of_the_card(cuda, ta, tb):
    from gemm_hls_tpu_torch.parallel import summa_matmul
    mesh = _mesh_of(cuda, (2, 4))
    a, b = _operands(256, 512, 512, torch.bfloat16, ta, tb, device=cuda)
    before = _launches()
    c = summa_matmul(a, b, mesh, transpose_a=ta, transpose_b=tb, out_dtype=torch.float32)
    assert _launched(before) == {"B1": 8}
    assert summa_matmul.last_routes and all(
        r == ["wgmma"] for r in summa_matmul.last_routes.values())
    ref = torch.matmul((a.T if ta else a).float(), (b.T if tb else b).float())
    _agree(c.full(), ref, 1e-4)


@pytest.mark.parametrize("semiring,dtype", [("plus_times", torch.bfloat16),
                                            ("min_plus", torch.float32)])
def test_cannon_on_ranks_of_the_card(cuda, semiring, dtype):
    from gemm_hls_tpu_torch.parallel import cannon_matmul
    mesh = _mesh_of(cuda, (2, 2))
    a, b = _operands(256, 256, 512, dtype, device=cuda)
    before = _launches()
    c = cannon_matmul(a, b, mesh, semiring=semiring)
    assert _launched(before) == {"B1" if semiring == "plus_times" else "B3": 8}
    ref = matmul(a.cpu(), b.cpu(), semiring=semiring, out_dtype=torch.float32).to(dtype)
    _agree(c.full(), ref.to(cuda), 1e-2 if dtype == torch.bfloat16 else 0.0)


@pytest.mark.parametrize("semiring,dtype", [("plus_times", torch.bfloat16),
                                            ("max_plus", torch.float32)])
def test_matmul_25d_on_ranks_of_the_card(cuda, semiring, dtype):
    from gemm_hls_tpu_torch.parallel import matmul_25d
    mesh = _mesh_of(cuda, (2, 2, 2))
    a, b = _operands(256, 256, 512, dtype, device=cuda)
    before = _launches()
    c = matmul_25d(a, b, mesh, semiring=semiring, out_dtype=torch.float32)
    assert _launched(before) == {"B1" if semiring == "plus_times" else "B3": 8}
    ref = matmul(a.cpu().float(), b.cpu().float(), semiring=semiring)
    _agree(c.full(), ref.to(cuda), 1e-4 if semiring == "plus_times" else 0.0)


def test_distributed_matmul_unaligned_on_ranks_of_the_card(cuda):
    from gemm_hls_tpu_torch.parallel import distributed_matmul
    mesh = _mesh_of(cuda, (2, 4))
    a, b = _operands(257, 255, 253, torch.float32, ta=True, device=cuda)
    before = _launches()
    c = distributed_matmul(a, b, mesh, semiring="min_plus", transpose_a=True)
    assert _launched(before) == {"B3": 8}
    assert c.shape == (257, 255) and tuple(c.spec) == ()
    ref = matmul(a.cpu(), b.cpu(), semiring="min_plus", transpose_a=True)
    _agree(c.full(), ref.to(cuda), 0.0)


def test_ozaki_int8_distributed_on_ranks_of_the_card(cuda):
    mesh = _mesh_of(cuda, (2, 2))
    rng = np.random.default_rng(13)
    a, b = rng.uniform(-5, 5, (300, 520)), rng.uniform(-5, 5, (520, 260))
    before = _launches()
    got = ozaki.ozaki_matmul_int8_distributed(a, b, mesh)
    assert _launched(before) == {"B5": 4}
    assert chip_smoke.normwise(torch, torch.from_numpy(got), torch.from_numpy(a),
                               torch.from_numpy(b))[0] < 1e-13


# ---- slice 20: ring attention, the sharded MLP, MoE EP and the pipeline on
# virtual ranks of the card, each against its single-card call (normwise:
# chip_smoke.PAR_FWD_TOL for attention outputs, PAR_BF16_TOL for gradients
# and bf16 steps).

def _ranks(cuda, shape, names):
    from gemm_hls_tpu_torch.parallel import make_mesh
    return make_mesh(shape, names, devices=[cuda] * int(np.prod(shape)))


@pytest.mark.parametrize("zigzag", [False, True])
def test_ring_attention_on_ranks_of_the_card(cuda, zigzag):
    from gemm_hls_tpu_torch.ops import flash
    from gemm_hls_tpu_torch.parallel import ring_flash_attention
    mesh = _ranks(cuda, (4,), ("x",))
    gen = _gen(41)
    q, k, v, do = (chip_smoke.signed(torch, (4, 1024, 64), torch.bfloat16, gen) for _ in range(4))
    xs = [t.requires_grad_() for t in (q, k, v)]
    before = flash.flash_mha.launches
    o = ring_flash_attention(*xs, mesh, causal=True, zigzag=zigzag).full()
    fwd = chip_smoke.ring_launches(4, 256, True, zigzag)
    assert flash.flash_mha.launches - before == fwd
    assert flash.flash_mha.last_route == "wgmma"
    grads = torch.autograd.grad(o, xs, do)
    sc = torch.tensor(64 ** -0.5, dtype=torch.bfloat16, device=cuda)
    ref = flash.flash_mha_diff(xs[0] * sc, xs[1], xs[2], causal=True)
    want = torch.autograd.grad(ref, xs, do)
    assert chip_smoke.rel_norm(o, ref) < chip_smoke.PAR_FWD_TOL
    for g, w in zip(grads, want):
        assert chip_smoke.rel_norm(g, w) < chip_smoke.PAR_BF16_TOL


def test_ring_decode_on_ranks_of_the_card(cuda):
    from gemm_hls_tpu_torch.ops import flash
    from gemm_hls_tpu_torch.parallel import ring_decode_attention
    mesh = _ranks(cuda, (4,), ("x",))
    gen = _gen(42)
    q = chip_smoke.signed(torch, (16, 4, 128), torch.bfloat16, gen)
    k, v = (chip_smoke.signed(torch, (4, 1024, 128), torch.bfloat16, gen) for _ in range(2))
    lens = torch.tensor([4, 300, 700, 1024], dtype=torch.int32, device=cuda)
    o = ring_decode_attention(q, k, v, lens, mesh, window=500).full()
    assert flash.flash_mha.last_route == "mma.sync"
    sc = torch.tensor(128 ** -0.5, dtype=torch.bfloat16, device=cuda)
    ref = flash.flash_mha(q * sc, k, v, kv_lengths=lens, causal=True, window=500)
    assert chip_smoke.rel_norm(o, ref) < chip_smoke.PAR_FWD_TOL


def test_sharded_mlp_step_on_ranks_of_the_card(cuda):
    from gemm_hls_tpu_torch.models import mlp
    mesh = _ranks(cuda, (2, 4), ("dp", "tp"))
    gen = _gen(43)
    params = mlp.init_params(gen, (256, 512, 256), torch.bfloat16)
    batch = mlp.make_batch(gen, 128, 256, 256, torch.bfloat16)
    got, loss = mlp.train_step(mlp.shard_params(params, mesh), batch, lr=0.1)
    want, wloss = mlp.train_step(params, batch, lr=0.1)
    assert abs(float(loss) - float(wloss)) <= 1e-2 * abs(float(wloss))
    for (w, b), (ww, wb) in zip(got, want):
        assert chip_smoke.rel_norm(w.full(), ww) < chip_smoke.PAR_BF16_TOL
        assert chip_smoke.rel_norm(b.full(), wb) < chip_smoke.PAR_BF16_TOL


@pytest.mark.parametrize("form", ["psum", "a2a"])
def test_moe_expert_parallel_on_ranks_of_the_card(cuda, form):
    from gemm_hls_tpu_torch.models.moe import (
        MoEConfig, init_moe_params, moe_forward, moe_forward_ep, moe_forward_ep_a2a,
    )
    cfg = MoEConfig(d_model=256, d_ff=512, num_experts=8, top_k=2, dtype="bfloat16")
    gen = _gen(44)
    params = init_moe_params(gen, cfg)
    x = chip_smoke.signed(torch, (512, 256), torch.bfloat16, gen)
    if form == "psum":
        got = moe_forward_ep(params, x, cfg, _ranks(cuda, (2, 4), ("dp", "ep")))
    else:
        got = moe_forward_ep_a2a(params, x, cfg, _ranks(cuda, (4,), ("ep",)),
                                 capacity_factor=4.0)
    want = moe_forward(params, x, cfg)
    logits = (x.double() @ params["router"].double()).sort(-1, descending=True)[0]
    keep = (logits[:, 1] - logits[:, 2]) > 1e-3  # rows whose routing cannot flip
    assert chip_smoke.rel_norm(got.full()[keep], want[keep]) < chip_smoke.PAR_BF16_TOL


def test_pipeline_on_ranks_of_the_card(cuda):
    from gemm_hls_tpu_torch.parallel import (
        init_pipeline_params, pipeline_forward, shard_pipeline_params, stages_forward,
    )
    mesh = _ranks(cuda, (2,), ("pp",))
    params = init_pipeline_params(_gen(45), 2, 256, 512, torch.bfloat16)
    x = chip_smoke.signed(torch, (256, 256), torch.bfloat16, _gen(46))
    before = _launches()
    got = pipeline_forward(shard_pipeline_params(params, mesh), x, mesh, microbatches=4).full()
    assert _launched(before) == {"B1": 2 * 2 * 4}
    assert chip_smoke.rel_norm(got, stages_forward(params, x)) < chip_smoke.PAR_BF16_TOL


# ---- slice 21: the wide operand types (chip_smoke.py phase 30) ------------
# Every wide type on B1 / B2 (float64 on csrc/dmma_gemm.cu, int16 and the
# unsigned ints on csrc/mxu_simt_int.cu, int8's extremes on its tensor-core
# routes) and on B3 (every semiring of each type's csrc/semiring_*.cu),
# each against its plain version on the card, the route checked.

@pytest.mark.parametrize("case", chip_smoke.WIDE_B1_CASES, ids=str)
def test_wide_b1_b2_cases_match_plain(cuda, case):
    chip_smoke.wide_b1_case(torch, _gen(2101), case)


@pytest.mark.parametrize("case", chip_smoke.WIDE_B3_CASES, ids=str)
def test_wide_b3_cases_match_plain(cuda, case):
    chip_smoke.wide_b3_case(torch, _gen(2102), case)


@pytest.mark.parametrize("ta,tb", LAYOUTS)
def test_float64_matmul_matches_the_numpy_oracle(cuda, ta, tb):
    # The front door on dmma against numpy's float64 product (rtol 1e-9,
    # scaled by the largest output: mixed-sign sums).
    rng = np.random.default_rng(2103)
    a, b = rng.uniform(-1, 1, (777, 1025)), rng.uniform(-1, 1, (1025, 513))
    x = torch.from_numpy(a.T.copy() if ta else a).to(cuda)
    y = torch.from_numpy(b.T.copy() if tb else b).to(cuda)
    got = matmul(x, y, transpose_a=ta, transpose_b=tb)
    assert mxu.mxu_matmul.last_route == "dmma"
    want = a @ b
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-9,
                               atol=1e-9 * np.abs(want).max())


def test_float64_gradient_on_dmma_matches_plain_autograd(cuda):
    gen = _gen(2104)
    a = chip_smoke.signed(torch, (300, 520), torch.float64, gen).requires_grad_()
    b = chip_smoke.signed(torch, (520, 136), torch.float64, gen).requires_grad_()
    g = chip_smoke.signed(torch, (300, 136), torch.float64, gen)
    before = mxu.route_launches["dmma", "float64"]
    matmul(a, b).backward(g)
    assert mxu.route_launches["dmma", "float64"] - before == 3
    ap, bp = a.detach().clone().requires_grad_(), b.detach().clone().requires_grad_()
    torch.matmul(ap, bp).backward(g)
    for got, want in ((a.grad, ap.grad), (b.grad, bp.grad)):
        chip_smoke.compare(torch, got, want, 1e-9, "float64 gradient", scaled=True)


@pytest.mark.parametrize("dtype", ["float16", "float64"])
def test_tropical_subgradients_of_the_new_floats_on_b3(cuda, dtype):
    gen = _gen(2105)
    dt = getattr(torch, dtype)
    a = chip_smoke.signed(torch, (64, 48), dt, gen).requires_grad_()
    b = chip_smoke.signed(torch, (48, 40), dt, gen).requires_grad_()
    before = vpu.vpu_matmul.dtype_launches[dtype]
    out = matmul(a, b, semiring="min_plus")
    assert vpu.vpu_matmul.dtype_launches[dtype] - before == 1
    out.float().sum().backward()
    ac, bc = a.detach().cpu().requires_grad_(), b.detach().cpu().requires_grad_()
    matmul(ac, bc, semiring="min_plus").float().sum().backward()
    assert torch.equal(out.cpu(), matmul(ac.detach(), bc.detach(), semiring="min_plus"))
    # The fp32 routing sums of the backward run in another order on the card
    # (float16 gradients then round to 2^-11).
    rtol = 1e-5 if dtype == "float64" else chip_smoke.BF16_RTOL
    for got, want in ((a.grad, ac.grad), (b.grad, bc.grad)):
        chip_smoke.compare(torch, got.cpu(), want, rtol, f"{dtype} subgradient", scaled=True)


def test_int64_plus_times_raises_on_the_card(cuda):
    a = torch.ones((4, 5), dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError, match="int64 plus_times"):
        matmul(a, a.T.contiguous())
    with pytest.raises(TypeError, match="int64 plus_times"):
        mxu.mxu_matmul(a, a, cfg=default_config(torch.int64), transpose_b=True)


# ---- slice 22: user semirings and callable epilogues (generated functors) --

@pytest.mark.parametrize("case", chip_smoke.GEN_B3_CASES, ids=str)
def test_generated_b3_cases_match_plain(cuda, case):
    chip_smoke.gen_b3_case(torch, _gen(2201), case)


@pytest.mark.parametrize("case", chip_smoke.GEN_EPILOGUE_CASES, ids=str)
def test_generated_epilogue_cases_match_plain(cuda, case):
    chip_smoke.gen_epilogue_case(torch, _gen(2202), case)


def test_generated_user_max_plus_is_the_builtin_bit_for_bit(cuda):
    gen = _gen(2203)
    a = chip_smoke.wide_operand(torch, gen, 300, 257, torch.float32, "edge")
    b = chip_smoke.wide_operand(torch, gen, 257, 130, torch.float32, "edge")
    got = matmul(a, b, semiring=chip_smoke.user_semirings()["user_max_plus"])
    assert torch.equal(got.isnan(), matmul(a, b, semiring="max_plus").isnan())
    ok = ~got.isnan()
    assert torch.equal(got[ok], matmul(a, b, semiring="max_plus")[ok])


def test_generated_epilogue_gradient_matches_plain_autograd(cuda):
    gen = _gen(2204)
    silu = chip_smoke.user_epilogues()["silu_bias"][0]
    xs = [chip_smoke.signed(torch, s, torch.float32, gen) for s in ((130, 67), (67, 200), (200,))]
    got = [t.clone().requires_grad_() for t in xs]
    ref = [t.clone().requires_grad_() for t in xs]
    cot = chip_smoke.signed(torch, (130, 200), torch.float32, gen)
    before = sum(mxu.generated_launches.values())
    matmul(got[0], got[1], epilogue=silu, epilogue_operands=(got[2],)).backward(cot)
    assert sum(mxu.generated_launches.values()) - before == 1
    torch.nn.functional.silu(torch.matmul(ref[0], ref[1]) + ref[2]).backward(cot)
    for g_, w_ in zip(got, ref):
        chip_smoke.compare(torch, g_.grad, w_.grad, 1e-4, "callable gradient", scaled=True)


def test_untranslatable_callable_raises_on_the_card(cuda):
    a = torch.ones(8, 8, device=cuda)
    with pytest.raises(NotImplementedError, match="'amax'.*ROADMAP B coverage item 5"):
        matmul(a, a, epilogue=lambda acc: acc - acc.amax(-1, keepdim=True))
    with pytest.raises(NotImplementedError, match="yields bool"):
        matmul(a, a, semiring=Semiring("cmp", lambda x, y: x > y, torch.add, 0, None, None))


# ---- slice 23: float64 at the card's FP64 rates (the float64 tiles) --------

@pytest.mark.parametrize("case", chip_smoke.DMMA_TMA_CASES, ids=str)
def test_dmma_tma_cases_match_plain(cuda, case):
    chip_smoke.wide_b1_case(torch, _gen(2301), case)


@pytest.mark.parametrize("case", chip_smoke.F64_GATE_CASES, ids=str)
def test_b3_float64_gate_cases_match_plain_on_their_form(cuda, case):
    chip_smoke.f64_gate_case(torch, _gen(2302), case)


@pytest.mark.parametrize("ta,tb", LAYOUTS)
def test_float64_tiles_agree_on_aligned_operands(cuda, ta, tb):
    gen = _gen(2303)
    a = chip_smoke.signed(torch, (136, 300) if ta else (300, 136), torch.float64, gen)
    b = chip_smoke.signed(torch, (520, 136) if tb else (136, 520), torch.float64, gen)
    cfg = default_config(torch.float64)
    kw = dict(cfg=cfg, transpose_a=ta, transpose_b=tb)
    got = mxu.mxu_matmul(a, b, **kw)
    assert mxu.mxu_matmul.last_dmma_tile == "tma"
    old = mxu.mxu_matmul(a, b, _dmma_tile="cp_async", **kw)
    assert mxu.mxu_matmul.last_dmma_tile == "cp_async"
    chip_smoke.compare(torch, got, old, 1e-9, "TMA tile vs cp.async tile", scaled=True)
    # A view one element into A's rows: its base is off the 16-byte grid.
    a_off = a[:, 1:]
    b_off = b if ta else (b[:, 1:] if tb else b[1:])
    with pytest.raises(ValueError, match="'tma' float64 tile cannot take"):
        mxu.mxu_matmul(a_off, b_off, _dmma_tile="tma", **kw)


def test_dmma_tma_launches_repeat_bitwise(cuda):
    chip_smoke.dmma_tma_repeats(torch, _gen(2304))


def test_float64_apsp_runs_the_num_form_exactly(cuda):
    gen = _gen(2305)
    adj = chip_smoke.apsp_adjacency(torch, gen, 700, torch.float64)
    vpu.f64_slice_forms(reset=True)
    dist = graph.all_pairs_shortest_paths(adj)
    fast, slow = vpu.f64_slice_forms(reset=True)
    assert fast > 0 and slow == 0
    cfg = default_config(torch.float64, semiring="min_plus")
    want = graph.all_pairs_shortest_paths(adj, matmul_fn=lambda x, y: vpu.vpu_matmul_plain(
        x, y, cfg=cfg, sr=get_semiring("min_plus")))
    assert torch.equal(dist, want)


def test_float64_callable_epilogue_runs_on_the_tile_the_rule_picks(cuda):
    gen = _gen(2306)
    relu = chip_smoke.user_epilogues()["relu_bias"][0]
    for m, k, tile in ((256, 320, "tma"), (255, 321, "cp_async")):
        a = chip_smoke.signed(torch, (m, k), torch.float64, gen)
        b = chip_smoke.signed(torch, (k, 384), torch.float64, gen)
        bias = chip_smoke.signed(torch, (384,), torch.float64, gen)
        before = mxu.generated_launches["dmma", "float64"]
        got = matmul(a, b, epilogue=relu, epilogue_operands=(bias,))
        assert mxu.generated_launches["dmma", "float64"] == before + 1
        assert mxu.mxu_matmul.last_dmma_tile == tile
        want = matmul(a, b, epilogue="bias_relu", epilogue_operands=(bias,))
        assert torch.equal(got, want)
