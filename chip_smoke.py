#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``gemm_hls_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printed as it ends:
  1. device check: a CUDA device is required (there is no CPU path);
  2. build every kernel from ``gemm_hls_tpu_torch/csrc`` with nvcc (sm_90a,
     one nvcc per source, all at once);
  3. kernel B1 (dense plus_times) against its plain PyTorch version on the
     card: bf16, fp16, fp32, int8 -> int32 and int32, four layouts, odd,
     unaligned and 1024-class shapes, bool or_and, autograd gradients;
  4. kernel B3 (semiring GEMM) against its plain version: every built-in
     semiring, f32 / bf16 / int32, unaligned shapes up to 2048, NaN and
     +-inf inputs, all -inf rows for log_plus;
  5. slice 1's main path at full size through ``tools.run``: bf16 8192^3
     and fp32 min_plus 4096^3, each checked against the plain version on
     the card and timed beside it, then host-oracle verification at 1024^3;
  6. kernel B1 with each epilogue, B2 (plain, per-column epilogue and
     row-softmax variants) and batched B3 against their plain versions:
     dtypes, four layouts, odd shapes, N not a multiple of 128, a 2-D
     operand broadcast over the batch, a batch above gridDim.z's 65535;
  7. gradients of the batched, epilogue and fused_linear paths against
     plain autograd;
  8. slice 2's main path at full width, launch counts set to 0 before it
     and read after: the MLP trainer (``models.mlp.train_step``, 5 steps,
     fused and unfused) at dims (4096, 16384, 4096) with 8192 bf16 tokens
     and at (1024, 4096, 1024) with 2048 fp32 tokens, each held step by
     step against a plain PyTorch trainer, plus a checkpoint round trip;
     ``attention`` at (32, 1024, 128) bf16 (fused row softmax) and at
     (8, 8192, 128) (rows past the fused bound: the unfused branch), its
     gradient at (8, 512, 64); batched ``matmul`` calls (four layouts,
     int8, fp32, broadcast, 4-D, min_plus);
  9. times of B1's epilogue, B2 and B2's row softmax beside their plain
     versions at the main path's shapes, and of phase 8's batched calls
     beside the torch call that computes the same (not counted as
     launches).

Tolerances (kernel vs plain version on the same inputs, on the card):
  exact for integer, bool and tropical results (min/max of identically
  rounded terms); relative 1e-4 for outputs summed in fp32 (both sum in
  fp32 in different orders over K <= 2048: about sqrt(K) * 2^-24 per
  element); relative 1e-2 where the output is rounded to bf16 (one bf16
  ulp is 2^-8 relative).  Outputs of mixed-sign operands (epilogues,
  softmax, attention, gradients) can cancel to near zero, so there the
  relative error is taken against |ref| + max|ref| ("scaled").  The
  trainers' losses: relative 1e-2 per step in bf16, 1e-3 in fp32.  The
  plain fp32 matmul runs without TF32.

Any mismatch or exception ends the run with a non-zero exit.  The last
three lines are the card's name and power limit, one JSON line on the
kernels, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

F32_RTOL = 1e-4
BF16_RTOL = 1e-2
LAYOUTS = [(False, False), (True, False), (False, True), (True, True)]
EPILOGUES = ["bias", "bias_relu", "bias_sigmoid", "bias_tanh", "col_scale",
             "scale_bias"]


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return proc.stdout.strip().splitlines()[0]


def compare(torch, got, ref, rtol: float, what: str, scaled: bool = False):
    """Max abs and rel error of ``got`` against ``ref``; NaN and +-inf must
    sit at the same places.  ``scaled``: relative to |ref| + max|ref|.
    Raises on a mismatch."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{what}: {got.shape}/{got.dtype} vs "
                             f"{ref.shape}/{ref.dtype}")
    if not got.is_floating_point():
        bad = int((got != ref).sum())
        if bad:
            raise AssertionError(f"{what}: {bad} elements differ (exact)")
        return 0.0, 0.0
    g, r = got.double(), ref.double()
    nan_r = torch.isnan(r)
    if not torch.equal(torch.isnan(g), nan_r):
        raise AssertionError(f"{what}: NaN positions differ")
    inf_r = torch.isinf(r)
    if not torch.equal(g[inf_r], r[inf_r]) or bool(torch.isinf(g[~inf_r]).any()):
        raise AssertionError(f"{what}: inf positions differ")
    fin = ~(nan_r | inf_r)
    if not bool(fin.any()):
        return 0.0, 0.0
    diff = (g[fin] - r[fin]).abs()
    scale = r[fin].abs() + (r[fin].abs().max() if scaled else 0.0)
    rel = diff / scale.clamp_min(1e-30)
    max_abs, max_rel = float(diff.max()), float(rel.max())
    if max_rel > rtol:
        raise AssertionError(f"{what}: max rel err {max_rel:.3e} > {rtol:g} "
                             f"(max abs {max_abs:.3e})")
    return max_abs, max_rel


def operands(torch, m, n, k, dtype, ta=False, tb=False, seed=5):
    """Seeded U(1,10) operands (int8: U{1..3} so int32 counts stay small)."""
    from gemm_hls_tpu_torch.utils.verify import make_operands
    hi = 3.0 if dtype == torch.int8 else 10.0
    draw = "int32" if not dtype.is_floating_point else "float32"
    a, b = make_operands(m, n, k, draw, seed=seed, high=hi,
                         transpose_a=ta, transpose_b=tb)
    return (torch.from_numpy(a).to("cuda", dtype),
            torch.from_numpy(b).to("cuda", dtype))


def phase_b1(torch):
    from gemm_hls_tpu_torch import matmul
    from gemm_hls_tpu_torch.config import default_config, dtype_name
    from gemm_hls_tpu_torch.ops import mxu

    shapes = [(65, 140, 131), (1, 1, 1), (7, 13, 5), (33, 129, 130),
              (1024, 1024, 1024), (1000, 1030, 1100)]
    cases = [(torch.bfloat16, torch.bfloat16, BF16_RTOL),
             (torch.bfloat16, torch.float32, F32_RTOL),
             (torch.float16, torch.float32, F32_RTOL),
             (torch.float32, torch.float32, F32_RTOL),
             (torch.int8, torch.int32, 0.0),
             (torch.int32, torch.int32, 0.0)]
    worst = 0.0
    for dt, out_dt, rtol in cases:
        for ta in (False, True):
            for tb in (False, True):
                for m, n, k in shapes:
                    cfg = default_config(dt, out_dtype=dtype_name(out_dt))
                    a, b = operands(torch, m, n, k, dt, ta, tb)
                    got = mxu.mxu_matmul(a, b, cfg=cfg, transpose_a=ta,
                                         transpose_b=tb)
                    ref = mxu.mxu_matmul_plain(a, b, cfg=cfg, transpose_a=ta,
                                               transpose_b=tb)
                    torch.cuda.synchronize()
                    _, rel = compare(torch, got, ref, rtol,
                                     f"B1 {dt}->{out_dt} ta={ta} tb={tb} "
                                     f"{(m, n, k)}")
                    worst = max(worst, rel)
    log(f"phase 3a: B1 vs plain, {len(cases) * 4 * len(shapes)} cases: ok "
        f"(worst rel err {worst:.3e})")

    # Bool or_and through B1 (int8 -> int32 counts): a sparse case, and an
    # all-true K=256 one whose count is a multiple of 256.
    gen = torch.Generator(device="cuda").manual_seed(7)
    for ta in (False, True):
        for tb in (False, True):
            m, n, k = 300, 257, 1025
            a = torch.rand((k, m) if ta else (m, k), generator=gen,
                           device="cuda") < 0.01
            b = torch.rand((n, k) if tb else (k, n), generator=gen,
                           device="cuda") < 0.01
            got = matmul(a, b, semiring="or_and", transpose_a=ta,
                         transpose_b=tb)
            ref = matmul(a, b, semiring="or_and", transpose_a=ta,
                         transpose_b=tb, backend="torch")
            compare(torch, got, ref, 0.0, f"or_and ta={ta} tb={tb}")
    ones = torch.ones((4, 256), dtype=torch.bool, device="cuda")
    got = matmul(ones, ones.T.contiguous(), semiring="or_and")
    if not bool(got.all()):
        raise AssertionError("or_and: all-true K=256 gave False")
    log("phase 3b: bool or_and via B1 vs plain, 4 layouts + K=256 count: ok")

    # Gradients: the backward is B1 again with flipped transpose flags.
    m, n, k = 1024, 1536, 2048
    for dt, rtol in ((torch.float32, F32_RTOL), (torch.bfloat16, BF16_RTOL)):
        for ta in (False, True):
            for tb in (False, True):
                a, b = operands(torch, m, n, k, dt, ta, tb, seed=11)
                g = operands(torch, m, n, 1, dt, seed=12)[1].expand(m, n) * 0.5
                grads = []
                for backend in (None, "torch"):
                    x = a.clone().requires_grad_()
                    y = b.clone().requires_grad_()
                    out = matmul(x, y, transpose_a=ta, transpose_b=tb,
                                 backend=backend)
                    out.backward(g)
                    grads.append((x.grad, y.grad))
                torch.cuda.synchronize()
                for name, got, ref in (("dA", grads[0][0], grads[1][0]),
                                       ("dB", grads[0][1], grads[1][1])):
                    compare(torch, got, ref, rtol,
                            f"grad {name} {dt} ta={ta} tb={tb}")
    log(f"phase 3c: B1 gradients vs plain autograd at {m}x{n}x{k}, "
        f"f32 + bf16, 4 layouts: ok")


def phase_b3(torch):
    from gemm_hls_tpu_torch import matmul
    from gemm_hls_tpu_torch.config import default_config
    from gemm_hls_tpu_torch.ops import vpu
    from gemm_hls_tpu_torch.ops.semiring import available_semirings, get_semiring

    exact = {"min_plus", "max_plus", "max_min", "min_max", "max_times"}
    shapes = [(65, 140, 131), (7, 13, 5), (1000, 1030, 1100),
              (2048, 2047, 2049)]
    n_cases = 0
    for name in available_semirings():
        if name == "or_and":
            continue
        sr = get_semiring(name)
        dts = [torch.float32, torch.bfloat16]
        if name != "log_plus":
            dts.append(torch.int32)
        for dt in dts:
            for (m, n, k), (ta, tb) in zip(shapes, [(False, False), (True, False),
                                                    (False, True), (True, True)]):
                cfg = default_config(dt, semiring=name)
                a, b = operands(torch, m, n, k, dt, ta, tb, seed=3)
                got = vpu.vpu_matmul(a, b, cfg=cfg, sr=sr, transpose_a=ta,
                                     transpose_b=tb)
                ref = vpu.vpu_matmul_plain(a, b, cfg=cfg, sr=sr,
                                           transpose_a=ta, transpose_b=tb)
                torch.cuda.synchronize()
                rtol = 0.0 if (name in exact or dt == torch.int32) else (
                    BF16_RTOL if dt == torch.bfloat16 else F32_RTOL)
                compare(torch, got, ref, rtol,
                        f"B3 {name} {dt} ta={ta} tb={tb} {(m, n, k)}")
                n_cases += 1
    log(f"phase 4a: B3 vs plain, {n_cases} semiring/dtype/shape cases: ok")

    # NaN and +-inf inputs: min/max semirings must propagate NaN (fminf
    # would drop it) and treat infinities exactly.
    m, n, k = 300, 257, 333
    for name in sorted(exact):
        sr = get_semiring(name)
        cfg = default_config(torch.float32, semiring=name)
        a, b = operands(torch, m, n, k, torch.float32, seed=4)
        a[3, 10] = float("nan")
        b[20, 7] = float("nan")
        a[5, :] = float("inf")
        b[:, 9] = float("-inf")
        a[100, 50] = float("-inf")
        got = vpu.vpu_matmul(a, b, cfg=cfg, sr=sr)
        ref = vpu.vpu_matmul_plain(a, b, cfg=cfg, sr=sr)
        compare(torch, got, ref, 0.0, f"B3 {name} NaN/inf")
    # log_plus: an all -inf row gives -inf (logaddexp(-inf, -inf) = -inf).
    sr = get_semiring("log_plus")
    cfg = default_config(torch.float32, semiring="log_plus")
    a, b = operands(torch, m, n, k, torch.float32, seed=6)
    a[7, :] = float("-inf")
    got = vpu.vpu_matmul(a, b, cfg=cfg, sr=sr)
    ref = vpu.vpu_matmul_plain(a, b, cfg=cfg, sr=sr)
    compare(torch, got, ref, F32_RTOL, "B3 log_plus -inf row")
    if not bool(torch.isneginf(got[7]).all()):
        raise AssertionError("log_plus: all -inf row is not -inf")
    # Bool or_and bit-packed on B3 (backend="vpu").
    gen = torch.Generator(device="cuda").manual_seed(9)
    for k in (1, 31, 33, 257, 2049):
        a = torch.rand((129, k), generator=gen, device="cuda") < 0.05
        b = torch.rand((k, 200), generator=gen, device="cuda") < 0.05
        got = matmul(a, b, semiring="or_and", backend="vpu")
        ref = matmul(a, b, semiring="or_and", backend="torch")
        compare(torch, got, ref, 0.0, f"B3 or_and bits K={k}")
    log("phase 4b: B3 NaN/+-inf, log_plus -inf rows, bit-packed or_and: ok")


def phase_main(torch):
    from gemm_hls_tpu_torch.ops import mxu, vpu
    from gemm_hls_tpu_torch.tools import run

    runs = {
        "B1": ["8192", "8192", "8192", "--dtype", "bfloat16", "--verify",
               "off", "--baseline", "--iters", "20"],
        "B3": ["4096", "4096", "4096", "--dtype", "float32", "--semiring",
               "min_plus", "--verify", "off", "--baseline", "--iters", "5"],
    }
    mxu.mxu_matmul.launches = 0
    vpu.vpu_matmul.launches = 0
    results = {key: run.run(argv) for key, argv in runs.items()}
    launches = {"B1": mxu.mxu_matmul.launches, "B3": vpu.vpu_matmul.launches}
    log(f"phase 5a: main-path launch counts {launches}")
    for key, res in results.items():
        rtol = BF16_RTOL if key == "B1" else 0.0
        max_abs, max_rel = compare(torch, res["out"], res["plain_out"], rtol,
                                   f"main path {key} vs plain")
        if not res["ok"]:
            raise AssertionError(f"main path {key}: tools.run reported failure")
        out = res["out"]
        if not bool(torch.isfinite(out.float()).all()) or out.shape != (
                res["m"], res["n"]):
            raise AssertionError(f"main path {key}: bad output")
        res["max_abs_err"], res["max_rel_err"] = max_abs, max_rel
        log(f"phase 5b: {key} {res['m']}x{res['n']}x{res['k']} {res['dtype']} "
            f"{res['semiring']}: {res['seconds'] * 1e3:.3f} ms "
            f"({res['gops']:.1f} GOp/s) vs plain "
            f"{res['plain_seconds'] * 1e3:.3f} ms ({res['plain_gops']:.1f} "
            f"GOp/s); max abs err {max_abs:.3e}, max rel {max_rel:.3e}")
    for key, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {key} was not launched on the main path")

    for argv in (["1024", "1024", "1024", "--dtype", "bfloat16"],
                 ["1024", "1024", "1024", "--dtype", "float32", "--semiring",
                  "min_plus"]):
        if run.main(argv + ["--iters", "3"]) != 0:
            raise AssertionError(f"tools.run {' '.join(argv)}: verification failed")
    log("phase 5c: tools.run host-oracle verification at 1024^3 (bf16, "
        "min_plus): ok")
    return results, launches


def signed(torch, shape, dtype, gen):
    """Seeded U(-1, 1) on the card, in ``dtype``."""
    return (torch.rand(shape, generator=gen, device="cuda") * 2 - 1).to(dtype)


def counters():
    from gemm_hls_tpu_torch.ops import mxu, vpu
    return {"B1": mxu.mxu_matmul.launches,
            "B1 epilogue": mxu.mxu_matmul.epilogue_launches,
            "B2": mxu.mxu_matmul_batched.launches,
            "B2 row-softmax": mxu.mxu_matmul_batched.row_softmax_launches,
            "B3": vpu.vpu_matmul.launches}


def reset_counters():
    from gemm_hls_tpu_torch.ops import mxu, vpu
    mxu.mxu_matmul.launches = mxu.mxu_matmul.epilogue_launches = 0
    mxu.mxu_matmul_batched.launches = 0
    mxu.mxu_matmul_batched.row_softmax_launches = 0
    vpu.vpu_matmul.launches = 0


def phase_b2(torch):
    from gemm_hls_tpu_torch.config import ROW_SOFTMAX_MAX_N, default_config, dtype_name
    from gemm_hls_tpu_torch.ops import mxu, vpu
    from gemm_hls_tpu_torch.ops.epilogue import get_epilogue
    from gemm_hls_tpu_torch.ops.semiring import get_semiring

    gen = torch.Generator(device="cuda").manual_seed(21)
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    float_cases = [(bf16, bf16, BF16_RTOL), (bf16, f32, F32_RTOL),
                   (f16, f32, F32_RTOL), (f32, f32, F32_RTOL)]

    def cfg_of(dt, out):
        return default_config(dt, out_dtype=dtype_name(out))

    def operand(bsz, rows, cols, t, dt):
        shape = (cols, rows) if t else (rows, cols)
        return signed(torch, (bsz,) + shape if bsz else shape, dt, gen)

    n_cases = 0
    for dt, out, rtol in float_cases:
        for ta, tb in LAYOUTS:
            for name in EPILOGUES:
                ep = get_epilogue(name)
                for m, n, k in ((65, 140, 131), (1000, 1030, 1100)):
                    a, b = operand(0, m, k, ta, dt), operand(0, k, n, tb, dt)
                    eps = [signed(torch, (n,), bf16 if dt == bf16 else f32, gen)
                           for _ in range(ep.n_operands)]
                    kw = dict(cfg=cfg_of(dt, out), transpose_a=ta,
                              transpose_b=tb, epilogue=ep)
                    got = mxu.mxu_matmul(a, b, *eps, **kw)
                    ref = mxu.mxu_matmul_plain(a, b, *eps, **kw)
                    compare(torch, got, ref, rtol, f"B1 {name} {dt}->{out} "
                            f"ta={ta} tb={tb} {(m, n, k)}", scaled=True)
                    n_cases += 1
    # Integer inputs: the exact int32 accumulator widened to fp32 for the
    # epilogue.  An int32 output of sigmoid / tanh would flip on a one-ulp
    # difference next to 1, so it takes the exact epilogues only.
    m, n, k = 1000, 1030, 1100
    for dt, out in ((torch.int8, torch.int32), (torch.int8, f32), (torch.int32, f32)):
        for ta, tb in LAYOUTS:
            for name in EPILOGUES:
                if out == torch.int32 and name in ("bias_sigmoid", "bias_tanh"):
                    continue
                ep = get_epilogue(name)
                a, b = (torch.randint(-3, 4, shape, generator=gen, device="cuda").to(dt)
                        for shape in ((k, m) if ta else (m, k), (n, k) if tb else (k, n)))
                eps = [signed(torch, (n,), f32, gen) * 20 for _ in range(ep.n_operands)]
                kw = dict(cfg=cfg_of(dt, out), transpose_a=ta, transpose_b=tb,
                          epilogue=ep)
                compare(torch, mxu.mxu_matmul(a, b, *eps, **kw),
                        mxu.mxu_matmul_plain(a, b, *eps, **kw),
                        0.0 if out == torch.int32 else F32_RTOL,
                        f"B1 {name} {dt}->{out} ta={ta} tb={tb}", scaled=True)
                n_cases += 1
    log(f"phase 6a: B1 with each epilogue vs plain, {n_cases} cases "
        f"(float and integer inputs): ok")

    n_cases = 0
    shapes = [(7, 33, 65, 17), (3, 130, 257, 77), (2, 1000, 1030, 1100)]
    for dt, out, rtol in float_cases + [(torch.int8, torch.int32, 0.0)]:
        for ta, tb in LAYOUTS:
            for bsz, m, n, k in shapes:
                for bcast in (None, "a", "b"):
                    if dt == torch.int8:
                        a = torch.randint(-3, 4, (bsz,) + ((k, m) if ta else (m, k)),
                                          generator=gen, device="cuda").to(dt)
                        b = torch.randint(-3, 4, (bsz,) + ((n, k) if tb else (k, n)),
                                          generator=gen, device="cuda").to(dt)
                    else:
                        a, b = operand(bsz, m, k, ta, dt), operand(bsz, k, n, tb, dt)
                    a = a[0] if bcast == "a" else a
                    b = b[0] if bcast == "b" else b
                    kw = dict(cfg=cfg_of(dt, out), transpose_a=ta, transpose_b=tb)
                    got = mxu.mxu_matmul_batched(a, b, **kw)
                    ref = mxu.mxu_matmul_plain(a, b, **kw)
                    compare(torch, got, ref, rtol, f"B2 {dt}->{out} ta={ta} "
                            f"tb={tb} {(bsz, m, n, k)} broadcast={bcast}",
                            scaled=True)
                    n_cases += 1
    for name in EPILOGUES:
        ep = get_epilogue(name)
        a, b = operand(5, 300, 200, False, bf16), operand(5, 200, 1030, True, bf16)
        eps = [signed(torch, (1030,), f32, gen) for _ in range(ep.n_operands)]
        kw = dict(cfg=cfg_of(bf16, bf16), transpose_b=True, epilogue=ep)
        compare(torch, mxu.mxu_matmul_batched(a, b, *eps, **kw),
                mxu.mxu_matmul_plain(a, b, *eps, **kw), BF16_RTOL,
                f"B2 {name}", scaled=True)
        n_cases += 1
    log(f"phase 6b: B2 (plain + per-column epilogue) vs plain, {n_cases} "
        f"cases: ok")

    n_cases = 0
    softmax = get_epilogue("softmax")
    for dt, out, rtol in [(bf16, bf16, BF16_RTOL), (bf16, f32, F32_RTOL),
                          (f16, f16, BF16_RTOL), (f32, f32, F32_RTOL)]:
        for ta, tb in LAYOUTS:
            for bsz, m, n, k in ((3, 33, 129, 40), (2, 17, ROW_SOFTMAX_MAX_N, 64),
                                 (4, 1024, 1024, 128)):
                a = operand(bsz, m, k, ta, dt) * 4
                b = operand(bsz, k, n, tb, dt)
                kw = dict(cfg=cfg_of(dt, out), transpose_a=ta, transpose_b=tb,
                          epilogue=softmax)
                got = mxu.mxu_matmul_batched(a, b, **kw)
                compare(torch, got, mxu.mxu_matmul_plain(a, b, **kw), rtol,
                        f"B2 row-softmax {dt}->{out} ta={ta} tb={tb} "
                        f"{(bsz, m, n, k)}", scaled=True)
                n_cases += 1
    log(f"phase 6c: B2 row-softmax vs plain, {n_cases} cases (N up to "
        f"{ROW_SOFTMAX_MAX_N}): ok")

    bsz = 70_000  # above gridDim.z's 65535: launched in two chunks
    a = signed(torch, (bsz, 3, 5), f32, gen)
    b = signed(torch, (bsz, 5, 4), f32, gen)
    cfg = default_config(f32)
    compare(torch, mxu.mxu_matmul_batched(a, b, cfg=cfg),
            mxu.mxu_matmul_plain(a, b, cfg=cfg), F32_RTOL, "B2 batch 70000",
            scaled=True)
    compare(torch, mxu.mxu_matmul_batched(a, b, cfg=cfg, epilogue=softmax),
            mxu.mxu_matmul_plain(a, b, cfg=cfg, epilogue=softmax), F32_RTOL,
            "B2 row-softmax batch 70000", scaled=True)
    for name in ("min_plus", "log_plus"):
        sr, scfg = get_semiring(name), default_config(f32, semiring=name)
        compare(torch, vpu.vpu_matmul(a, b, cfg=scfg, sr=sr),
                vpu.vpu_matmul_plain(a, b, cfg=scfg, sr=sr),
                0.0 if name == "min_plus" else F32_RTOL, f"B3 {name} batch 70000",
                scaled=True)
    log("phase 6d: batch 70000 at 3x4x5 (B2, B2 row-softmax, B3): ok")

    n_cases = 0
    for name in ("min_plus", "max_plus", "max_min", "plus_absdiff", "log_plus"):
        for dt in (f32, bf16, torch.int32):
            if name == "log_plus" and dt == torch.int32:
                continue
            sr, scfg = get_semiring(name), default_config(dt, semiring=name)
            for bcast in (None, "a", "b"):
                a, b = operands(torch, 130, 257, 77, dt, seed=31)
                a = torch.stack([a, a + 1, a + 2])
                b = torch.stack([b, b + 3, b])
                a = a[1] if bcast == "a" else a
                b = b[2] if bcast == "b" else b
                got = vpu.vpu_matmul(a, b, cfg=scfg, sr=sr)
                exact = name in ("min_plus", "max_plus", "max_min") or dt == torch.int32
                compare(torch, got, vpu.vpu_matmul_plain(a, b, cfg=scfg, sr=sr),
                        0.0 if exact else (BF16_RTOL if dt == bf16 else F32_RTOL),
                        f"B3 batched {name} {dt} broadcast={bcast}", scaled=True)
                n_cases += 1
    log(f"phase 6e: batched B3 vs plain, {n_cases} cases: ok")


def grads(torch, fn, xs, gen):
    """Gradients of <fn(*xs), G> for a seeded cotangent G."""
    xs = [x.detach().clone().requires_grad_() for x in xs]
    out = fn(*xs)
    g = signed(torch, out.shape, out.dtype, gen)
    torch.autograd.backward(out, g)
    return [x.grad for x in xs]


def phase_grads(torch):
    from gemm_hls_tpu_torch import fused_linear, matmul

    f32 = torch.float32
    n_cases = 0
    for ta, tb in LAYOUTS:
        for bcast in (None, "a", "b"):
            gen = torch.Generator(device="cuda").manual_seed(41)
            a = signed(torch, (3,) + ((150, 200) if ta else (200, 150)), f32, gen)
            b = signed(torch, (3,) + ((300, 150) if tb else (150, 300)), f32, gen)
            a = a[0] if bcast == "a" else a
            b = b[0] if bcast == "b" else b
            got = grads(torch, lambda x, y: matmul(x, y, transpose_a=ta,
                                                   transpose_b=tb), (a, b),
                        torch.Generator(device="cuda").manual_seed(4))
            ref = grads(torch, lambda x, y: matmul(x, y, transpose_a=ta,
                                                   transpose_b=tb, backend="torch"),
                        (a, b), torch.Generator(device="cuda").manual_seed(4))
            for name, g, r in zip("ab", got, ref):
                compare(torch, g, r, F32_RTOL, f"batched grad d{name} ta={ta} "
                        f"tb={tb} broadcast={bcast}", scaled=True)
            n_cases += 1
    acts = {"identity": lambda p: p, "relu": torch.relu, "sigmoid": torch.sigmoid,
            "tanh": torch.tanh}
    for act, f in acts.items():
        for lead in ((), (3,)):
            gen = torch.Generator(device="cuda").manual_seed(43)
            x = signed(torch, lead + (256, 384), f32, gen)
            w = signed(torch, (384, 1030), f32, gen)
            b = signed(torch, (1030,), f32, gen)
            got = grads(torch, lambda *t: fused_linear(*t, act), (x, w, b),
                        torch.Generator(device="cuda").manual_seed(5))
            ref = grads(torch, lambda x_, w_, b_: f(x_ @ w_ + b_), (x, w, b),
                        torch.Generator(device="cuda").manual_seed(5))
            for name, g, r in zip(("x", "w", "b"), got, ref):
                compare(torch, g, r, F32_RTOL, f"fused_linear {act} lead={lead} "
                        f"d{name}", scaled=True)
            n_cases += 1
    gen = torch.Generator(device="cuda").manual_seed(47)
    a = signed(torch, (4, 100, 128), f32, gen)
    b = signed(torch, (4, 128, 300), f32, gen)
    bias = signed(torch, (300,), f32, gen)
    got = grads(torch, lambda x, y, z: matmul(x, y, epilogue="bias_tanh",
                                              epilogue_operands=(z,)),
                (a, b, bias), torch.Generator(device="cuda").manual_seed(6))
    ref = grads(torch, lambda x, y, z: torch.tanh(x @ y + z), (a, b, bias),
                torch.Generator(device="cuda").manual_seed(6))
    for name, g, r in zip(("a", "b", "bias"), got, ref):
        compare(torch, g, r, F32_RTOL, f"batched epilogue recompute d{name}",
                scaled=True)
    log(f"phase 7: gradients vs plain autograd (batched {4 * 3} layouts x "
        f"broadcasts, fused_linear {len(acts) * 2}, batched epilogue "
        f"recompute): ok")


def plain_mlp_step(torch, params, batch, lr):
    """The plain reference trainer step: x @ W + b, relu, mse_loss,
    autograd, SGD.  Used only to compare against the port's step."""
    leaves = [t.detach().requires_grad_() for wb in params for t in wb]
    h = batch[0]
    for i in range(0, len(leaves), 2):
        h = h @ leaves[i] + leaves[i + 1]
        if i + 2 < len(leaves):
            h = torch.relu(h)
    loss = torch.nn.functional.mse_loss(h, batch[1])
    gs = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        new = [p - lr * g for p, g in zip(leaves, gs)]
    return list(zip(new[::2], new[1::2])), loss.detach()


def run_trainer(torch, dims, tokens, dtype, fused, lr=0.1, steps=5):
    """(losses, step seconds) of the port's trainer and of the plain one,
    both from the same seeded parameters and batch."""
    from gemm_hls_tpu_torch.models import mlp

    out = {}
    for who in ("port", "plain"):
        params = mlp.init_params(torch.Generator(device="cuda").manual_seed(0),
                                 dims, dtype)
        batch = mlp.make_batch(torch.Generator(device="cuda").manual_seed(1),
                               tokens, dims[0], dims[-1], dtype)
        losses, secs = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if who == "port":
                params, loss = mlp.train_step(params, batch, lr=lr, fused=fused)
            else:
                params, loss = plain_mlp_step(torch, params, batch, lr)
            losses.append(float(loss))
            secs.append(time.perf_counter() - t0)
        out[who] = (losses, secs, params)
    return out


def ops_in(torch, fn):
    """Names of the aten ops ``fn`` dispatches (its kernels' launches go
    through ctypes and show as none)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func.__name__)
            return func(*args, **(kwargs or {}))

    with Record():
        fn()
    return seen


def phase_slice2(torch):
    from gemm_hls_tpu_torch import attention, matmul
    from gemm_hls_tpu_torch.config import ROW_SOFTMAX_MAX_N
    from gemm_hls_tpu_torch.models import mlp
    from gemm_hls_tpu_torch.ops import mxu
    from gemm_hls_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    reset_counters()
    # 8a/8b: the trainer, fused and unfused, against the plain trainer.
    for key, dims, tokens, dtype, rtol in (
            ("bf16", (4096, 16384, 4096), 8192, torch.bfloat16, BF16_RTOL),
            ("fp32", (1024, 4096, 1024), 2048, torch.float32, 1e-3)):
        for fused in (True, False):
            ep_before = mxu.mxu_matmul.epilogue_launches
            run = run_trainer(torch, dims, tokens, dtype, fused)
            ep_launches = mxu.mxu_matmul.epilogue_launches - ep_before
            (losses, secs, params), (p_losses, p_secs, _) = run["port"], run["plain"]
            for i, (l, pl) in enumerate(zip(losses, p_losses)):
                if not (abs(l - pl) <= rtol * abs(pl)):
                    raise AssertionError(f"trainer {key} fused={fused} step {i}: "
                                         f"loss {l} vs plain {pl}")
            if not losses[-1] < losses[0]:
                raise AssertionError(f"trainer {key} fused={fused}: loss did "
                                     f"not decrease: {losses}")
            if fused != (ep_launches > 0):
                raise AssertionError(f"trainer {key} fused={fused}: {ep_launches} "
                                     f"B1 epilogue launches")
            step = statistics.median(secs[1:])
            log(f"phase 8a: trainer {key} dims {dims} x {tokens} tokens "
                f"fused={fused}: losses {[round(v, 4) for v in losses]} vs plain "
                f"{[round(v, 4) for v in p_losses]}; step {step * 1e3:.1f} ms "
                f"(plain {statistics.median(p_secs[1:]) * 1e3:.1f} ms); "
                f"B1 epilogue launches {ep_launches}")
        if key == "bf16":
            # No separate bias or activation pass in the fused forward.
            x = mlp.make_batch(torch.Generator(device="cuda").manual_seed(1), tokens,
                               dims[0], dims[-1], dtype)[0]
            pointwise = ("add", "relu", "threshold", "clamp", "maximum", "mul")
            with torch.no_grad():
                fused_ops = ops_in(torch, lambda: mlp.mlp_forward(params, x, fused=True))
                unfused_ops = ops_in(torch, lambda: mlp.mlp_forward(params, x))
            bad = [o for o in fused_ops if o.split(".")[0] in pointwise]
            if bad or not any(o.split(".")[0] in pointwise for o in unfused_ops):
                raise AssertionError(f"fused forward ran {bad}; unfused ran "
                                     f"{unfused_ops}")
            log(f"phase 8a: fused forward dispatched only {sorted(set(fused_ops))}; "
                f"the unfused one also {sorted(set(unfused_ops) - set(fused_ops))}")
            build = REPO / "gemm_hls_tpu_torch" / "build"
            build.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=build) as d:
                path = save_checkpoint(str(Path(d) / "mlp.npz"), params)
                back = load_checkpoint(path, like=params)
            if not all(torch.equal(u, v) for pu, pv in zip(params, back)
                       for u, v in zip(pu, pv)):
                raise AssertionError("checkpoint round trip changed the params")
            log("phase 8a: checkpoint round trip of the bf16 params: ok")

    # 8c/8d: fused-scores attention, and rows past the fused bound.
    gen = torch.Generator(device="cuda").manual_seed(51)
    for key, (bh, s, d) in (("attention", (32, 1024, 128)),
                            ("attention long", (8, 8192, 128))):
        q, k, v = (torch.randn((bh, s, d), generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        before = mxu.mxu_matmul_batched.row_softmax_launches
        out = attention(q, k, v)
        fused = mxu.mxu_matmul_batched.row_softmax_launches - before
        if fused != (1 if s <= ROW_SOFTMAX_MAX_N else 0):
            raise AssertionError(f"{key}: {fused} row-softmax launches")
        ref = plain_attention(torch, q, k, v)
        max_abs, max_rel = compare(torch, out, ref, BF16_RTOL, key, scaled=True)
        if out.shape != q.shape or not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(f"{key}: bad output")
        log(f"phase 8c: {key} ({bh}, {s}, {d}) bf16, "
            f"{'fused row softmax' if fused else 'unfused branch'}: max abs err "
            f"{max_abs:.3e}, scaled rel {max_rel:.3e}")
        del q, k, v, out, ref
    # 8e: attention's gradient against plain autograd.
    gen = torch.Generator(device="cuda").manual_seed(53)
    qkv = [signed(torch, (8, 512, 64), torch.float32, gen) for _ in range(3)]
    got = grads(torch, attention, qkv, torch.Generator(device="cuda").manual_seed(7))
    ref = grads(torch, lambda q, k, v: torch.softmax(q @ k.transpose(1, 2) / 8.0, -1) @ v,
                qkv, torch.Generator(device="cuda").manual_seed(7))
    for name, g, r in zip("qkv", got, ref):
        compare(torch, g, r, F32_RTOL, f"attention grad d{name}", scaled=True)
    log("phase 8e: attention gradient at (8, 512, 64) fp32 vs plain autograd: ok")

    # 8f: batched GEMMs through the front door.
    n_cases = 0
    for bsz, sz in ((64, 512), (256, 128)):
        for ta, tb in LAYOUTS:
            a = signed(torch, (bsz, sz, sz), torch.bfloat16, gen)
            b = signed(torch, (bsz, sz, sz), torch.bfloat16, gen)
            kw = dict(transpose_a=ta, transpose_b=tb)
            compare(torch, matmul(a, b, **kw), matmul(a, b, backend="torch", **kw),
                    BF16_RTOL, f"matmul bf16 {bsz}x{sz}^3 ta={ta} tb={tb}",
                    scaled=True)
            n_cases += 1
    a8 = torch.randint(-100, 100, (64, 512, 512), generator=gen, device="cuda",
                       dtype=torch.int8)
    b8 = torch.randint(-100, 100, (64, 512, 512), generator=gen, device="cuda",
                       dtype=torch.int8)
    compare(torch, matmul(a8, b8, out_dtype="int32"),
            matmul(a8, b8, out_dtype="int32", backend="torch"), 0.0, "int8 batched")
    a32, b32 = (signed(torch, (64, 512, 512), torch.float32, gen) for _ in range(2))
    compare(torch, matmul(a32, b32), matmul(a32, b32, backend="torch"), F32_RTOL,
            "fp32 batched", scaled=True)
    w = b32[0].to(torch.bfloat16)
    ab = a32.to(torch.bfloat16)
    for kw in (dict(transpose_a=True), dict()):  # broadcast 2-D b: B2, and one B1
        compare(torch, matmul(ab, w, **kw), matmul(ab, w, backend="torch", **kw),
                BF16_RTOL, f"broadcast 2-D b {kw}", scaled=True)
    compare(torch, matmul(w, ab), matmul(w, ab, backend="torch"), BF16_RTOL,
            "broadcast 2-D a", scaled=True)
    a4 = ab.reshape(8, 8, 512, 512)
    compare(torch, matmul(a4, a4), matmul(a4, a4, backend="torch"), BF16_RTOL,
            "4-D leading dims", scaled=True)
    am, bm = (signed(torch, (16, 512, 512), torch.float32, gen) for _ in range(2))
    compare(torch, matmul(am, bm, semiring="min_plus"),
            matmul(am, bm, semiring="min_plus", backend="torch"), 0.0,
            "batched min_plus")
    n_cases += 7
    log(f"phase 8f: batched matmul vs plain, {n_cases} cases (64x512^3 and "
        f"256x128^3 bf16 four layouts, int8, fp32, broadcast, 4-D, min_plus): ok")

    launches = counters()
    log(f"phase 8: main-path launch counts {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the slice 2 "
                                 f"main path")
    return launches


def plain_attention(torch, q, k, v):
    """The plain version of ``attention``: the plain row-softmax GEMM, then
    the plain batched GEMM, from the same rounded-scale q."""
    from gemm_hls_tpu_torch.config import default_config
    from gemm_hls_tpu_torch.ops import mxu
    from gemm_hls_tpu_torch.ops.epilogue import get_epilogue

    cfg = default_config(q.dtype)
    qs = q * torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype)
    p = mxu.mxu_matmul_plain(qs, k, cfg=cfg, transpose_b=True,
                             epilogue=get_epilogue("softmax"))
    return mxu.mxu_matmul_plain(p, v, cfg=cfg)


def phase_times(torch):
    """Kernel vs plain times at the main path's shapes (launches here are
    comparisons, not the main path's)."""
    from gemm_hls_tpu_torch.config import default_config
    from gemm_hls_tpu_torch.ops import mxu
    from gemm_hls_tpu_torch.ops.epilogue import get_epilogue
    from gemm_hls_tpu_torch.utils.benchmark import time_fn

    gen = torch.Generator(device="cuda").manual_seed(61)
    bf16 = torch.bfloat16
    out = {}

    def entry(key, fn, plain, args, iters, rtol, extra=None):
        got, ref = fn(*args), plain(*args)
        max_abs, _ = compare(torch, got, ref, rtol, key, scaled=True)
        ms = time_fn(fn, args, iters=iters) * 1e3
        plain_ms = time_fn(plain, args, iters=iters) * 1e3
        out[key] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=max_abs)
        line = f"phase 9: {key}: {ms:.3f} ms vs plain {plain_ms:.3f} ms"
        if extra:
            e_ms = time_fn(extra[1], args, iters=iters) * 1e3
            line += f" ({extra[0]} {e_ms:.3f} ms)"
        log(line + f"; max abs err {max_abs:.3e}")

    # B1 with bias_relu at the trainer's first layer.
    x = signed(torch, (8192, 4096), bf16, gen)
    w = signed(torch, (4096, 16384), bf16, gen) * 0.02
    b = signed(torch, (16384,), bf16, gen)
    ep, cfg = get_epilogue("bias_relu"), default_config(bf16)
    entry("B1 epilogue", lambda x_, w_, b_: mxu.mxu_matmul(x_, w_, b_, cfg=cfg, epilogue=ep),
          lambda x_, w_, b_: mxu.mxu_matmul_plain(x_, w_, b_, cfg=cfg, epilogue=ep),
          (x, w, b), 10, BF16_RTOL,
          ("torch.relu(x @ w + b) in bf16", lambda x_, w_, b_: torch.relu(x_ @ w_ + b_)))
    del x, w, b
    # B2 at 64 x 512^3 and 256 x 128^3, against torch.bmm.
    for bsz, sz in ((64, 512), (256, 128)):
        a = signed(torch, (bsz, sz, sz), bf16, gen)
        c = signed(torch, (bsz, sz, sz), bf16, gen)
        entry(f"B2 {bsz}x{sz}^3", lambda a_, c_: mxu.mxu_matmul_batched(a_, c_, cfg=cfg),
              torch.bmm, (a, c), 20, BF16_RTOL)
    # B2's row softmax at the attention scores' shape.
    q = torch.randn((32, 1024, 128), generator=gen, device="cuda", dtype=bf16)
    k = torch.randn((32, 1024, 128), generator=gen, device="cuda", dtype=bf16)
    sm = get_epilogue("softmax")
    entry("B2 row-softmax", lambda q_, k_: mxu.mxu_matmul_batched(
              q_, k_, cfg=cfg, transpose_b=True, epilogue=sm),
          lambda q_, k_: mxu.mxu_matmul_plain(q_, k_, cfg=cfg, transpose_b=True,
                                              epilogue=sm),
          (q, k), 20, BF16_RTOL,
          ("torch.softmax(bmm) in bf16", lambda q_, k_: torch.softmax(
              torch.bmm(q_, k_.transpose(1, 2)).float(), -1).to(bf16)))
    from gemm_hls_tpu_torch import attention, matmul
    v = torch.randn((32, 1024, 128), generator=gen, device="cuda", dtype=bf16)
    entry("attention (32, 1024, 128)", attention,
          lambda q_, k_, v_: plain_attention(torch, q_, k_, v_), (q, k, v), 20,
          BF16_RTOL)
    del q, k, v

    # Phase 8f's batched calls through the front door, beside the torch
    # call that computes the same thing (torch.bmm / torch.matmul; for int8
    # and min_plus, which cuBLAS does not take, the plain version).
    def tr(x, t):
        return x.transpose(-1, -2) if t else x

    for bsz, sz in ((64, 512), (256, 128)):
        a = signed(torch, (bsz, sz, sz), bf16, gen)
        c = signed(torch, (bsz, sz, sz), bf16, gen)
        for ta, tb in LAYOUTS:
            entry(f"matmul bf16 {bsz}x{sz}^3 ta={int(ta)} tb={int(tb)}",
                  lambda a_, c_, ta=ta, tb=tb: matmul(a_, c_, transpose_a=ta,
                                                      transpose_b=tb),
                  lambda a_, c_, ta=ta, tb=tb: torch.bmm(tr(a_, ta), tr(c_, tb)),
                  (a, c), 20, BF16_RTOL)
    a8, c8 = (torch.randint(-100, 100, (64, 512, 512), generator=gen,
                            device="cuda", dtype=torch.int8) for _ in range(2))
    entry("matmul int8->int32 64x512^3", lambda x, y: matmul(x, y, out_dtype="int32"),
          lambda x, y: matmul(x, y, out_dtype="int32", backend="torch"),
          (a8, c8), 20, 0.0)
    a32, c32 = (signed(torch, (64, 512, 512), torch.float32, gen) for _ in range(2))
    entry("matmul fp32 64x512^3", matmul, torch.bmm, (a32, c32), 10, F32_RTOL)
    ab, w = a32.to(bf16), c32[0].to(bf16)
    entry("matmul broadcast 2-D b (ta) 64x512^3",
          lambda x, y: matmul(x, y, transpose_a=True),
          lambda x, y: torch.matmul(x.transpose(1, 2), y), (ab, w), 20, BF16_RTOL)
    entry("matmul broadcast 2-D a 64x512^3", matmul, torch.matmul, (w, ab), 20,
          BF16_RTOL)
    a4 = ab.reshape(8, 8, 512, 512)
    entry("matmul 4-D 8x8x512^3", matmul, torch.matmul, (a4, a4), 20, BF16_RTOL)
    am, cm = (signed(torch, (16, 512, 512), torch.float32, gen) for _ in range(2))
    entry("matmul min_plus 16x512^3", lambda x, y: matmul(x, y, semiring="min_plus"),
          lambda x, y: matmul(x, y, semiring="min_plus", backend="torch"),
          (am, cm), 5, 0.0)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    if not (REPO / "gemm_hls_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no gemm_hls_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1: device {kind} x{torch.cuda.device_count()} ({smi}); "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    from gemm_hls_tpu_torch import _build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    spills = [ln.strip() for ln in lib_path.with_suffix(".log").read_text()
              .splitlines() if "spill" in ln and not ln.strip().endswith(
                  "0 bytes spill stores, 0 bytes spill loads")]
    log(f"phase 2: built and loaded {lib_path.name} in "
        f"{time.perf_counter() - t0:.1f} s; kernels with spills: {len(spills)}")

    phase_b1(torch)
    phase_b3(torch)
    results, launches = phase_main(torch)
    phase_b2(torch)
    phase_grads(torch)
    launches2 = phase_slice2(torch)
    times = phase_times(torch)

    def kernel(name, source, replaces, n, t):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n,
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"]}

    slice1 = {key: {"max_abs_err": r["max_abs_err"], "ms": r["seconds"] * 1e3,
                    "plain_ms": r["plain_seconds"] * 1e3}
              for key, r in results.items()}
    kernels = [
        kernel("mxu_gemm (B1, dense plus_times)",
               "gemm_hls_tpu_torch/csrc/mxu_gemm.cu",
               "gemm_hls_tpu/ops/pallas_mxu.py:69", launches["B1"], slice1["B1"]),
        kernel("mxu_gemm with epilogue (B1 fused bias + activation)",
               "gemm_hls_tpu_torch/csrc/mxu_gemm.cu",
               "gemm_hls_tpu/ops/pallas_mxu.py:103", launches2["B1 epilogue"],
               times["B1 epilogue"]),
        kernel("mxu_gemm batched (B2, plain and per-column epilogue)",
               "gemm_hls_tpu_torch/csrc/mxu_gemm.cu",
               "gemm_hls_tpu/ops/pallas_mxu.py:143", launches2["B2"],
               times["B2 64x512^3"]),
        kernel("mxu_gemm_row_softmax (B2, row-softmax epilogue)",
               "gemm_hls_tpu_torch/csrc/row_softmax.cu",
               "gemm_hls_tpu/ops/pallas_mxu.py:176", launches2["B2 row-softmax"],
               times["B2 row-softmax"]),
        kernel("semiring_gemm (B3, generic semiring)",
               "gemm_hls_tpu_torch/csrc/semiring_gemm.cu",
               "gemm_hls_tpu/ops/pallas_vpu.py:56", launches["B3"], slice1["B3"]),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
