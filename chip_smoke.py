#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``gemm_hls_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printed as it ends:
  1. device check: a CUDA device is required (there is no CPU path);
  2. build both kernels from ``gemm_hls_tpu_torch/csrc`` with nvcc (sm_90a);
  3. kernel B1 (dense plus_times) against its plain PyTorch version on the
     card: bf16, fp16, fp32, int8 -> int32 and int32, four layouts, odd,
     unaligned and 1024-class shapes, bool or_and, autograd gradients;
  4. kernel B3 (semiring GEMM) against its plain version: every built-in
     semiring, f32 / bf16 / int32, unaligned shapes up to 2048, NaN and
     +-inf inputs, all -inf rows for log_plus;
  5. the main path at full size through ``tools.run``: bf16 8192^3 and fp32
     min_plus 4096^3, each checked against the plain version on the card
     and timed beside it, then host-oracle verification at 1024^3.

Tolerances (kernel vs plain version on the same inputs, on the card):
  exact for integer, bool and tropical results (min/max of identically
  rounded terms); relative 1e-4 for outputs summed in fp32 (both sum in
  fp32 in different orders over K <= 2048: about sqrt(K) * 2^-24 per
  element); relative 1e-2 where the output is rounded to bf16 (one bf16
  ulp is 2^-8 relative).  The plain fp32 matmul runs without TF32.

Any mismatch or exception ends the run with a non-zero exit.  The last
three lines are the card's name and power limit, one JSON line on the
kernels, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

F32_RTOL = 1e-4
BF16_RTOL = 1e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return proc.stdout.strip().splitlines()[0]


def compare(torch, got, ref, rtol: float, what: str):
    """Max abs and rel error of ``got`` against ``ref``; NaN and +-inf must
    sit at the same places.  Raises on a mismatch."""
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
    rel = diff / r[fin].abs().clamp_min(1e-30)
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

    kernels = [
        {"name": "mxu_gemm (B1, dense plus_times)", "route": "cuda",
         "source": "gemm_hls_tpu_torch/csrc/mxu_gemm.cu",
         "replaces": "gemm_hls_tpu/ops/pallas_mxu.py:69",
         "launches": launches["B1"], "max_abs_err": results["B1"]["max_abs_err"],
         "ms": results["B1"]["seconds"] * 1e3,
         "plain_ms": results["B1"]["plain_seconds"] * 1e3},
        {"name": "semiring_gemm (B3, generic semiring)", "route": "cuda",
         "source": "gemm_hls_tpu_torch/csrc/semiring_gemm.cu",
         "replaces": "gemm_hls_tpu/ops/pallas_vpu.py:56",
         "launches": launches["B3"], "max_abs_err": results["B3"]["max_abs_err"],
         "ms": results["B3"]["seconds"] * 1e3,
         "plain_ms": results["B3"]["plain_seconds"] * 1e3},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
