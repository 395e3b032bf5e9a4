"""Host runner CLI — the ``RunHardware.exe N K M [hw/hw_emu] [verify]`` port
(reference ``host/RunHardware.cpp:18-28``), on PyTorch and CUDA.

    python -m gemm_hls_tpu_torch.tools.run M N K [--dtype DT] [--semiring SR]
        [--verify {on,off}] [--iters I] [--backend cuda|vpu|torch] [--baseline]
        [--device {cuda,cpu}]

``--dtype`` takes every operand type the kernels take: float32, bfloat16,
float16, float64, int8, int16, int32, uint8, uint16, uint32, and int64
under the semirings other than plus_times (which the reference refuses).
Seed-5 U(1,10) operands, kernel launch and timing on CUDA events,
GOp/s = 1e-9 * 2*M*N*K / t, and element-wise verification against the
float64 BLAS / semiring oracle (relative 1e-3 for float32, exact for
integers).  ``--baseline`` also times the plain PyTorch version on the same
operands (``torch.matmul`` for plus_times) and compares the two outputs.
The run needs a CUDA device: without one it says so on stderr and exits
non-zero.  ``--device cpu`` runs the plain versions on the CPU instead and
reports no device time.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from gemm_hls_tpu_torch.config import default_config, torch_dtype
from gemm_hls_tpu_torch.models.perf_model import detect_chip, plus_times_peak
from gemm_hls_tpu_torch.ops import mxu
from gemm_hls_tpu_torch.ops.matmul import matmul
from gemm_hls_tpu_torch.ops.semiring import get_semiring
from gemm_hls_tpu_torch.utils.benchmark import gflops, percent_of_peak, time_fn
from gemm_hls_tpu_torch.utils.verify import (
    check_result, make_operands, reference_matmul, tolerance_for,
)


def _parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("m", type=int)
    p.add_argument("n", type=int)
    p.add_argument("k", type=int)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--out-dtype", default=None)
    p.add_argument("--semiring", default="plus_times")
    p.add_argument("--verify", choices=["on", "off"], default="on")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--backend", choices=["cuda", "vpu", "torch"], default=None)
    p.add_argument("--precision", choices=["default", "high", "highest"],
                   default=None)
    p.add_argument("--baseline", action="store_true",
                   help="also time the plain PyTorch version and compare")
    p.add_argument("--block-m", type=int, default=None)
    p.add_argument("--block-n", type=int, default=None)
    p.add_argument("--block-k", type=int, default=None)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the GEMM runs (cpu: the plain versions)")
    return p


def _host(x: torch.Tensor) -> np.ndarray:
    """A result or operand as numpy, bf16/fp16 widened exactly to float32."""
    if x.dtype in (torch.bfloat16, torch.float16):
        x = x.float()
    return x.cpu().numpy()


def run(argv=None) -> dict:
    """Run one GEMM as ``main`` does; returns what was measured, with the
    output tensor under "out"."""
    args = _parser().parse_args(argv)
    sr = get_semiring(args.semiring)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("run: no CUDA device; pass --device cpu to run the plain "
              "versions on the CPU", file=sys.stderr)
        return {"ok": False, "device": None}
    device = torch.device(args.device)
    backend = args.backend
    cfg = None
    overrides = {}
    for name in ("block_m", "block_n", "block_k"):
        if getattr(args, name) is not None:
            overrides[name] = getattr(args, name)
    if args.out_dtype:
        overrides["out_dtype"] = args.out_dtype
    if args.precision:
        overrides["precision"] = args.precision
    if overrides:
        cfg = default_config(args.dtype, semiring=sr.name, **overrides)
    name = torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"
    print(f"Executing {args.m}x{args.n}x{args.k} {args.dtype} {sr.name} "
          f"GEMM on {name}...")

    a_np, b_np = make_operands(args.m, args.n, args.k, args.dtype)
    dt = torch_dtype(args.dtype)
    a = torch.from_numpy(a_np).to(device=device, dtype=dt)
    b = torch.from_numpy(b_np).to(device=device, dtype=dt)

    def fn(x, y, be=backend):
        return matmul(x, y, semiring=sr, config=cfg, backend=be)

    out = fn(a, b)
    res = {"m": args.m, "n": args.n, "k": args.k, "dtype": args.dtype,
           "semiring": sr.name, "device": name, "out": out, "ok": True}
    if device.type == "cuda":
        chip = detect_chip()
        secs = time_fn(fn, [(a, b)], iters=args.iters, warmup=1)
        gf = gflops(args.m, args.n, args.k, secs)
        # The route the call took sets the peak (the integers' byte planes
        # on the engine: the int8 rate over their pairs).
        peak = (plus_times_peak(chip, args.dtype, mxu.mxu_matmul.last_route) if sr.is_mxu
                else chip.vpu_ops_for(args.dtype, sr.name, out.dtype))
        res.update(seconds=secs, gops=gf)
        print(f"Kernel executed in {secs:.6f} seconds, corresponding to a "
              f"performance of {gf:.1f} GOp/s ({percent_of_peak(gf, peak):.1f}% "
              f"of {chip.name} peak).")
        if args.baseline:
            plain = fn(a, b, "torch")
            p_secs = time_fn(fn, [(a, b, "torch")], iters=max(1, args.iters // 5),
                             warmup=0, repeats=1)
            rtol = tolerance_for(out.dtype)
            ok, err = check_result(_host(out), _host(plain), rtol=rtol)
            res.update(plain_seconds=p_secs,
                       plain_gops=gflops(args.m, args.n, args.k, p_secs),
                       max_rel_err_vs_plain=err, plain_out=plain, ok=ok)
            print(f"Plain PyTorch version: {p_secs:.6f} seconds "
                  f"({res['plain_gops']:.1f} GOp/s); kernel vs plain max rel "
                  f"err {err:.3e} (rtol {rtol:g}): "
                  f"{'agree' if ok else 'DISAGREE'}.")
    else:
        print("Device time: not measured (no CUDA device; plain versions ran "
              "on the CPU).")

    if args.verify == "on":
        print("Verifying result...")
        exp = reference_matmul(_host(a), _host(b), semiring=sr.name)
        got = _host(out)
        if exp.dtype.kind in "iu":
            # The reference's int32 accumulator wraps, then its astype to
            # the output type (int8 / int16 / the unsigned ints) wraps again.
            exp = exp.astype(np.int32).astype(got.dtype)
        ok, err = check_result(got, exp, rtol=tolerance_for(out.dtype))
        res["ok"] = res["ok"] and ok
        res["max_rel_err_vs_oracle"] = err
        if ok:
            print(f"Results verified (max rel err {err:.3e} <= "
                  f"{tolerance_for(out.dtype):g}).")
        else:
            print(f"VERIFICATION FAILED (max err {err:.3e}).")
    return res


def main(argv=None) -> int:
    return 0 if run(argv)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
