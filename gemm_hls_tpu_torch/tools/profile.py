"""Profiling and tracing: the port of ``gemm_hls_tpu/tools/profile.py``.

The reference offers opt-in instrumentation (``MM_ENABLE_PROFILING``,
``CMakeLists.txt:10,197-201``) plus host timing held against the
``PrintSpecifications`` expectation.  Here:

* :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace (``<logdir>/trace.json``, read by chrome://tracing or
  Perfetto) of the host calls and, on a card, the kernels and copies.
* :func:`profile_matmul`: times one GEMM (CUDA events on a card, the host
  clock on the CPU) and reports it against ``models.perf_model``'s
  expectation for the tile the call runs (``config.route_config``).

    python -m gemm_hls_tpu_torch.tools.profile 4096 4096 4096 --dtype bfloat16 \
        [--trace-dir DIR] [--device {cuda,cpu}]
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import time
from pathlib import Path
from typing import Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace of the block, written to ``logdir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


def profile_matmul(m: int, n: int, k: int, *, dtype="float32",
                   semiring="plus_times", config=None, iters: int = 5,
                   logdir: Optional[str] = None, device=None) -> dict:
    """Measure one GEMM and compare to the analytical model.  ``device``:
    where it runs (default: the card; "cpu" runs the plain versions on the
    host clock)."""
    from gemm_hls_tpu_torch.config import pack_bytes, route_config, torch_dtype
    from gemm_hls_tpu_torch.models.perf_model import detect_chip, specifications
    from gemm_hls_tpu_torch.ops import mxu
    from gemm_hls_tpu_torch.ops.matmul import matmul
    from gemm_hls_tpu_torch.ops.semiring import get_semiring
    from gemm_hls_tpu_torch.utils.benchmark import gflops, percent_of_peak, time_fn
    from gemm_hls_tpu_torch.utils.verify import make_operands

    dev = torch.device("cuda" if device is None else device)
    sr = get_semiring(semiring)
    chip = detect_chip(dev)
    a_np, b_np = make_operands(m, n, k, dtype)
    dt = torch_dtype(dtype)
    a = torch.from_numpy(a_np).to(device=dev, dtype=dt)
    b = torch.from_numpy(b_np).to(device=dev, dtype=dt)

    def fn(x, y):
        return matmul(x, y, semiring=sr, config=config)

    fn(a, b)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    route = mxu.mxu_matmul.last_route if dev.type == "cuda" and sr.is_mxu else None

    if logdir:
        with trace(logdir):
            fn(a, b)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    if dev.type == "cuda":
        secs = time_fn(fn, [(a, b)], iters=iters, warmup=1)
    else:
        times = []
        for _ in range(max(1, iters)):
            t0 = time.perf_counter()
            fn(a, b)
            times.append(time.perf_counter() - t0)
        secs = statistics.median(times)
    cfg = config or route_config(dtype, semiring=sr.name)
    packed = pack_bytes(dtype, m, n, k) if sr.is_mxu and dev.type == "cuda" else 0
    spec = specifications(cfg, m, n, k, chip=chip, semiring_is_mxu=sr.is_mxu,
                          pack_bytes=packed, route=route)
    gf = gflops(m, n, k, secs)
    return {
        "measured_seconds": secs,
        "measured_gflops": gf,
        "expected_seconds": spec["expected_runtime_s"],
        "expected_gflops": spec["expected_gflops"],
        "percent_of_expected": 100.0 * spec["expected_runtime_s"] / secs,
        "percent_of_peak": percent_of_peak(gf, spec["peak_flops"]),
        "bound": spec["bound"],
        "blocks": spec["blocks"],
        "route": route,
        "clock": "cuda events" if dev.type == "cuda" else "host",
        "trace_dir": logdir,
        "chip": chip.name,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("m", type=int)
    p.add_argument("n", type=int)
    p.add_argument("k", type=int)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--semiring", default="plus_times")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--trace-dir", default=None,
                   help="write a Chrome trace (trace.json) here")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the GEMM runs (cpu: the plain versions)")
    args = p.parse_args(argv)
    r = profile_matmul(args.m, args.n, args.k, dtype=args.dtype,
                       semiring=args.semiring, iters=args.iters,
                       logdir=args.trace_dir, device=args.device)
    print(f"measured ({r['clock']}): {r['measured_seconds'] * 1e3:.3f} ms "
          f"({r['measured_gflops']:.1f} GOp/s){'' if r['route'] is None else ', route ' + r['route']}")
    print(f"roofline expectation for blocks {r['blocks']}: "
          f"{r['expected_seconds'] * 1e3:.3f} ms "
          f"({r['expected_gflops']:.1f} GOp/s) [{r['bound']}-bound]")
    print(f"achieved {r['percent_of_expected']:.1f}% of expected, "
          f"{r['percent_of_peak']:.1f}% of {r['chip']} peak")
    if r["trace_dir"]:
        print(f"trace written to {Path(r['trace_dir']) / 'trace.json'}")
    return r


if __name__ == "__main__":
    main()
