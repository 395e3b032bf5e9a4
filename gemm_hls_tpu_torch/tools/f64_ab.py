"""B3 float64 against an earlier commit's, on the card.

    python -m gemm_hls_tpu_torch.tools.f64_ab PARENT_CSRC

``PARENT_CSRC`` is the ``gemm_hls_tpu_torch/csrc`` directory of an earlier
checkout (say one that ``git archive`` unpacked into a gitignored
directory).  Builds two small libraries side by side under the gitignored
``gemm_hls_tpu_torch/build/f64_ab/``, one against those sources and one
against this checkout's, each an ``extern "C"`` entry that builds its
arguments as ``csrc/semiring_gemm.cu`` does and calls ``dispatch_op<double,
double>``: B3's float64 dispatch, on whichever float64 tile that source
has.  Then, for every built-in semiring at 4096^3 (log_plus at 2048^3) on
seeded U(-1, 1) operands, and min_plus with half of A +inf (an APSP
adjacency's shape): counts the outputs whose bits differ between the two
and times both on CUDA events in turns (parent, change, change, parent),
beside each semiring's bound (``ChipSpec.vpu_ops_for``).  Prints each
library's ptxas report.  Needs the card and ``chip_smoke.py`` at the
repository root (``nvidia_smi``).
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from gemm_hls_tpu_torch import _build

REPO = Path(__file__).resolve().parents[2]
# The built-in semirings in csrc/semiring_ops.cuh's Op order.
SEMIRINGS = ("plus_times", "min_plus", "max_plus", "max_min", "min_max", "max_times",
             "plus_absdiff", "plus_sqdiff", "log_plus")
N, N_LOG_PLUS = 4096, 2048

_SOURCE = """// B3 float64 through dispatch_op, as csrc/semiring_gemm.cu calls it.
#include "semiring_ops.cuh"

using namespace gemm_hls;

extern "C" int ab_semiring(const void* a, const void* b, void* c, int M, int N, int K, int op,
                           void* stream) {
  const Gemm g{a, b, c, M, N, K, K, N, 0, 0, 0, 0, 0, 0, kF64,
               EpArgs{nullptr, nullptr, 0, kEpNone}};
  return dispatch_op<double, double>(op, g, 1, static_cast<cudaStream_t>(stream));
}
"""


def build(parent_csrc: Path):
    """({"parent" | "change": CDLL}, {same: ptxas report lines}), built side
    by side."""
    out_dir = _build.BUILD_DIR / "f64_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "ab_semiring.cu"
    cu.write_text(_SOURCE)
    nvcc = _build._nvcc()
    jobs = {}
    for name, csrc in (("parent", parent_csrc), ("change", _build.CSRC_DIR)):
        so = out_dir / f"lib{name}.so"
        jobs[name] = (so, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-I", str(csrc), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, reports = {}, {}
    for name, (so, proc) in jobs.items():
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{text[-4000:]}")
        reports[name] = [ln.strip() for ln in text.splitlines()
                         if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        lib = ctypes.CDLL(str(so))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ab_semiring.restype = i32
        lib.ab_semiring.argtypes = [vp, vp, vp, i32, i32, i32, i32, vp]
        libs[name] = lib
    return libs, reports


def semiring(lib, op, a, b):
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=torch.float64, device="cuda")
    rc = lib.ab_semiring(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, SEMIRINGS.index(op),
                         torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "ab_semiring")
    return c


def turns(fns, rounds=4, iters=2):
    """{name: median ms a call} on CUDA events, the order reversed every
    other round (parent, change, change, parent, ...)."""
    from gemm_hls_tpu_torch.utils.benchmark import time_fn
    names = list(fns)
    times = {name: [] for name in names}
    for r in range(rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            times[name].append(time_fn(fns[name], [()], iters=iters, warmup=1) * 1e3)
    return {name: statistics.median(t) for name, t in times.items()}


def run(libs):
    """[{semiring, n, operands, differing, parent_ms, change_ms, bound_ms}]."""
    from gemm_hls_tpu_torch.models.perf_model import H100
    gen = torch.Generator(device="cuda").manual_seed(2323)
    x = torch.rand((N, N), generator=gen, device="cuda", dtype=torch.float64) * 2 - 1
    y = torch.rand((N, N), generator=gen, device="cuda", dtype=torch.float64) * 2 - 1
    half_inf = x.clone()
    half_inf[torch.rand(x.shape, generator=gen, device="cuda") < 0.5] = float("inf")
    cases = [(op, "U(-1, 1)", x, y) for op in SEMIRINGS]
    cases.append(("min_plus", "A half +inf", half_inf, y))
    rows = []
    for op, values, a, b in cases:
        n = N_LOG_PLUS if op == "log_plus" else N
        a, b = a[:n, :n].contiguous(), b[:n, :n].contiguous()
        got = {name: semiring(lib, op, a, b) for name, lib in libs.items()}
        differing = int((got["parent"].view(torch.int64)
                         != got["change"].view(torch.int64)).sum())
        t = turns({name: (lambda lib=lib: semiring(lib, op, a, b)) for name, lib in libs.items()},
                  iters=1 if op == "log_plus" else 2)
        bound_s, _ = H100.bound(2.0 * n ** 3, H100.vpu_ops_for("float64", op), 3 * n * n * 8)
        rows.append(dict(semiring=op, n=n, operands=values, differing=differing,
                         parent_ms=t["parent"], change_ms=t["change"], bound_ms=bound_s * 1e3))
        r = rows[-1]
        print(f"f64_ab: {op} {n}^3 {values}: parent {r['parent_ms']:.3f} ms, change "
              f"{r['change_ms']:.3f} ms ({r['change_ms'] / r['parent_ms']:.3f}x), bound "
              f"{r['bound_ms']:.3f} ms (change {r['bound_ms'] / r['change_ms']:.1%} of it); "
              f"outputs whose bits differ: {differing}", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent_csrc", type=Path, help="an earlier checkout's csrc directory")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("f64_ab: no CUDA device", file=sys.stderr)
        return 2
    if not (args.parent_csrc / "semiring_ops.cuh").is_file():
        print(f"f64_ab: no semiring_ops.cuh in {args.parent_csrc}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    print(f"f64_ab: {chip_smoke.nvidia_smi()}", flush=True)
    t0 = time.perf_counter()
    libs, reports = build(args.parent_csrc.resolve())
    print(f"f64_ab: built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, lines in reports.items():
        print(f"f64_ab: {name} ptxas:" + "".join(f"\n  {ln}" for ln in lines), flush=True)
    run(libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
