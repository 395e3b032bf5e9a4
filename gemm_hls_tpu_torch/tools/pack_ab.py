"""The pack pass and the TF32 split pass against an earlier commit's, on the card.

    python -m gemm_hls_tpu_torch.tools.pack_ab PARENT_CSRC

``PARENT_CSRC`` is the ``gemm_hls_tpu_torch/csrc`` directory of an earlier
checkout (say one that ``git archive`` unpacked into a gitignored
directory).  Builds ``csrc/operand_pack.cu`` and ``csrc/tf32_split.cu``
(the pack on ``csrc/operand_tile.cuh``'s tile walk; the split's fp32 entry)
into two small libraries side by side under the gitignored
``gemm_hls_tpu_torch/build/pack_ab/``, one from those sources and one from
this checkout's.  Then, for each pass at the shapes of ``chip_smoke.py``'s
phase 34 (an int8 B held (K, N), a bf16 A with K 8190 held either way, an
fp32 operand split into three segments held either way), on seeded
operands: counts the workspace bytes that differ between the two and
times both on CUDA events in turns (parent, change, change, parent),
beside the pass's byte bound (each value read once, each workspace value
written once, at ``H100.hbm_bandwidth``).  Prints each library's ptxas
report.  Needs the card and ``chip_smoke.py`` at the repository root
(``nvidia_smi``).
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
SOURCES = ("operand_pack.cu", "tf32_split.cu")
# (pass, dtype, rows, K, held (K, rows)): phase 34's operands.
CASES = (("pack", "int8", 8192, 8192, True),        # B (K, N) of int8 8192^3
         ("pack", "bfloat16", 8192, 8190, False),   # A (M, K) of bf16 8192 x 8190
         ("pack", "bfloat16", 8192, 8190, True),    # the same held (K, M)
         ("split", "float32", 8192, 8190, False),   # A (M, K) of fp32 8192 x 8190
         ("split", "float32", 8192, 8190, True))    # B (K, N)


def build(parent_csrc: Path):
    """({"parent" | "change": CDLL}, {same: ptxas report lines}), built side
    by side."""
    out_dir = _build.BUILD_DIR / "pack_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    jobs = {}
    for name, csrc in (("parent", parent_csrc), ("change", _build.CSRC_DIR)):
        so = out_dir / f"lib{name}.so"
        jobs[name] = (so, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-I", str(csrc), "-o", str(so),
             *(str(csrc / s) for s in SOURCES)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, reports = {}, {}
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name, (so, proc) in jobs.items():
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{text[-4000:]}")
        reports[name] = [ln.strip() for ln in text.splitlines()
                         if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        lib = ctypes.CDLL(str(so))
        lib.operand_pack.restype = lib.tf32_split.restype = i32
        lib.operand_pack.argtypes = [vp, vp, i64, i32, i32, i64, i64, i32, i32, i32, vp]
        lib.tf32_split.argtypes = [vp, vp, i64, i32, i32, i64, i64, i32, i32, i32, i32, vp]
        libs[name] = lib
    return libs, reports


def launch(lib, what, x, rows, k, mn_major):
    """The pass's workspace of ``x`` (held (rows, k), or (k, rows) with
    ``mn_major``), contiguous."""
    per = 16 // x.element_size()
    kp = (k + per - 1) // per * per
    segs = 3 if what == "split" else 1
    out = torch.empty((rows, segs * kp), dtype=x.dtype, device="cuda")
    st = torch.cuda.current_stream().cuda_stream
    ld = x.stride(0)
    if what == "pack":
        rc = lib.operand_pack(x.data_ptr(), out.data_ptr(), 1, rows, k, ld, 0, int(mn_major), kp,
                              x.element_size(), st)
    else:
        rc = lib.tf32_split(x.data_ptr(), out.data_ptr(), 1, rows, k, ld, 0, int(mn_major), kp,
                            segs, 1, st)
    _build.check(rc, f"pack_ab {what}")
    return out


def turns(fns, rounds=10, iters=20):
    """{name: median ms a call} on CUDA events, the order reversed every
    other round (parent, change, change, parent, ...)."""
    from gemm_hls_tpu_torch.utils.benchmark import time_fn
    names = list(fns)
    times = {name: [] for name in names}
    for r in range(rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            times[name].append(time_fn(fns[name], [()], iters=iters, warmup=2,
                                       hold_stream=True) * 1e3)
    return {name: statistics.median(t) for name, t in times.items()}


def run(libs):
    """[{pass, dtype, rows, k, mn_major, differing, parent_ms, change_ms,
    bound_ms}]."""
    from gemm_hls_tpu_torch.models.perf_model import H100
    gen = torch.Generator(device="cuda").manual_seed(2525)
    rows_out = []
    for what, dt, rows, k, mn in CASES:
        shape = (k, rows) if mn else (rows, k)
        if dt == "int8":
            x = torch.randint(-128, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
        else:
            x = torch.randn(shape, generator=gen, device="cuda").to(getattr(torch, dt))
        got = {name: launch(lib, what, x, rows, k, mn) for name, lib in libs.items()}
        bits = {name: g.view(torch.uint8) for name, g in got.items()}
        differing = int((bits["parent"] != bits["change"]).sum())
        out_bytes = got["change"].numel() * got["change"].element_size()
        del got, bits
        t = turns({name: (lambda lib=lib: launch(lib, what, x, rows, k, mn))
                   for name, lib in libs.items()})
        bound_ms = (x.numel() * x.element_size() + out_bytes) / H100.hbm_bandwidth * 1e3
        r = dict(pass_=what, dtype=dt, rows=rows, k=k, mn_major=mn, differing=differing,
                 parent_ms=t["parent"], change_ms=t["change"], bound_ms=bound_ms)
        rows_out.append(r)
        print(f"pack_ab: {what} {dt} {rows} x {k} held {'(K, rows)' if mn else '(rows, K)'}: "
              f"parent {r['parent_ms']:.4f} ms ({bound_ms / r['parent_ms']:.1%} of the bound), "
              f"change {r['change_ms']:.4f} ms ({bound_ms / r['change_ms']:.1%}; "
              f"{r['change_ms'] / r['parent_ms']:.3f}x), bound {bound_ms:.4f} ms; bytes that "
              f"differ: {differing}", flush=True)
        del x
    return rows_out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent_csrc", type=Path, help="an earlier checkout's csrc directory")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pack_ab: no CUDA device", file=sys.stderr)
        return 2
    if not all((args.parent_csrc / s).is_file() for s in SOURCES):
        print(f"pack_ab: {args.parent_csrc} lacks one of {SOURCES}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    print(f"pack_ab: {chip_smoke.nvidia_smi()}", flush=True)
    t0 = time.perf_counter()
    libs, reports = build(args.parent_csrc.resolve())
    print(f"pack_ab: built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, lines in reports.items():
        print(f"pack_ab: {name} ptxas:" + "".join(f"\n  {ln}" for ln in lines), flush=True)
    rows = run(libs)
    return 1 if any(r["differing"] for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
