"""B3's routes against an earlier commit's, and the measurements its bound
counts, on the card.

    python -m gemm_hls_tpu_torch.tools.b3_ab [PARENT_CSRC ...] [--probe] [--sass]

Builds a small library under the gitignored
``gemm_hls_tpu_torch/build/b3_ab/`` against this checkout's
``gemm_hls_tpu_torch/csrc`` and, for each ``PARENT_CSRC`` (an earlier
checkout's csrc, say one that ``git archive`` unpacked into a gitignored
directory, or a variant's; named after the directory above it, or above
the package directory), one
against those sources, all side by side: an ``extern "C"``
entry that builds its arguments as ``csrc/semiring_gemm.cu`` does and
launches B3's scalar tile (``simt_gemm.cuh``, through ``launch_simt``) or,
where the sources have one, its packed tile (``packed_gemm.cuh``, through
``dispatch_packed``).  Then, for each case of ``CASES`` at 4096^3 on seeded
operands (U(-1, 1) floats, integers over their range), counts the outputs
whose bits differ from the first library's scalar tile and times every
(library, route) on CUDA events in turns, the order reversed every other
round (parent, change, change, parent), beside the bound
(``ChipSpec.vpu_ops_for``); a plus_times case also times, in the same
turns, the library calls that compute it: ``torch.matmul`` on the
operands and, for a 16-bit type, on their fp32 copies.

``--probe``: the card's rates and the packed route's premise, from
``csrc/b3_probe.cu`` (:func:`issue_rates`, :func:`pair_checks`; phases 36a
and 36b of ``chip_smoke.py`` run the same).  ``--sass``: each built
kernel's instruction counts from ``cuobjdump -sass`` (:func:`sass_counts`).
Needs the card and ``chip_smoke.py`` at the repository root
(``nvidia_smi``).
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from gemm_hls_tpu_torch import _build

REPO = Path(__file__).resolve().parents[2]
N = 4096
# (dtype, semiring) at N^3: every packed (type, semiring), then the
# controls: rows no route of this tool's changes should move.
CASES = tuple((dt, sr) for dt in ("float16", "bfloat16")
              for sr in ("min_plus", "max_plus", "max_min", "min_max", "max_times")) + (
    ("float16", "plus_times"), ("float32", "min_plus"), ("float32", "max_min"),
    ("uint32", "max_min"), ("int32", "min_plus"), ("int32", "max_min"), ("int8", "min_plus"))
# csrc/semiring_ops.cuh's Op codes.
OPS = {"plus_times": 0, "min_plus": 1, "max_plus": 2, "max_min": 3, "min_max": 4,
       "max_times": 5}
CODES = {"float32": 0, "bfloat16": 1, "float16": 2, "int8": 3, "int32": 4, "uint32": 9}

_SOURCE = """// B3's tiles as csrc/semiring_gemm.cu launches them.
#include "semiring_ops.cuh"
#if __has_include("packed_gemm.cuh")
#include "packed_gemm.cuh"
#define AB_PACKED 1
#endif

using namespace gemm_hls;

template <typename TIn, typename Acc>
static int ab_scalar(int op, const Gemm& g, cudaStream_t s) {
  switch (op) {
    case kPlusTimes: return launch_simt<TIn, Acc, PlusTimes<Acc>>(g, 1, s);
    case kMinPlus: return launch_simt<TIn, Acc, MinPlus<Acc>>(g, 1, s);
    case kMaxPlus: return launch_simt<TIn, Acc, MaxPlus<Acc>>(g, 1, s);
    case kMaxMin: return launch_simt<TIn, Acc, MaxMin<Acc>>(g, 1, s);
    case kMinMax: return launch_simt<TIn, Acc, MinMax<Acc>>(g, 1, s);
    case kMaxTimes: return launch_simt<TIn, Acc, MaxTimes<Acc>>(g, 1, s);
    default: return kUnsupported;
  }
}

extern "C" int ab_semiring(const void* a, const void* b, void* c, int M, int N, int K,
                           int in_code, int op, int packed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Gemm g{a, b, c, M, N, K, K, N, 0, 0, 0, 0, 0, 0, in_code,
               EpArgs{nullptr, nullptr, 0, kEpNone}};
  if (packed) {
#ifdef AB_PACKED
    if (in_code == kF16) return dispatch_packed<__half>(op, g, 1, s);
    if (in_code == kBF16) return dispatch_packed<__nv_bfloat16>(op, g, 1, s);
#endif
    return kUnsupported;
  }
  switch (in_code) {
    case kF32: return ab_scalar<float, float>(op, g, s);
    case kF16: return ab_scalar<__half, float>(op, g, s);
    case kBF16: return ab_scalar<__nv_bfloat16, float>(op, g, s);
    case kI32: return ab_scalar<int, int>(op, g, s);
    case kU32: return op == kMaxMin ? launch_simt<unsigned, int, MaxMin<int>>(g, 1, s)
                                    : kUnsupported;
    case kI8: return op == kMinPlus ? launch_simt<signed char, int, MinPlus<int>>(g, 1, s)
                                    : kUnsupported;
    default: return kUnsupported;
  }
}
"""

# csrc/b3_probe.cu's throughput loops, in its Seq order: (name, what a lane
# does a step: "results" of one instruction, or "terms" of one sequence,
# and how many, the instructions of a step).
SEQUENCES = (
    ("FADD", "results", 1, "add.rn.f32"),
    ("FFMA", "results", 1, "fma.rn.f32"),
    ("FMNMX", "results", 1, "min.NaN.f32"),
    ("IMNMX", "results", 1, "min.s32"),
    ("IMAD", "results", 1, "mad.lo.s32"),
    ("VIADDMNMX", "results", 1, "__viaddmin_s32"),
    ("VIMNMX3", "results", 1, "__vimax3_s32"),
    ("HADD2", "results", 2, "add.rn.f16x2"),
    ("HMUL2", "results", 2, "mul.rn.f16x2"),
    ("HMNMX2", "results", 2, "min.NaN.f16x2"),
    ("HADD2.BF16", "results", 2, "add.rn.bf16x2"),
    ("HMUL2.BF16", "results", 2, "mul.rn.bf16x2"),
    ("HMNMX2.BF16", "results", 2, "min.NaN.bf16x2"),
    ("MUFU.EX2", "results", 1, "ex2.approx.ftz.f32"),
    ("MUFU.LG2", "results", 1, "lg2.approx.ftz.f32"),
    ("fp32 min_plus", "terms", 1, "FADD, FMNMX"),
    ("fp32 max_min", "terms", 1, "FMNMX, FMNMX"),
    ("fp32 max_times", "terms", 1, "FMUL, FMNMX"),
    ("int32 min_plus", "terms", 1, "VIADDMNMX"),
    ("int32 max_min", "terms", 1, "IMNMX, IMNMX"),
    ("int32 max_min, 3-input max", "terms", 2, "IMNMX, IMNMX, VIMNMX3"),
    ("int32 max_times", "terms", 1, "IMUL, IMNMX"),
    ("float16 min_plus packed", "terms", 2, "HADD2, HMNMX2"),
    ("float16 max_min packed", "terms", 2, "HMNMX2, HMNMX2"),
    ("float16 max_times packed", "terms", 2, "HMUL2, HMNMX2"),
    ("bfloat16 min_plus packed", "terms", 2, "HADD2.BF16, HMNMX2.BF16"),
    ("bfloat16 max_min packed", "terms", 2, "HMNMX2.BF16, HMNMX2.BF16"),
    ("bfloat16 max_times packed", "terms", 2, "HMUL2.BF16, HMNMX2.BF16"),
)
# csrc/b3_probe.cu's pair checks: (type, instruction, PairOp code).
PAIR_OPS = tuple((dt, op, code) for dt in ("float16", "bfloat16")
                 for code, op in enumerate(("add", "mul", "min", "max")))
_RATE_ITERS, _RATE_CHAINS, _RATE_UNROLL, _RATE_THREADS = 2048, 8, 4, 1024


def issue_rates(lib):
    """{name: (per clock an SM, what)} for every ``SEQUENCES`` loop: results
    (terms) a lane a step x steps x 1024 threads over the median block's SM
    clocks, one block an SM on every SM."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sink = torch.zeros(sms * _RATE_THREADS, dtype=torch.int32, device="cuda")
    clocks = torch.zeros(sms, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for seq, (name, what, per_step, _) in enumerate(SEQUENCES):
        for rep in range(2):  # the first launch warms up
            _build.check(lib.b3_issue_rate(seq, sms, _RATE_ITERS, 0x1234 + rep, sink.data_ptr(),
                                           clocks.data_ptr(), stream), f"b3_issue_rate[{name}]")
        torch.cuda.synchronize()
        cycles = statistics.median(clocks.tolist())
        work = _RATE_THREADS * _RATE_ITERS * _RATE_UNROLL * _RATE_CHAINS * per_step
        out[name] = (work / cycles, what)
    return out


def pair_checks(lib):
    """{(type, instruction): (differing, NaN payloads apart, first)} over all
    2^32 pairs: results whose bits differ from the scalar tile's fp32 term
    rounded to the type (both NaN excepted), those both NaN with other
    bits, and the least (a << 16 | b) of a differing one (None)."""
    out = torch.empty(3, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for dt, op, code in PAIR_OPS:
        _build.check(lib.b3_pair_check(int(dt == "bfloat16"), code, out.data_ptr(), stream),
                     f"b3_pair_check[{dt} {op}]")
        bad, nan_bits, first = out.tolist()
        res[dt, op] = (bad, nan_bits, None if first == -1 else first)
    return res


def _nvcc_jobs(out_dir: Path, sources):
    """Start one ``nvcc -shared`` a (name, csrc directory, .cu) in
    ``sources``; returns {name: (library path, process)}."""
    nvcc = _build._nvcc()
    jobs = {}
    for name, csrc, cu in sources:
        so = out_dir / f"lib{name}.so"
        jobs[name] = (so, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-I", str(csrc), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return jobs


def build(others, probe: bool):
    """({name | "change" | "probe": (CDLL, path)}, {name: ptxas lines}),
    built side by side; ``others`` maps a name to a csrc directory."""
    out_dir = _build.BUILD_DIR / "b3_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "ab_semiring.cu"
    cu.write_text(_SOURCE)
    sources = [(name, csrc, cu) for name, csrc in others.items()]
    sources.append(("change", _build.CSRC_DIR, cu))
    if probe:
        sources.append(("probe", _build.CSRC_DIR, _build.CSRC_DIR / "b3_probe.cu"))
    libs, reports = {}, {}
    for name, (so, proc) in _nvcc_jobs(out_dir, sources).items():
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{text[-4000:]}")
        reports[name] = [ln.strip() for ln in text.splitlines()
                         if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        lib = ctypes.CDLL(str(so))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        if name == "probe":
            lib.b3_issue_rate.restype = lib.b3_pair_check.restype = i32
            lib.b3_issue_rate.argtypes = [i32, i32, i32, ctypes.c_uint, vp, vp, vp]
            lib.b3_pair_check.argtypes = [i32, i32, vp, vp]
        else:
            lib.ab_semiring.restype = i32
            lib.ab_semiring.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, i32, vp]
        libs[name] = (lib, so)
    return libs, reports


def sass_counts(so: Path, pattern: str = r"simt_gemm_kernel|packed_gemm_kernel"):
    """{function: Counter of SASS opcodes (width suffixes of loads and stores
    kept)} of the functions in ``so`` whose mangled name matches
    ``pattern``, from ``cuobjdump -sass``; {} where the toolkit has no
    cuobjdump."""
    tool = shutil.which("cuobjdump") or str(Path(_build._nvcc()).with_name("cuobjdump"))
    if not Path(tool).exists():
        return {}
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            fn = head.group(1) if re.search(pattern, head.group(1)) else None
            if fn:
                counts[fn] = collections.Counter()
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if fn and ins:
            op = ins.group(1)
            base = op.split(".")[0]
            keep = base in ("LDS", "STS", "LDG", "STG", "LDGSTS") or op.startswith("HMNMX2") \
                or op.startswith("HADD2") or op.startswith("HMUL2")
            counts[fn][op if keep else base] += 1
    return counts


def semiring(lib, dt, sr, a, b, packed=False):
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=a.dtype, device="cuda")
    rc = lib.ab_semiring(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, CODES[dt], OPS[sr],
                         int(packed), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"ab_semiring[{dt} {sr}{' packed' if packed else ''}]")
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


def operand(dt, gen, n=N):
    if dt == "uint32":
        return torch.randint(0, 2 ** 32, (n, n), generator=gen, device="cuda",
                             dtype=torch.int64).to(torch.uint32)
    if dt == "int32":
        return torch.randint(-2 ** 31, 2 ** 31, (n, n), generator=gen, device="cuda",
                             dtype=torch.int64).to(torch.int32)
    if dt == "int8":
        return torch.randint(-128, 128, (n, n), generator=gen, device="cuda",
                             dtype=torch.int8)
    return (torch.rand((n, n), generator=gen, device="cuda") * 2 - 1).to(getattr(torch, dt))


def run(libs, cases=CASES):
    """[{dtype, semiring, ms: {variant: ms}, differing: {variant: n}, bound_ms}]."""
    from gemm_hls_tpu_torch.models.perf_model import H100
    gen = torch.Generator(device="cuda").manual_seed(2727)
    rows = []
    for dt, sr in cases:
        a, b = operand(dt, gen), operand(dt, gen)
        variants = {}
        for name, (lib, _) in libs.items():
            if name == "probe":
                continue
            variants[f"{name} simt"] = (lambda lib=lib: semiring(lib, dt, sr, a, b))
            try:
                semiring(lib, dt, sr, a, b, packed=True)
            except NotImplementedError:
                continue
            variants[f"{name} packed"] = (lambda lib=lib: semiring(lib, dt, sr, a, b, True))
        first = next(iter(variants))
        ref = variants[first]()
        differing = {}
        for name, fn in variants.items():
            got = fn()
            view = torch.int16 if got.element_size() == 2 else (
                torch.int8 if got.element_size() == 1 else torch.int32)
            differing[name] = int((got.view(view) != ref.view(view)).sum())
        if sr == "plus_times":  # the library calls of the same product, timed beside
            variants[f"torch.matmul {dt}"] = lambda: torch.matmul(a, b)
            if a.element_size() == 2:
                af, bf = a.float(), b.float()
                variants["torch.matmul float32"] = lambda: torch.matmul(af, bf)
        t = turns(variants)
        bound_s, _ = H100.bound(2.0 * N ** 3, H100.vpu_ops_for(dt, sr, dt),
                                3 * N * N * a.element_size())
        rows.append(dict(dtype=dt, semiring=sr, ms=t, differing=differing,
                         bound_ms=bound_s * 1e3))
        print(f"b3_ab: {dt} {sr} {N}^3: " + ", ".join(
            f"{k} {v:.3f} ms ({bound_s * 1e3 / v:.1%} of the bound)" for k, v in t.items())
            + f"; bound {bound_s * 1e3:.3f} ms; outputs whose bits differ from {first}: "
            + ", ".join(f"{k} {v}" for k, v in differing.items() if k != first), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent_csrc", type=Path, nargs="*",
                    help="an earlier checkout's (or a variant's) csrc directory")
    ap.add_argument("--probe", action="store_true",
                    help="the instruction rates and the exhaustive pair checks")
    ap.add_argument("--sass", action="store_true", help="SASS opcode counts of the tiles")
    ap.add_argument("--cases", default="all",
                    help="comma-separated dtype:semiring cases, or all")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("b3_ab: no CUDA device", file=sys.stderr)
        return 2
    others = {}
    for csrc in args.parent_csrc:
        if not (csrc / "semiring_ops.cuh").is_file():
            print(f"b3_ab: no semiring_ops.cuh in {csrc}", file=sys.stderr)
            return 2
        above = [d.name for d in csrc.resolve().parents if d.name != "gemm_hls_tpu_torch"]
        others[above[0]] = csrc.resolve()
    cases = CASES if args.cases == "all" else tuple(
        tuple(c.split(":")) for c in args.cases.split(","))
    sys.path.insert(0, str(REPO))
    import chip_smoke
    print(f"b3_ab: {chip_smoke.nvidia_smi()}", flush=True)
    t0 = time.perf_counter()
    libs, reports = build(others, args.probe)
    print(f"b3_ab: built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, lines in reports.items():
        print(f"b3_ab: {name} ptxas:" + "".join(f"\n  {ln}" for ln in lines), flush=True)
    if args.probe:
        lib = libs["probe"][0]
        for name, (rate, what) in issue_rates(lib).items():
            print(f"b3_ab: rate {name}: {rate:.2f} {what} a clock an SM", flush=True)
        for (dt, op), (bad, nan_bits, first) in pair_checks(lib).items():
            print(f"b3_ab: pairs {dt} {op}: {bad} differ, {nan_bits} NaN payloads apart"
                  + ("" if first is None else f", first a=0x{first >> 16:04x} "
                                              f"b=0x{first & 0xffff:04x}"), flush=True)
    if args.sass:
        for name, (_, so) in libs.items():
            if name == "probe":
                continue
            for fn, cnt in sass_counts(so).items():
                print(f"b3_ab: sass {name} {fn}: {sum(cnt.values())} instructions; "
                      + ", ".join(f"{op} {c}" for op, c in cnt.most_common(24)), flush=True)
    run(libs, cases)
    return 0


if __name__ == "__main__":
    sys.exit(main())
