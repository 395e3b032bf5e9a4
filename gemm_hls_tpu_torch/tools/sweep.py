"""Configuration sweep manager: the port of ``gemm_hls_tpu/tools/sweep.py``
(the reference's ``build_manager.py``).

The reference scans cartesian products of build configurations, classifies
each build's outcome (``scripts/build_manager.py:351-396``), benchmarks the
survivors with timeout and retry (:611-669) and extracts the results to
CSV (:578-608).  On the card a "build" is the one ``nvcc`` build of
``csrc/`` (``_build.py``), and a configuration is a :class:`GemmConfig`:
its blocks name a compiled tile, so a sweep over blocks finds which tiles
exist and how fast each route runs.  The taxonomy keeps the reference's
status names, so CSVs from both packages merge:

* ``invalid_config``    -- ``validate`` refused it (a tile no kernel is
  compiled for);
* ``vmem_overflow``     -- the tile's shared memory is above
  ``SMEM_LIMIT_BYTES``, or CUDA reported "too many resources requested"
  or ran out of memory;
* ``compile_failed``    -- ``_build`` / ``nvcc`` failed;
* ``wrong_result``      -- the result failed verification against the host
  oracle;
* ``unreliable_timing`` -- the reading stayed above the card's peak;
* ``crashed``, ``timeout`` -- anything else, and the wall-clock limit;
* ``ok``                -- verified and timed (CUDA events), with seconds
  and GOp/s.

CLI (on the card):
    python -m gemm_hls_tpu_torch.tools.sweep --m 4096 --n 4096 --k 4096 \\
        --dtype bfloat16 --block-n 128,256 --block-k 32,64
    # config products (dtype x semiring x precision):
    python -m gemm_hls_tpu_torch.tools.sweep --m 2048 --n 2048 --k 2048 \\
        --dtype float32 --semiring plus_times,min_plus
    # merge result CSVs harvested on different machines or runs, the JAX
    # package's included:
    python -m gemm_hls_tpu_torch.tools.sweep merge a.csv b.csv -o all.csv
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import io
import itertools
import json
import os
import subprocess
import sys
import traceback
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from gemm_hls_tpu_torch.config import SMEM_LIMIT_BYTES, GemmConfig

# The package's parent directory, on the child interpreters' path.
_ROOT = str(Path(__file__).resolve().parents[2])


@dataclasses.dataclass
class SweepResult:
    """One configuration's outcome (``scripts/build_manager.py:210-213``'s
    ``Consumption`` row)."""

    config: GemmConfig
    status: str
    seconds: Optional[float] = None
    gflops: Optional[float] = None
    max_rel_err: Optional[float] = None
    detail: str = ""
    # Problem dims, so merged CSVs say which rows are comparable.
    m: Optional[int] = None
    n: Optional[int] = None
    k: Optional[int] = None

    CSV_COLS = ("m", "n", "k", "dtype", "semiring", "block_m", "block_n",
                "block_k", "precision", "status", "seconds", "gflops",
                "max_rel_err", "detail")

    def csv_row(self) -> Dict:
        # Six significant digits: a resumed reading compares at rel 1e-5
        # whatever its size (the reference's two decimals lose a reading
        # under 1 GOp/s).
        return {
            "m": self.m if self.m is not None else "",
            "n": self.n if self.n is not None else "",
            "k": self.k if self.k is not None else "",
            "dtype": self.config.dtype,
            "semiring": self.config.semiring,
            "block_m": self.config.block_m,
            "block_n": self.config.block_n,
            "block_k": self.config.block_k,
            "precision": self.config.precision,
            "status": self.status,
            "seconds": f"{self.seconds:.6g}" if self.seconds else "",
            "gflops": f"{self.gflops:.6g}" if self.gflops else "",
            "max_rel_err": f"{self.max_rel_err:.3e}"
                           if self.max_rel_err is not None else "",
            "detail": self.detail[:200],
        }


def _classify_exception(e: BaseException) -> str:
    low = f"{type(e).__name__}: {e}".lower()
    if ("too many resources requested" in low or "out of memory" in low
            or "shared memory" in low):
        return "vmem_overflow"
    if "nvcc" in low:
        return "compile_failed"
    return "crashed"


def expand_grid(**axes: Sequence) -> List[Dict]:
    """Cartesian product of configuration axes
    (``build_manager.py:417-431``)."""
    keys = list(axes)
    return [dict(zip(keys, vals))
            for vals in itertools.product(*(axes[k] for k in keys))]


class _Timeout(BaseException):
    """The in-process timeout.  A ``BaseException``, so no ``except
    Exception`` around the timed call (``_run_one_inner``'s taxonomy)
    reads it as a crash."""


@contextlib.contextmanager
def _alarm(seconds: Optional[float]):
    """SIGALRM wall-clock timeout (main thread only) around an in-process
    run (``build_manager.py:649-669``).  Yields a list the handler appends
    to when the alarm fires: an alarm whose exception was swallowed (one
    that lands in a gc callback is printed as "Exception ignored" and
    lost) still shows there, and ``run_one`` reads it after each attempt."""
    import signal
    fired = []
    if not seconds or not hasattr(signal, "SIGALRM"):
        yield fired
        return

    def handler(signum, frame):
        fired.append(signum)
        raise _Timeout(f"exceeded {seconds}s")

    old = signal.signal(signal.SIGALRM, handler)
    try:
        signal.setitimer(signal.ITIMER_REAL, seconds)
        yield fired
    finally:
        try:
            signal.setitimer(signal.ITIMER_REAL, 0)
        finally:
            signal.signal(signal.SIGALRM, old)


def _child_main(payload_json: str) -> int:
    """Entry point of one isolated sweep child (a fresh interpreter, no
    jax): reads a JSON work order, prints one JSON result line.  Invoked as
    ``python -m gemm_hls_tpu_torch.tools.sweep --child '<json>'``."""
    p = json.loads(payload_json)
    try:
        if p.get("setup_code"):
            # The configure.sh hook (build_manager.py:224-234); also the
            # fault-injection point of the isolation tests.
            exec(p["setup_code"], {"__name__": "__sweep_child_setup__"})
        res = _run_one_inner(GemmConfig(**p["cfg"]), p["m"], p["n"], p["k"],
                             verify=p["verify"], iters=p["iters"],
                             backend=p.get("backend"), device=p.get("platform"))
        out = {"status": res.status, "seconds": res.seconds,
               "gflops": res.gflops, "max_rel_err": res.max_rel_err,
               "detail": res.detail}
    except Exception as e:  # noqa: BLE001 - the taxonomy happens here
        out = {"status": _classify_exception(e),
               "detail": f"{type(e).__name__}: {e}"[:500]}
    print("SWEEP_RESULT " + json.dumps(out), flush=True)
    return 0


def _spawn_child(cfg: GemmConfig, m, n, k, *, verify, iters, backend,
                 platform, setup_code):
    """One configuration in a fresh interpreter: a crash (even a segfault)
    or a hang is classified and the scan goes on."""
    payload = json.dumps({
        "cfg": dataclasses.asdict(cfg), "m": m, "n": n, "k": k,
        "verify": verify, "iters": iters, "backend": backend,
        "platform": platform, "setup_code": setup_code,
    })
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(x for x in (_ROOT, env.get("PYTHONPATH")) if x)
    return subprocess.Popen(
        [sys.executable, "-m", "gemm_hls_tpu_torch.tools.sweep", "--child",
         payload],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def _reap_child(cfg: GemmConfig, proc,
                timeout_s: Optional[float]) -> SweepResult:
    try:
        stdout, stderr = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        # Hard wall-clock kill (build_manager.py:649-669).
        proc.kill()
        proc.communicate()
        return SweepResult(cfg, "timeout", detail=f"killed after {timeout_s}s")
    payload = None
    for line in (stdout or "").splitlines():
        if line.startswith("SWEEP_RESULT "):
            payload = json.loads(line[len("SWEEP_RESULT "):])
    if payload is None:
        tail = (stderr or "").strip().splitlines()[-1:] or [""]
        return SweepResult(
            cfg, "crashed",
            detail=f"subprocess died (exit {proc.returncode}) {tail[0]}"[:200])
    return SweepResult(cfg, payload["status"], seconds=payload.get("seconds"),
                       gflops=payload.get("gflops"),
                       max_rel_err=payload.get("max_rel_err"),
                       detail=payload.get("detail", ""))


def run_one(cfg: GemmConfig, m: int, n: int, k: int, *, verify: bool = True,
            iters: int = 5, backend: Optional[str] = None,
            timeout_s: Optional[float] = None,
            retries: int = 0, isolation: str = "none",
            platform: Optional[str] = None,
            setup_code: Optional[str] = None) -> SweepResult:
    """Build, verify and time one configuration, with timeout and retry
    (``build_manager.py:611-669``).

    ``isolation="process"`` runs it in a child interpreter with a hard
    wall-clock kill.  ``setup_code`` runs in the child first.  ``platform``
    is the device type the run takes ("cuda", the default, or "cpu": the
    plain versions, verified but not timed, since a CPU time is no reading
    of the card).  ``iters=0`` skips the timing."""
    def stamp(res):
        res.m, res.n, res.k = m, n, k
        return res

    last = None
    for _ in range(retries + 1):
        if isolation == "process":
            proc = _spawn_child(cfg, m, n, k, verify=verify,
                                iters=iters, backend=backend,
                                platform=platform, setup_code=setup_code)
            res = _reap_child(cfg, proc, timeout_s)
            if res.status != "timeout":
                return stamp(res)
            last = res
            continue
        try:
            with _alarm(timeout_s) as fired:
                res = _run_one_inner(cfg, m, n, k, verify=verify,
                                     iters=iters, backend=backend,
                                     device=platform)
            if not fired:
                return stamp(res)
            last = SweepResult(cfg, "timeout", detail=f"exceeded {timeout_s}s")
        except _Timeout as e:
            last = SweepResult(cfg, "timeout", detail=str(e))
    return stamp(last)


def _run_one_inner(cfg: GemmConfig, m: int, n: int, k: int, *,
                   verify: bool, iters: int, backend: Optional[str],
                   device: Optional[str] = None) -> SweepResult:
    import torch

    from gemm_hls_tpu_torch.models.perf_model import detect_chip
    from gemm_hls_tpu_torch.ops.matmul import matmul
    from gemm_hls_tpu_torch.ops.semiring import get_semiring
    from gemm_hls_tpu_torch.utils.benchmark import gflops, time_fn
    from gemm_hls_tpu_torch.utils.verify import (
        check_result, make_operands, reference_matmul, tolerance_for,
    )

    device = device or "cuda"
    try:
        cfg.validate()
        if cfg.smem_bytes() > SMEM_LIMIT_BYTES:
            return SweepResult(cfg, "vmem_overflow", detail=(
                f"tile config needs {cfg.smem_bytes()} B of shared memory "
                f"(> {SMEM_LIMIT_BYTES} B per block)"))
        cfg.validate(strict_alignment=backend != "torch")
    except ValueError as e:
        return SweepResult(cfg, "invalid_config", detail=str(e))

    sr = get_semiring(cfg.semiring)
    a, b = make_operands(m, n, k, cfg.dtype, transpose_a=cfg.transpose_a,
                         transpose_b=cfg.transpose_b)
    x, y = (torch.from_numpy(v).to(device=device, dtype=cfg.tdtype) for v in (a, b))

    def fn():
        return matmul(x, y, semiring=sr, config=cfg, backend=backend)

    try:
        out = fn()
        if out.is_cuda:
            torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 - the taxonomy, like the log regexes
        return SweepResult(cfg, _classify_exception(e),
                           detail=traceback.format_exception_only(e)[-1].strip())

    err = None
    if verify:
        # The oracle reads the operands as the kernel does (bf16 rounded).
        host = [v.cpu().double().numpy() if v.is_floating_point() else v.cpu().numpy()
                for v in (x, y, out)]
        exp = reference_matmul(host[0], host[1], semiring=sr.name,
                               transpose_a=cfg.transpose_a, transpose_b=cfg.transpose_b)
        ok, err = check_result(host[2], exp, rtol=tolerance_for(out.dtype))
        if not ok:
            return SweepResult(cfg, "wrong_result", max_rel_err=err)
    if not iters or torch.device(device).type != "cuda":
        return SweepResult(cfg, "ok", max_rel_err=err,
                           detail="" if iters else "not timed (iters=0)")

    # A reading above the card's peak is measured twice more, then
    # published as unreliable_timing, not as a record.
    ceiling = None
    if sr.is_mxu:
        chip = detect_chip(device)
        ceiling = chip.peak_for("int8" if cfg.precision.startswith("i8x")
                                else cfg.dtype)
    try:
        secs = time_fn(fn, [()], iters=iters, warmup=1)
        retries = 2
        while ceiling and gflops(m, n, k, secs) * 1e9 > ceiling and retries:
            secs = time_fn(fn, [()], iters=iters, warmup=1)
            retries -= 1
    except Exception as e:  # noqa: BLE001
        return SweepResult(cfg, _classify_exception(e),
                           detail=traceback.format_exception_only(e)[-1].strip())
    if ceiling and gflops(m, n, k, secs) * 1e9 > ceiling:
        return SweepResult(cfg, "unreliable_timing", seconds=secs,
                           gflops=gflops(m, n, k, secs), max_rel_err=err)
    return SweepResult(cfg, "ok", seconds=secs, gflops=gflops(m, n, k, secs),
                       max_rel_err=err)


def _config_key(cfg: GemmConfig) -> tuple:
    return (cfg.dtype, cfg.semiring, cfg.block_m, cfg.block_n, cfg.block_k,
            cfg.precision)


def _load_checkpoint(path: str) -> Dict[tuple, Dict]:
    done = {}
    if not os.path.exists(path):
        return done
    with open(path) as f:
        for row in csv.DictReader(f):
            key = (row["dtype"], row["semiring"], int(row["block_m"]),
                   int(row["block_n"]), int(row["block_k"]), row["precision"])
            done[key] = row
    return done


def sweep(grid: List[Dict], m: int, n: int, k: int, *, base: Optional[GemmConfig] = None,
          verify: bool = True, iters: int = 5, progress: bool = False,
          checkpoint_csv: Optional[str] = None,
          timeout_s: Optional[float] = None,
          retries: int = 0, isolation: str = "none",
          backend: Optional[str] = None, platform: Optional[str] = None,
          workers: int = 1,
          setup_code: Optional[str] = None) -> List[SweepResult]:
    """Run every configuration in ``grid`` (dicts of GemmConfig overrides).

    ``checkpoint_csv``: append each result as it completes and skip
    configurations already there (``build_manager.py:224-307``'s resume).

    ``isolation="process"``: each configuration in its own child
    interpreter, up to ``workers`` at once (``build_manager.py:417-431``'s
    pool).  Children on one card share it, so their readings overlap in
    time where ``workers`` > 1.
    """
    base = base or GemmConfig()
    done = _load_checkpoint(checkpoint_csv) if checkpoint_csv else {}
    results: List[Optional[SweepResult]] = [None] * len(grid)
    pending = []  # (index, cfg) still to run

    def emit(i, res, cached=False):
        res.m, res.n, res.k = m, n, k
        results[i] = res
        if not cached and checkpoint_csv:
            new_file = not os.path.exists(checkpoint_csv)
            cols = SweepResult.CSV_COLS
            if not new_file:
                # Resume into a checkpoint of an older schema: its header.
                with open(checkpoint_csv) as f:
                    header = f.readline().strip()
                cols = header.split(",") if header else cols
            with open(checkpoint_csv, "a", newline="") as f:
                w = csv.DictWriter(f, fieldnames=cols, extrasaction="ignore")
                if new_file:
                    w.writeheader()
                w.writerow(res.csv_row())
        if progress:
            print(f"[{i + 1}/{len(grid)}] {grid[i]} -> {res.status}"
                  + (f" {res.gflops:.1f} GOp/s" if res.gflops else "")
                  + (" (cached)" if cached else ""))

    for i, overrides in enumerate(grid):
        cfg = base.replace(**overrides)
        key = _config_key(cfg)
        if key in done:
            row = done[key]
            emit(i, SweepResult(
                cfg, row["status"],
                seconds=float(row["seconds"]) if row["seconds"] else None,
                gflops=float(row["gflops"]) if row["gflops"] else None,
                detail=row.get("detail", "") + " [resumed]"), cached=True)
            continue
        pending.append((i, cfg))

    if isolation == "process" and workers > 1:
        # A window of running children, reaped in launch order.
        window = []  # (index, cfg, proc, retries_left)

        def reap_front():
            wi, wcfg, proc, tries = window.pop(0)
            res = _reap_child(wcfg, proc, timeout_s)
            if res.status == "timeout" and tries > 0:
                window.append((wi, wcfg,
                               _spawn_child(wcfg, m, n, k, verify=verify,
                                            iters=iters, backend=backend,
                                            platform=platform,
                                            setup_code=setup_code),
                               tries - 1))
                return
            emit(wi, res)

        for i, cfg in pending:
            while len(window) >= workers:
                reap_front()
            proc = _spawn_child(cfg, m, n, k, verify=verify,
                                iters=iters, backend=backend,
                                platform=platform, setup_code=setup_code)
            window.append((i, cfg, proc, retries))
        while window:
            reap_front()
    else:
        for i, cfg in pending:
            emit(i, run_one(cfg, m, n, k, verify=verify, iters=iters,
                            timeout_s=timeout_s, retries=retries,
                            isolation=isolation, backend=backend,
                            platform=platform, setup_code=setup_code))
    return results


def to_csv(results: List[SweepResult], path: Optional[str] = None) -> str:
    """Serialize like ``extract_benchmarks`` (``build_manager.py:578-608``)."""
    buf = io.StringIO()
    writer = csv.DictWriter(buf, fieldnames=SweepResult.CSV_COLS)
    writer.writeheader()
    for r in results:
        writer.writerow(r.csv_row())
    text = buf.getvalue()
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text


def best_result(results: List[SweepResult]) -> Optional[SweepResult]:
    ok = [r for r in results if r.status == "ok" and r.gflops]
    return max(ok, key=lambda r: r.gflops) if ok else None


def merge_csvs(paths: Sequence[str], out: Optional[str] = None) -> str:
    """Merge sweep / benchmark CSVs harvested on different machines or runs
    into one (the ``merge_files`` verb, ``build_manager.py:671-693,763-770``).

    Rows are keyed by (m, n, k, dtype, semiring, block_m, block_n, block_k,
    precision); duplicates collapse to the best evidence: an ``ok`` row
    beats any failure, and among ``ok`` rows the highest GOp/s wins.  Key
    columns absent in older CSVs (m / n / k) merge as blank and still
    collapse consistently."""
    keyed: Dict[tuple, Dict] = {}
    order: List[tuple] = []
    cols = list(SweepResult.CSV_COLS)
    for path in paths:
        with open(path, newline="") as f:
            reader = csv.DictReader(f)
            for row in reader:
                for c in (reader.fieldnames or []):
                    if c not in cols:
                        cols.append(c)
                key = tuple(row.get(c, "") for c in
                            ("m", "n", "k", "dtype", "semiring", "block_m",
                             "block_n", "block_k", "precision"))
                prev = keyed.get(key)
                if prev is None:
                    keyed[key] = row
                    order.append(key)
                    continue

                def rank(r):
                    ok = r.get("status") == "ok"
                    gf = float(r["gflops"]) if r.get("gflops") else 0.0
                    return (1 if ok else 0, gf)

                if rank(row) > rank(prev):
                    keyed[key] = row
    buf = io.StringIO()
    w = csv.DictWriter(buf, fieldnames=cols, restval="")
    w.writeheader()
    for key in order:
        w.writerow(keyed[key])
    text = buf.getvalue()
    if out:
        with open(out, "w") as f:
            f.write(text)
    return text


def _int_list(s: str) -> List[int]:
    return [int(x) for x in s.split(",")]


def _str_list(s: str) -> List[str]:
    return [x.strip() for x in s.split(",") if x.strip()]


def _default_blocks(dtype: str, semiring: str) -> Dict[str, List[int]]:
    """Block axes covering every compiled tile of the first dtype's routes
    (their cartesian product also names tiles no kernel has, which the
    taxonomy reports as invalid_config)."""
    from gemm_hls_tpu_torch.config import ENGINE_TILES, KERNEL_TILES, kernel_route

    tiles = [KERNEL_TILES[kernel_route(dtype, semiring)]]
    if semiring == "plus_times" and dtype in ENGINE_TILES:
        tiles.append(ENGINE_TILES[dtype])
    return {f"block_{ax}": sorted({t[i] for t in tiles})
            for i, ax in enumerate("mnk")}


def main(argv=None):
    args_in = list(argv) if argv is not None else sys.argv[1:]
    if args_in[:1] == ["--child"]:
        return _child_main(args_in[1])
    if args_in[:1] == ["merge"]:
        mp = argparse.ArgumentParser(
            prog="sweep merge",
            description="Merge sweep CSVs from different machines or runs "
                        "(the reference's merge_files).")
        mp.add_argument("csvs", nargs="+", help="input CSV paths")
        mp.add_argument("-o", "--out", default=None, help="merged CSV path")
        margs = mp.parse_args(args_in[1:])
        text = merge_csvs(margs.csvs, margs.out)
        if not margs.out:
            print(text, end="")
        else:
            nrows = text.count("\n") - 1
            print(f"merged {len(margs.csvs)} files -> {margs.out} "
                  f"({nrows} unique configs)")
        return text
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--m", type=int, required=True)
    p.add_argument("--n", type=int, required=True)
    p.add_argument("--k", type=int, required=True)
    p.add_argument("--dtype", type=_str_list, default=["float32"],
                   help="comma list -> swept as a config-product axis")
    p.add_argument("--semiring", type=_str_list, default=["plus_times"],
                   help="comma list -> swept as a config-product axis")
    p.add_argument("--precision", type=_str_list, default=["high"],
                   help="comma list -> swept as a config-product axis")
    p.add_argument("--block-m", type=_int_list, default=None)
    p.add_argument("--block-n", type=_int_list, default=None)
    p.add_argument("--block-k", type=_int_list, default=None)
    p.add_argument("--no-verify", action="store_true")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--csv", default=None, help="output CSV path")
    p.add_argument("--checkpoint", default=None,
                   help="incremental CSV for crash/resume")
    p.add_argument("--timeout-s", type=float, default=None)
    p.add_argument("--retries", type=int, default=0)
    p.add_argument("--isolation", choices=("none", "process"), default="none",
                   help="'process' runs each config in its own subprocess "
                        "with a hard kill on timeout")
    p.add_argument("--workers", type=int, default=1,
                   help="concurrent isolated children (they share the card)")
    p.add_argument("--backend", default=None,
                   help="compute path passed to matmul (cuda / vpu / torch)")
    p.add_argument("--platform", default=None,
                   help="device type of the runs: cuda (default) or cpu")
    args = p.parse_args(args_in)

    defaults = _default_blocks(args.dtype[0], args.semiring[0])
    grid = expand_grid(block_m=args.block_m or defaults["block_m"],
                       block_n=args.block_n or defaults["block_n"],
                       block_k=args.block_k or defaults["block_k"],
                       dtype=args.dtype, semiring=args.semiring,
                       precision=args.precision)
    base = GemmConfig(dtype=args.dtype[0], semiring=args.semiring[0])
    results = sweep(grid, args.m, args.n, args.k, base=base,
                    verify=not args.no_verify, iters=args.iters, progress=True,
                    checkpoint_csv=args.checkpoint, timeout_s=args.timeout_s,
                    retries=args.retries, isolation=args.isolation,
                    workers=args.workers, backend=args.backend,
                    platform=args.platform)
    text = to_csv(results, args.csv)
    if not args.csv:
        print(text)
    best = best_result(results)
    if best:
        print(f"best: blocks ({best.config.block_m},{best.config.block_n},"
              f"{best.config.block_k}) -> {best.gflops:.1f} GOp/s")
    return results


if __name__ == "__main__":
    main()
