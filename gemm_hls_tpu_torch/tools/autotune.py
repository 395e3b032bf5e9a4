"""Problem-keyed tuner of the card's routes and launch plans, with a
persistent result cache: the port of ``gemm_hls_tpu/tools/autotune.py``.

On the TPU the tuner picks Pallas block shapes.  Every Hopper kernel here
is compiled for fixed tiles (``config.KERNEL_TILES``, ``ENGINE_TILES``,
``csrc/wgmma_tile.cuh``), so that search has no counterpart.  What a call
can choose at run time is the route and, on the tile engine, the launch
plan, and those are the knobs this tuner turns:

* dense ``plus_times`` (key ``chip/dtype/semiring/MxNxK[/layout]``): B1's
  route, the tile engine (``wgmma``) or WMMA (``wmma``; ``dmma`` for
  float64, ``simt`` for fp32 / int32, int16, the unsigned ints and every
  other semiring: one route each, so nothing to choose; a cached winner
  whose route cannot run the dtype is a miss).  The winner is a :class:`GemmConfig`
  whose blocks are that route's compiled tile (``config.route_tile``);
* batched (``.../Bbx MxNxK``): B2's route, the same two kernels;
* ``flash`` (dims (B, S_q, S_kv, D), tag ``causal`` / ``full``): the
  forward's route and the backward pair's (``wgmma`` / ``mma.sync``);
* ``dequant4`` / ``dequant8`` (dims (M, N, K), tag ``g<group>`` / ``chan``):
  B13's route and, on the engine, its plan (N tile, K splits);
* ``w8a8`` (the same dims and tags): B14 / B15's route and, on the
  engine, the N tile 128 / 64;
* ``grouped`` (dims (M, K, N, G)): B16's route.

Each candidate that can run the problem is checked against its plain
version once, then timed on CUDA events (``utils/benchmark.time_fn``, the
stream held while a window is queued, so a call's host cost does not hide
its kernel) in turns with the others, ``rounds`` times; the median wins and
is memoized per (chip, dtype, semiring, shape bucket) in a JSON cache under
the reference's keys, with its reading and the card's name.  The front
doors adopt a cached winner when the caller passes no config
(``ops/matmul.py``, ``ops/attention.py``, ``ops/quant.py``,
``ops/grouped.py``).  A tuned knob never changes what a call computes:
W8A8's semantic ``block_k`` and fused / two-pass rule, the quantized front
doors' ``block_k`` resolution and ``precision`` stay the front doors' own.

    from gemm_hls_tpu_torch.tools.autotune import autotune
    cfg = autotune(8192, 8192, 8192, dtype="bfloat16")
    c = matmul(a, b, config=cfg)

CLI (on the card):
    python -m gemm_hls_tpu_torch.tools.autotune 8192 8192 8192 --dtype bfloat16
    python -m gemm_hls_tpu_torch.tools.autotune 512 512 512 --batch 64
    python -m gemm_hls_tpu_torch.tools.autotune 32 1024 128 --family flash --causal --bwd
    python -m gemm_hls_tpu_torch.tools.autotune 64 2048 2048 --family int4 --group 128
    python -m gemm_hls_tpu_torch.tools.autotune 4096 2048 2048 --family w8a8
    python -m gemm_hls_tpu_torch.tools.autotune 8192 2048 4096 --family grouped --groups 8
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
from pathlib import Path
from typing import Callable, List, Optional

import torch

from gemm_hls_tpu_torch.config import GemmConfig, named_route, route_tile, torch_dtype

DEFAULT_CACHE = os.path.expanduser("~/.cache/gemm_hls_tpu_torch/autotune.json")
# Winners measured on the card and shipped with the package, consulted when
# the user cache misses, so ``matmul(a, b)`` adopts a measured route out of
# the box.  It holds H100 entries only.
SEED_CACHE = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "data", "autotune_seed.json")

# path -> ((mtime, size), parsed dict); lookups happen on every untuned front-door
# call, so the JSON is not re-read each time.
_load_memo: dict = {}

# B1 / B2 route names (ops/mxu.py::mxu_route) by the compiled tile a
# config's blocks name (GemmConfig.route), and back.
_MXU_ROUTE = {"wgmma": "wgmma", "tc": "wmma", "simt": "simt", "dmma": "dmma"}
_TILE_ROUTE = {v: k for k, v in _MXU_ROUTE.items()}


def _bucket(x: int) -> int:
    """Shape bucket: next power of two (winners generalize within a bucket)."""
    return 1 << (max(int(x), 1) - 1).bit_length()


def _key(chip: str, dtype: str, semiring: str, m: int, n: int, k: int,
         layout: str = "nn") -> str:
    """Cache key; ``layout`` is "nn"/"tn"/"nt"/"tt" (transpose_a/_b flags).
    The NN layout has no suffix, as in the reference."""
    base = f"{chip}/{dtype}/{semiring}/{_bucket(m)}x{_bucket(n)}x{_bucket(k)}"
    return base if layout == "nn" else f"{base}/{layout}"


def layout_of(transpose_a: bool, transpose_b: bool) -> str:
    return ("t" if transpose_a else "n") + ("t" if transpose_b else "n")


def _load(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}


def _store(path: str, data: dict):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    _load_memo.pop(path, None)


def _load_memoized(path: str) -> dict:
    try:
        st = os.stat(path)
    except OSError:
        return {}
    stamp = (st.st_mtime_ns, st.st_size)
    hit = _load_memo.get(path)
    if hit is not None and hit[0] == stamp:
        return hit[1]
    data = _load(path)
    _load_memo[path] = (stamp, data)
    return data


def _chip_name(device=None) -> Optional[str]:
    """The perf model's name of ``device``'s chip ("h100", "cpu"), or None
    for a card with neither an entry nor a calibration, and for a device
    that is neither a card nor the CPU (meta tensors): its lookups miss."""
    from gemm_hls_tpu_torch.models.perf_model import detect_chip

    if device is not None and torch.device(device).type not in ("cpu", "cuda"):
        return None
    try:
        return detect_chip(device).name
    except NotImplementedError:
        return None


def _entries(key_of: Callable[[str], str], cache_path: Optional[str], device) -> list:
    """The entries under ``key_of(chip)`` in the user cache, then the seed
    (none where neither file holds anything, before the chip is asked)."""
    caches = [c for c in (_load_memoized(cache_path or DEFAULT_CACHE),
                          _load_memoized(SEED_CACHE)) if c]
    chip = _chip_name(device) if caches else None
    if chip is None:
        return []
    key = key_of(chip)
    return [c[key] for c in caches if key in c]


def _runs(route: str, rule: str) -> bool:
    """Whether a launch takes ``route`` where the route rule gives ``rule``
    (``config.named_route``'s test, without the raise)."""
    try:
        named_route(route, rule, "")
    except ValueError:
        return False
    return True


def card_name(device=None) -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    ("NVIDIA H100 80GB HBM3, 700.00 W"), else torch's device name; "cpu"
    for the CPU."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cpu":
        return "cpu"
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={idx}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return torch.cuda.get_device_name(idx)


# ---------------------------------------------------------------------------
# Dense (2-D) winners: B1's route, as the config of its compiled tile
# ---------------------------------------------------------------------------

def _cfg_from_entry(e: dict, dtype: str, semiring: str,
                    layout: str = "nn") -> GemmConfig:
    return GemmConfig(dtype=dtype, semiring=semiring,
                      block_m=e["block_m"], block_n=e["block_n"],
                      block_k=e["block_k"],
                      transpose_a=layout[0] == "t",
                      transpose_b=layout[1] == "t")


def _pitches_aligned(dtype: str, *pitches: int) -> bool:
    """Whether rows of these lengths are whole 16-byte units: what a
    contiguous operand needs for a TMA map (its base is aligned)."""
    size = torch_dtype(dtype).itemsize
    return all(p * size % 16 == 0 for p in pitches)


def _dense_rule(dtype: str, semiring: str, layout: str, m: int, n: int,
                k: int, aligned) -> str:
    """The route rule's B1 / B2 kernel for these operands (``aligned``: a
    bool, a callable giving it, or None: contiguous operands of these
    dims)."""
    from gemm_hls_tpu_torch.ops.mxu import mxu_route

    if semiring != "plus_times":
        return "simt"
    ta, tb = layout[0] == "t", layout[1] == "t"
    if aligned is None:
        aligned = _pitches_aligned(dtype, m if ta else k, k if tb else n)
    elif callable(aligned):
        aligned = aligned()
    return mxu_route(torch_dtype(dtype), ta, tb, aligned)


def cached_winner(m: int, n: int, k: int, *, dtype: str,
                  semiring: str = "plus_times", layout: str = "nn",
                  cache_path: Optional[str] = None, aligned: Optional[bool] = None,
                  device=None):
    """(config, route) of the cached dense winner, or None: never measures.

    The user cache first, then the packaged seed.  An entry is a miss where
    its blocks are no route's compiled tile, where its route is not the one
    those blocks name, where the route rule cannot run that route on these
    operands (``aligned``: their 16-byte rows and bases, a bool or a
    callable asked only once an entry is found; None: contiguous operands
    of these dims), or where its tile pads the problem by more than 1.3x
    (the reference's guard)."""
    entries = _entries(lambda chip: _key(chip, dtype, semiring, m, n, k, layout),
                       cache_path, device)
    rule = None
    for e in entries:
        try:
            cfg = _cfg_from_entry(e, dtype, semiring, layout).validate(
                strict_alignment=True)
        except (KeyError, TypeError, ValueError):
            continue
        route = e.get("route", _MXU_ROUTE[cfg.route()])
        rule = rule or _dense_rule(dtype, semiring, layout, m, n, k, aligned)
        if _TILE_ROUTE.get(route) != cfg.route() or not _runs(route, rule):
            continue
        # Winners are keyed by power-of-two bucket: an off-bucket shape the
        # winner's tile pads by more than 1.3x keeps the route rule.
        mp, np_, kp = cfg.padded_shape(m, n, k)
        if mp * np_ * kp > 1.3 * m * n * k:
            continue
        return cfg, route
    return None


def cached_config(m: int, n: int, k: int, *, dtype: str,
                  semiring: str = "plus_times", layout: str = "nn",
                  cache_path: Optional[str] = None, aligned: Optional[bool] = None,
                  device=None) -> Optional[GemmConfig]:
    """Cached autotune winner for this problem, or None: never measures.

    The config's blocks are the winning route's compiled tile (the engine's
    names the engine; the front door names the route of the WMMA tile too,
    through :func:`cached_winner`).  Transposed layouts have their own
    buckets; the config carries the matching transpose flags.  The guards
    are :func:`cached_winner`'s."""
    hit = cached_winner(m, n, k, dtype=dtype, semiring=semiring, layout=layout,
                        cache_path=cache_path, aligned=aligned, device=device)
    return None if hit is None else hit[0]


def candidate_configs(m: int, n: int, k: int, dtype: str, semiring: str,
                      max_candidates: int = 6, layout: str = "nn",
                      aligned: Optional[bool] = None) -> List[GemmConfig]:
    """The configs whose routes can run this problem: for plus_times the
    route rule's (the tile engine where its maps describe the operands) and
    WMMA beside the engine; the CUDA-core tile for fp32 / int32 and every
    other semiring."""
    rule = _dense_rule(dtype, semiring, layout, m, n, k, aligned)
    routes = [rule] + (["wmma"] if rule == "wgmma" else [])
    return [GemmConfig(dtype=dtype, semiring=semiring,
                       block_m=bm, block_n=bn, block_k=bk,
                       transpose_a=layout[0] == "t", transpose_b=layout[1] == "t")
            for bm, bn, bk in (route_tile(_TILE_ROUTE[r], dtype)
                               for r in routes[:max_candidates])]


def _operands(shape_a, shape_b, dtype: str, device, seed: int = 5):
    """Seeded operands on the card: N(0, 1) floats, integers in [-3, 3]
    ([0, 3] unsigned)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    td = torch_dtype(dtype)
    if td.is_floating_point:
        draw = [torch.randn(s, generator=gen) for s in (shape_a, shape_b)]
    else:
        low = -3 if td.is_signed else 0
        draw = [torch.randint(low, 4, s, generator=gen) for s in (shape_a, shape_b)]
    return tuple(x.to(device=device, dtype=td) for x in draw)


def agreement(got, ref) -> float:
    """A candidate's error against its plain version: 0 for integers that
    agree exactly (inf where one differs); the normwise relative error
    ||got - ref|| / ||ref|| (Frobenius) for floating outputs, inf where one
    is not finite."""
    if not got.is_floating_point():
        return 0.0 if torch.equal(got, ref) else math.inf
    g, r = got.double(), ref.double()
    if not bool(torch.isfinite(g).all()):
        return math.inf
    return float(torch.linalg.vector_norm(g - r) / torch.linalg.vector_norm(r))


def tolerance(dtype) -> float:
    """The contract a tuned knob's result is held to against the plain
    version: rel 1e-3 normwise for fp32 outputs, exact for integers, and
    1e-2 normwise for 16-bit outputs, which hold 8 (bf16) or 11 (fp16) bits
    an element: the flash kernels, which round P to bf16 against a running
    row max where the plain version uses the final one, read 0.9e-3 to
    2.3e-3 normwise on both of their routes at (32, 1024, 128) (PERF.md
    §6), the repo's 1e-2 for bf16-rounded outputs (chip_smoke.py)."""
    if not dtype.is_floating_point:
        return 0.0
    return 1e-2 if dtype.itemsize == 2 else 1e-3


def _agrees(got, ref) -> bool:
    return agreement(got, ref) <= tolerance(got.dtype)


def _outputs_agree(got, ref) -> bool:
    got = got if isinstance(got, (tuple, list)) else (got,)
    ref = ref if isinstance(ref, (tuple, list)) else (ref,)
    return all(_agrees(g, r) for g, r in zip(got, ref))


def _timer(run: Callable, iters: int) -> Callable:
    """``measure(entry)``: one reading of ``run(entry)``'s seconds a call
    (``time_fn`` on CUDA events, the stream held while the window is
    queued)."""
    from gemm_hls_tpu_torch.utils.benchmark import time_fn

    return lambda e: time_fn(lambda: run(e), [()], iters=iters, warmup=1,
                             repeats=1, hold_stream=True)


def _ceiling(device, dtype: str) -> Optional[float]:
    """The chip's peak rate for ``dtype`` in GFLOP/s, or None."""
    from gemm_hls_tpu_torch.models.perf_model import detect_chip

    try:
        return (detect_chip(device).peak_for(dtype) or 0) / 1e9 or None
    except NotImplementedError:
        return None


def _measure(candidates, measure, flops: float, ceiling: Optional[float],
             rounds: int, verbose: bool, check=None):
    """The median-of-rounds loop shared by every tuner.

    ``candidates`` is a list of entry dicts; ``check(entry)`` (once, before
    the rounds) returns False, or raises, for one whose result disagrees
    with its plain version, and ``measure(entry)`` returns seconds a call
    and raises for one that cannot run.  The candidates are measured in
    turns, one reading each a round.  A reading above ``ceiling`` GFLOP/s
    is measured twice more and dropped if it stays impossible.  A candidate
    that fails in any round loses all its rounds (the reference's
    ``_tune_family`` guard; its ``autotune_batched`` kept partial medians).
    Returns (best entry or None, best GFLOP/s, best ms, report): the report
    has each candidate's entry, status and readings in ms."""
    report = [{"entry": dict(e), "status": "ok", "samples_ms": []} for e in candidates]
    for r in report:
        if check is None:
            continue
        try:
            if not check(r["entry"]):
                r["status"] = "wrong_result"
        except Exception as exc:  # noqa: BLE001 - a candidate that cannot run is dropped
            r["status"] = f"fail:{type(exc).__name__}"
            r["detail"] = str(exc)[:300]
    for _ in range(max(1, rounds)):
        for r in report:
            if r["status"] != "ok":
                continue
            try:
                secs = measure(r["entry"])
                retries = 2
                while ceiling and flops / secs / 1e9 > ceiling and retries:
                    secs = measure(r["entry"])
                    retries -= 1
            except Exception as exc:  # noqa: BLE001 - a candidate that cannot run is dropped
                # Discard earlier rounds too: an intermittently failing
                # candidate must not win on a lucky partial median.
                r.update(status=f"fail:{type(exc).__name__}", samples_ms=[],
                         detail=str(exc)[:300])
                continue
            if ceiling and flops / secs / 1e9 > ceiling:
                r["dropped"] = r.get("dropped", 0) + 1
                continue
            r["samples_ms"].append(secs * 1e3)
    best = None
    for r in report:
        if r["status"] == "ok" and not r["samples_ms"]:
            r["status"] = "unreliable_timing"
        if r["status"] == "ok":
            s = sorted(r["samples_ms"])
            r["ms"] = s[len(s) // 2]
            r["gflops"] = flops / (r["ms"] / 1e3) / 1e9
            if best is None or r["gflops"] > best["gflops"]:
                best = r
        if verbose:
            print(f"  {r['entry']} -> {r['status']}"
                  + (f" median {r['ms']:.4f} ms ({r['gflops']:.0f} GFLOP/s) of "
                     f"{[round(x, 4) for x in r['samples_ms']]} ms" if "ms" in r else "")
                  + (f" [{r['detail']}]" if "detail" in r else ""))
    if best is None:
        return None, None, None, report
    return dict(best["entry"]), best["gflops"], best["ms"], report


def _record(cache_path: str, key: str, best: dict, gf: float, ms: float, device,
            keep=()) -> dict:
    """Store a winner with its reading and the card's name; the named
    fields of an entry already there are kept."""
    cache = _load(cache_path)
    entry = {f: v for f, v in cache.get(key, {}).items() if f in keep}
    entry.update(best, gflops=round(gf, 1), ms=float(f"{ms:.5g}"),
                 card=card_name(device))
    cache[key] = entry
    _store(cache_path, cache)
    return entry


def _dense_gemm(a, b, cfg: GemmConfig, route: str):
    """One launch of the dense kernel of ``cfg``'s semiring on ``route``."""
    from gemm_hls_tpu_torch.ops import mxu, vpu
    from gemm_hls_tpu_torch.ops.semiring import get_semiring

    if cfg.semiring == "plus_times":
        return mxu.mxu_matmul(a, b, cfg=cfg, transpose_a=cfg.transpose_a,
                              transpose_b=cfg.transpose_b, route=route)
    return vpu.vpu_matmul(a, b, cfg=cfg, sr=get_semiring(cfg.semiring),
                          transpose_a=cfg.transpose_a, transpose_b=cfg.transpose_b)


def _dense_plain(a, b, cfg: GemmConfig):
    from gemm_hls_tpu_torch.ops import mxu, vpu
    from gemm_hls_tpu_torch.ops.semiring import get_semiring

    if cfg.semiring == "plus_times":
        return mxu.mxu_matmul_plain(a, b, cfg=cfg, transpose_a=cfg.transpose_a,
                                    transpose_b=cfg.transpose_b)
    return vpu.vpu_matmul_plain(a, b, cfg=cfg, sr=get_semiring(cfg.semiring),
                                transpose_a=cfg.transpose_a, transpose_b=cfg.transpose_b)


def autotune(m: int, n: int, k: int, *, dtype: str = "bfloat16",
             semiring: str = "plus_times", cache_path: str = DEFAULT_CACHE,
             iters: int = 5, rounds: int = 3, force: bool = False,
             verbose: bool = False, device="cuda") -> GemmConfig:
    """Best measured config for this problem (cached): the compiled tile of
    the fastest route that runs it (:func:`candidate_configs`), each
    candidate checked against its plain version once and measured
    ``rounds`` times in turns, scored by the median."""
    chip = _chip_name(device)
    if chip is None:
        raise NotImplementedError(f"no chip model for {device}: calibrate it first "
                                  "(python -m gemm_hls_tpu_torch.tools.calibrate)")
    key = _key(chip, dtype, semiring, m, n, k)
    cache = _load(cache_path)
    if key in cache and not force:
        return _cfg_from_entry(cache[key], dtype, semiring)
    a, b = _operands((m, k), (k, n), dtype, device)
    cands = [{"block_m": c.block_m, "block_n": c.block_n, "block_k": c.block_k,
              "route": _MXU_ROUTE[c.route()]}
             for c in candidate_configs(m, n, k, dtype, semiring)]

    def run(e):
        return _dense_gemm(a, b, _cfg_from_entry(e, dtype, semiring), e["route"])

    ref = _dense_plain(a, b, _cfg_from_entry(cands[0], dtype, semiring))
    ceiling = _ceiling(device, dtype) if semiring == "plus_times" else None
    best, gf, ms, report = _measure(cands, _timer(run, iters), 2.0 * m * n * k, ceiling,
                                    rounds, verbose, lambda e: _agrees(run(e), ref))
    autotune.last_report = report
    if best is None:
        raise RuntimeError(f"autotune: no feasible configuration for {key}")
    _record(cache_path, key, best, gf, ms, device)
    return _cfg_from_entry(best, dtype, semiring)


autotune.last_report = []


# ---------------------------------------------------------------------------
# Batched (3-D) problems: the TPU tuned the batched kernel's batch_block; the
# card's B2 walks a batch as the engine's steps, so its knob is B2's route.
# ---------------------------------------------------------------------------

def _key_batched(chip: str, dtype: str, semiring: str, bsz: int, m: int,
                 n: int, k: int) -> str:
    return (f"{chip}/{dtype}/{semiring}/"
            f"{_bucket(bsz)}bx{_bucket(m)}x{_bucket(n)}x{_bucket(k)}")


def _batched_key(chip, dtype, semiring, bsz, m, n, k, layout):
    key = _key_batched(chip, dtype, semiring, bsz, m, n, k)
    return key if layout == "nn" else f"{key}/{layout}"


def cached_batch_block(bsz: int, m: int, n: int, k: int, *, dtype: str,
                       semiring: str = "plus_times",
                       cache_path: Optional[str] = None, layout: str = "nn",
                       aligned: Optional[bool] = None, device=None) -> Optional[str]:
    """Cached B2 route for this 3-D problem ("wgmma", "wmma" or "simt"), or
    None: never measures.  Where the TPU's answer was a batch block (how
    many examples one grid step holds), the card's is the kernel that
    walks the batch, which the batched front door names to
    ``mxu_matmul_batched(..., route=)``.  The guards are
    :func:`cached_winner`'s: a route the rule cannot run on these operands,
    or whose tile pads (M, N, K) by more than 1.3x, is a miss."""
    rule = None
    for e in _entries(lambda chip: _batched_key(chip, dtype, semiring, bsz, m, n, k,
                                                layout), cache_path, device):
        route = e.get("route")
        if route not in _TILE_ROUTE:
            continue
        rule = rule or _dense_rule(dtype, semiring, layout, m, n, k, aligned)
        if not _runs(route, rule):
            continue
        try:
            bm, bn, bk = route_tile(_TILE_ROUTE[route], dtype)
        except KeyError:
            continue
        mp, np_, kp = GemmConfig(block_m=bm, block_n=bn, block_k=bk).padded_shape(m, n, k)
        if mp * np_ * kp > 1.3 * m * n * k:
            continue
        return route
    return None


def batch_block_candidates(bsz: int, m: int, n: int, k: int, dtype: str,
                           semiring: str = "plus_times", layout: str = "nn",
                           aligned: Optional[bool] = None) -> List[str]:
    """The B2 routes that can run this batched problem: the route rule's
    and, beside the engine, WMMA."""
    rule = _dense_rule(dtype, semiring, layout, m, n, k, aligned)
    return [rule] + (["wmma"] if rule == "wgmma" else [])


def autotune_batched(bsz: int, m: int, n: int, k: int, *,
                     dtype: str = "bfloat16", semiring: str = "plus_times",
                     cache_path: str = DEFAULT_CACHE, iters: int = 5,
                     rounds: int = 3, force: bool = False,
                     verbose: bool = False, interpret: bool = False,
                     device="cuda") -> str:
    """Best measured B2 route for a (B, M, K) x (B, K, N) problem (cached),
    by :func:`_measure`'s protocol, whose partial-median guard holds here
    too."""
    if interpret:
        raise NotImplementedError("CUDA has no interpreter mode")
    if semiring != "plus_times":
        raise ValueError("autotune_batched covers plus_times only")
    chip = _chip_name(device)
    if chip is None:
        raise NotImplementedError(f"no chip model for {device}")
    key = _key_batched(chip, dtype, semiring, bsz, m, n, k)
    cache = _load(cache_path)
    if key in cache and not force:
        return cache[key]["route"]
    from gemm_hls_tpu_torch.ops import mxu

    a, b = _operands((bsz, m, k), (bsz, k, n), dtype, device)
    cfg = GemmConfig(dtype=dtype)

    def run(e):
        return mxu.mxu_matmul_batched(a, b, cfg=cfg, route=e["route"])

    ref = mxu.mxu_matmul_plain(a, b, cfg=cfg)
    cands = [{"route": r} for r in batch_block_candidates(bsz, m, n, k, dtype)]
    best, gf, ms, report = _measure(cands, _timer(run, iters), 2.0 * bsz * m * n * k,
                                    _ceiling(device, dtype), rounds, verbose,
                                    lambda e: _agrees(run(e), ref))
    autotune_batched.last_report = report
    if best is None:
        raise RuntimeError(f"autotune_batched: no feasible route for {key}")
    return _record(cache_path, key, best, gf, ms, device)["route"]


autotune_batched.last_report = []


# ---------------------------------------------------------------------------
# Kernel families: flash attention, the quantized GEMMs, the grouped MoE
# GEMM.  Same cache and seed, family-prefixed keys; the front doors consult
# cached_family_entry() and keep their route rules and plans on a miss.
# ---------------------------------------------------------------------------

def _key_family(chip: str, family: str, dtype: str, dims, tag: str = ""):
    dims_s = "x".join(str(_bucket(int(v))) for v in dims)
    base = f"{chip}/{family}/{dtype}/{dims_s}"
    return f"{base}/{tag}" if tag else base


def _family_pad_ratio(family: str, dims, e: dict) -> float:
    """Padded-work ratio when this winner's blocks run the ACTUAL dims (the
    reference's, field for field).  The port's entries carry their routes'
    compiled tiles (``_FLASH_TILES``, ``_GROUPED_TILES``, ``_MMA_TILES``,
    the engine plans' tiles); an entry without them is read at the
    reference's default blocks."""
    def r(x, b):
        x, b = int(x), int(b)
        if b <= 0 or x <= 0:
            return 1.0
        return math.ceil(x / b) * b / x

    if family == "flash":
        _, s_q, s_kv, _ = (int(v) for v in dims)
        return (r(s_q, min(e.get("block_q", 512), s_q))
                * r(s_kv, min(e.get("block_kv", 2048), s_kv)))
    if family in ("w8a8", "dequant4", "dequant8"):
        m, n, k = (int(v) for v in dims)
    elif family == "grouped":
        m, k, n = (int(v) for v in dims[:3])
    else:
        return 1.0
    return (r(m, e.get("block_m", 512)) * r(n, e.get("block_n", 1024))
            * r(k, e.get("block_k", 2048)))


def _group_of(tag: str) -> Optional[int]:
    """The group size a quantized family's tag names (None: per-channel)."""
    return int(tag[1:]) if tag.startswith("g") else None


def _family_runs(family: str, dims, dtype: str, tag: str, e: dict, device,
                 aligned: Optional[bool]) -> bool:
    """Whether the route rule takes the entry's route (and its plan) for a
    call of these dims: the ops modules' own predicates.  ``aligned``: the
    operands' 16-byte bases (None: fresh tensors); the rows come from the
    dims."""
    from gemm_hls_tpu_torch.ops import dequant, flash, gmm, quant

    td = torch_dtype(dtype)
    al = True if aligned is None else bool(aligned)
    route, plan = e.get("route"), e.get("plan")
    if family == "flash":
        _, s_q, s_kv, d = (int(v) for v in dims)
        al = al and _pitches_aligned(dtype, d)
        bwd = e.get("bwd_route")
        return ((route is None or _runs(route, flash.flash_route(td, d, s_q, al)))
                and (bwd is None or all(_runs(bwd, flash.flash_bwd_route(td, d, rows, al))
                                        for rows in (s_q, s_kv))))
    if family == "grouped":
        _, k, n, _ = (int(v) for v in dims)
        return route is None or _runs(route, gmm.grouped_route(
            td, al and _pitches_aligned(dtype, k, n)))
    if family in ("dequant4", "dequant8"):
        m, n, k = (int(v) for v in dims)
        g = _group_of(tag) or k
        if route is not None and not _runs(route, dequant.dequant_route(td, n, k, g, al)):
            return False
        if plan is None:
            return True
        if route != "wgmma" or not isinstance(plan, (list, tuple)) or len(plan) != 2:
            return False
        return tuple(plan) in _dequant_plans(device if device is not None else "cpu",
                                             m, n, k)
    if family == "w8a8":
        m, n, k = (int(v) for v in dims)
        g = _group_of(tag)
        if k % (g or k):
            return False
        cfg = quant.w8a8_resolve(m, n, k, g)
        _, mode, bk = dequant.w8a8_schedule(m, n, k, cfg, k // (g or k), True)
        if route is not None and not _runs(route, dequant.w8a8_route(n, k, bk, mode, al)):
            return False
        return plan is None or (route == "wgmma"
                                and plan in dequant.w8a8_engine_plans(k, bk, mode))
    return True


def cached_family_entry(family: str, dims, *, dtype: str, tag: str = "",
                        cache_path: Optional[str] = None, device=None,
                        aligned: Optional[bool] = None) -> Optional[dict]:
    """Cached winner dict for a kernel family, or None: never measures.

    Families: ``flash`` (dims (B, S_q, S_kv, D), tag "causal" / "full";
    entry keys ``route``, ``bwd_route``), ``dequant4`` / ``dequant8`` and
    ``w8a8`` (dims (M, N, K), tag ``g<group>`` / ``chan``; ``route``, on the
    engine ``plan``: B13's (N tile, K splits), W8A8's N tile), ``grouped``
    (dims (M, K, N, G); ``route``).  An entry whose route or plan the route
    rule cannot run for this call (``aligned``: the operands' 16-byte bases;
    ``device``: whose plans), or whose blocks would pad the actual shape by
    more than 1.3x (the reference's guard), is a miss, and the front doors
    keep their route rules and plans."""
    for e in _entries(lambda chip: _key_family(chip, family, dtype, dims, tag),
                      cache_path, device):
        if (_family_pad_ratio(family, dims, e) <= 1.3
                and _family_runs(family, dims, dtype, tag, e, device, aligned)):
            return e
    return None


def _tune_family(family: str, dims, dtype: str, tag: str, candidates,
                 measure, flops: float, ceiling: Optional[float],
                 cache_path: str, rounds: int, force: bool,
                 verbose: bool, check=None, device="cuda", keep=()) -> dict:
    """Median-of-rounds measurement loop shared by the family tuners
    (:func:`_measure`), then the winner stored under the family's key.

    ``candidates`` is a list of entry dicts; ``measure(entry)`` returns
    seconds per call (raises on infeasible); ``check(entry)`` holds it to
    its plain version first.  ``keep``: fields of an existing entry kept
    (the forward tuner keeps the backward's)."""
    key = _key_family(_chip_name(device) or "unknown", family, dtype, dims, tag)
    cache = _load(cache_path)
    if key in cache and not force:
        return cache[key]
    best, gf, ms, report = _measure(candidates, measure, flops, ceiling, rounds,
                                    verbose, check)
    _tune_family.last_report = report
    if best is None:
        raise RuntimeError(f"autotune family: no feasible candidate for {key}")
    return _record(cache_path, key, best, gf, ms, device, keep)


_tune_family.last_report = []


def _flash_inputs(bsz, s_q, s_kv, d, dtype, device, seed=5):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    td = torch_dtype(dtype)
    return tuple((torch.randn(shape, generator=gen) * 0.3).to(device=device, dtype=td)
                 for shape in ((bsz, s_q, d), (bsz, s_kv, d), (bsz, s_kv, d), (bsz, s_q, d)))


# The compiled tiles of the families' routes, recorded in their entries so
# the reference's 1.3x padding guard reads each kernel's own blocks (flash:
# (block_q, block_kv); the rest (block_m, block_n, block_k)): flash
# csrc/flash_wgmma.cu (kFwBQ, kFwBKV) and csrc/flash_fwd.cu (FQ, FKV on the
# tensor cores, SQ, SKV on the CUDA cores); B16 csrc/wgmma_tile.cuh (kWgBM,
# kWgBN, a 128-byte K slab) and csrc/grouped_gemm.cu (GBM, GBN, GBK); the
# mma.sync tiles of B13 (csrc/dequant_gemm.cu: DBM, DBN, DBK) and W8A8
# (csrc/w8a8_gemm.cu: WBM, WBN, WBK).  The engine tiles of B13 and W8A8
# follow their plans (ops/dequant.py).
_FLASH_TILES = {"wgmma": (128, 128), "mma.sync": (128, 64), "simt": (32, 32)}
_GROUPED_TILES = {"wgmma": (128, 256, 64), "mma.sync": (64, 128, 32)}
_MMA_TILES = {"dequant": (64, 64, 64), "w8a8": (64, 128, 64)}


def _blocks(tile) -> dict:
    return dict(zip(("block_m", "block_n", "block_k"), tile)) if tile else {}


def _route_pair(rule: str) -> List[str]:
    """The rule's route and, beside the tile engine, the other tensor-core
    tile."""
    return [rule] + (["mma.sync"] if rule == "wgmma" else [])


def autotune_flash(bsz: int, s_q: int, s_kv: int, d: int, *,
                   dtype: str = "bfloat16", causal: bool = False,
                   cache_path: str = DEFAULT_CACHE, iters: int = 8,
                   rounds: int = 3, force: bool = False,
                   verbose: bool = False, device="cuda") -> dict:
    """Best measured route for the flash forward (the engine or the
    ``mma.sync`` tile), stored as the ``flash`` entry's ``route``."""
    from gemm_hls_tpu_torch.ops import flash

    q, k, v, _ = _flash_inputs(bsz, s_q, s_kv, d, dtype, device)
    scale = d ** -0.5
    kw = dict(causal=causal, scale=scale)

    def run(e):
        return flash.flash_mha(q, k, v, route=e["route"], **kw)

    ref = flash.flash_fwd_plain(q, k, v, **kw)[0]
    rule = flash.flash_route(torch_dtype(dtype), d, s_q, bool(flash._vec(q, k, v)))
    return _tune_family(
        "flash", (bsz, s_q, s_kv, d), dtype, "causal" if causal else "full",
        [{"route": r, "block_q": _FLASH_TILES[r][0], "block_kv": _FLASH_TILES[r][1]}
         for r in _route_pair(rule)], _timer(run, iters),
        4.0 * bsz * s_q * s_kv * d / (2 if causal else 1), _ceiling(device, dtype),
        cache_path, rounds, force, verbose, lambda e: _agrees(run(e), ref), device,
        keep=("bwd_route", "bwd_gflops", "bwd_ms"))


def autotune_flash_bwd(bsz: int, s_q: int, s_kv: int, d: int, *,
                       dtype: str = "bfloat16", causal: bool = False,
                       cache_path: str = DEFAULT_CACHE, iters: int = 8,
                       rounds: int = 3, force: bool = False,
                       verbose: bool = False, device="cuda") -> dict:
    """Best measured route for the flash backward pair (dq and dk / dv timed
    together, as they always run in the gradient), merged into the same
    ``flash`` entry the forward tuner writes (``bwd_route``), so the front
    door reads both from one lookup."""
    from gemm_hls_tpu_torch.ops import flash

    chip = _chip_name(device) or "unknown"
    tag = "causal" if causal else "full"
    key = _key_family(chip, "flash", dtype, (bsz, s_q, s_kv, d), tag)
    cache = _load(cache_path)
    if not force and "bwd_route" in cache.get(key, {}):
        return cache[key]
    q, k, v, do = _flash_inputs(bsz, s_q, s_kv, d, dtype, device)
    scale = d ** -0.5
    o, lse = flash.flash_mha(q, k, v, causal=causal, scale=scale, save_lse=True)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, None, None, None, causal, None, None, scale, 512)

    def run(e):
        return (flash._backward(*args, "dq", route=e["route"]),
                *flash._backward(*args, "dkv", route=e["route"]))

    plain = (q, k, v, do, lse[..., 0], delta)
    kw = dict(causal=causal, scale=scale)
    ref = (flash.flash_bwd_dq_plain(*plain, **kw), *flash.flash_bwd_dkv_plain(*plain, **kw))
    al = bool(flash._vec(q, k, v, do))
    rules = {flash.flash_bwd_route(torch_dtype(dtype), d, rows, al) for rows in (s_q, s_kv)}
    rule = rules.pop() if len(rules) == 1 else "mma.sync"
    # Seven score-area contractions across the pair (flash_bound: 6 + 8).
    flops = 7 * 2.0 * bsz * s_q * s_kv * d / (2 if causal else 1)
    best, gf, ms, report = _measure(
        [{"route": r} for r in _route_pair(rule)], _timer(run, iters), flops,
        _ceiling(device, dtype), rounds, verbose,
        lambda e: _outputs_agree(run(e), ref))
    autotune_flash_bwd.last_report = report
    if best is None:
        raise RuntimeError(f"autotune_flash_bwd: no feasible route for {key}")
    cache = _load(cache_path)
    entry = dict(cache.get(key, {}))
    entry.update(bwd_route=best["route"], bwd_gflops=round(gf, 1),
                 bwd_ms=float(f"{ms:.5g}"), card=card_name(device))
    cache[key] = entry
    _store(cache_path, cache)
    return entry


autotune_flash_bwd.last_report = []


def _dequant_plans(device, m: int, n: int, k: int) -> list:
    """B13's engine plans on ``device``; off the card (where the plain
    version runs whatever the plan) those of an H100's 132 SMs."""
    from gemm_hls_tpu_torch.ops import dequant

    if torch.device(device).type == "cuda":
        return dequant.engine_plans(device, m, n, k)
    return dequant.dequant_engine_plans(m, n, k, 132)


def autotune_quant(m: int, n: int, k: int, *, mode: str = "w8a8",
                   group_size: Optional[int] = None,
                   act_dtype: str = "bfloat16",
                   cache_path: str = DEFAULT_CACHE, iters: int = 8,
                   rounds: int = 3, force: bool = False,
                   verbose: bool = False, device="cuda") -> dict:
    """Best measured route and engine plan for the quantized GEMMs.

    ``mode``: "w8a8" (dynamic int8 activations, per-channel weights, as the
    reference tunes it: B14 / B15's route, on the engine the N tile) or
    "int4" / "int8" (weight-only, B13's route, on the engine the plan (N
    tile, K splits)).  The front doors' ``block_k`` and W8A8's fused /
    two-pass rule are resolved as the front doors resolve them, never
    tuned."""
    import numpy as np

    from gemm_hls_tpu_torch.ops import dequant, quant

    rng = np.random.default_rng(5)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    bits = 4 if mode == "int4" else 8
    g = group_size if mode != "w8a8" else None
    wq, s = quant.quantize_weights(w, bits=bits, group_size=g)
    td = torch_dtype(act_dtype)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(device, td)
    wq, s = torch.from_numpy(wq).to(device), torch.from_numpy(s).to(device)
    if mode == "w8a8":
        cfg = quant.w8a8_resolve(m, n, k, None)
        fused, kind, bk = dequant.w8a8_schedule(m, n, k, cfg, 1, True)
        rule = dequant.w8a8_route(n, k, bk, kind, True)
        cands = ([{"route": "wgmma", "plan": bn, "block_m": dequant.W8A8_ENGINE_BM,
                   "block_n": bn, "block_k": dequant.W8A8_ENGINE_STEP}
                  for bn in dequant.w8a8_engine_plans(k, bk, kind)] if rule == "wgmma"
                 else []) + [dict(route="mma.sync", **_blocks(_MMA_TILES["w8a8"]))]

        def run(e):
            return dequant.w8a8_matmul(x, wq, s, cfg=cfg, route=e["route"],
                                       plan=e.get("plan"))

        ref = dequant.w8a8_plain(x, wq, s, bk=bk, fused=fused, out_dtype=torch.float32)
        ceiling = _ceiling(device, "int8")
    else:
        cfg = quant.dequant_resolve(m, n, k, td, g)
        rule = dequant.dequant_route(td, n, k, g or k, True)
        cands = ([{"route": "wgmma", "plan": [bn, splits], "block_m": dequant.DEQUANT_ENGINE_BM,
                   "block_n": bn, "block_k": dequant.DEQUANT_ENGINE_STEP}
                  for bn, splits in _dequant_plans(device, m, n, k)]
                 if rule == "wgmma" else []) + (
            [{"route": "simt"}] if rule == "simt"
            else [dict(route="mma.sync", **_blocks(_MMA_TILES["dequant"]))])

        def run(e):
            return dequant.dequant_matmul(x, wq, s, cfg=cfg, bits=bits, group_size=g,
                                          route=e["route"], plan=e.get("plan"))

        ref = dequant.dequant_matmul_plain(x, wq, s, bits=bits, group_size=g,
                                           out_dtype=cfg.tout_dtype)
        ceiling = _ceiling(device, act_dtype)
    tag = f"g{g}" if g else "chan"
    return _tune_family(mode if mode == "w8a8" else f"dequant{bits}", (m, n, k),
                        act_dtype, tag, cands, _timer(run, iters), 2.0 * m * n * k,
                        ceiling, cache_path, rounds, force, verbose,
                        lambda e: _agrees(run(e), ref), device)


def autotune_grouped(m: int, k: int, n: int, num_groups: int, *,
                     dtype: str = "bfloat16",
                     cache_path: str = DEFAULT_CACHE, iters: int = 8,
                     rounds: int = 3, force: bool = False,
                     verbose: bool = False, device="cuda") -> dict:
    """Best measured B16 route for the grouped (ragged MoE) GEMM under even
    routing (the schedule's shape depends on the routing; even routing is
    the representative steady state)."""
    import numpy as np

    from gemm_hls_tpu_torch.ops import gmm

    rng = np.random.default_rng(5)
    td = torch_dtype(dtype)
    lhs = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(device, td)
    rhs = torch.from_numpy((rng.standard_normal((num_groups, k, n)) / np.sqrt(k))
                           .astype(np.float32)).to(device, td)
    sizes = torch.full((num_groups,), m // num_groups, dtype=torch.int32, device=device)

    def run(e):
        return gmm.grouped_mxu(lhs, rhs, sizes, route=e["route"])

    ref = gmm.grouped_mxu_plain(lhs, rhs, sizes)
    rule = gmm.grouped_route(td, _pitches_aligned(dtype, k, n))
    return _tune_family("grouped", (m, k, n, num_groups), dtype, "",
                        [dict(route=r, **_blocks(_GROUPED_TILES.get(r)))
                         for r in _route_pair(rule)], _timer(run, iters),
                        2.0 * m * k * n, _ceiling(device, dtype), cache_path, rounds,
                        force, verbose, lambda e: _agrees(run(e), ref), device)


# ---------------------------------------------------------------------------
# Cross-chip seed priors over the port's chip table (models/perf_model.py):
# every ``{donor}/...`` entry spawns a ``{target}/...`` twin with the same
# knobs, ``derived: true``, its GFLOP/s scaled by the two chips' peak
# ratio.  The port's table holds one card, so there is no target by
# default, and the packaged seed holds measured entries only.
# ---------------------------------------------------------------------------

_FAMILY_NAMES = ("flash", "w8a8", "dequant4", "dequant8", "grouped")


def _seed_key_dtype(key: str) -> Optional[str]:
    """The dtype component of any seed-cache key (dense, batched, or
    family-prefixed), or None if the key doesn't parse."""
    parts = key.split("/")
    if len(parts) < 3:
        return None
    return parts[2] if parts[1] in _FAMILY_NAMES else parts[1]


def derive_seed_priors(seed: dict, donor: str = "h100", targets=()) -> dict:
    """Return ``seed`` plus derived entries for each target chip.

    Every ``{donor}/...`` entry spawns a ``{target}/...`` twin (only where
    the target has no measured entry already): identical knobs,
    ``derived: true``, gflops scaled by the target/donor peak ratio for the
    entry's dtype.  Never mutates measured entries."""
    from gemm_hls_tpu_torch.models.perf_model import get_chip

    out = dict(seed)
    donor_chip = get_chip(donor)
    for target in targets:
        tchip = get_chip(target)
        for key, e in seed.items():
            if not key.startswith(donor + "/") or e.get("derived"):
                continue
            tkey = target + key[len(donor):]
            if tkey in out:
                continue  # measured target entry wins
            te = dict(e)
            te["derived"] = True
            dt = _seed_key_dtype(key)
            if "gflops" in te and dt:
                try:
                    ratio = tchip.peak_for(dt) / donor_chip.peak_for(dt)
                    te["gflops"] = round(te["gflops"] * ratio, 1)
                except (KeyError, ZeroDivisionError, TypeError):
                    te.pop("gflops", None)
            out[tkey] = te
    return out


def refresh_derived_seeds(seed_path: str = SEED_CACHE, donor: str = "h100",
                          targets=()) -> int:
    """Regenerate the derived priors inside the packaged seed (dropping
    stale derived entries first).  Returns the derived count."""
    seed = _load(seed_path)
    measured = {k: v for k, v in seed.items() if not v.get("derived")}
    out = derive_seed_priors(measured, donor, targets)
    _store(seed_path, out)
    return sum(1 for v in out.values() if v.get("derived"))


def main(argv=None):
    import sys as _sys
    args_in = list(argv) if argv is not None else _sys.argv[1:]
    if "--refresh-derived-seeds" in args_in:
        n = refresh_derived_seeds()
        print(f"derived seed priors refreshed: {n} entries")
        return n
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("m", type=int)
    p.add_argument("n", type=int)
    p.add_argument("k", type=int)
    p.add_argument("--batch", type=int, default=None,
                   help="tune B2's route for a (B, M, K) x (B, K, N) problem")
    p.add_argument("--family", default=None,
                   choices=["flash", "w8a8", "int4", "int8", "grouped"],
                   help="tune a non-dense kernel family.  flash: m n k = B "
                        "S_q(S_kv) D (--causal for the causal kernel, --bwd "
                        "for the backward pair too); w8a8/int4/int8: M N K "
                        "(--group for group-wise scales); grouped: m n k = M "
                        "K N with --groups experts")
    p.add_argument("--causal", action="store_true")
    p.add_argument("--bwd", action="store_true")
    p.add_argument("--group", type=int, default=None)
    p.add_argument("--groups", type=int, default=8)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--semiring", default="plus_times")
    p.add_argument("--cache", default=DEFAULT_CACHE)
    p.add_argument("--force", action="store_true")
    args = p.parse_args(args_in)
    common = dict(cache_path=args.cache, force=args.force, verbose=True)
    if args.family == "flash":
        e = autotune_flash(args.m, args.n, args.n, args.k, dtype=args.dtype,
                           causal=args.causal, **common)
        if args.bwd:
            e = autotune_flash_bwd(args.m, args.n, args.n, args.k, dtype=args.dtype,
                                   causal=args.causal, **common)
    elif args.family in ("w8a8", "int4", "int8"):
        e = autotune_quant(args.m, args.n, args.k, mode=args.family,
                           group_size=args.group, act_dtype=args.dtype, **common)
    elif args.family == "grouped":
        e = autotune_grouped(args.m, args.n, args.k, args.groups, dtype=args.dtype,
                             **common)
    elif args.batch is not None:
        e = autotune_batched(args.batch, args.m, args.n, args.k, dtype=args.dtype,
                             semiring=args.semiring, **common)
        print(f"best: route={e}")
        return e
    else:
        cfg = autotune(args.m, args.n, args.k, dtype=args.dtype,
                       semiring=args.semiring, **common)
        print(f"best: block_m={cfg.block_m} block_n={cfg.block_n} "
              f"block_k={cfg.block_k} (route {_MXU_ROUTE[cfg.route()]})")
        return cfg
    print(f"best: {e}")
    return e


if __name__ == "__main__":
    main()
