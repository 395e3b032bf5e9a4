"""The bf16 trainer step, the TF32 split pass and fp32 8192^3 of one tree,
timed on the card, for comparing two trees in turns.

    cd TREE && python3 PATH/TO/trainer_ab.py [--tag NAME]

Imports ``gemm_hls_tpu_torch`` and ``chip_smoke`` from the current directory
(the root of the tree to time, which may be an older checkout without this
file), builds that tree's kernels, and prints one JSON line:

* the bf16 trainer step (``models/mlp.py::train_step`` at phase 8a's width,
  (4096, 16384, 4096) x 8192 tokens), fused and unfused, and the plain
  PyTorch step (``chip_smoke.plain_mlp_step``) beside them: host-clock ms a
  step over ROUNDS windows of STEPS steps (each window ends in one sync)
  and their median; the launches of one step (B1, B1 epilogue, the split
  pass, B1 / B2 by route); a torch.profiler breakdown of PROFILED steps:
  the device busy share, device ms a step in all, in the split pass
  (``tf32_split`` kernels, or an older tree's ``SplitPut`` tile), in the
  tile engine's kernels (``mxu_wg``) and in the largest kernels, named;
* the split pass alone (``ops/mxu.py::tf32_operand``) on an 8192^2
  operand of each source type (fp32, bf16, fp16), held (K, N) and (N, K),
  one and three segments, on CUDA events, each beside its bytes bound (a
  tree whose split takes fp32 only reports null for the 16-bit sources);
* fp32 ``matmul`` at 8192^3, "default" and "high", on CUDA events, each
  with its normwise error against float64 ``torch.matmul``.

Two kernel libraries do not mix in one process: run each tree in its own
process, parent and change in turns (parent, change, change, parent)
within one call on the card.  Needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROUNDS, STEPS, PROFILED = 5, 10, 5
DIMS, TOKENS, LR = (4096, 16384, 4096), 8192, 0.1
SPLIT, GEMM = 8192, 8192


def _split_kernel(name: str) -> bool:
    return "tf32_split" in name or "SplitPut" in name


def trainer(torch, cs, fused):
    """Host ms a step (windows, median), one step's launches, and the
    profile of the port's bf16 step (``fused``; None: the plain step)."""
    from gemm_hls_tpu_torch.models import mlp
    from gemm_hls_tpu_torch.ops import mxu
    params = mlp.init_params(torch.Generator(device="cuda").manual_seed(0), DIMS, torch.bfloat16)
    batch = mlp.make_batch(torch.Generator(device="cuda").manual_seed(1), TOKENS, DIMS[0],
                           DIMS[-1], torch.bfloat16)

    def step():
        if fused is None:
            return cs.plain_mlp_step(torch, params, batch, LR)[1]
        return mlp.train_step(params, batch, lr=LR, fused=fused)[1]

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    cs.reset_counters()
    loss = float(step())
    torch.cuda.synchronize()
    launches = {k: v for k, v in cs.counters().items() if v}
    by_route = {f"{r} {dt}": v for (r, dt), v in sorted(mxu.route_launches.items())}
    windows = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / STEPS * 1e3)
    busy, kernels = cs.device_profile(torch, step, PROFILED)
    return {"ms_a_step": windows, "ms_median": statistics.median(windows), "loss": loss,
            "launches": launches, "by_route": by_route, "busy": busy,
            "device_ms_a_step": sum(us for _, us in kernels) / 1e3,
            "split_ms_a_step": sum(us for n, us in kernels if _split_kernel(n)) / 1e3,
            "engine_ms_a_step": sum(us for n, us in kernels if "mxu_wg" in n) / 1e3,
            "kernels_ms": [[n[:64], us / 1e3] for n, us in kernels[:8]]}


def split_alone(torch, cs):
    """{"<dtype> <holding> x<segments>": {ms, bound_ms} or None}."""
    from gemm_hls_tpu_torch.models.perf_model import H100
    from gemm_hls_tpu_torch.ops import mxu
    gen = torch.Generator(device="cuda").manual_seed(29)
    fns, bounds = {}, {}
    for dt in ("float32", "bfloat16", "float16"):
        x = cs.signed(torch, (SPLIT, SPLIT), getattr(torch, dt), gen)
        for mn in (True, False):
            for p in (1, 3):
                name = f"{dt} {'(K, N)' if mn else '(N, K)'} x{p}"
                try:
                    mxu.tf32_operand(x, mn, p, "b")
                except TypeError:  # a tree whose split takes fp32 only
                    continue
                fns[name] = lambda x=x, mn=mn, p=p: mxu.tf32_operand(x, mn, p, "b")
                bounds[name] = (x.numel() * x.element_size() + x.numel() * 4 * p) \
                    / H100.hbm_bandwidth * 1e3
    t = cs.event_turns(torch, fns, rounds=5, iters=20, hold=True)
    names = [f"{dt} {h} x{p}" for dt in ("float32", "bfloat16", "float16")
             for h in ("(K, N)", "(N, K)") for p in (1, 3)]
    return {n: (dict(ms=t[n], bound_ms=bounds[n]) if n in t else None) for n in names}


def fp32_gemm(torch, cs):
    """fp32 ``matmul`` at GEMM^3, "default" and "high": ms on CUDA events
    (in turns) and normwise errors against float64."""
    from gemm_hls_tpu_torch import matmul
    gen = torch.Generator(device="cuda").manual_seed(24)
    a = cs.signed(torch, (GEMM, GEMM), torch.float32, gen)
    b = cs.signed(torch, (GEMM, GEMM), torch.float32, gen)
    fns = {"default": lambda: matmul(a, b, precision="default"), "high": lambda: matmul(a, b)}
    t = cs.event_turns(torch, fns, rounds=3, iters=5)
    ref = torch.matmul(a.double(), b.double())
    err = {k: float((fn().double() - ref).norm() / ref.norm()) for k, fn in fns.items()}
    return {k: dict(ms=t[k], normwise=err[k]) for k in fns}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default=os.path.basename(os.getcwd()))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("trainer_ab: needs the card", file=sys.stderr)
        return 2
    from gemm_hls_tpu_torch import _build
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    out = {"tag": args.tag, "build_s": build_s, "dims": DIMS, "tokens": TOKENS,
           "fused": trainer(torch, cs, True), "unfused": trainer(torch, cs, False),
           "plain": trainer(torch, cs, None), "split_8192": split_alone(torch, cs),
           "fp32_8192": fp32_gemm(torch, cs)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
