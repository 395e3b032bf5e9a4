"""Out-of-device-memory GEMM CLI: host-memory tile staging for problems
larger than the card's memory (the device-level analogue of the reference's
DDR-to-BRAM outer-tile streaming, ``kernel/Memory.cpp``); the port of
``gemm_hls_tpu/tools/oversize.py``.

    python -m gemm_hls_tpu_torch.tools.oversize [--m 32768 --n 32768 --k 32768]
        [--dtype bfloat16] [--tile 8192] [--semiring plus_times]
        [--verify-samples 8] [--no-prefetch] [--device {cuda,cpu}]

Allocates A, B and C in host memory, fills A and B with U(0, 1) block by
block from a seeded ``torch.Generator`` on the run's device (numpy has no
bfloat16), streams K panels per stationary C host tile through
``parallel.staging.streamed_matmul``, and reports the rate including the
staging, the host-to-device bytes it moved beside the CA law
``M*N*(1 + K/tile_n + K/tile_m)`` words, and the panel products' kernel
routes.  Random output entries are spot-checked against a float64 host
dot product (full verification is infeasible at these sizes, as in the
reference's verify-off mode, ``host/RunHardware.cpp:83-91``).  Without a
CUDA device the run says so on stderr and exits non-zero; ``--device cpu``
runs the plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import collections
import sys
import time

import torch

# Rows of fp32 draws per fill block: 256 MB.
_FILL_BYTES = 1 << 28


def _parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--m", type=int, default=32768)
    p.add_argument("--n", type=int, default=32768)
    p.add_argument("--k", type=int, default=32768)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--tile", type=int, default=8192,
                   help="host tile edge (tile_m = tile_n = tile_k)")
    p.add_argument("--semiring", default="plus_times")
    p.add_argument("--verify-samples", type=int, default=8,
                   help="number of random output entries to spot-check")
    p.add_argument("--no-prefetch", dest="prefetch", action="store_false",
                   help="stage each panel only when its GEMM needs it")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the products run (cpu: the plain versions)")
    return p


def fill(shape, dtype, gen, device) -> torch.Tensor:
    """A host tensor of U(0, 1) draws (integers: 0..3), made block by block
    on ``device`` from ``gen`` so no whole-matrix fp32 copy exists."""
    out = torch.empty(shape, dtype=dtype)
    step = max(1, _FILL_BYTES // (shape[1] * 4))
    for r0 in range(0, shape[0], step):
        r1 = min(shape[0], r0 + step)
        blk = (r1 - r0, shape[1])
        if dtype.is_floating_point:
            draw = torch.rand(blk, generator=gen, device=device)
        else:
            draw = torch.randint(0, 4, blk, generator=gen, device=device)
        out[r0:r1] = draw.to(dtype).cpu()
    return out


def run(argv=None) -> dict:
    """Run the tool as ``main`` does; returns what was measured, with the
    operands and the result (host tensors) under "a", "b", "c"."""
    from gemm_hls_tpu_torch.config import torch_dtype
    from gemm_hls_tpu_torch.ops.semiring import get_semiring
    from gemm_hls_tpu_torch.parallel.staging import streamed_matmul
    from gemm_hls_tpu_torch.utils.benchmark import gflops

    args = _parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("oversize: no CUDA device; pass --device cpu to run the plain "
              "versions on the CPU", file=sys.stderr)
        return {"ok": False}
    m, n, k, t = args.m, args.n, args.k, args.tile
    d = torch_dtype(args.dtype)
    sr = get_semiring(args.semiring)
    device = torch.device(args.device)

    bytes_total = (m * k + k * n + m * n) * d.itemsize
    print(f"Allocating A({m}x{k}) B({k}x{n}) C({m}x{n}) {args.dtype} "
          f"= {bytes_total / 1e9:.1f} GB in host memory...", flush=True)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(5)
    a = fill((m, k), d, gen, device)
    b = fill((k, n), d, gen, device)
    fill_s = time.perf_counter() - t0

    print(f"Streaming with host tiles {t}^3 on {args.device}"
          f"{'' if args.prefetch else ' (no prefetch)'}...", flush=True)
    t0 = time.perf_counter()
    c = streamed_matmul(a, b, semiring=sr.name, tile_m=t, tile_n=t, tile_k=t,
                        device=device, prefetch=args.prefetch)
    dt = time.perf_counter() - t0
    stats = streamed_matmul.last_stats
    gf = gflops(m, n, k, dt)
    # The CA law one level up: each (t, t) C tile streams an A slab and a B
    # slab of K once, and C leaves once.
    law_words = m * n * (1 + k / t + k / t)
    law_h2d = m * n * (k / t + k / t) * d.itemsize
    print(f"Done in {dt:.3f} s -> {gf:.0f} GOp/s effective "
          f"(incl. host<->device staging)")
    print(f"Host-to-device: {stats['h2d_bytes']} bytes in {stats['jobs']} panel jobs, "
          f"{stats['h2d_bytes'] / dt / 1e9:.2f} GB/s over the run; the CA law's "
          f"M*N*(K/tile_n + K/tile_m) words = {law_h2d:.0f} bytes "
          f"(ratio {stats['h2d_bytes'] / law_h2d:.4f}); device-to-host "
          f"{stats['d2h_bytes']} bytes (M*N words); law total "
          f"M*N*(1 + K/tile_n + K/tile_m) = {law_words:.0f} words")
    print(f"Host seconds: {stats['fill_s']:.3f} copying panels into place, "
          f"{stats['stage_wait_s']:.3f} of the compute thread waiting for them, "
          f"{stats['drain_s']:.3f} draining C tiles")
    routes = dict(collections.Counter(stats["routes"]))
    print(f"Panel routes: {routes or 'plain versions (CPU)'}; prefetch "
          f"{stats['prefetch']} ({stats['slots']} staging slots)")

    ok = True
    pick = torch.Generator().manual_seed(6)
    spots = []
    for _ in range(args.verify_samples):
        i = int(torch.randint(0, m, (1,), generator=pick))
        j = int(torch.randint(0, n, (1,), generator=pick))
        row = a[i, :].double().numpy()
        col = b[:, j].double().numpy()
        exp = float(sr.np_reduce.reduce(sr.np_map(row, col)))
        got = float(c[i, j].double())
        rel = abs(got - exp) / max(abs(exp), 1e-30)
        good = rel < 1e-2
        ok = ok and good
        spots.append({"i": i, "j": j, "got": got, "exp": exp, "rel": rel})
        print(f"  spot check C[{i},{j}]: got {got:.6g} exp {exp:.6g} "
              f"rel {rel:.2e} {'ok' if good else 'MISMATCH'}")
    print("Spot verification:", "PASS" if ok else "FAIL")
    return {"ok": ok, "seconds": dt, "gops": gf, "fill_seconds": fill_s,
            "stats": stats, "routes": routes, "law_words": law_words,
            "law_h2d_bytes": law_h2d, "spots": spots, "a": a, "b": b, "c": c}


def main(argv=None) -> int:
    return 0 if run(argv)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
