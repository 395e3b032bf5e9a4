"""A/B runs of the flash kernels on the card.

    python -m gemm_hls_tpu_torch.tools.flash_ab [--replace FILE] [--stage check|time]

Builds only the flash sources of ``csrc/`` (``flash_*.cu`` and every header),
optionally with one of them replaced by ``FILE`` (a variant of the same
name), into a library of their own under the gitignored
``gemm_hls_tpu_torch/build/``; prints their ptxas report; with ``--stage
check`` runs ``chip_smoke.py``'s backward route cases on the engine and the
20-launch repeats; then times the backward pair (and, where given, SDPA's
backward pinned to cuDNN and FlashAttention-2) in turns on device time at the
main path's shapes: (32, 1024, 128) causal and full, (8, 8192, 128) causal,
the GQA prefill (4, 1024, 16 / 4 heads, 128).  Two kernel libraries do not
mix in one process: run each variant in its own process, parent and variant
in turns (parent, variant, variant, parent) within one call on the card.
Needs the card, and ``chip_smoke.py`` at the repository root (its case
tables and timing helpers).
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import sys
from pathlib import Path

import torch

from gemm_hls_tpu_torch import _build

REPO = Path(__file__).resolve().parents[2]
FLASH_ENTRIES = ("flash_fwd", "flash_wgmma", "flash_bwd_dq", "flash_bwd_dkv",
                 "flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma")
SHAPES = (("causal 32x1024", (32, 1024, 128), None, True),
          ("full 32x1024", (32, 1024, 128), None, False),
          ("causal 8x8192", (8, 8192, 128), None, True),
          ("GQA 4x1024 16/4", (4, 1024, 16, 128), 4, True))


def _declare_flash(lib):
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    args = [ctypes.POINTER(i64), vp, vp, vp, vp, vp, ctypes.POINTER(i32),
            ctypes.c_float, ctypes.c_float, i32, vp]
    for name in FLASH_ENTRIES:
        getattr(lib, name).restype = i32
        getattr(lib, name).argtypes = args
    return lib


def build(replace: Path | None) -> Path:
    """The flash sources (one replaced by ``replace``) built into their own
    library; ``_build.library()`` loads it afterwards."""
    tag = "ab-" + (replace.parent.name if replace else "tree")
    src = _build.BUILD_DIR / tag / "csrc"
    shutil.rmtree(src, ignore_errors=True)
    src.mkdir(parents=True)
    for f in _build.CSRC_DIR.iterdir():
        if f.suffix == ".cuh" or f.name.startswith("flash_"):
            shutil.copy(f, src / f.name)
    if replace:
        shutil.copy(replace, src / replace.name)
    _build.CSRC_DIR, _build.BUILD_DIR = src, src.parent
    _build._declare = _declare_flash
    return _build.build()


def pair_turns(cs, flash, gen, shape, hkv, causal, library):
    """{name: device ms} of dq and dkv on their route (and SDPA's
    backward where ``library``) at one shape, in turns."""
    bf16 = torch.bfloat16
    q, do = (torch.randn(shape, generator=gen, device="cuda", dtype=bf16) for _ in range(2))
    kshape = shape if hkv is None else shape[:2] + (hkv, shape[3])
    k, v = (torch.randn(kshape, generator=gen, device="cuda", dtype=bf16) for _ in range(2))
    sc = shape[-1] ** -0.5
    o, lse = flash._forward(q, k, v, None, None, None, None, causal, None, None, sc, 512)
    delta = flash._pack((do.float() * o.float()).sum(-1, keepdim=True))[..., 0]
    b = (q, k, v, do, lse, delta, None, None, None, causal, None, None, sc, 512)
    fns = {w: (lambda w=w: flash._backward(*b, which=w)) for w in ("dq", "dkv")}
    if library:
        lib = ([x[None] for x in (q, k, v, do)] if hkv is None else
               [x.permute(0, 2, 1, 3).repeat_interleave(shape[2] // x.shape[2], 1).contiguous()
                for x in (q, k, v, do)])
        fns.update(cs.sdpa_grads(torch, *lib, causal))
    return cs.time_turns(torch, fns)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--replace", type=Path, default=None,
                    help="a variant of one flash source, built in its place")
    ap.add_argument("--stage", choices=("check", "time"), default="time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from gemm_hls_tpu_torch.ops import flash

    path = build(args.replace)
    print(f"variant {args.replace or 'tree'}, stage {args.stage}")
    for ln in path.with_suffix(".log").read_text().splitlines():
        if ln.startswith("==") or "Compiling entry" in ln or "spill" in ln:
            print(ln)
    _build.library()
    gen = torch.Generator(device="cuda").manual_seed(131)
    if args.stage == "check":
        for case in cs.FLASH_BWD_ROUTE_CASES:
            if case[-1] == "wgmma":
                print(f"{case}: max abs err {cs.flash_bwd_route_case(torch, gen, case):.3e}")
        cs.flash_bwd_repeats(torch, gen)
        torch.cuda.synchronize()
        print("route cases and repeats: ok")
    for key, shape, hkv, causal in SHAPES:
        turns = pair_turns(cs, flash, gen, shape, hkv, causal, args.stage == "check")
        print(f"{key}: pair {turns['dq'] + turns['dkv']:.4f} ms; "
              + ", ".join(f"{n} {t:.4f} ms" for n, t in turns.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
