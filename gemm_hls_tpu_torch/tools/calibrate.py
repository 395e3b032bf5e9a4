"""First-run self-calibration for cards without packaged constants: the
port of ``gemm_hls_tpu/tools/calibrate.py``.

The perf model's chip table (``models/perf_model.py``) holds the H100's
data-sheet rooflines.  On a card without an entry, ``detect_chip`` reads
the entry this module persists instead, so a new card is not blocked on
hand-edited constants:

1. **Engine-rate probe**: B1 bf16 on the tile engine at ``2 * n_probe``
   cubed, the sustained rate that scales the H100's roofline.
2. **Latch probe**: stays 0.0 (``run_calibration`` says why).
3. **Autotune seed**: the tuner's winner at the probe's size, in the
   autotune cache the front door consults.

Results persist to ``~/.cache/gemm_hls_tpu_torch/calibration.json``.

CLI (on the card):
    python -m gemm_hls_tpu_torch.tools.calibrate [--force]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

CALIBRATION_CACHE = os.path.expanduser(
    "~/.cache/gemm_hls_tpu_torch/calibration.json")


def fit_latch(t_sparse: float, steps_sparse: int, t_dense: float,
              steps_dense: int) -> float:
    """Per-grid-step latch from two timings of the *same total work* at
    different grid densities: the roofline terms cancel in the difference,
    leaving (extra steps) x latch."""
    if steps_dense <= steps_sparse:
        raise ValueError("dense probe must have more grid steps")
    return max(0.0, (t_dense - t_sparse) / (steps_dense - steps_sparse))


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


def load_calibration(kind: str, cache_path: str = None) -> dict | None:
    """The persisted calibration entry for a device kind, or None."""
    return _load(cache_path or CALIBRATION_CACHE).get(kind.lower())


def run_calibration(*, cache_path: str = None, force: bool = False,
                    n_probe: int = 2048, verbose: bool = False,
                    autotune_cache: str = None) -> dict:
    """Measure and persist this card's calibration entry.

    Returns the entry, under the reference's keys: ``measured_bf16_flops``
    (B1 bf16 on the tile engine at ``(2 n_probe)^3``, the best of two
    readings on CUDA events), ``grid_step_overhead_s``, ``timestamp``, and
    the card's name and power limit.

    ``grid_step_overhead_s`` is 0.0 and is not fitted: the reference's
    latch probe times the same work at two grid densities (two block
    shapes of one kernel), and every kernel here runs one compiled tile, so
    the same work always takes the same number of block steps; a slope
    between two different kernels would fit their difference, not a
    latch (``models/perf_model.py``'s H100 entry keeps 0.0 for this
    reason).

    Then seeds ``autotune_cache`` (default: the autotune module's
    ``DEFAULT_CACHE``) with the tuner's winner at the probe's size, as the
    reference does; a failure there is reported, and the calibration
    stands."""
    import torch

    from gemm_hls_tpu_torch.config import route_config
    from gemm_hls_tpu_torch.ops import mxu
    from gemm_hls_tpu_torch.tools.autotune import card_name
    from gemm_hls_tpu_torch.utils.benchmark import time_fn

    cache_path = cache_path or CALIBRATION_CACHE
    kind = torch.cuda.get_device_name(0).lower()
    cache = _load(cache_path)
    if kind in cache and not force:
        return cache[kind]

    n = 2 * n_probe
    gen = torch.Generator(device="cpu").manual_seed(5)
    a, b = (torch.randn(n, n, generator=gen).to("cuda", torch.bfloat16) for _ in range(2))
    cfg = route_config("bfloat16")

    def probe():
        return mxu.mxu_matmul(a, b, cfg=cfg, route="wgmma")

    secs = min(time_fn(probe, [()], iters=8, warmup=1) for _ in range(2))
    measured = 2.0 * n ** 3 / secs
    if verbose:
        print(f"engine probe: {measured / 1e12:.1f} TFLOP/s sustained bf16 at {n}^3 "
              f"({secs * 1e3:.4f} ms)")
    entry = {
        "measured_bf16_flops": measured,
        "grid_step_overhead_s": 0.0,
        "timestamp": time.time(),
        "card": card_name("cuda"),
    }
    cache[kind] = entry
    _store(cache_path, cache)

    try:
        from gemm_hls_tpu_torch.tools import autotune

        autotune.autotune(n, n, n, dtype="bfloat16", rounds=1,
                          cache_path=autotune_cache or autotune.DEFAULT_CACHE)
    except (NotImplementedError, RuntimeError) as e:
        if verbose:
            print(f"autotune seeding skipped: {e}")
    return entry


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--force", action="store_true",
                   help="re-measure even if a calibration exists")
    p.add_argument("--cache", default=CALIBRATION_CACHE)
    args = p.parse_args(argv)
    e = run_calibration(cache_path=args.cache, force=args.force, verbose=True)
    print(f"calibrated: {e['measured_bf16_flops'] / 1e12:.1f} TF bf16, "
          f"latch {e['grid_step_overhead_s'] * 1e9:.0f} ns")
    return e


if __name__ == "__main__":
    main()
