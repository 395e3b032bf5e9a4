"""The serving decode step of one tree, timed on the card, for comparing two
trees in turns.

    cd TREE && python3 PATH/TO/decode_ab.py [--tag NAME]

Imports ``gemm_hls_tpu_torch`` and ``chip_smoke`` from the current directory
(the root of the tree to time, which may be an older checkout without this
file), builds that tree's kernels, sets up the serving block at
``chip_smoke.SERVING``'s width as phase 18 does
(``models/serving.py::serving_setup``, a 64 x 4096-slot decode cache; a tree
from before that module takes ``chip_smoke``'s copy of the block), and
prints one JSON line: the host-clock us a step of the block's decode step
over 7 windows of 50 steps (each window ends in one
sync) and their median, the main thread's CPU us a step in the same
windows (``time.thread_time``: the host's own cost of a step, which a
descheduled host core does not inflate) and their median, then a
torch.profiler breakdown of 10 steps (the device busy share of the window,
device us a step in all, in B13's kernels and in the decode attention's
kernel, whichever route the tree's rule gives it (``flash_decode_kernel``,
the split-KV decode, or an older tree's ``flash_fwd_tc``), named; the
largest kernels).  Two
kernel libraries do not mix in one process: run each tree in its own
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

ROUNDS, STEPS = 7, 50


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default=os.path.basename(os.getcwd()))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("decode_ab: needs the card", file=sys.stderr)
        return 2
    c = cs.SERVING
    dims = dict(h_q=c["h_q"], h_kv=c["h_kv"], d_head=c["d_head"])
    gen = torch.Generator(device="cuda").manual_seed(181)
    try:
        from gemm_hls_tpu_torch.models import serving
        _, _, q4, _, moe, cfg = serving.serving_setup(c)
        decode = serving.block_decode
    except ImportError:  # a tree whose block lived in chip_smoke.py
        _, _, q4, _, moe, cfg = cs.serving_setup(torch)
        decode = cs.serving_decode
    kc, vc, lens = cs.decode_cache(torch, gen, nb=c["dec_batch"], slots=c["slots"],
                                   hkv=c["h_kv"], d=c["d_head"], steps=c["steps"])
    xt = (torch.randn((c["dec_batch"], c["d_model"]), generator=gen, device="cuda")
          * 0.5).to(torch.bfloat16)

    def step():
        return decode(xt, kc, vc, lens, q4, moe, cfg, group_size=c["group"], **dims)

    for _ in range(5):
        step()
    torch.cuda.synchronize()
    windows, cpu = [], []
    for _ in range(ROUNDS):
        t0, c0 = time.perf_counter(), time.thread_time()
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / STEPS * 1e6)
        cpu.append((time.thread_time() - c0) / STEPS * 1e6)
    busy, kernels = cs.device_profile(torch, step, 10)
    print(json.dumps({
        "tag": args.tag, "host_us_a_step": windows,
        "host_us_median": statistics.median(windows), "cpu_us_a_step": cpu,
        "cpu_us_median": statistics.median(cpu), "busy": busy,
        "device_us_a_step": sum(us for _, us in kernels),
        "b13_us_a_step": sum(us for name, us in kernels if "dequant" in name),
        "attention_us_a_step": sum(us for name, us in kernels if "flash_" in name),
        "attention_kernels": sorted({name.split("<")[0][:48] for name, _ in kernels
                                     if "flash_" in name}),
        "kernels_us": [[name[:48], us] for name, us in kernels[:8]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
