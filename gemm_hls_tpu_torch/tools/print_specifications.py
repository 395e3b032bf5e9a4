"""CLI: analytical expectations for a problem / config on the card, the
port of ``gemm_hls_tpu/tools/print_specifications.py`` (the
``PrintSpecifications N K M [frequency]`` executable,
``src/PrintSpecifications.cpp:4-11``).

    python -m gemm_hls_tpu_torch.tools.print_specifications 8192 8192 8192 \
        --dtype bfloat16 [--chip h100] [--block-m 128 --block-n 256 --block-k 64]

The blocks default to the tile of the kernel the call runs on the card
(``config.route_config``: the tile engine's 128 x 256 for bf16 / fp16).
A plus_times call on contiguous operands whose rows are not whole 16-byte
units (or int8 / uint8 B held (K, N)) is charged the pack pass's bytes
(``config.pack_bytes``).  int16, uint8, uint16, uint32 and int32 run on
the engine as byte planes: the peak is the int8 rate over the plane pairs
(``perf_model.plus_times_peak``), and the split's bytes are charged as the
pack's are.
``--chip h100`` needs no card; without ``--chip`` the model is the local
device's (``models.perf_model.detect_chip``: the CPU where there is no
card).
"""

from __future__ import annotations

import argparse

from gemm_hls_tpu_torch.config import pack_bytes, route_config
from gemm_hls_tpu_torch.models.perf_model import (
    detect_chip, format_specifications, get_chip, specifications,
)
from gemm_hls_tpu_torch.ops.semiring import get_semiring


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("m", type=int)
    p.add_argument("n", type=int)
    p.add_argument("k", type=int)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--semiring", default="plus_times")
    p.add_argument("--chip", default=None)
    p.add_argument("--block-m", type=int, default=None)
    p.add_argument("--block-n", type=int, default=None)
    p.add_argument("--block-k", type=int, default=None)
    args = p.parse_args(argv)

    cfg = route_config(args.dtype, semiring=args.semiring)
    overrides = {name: getattr(args, name) for name in ("block_m", "block_n", "block_k")
                 if getattr(args, name) is not None}
    if overrides:
        cfg = cfg.replace(**overrides)
    chip = get_chip(args.chip) if args.chip else detect_chip()
    sr = get_semiring(args.semiring)
    packed = pack_bytes(args.dtype, args.m, args.n, args.k) if sr.is_mxu else 0
    spec = specifications(cfg, args.m, args.n, args.k, chip=chip,
                          semiring_is_mxu=sr.is_mxu, pack_bytes=packed)
    print(format_specifications(spec))
    return spec


if __name__ == "__main__":
    main()
