"""Fast-memory-budget tile optimizer: the port of
``gemm_hls_tpu/tools/tile_optimizer.py`` (``optimal_memory_tile_size.py``).

The reference picks the (block_m, block_n, block_k) whose fast-memory cost
fits the chip and whose HBM traffic ``M*N*K*(1/block_m + 1/block_n)`` plus
the output is least (``src/PrintSpecifications.cpp:72-75``).  On the card
the kernels run compiled tiles only (``config.KERNEL_TILES``,
``config.ENGINE_TILES``), so the candidates are the compiled tiles of the
routes that run the dtype, the budget is one thread block's shared memory
(``config.SMEM_LIMIT_BYTES``), and the objective is the reference's: the
least I/O, then balance, then the largest block_k.  The result is always
a tile the card runs.

    python -m gemm_hls_tpu_torch.tools.tile_optimizer --dtype bfloat16 \
        [--smem-bytes 232448] [--m 8192 --n 8192 --k 8192]
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

from gemm_hls_tpu_torch.config import (
    SMEM_LIMIT_BYTES, GemmConfig, beside_engine, call_route, dtype_name, route_tile,
)


def tile_candidates(dtype="float32", *, max_dim: int = 2048,
                    min_block_k: int = 1,
                    semiring: str = "plus_times") -> List[Tuple[int, int, int]]:
    """The compiled (block_m, block_n, block_k) tiles of the routes that
    run ``dtype``: the route rule's (``config.call_route``: the engine for
    bf16 / fp16 / int8 / fp32 plus_times in any layout and at any
    alignment) and, beside the engine, the tile a caller may name
    (``config.beside_engine``: WMMA's for the 16-bit types and int8, the
    CUDA cores' for fp32), within ``max_dim`` and from ``min_block_k`` (the
    reference's filters)."""
    rule = call_route(dtype, semiring)
    tiles = [route_tile(r, dtype) for r in [rule] + beside_engine(rule, dtype)]
    return [t for t in tiles
            if max(t[0], t[1]) <= max_dim and t[2] >= min_block_k]


def optimal_tiles(dtype="float32", *, vmem_budget: Optional[int] = None,
                  m: Optional[int] = None, n: Optional[int] = None,
                  k: Optional[int] = None, semiring: str = "plus_times",
                  out_dtype=None, transpose_a: bool = False,
                  transpose_b: bool = False) -> GemmConfig:
    """The compiled tile with the least I/O for (m, n, k) (8192 each where
    not given) whose block fits ``vmem_budget`` bytes of shared memory
    (default: ``SMEM_LIMIT_BYTES``), preferring (1) minimal I/O volume, (2)
    balance, (3) larger block_k.  For bf16 that is the tile engine's 128 x
    256, which moves a quarter less than the WMMA tile; for fp32 too (its
    TF32 route), against the CUDA-core tile's 128 x 128."""
    budget = SMEM_LIMIT_BYTES if vmem_budget is None else vmem_budget
    name = dtype_name(dtype)
    best, best_key = None, None
    for bm, bn, bk in tile_candidates(name, semiring=semiring):
        cfg = GemmConfig(dtype=name, block_m=bm, block_n=bn, block_k=bk,
                         semiring=semiring, transpose_a=transpose_a,
                         transpose_b=transpose_b,
                         out_dtype=dtype_name(out_dtype) if out_dtype else None)
        if cfg.smem_bytes() > budget:
            continue
        if m and bm > m and bm > 128:
            continue
        if n and bn > n and bn > 128:
            continue
        pm, pn, pk = (m or 8192), (n or 8192), (k or 8192)
        key = (cfg.io_volume_bytes(pm, pn, pk), max(bm, bn) / min(bm, bn), -bk)
        if best_key is None or key < best_key:
            best, best_key = cfg, key
    if best is None:
        raise ValueError(f"no feasible tile configuration for dtype={name} "
                         f"under {budget} bytes of shared memory")
    return best


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dtype", default="float32")
    p.add_argument("--smem-bytes", "--vmem-bytes", dest="smem_bytes", type=int,
                   default=None, help="shared-memory budget of one block")
    p.add_argument("--m", type=int, default=None)
    p.add_argument("--n", type=int, default=None)
    p.add_argument("--k", type=int, default=None)
    p.add_argument("--semiring", default="plus_times")
    args = p.parse_args(argv)
    cfg = optimal_tiles(args.dtype, vmem_budget=args.smem_bytes,
                        m=args.m, n=args.n, k=args.k, semiring=args.semiring)
    print(f"block_m={cfg.block_m} block_n={cfg.block_n} block_k={cfg.block_k} "
          f"route={cfg.route()}")
    print(f"smem_bytes={cfg.smem_bytes()}")
    if args.m and args.n and args.k:
        print(f"io_volume_bytes={cfg.io_volume_bytes(args.m, args.n, args.k)}")
    return cfg


if __name__ == "__main__":
    main()
