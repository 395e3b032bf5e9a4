"""A/B runs of the row softmax's engine kernel (``csrc/row_softmax_wgmma.cu``)
on the card.

    python -m gemm_hls_tpu_torch.tools.row_softmax_ab [VARIANT ...]

Builds the tree's kernel and the variants named (default: all of
``VARIANTS``) into ONE library of their own under the gitignored
``gemm_hls_tpu_torch/build/`` -- each variant in a namespace of its own,
with its own entry point, since a second kernel library loaded in one
process fails its launches -- prints their ptxas report, then times them in
turns on device time at the attention scores' shape (32 x 1024^2 x 128
bf16, k held (N, K), bf16 P) and holds the tree and every variant that
keeps the function against the plain version.  The variants are text
patches of the source (a patch that no longer matches stops the build;
``tools/w8a8_ab.py``'s ``patch_source`` and ``build_variants``):

* ``noturns``: no turns at the tensor cores (both consumers issue at will);
* ``turn_at_issue``: the turn handed on once the products are issued, not
  once they have retired;
* ``pair_stores``: 16-bit P staged by a 4-byte store per value pair
  (``flash_wgmma.cuh::fw_stage``), not by stmatrix;
* ``exp2f``: exp2f for ex2.approx.ftz;
* ``nsplit``: each tile's products as two m64n64 chains (columns 0-63 and
  64-127) in place of one m64n128 chain;
* ``stamps``: ``clock64`` at each tile's start, its products retired, its
  softmax (pass 1) or exponentials (pass 2) done and its store issued, by
  thread 0 of each consumer warpgroup of block 0, printed per tile;

and the diagnostics, whose outputs are wrong by design: ``noexp`` (no
exponentials), ``noproducts`` (no wgmma), ``nostores`` (no TMA stores of P),
``noload`` (B loaded once an item, the ring's later stages left stale).

Needs the card, and ``chip_smoke.py`` at the repository root (its timing
and comparison helpers).
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import torch

from gemm_hls_tpu_torch import _build
from gemm_hls_tpu_torch.config import default_config
from gemm_hls_tpu_torch.ops import mxu
from gemm_hls_tpu_torch.ops.epilogue import get_epilogue
from gemm_hls_tpu_torch.tools.w8a8_ab import build_variants, patch_source

REPO = Path(__file__).resolve().parents[2]
SOURCE = "row_softmax_wgmma.cu"
SHAPE = (32, 1024, 1024, 128)  # (batch, M, N, K): attention's scores
DIAGNOSTICS = ("noexp", "noproducts", "nostores", "noload")
STAMP_POINTS = ("start", "products", "softmax", "stored")
_SCORES = "      rs_scores<T, MnA, MnB>(s, r, g, bars, a_base, ring, wg);\n"
_ISSUE = """    const uint64_t da = SA::desc(a_base + c * kRsChunk), db = SB::desc(ring + r.stage * kRsChunk);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      rs_mma<T, MnA, MnB>(s, da + SA::kStep * kk, db + SB::kStep * kk, c > 0 || kk > 0);
"""
_MMA64 = """template <typename T, bool TA, bool TB>
__device__ __forceinline__ void rs_mma64(float* d, uint64_t da, uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\\n .reg .pred p;\\n setp.ne.b32 p, %34, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {" RS_R32 "}, %32, %33, p, 1, 1, %35, %36;\\n}"
        : RS_O32 : "l"(da), "l"(db), "r"(scale_d), "n"(static_cast<int>(TA)), "n"(static_cast<int>(TB)));
  } else {
    asm volatile(
        "{\\n .reg .pred p;\\n setp.ne.b32 p, %34, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" RS_R32 "}, %32, %33, p, 1, 1, %35, %36;\\n}"
        : RS_O32 : "l"(da), "l"(db), "r"(scale_d), "n"(static_cast<int>(TA)), "n"(static_cast<int>(TB)));
  }
}
"""
_R32 = ('#define RS_R32 "' + ", ".join(f"%{i}" for i in range(32)) + '"\n'
        + "#define RS_O32 " + ", ".join(f'"+f"(d[{i}])' for i in range(32)) + "\n")
# "gemm_hls{": not the text patch_source renames.
_STAMP_HEAD = (
    '#include "mxu_wgmma.cuh"\n'
    "namespace gemm_hls{ namespace v_stamps {\n"
    "__device__ long long rs_stamps[2][4][32];\n} }\n"
    "#define RS_STAMP(p, t) do { if (blockIdx.x == 0 && tid == 0 && (t) < 32) "
    "rs_stamps[wg][p][t] = clock64(); } while (0)\n")
_STAMP_TAIL = (
    '\nextern "C" int row_softmax_stamps_read(void* host) {\n'
    "  return static_cast<int>(cudaMemcpyFromSymbol(host, gemm_hls::v_stamps::rs_stamps, "
    "2 * 4 * 32 * 8));\n}\n")
# (old, new) text patches of the source.
VARIANTS = {
    "noturns": [("  named_sync(4 + wg, 256);\n", ""), ("  named_arrive(4 + (wg ^ 1), 256);\n", ""),
                ("  if (wg == 0) named_arrive(4, 256);\n", ""),
                ("  if (wg == 0) named_sync(4, 256);\n", "")],
    "turn_at_issue": [("  wg_wait<0>();\n  named_arrive(4 + (wg ^ 1), 256);\n",
                       "  named_arrive(4 + (wg ^ 1), 256);\n  wg_wait<0>();\n")],
    "pair_stores": [
        ("        case kBF16: rs_stage16<__nv_bfloat16>(o, s); break;\n"
         "        case kF16: rs_stage16<__half>(o, s); break;\n",
         "        case kBF16: fw_stage<__nv_bfloat16, 128>(o, s, one); break;\n"
         "        case kF16: fw_stage<__half, 128>(o, s, one); break;\n"),
        ("      unsigned char* o = out + buf * boxes * kWgMnBox;\n",
         "      unsigned char* o = out + buf * boxes * kWgMnBox;\n"
         "      const float one[2] = {1.f, 1.f};\n")],
    "exp2f": [('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));\n', "  y = exp2f(x);\n")],
    "nsplit": [
        ("__device__ __forceinline__ void tma_store_3d(",
         _R32 + _MMA64 + "__device__ __forceinline__ void tma_store_3d("),
        (_ISSUE,
         "    const uint32_t st = ring + r.stage * kRsChunk;\n"
         "    const uint64_t da = SA::desc(a_base + c * kRsChunk), db0 = SB::desc(st), "
         "db1 = SB::desc(st + kWgMnBox);\n"
         "    wg_fence();\n#pragma unroll\n    for (int kk = 0; kk < 4; ++kk) {\n"
         "      rs_mma64<T, MnA, MnB>(s, da + SA::kStep * kk, db0 + SB::kStep * kk, "
         "c > 0 || kk > 0);\n"
         "      rs_mma64<T, MnA, MnB>(s + 32, da + SA::kStep * kk, db1 + SB::kStep * kk, "
         "c > 0 || kk > 0);\n    }\n")],
    "stamps": [
        ('#include "mxu_wgmma.cuh"\n', _STAMP_HEAD),
        ("  RsRing r;\n", "  RsRing r;\n  int rs_t = 0;\n"),
        (_SCORES, "      RS_STAMP(0, rs_t);\n" + _SCORES + "      RS_STAMP(1, rs_t);\n"
         "      ++rs_t;\n"),
        ("      for (int x = 0; x < 64; ++x) l_r[x % 4] += rs_ex2(fmaf(s[x], kLog2e, "
         "-ml[(x % 4) >> 1]));\n",
         "      for (int x = 0; x < 64; ++x) l_r[x % 4] += rs_ex2(fmaf(s[x], kLog2e, "
         "-ml[(x % 4) >> 1]));\n      RS_STAMP(2, rs_t - 1);\n      RS_STAMP(3, rs_t - 1);\n"),
        ("      for (int x = 0; x < 64; ++x) s[x] = rs_ex2(fmaf(s[x], kLog2e, "
         "-c[(x % 4) >> 1]));\n",
         "      for (int x = 0; x < 64; ++x) s[x] = rs_ex2(fmaf(s[x], kLog2e, "
         "-c[(x % 4) >> 1]));\n      RS_STAMP(2, rs_t - 1);\n"),
        ("      if (boxes == 2) buf ^= 1;\n",
         "      RS_STAMP(3, rs_t - 1);\n      if (boxes == 2) buf ^= 1;\n")],
    "noexp": [('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));\n', "  y = x;\n")],
    "noproducts": [(
        "      rs_mma<T, MnA, MnB>(s, da + SA::kStep * kk, db + SB::kStep * kk, c > 0 || kk > 0);",
        "      if (g.M < 0) rs_mma<T, MnA, MnB>(s, da, db, 0);")],
    "nostores": [(
        "          tma_store_3d(&g.mp, o + b * kWgMnBox, j * kRsBN + b * cols, m0 + 64 * wg, z);",
        "          if (g.M < 0) tma_store_3d(&g.mp, o, 0, 0, 0);")],
    "noload": [(
        "        mbar_expect_tx(&bars->full[stage], kRsChunk);\n"
        "        unsigned char* st = ring + stage * kRsChunk;\n",
        "        mbar_expect_tx(&bars->full[stage], t > 0 ? 0 : kRsChunk);\n"
        "        if (t > 0) {\n          if (++stage == kRsStages) {\n            stage = 0;\n"
        "            phase ^= 1;\n          }\n          continue;\n        }\n"
        "        unsigned char* st = ring + stage * kRsChunk;\n")],
}


def build(names) -> ctypes.CDLL:
    """The tree's kernel and ``names``' variants in one library."""
    text = (_build.CSRC_DIR / SOURCE).read_text()
    lib = ctypes.CDLL(str(build_variants("row-softmax-ab", {
        f"row_softmax_{name}.cu": patch_source(name, text, VARIANTS.get(name, []),
                                               "row_softmax_wgmma")
        + (_STAMP_TAIL if name == "stamps" else "") for name in ("tree", *names)})))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name in ("tree", *names):
        fn = getattr(lib, f"row_softmax_wgmma_{name}")
        fn.restype = i32
        fn.argtypes = [vp, vp, vp, i64, i32, i32, i32, i64, i64, i64, i64, i32, i32, i32, i32, vp]
    return lib


def stamp_report(lib, tiles: int) -> None:
    host = (ctypes.c_longlong * (2 * 4 * 32))()
    if lib.row_softmax_stamps_read(host):
        raise RuntimeError("row_softmax_stamps_read failed")
    st = [[list(host[(w * 4 + p) * 32:(w * 4 + p + 1) * 32]) for p in range(4)] for w in range(2)]
    t0 = st[0][0][0]
    print("stamps, block 0, cycles: tile, consumer, start, products (turn, issue, retire), "
          "softmax or exponentials, staging and store, to the next tile")
    for t in range(min(tiles, 32)):
        for w in range(2):
            p = [st[w][i][t] for i in range(4)]
            nxt = st[w][0][t + 1] - p[0] if t + 1 < min(tiles, 32) else None
            print(f"  {t:2d} {w} {p[0] - t0:8d} {p[1] - p[0]:6d} {p[2] - p[1]:6d} "
                  f"{p[3] - p[2]:6d} {nxt}")


def main(argv=None) -> int:
    sys.path.insert(0, str(REPO))
    import chip_smoke

    names = (argv if argv is not None else sys.argv[1:]) or list(VARIANTS)
    if not torch.cuda.is_available():
        print("row_softmax_ab: needs a CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.nvidia_smi())
    lib = build(names)
    stream = torch.cuda.current_stream().cuda_stream
    bsz, m, n, k = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(7)
    q = torch.randn((bsz, m, k), generator=gen, device="cuda").to(torch.bfloat16)
    kk = torch.randn((bsz, n, k), generator=gen, device="cuda").to(torch.bfloat16)
    ps = {name: torch.empty((bsz, m, n), dtype=torch.bfloat16, device="cuda")
          for name in ("tree", *names)}
    code = _build.dtype_code(torch.bfloat16)

    def launch(name):
        rc = getattr(lib, f"row_softmax_wgmma_{name}")(
            q.data_ptr(), kk.data_ptr(), ps[name].data_ptr(), bsz, m, n, k, k, k, m * k, n * k,
            0, 1, code, code, stream)
        if rc:
            raise RuntimeError(f"{name}: launch returned {rc}")

    turns = chip_smoke.time_turns(torch, {name: (lambda name=name: launch(name)) for name in ps})
    ref = mxu.mxu_matmul_plain(q, kk, cfg=default_config(torch.bfloat16), transpose_b=True,
                               epilogue=get_epilogue("softmax"))
    for name in ps:
        if name not in DIAGNOSTICS:
            chip_smoke.compare(torch, ps[name], ref, chip_smoke.BF16_RTOL, name, scaled=True)
    print(f"{bsz}x{m}x{n}x{k} bf16, device ms in turns: "
          + ", ".join(f"{name} {ms:.4f}" for name, ms in turns.items()))
    if "stamps" in names:
        launch("stamps")
        torch.cuda.synchronize()
        stamp_report(lib, 2 * 2 * -(-n // 128))
    return 0


if __name__ == "__main__":
    sys.exit(main())
