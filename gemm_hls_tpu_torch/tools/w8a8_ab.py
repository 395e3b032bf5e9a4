"""A/B runs of the W8A8 engine kernel (``csrc/w8a8_wgmma.cu``) on the card.

    python -m gemm_hls_tpu_torch.tools.w8a8_ab [VARIANT ...]

Builds the tree's kernel and the variants named (default: all of
``VARIANTS``) into ONE library of their own under the gitignored
``gemm_hls_tpu_torch/build/`` -- each variant in a namespace of its own,
with its own entry point, since a second kernel library loaded in one
process fails its launches -- prints their ptxas report, then times the
GEMM alone in turns on device time at the serving prefill's q / o and k / v
projections (x quantized per row by the plain version, per-channel int8
weights, bf16 out), the tree's kernel at both N tiles, and checks the
tree's output against the plain version.  The variants are text patches of
the source (a patch that no longer matches stops the build), and
``noturn`` and ``noproducts`` compute wrong outputs by design:

* ``noturn``: the weights are not turned K-major (the B tiles keep stale
  bytes): the loads, barriers and products alone;
* ``noproducts``: no ``wgmma`` is issued: the loads, the turn, the barriers
  and the store alone;
* ``direct_store``: the tile stored from the registers, each thread its
  4-byte value pairs, in place of the staged TMA store (the same output);
* ``stamps``: ``%globaltimer`` at each point of a step, by thread 0 of the
  first block and of block 140 (the second wave at q / o on an H100), and
  by the producer thread, printed per step in microseconds from the
  block's start.

Needs the card, and ``chip_smoke.py`` at the repository root (its timing
helper).
"""

from __future__ import annotations

import ctypes
import shutil
import sys
from pathlib import Path

import torch

from gemm_hls_tpu_torch import _build, quantize_weights
from gemm_hls_tpu_torch.ops import dequant

REPO = Path(__file__).resolve().parents[2]
SOURCE = "w8a8_wgmma.cu"
# The prefill's projections: (M, K, N).
SHAPES = {"q/o": (4096, 2048, 2048), "k/v": (4096, 2048, 512)}
STAMP_SLOTS = {0: "block 0", 1024: "block 140"}
STAMP_POINTS = ("top", "w_full", "sync1", "a_full", "commit", "wait", "sync2", "issue W",
                "issue x")
_STAMP_HEAD = (
    '#include "w8a8.cuh"\n#include "wgmma_tile.cuh"\n'
    "namespace gemm_hls{ namespace v_stamps {\n"
    "__device__ long long w8_stamps[2048];\n"
    "__device__ __forceinline__ int w8_slot() {\n"
    "  const int b = blockIdx.y * gridDim.x + blockIdx.x;\n"
    "  return b == 0 ? 0 : b == 140 ? 1024 : -1;\n}\n} }\n"
    "#define W8_STAMP(i) do { const int s_ = w8_slot(); "
    "if (s_ >= 0) w8_stamps[s_ + (i)] = global_ns(); } while (0)\n")
_STAMP_TAIL = (
    '\nextern "C" int w8a8_stamps_read(void* host) {\n'
    "  return static_cast<int>(cudaMemcpyFromSymbol(host, gemm_hls::v_stamps::w8_stamps, "
    "2048 * 8));\n}\n"
    'extern "C" int w8a8_stamps_clear() {\n'
    "  static const long long zeros[2048] = {};\n"
    "  return static_cast<int>(cudaMemcpyToSymbol(gemm_hls::v_stamps::w8_stamps, zeros, "
    "2048 * 8));\n}\n")
# The store before staging: each thread's value pairs straight from its
# registers, masked to M x N.
_DIRECT_STORE = """template <typename Out, int BN, bool kBlocks>
__device__ __forceinline__ void w8_direct(const W8Args& g, const int (&part)[BN / 2],
                                          const float (&acc)[kBlocks ? BN / 2 : 1], int r0, int c0) {
  using Pair = PairOf<Out>;
  Out* out = static_cast<Out*>(g.out);
  const float frs[2] = {w8_fold_rs(g, 0, r0), w8_fold_rs(g, 0, r0 + 8)};
  const float srs[2] = {w8_store_rs(g, r0), w8_store_rs(g, r0 + 8)};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = c0 + 8 * j;
    if (c >= g.N) continue;
    const float fcs[2] = {w8_fold_cs(g, 0, c), w8_fold_cs(g, 0, c + 1)};
    const float scs[2] = {w8_store_cs(g, c), w8_store_cs(g, c + 1)};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= g.M) continue;
      float v[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int e = 4 * j + 2 * h + q;
        float b;
        if constexpr (kBlocks) b = acc[e];
        else b = g.mode == kIntAcc ? __int2float_rn(part[e])
                                   : __fadd_rn(0.f, w8_part(part[e], frs[h], fcs[q]));
        v[q] = w8_out(b, scs[q], srs[h]);
      }
      *reinterpret_cast<typename Pair::P*>(out + static_cast<int64_t>(r) * g.N + c) =
          Pair::make(cast_out<Out>(v[0]), cast_out<Out>(v[1]));
    }
  }
}

"""
# (old, new) text patches of the source.  Stamp slot 64 p + t holds point p
# of step t (STAMP_POINTS); 576 / 577 / 578: the block's start, the end of
# its products, its store done.
VARIANTS = {
    "noturn": [("  if (!u.live) return;\n", "  return;\n")],
    "noproducts": [(
        "for (int kk = 0; kk < 4; ++kk) W8Mma<BN>::run(part, da + 2 * kk, db + 2 * kk, "
        "!opens || kk > 0);",
        "if (g.M < 0) W8Mma<BN>::run(part, da, db, !opens);")],
    "direct_store": [
        ("  const float* sx;  // kFused: (K / bk, M); otherwise (M,)\n",
         "  const float* sx;  // kFused: (K / bk, M); otherwise (M,)\n  void* out;\n"),
        ("  g.sx = static_cast<const float*>(sx);\n",
         "  g.sx = static_cast<const float*>(sx);\n  g.out = out;\n"),
        ("template <typename Out, int BN, bool kBlocks>\n__device__ __forceinline__ void w8_store(",
         _DIRECT_STORE + "template <typename Out, int BN, bool kBlocks>\n"
         "__device__ __forceinline__ void w8_store("),
        ("  w8_stage<Out, BN, kBlocks>(g, part, acc, r0, c0, m0, n0, stage);\n",
         "  if (g.M > 0) {\n    w8_direct<Out, BN, kBlocks>(g, part, acc, r0, c0);\n    return;\n  }\n"
         "  w8_stage<Out, BN, kBlocks>(g, part, acc, r0, c0, m0, n0, stage);\n"),
    ],
    "stamps": [
        ('#include "w8a8.cuh"\n', _STAMP_HEAD),
        ("    mbar_wait(&bars->w_full[w], (t / kW8WStages) & 1, g.spin);\n    w8_turn<BN>",
         "    if (tid == 0) W8_STAMP(t);\n"
         "    mbar_wait(&bars->w_full[w], (t / kW8WStages) & 1, g.spin);\n"
         "    if (tid == 0) W8_STAMP(64 + t);\n    w8_turn<BN>"),
        ("    named_sync(1, kW8Consumers);\n    if (tid == 0) mbar_arrive",
         "    named_sync(1, kW8Consumers);\n    if (tid == 0) W8_STAMP(128 + t);\n"
         "    if (tid == 0) mbar_arrive"),
        ("    mbar_wait(&bars->a_full[a], (t / kW8AStages) & 1, g.spin);\n    const uint64_t da",
         "    mbar_wait(&bars->a_full[a], (t / kW8AStages) & 1, g.spin);\n"
         "    if (tid == 0) W8_STAMP(192 + t);\n    const uint64_t da"),
        ("    wg_commit();\n    if (kBlocks &&",
         "    wg_commit();\n    if (tid == 0) W8_STAMP(256 + t);\n    if (kBlocks &&"),
        ("    if (t > 0) {\n      named_sync(2, kW8Consumers);",
         "    if (tid == 0) W8_STAMP(320 + t);\n    if (t > 0) {\n      named_sync(2, kW8Consumers);"),
        ("its B tile and x slab are free\n",
         "its B tile and x slab are free\n      if (tid == 0) W8_STAMP(384 + t);\n"),
        ("    tma_load_2d(smem + L::kW + w * L::kRaw",
         "    W8_STAMP(448 + t);\n    tma_load_2d(smem + L::kW + w * L::kRaw"),
        ("    tma_load_2d(smem + a * kW8A", "    W8_STAMP(512 + t);\n    tma_load_2d(smem + a * kW8A"),
        ("  if (tid == 0) {\n    for (int i = 0; i < kW8AStages; ++i) {",
         "  if (tid == 0) W8_STAMP(576);\n  if (tid == 0) {\n"
         "    for (int i = 0; i < kW8AStages; ++i) {"),
        ("  wg_wait<0>();\n  wg_pin(part);\n",
         "  wg_wait<0>();\n  wg_pin(part);\n  if (tid == 0) W8_STAMP(577);\n"),
        ("    bulk_wait_all();  // the stores are done before the block exits\n",
         "    bulk_wait_all();  // the stores are done before the block exits\n"
         "    W8_STAMP(578);\n"),
    ],
}


def patch_source(name: str, text: str, patches, entry: str) -> str:
    """The kernel source ``text`` with ``patches`` ((old, new) pairs) applied,
    its kernel in namespace gemm_hls::v_<name> and its entry point
    <entry>_<name>, so that variants of one source share a library."""
    for old, new in patches:
        if old not in text:
            raise ValueError(f"variant {name}: its patch no longer matches: {old[:60]!r}")
        text = text.replace(old, new)
    text = text.replace("namespace gemm_hls {", f"namespace gemm_hls {{ namespace v_{name} {{", 1)
    text = text.replace("}  // namespace gemm_hls", "} }  // namespace gemm_hls", 1)
    text = text.replace("using namespace gemm_hls;",
                        f"using namespace gemm_hls;\nusing namespace gemm_hls::v_{name};")
    return text.replace(f'extern "C" int {entry}(', f'extern "C" int {entry}_{name}(')


def build_variants(tag: str, sources) -> Path:
    """One library of ``sources`` ({file name: text}) beside copies of the
    headers, under the gitignored build/<tag>/; prints each source's
    compile seconds, the ptxas registers, spills and C75xx warnings."""
    src = _build.BUILD_DIR / tag / "csrc"
    shutil.rmtree(src, ignore_errors=True)
    src.mkdir(parents=True)
    for f in _build.CSRC_DIR.glob("*.cuh"):
        shutil.copy(f, src / f.name)
    for name, text in sources.items():
        (src / name).write_text(text)
    _build.CSRC_DIR, _build.BUILD_DIR = src, src.parent
    path = _build.build()
    for ln in path.with_suffix(".log").read_text().splitlines():
        if (ln.startswith("== ") or "registers" in ln or "C75" in ln
                or ("spill" in ln and " 0 bytes spill stores" not in ln)):
            print(ln.strip()[:170])
    return path


def build(names) -> ctypes.CDLL:
    """The tree's kernel and ``names``' variants in one library."""
    text = (_build.CSRC_DIR / SOURCE).read_text()
    lib = ctypes.CDLL(str(build_variants("w8a8-ab", {
        f"w8a8_{name}.cu": patch_source(name, text, VARIANTS.get(name, []), "w8a8_wgmma")
        + (_STAMP_TAIL if name == "stamps" else "") for name in ("tree", *names)})))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("tree", *names):
        fn = getattr(lib, f"w8a8_wgmma_{name}")
        fn.restype = i32
        fn.argtypes = [vp] * 5 + [i32] * 8 + [vp]
    return lib


def stamp_report(lib, shape: str, steps: int) -> None:
    host = (ctypes.c_longlong * 2048)()
    if lib.w8a8_stamps_read(host):
        raise RuntimeError("w8a8_stamps_read failed")
    for slot, which in STAMP_SLOTS.items():
        st = list(host[slot:slot + 640])
        if not st[576]:
            continue

        def rel(v, t0=st[576]):
            return round((v - t0) / 1000, 2) if v else None
        print(f"{shape} {which}: products end {rel(st[577])} us, store done {rel(st[578])} us")
        for i, point in enumerate(STAMP_POINTS):
            print(f"  {point:8s}", [rel(st[64 * i + t]) for t in range(steps)])


def main(argv=None) -> int:
    sys.path.insert(0, str(REPO))
    import chip_smoke

    names = (argv if argv is not None else sys.argv[1:]) or list(VARIANTS)
    if not torch.cuda.is_available():
        print("w8a8_ab: needs a CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.nvidia_smi())
    lib = build(names)
    stream = torch.cuda.current_stream().cuda_stream
    for shape, (m, k, n) in SHAPES.items():
        w = torch.randn((k, n), device="cuda") * k ** -0.5
        wq, s = (torch.from_numpy(a).cuda() for a in quantize_weights(w.cpu().numpy(), bits=8))
        x = (torch.randn((m, k), device="cuda") * 0.5).to(torch.bfloat16)
        xq, sx = dequant._quantize_plain(x, k, False)
        xq, sx = xq.contiguous(), sx.reshape(-1).contiguous()
        bn = dequant.w8a8_engine_plan(m, n, k, k, "int_acc", dequant.sm_count(x.device))
        runs = {f"tree N {b}": ("tree", b) for b in dequant.W8A8_ENGINE_BN}
        runs.update({name: (name, bn) for name in names})
        ys = {key: torch.empty((m, n), dtype=torch.bfloat16, device="cuda") for key in runs}

        def gemm(key):
            name, b = runs[key]
            rc = getattr(lib, f"w8a8_wgmma_{name}")(
                xq.data_ptr(), wq.data_ptr(), s.data_ptr(), sx.data_ptr(), ys[key].data_ptr(),
                m, n, k, k, 1, dequant.W8A8_MODES["int_acc"], _build.dtype_code(torch.bfloat16),
                b, stream)
            if rc:
                raise RuntimeError(f"{key}: launch returned {rc}")
        turns = chip_smoke.time_turns(torch, {key: (lambda key=key: gemm(key)) for key in runs})
        ref = dequant.w8a8_plain(x, wq, s, bk=k, fused=False, out_dtype=torch.bfloat16)
        for key in runs:
            if runs[key][0] in ("tree", "direct_store", "stamps") and not torch.equal(ys[key], ref):
                raise AssertionError(f"{shape} {key}: differs from the plain version")
        print(f"{shape} {m}x{k}x{n} (the plan's N tile {bn}), GEMM device ms in turns: "
              + ", ".join(f"{key} {ms:.4f}" for key, ms in turns.items()))
        if "stamps" in names:
            if lib.w8a8_stamps_clear():
                raise RuntimeError("w8a8_stamps_clear failed")
            gemm("stamps")
            torch.cuda.synchronize()
            stamp_report(lib, shape, -(-k // dequant.W8A8_ENGINE_STEP))
    return 0


if __name__ == "__main__":
    sys.exit(main())
