// Kernel grouped_gemm on Hopper's tile engine: the ragged grouped GEMM of a
// mixture-of-experts FFN, out[rows(g)] = lhs[rows(g)] . rhs[g] for bf16 /
// fp16 operands with fp32 sums, rows(g) the clamped span [ends[g-1],
// ends[g]) of the row partition, the rows past the last group ([ends[G-1],
// M)) written as zeros, out in bf16, fp16 or fp32.
//
// Replaces gemm_hls_tpu/ops/pallas_grouped.py::_gmm_kernel (B16), as
// csrc/grouped_gemm.cu does and with its clamped-span convention (ROADMAP
// C2); the calls this route does not take (fp32, rows that are not whole
// 16-byte units) stay there (ops/gmm.py::grouped_route).
//
// What bounds it on an H100: at prefill (8192 routed slots x 2048 -> 4096,
// 8 experts, bf16: 137 GFLOP) the tensor-core rate, 139 us at 989 TFLOP/s.
// grouped_gemm.cu's 64 x 128 mma.sync tile reached 160 TFLOP/s there
// (little reuse per shared-memory byte, no overlap of loads across warps,
// no persistence).
//
// The design: the engine's block (csrc/wgmma_tile.cuh: a producer thread
// keeping a 4-stage TMA ring of 128 x 64 A and 64 x 256 B slabs full, two
// consumer warpgroups of m64n256k16 wgmma, 64 rows each of a 128 x 256
// tile), one persistent block a SM, walking jobs (logical tile, N tile).
// The logical tiles are the (segment, 128-row M tile) pairs of
// csrc/grouped_span.cuh, at most cdiv(M, 128) + G; every block finds its
// jobs from the device-side ends, the N tiles of one logical tile next to
// each other (a wave shares one expert's weights and a few A panels in the
// L2), and stops at the first job past the live count.  A is one 2-D
// K-major map; the experts one 3-D map with the group as its outer
// coordinate: (N, K, G) read MN-major through wgmma's transpose bit, or
// (K, N, G) K-major under transpose_rhs, never a copy.  A job computes all
// 128 rows of its M tile and stores only its own, [r_lo, r_hi), so two jobs
// that share an M tile write disjoint rows and nothing is read back; rows
// of another group or past M (zero-filled by TMA) reach no stored value.
// The zero tail's jobs store zeros and issue no MMA.  No atomics, one
// fixed K order: every launch gives the same bits.
// Measured (H100 80GB HBM3, 700 W, chip_smoke.py phase 18, device time in
// turns): 0.293 ms at w1's prefill shape (torch._grouped_mm 0.214,
// grouped_gemm.cu's tile 0.856), 0.061 ms at 128 decode slots (0.061,
// 0.094).  What is left: the 11% of tiles at group edges and a ninth wave
// of jobs, and the store, which does not overlap the next job's products.
#include "wgmma_tile.cuh"
#include "grouped_span.cuh"

namespace gemm_hls {

struct GwArgs {
  CUtensorMap ma, mb;  // lhs (K, M) K-major; rhs (N, K, G) or (K, N, G)
  const int* ends;     // (G,) cumulative row ends, clamped to [0, M]
  void* out;           // (M, N) row-major, out_code
  int M, N, K, G, out_code;
  int tiles, tiles_n;  // logical tiles' bound, N tiles
  long long spin;
};

// Job i: logical tile i / tiles_n, N tile i % tiles_n.
struct GwJob {
  int grp, m0, r_lo, r_hi, n0;
};
__device__ __forceinline__ bool gw_job(const GwArgs& g, int i, GwJob& j) {
  j.n0 = i % g.tiles_n * kWgBN;
  return locate_span(g.ends, g.G, g.M, i / g.tiles_n, kWgBM, j.grp, j.m0, j.r_lo, j.r_hi);
}

template <typename T, bool MnB>
__device__ void gw_produce(const GwArgs& g, unsigned char* smem, WgBars* bars, int ksteps) {
  int stage = 0;
  uint32_t phase = 0;
  GwJob jb;
  for (int i = blockIdx.x; i < g.tiles * g.tiles_n && gw_job(g, i, jb); i += gridDim.x) {
    if (jb.grp == g.G) continue;  // the zero tail: nothing to load
    for (int kt = 0; kt < ksteps; ++kt) {
      mbar_wait(&bars->empty[stage], phase ^ 1, g.spin);
      mbar_expect_tx(&bars->full[stage], kWgStage);
      unsigned char* st = smem + stage * kWgStage;
      uint64_t* bar = &bars->full[stage];
      tma_load_2d(st, &g.ma, kt * 64, jb.m0, bar);
      if constexpr (MnB) {
#pragma unroll
        for (int h = 0; h < kWgBN / 64; ++h)
          tma_load_3d(st + kWgTileA + h * kWgMnBox, &g.mb, jb.n0 + 64 * h, kt * 64, jb.grp, bar);
      } else {
        tma_load_3d(st + kWgTileA, &g.mb, kt * 64, jb.n0, jb.grp, bar);
      }
      if (++stage == kWgStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// The 128 values of this thread as Out, rows [r_lo, r_hi) and columns < N
// only, (c, c + 1) of a row as one store where both are inside and N is
// even (every row start then aligned).
template <typename Out>
__device__ __forceinline__ void gw_store_as(const float (&d)[128], const GwArgs& g, int r0, int c0,
                                            int r_lo, int r_hi) {
  using Pair = PairOf<Out>;
  Out* out = static_cast<Out*>(g.out);
  const bool pairs = g.N % 2 == 0;
#pragma unroll
  for (int i = 0; i < 128; i += 2) {
    const int r = r0 + 8 * ((i % 4) / 2), c = c0 + 8 * (i / 4);
    if (r < r_lo || r >= r_hi || c >= g.N) continue;
    Out* p = out + static_cast<int64_t>(r) * g.N + c;
    if (pairs) {
      *reinterpret_cast<typename Pair::P*>(p) = Pair::make(cast_out<Out>(d[i]), cast_out<Out>(d[i + 1]));
    } else {
      p[0] = cast_out<Out>(d[i]);
      if (c + 1 < g.N) p[1] = cast_out<Out>(d[i + 1]);
    }
  }
}

template <typename T, bool MnB>
__device__ void gw_consume(const GwArgs& g, unsigned char* smem, WgBars* bars, int ksteps) {
  using SB = WgSlab<MnB>;
  const int wg = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
  const int lane = tid % 32, warp = tid / 32;
  const uint32_t base = smem_u32(smem);
  float d[128];
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  GwJob jb;
  for (int i = blockIdx.x; i < g.tiles * g.tiles_n && gw_job(g, i, jb); i += gridDim.x) {
    if (jb.grp == g.G) {
#pragma unroll
      for (int x = 0; x < 128; ++x) d[x] = 0.f;
    } else {
      wg_pin(d);
      for (int kt = 0; kt < ksteps; ++kt) {
        mbar_wait(&bars->full[stage], phase, g.spin);
        const uint32_t st = base + stage * kWgStage;
        // This warpgroup's 64 rows: half of A's K-major box.
        const uint64_t da = wg_desc(st + wg * kWgMnBox), db = SB::desc(st + kWgTileA);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          WgMma<T, false, MnB>::run(d, da + 2 * kk, db + SB::kStep * kk, kt > 0 || kk > 0);
        wg_commit();
        if (kt > 0) {
          wg_wait<1>();  // the group that read stage prev has retired
          mbar_arrive(&bars->empty[prev]);
        }
        prev = stage;
        if (++stage == kWgStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wg_wait<0>();
      mbar_arrive(&bars->empty[prev]);
      wg_pin(d);
    }
    const int r0 = jb.m0 + 64 * wg + 16 * warp + lane / 4, c0 = jb.n0 + 2 * (lane % 4);
    switch (g.out_code) {
      case kF32: gw_store_as<float>(d, g, r0, c0, jb.r_lo, jb.r_hi); break;
      case kBF16: gw_store_as<__nv_bfloat16>(d, g, r0, c0, jb.r_lo, jb.r_hi); break;
      case kF16: gw_store_as<__half>(d, g, r0, c0, jb.r_lo, jb.r_hi); break;
    }
  }
}

// MnB: rhs held (G, K, N), read MN-major; else (G, N, K), K-major.
template <typename T, bool MnB>
__global__ void __launch_bounds__(kWgThreads, 1) grouped_wg_kernel(const __grid_constant__ GwArgs g) {
  extern __shared__ unsigned char dyn_smem[];
  unsigned char* smem = wg_align(dyn_smem);
  WgBars* bars = reinterpret_cast<WgBars*>(smem + kWgStages * kWgStage);
  if (threadIdx.x == 0) wg_init_bars(bars);
  __syncthreads();
  const int ksteps = (g.K + 63) / 64;
  if (threadIdx.x < 128) {
    reg_dealloc<40>();
    if (threadIdx.x == 0) gw_produce<T, MnB>(g, smem, bars, ksteps);
  } else {
    reg_alloc<232>();
    gw_consume<T, MnB>(g, smem, bars, ksteps);
  }
}

template <typename T, bool MnB>
int launch_grouped_wg(GwArgs& g, const void* lhs, const void* rhs, cudaStream_t st) {
  constexpr bool f16 = std::is_same<T, __half>::value;
  const int64_t kn = static_cast<int64_t>(g.K) * g.N;
  const int64_t dims_t[3] = {g.K, g.N, g.G}, strides_t[2] = {2ll * g.K, 2 * kn};
  const int64_t dims_n[3] = {g.N, g.K, g.G}, strides_n[2] = {2ll * g.N, 2 * kn};
  const int box_t[3] = {64, kWgBN, 1}, box_n[3] = {64, 64, 1};
  const bool ok = encode_kmajor(&g.ma, lhs, g.M, g.K, 2, kWgBM, g.K, f16) &&
                  (MnB ? encode_nd(&g.mb, rhs, 3, dims_n, strides_n, box_n, 2, f16)
                       : encode_nd(&g.mb, rhs, 3, dims_t, strides_t, box_t, 2, f16));
  if (!ok) return kTmaEncodeFailed;
  auto kern = grouped_wg_kernel<T, MnB>;
  static const int attr = static_cast<int>(
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem));
  if (attr) return attr;
  int dev = 0, sms = 0;
  int err = cudaGetDevice(&dev);
  if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return err;
  const int64_t jobs = static_cast<int64_t>(g.tiles) * g.tiles_n;
  if (jobs > INT_MAX) return kUnsupported;
  kern<<<static_cast<unsigned>(jobs < sms ? jobs : sms), kWgThreads, kWgSmem, st>>>(g);
  return last_error();
}

}  // namespace gemm_hls

using namespace gemm_hls;

// lhs (M, K) and rhs (G, K, N) (trb: (G, N, K)) in ``in_code``'s type (bf16
// or fp16), K whole 16-byte units (and N too without trb), bases 16-byte
// aligned; ends (G,) int32 cumulative group ends clamped to [0, M]; out
// (M, N) in ``out_code``'s type (fp32, bf16 or fp16).  Returns 0, a CUDA
// error code, -1 for what the route does not take, or -2 for a tensor map
// cuTensorMapEncodeTiled refused.
extern "C" int grouped_wgmma(const void* lhs, const void* rhs, const void* ends, void* out, int M,
                             int N, int K, int G, int trb, int in_code, int out_code,
                             void* stream) {
  if (M < 1 || N < 1 || K < 1 || G < 1) return kUnsupported;
  if (out_code != kF32 && out_code != kBF16 && out_code != kF16) return kUnsupported;
  GwArgs g{};
  g.ends = static_cast<const int*>(ends);
  g.out = out;
  g.M = M;
  g.N = N;
  g.K = K;
  g.G = G;
  g.out_code = out_code;
  g.tiles = (M + kWgBM - 1) / kWgBM + G;
  g.tiles_n = (N + kWgBN - 1) / kWgBN;
  g.spin = spin_cycles(10000);  // a stage wait is microseconds; 10 s means a lost load
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (in_code) {
    case kBF16:
      return trb ? launch_grouped_wg<__nv_bfloat16, false>(g, lhs, rhs, st)
                 : launch_grouped_wg<__nv_bfloat16, true>(g, lhs, rhs, st);
    case kF16:
      return trb ? launch_grouped_wg<__half, false>(g, lhs, rhs, st)
                 : launch_grouped_wg<__half, true>(g, lhs, rhs, st);
    default: return kUnsupported;
  }
}
