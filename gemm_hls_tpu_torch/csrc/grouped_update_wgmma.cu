// Kernel grouped_update on Hopper's tile engine: the weight gradient of the
// ragged grouped GEMM of a mixture-of-experts FFN, out[g] = lhs[rows(g)]^T .
// gbar[rows(g)] for every group g: (M, K) and (M, N) in bf16 / fp16, (G, K,
// N) out in fp32, bf16 or fp16, summed in fp32, with rows(g) the clamped
// span [ends[g-1], ends[g]) of the device-side group ends (csrc/
// grouped_span.cuh's partition, ROADMAP C2).  A group with no rows gets a
// zero block.
//
// Replaces gemm_hls_tpu/ops/pallas_grouped.py::_tgmm_kernel (B17, called
// at :399), as csrc/grouped_update.cu does; the calls this route does not
// take (fp32, rows that are not whole 16-byte units, no rows at all) stay
// there (ops/gmm.py::grouped_update_route).
//
// What bounds it on an H100: at the MoE step's shapes (8192 routed slots,
// (8, 2048, 4096) or (8, 4096, 2048) out, bf16) the tensor-core rate, 2 x
// 8192 x 2048 x 4096 operations in 139 us at 989 TFLOP/s, against 70 us for
// its 235 MB.  grouped_update.cu's 128 x 128 mma.sync blocks took 0.780 ms.
//
// The design: the engine's block (csrc/wgmma_tile.cuh: a producer thread
// keeping a 4-stage TMA ring full, two consumer warpgroups of m64n256k16
// wgmma, 64 rows each of a 128 x 256 tile), one persistent block a SM,
// walking jobs (group, 128-row tile of K, 256-column tile of N) flattened
// group-major, job i to block i mod n: a wave shares one expert's rows in
// the L2, and every job of a group has that group's depth, so a block takes
// one or two jobs of every group and a skewed routing stays balanced while
// a group has as many jobs as there are SMs (256 at the MoE shapes).  The
// contraction runs over rows, so both operands are MN-major in the
// engine's terms (lhs is A held (rows, K), gbar is B held (rows, N): B1's
// transpose bits and 64-value boxes), each one 2-D map over its whole
// array.  A job's slabs are 64 rows from the group's first row, r_lo (a
// TMA coordinate need not be a multiple of anything), ceil(span / 64) of
// them, read on the device from the ends: nothing reaches the host.
//
// The last slab overruns the span into the next group's rows, or rows past
// the groups that may hold NaN; TMA zero-fills only past M.  In an
// MN-major box every contraction row is one whole 128-byte line, which the
// 128-byte swizzle permutes within but never moves, so each consumer
// warpgroup zeroes those lines in its A box and in all four B boxes (0 x
// NaN is NaN: both operands), then fence.proxy.async.shared::cta and a
// barrier over its own threads before its wgmma reads the stage (generic
// writes, async-proxy reads).  The two warpgroups write the same zeros to
// the B boxes, so neither waits for the other.  Empty groups store zeros
// and issue no load or MMA (the zeros never pass through the accumulator:
// a non-wgmma write to it makes ptxas serialise the kernel's wgmma).  One
// fixed order, no atomics, no split-K: every launch gives the same bits.
// The tile leaves from registers (TileOut, wg_store_as) at out + g K N.
#include "wgmma_tile.cuh"

namespace gemm_hls {

struct GuArgs {
  CUtensorMap ma, mb;  // lhs (M, K) and gbar (M, N), each read MN-major
  const int* ends;     // (G,) cumulative row ends, clamped to [0, M]
  void* out;           // (G, K, N) row-major, out_code
  int M, K, N, G, out_code;
  int tiles_k, tiles_n;
  long long spin;
};

// Job i: group i / (tiles_k tiles_n), then its K tile, then its N tile.
struct GuJob {
  int grp, k0, n0, r_lo, slabs;
  int zero_lo, zero_hi;  // lines of the last slab past the span, up to M
};
__device__ __forceinline__ GuJob gu_job(const GuArgs& g, int i) {
  const int per = g.tiles_k * g.tiles_n, t = i % per;
  GuJob j;
  j.grp = i / per;
  j.k0 = t / g.tiles_n * kWgBM;
  j.n0 = t % g.tiles_n * kWgBN;
  j.r_lo = j.grp > 0 ? g.ends[j.grp - 1] : 0;
  const int span = max(g.ends[j.grp] - j.r_lo, 0);
  j.slabs = (span + 63) / 64;
  // Rows past M are zero-filled by TMA: only rows of the array need zeros.
  const int last = j.r_lo + 64 * (j.slabs - 1);
  j.zero_lo = j.r_lo + span - last;
  j.zero_hi = min(64, g.M - last);
  return j;
}

__device__ void gu_produce(const GuArgs& g, unsigned char* smem, WgBars* bars, int jobs) {
  int stage = 0;
  uint32_t phase = 0;
  for (int i = blockIdx.x; i < jobs; i += gridDim.x) {
    const GuJob jb = gu_job(g, i);
    for (int s = 0; s < jb.slabs; ++s) {
      mbar_wait(&bars->empty[stage], phase ^ 1, g.spin);
      mbar_expect_tx(&bars->full[stage], kWgStage);
      unsigned char* st = smem + stage * kWgStage;
      uint64_t* bar = &bars->full[stage];
      const int r = jb.r_lo + 64 * s;
#pragma unroll
      for (int h = 0; h < kWgBM / 64; ++h) tma_load_2d(st + h * kWgMnBox, &g.ma, jb.k0 + 64 * h, r, bar);
#pragma unroll
      for (int h = 0; h < kWgBN / 64; ++h)
        tma_load_2d(st + kWgTileA + h * kWgMnBox, &g.mb, jb.n0 + 64 * h, r, bar);
      if (++stage == kWgStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// Lines [lo, hi) of this warpgroup's A box and of the four B boxes of the
// stage at ``st``, zeroed and fenced for the async proxy.
__device__ __forceinline__ void gu_zero_tail(unsigned char* st, int lo, int hi, int wg) {
  constexpr int kUnits = kWgRowBytes / 16;  // 16-byte units of a line
  const int lines = hi - lo;
  for (int u = threadIdx.x % 128; u < 5 * lines * kUnits; u += 128) {
    const int box = u / (lines * kUnits), line = lo + u / kUnits % lines;
    unsigned char* b = box == 0 ? st + wg * kWgMnBox : st + kWgTileA + (box - 1) * kWgMnBox;
    *reinterpret_cast<uint4*>(b + line * kWgRowBytes + 16 * (u % kUnits)) = make_uint4(0u, 0u, 0u, 0u);
  }
  fence_proxy_async_shared();
  named_sync(2 + wg, 128);
}

// This warpgroup's 64 x 256 part of an empty group's tile, zeros stored
// without the accumulator: an instruction that sets it outside wgmma makes
// ptxas serialise every wgmma of the kernel.
template <typename Out>
__device__ __forceinline__ void gu_store_zero(const GuArgs& g, const GuJob& jb, int wg) {
  Out* out = static_cast<Out*>(g.out) + static_cast<int64_t>(jb.grp) * g.K * g.N;
  for (int e = threadIdx.x % 128; e < 64 * kWgBN; e += 128) {
    const int r = jb.k0 + 64 * wg + e / kWgBN, c = jb.n0 + e % kWgBN;
    if (r < g.K && c < g.N) out[static_cast<int64_t>(r) * g.N + c] = cast_out<Out>(0.f);
  }
}

// The tile (or an empty group's zeros) as Out: the output type fixed once
// a tile, bf16 / fp16 / fp32 only.
template <typename Out>
__device__ __forceinline__ void gu_store(const float (&d)[128], const GuArgs& g, const GuJob& jb,
                                         int wg) {
  if (jb.slabs == 0) {
    gu_store_zero<Out>(g, jb, wg);
    return;
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x % 128 / 32;
  const TileOut o{nullptr, 0, g.out, static_cast<int64_t>(jb.grp) * g.K * g.N, g.N, g.out_code, 0};
  wg_store_as<Out>(d, o, jb.k0 + 64 * wg + 16 * warp + lane / 4, jb.n0 + 2 * (lane % 4), g.K, g.N);
}

template <typename T>
__device__ void gu_consume(const GuArgs& g, unsigned char* smem, WgBars* bars, int jobs) {
  const int wg = threadIdx.x / 128 - 1;
  const uint32_t base = smem_u32(smem);
  float d[128];
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int i = blockIdx.x; i < jobs; i += gridDim.x) {
    const GuJob jb = gu_job(g, i);
    if (jb.slabs > 0) {
      wg_pin(d);
      for (int s = 0; s < jb.slabs; ++s) {
        mbar_wait(&bars->full[stage], phase, g.spin);
        if (s == jb.slabs - 1 && jb.zero_lo < jb.zero_hi)
          gu_zero_tail(smem + stage * kWgStage, jb.zero_lo, jb.zero_hi, wg);
        const uint32_t st = base + stage * kWgStage;
        // This warpgroup's 64 rows of K: one of A's two MN-major boxes.
        const uint64_t da = wg_desc_mn(st + wg * kWgMnBox), db = wg_desc_mn(st + kWgTileA);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          WgMma<T, true, true>::run(d, da + 128 * kk, db + 128 * kk, s > 0 || kk > 0);
        wg_commit();
        if (s > 0) {
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
    switch (g.out_code) {
      case kF32: gu_store<float>(d, g, jb, wg); break;
      case kBF16: gu_store<__nv_bfloat16>(d, g, jb, wg); break;
      case kF16: gu_store<__half>(d, g, jb, wg); break;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWgThreads, 1) grouped_update_wg_kernel(const __grid_constant__ GuArgs g) {
  extern __shared__ unsigned char dyn_smem[];
  unsigned char* smem = wg_align(dyn_smem);
  WgBars* bars = reinterpret_cast<WgBars*>(smem + kWgStages * kWgStage);
  if (threadIdx.x == 0) wg_init_bars(bars);
  __syncthreads();
  const int jobs = g.G * g.tiles_k * g.tiles_n;
  if (threadIdx.x < 128) {
    reg_dealloc<40>();
    if (threadIdx.x == 0) gu_produce(g, smem, bars, jobs);
  } else {
    reg_alloc<232>();
    gu_consume<T>(g, smem, bars, jobs);
  }
}

template <typename T>
int launch_grouped_update_wg(GuArgs& g, const void* lhs, const void* gbar, cudaStream_t st) {
  constexpr bool f16 = std::is_same<T, __half>::value;
  if (!encode_mnmajor(&g.ma, lhs, g.M, g.K, g.K, f16) || !encode_mnmajor(&g.mb, gbar, g.M, g.N, g.N, f16))
    return kTmaEncodeFailed;
  auto kern = grouped_update_wg_kernel<T>;
  static const int attr = static_cast<int>(
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem));
  if (attr) return attr;
  int dev = 0, sms = 0;
  int err = cudaGetDevice(&dev);
  if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return err;
  const int64_t jobs = static_cast<int64_t>(g.G) * g.tiles_k * g.tiles_n;
  if (jobs > INT_MAX) return kUnsupported;
  kern<<<static_cast<unsigned>(jobs < sms ? jobs : sms), kWgThreads, kWgSmem, st>>>(g);
  return last_error();
}

}  // namespace gemm_hls

using namespace gemm_hls;

// lhs (M, K) and g (M, N) in ``in_code``'s type (bf16 or fp16), K and N
// whole 16-byte units, bases 16-byte aligned, M >= 1; ends (G,) int32
// cumulative group ends clamped to [0, M] (nondecreasing); out (G, K, N) in
// ``out_code``'s type (fp32, bf16 or fp16).  Returns 0, a CUDA error code,
// -1 for what the route does not take, or -2 for a tensor map
// cuTensorMapEncodeTiled refused.
extern "C" int grouped_update_wgmma(const void* lhs, const void* g, const void* ends, void* out,
                                    int M, int K, int N, int G, int in_code, int out_code,
                                    void* stream) {
  if (M < 1 || K < 1 || N < 1 || G < 1) return kUnsupported;
  if (out_code != kF32 && out_code != kBF16 && out_code != kF16) return kUnsupported;
  GuArgs a{};
  a.ends = static_cast<const int*>(ends);
  a.out = out;
  a.M = M;
  a.K = K;
  a.N = N;
  a.G = G;
  a.out_code = out_code;
  a.tiles_k = (K + kWgBM - 1) / kWgBM;
  a.tiles_n = (N + kWgBN - 1) / kWgBN;
  a.spin = spin_cycles(10000);  // a stage wait is microseconds; 10 s means a lost load
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (in_code) {
    case kBF16: return launch_grouped_update_wg<__nv_bfloat16>(a, lhs, g, st);
    case kF16: return launch_grouped_update_wg<__half>(a, lhs, g, st);
    default: return kUnsupported;
  }
}
