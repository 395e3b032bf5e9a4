// Kernel diag_wg_kernel: B4 on the Hopper tile engine, for up to 4
// diagonals (ops/slice_kernels.py::diag_route; the rest stays on
// csrc/int8_slices.cu's slice_gemm_kernel).
//
// Replaces gemm_hls_tpu/ops/pallas_ozaki.py::_diag_kernel (entry
// fused_int8_fp32): n int8 slices A_i (M, K) and B_j (K, N), read as B_j^T
// (N, K) rows; one int32 accumulator P_d = sum_{i+j=d} A_i . B_j per
// diagonal d < n_diags, exact over ALL of K (the wrapper checks
// n * 127^2 * K < 2^31), combined once at the store as sum_d P_d * 2^(-7d)
// in fp32, d ascending, then times the row ulp ua[m] and column ulp ub[n]
// when given.  Like the TPU kernel, a block holds every used slice's block
// of a K step and every diagonal's accumulator.
//
// What bounds it on an H100: the int8 tensor-core rate.  At 8192^3,
// i8x2 / i8x3 / i8x4 are 3 / 6 / 10 products of 1.1 TOP: 1.67 / 3.33 / 5.56
// ms at 1979 TOP/s.  The engine's B5 walk (ozaki_wg_kernel, diagonal-major,
// one slice pair a stage) reloads a slab for every pair it sits in, two 16
// KB slabs per 128 x 128 x 128 product; here each used slice's A and B^T
// slab of a K step lands once and feeds every pair it sits in:
//   * one thread of warpgroup 0 (setmaxnreg 40) keeps a ring of stages full
//     by TMA; a stage is one slice's A slab (128 rows x 128 bytes of K) and
//     B^T slab (BN rows), K-major, 128-byte swizzled, so a K step is n_used
//     stages, and the ring (192 KB) holds two or three K steps;
//   * consumer warpgroups 1 and 2 (setmaxnreg 232) own 64 rows each of the
//     128 x BN tile; as slice s of a K step arrives, every pair (i, j) with
//     max(i, j) = s and i + j < n_diags issues its four wgmma k32 (s8 x s8
//     -> s32) into acc[i + j]; one wgmma group a K step, whose stages are
//     released once the next step's group is issued and this one retired;
//   * the accumulators stay in registers: m64n128 is 64 int32 a thread a
//     diagonal, 128 for i8x2 and 192 for i8x3 (B5 runs 192 live values
//     under the same 232); i8x4's 256 would not fit, so 4 diagonals take
//     m64n64 (a 128 x 64 tile, 128 values);
//   * persistent blocks, one a SM, walk the tiles in groups of 8 tile rows
//     (tile_origin), so a wave shares its A and B^T slabs in the L2.  Slab
//     traffic at 8192^3: (128 + BN) rows x 128 bytes x n_used a tile and K
//     step, 25.8 GB at i8x3 (B5's walk would move 51.5).
// Every P_d is exact, so the order of the products inside it is free; the
// fp32 sum after it is written with __fadd_rn / __fmul_rn, d ascending, as
// fused_int8_fp32_plain and slice_gemm_kernel round it: the same bits on
// either route.  The K tail past K is zero-filled by TMA.
#include "wgmma_tile.cuh"

namespace gemm_hls {

constexpr int kDgBM = 128, kDgMaxDiags = 4;
constexpr int kDgRing = 192 * 1024;  // the stages' bytes
constexpr int kDgMaxStages = 8;

// The tile of up to 3 diagonals (BN 128) or 4 (BN 64).
template <int BN> struct DgTile {
  static constexpr int kA = kDgBM * kWgRowBytes;  // one slice's A slab: 16 KB
  static constexpr int kStage = kA + BN * kWgRowBytes;
  static constexpr int kStages = kDgRing / kStage;  // 6 (BN 128) or 8 (BN 64)
  static constexpr int kMaxUsed = BN == 128 ? 3 : kDgMaxDiags;
  static_assert(kStages <= kDgMaxStages && kStages >= 2 * kMaxUsed, "two K steps in flight");
};
struct DgBars {
  uint64_t full[kDgMaxStages], empty[kDgMaxStages];
};
constexpr int kDgSmem = 1024 + kDgRing + static_cast<int>(sizeof(DgBars));

struct DgArgs {
  CUtensorMap a[kDgMaxDiags];  // A_i: (M, K), boxes of 128 K by 128 rows
  CUtensorMap b[kDgMaxDiags];  // B_j^T: (N, K), boxes of 128 K by BN rows
  float* c;                    // (M, N) fp32
  const float* ua;             // (M,) row ulps, or null
  const float* ub;             // (N,) column ulps
  int M, N, K, n_used, n_diags;
  long long spin;
};

template <int BN>
__device__ __forceinline__ void dg_mma(int (&d)[BN / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (BN == 128) wgmma_s8_n128(d, da, db, scale_d);
  else wgmma_s8_n64(d, da, db, scale_d);
}

// 2^(-7 d) as an fp32 bit pattern (d <= 8: a normal number).
__device__ __forceinline__ float dg_weight(int d) { return __int_as_float((127 - 7 * d) << 23); }

// Diagonal d has a pair of used slices: its first one, (d / 2, d - d / 2),
// is (ceil(d / 2) < n_used).
__device__ __forceinline__ bool dg_live(int d, int n_used) { return (d + 1) / 2 < n_used; }

// The producer (one thread): the consumers' walk, a stage a slice.
template <int BN>
__device__ void dg_produce(const DgArgs& g, unsigned char* smem, DgBars* bars) {
  using T = DgTile<BN>;
  const int tiles_m = (g.M + kDgBM - 1) / kDgBM, tiles_n = (g.N + BN - 1) / BN;
  const int ksteps = (g.K + kWgRowBytes - 1) / kWgRowBytes;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles_m * tiles_n; t += gridDim.x) {
    int m0, n0;
    tile_origin(t, tiles_m, tiles_n, kDgBM, BN, m0, n0);
    for (int kt = 0; kt < ksteps; ++kt)
      for (int s = 0; s < g.n_used; ++s) {
        mbar_wait(&bars->empty[stage], phase ^ 1, g.spin);
        unsigned char* st = smem + stage * T::kStage;
        mbar_expect_tx(&bars->full[stage], T::kStage);
        tma_load_2d(st, &g.a[s], kt * kWgRowBytes, m0, &bars->full[stage]);
        tma_load_2d(st + T::kA, &g.b[s], kt * kWgRowBytes, n0, &bars->full[stage]);
        if (++stage == T::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
  }
}

// Slice s of K step kt has landed in ring position first + s: issue every
// pair (i, j) with max(i, j) = s, i + j < n_diags (i ascending, then j), its
// four k32 slices into acc[i + j].  A diagonal's first pair, (d / 2, d -
// d / 2), is also its first issued, so it alone starts the tile's sum.
template <int MAXD, int BN>
__device__ __forceinline__ void dg_issue(int (&acc)[MAXD][BN / 2], const DgArgs& g, uint32_t base,
                                         int first, int s, int kt, int wg) {
  using T = DgTile<BN>;
  auto slab = [&](int i) { return base + ((first + i) % T::kStages) * T::kStage; };
#pragma unroll
  for (int i = 0; i < MAXD; ++i)
#pragma unroll
    for (int j = 0; j < MAXD - i; ++j) {
      if ((i == s || j == s) && i <= s && j <= s && i < g.n_used && j < g.n_used &&
          i + j < g.n_diags) {
        const int d = i + j;
        const bool opens = kt == 0 && i == d / 2 && j == d - d / 2;
        const uint64_t da = wg_desc(slab(i) + wg * 64 * kWgRowBytes);
        const uint64_t db = wg_desc(slab(j) + T::kA);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          dg_mma<BN>(acc[i + j], da + 2 * kk, db + 2 * kk, !opens || kk > 0);
      }
    }
}

// A consumer warpgroup: 64 rows of each tile.
template <int MAXD, int BN>
__device__ void dg_consume(const DgArgs& g, unsigned char* smem, DgBars* bars) {
  using T = DgTile<BN>;
  const int wg = threadIdx.x / 128 - 1, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int tiles_m = (g.M + kDgBM - 1) / kDgBM, tiles_n = (g.N + BN - 1) / BN;
  const int ksteps = (g.K + kWgRowBytes - 1) / kWgRowBytes;
  const uint32_t base = smem_u32(smem);
  int acc[MAXD][BN / 2];
  int next = 0;  // ring position of the next stage to arrive (mod kStages)
  uint32_t phase = 0;
  auto release = [&](int first) {
    for (int s = 0; s < g.n_used; ++s) mbar_arrive(&bars->empty[(first + s) % T::kStages]);
  };
  for (int t = blockIdx.x; t < tiles_m * tiles_n; t += gridDim.x) {
    int m0, n0;
    tile_origin(t, tiles_m, tiles_n, kDgBM, BN, m0, n0);
    int prev = -1;
#pragma unroll
    for (int d = 0; d < MAXD; ++d) wg_pin(acc[d]);
    for (int kt = 0; kt < ksteps; ++kt) {
      const int first = next;
      for (int s = 0; s < g.n_used; ++s) {
        mbar_wait(&bars->full[next], phase, g.spin);
        wg_fence();
        dg_issue<MAXD, BN>(acc, g, base, first, s, kt, wg);
        if (++next == T::kStages) {
          next = 0;
          phase ^= 1;
        }
      }
      wg_commit();
      if (prev >= 0) {
        wg_wait<1>();  // the previous K step's products have retired
        release(prev);
      }
      prev = first;
    }
    wg_wait<0>();
    release(prev);
#pragma unroll
    for (int d = 0; d < MAXD; ++d) wg_pin(acc[d]);
    // Value 4 jn + 2 h + q of the m64nBN fragment: row r0 + 8 h, column
    // c0 + 8 jn + q.
    const int r0 = m0 + 64 * wg + 16 * warp + lane / 4, c0 = n0 + 2 * (lane % 4);
    const bool pairs = g.N % 2 == 0;
#pragma unroll
    for (int e = 0; e < BN / 2; e += 2) {
      const int r = r0 + 8 * ((e % 4) / 2), c = c0 + 8 * (e / 4);
      if (r >= g.M || c >= g.N) continue;
      float v[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        // sum_d P_d 2^(-7d), d ascending, then the ulps: the plain order.
        float out = __int2float_rn(acc[0][e + q]);
#pragma unroll
        for (int d = 1; d < MAXD; ++d)
          if (d < g.n_diags && dg_live(d, g.n_used))
            out = __fadd_rn(out, __fmul_rn(__int2float_rn(acc[d][e + q]), dg_weight(d)));
        if (g.ua && c + q < g.N) out = __fmul_rn(__fmul_rn(out, g.ua[r]), g.ub[c + q]);
        v[q] = out;
      }
      float* at = g.c + static_cast<int64_t>(r) * g.N + c;
      if (pairs) {
        *reinterpret_cast<float2*>(at) = make_float2(v[0], v[1]);
      } else {
        at[0] = v[0];
        if (c + 1 < g.N) at[1] = v[1];
      }
    }
  }
}

template <int MAXD, int BN>
__global__ void __launch_bounds__(kWgThreads, 1) diag_wg_kernel(const __grid_constant__ DgArgs g) {
  using T = DgTile<BN>;
  extern __shared__ unsigned char dyn_smem[];
  unsigned char* smem = wg_align(dyn_smem);
  DgBars* bars = reinterpret_cast<DgBars*>(smem + kDgRing);
  if (threadIdx.x == 0) {
    for (int i = 0; i < T::kStages; ++i) {
      mbar_init(&bars->full[i], 1);
      mbar_init(&bars->empty[i], 256);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    reg_dealloc<40>();
    if (threadIdx.x == 0) dg_produce<BN>(g, smem, bars);
  } else {
    reg_alloc<232>();
    dg_consume<MAXD, BN>(g, smem, bars);
  }
}

// One persistent block a SM, at most one a tile.
template <int MAXD, int BN>
int dg_launch(const DgArgs& g, cudaStream_t st) {
  auto kern = diag_wg_kernel<MAXD, BN>;
  static const int attr = static_cast<int>(
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kDgSmem));
  if (attr) return attr;
  int dev = 0, sms = 0;
  int err = cudaGetDevice(&dev);
  if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return err;
  const int64_t tiles = static_cast<int64_t>((g.M + kDgBM - 1) / kDgBM) * ((g.N + BN - 1) / BN);
  if (tiles > INT_MAX) return kUnsupported;
  kern<<<static_cast<unsigned>(tiles < sms ? tiles : sms), kWgThreads, kDgSmem, st>>>(g);
  return last_error();
}

}  // namespace gemm_hls

using namespace gemm_hls;

// a: ``n_used`` A slice pointers ((M, K), row pitch lda); b: ``n_used`` B
// slice pointers as B_j^T ((N, K), row pitch ldb); every base and pitch a
// whole number of 16-byte units; c: (M, N) fp32, row-major, scaled by ua
// (M,) and ub (N,) when both are given.  n_diags 1-4.  Returns 0, a CUDA
// error code from the launch, -1 for a diagonal count no kernel is built
// for, or -2 for a tensor map cuTensorMapEncodeTiled refused.
extern "C" int slice_diag_wgmma(const void* const* a, const void* const* b, int n_used, void* c,
                                const void* ua, const void* ub, int M, int N, int K, int64_t lda,
                                int64_t ldb, int n_diags, void* stream) {
  if (n_diags < 1 || n_diags > kDgMaxDiags || n_used < 1 || n_used > n_diags) return kUnsupported;
  const int bn = n_diags == 4 ? 64 : 128;
  DgArgs g{};
  for (int i = 0; i < n_used; ++i)
    if (!encode_kmajor(&g.a[i], a[i], M, K, 1, kDgBM, lda) ||
        !encode_kmajor(&g.b[i], b[i], N, K, 1, bn, ldb))
      return kTmaEncodeFailed;
  g.c = static_cast<float*>(c);
  g.ua = static_cast<const float*>(ua);
  g.ub = static_cast<const float*>(ub);
  g.M = M;
  g.N = N;
  g.K = K;
  g.n_used = n_used;
  g.n_diags = n_diags;
  g.spin = spin_cycles(10000);  // a stage wait is microseconds; 10 s means a lost load
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_diags) {
    case 1:
    case 2: return dg_launch<2, 128>(g, st);
    case 3: return dg_launch<3, 128>(g, st);
    default: return dg_launch<4, 64>(g, st);
  }
}
