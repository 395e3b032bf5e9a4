// Kernels B4 and B5: the integer-slice GEMMs behind the fp32-class
// precision tiers (precision="i8x2" | "i8x3" | "i8x4") and the f64-class
// Ozaki GEMM.  Operands are n int8 slices per input, A_i (M, K) and
// B_j (K, N); diagonal d of the slice triangle is the exact int32 sum
// P_d = sum_{i+j=d} A_i . B_j.
//
// Replaces two TPU kernels of gemm_hls_tpu/ops/pallas_ozaki.py:
//   * _diag_kernel (entry fused_int8_fp32, B4): one int32 accumulator per
//     diagonal carried over ALL of K (exact while n_slices * 127^2 * K <
//     2^31), combined once at the store as sum_d P_d * 2^(-7d) in fp32, d
//     ascending, then optionally times the row ulp ua[m] and column ulp
//     ub[n];
//   * _oz_kernel (entry fused_ozaki_int8, B5): the same diagonals summed
//     exactly per K block of ``flush_steps`` 64-deep K steps, each split
//     into two fp32-exact halves (p >> 12 arithmetic shift, then the low 12
//     bits) and TwoSum-flushed into resident fp32 (hi, lo) accumulators, d
//     ascending, in the TPU kernel's order; the (hi, lo) pair is the output.
// The TPU grid's sequential K axis and its VMEM scratch become a loop inside
// the block and registers; blocks carry nothing between them.
//
// Two designs.  B5 runs on the Hopper tile engine (ozaki_wg_kernel, below:
// TMA, warp-specialised wgmma, the diagonal-major walk) wherever a TMA map
// describes the slices (rows and bases of whole 16-byte units) and block_k
// is a multiple of its 128-deep slab (ops/slice_kernels.py::ozaki_route);
// B4 runs on the engine too (csrc/diag_wgmma.cu, every slice pair of a K
// step from slabs landed once) for up to 4 diagonals with such rows
// (ops/slice_kernels.py::diag_route).  B4 with more diagonals or other
// rows, and B5 on other shapes, run on slice_gemm_kernel (mma.sync).  All
// read B as B_j^T (N, K) rows, since int8 MMA operands are K-major (the
// wrapper passes transposed views, or transposes a row-major slice once).
// Every int32 diagonal is exact (the wrapper checks the bound on the K the
// kernel walks), so the order of the products inside a diagonal is free;
// the fp32 arithmetic after it (B4's weighted sum, B5's split and TwoSum)
// is written with __fadd_rn / __fmul_rn so nvcc can neither contract it
// into FMAs nor reorder it: it rounds exactly as the plain version's
// separate torch ops, and B5 gives the plain version's bits on either
// route.
//
// slice_gemm_kernel: mma.sync m16n8k32 s8 x s8 -> s32 from a ring of
// SK_STAGES shared-memory stages, each holding one 64-deep K step of every
// used slice's A tile and B^T tile, filled by cp.async (16 bytes a thread,
// zero-filled past the M, N and K edges, so the caller pads nothing);
// fragments come out of shared memory with ldmatrix (the 80-byte row
// pitch keeps both the 16-byte copies and the ldmatrix phases free of bank
// conflicts).  Within a step, each B_j fragment is loaded once and each
// A_i fragment once (A_{i+1}'s while A_i's MMAs issue), and every pair
// (i, j) with i + j < n_diags issues its MMAs into acc[i + j].  Registers
// are its design constraint: each live diagonal is a full int32
// accumulator tile.  One instantiation per diagonal count (MAXD = 2, 3, 4:
// the i8x tiers, a 128 x 64 block tile with 32 x 32 warp tiles, 32 int32
// per diagonal per thread) and a 64 x 32 tile for up to 9 diagonals (the
// 8-slice Ozaki GEMM, and B5 off the engine, whose (hi, lo) pair adds two
// fp32 tiles).  n_slices and n_diags are run-time arguments.  Blocks walk
// the output in groups of SK_GROUP_M block rows, so a wave of blocks shares
// its A and B tiles in L2.
//
// What bounds them on an H100: the int8 tensor-core rate.  At 8192^3,
// i8x2 / i8x3 / i8x4 are 3 / 6 / 10 products of 1.1 TOP: 1.67 / 3.33 /
// 5.56 ms at 1979 TOP/s; the bytes (slices read once, fp32 C written once)
// take under 0.3 ms at 3.35 TB/s.  8-slice Ozaki at 2048^3: 36 products of
// 17.2 GOP, 0.31 ms.  slice_gemm_kernel reached 15-20% of that (B5 2.12 ms
// at 2048^3, 8 slices; B4 i8x3 17.3 ms at 8192^3, 5.6 on the engine):
// mma.sync issues from
// registers that ldmatrix fills, and the nine accumulators held its tile
// to 64 x 32.  The engine's walk keeps three tiles live, so its tile is
// 128 x 128 and wgmma reads shared memory directly: B5 at 2048^3 takes
// 0.503 ms, 62% of the bound (H100 80GB HBM3, 700 W, chip_smoke.py); at
// 8192^3 the slab traffic (a slab pair a stage, 32 KB per 2 x 64 x 128 x
// 128 products) outgrows the L2 and sets the pace: 61 ms against a 20 ms
// bound (slice_gemm_kernel: 124 ms).
#include "wgmma_tile.cuh"

namespace gemm_hls {

constexpr int kSliceMaxDiags = 9;
constexpr int SK_BK = 64;        // K per pipeline stage: two m16n8k32 steps
constexpr int SK_PITCH = 80;     // shared row pitch in bytes (64 + 16)
constexpr int SK_STAGES = 3;
constexpr int SK_THREADS = 256;  // 8 warps
constexpr int SK_GROUP_M = 8;    // block rows per group of the block order

struct SliceGemm {
  const signed char* a[kSliceMaxDiags];  // slice i of A: (M, K), row pitch lda
  const signed char* b[kSliceMaxDiags];  // slice j of B, as B_j^T: (N, K), row pitch ldb
  float* c;                              // B4: C; B5: hi
  float* c2;                             // B5: lo
  const float* ua;                       // B4 scaled: (M,) row ulps, else null
  const float* ub;                       // (N,) column ulps
  int M, N, K;
  int64_t lda, ldb;
  int n_used;       // slices read: min(n_slices, n_diags)
  int n_diags;      // diagonals d < n_diags are computed
  int flush_steps;  // B5: flush every flush_steps K steps (0 for B4)
  int vec;          // every row is 16-byte aligned: cp.async copies
};

template <int MAXD, int BM, int BN, int WARPS_M>
struct SliceTile {
  static constexpr int WARPS_N = SK_THREADS / 32 / WARPS_M;
  static constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;
  static constexpr int MT = WTM / 16, NT = WTN / 8;  // m16 / n8 tiles per warp
  static constexpr int ROWS = BM + BN;               // A rows, then B^T rows
  static_assert(SK_BK == 64 && SK_THREADS == 256, "a stage row is 4 copies, 64 rows a pass");
  static_assert(NT % 2 == 0, "B fragments load two n8 tiles at a time");
};

// This thread's share of a stage: rows tid / 4 + 64 t (t < ROW_PASSES) of
// every used slice's A and B^T tiles, 16 bytes at column (tid % 4) * 16.
// The row offsets are fixed for the whole K loop, so they are computed once.
template <int BM, int BN>
struct LoadPlan {
  static constexpr int ROWS = BM + BN, ROW_PASSES = (ROWS + 63) / 64;
  int64_t off[ROW_PASSES];  // row offset in the slice, in bytes
  bool live[ROW_PASSES];    // the row lies inside M (A) or N (B)

  __device__ __forceinline__ LoadPlan(const SliceGemm& g, int m0, int n0) {
#pragma unroll
    for (int t = 0; t < ROW_PASSES; ++t) {
      const int row = threadIdx.x / 4 + 64 * t;
      const bool is_a = row < BM;
      const int grow = is_a ? m0 + row : n0 + row - BM;
      live[t] = row < ROWS && grow < (is_a ? g.M : g.N);
      off[t] = live[t] ? static_cast<int64_t>(grow) * (is_a ? g.lda : g.ldb) : 0;
    }
  }
};

// One K step (k0) of every used slice's A and B^T tiles into stage buffer
// ``st``; zeros past the M, N and K edges.
template <int MAXD, int BM, int BN>
__device__ __forceinline__ void sk_load(signed char* st, const SliceGemm& g,
                                        const LoadPlan<BM, BN>& plan, int k0) {
  using P = LoadPlan<BM, BN>;
  const int col = (threadIdx.x % 4) * 16, gk = k0 + col;
  const int tail = min(16, g.K - gk);  // <= 0 past the K edge
#pragma unroll
  for (int s = 0; s < MAXD; ++s) {
    if (s >= g.n_used) break;
#pragma unroll
    for (int t = 0; t < P::ROW_PASSES; ++t) {
      const int row = threadIdx.x / 4 + 64 * t;
      if (row >= P::ROWS) continue;
      const signed char* src = (row < BM ? g.a[s] : g.b[s]) + plan.off[t] + gk;
      signed char* dst = st + (s * P::ROWS + row) * SK_PITCH + col;
      const int bytes = plan.live[t] && tail > 0 ? tail : 0;
      if (g.vec) {
        cp16(dst, bytes ? src : g.a[0], bytes);
      } else {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        signed char* e = reinterpret_cast<signed char*>(&v);
        for (int i = 0; i < bytes; ++i) e[i] = src[i];
        *reinterpret_cast<uint4*>(dst) = v;
      }
    }
  }
}

// Knuth TwoSum, s + err == a + b exactly, in IEEE round-to-nearest steps.
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& err) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  err = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

// 2^(-7 d) as an fp32 bit pattern (d <= 8: a normal number).
__device__ __forceinline__ float diag_weight(int d) { return __int_as_float((127 - 7 * d) << 23); }

template <int MAXD, int BM, int BN, int WARPS_M, bool FLUSH>
__global__ void __launch_bounds__(SK_THREADS) slice_gemm_kernel(const SliceGemm g) {
  using T = SliceTile<MAXD, BM, BN, WARPS_M>;
  extern __shared__ __align__(128) signed char smem[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;  // mma groupID, thread-in-group
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;

  // Grouped block order: SK_GROUP_M block rows share a wave.
  const int grid_m = (g.M + BM - 1) / BM, grid_n = (g.N + BN - 1) / BN;
  const int pid = blockIdx.x, per_group = SK_GROUP_M * grid_n;
  const int first_m = (pid / per_group) * SK_GROUP_M;
  const int group_m = min(grid_m - first_m, SK_GROUP_M);
  const int m0 = (first_m + (pid % per_group) % group_m) * BM;
  const int n0 = ((pid % per_group) / group_m) * BN;

  int acc[MAXD][T::MT][T::NT][4];
  float hi[FLUSH ? T::MT : 1][FLUSH ? T::NT : 1][4], lo[FLUSH ? T::MT : 1][FLUSH ? T::NT : 1][4];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int d = 0; d < MAXD; ++d) acc[d][mt][nt][e] = 0;
        if constexpr (FLUSH) hi[mt][nt][e] = lo[mt][nt][e] = 0.f;
      }

  const int stage_bytes = g.n_used * T::ROWS * SK_PITCH;
  const int ksteps = (g.K + SK_BK - 1) / SK_BK;
  const LoadPlan<BM, BN> plan(g, m0, n0);
#pragma unroll
  for (int s = 0; s < SK_STAGES - 1; ++s) {
    if (s < ksteps) sk_load<MAXD, BM, BN>(smem + s * stage_bytes, g, plan, s * SK_BK);
    cp_commit();
  }

  // ldmatrix row addresses of this lane: A matrices (rows 0-7 | 8-15) x
  // (k 0-15 | 16-31); B^T matrices (k 0-15 | 16-31) x (n 0-7 | 8-15).
  const int a_row = wm * T::WTM + (lane % 8) + 8 * ((lane / 8) & 1), a_col = 16 * (lane / 16);
  const int b_row = BM + wn * T::WTN + (lane % 8) + 8 * (lane / 16), b_col = 16 * ((lane / 8) & 1);

  for (int kt = 0; kt < ksteps; ++kt) {
    cp_wait<SK_STAGES - 2>();
    __syncthreads();
    {
      const int nk = kt + SK_STAGES - 1;
      if (nk < ksteps) sk_load<MAXD, BM, BN>(smem + (nk % SK_STAGES) * stage_bytes, g, plan, nk * SK_BK);
      cp_commit();
    }
    const signed char* st = smem + (kt % SK_STAGES) * stage_bytes;
#pragma unroll
    for (int kk = 0; kk < SK_BK; kk += 32) {
      uint32_t bf[MAXD][T::NT / 2][4];
#pragma unroll
      for (int j = 0; j < MAXD; ++j)
        if (j < g.n_used)
#pragma unroll
          for (int np = 0; np < T::NT / 2; ++np)
            ldsm_x4(bf[j][np], st + (j * T::ROWS + b_row + np * 16) * SK_PITCH + kk + b_col);
      // A_i's fragments are loaded while A_{i-1}'s MMAs issue.
      uint32_t af[2][T::MT][4];
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
        ldsm_x4(af[0][mt], st + (a_row + mt * 16) * SK_PITCH + kk + a_col);
#pragma unroll
      for (int i = 0; i < MAXD; ++i) {
        if (i < g.n_used) {
          if (i + 1 < MAXD && i + 1 < g.n_used) {
#pragma unroll
            for (int mt = 0; mt < T::MT; ++mt)
              ldsm_x4(af[(i + 1) & 1][mt],
                          st + ((i + 1) * T::ROWS + a_row + mt * 16) * SK_PITCH + kk + a_col);
          }
#pragma unroll
          for (int j = 0; j < MAXD - i; ++j) {
            if (j < g.n_used && i + j < g.n_diags) {
#pragma unroll
              for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
                for (int nt = 0; nt < T::NT; ++nt)
                  mma_s8(acc[i + j][mt][nt], af[i & 1][mt], bf[j][nt / 2][2 * (nt % 2)],
                         bf[j][nt / 2][2 * (nt % 2) + 1]);
            }
          }
        }
      }
    }
    if constexpr (FLUSH) {
      if ((kt + 1) % g.flush_steps == 0 || kt + 1 == ksteps) {
        // B5: flush this K block's exact diagonals into (hi, lo), d ascending.
#pragma unroll
        for (int d = 0; d < MAXD; ++d) {
          if (d < g.n_diags) {
            const float w = diag_weight(d);
#pragma unroll
            for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
              for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int p = acc[d][mt][nt][e];
                  const float p_hi = __fmul_rn(__fmul_rn(__int2float_rn(p >> 12), 4096.f), w);
                  const float p_lo = __fmul_rn(__int2float_rn(p & 4095), w);
                  float s, err;
                  two_sum(hi[mt][nt][e], p_hi, s, err);
                  hi[mt][nt][e] = s;
                  lo[mt][nt][e] = __fadd_rn(lo[mt][nt][e], err);
                  two_sum(hi[mt][nt][e], p_lo, s, err);
                  hi[mt][nt][e] = s;
                  lo[mt][nt][e] = __fadd_rn(lo[mt][nt][e], err);
                  acc[d][mt][nt][e] = 0;
                }
          }
        }
      }
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gm = m0 + wm * T::WTM + mt * 16 + gq + (e >= 2 ? 8 : 0);
        const int gn = n0 + wn * T::WTN + nt * 8 + tq * 2 + (e & 1);
        if (gm >= g.M || gn >= g.N) continue;
        const int64_t idx = static_cast<int64_t>(gm) * g.N + gn;
        if constexpr (FLUSH) {
          g.c[idx] = hi[mt][nt][e];
          g.c2[idx] = lo[mt][nt][e];
        } else {
          // B4: sum_d P_d * 2^(-7d), d ascending, then the ulps.
          float out = __int2float_rn(acc[0][mt][nt][e]);
#pragma unroll
          for (int d = 1; d < MAXD; ++d)
            if (d < g.n_diags)
              out = __fadd_rn(out, __fmul_rn(__int2float_rn(acc[d][mt][nt][e]), diag_weight(d)));
          if (g.ua) out = __fmul_rn(__fmul_rn(out, g.ua[gm]), g.ub[gn]);
          g.c[idx] = out;
        }
      }
}

template <int MAXD, int BM, int BN, int WARPS_M, bool FLUSH>
int launch_slice(const SliceGemm& g, cudaStream_t stream) {
  using T = SliceTile<MAXD, BM, BN, WARPS_M>;
  auto kernel = slice_gemm_kernel<MAXD, BM, BN, WARPS_M, FLUSH>;
  static const int attr = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SK_STAGES * MAXD * T::ROWS * SK_PITCH));
  if (attr) return attr;
  const int64_t blocks = static_cast<int64_t>((g.M + BM - 1) / BM) * ((g.N + BN - 1) / BN);
  if (blocks > INT_MAX) return kUnsupported;
  const int smem = SK_STAGES * g.n_used * T::ROWS * SK_PITCH;
  kernel<<<static_cast<unsigned>(blocks), SK_THREADS, smem, stream>>>(g);
  return last_error();
}


// ---- B5 on the Hopper tile engine ------------------------------------------
//
// The walk is diagonal-major: for each 128 x 128 output tile, each K block
// of block_k (the flush period) and each diagonal d ascending, P_d is one
// wgmma chain over the concatenated (pair (i, d - i), 128-deep K slab)
// sequence into one int32 accumulator; the chain drains (wait_group 0),
// P_d is split and TwoSum-flushed into (hi, lo), and the next diagonal's
// chain starts.  That is the plain version's and the TPU kernel's flush
// order, and only three tiles stay live: the accumulator, hi and lo, 64
// values each a thread at m64n128 (at m64n256, 384 would not fit).  The
// block is the engine's: consumer warpgroups 1 and 2 (setmaxnreg 232, room
// for the 192 live values) own 64 rows each of the tile, one thread of
// warpgroup 0 (setmaxnreg 40) keeps a 6-stage TMA ring full.  A stage
// is one slice pair's slab: A_i's 128 rows and B_j^T's 128 rows of 128
// bytes of K (16 KB each, K-major, 128-byte swizzled), four k32 wgmma a
// consumer warpgroup.  The 2 x 9 tensor maps (A_i (M, K) and B_j^T
// (N, K)) travel as launch parameters (2.3 KB of the 4 KB), so no device
// buffer, upload copy or tensormap fence is needed.  block_k must be a
// multiple of the 128-deep slab, so that no slab straddles a flush; the
// wrapper sends other block_k, and rows whose pitch or base TMA cannot
// describe, to slice_gemm_kernel.
//
// A slab is reloaded for every pair it sits in, so past the L2 (8192^3:
// 302 GB of slab traffic) the L2 sets the pace.  Two cures measured slower
// on an H100 and were dropped: clusters of 2 or 2 x 2 blocks loading half
// of each shared slab by multicast TMA (2-3x slower: every stage's release
// must reach the partners before either reloads, a round trip the 6-stage
// ring does not cover), and reversing the pair order of odd diagonals so a
// diagonal starts on the operand its predecessor ended on (no change).

constexpr int kOzBM = 128, kOzBN = 128, kOzBK = kWgRowBytes, kOzStages = 6;
constexpr int kOzTile = 128 * kWgRowBytes;  // 128 rows of one 128-byte K slab
constexpr int kOzStage = 2 * kOzTile;
struct OzBars {
  uint64_t full[kOzStages], empty[kOzStages];
};
constexpr int kOzSmem = 1024 + kOzStages * kOzStage + static_cast<int>(sizeof(OzBars));

struct OzArgs {
  CUtensorMap a[kSliceMaxDiags];  // A_i: (M, K), boxes of 128 K by 128 rows
  CUtensorMap b[kSliceMaxDiags];  // B_j^T: (N, K)
  float* hi;
  float* lo;
  int M, N, K, n_used, n_diags, block_k;
  long long spin;
};

// The slice pairs (i, d - i) of diagonal d: i in [first, last].
__device__ __forceinline__ void oz_pairs(const OzArgs& g, int d, int& first, int& last) {
  first = max(0, d - g.n_used + 1);
  last = min(d, g.n_used - 1);
}
__device__ __forceinline__ int oz_slabs(const OzArgs& g, int64_t k0) {
  const int64_t len = g.K - k0 < g.block_k ? g.K - k0 : g.block_k;
  return static_cast<int>((len + kOzBK - 1) / kOzBK);
}

// The producer (one thread): the consumers' walk, stage by stage.
__device__ void oz_produce(const OzArgs& g, unsigned char* smem, OzBars* bars) {
  const int tiles_m = (g.M + kOzBM - 1) / kOzBM, tiles_n = (g.N + kOzBN - 1) / kOzBN;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles_m * tiles_n; t += gridDim.x) {
    int m0, n0;
    tile_origin(t, tiles_m, tiles_n, kOzBM, kOzBN, m0, n0);
    for (int64_t k0 = 0; k0 < g.K; k0 += g.block_k) {
      const int slabs = oz_slabs(g, k0);
      for (int d = 0; d < g.n_diags; ++d) {
        int first, last;
        oz_pairs(g, d, first, last);
        for (int i = first; i <= last; ++i)
          for (int s = 0; s < slabs; ++s) {
            const int k = static_cast<int>(k0) + s * kOzBK;
            mbar_wait(&bars->empty[stage], phase ^ 1, g.spin);
            unsigned char* st = smem + stage * kOzStage;
            mbar_expect_tx(&bars->full[stage], kOzStage);
            tma_load_2d(st, &g.a[i], k, m0, &bars->full[stage]);
            tma_load_2d(st + kOzTile, &g.b[d - i], k, n0, &bars->full[stage]);
            if (++stage == kOzStages) {
              stage = 0;
              phase ^= 1;
            }
          }
      }
    }
  }
}

// A consumer warpgroup: 64 rows of each tile.
__device__ void oz_consume(const OzArgs& g, unsigned char* smem, OzBars* bars) {
  const int wg = threadIdx.x / 128 - 1, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int tiles_m = (g.M + kOzBM - 1) / kOzBM, tiles_n = (g.N + kOzBN - 1) / kOzBN;
  const uint32_t base = smem_u32(smem);
  int acc[64];
  float hi[64], lo[64];
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles_m * tiles_n; t += gridDim.x) {
    int m0, n0;
    tile_origin(t, tiles_m, tiles_n, kOzBM, kOzBN, m0, n0);
#pragma unroll
    for (int e = 0; e < 64; ++e) hi[e] = lo[e] = 0.f;
    for (int64_t k0 = 0; k0 < g.K; k0 += g.block_k) {
      const int slabs = oz_slabs(g, k0);
      for (int d = 0; d < g.n_diags; ++d) {
        int first, last;
        oz_pairs(g, d, first, last);
        if (first > last) continue;  // no pair lies on d: nothing to flush
        const int chain = (last - first + 1) * slabs;
        wg_pin(acc);
        for (int q = 0; q < chain; ++q) {
          mbar_wait(&bars->full[stage], phase, g.spin);
          const uint32_t st = base + stage * kOzStage;
          const uint64_t da = wg_desc(st + wg * 64 * kWgRowBytes), db = wg_desc(st + kOzTile);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma_s8_n128(acc, da + 2 * kk, db + 2 * kk, q > 0 || kk > 0);
          wg_commit();
          if (q > 0) {
            wg_wait<1>();  // the group that read stage prev has retired
            mbar_arrive(&bars->empty[prev]);
          }
          prev = stage;
          if (++stage == kOzStages) {
            stage = 0;
            phase ^= 1;
          }
        }
        wg_wait<0>();
        mbar_arrive(&bars->empty[prev]);
        wg_pin(acc);
        // P_d is exact: split it and flush it, as slice_gemm_kernel does.
        const float w = diag_weight(d);
#pragma unroll
        for (int e = 0; e < 64; ++e) {
          const int p = acc[e];
          const float p_hi = __fmul_rn(__fmul_rn(__int2float_rn(p >> 12), 4096.f), w);
          const float p_lo = __fmul_rn(__int2float_rn(p & 4095), w);
          float s, err;
          two_sum(hi[e], p_hi, s, err);
          hi[e] = s;
          lo[e] = __fadd_rn(lo[e], err);
          two_sum(hi[e], p_lo, s, err);
          hi[e] = s;
          lo[e] = __fadd_rn(lo[e], err);
        }
      }
    }
    // Value 4 j + 2 h + q of the m64n128 fragment: row r0 + 8 h, column
    // c0 + 8 j + q.
    const int r0 = m0 + 64 * wg + 16 * warp + lane / 4, c0 = n0 + 2 * (lane % 4);
    const bool pairs = g.N % 2 == 0;
#pragma unroll
    for (int e = 0; e < 64; e += 2) {
      const int r = r0 + 8 * ((e % 4) / 2), c = c0 + 8 * (e / 4);
      if (r >= g.M || c >= g.N) continue;
      const int64_t idx = static_cast<int64_t>(r) * g.N + c;
      if (pairs) {
        *reinterpret_cast<float2*>(g.hi + idx) = make_float2(hi[e], hi[e + 1]);
        *reinterpret_cast<float2*>(g.lo + idx) = make_float2(lo[e], lo[e + 1]);
      } else {
        g.hi[idx] = hi[e];
        g.lo[idx] = lo[e];
        if (c + 1 < g.N) {
          g.hi[idx + 1] = hi[e + 1];
          g.lo[idx + 1] = lo[e + 1];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kWgThreads, 1) ozaki_wg_kernel(const __grid_constant__ OzArgs g) {
  extern __shared__ unsigned char dyn_smem[];
  unsigned char* smem = wg_align(dyn_smem);
  OzBars* bars = reinterpret_cast<OzBars*>(smem + kOzStages * kOzStage);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kOzStages; ++i) {
      mbar_init(&bars->full[i], 1);
      mbar_init(&bars->empty[i], 256);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    reg_dealloc<40>();
    if (threadIdx.x == 0) oz_produce(g, smem, bars);
  } else {
    reg_alloc<232>();
    oz_consume(g, smem, bars);
  }
}

// B5 on the engine: one persistent block a SM, at most one a tile.
inline int launch_ozaki_wg(const SliceGemm& sg, int block_k, cudaStream_t st) {
  if (block_k % kOzBK) return kUnsupported;
  OzArgs g{};
  for (int i = 0; i < sg.n_used; ++i)
    if (!encode_kmajor(&g.a[i], sg.a[i], sg.M, sg.K, 1, kOzBM, sg.lda) ||
        !encode_kmajor(&g.b[i], sg.b[i], sg.N, sg.K, 1, kOzBN, sg.ldb))
      return kTmaEncodeFailed;
  g.hi = sg.c;
  g.lo = sg.c2;
  g.M = sg.M;
  g.N = sg.N;
  g.K = sg.K;
  g.n_used = sg.n_used;
  g.n_diags = sg.n_diags;
  g.block_k = block_k;
  g.spin = spin_cycles(10000);  // a stage wait is microseconds; 10 s means a lost load
  static const int attr = static_cast<int>(cudaFuncSetAttribute(
      ozaki_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kOzSmem));
  if (attr) return attr;
  int dev = 0, sms = 0;
  int err = cudaGetDevice(&dev);
  if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return err;
  const int64_t tiles = static_cast<int64_t>((sg.M + kOzBM - 1) / kOzBM) * ((sg.N + kOzBN - 1) / kOzBN);
  if (tiles > INT_MAX) return kUnsupported;
  ozaki_wg_kernel<<<static_cast<unsigned>(tiles < sms ? tiles : sms), kWgThreads, kOzSmem, st>>>(g);
  return last_error();
}

}  // namespace gemm_hls

using namespace gemm_hls;

// a: ``n_used`` A slice pointers ((M, K), row pitch lda); b: ``n_used`` B
// slice pointers as B_j^T ((N, K), row pitch ldb); c (and c2): (M, N) fp32,
// row-major.  flush_steps = 0 runs B4 into c, scaled by ua (M,) and ub (N,)
// when both are given; flush_steps > 0 runs B5, flushing every flush_steps
// 64-deep K steps, into c = hi and c2 = lo.  vec: every row start is
// 16-byte aligned.  Returns 0, a CUDA error code from the launch, or -1 for
// a diagonal count or grid no kernel is built for.  engine: B5 on the tile
// engine (ozaki_wg_kernel; rows and bases 16-byte aligned, flush_steps
// even), else on slice_gemm_kernel; -2 for a tensor map
// cuTensorMapEncodeTiled refused.
extern "C" int slice_gemm(const void* const* a, const void* const* b, int n_used, void* c, void* c2,
                          const void* ua, const void* ub, int M, int N, int K, int64_t lda,
                          int64_t ldb, int n_diags, int flush_steps, int vec, int engine,
                          void* stream) {
  if (n_diags < 1 || n_diags > kSliceMaxDiags || n_used < 1 || n_used > n_diags) return kUnsupported;
  SliceGemm g{};
  for (int i = 0; i < n_used; ++i) {
    g.a[i] = static_cast<const signed char*>(a[i]);
    g.b[i] = static_cast<const signed char*>(b[i]);
  }
  g.c = static_cast<float*>(c);
  g.c2 = static_cast<float*>(c2);
  g.ua = static_cast<const float*>(ua);
  g.ub = static_cast<const float*>(ub);
  g.M = M;
  g.N = N;
  g.K = K;
  g.lda = lda;
  g.ldb = ldb;
  g.n_used = n_used;
  g.n_diags = n_diags;
  g.flush_steps = flush_steps;
  g.vec = vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (flush_steps > 0)
    return engine ? launch_ozaki_wg(g, flush_steps * SK_BK, s) : launch_slice<9, 64, 32, 4, true>(g, s);
  if (engine) return kUnsupported;
  switch (n_diags) {
    case 1:
    case 2: return launch_slice<2, 128, 64, 4, false>(g, s);
    case 3: return launch_slice<3, 128, 64, 4, false>(g, s);
    case 4: return launch_slice<4, 128, 64, 4, false>(g, s);
    default: return launch_slice<9, 64, 32, 4, false>(g, s);
  }
}
