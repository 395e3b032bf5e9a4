// Kernel w8a8_wg_kernel: the W8A8 GEMM of B14 and B15 on the Hopper tile
// engine, out (M, N) = xq (M, K) int8 . wq (K, N) int8 with the scales of
// the three modes of csrc/w8a8.cuh (ops/dequant.py::w8a8_route; the rest
// stays on csrc/w8a8_gemm.cu's mma.sync tile, which also holds the quantize
// pass both routes run first).
//
// Replaces two TPU kernels of gemm_hls_tpu/ops/pallas_dequant.py:
//   * _w8a8_fused_kernel (B14, mode kFused): x quantized per (row, K-block);
//   * _w8a8_kernel (B15, modes kIntAcc and kPerBlock): x quantized per row.
// Each K-block product P_b is exact in int32, and its fp32 fold is
// csrc/w8a8.cuh's, block by block in K order: the same bits as the mma.sync
// tile and as the plain version's arithmetic.
//
// What bounds it on an H100: at the prefill's q / o projection ((4096, 2048)
// x (2048, 2048)) 34.4 GOP at 1979 TOP/s of int8, 17.4 us; its bytes (x, the
// weights, y: 16 + 4 + 16 MB) take 11 us at 3.35 TB/s.  So the design is
// about keeping the int8 tensor cores fed, and the cost is in the weights:
// wgmma takes 8-bit operands K-major only (the transpose bits exist for
// 16-bit types), and w_q is (K, N) row-major, so every weight byte a block
// multiplies is first turned K-major in shared memory by its threads.
//   * A block of 544 threads, one a SM, owns a 256-row, BN-column tile of y
//     (BN 128, or 64) and walks all of K in 128-deep steps.  A tall,
//     narrow tile puts few weight bytes on each product: a step moves 32 KB
//     of x and 16 KB of weights for 8.4 MOP.  (A 128 x 256 tile whose 32 KB
//     of weights a step three warps of their own turned took 0.069 ms at the
//     q / o projection on an H100, against this tile's 0.047-0.052: PERF.md,
//     section 6.)
//   * One thread of the last warp keeps two rings full by TMA: a 4-deep one
//     of x slabs (256 rows x 128 bytes of K, 128-byte swizzled: wgmma's A,
//     K-major as the quantize pass wrote it) and a 3-deep one of the
//     weights' (128 K rows, BN columns) boxes, raw.
//   * Warpgroups 0-3 own 64 rows each (m64nBNk32 s8 x s8 -> s32, four a
//     step).  At step t each of their threads turns one unit of the raw
//     box, 4 K rows x 8 columns: four 8-byte loads, two 4 x 4 byte
//     transposes of six byte permutes, eight 4-byte stores into one of two
//     BN-row, 128-byte-swizzled B tiles; then fence.proxy.async.shared::cta
//     and a barrier over the consumers, and step t's products issue while
//     step t + 1 is turned (one wgmma group in flight).  Bank conflicts:
//     lane l owns K rows 4l .. 4l + 3, so after the swizzle each store's
//     bank is l; a half warp's loads read 16 different 8-byte columns of
//     their rows at BN 128 (two lanes share one at BN 64).
//   * The first wgmma of a tile or of a scale block issues with scale-d 0
//     (the accumulator is never zeroed by other code: ptxas would
//     serialise the wgmma), and the producer warp returns before the
//     products, which must not sit on a divergent path (C7518).
// 544 threads hold 120 registers each: an int32 sum over all of K (kIntAcc,
// and kFused with one scale block: the prefill's case) keeps 64 a thread
// at BN 128; a scale block that ends inside K (kPerBlock, group-wise or
// several K-blocks of kFused) keeps its int32 partial and an fp32 sum, 32 +
// 32 at BN 64, and folds at each block's end.  The N tile comes from the
// shape (ops/dequant.py::w8a8_engine_plan): 128 where the 256 x 128 tiles
// fill a wave of SMs (q / o: 256 tiles), else 64 (k / v, N 512: 128 tiles).
// Rows past M, columns past N and K past its end are zero-filled by TMA;
// the tile goes out through the x ring, which it no longer needs, by TMA
// stores clipped to M x N (6-7% faster at the prefill's projections on an
// H100 than each thread storing its 4-byte pairs).
#include "w8a8.cuh"
#include "wgmma_tile.cuh"

namespace gemm_hls {

constexpr int kW8BM = 256;    // rows of a tile: four consumer warpgroups of 64
constexpr int kW8Step = 128;  // K bytes a step: one swizzled slab row
constexpr int kW8AStages = 4, kW8WStages = 3;
constexpr int kW8Consumers = 512, kW8Threads = kW8Consumers + 32;
constexpr int kW8A = kW8BM * kW8Step;  // an x slab: 32 KB

struct W8Bars {
  uint64_t a_full[kW8AStages], a_empty[kW8AStages];  // x slabs
  uint64_t w_full[kW8WStages], w_empty[kW8WStages];  // raw weight boxes
};

// Shared memory of a BN tile: the x ring, the raw ring, two B tiles, the
// barriers (offsets from the 1024-byte aligned base).
template <int BN> struct W8Tile {
  static constexpr int kRaw = kW8Step * BN;    // a raw box: 128 K rows x BN bytes
  static constexpr int kBTile = BN * kW8Step;  // a B tile: BN rows x 128 K bytes
  static constexpr int kW = kW8AStages * kW8A;
  static constexpr int kB = kW + kW8WStages * kRaw;
  static constexpr int kBars = kB + 2 * kBTile;
  static constexpr int kSmem = 1024 + kBars + static_cast<int>(sizeof(W8Bars));
  static constexpr int kUnits = 32 * (BN / 8);  // units of 4 K rows x 8 columns a step
};
static_assert(W8Tile<128>::kSmem <= 232448, "a block's shared memory");
static_assert(W8Tile<128>::kUnits == kW8Consumers, "one unit a consumer thread");
static_assert(kW8AStages * kW8A >= kW8BM * 128 * 4, "the x ring stages an fp32 tile");

struct W8Args {
  CUtensorMap x;    // xq (M, K): boxes of 128 K bytes by 256 rows, 128-byte swizzled
  CUtensorMap w;    // wq (K, N) as bytes: boxes of BN by 128 K rows, unswizzled
  CUtensorMap o;    // out (M, N): boxes of 128 bytes of columns by 256 rows, 128-byte swizzled
  const float* sw;  // (n_groups, N)
  const float* sx;  // kFused: (K / bk, M); otherwise (M,)
  int M, N, K, bk, n_groups, mode, out_code, steps;
  long long spin;
};

template <int BN> struct W8Mma;
template <> struct W8Mma<128> {
  static __device__ __forceinline__ void run(int (&d)[64], uint64_t da, uint64_t db, int sd) {
    wgmma_s8_n128(d, da, db, sd);
  }
};
template <> struct W8Mma<64> {
  static __device__ __forceinline__ void run(int (&d)[32], uint64_t da, uint64_t db, int sd) {
    wgmma_s8_n64(d, da, db, sd);
  }
};

// ---- the producer: one thread of the last warp ---------------------------------

// Step t's raw weight box, then its x slab (each ring runs ahead as far as
// its stages are free: the weights' once step t - 3 is turned, x's once
// the products of step t - 4 have retired).
template <int BN>
__device__ void w8_produce(const W8Args& g, unsigned char* smem, W8Bars* bars, int m0, int n0) {
  using L = W8Tile<BN>;
  for (int t = 0; t < g.steps; ++t) {
    const int a = t % kW8AStages, w = t % kW8WStages;
    mbar_wait(&bars->w_empty[w], ((t / kW8WStages) & 1) ^ 1, g.spin);
    mbar_expect_tx(&bars->w_full[w], L::kRaw);
    tma_load_2d(smem + L::kW + w * L::kRaw, &g.w, n0, t * kW8Step, &bars->w_full[w]);
    mbar_wait(&bars->a_empty[a], ((t / kW8AStages) & 1) ^ 1, g.spin);
    mbar_expect_tx(&bars->a_full[a], kW8A);
    tma_load_2d(smem + a * kW8A, &g.x, t * kW8Step, m0, &bars->a_full[a]);
  }
}

// ---- the turn: a raw box into a K-major B tile ---------------------------------

// A consumer thread's unit of every step: lane l of warp w takes K rows
// 4l .. 4l + 3 and columns 8 c .. 8 c + 7, c = (l + w) % (BN / 8); its
// words land in B tile rows 8 c .. 8 c + 7 (row n: 128 bytes of K, 16-byte
// chunk q at q ^ (n % 8), the layout TMA's 128-byte swizzle writes).  The
// offsets are the same every step.
struct W8Unit {
  int rd;     // byte offset of its first 8 bytes in the raw box
  int wr;     // byte offset of its first word in the B tile
  bool live;  // BN 64 has units for warps 0-7 only
};

template <int BN>
__device__ __forceinline__ W8Unit w8_unit(int tid) {
  const int warp = tid / 32, lane = tid % 32, c = (lane + warp) % (BN / 8);
  return {4 * lane * BN + 8 * c, 8 * c * kW8Step + 4 * (lane & 3), tid < W8Tile<BN>::kUnits};
}

template <int BN>
__device__ __forceinline__ void w8_turn(const W8Unit& u, const unsigned char* raw, unsigned char* bt,
                                        int lane) {
  if (!u.live) return;
  uint2 v[4];  // K row 4l + r, its 8 columns as two words
#pragma unroll
  for (int r = 0; r < 4; ++r) v[r] = *reinterpret_cast<const uint2*>(raw + u.rd + r * BN);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t w0 = h ? v[0].y : v[0].x, w1 = h ? v[1].y : v[1].x;
    const uint32_t w2 = h ? v[2].y : v[2].x, w3 = h ? v[3].y : v[3].x;
    const uint32_t t0 = __byte_perm(w0, w1, 0x5140), t1 = __byte_perm(w2, w3, 0x5140);
    const uint32_t t2 = __byte_perm(w0, w1, 0x7362), t3 = __byte_perm(w2, w3, 0x7362);
    const uint32_t o[4] = {__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                           __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 4 * h + e;  // B tile row 8 c + n, and n % 8 of it
      *reinterpret_cast<uint32_t*>(bt + u.wr + n * kW8Step + (((lane >> 2) ^ n) << 4)) = o[e];
    }
  }
}

// ---- the consumers' fold and store ---------------------------------------------

// Value e = 4 j + 2 h + q of the m64nBN fragment of a thread whose first row
// is r0 and first column c0: row r0 + 8 h, column c0 + 8 j + q.

// K-block kb has ended: acc += (f32(P) rs) cs.
template <int BN>
__device__ __forceinline__ void w8_fold(const W8Args& g, const int (&part)[BN / 2],
                                        float (&acc)[BN / 2], int kb, int r0, int c0) {
  const float rs[2] = {w8_fold_rs(g, kb, r0), w8_fold_rs(g, kb, r0 + 8)};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float cs[2] = {w8_fold_cs(g, kb, c0 + 8 * j), w8_fold_cs(g, kb, c0 + 8 * j + 1)};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      acc[4 * j + q] = __fadd_rn(acc[4 * j + q], w8_part(part[4 * j + q], rs[q >> 1], cs[q & 1]));
  }
}

// The store, staged: the int32 sum (kIntAcc; kFused's one block folded
// first) or the fp32 sum of the blocks, times the store's scales, as Out
// into ``stage`` -- boxes of 128 bytes of columns by the tile's 256 rows,
// 128-byte swizzled (16-byte chunk q of row r at q ^ (r % 8), the output
// map's layout; conflict-free for 16-bit outputs) -- for TMA stores, which
// clip the tile to M x N.  A warpgroup writes only its own 64 rows of each
// box: shared memory its own products have finished reading.
template <typename Out, int BN, bool kBlocks>
__device__ __forceinline__ void w8_stage(const W8Args& g, const int (&part)[BN / 2],
                                         const float (&acc)[kBlocks ? BN / 2 : 1], int r0, int c0,
                                         int m0, int n0, unsigned char* stage) {
  using Pair = PairOf<Out>;
  constexpr int kE = static_cast<int>(sizeof(Out)), kBoxCols = kW8Step / kE;
  const float frs[2] = {w8_fold_rs(g, 0, r0), w8_fold_rs(g, 0, r0 + 8)};
  const float srs[2] = {w8_store_rs(g, r0), w8_store_rs(g, r0 + 8)};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = c0 + 8 * j, col = c - n0, byte = col % kBoxCols * kE;
    const float fcs[2] = {w8_fold_cs(g, 0, c), w8_fold_cs(g, 0, c + 1)};
    const float scs[2] = {w8_store_cs(g, c), w8_store_cs(g, c + 1)};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h - m0;
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
      unsigned char* at = stage + col / kBoxCols * (kW8BM * kW8Step) + row * kW8Step +
                          ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15);
      *reinterpret_cast<typename Pair::P*>(at) = Pair::make(cast_out<Out>(v[0]), cast_out<Out>(v[1]));
    }
  }
}

template <typename Out, int BN, bool kBlocks>
__device__ __forceinline__ void w8_store(const W8Args& g, const int (&part)[BN / 2],
                                         const float (&acc)[kBlocks ? BN / 2 : 1], int r0, int c0,
                                         int m0, int n0, unsigned char* stage) {
  constexpr int kBoxCols = kW8Step / static_cast<int>(sizeof(Out));
  w8_stage<Out, BN, kBlocks>(g, part, acc, r0, c0, m0, n0, stage);
  fence_proxy_async_shared();  // the staged tile, written through the generic proxy, for TMA
  named_sync(1, kW8Consumers);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int b = 0; b < BN / kBoxCols; ++b)
      if (n0 + b * kBoxCols < g.N)
        tma_store_2d(&g.o, stage + b * (kW8BM * kW8Step), n0 + b * kBoxCols, m0);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    bulk_wait_all();  // the stores are done before the block exits
  }
}

// ---- the kernel ----------------------------------------------------------------

template <int BN, bool kBlocks>
__global__ void __launch_bounds__(kW8Threads, 1) w8a8_wg_kernel(const __grid_constant__ W8Args g) {
  using L = W8Tile<BN>;
  constexpr int kE = BN / 2;
  extern __shared__ unsigned char dyn_smem[];
  unsigned char* smem = wg_align(dyn_smem);
  W8Bars* bars = reinterpret_cast<W8Bars*>(smem + L::kBars);
  const int m0 = blockIdx.y * kW8BM, n0 = blockIdx.x * BN, tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < kW8AStages; ++i) {
      mbar_init(&bars->a_full[i], 1);
      mbar_init(&bars->a_empty[i], 1);
    }
    for (int i = 0; i < kW8WStages; ++i) {
      mbar_init(&bars->w_full[i], 1);
      mbar_init(&bars->w_empty[i], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();
  // No block-wide barrier after the role split: the producer returns, and
  // the consumers meet on named barriers 1 and 2 (512 threads).
  if (tid >= kW8Consumers) {
    if (tid == kW8Consumers) w8_produce<BN>(g, smem, bars, m0, n0);
    return;
  }
  const int wg = tid / 128, warp = tid % 128 / 32, lane = tid % 32;
  const W8Unit unit = w8_unit<BN>(tid);
  const uint32_t sa = smem_u32(smem) + wg * 64 * kW8Step;
  const int r0 = m0 + 64 * wg + 16 * warp + lane / 4, c0 = n0 + 2 * (lane % 4);
  const int per = kBlocks ? g.bk / kW8Step : g.steps;  // steps a scale block
  int part[kE];
  float acc[kBlocks ? kE : 1];
#pragma unroll
  for (int e = 0; e < (kBlocks ? kE : 1); ++e) acc[e] = 0.f;
  wg_pin(part);
  for (int t = 0; t < g.steps; ++t) {
    const int a = t % kW8AStages, w = t % kW8WStages;
    unsigned char* bt = smem + L::kB + (t & 1) * L::kBTile;
    // B tile t % 2 was last read by step t - 2's products, which every
    // warpgroup saw retire before the barrier that ended step t - 1.
    mbar_wait(&bars->w_full[w], (t / kW8WStages) & 1, g.spin);
    w8_turn<BN>(unit, smem + L::kW + w * L::kRaw, bt, lane);
    fence_proxy_async_shared();  // the tile, written through the generic proxy, for wgmma
    named_sync(1, kW8Consumers);
    if (tid == 0) mbar_arrive(&bars->w_empty[w]);
    mbar_wait(&bars->a_full[a], (t / kW8AStages) & 1, g.spin);
    const uint64_t da = wg_desc(sa + a * kW8A), db = wg_desc(smem_u32(bt));
    const bool opens = t % per == 0;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) W8Mma<BN>::run(part, da + 2 * kk, db + 2 * kk, !opens || kk > 0);
    wg_commit();
    if (kBlocks && ((t + 1) % per == 0 || t + 1 == g.steps)) {
      wg_wait<0>();
      wg_pin(part);
      if constexpr (kBlocks) w8_fold<BN>(g, part, acc, t / per, r0, c0);
    } else if (t > 0) {
      wg_wait<1>();  // step t - 1's products have retired
    }
    if (t > 0) {
      named_sync(2, kW8Consumers);  // on every warpgroup: its B tile and x slab are free
      if (tid == 0) mbar_arrive(&bars->a_empty[(t - 1) % kW8AStages]);
    }
  }
  wg_wait<0>();
  wg_pin(part);
  // The x ring (128 KB) stages the tile: no load lands there any more.
  switch (g.out_code) {
    case kF32: w8_store<float, BN, kBlocks>(g, part, acc, r0, c0, m0, n0, smem); break;
    case kBF16: w8_store<__nv_bfloat16, BN, kBlocks>(g, part, acc, r0, c0, m0, n0, smem); break;
    case kF16: w8_store<__half, BN, kBlocks>(g, part, acc, r0, c0, m0, n0, smem); break;
  }
}

template <int BN, bool kBlocks>
int w8_launch(const W8Args& g, cudaStream_t st) {
  auto kern = w8a8_wg_kernel<BN, kBlocks>;
  constexpr int smem = W8Tile<BN>::kSmem;
  static const int attr = static_cast<int>(
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (attr) return attr;
  kern<<<dim3(static_cast<unsigned>((g.N + BN - 1) / BN),
              static_cast<unsigned>((g.M + kW8BM - 1) / kW8BM)),
         kW8Threads, smem, st>>>(g);
  return last_error();
}

}  // namespace gemm_hls

using namespace gemm_hls;

// xq (M, K) and wq (K, N) int8, 16-byte bases, K and N multiples of 16; sw
// (n_groups, N) and sx (kFused: (K / bk, M), else (M,)) fp32; out (M, N)
// fp32 / bf16 / fp16 (out_code).  mode: csrc/w8a8.cuh's.  A mode with scale
// blocks inside K (kPerBlock, or kFused with bk < K) needs bk a multiple of
// 128 that divides K, and bn 64; the others an int32 sum (n_groups 1) and
// bn 128 or 64.  Returns 0, a CUDA error code, -1 for arguments no kernel
// is built for, or -2 for a tensor map cuTensorMapEncodeTiled refused.
extern "C" int w8a8_wgmma(const void* xq, const void* wq, const void* sw, const void* sx, void* out,
                          int M, int N, int K, int bk, int n_groups, int mode, int out_code, int bn,
                          void* stream) {
  const bool blocks = mode == kPerBlock || (mode == kFused && bk < K);
  if (mode < kFused || mode > kPerBlock || M < 1 || K < 16 || K % 16 || N < 16 || N % 16 ||
      bk < 1 || (out_code != kF32 && out_code != kBF16 && out_code != kF16) ||
      (M + kW8BM - 1) / kW8BM > 65535)
    return kUnsupported;
  if (blocks ? (bk % kW8Step || K % bk || bn != 64 || (n_groups != K / bk && n_groups != 1))
             : (n_groups != 1 || (bn != 128 && bn != 64)))
    return kUnsupported;
  W8Args g{};
  const int out_size = out_code == kF32 ? 4 : 2;
  if (!encode_kmajor(&g.x, xq, M, K, 1, kW8BM) || !encode_rows(&g.w, wq, K, N, false, bn, kW8Step) ||
      !encode_2d(&g.o, out, N, M, N, out_size, out_code == kF16, kW8Step / out_size, kW8BM))
    return kTmaEncodeFailed;
  g.sw = static_cast<const float*>(sw);
  g.sx = static_cast<const float*>(sx);
  g.M = M;
  g.N = N;
  g.K = K;
  g.bk = bk;
  g.n_groups = n_groups;
  g.mode = mode;
  g.out_code = out_code;
  g.steps = (K + kW8Step - 1) / kW8Step;
  g.spin = spin_cycles(10000);  // a stage wait is microseconds; 10 s means a lost load
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (blocks) return w8_launch<64, true>(g, st);
  return bn == 128 ? w8_launch<128, false>(g, st) : w8_launch<64, false>(g, st);
}
