// Kernel B2, row-softmax variant, on Hopper's tile engine: P[z] =
// softmax_rows(op(A[z]) . op(B[z])) for bf16 / fp16 inputs, the scores and
// the softmax in fp32, P stored in bf16, fp16 or fp32.
//
// Replaces, as csrc/row_softmax.cu does, the epilogue path of
// gemm_hls_tpu/ops/pallas_mxu.py::_batched_kernel (pallas_mxu.py:176-188,
// launched at :328) with gemm_hls_tpu/ops/attention.py::_softmax_rows as
// its epilogue: the fused attention scores.  The shapes this route does not
// take stay on row_softmax.cu (ops/mxu.py::row_softmax_route): fp32 inputs,
// operands whose bases, row pitches or batch strides are not whole 16-byte
// units, K past kRsMaxK, and rows of P that are not whole 16-byte units
// (N times the output's bytes: what P's TMA map describes).
//
// What bounds it on an H100: the bytes.  At attention's shape, 32 x 1024^2
// x 128 bf16, P is 67 MB (20 us at 3.35 TB/s) beside 17 MB of q and k,
// against 8.6 GFLOP of one pass of products (9 us at 989 TFLOP/s) and 33.5
// M exponentials a pass (~8 us on the MUFU units).  row_softmax.cu reached
// 4.8% of that bound: a 16-row strip of fp32 scores in shared memory, the
// operands re-staged by threads for every 128 columns, WMMA.
//
// The design keeps no strip: a 64-row strip of fp32 scores at N = 1024 is
// 256 KB, past a block's shared memory.  The scores are computed twice, as
// the flash kernels compute them (csrc/flash_wgmma.cu for the statistics,
// csrc/flash_bwd_wgmma.cu for the recomputed probabilities):
//   * one persistent block a SM of 384 threads walks (example, 128-row
//     tile) items.  Warpgroup 0's first thread, the producer (setmaxnreg
//     40), TMA-loads an item's A tile once into a slot of its own (two
//     slots where K <= 128, so the next item's A arrives under this one's
//     work), then B in 128-column by 64-deep chunks into a ring of
//     kRsStages stages, every N tile twice (K is read from the L2 the second
//     time: 8 MB for all 32 heads at attention's shape);
//   * warpgroups 1 and 2, the consumers (setmaxnreg 232), own 64 rows each
//     and take turns at the tensor cores.  Pass 1: S = A B^T by wgmma
//     m64n128k16 with both operands in shared memory (an MN-major one
//     through the transpose bit), a 128-column tile at a time; each row's
//     running max m and rescaled sum l of exp2((s - m) log2 e) stay in
//     registers.  The columns past N of the last tile (B's rows there are
//     zero-filled by TMA and would score 0, not -inf) are set to -inf, on
//     that tile only (per-element selects in every tile cost 1.4-2.5x in
//     the flash kernels).  Pass 2: the same products, P = exp2(s log2 e -
//     (m log2 e + log2 l)) (the 1 / l folded into the exponent: one FMA and
//     one MUFU op a value), rounded to the output type into a staging tile
//     in P's 128-byte swizzle, and TMA stores, which clip the rows past M
//     and the columns past N and run under the next tile's products (two
//     staging buffers a consumer for 16-bit P, one for fp32);
//   * A and B are read in place through 3-D maps (contiguous axis, outer
//     axis, batch; a broadcast or one-example operand through a 2-D map), as
//     B2's engine reads them (csrc/mxu_wgmma.cuh::encode_operand), so each
//     example's M, N and K edges are zero-filled on their own and no
//     transpose is copied; P leaves through a 3-D (N, M, batch) map.
// The layout is a template parameter (the transpose bits are immediates);
// the output type is chosen at run time once a tile, around the whole
// staging loop.  No atomics, one summation order: every launch gives the
// same bits.
//
// Measured (H100 80GB HBM3, 700 W, device time; PERF.md section 6): 0.050
// ms at attention's shape, half its 0.025 ms bound (row_softmax.cu 0.50).
// Cycle stamps of one block (tools/row_softmax_ab.py): a consumer's 64 x
// 128 tile takes ~2.2-2.9k cycles, ~1k of them its turn and its eight
// wgmma issued and retired (twice their time at the data sheet's rate per
// SM; both consumers issuing at once, without turns, is 6% slower overall)
// and ~1.1k its softmax (64 MUFU ops a thread a pass, the two consumers
// sharing the units); the two phases do not overlap.  Tried and
// dropped: two accumulators in flight with the next tile's products
// issued before this tile's softmax (ptxas serialised the wgmma, C7518:
// 1.3x slower), two m64n64 product chains (4% slower), four consumer
// warpgroups at 120 registers (spills, 7x slower), three staging buffers
// with four ring stages (2% slower).
#include "flash_wgmma.cuh"
#include "mxu_wgmma.cuh"

namespace gemm_hls {

constexpr int kRsBM = 128, kRsBN = 128, kRsBK = 64;
// The A region holds kRsMaxK / kRsBK chunks: one slot of a 128-row A tile
// at K <= kRsMaxK, two at K <= 128, four at K <= 64.
constexpr int kRsMaxK = 256, kRsAChunks = kRsMaxK / kRsBK;
// One chunk: 128 rows (A) or columns (B) by 64 K values, 16 KB.
constexpr int kRsChunk = kRsBM * kWgRowBytes;
constexpr int kRsStages = 6;
// A consumer's staging: 64 rows of 512 bytes, four 128-byte-wide boxes of
// kWgMnBox; a 128-column tile of P is two boxes (16-bit) or four (fp32).
constexpr int kRsOut = 4 * kWgMnBox;

struct RsBars {
  uint64_t full[kRsStages], empty[kRsStages], a_full[kRsAChunks], a_empty[kRsAChunks];
};

// The A region, the B ring, both consumers' staging, the barriers.
constexpr int kRsSmem = 1024 + (kRsAChunks + kRsStages) * kRsChunk + 2 * kRsOut +
                        static_cast<int>(sizeof(RsBars));
static_assert(kRsSmem <= 232448, "one block a SM");

struct RsWgArgs {
  CUtensorMap ma, mb, mp;  // A and B as the caller holds them, P (N, M, batch)
  int batch, M, N, tiles_m, tiles_n;
  int kc;       // 64-deep chunks of K
  int a_slots;  // A tiles the A region holds
  int out_code, out_bytes;
  int batch_maps;  // bit 0 / 1: A / B is a 3-D map read at the example
  long long spin;
};

#define RS_R64 \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define RS_F32(d, o) \
    "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), \
    "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7]), \
    "+f"(d[o + 8]), "+f"(d[o + 9]), "+f"(d[o + 10]), "+f"(d[o + 11]), \
    "+f"(d[o + 12]), "+f"(d[o + 13]), "+f"(d[o + 14]), "+f"(d[o + 15]), \
    "+f"(d[o + 16]), "+f"(d[o + 17]), "+f"(d[o + 18]), "+f"(d[o + 19]), \
    "+f"(d[o + 20]), "+f"(d[o + 21]), "+f"(d[o + 22]), "+f"(d[o + 23]), \
    "+f"(d[o + 24]), "+f"(d[o + 25]), "+f"(d[o + 26]), "+f"(d[o + 27]), \
    "+f"(d[o + 28]), "+f"(d[o + 29]), "+f"(d[o + 30]), "+f"(d[o + 31])

// S (64 x 128 of this warpgroup, 64 a thread) (+)= A . B^T for one k16
// slice; TA / TB: the operand is MN-major (wgmma's transpose bits);
// scale_d 0 overwrites (a tile's first slice).
template <typename T, bool TA, bool TB>
__device__ __forceinline__ void rs_mma(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {" RS_R64
        "}, %64, %65, p, 1, 1, %67, %68;\n}"
        : RS_F32(d, 0), RS_F32(d, 32)
        : "l"(da), "l"(db), "r"(scale_d), "n"(static_cast<int>(TA)), "n"(static_cast<int>(TB)));
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" RS_R64
        "}, %64, %65, p, 1, 1, %67, %68;\n}"
        : RS_F32(d, 0), RS_F32(d, 32)
        : "l"(da), "l"(db), "r"(scale_d), "n"(static_cast<int>(TA)), "n"(static_cast<int>(TB)));
  }
}
#undef RS_R64
#undef RS_F32

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, %3}], [%4];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(src))
      : "memory");
}

// ex2.approx.ftz: one MUFU op (exp2f adds a denormal range's scaling);
// results below 2^-126 flush to 0, far below every output type's
// tolerance next to a row's largest probability.
__device__ __forceinline__ float rs_ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A warpgroup's 64 x 128 fragment of P into the staging tile, in P's
// 128-byte swizzle (16-byte unit u of row r at u ^ (r % 8): no bank
// conflict).  16-bit P: two 64-column boxes of kWgMnBox, by stmatrix (each
// x4 stores columns 8 j .. 8 j + 15 of the warp's 16 rows as four 8 x 8
// matrices, rows 0-7 / 8-15 of column groups j and j + 1; lane l gives the
// address of row l % 8 of matrix l / 8); a store per value pair, as
// csrc/flash_wgmma.cuh::fw_stage, measured 1% slower.
template <typename Out>
__device__ __forceinline__ void rs_stage16(unsigned char* stage, const float* p) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, q = lane / 8;
  const int row = 16 * warp + 8 * (q % 2) + lane % 8;
  const uint32_t base = smem_u32(stage) + row * kWgRowBytes;
#pragma unroll
  for (int j = 0; j < 16; j += 2) {
    const int cg = j + q / 2;
    const uint32_t addr = base + (cg / 8) * kWgMnBox + ((cg % 8) ^ (lane % 8)) * 16;
    asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};" ::"r"(addr),
                 "r"(MmaType<Out>::pack(p[4 * j], p[4 * j + 1])),
                 "r"(MmaType<Out>::pack(p[4 * j + 2], p[4 * j + 3])),
                 "r"(MmaType<Out>::pack(p[4 * j + 4], p[4 * j + 5])),
                 "r"(MmaType<Out>::pack(p[4 * j + 6], p[4 * j + 7]))
                 : "memory");
  }
}
// fp32 P: four 32-column boxes; columns 8 j + 2 tq and + 1 are one 8-byte
// store at unit 2 (j % 4) + tq / 2 of box j / 4, 8 (tq % 2) bytes in.
__device__ __forceinline__ void rs_stage32(unsigned char* stage, const float* p) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, tq = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rs = 16 * warp + lane / 4 + 8 * h;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<float2*>(stage + (j / 4) * kWgMnBox + rs * kWgRowBytes +
                                 (((2 * (j % 4) + tq / 2) ^ (rs % 8)) * 16) + 8 * (tq & 1)) =
          make_float2(p[4 * j + 2 * h], p[4 * j + 2 * h + 1]);
  }
}

template <bool MnA, bool MnB>
__device__ void rs_produce(const RsWgArgs& g, unsigned char* smem, RsBars* bars) {
  unsigned char* ring = smem + kRsAChunks * kRsChunk;
  const int items = g.batch * g.tiles_m;
  int stage = 0, slot = 0;
  uint32_t phase = 0, a_phase = 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const int z = i / g.tiles_m, m0 = (i % g.tiles_m) * kRsBM;
    const int za = g.batch_maps & 1 ? z : -1, zb = g.batch_maps & 2 ? z : -1;
    mbar_wait(&bars->a_empty[slot], a_phase ^ 1, g.spin);
    mbar_expect_tx(&bars->a_full[slot], g.kc * kRsChunk);
    unsigned char* a = smem + slot * g.kc * kRsChunk;
    for (int c = 0; c < g.kc; ++c) {
      if constexpr (MnA) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          tma_load_z(a + c * kRsChunk + h * kWgMnBox, &g.ma, m0 + 64 * h, c * kRsBK, za,
                     &bars->a_full[slot]);
      } else {
        tma_load_z(a + c * kRsChunk, &g.ma, c * kRsBK, m0, za, &bars->a_full[slot]);
      }
    }
    if (++slot == g.a_slots) {
      slot = 0;
      a_phase ^= 1;
    }
    // Pass 1's tiles, then pass 2's: the same chunks in the same order.
    for (int t = 0; t < 2 * g.tiles_n; ++t) {
      const int n0 = (t % g.tiles_n) * kRsBN;
      for (int c = 0; c < g.kc; ++c) {
        mbar_wait(&bars->empty[stage], phase ^ 1, g.spin);
        mbar_expect_tx(&bars->full[stage], kRsChunk);
        unsigned char* st = ring + stage * kRsChunk;
        if constexpr (MnB) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            tma_load_z(st + h * kWgMnBox, &g.mb, n0 + 64 * h, c * kRsBK, zb, &bars->full[stage]);
        } else {
          tma_load_z(st, &g.mb, c * kRsBK, n0, zb, &bars->full[stage]);
        }
        if (++stage == kRsStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  }
}

// The consumers' place in the ring, carried from tile to tile.
struct RsRing {
  int stage = 0;
  uint32_t phase = 0;
};

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The consumers take turns at the tensor cores (named barrier 4 + wg:
// warpgroup wg's turn): each issues its products once the other's have
// retired, so one warpgroup's softmax runs under the other's products (5%
// faster than no turns; handing the turn on at the issue measured level).
// Warpgroup 0 opens its first turn itself (rs_turns_open) and closes the
// last one the other hands it (rs_turns_close).
__device__ __forceinline__ void rs_turns_open(int wg) {
  if (wg == 0) named_arrive(4, 256);
}
__device__ __forceinline__ void rs_turns_close(int wg) {
  if (wg == 0) named_sync(4, 256);
}

// This warpgroup's S of the next N tile, in its turn: every chunk's four k16
// products as its stage lands, the stages released once the products have
// retired.
template <typename T, bool MnA, bool MnB>
__device__ __forceinline__ void rs_scores(float (&s)[64], RsRing& r, const RsWgArgs& g,
                                          RsBars* bars, uint32_t a_base, uint32_t ring, int wg) {
  using SA = WgSlab<MnA>;
  using SB = WgSlab<MnB>;
  const int first = r.stage;
  named_sync(4 + wg, 256);
  for (int c = 0; c < g.kc; ++c) {
    mbar_wait(&bars->full[r.stage], r.phase, g.spin);
    const uint64_t da = SA::desc(a_base + c * kRsChunk), db = SB::desc(ring + r.stage * kRsChunk);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      rs_mma<T, MnA, MnB>(s, da + SA::kStep * kk, db + SB::kStep * kk, c > 0 || kk > 0);
    wg_commit();
    if (++r.stage == kRsStages) {
      r.stage = 0;
      r.phase ^= 1;
    }
  }
  wg_wait<0>();
  named_arrive(4 + (wg ^ 1), 256);
  wg_pin(s);
  for (int c = 0, st = first; c < g.kc; ++c) {
    mbar_arrive(&bars->empty[st]);
    if (++st == kRsStages) st = 0;
  }
}

template <typename T, bool MnA, bool MnB>
__device__ void rs_consume(const RsWgArgs& g, unsigned char* smem, RsBars* bars) {
  const int wg = threadIdx.x / 128 - 1, tid = threadIdx.x % 128, tq = tid % 4;
  const uint32_t base = smem_u32(smem), ring = base + kRsAChunks * kRsChunk;
  unsigned char* out = smem + (kRsAChunks + kRsStages) * kRsChunk + wg * kRsOut;
  const int boxes = g.out_bytes, cols = kWgRowBytes / g.out_bytes;  // a tile's boxes, a box's columns
  const int items = g.batch * g.tiles_m;
  RsRing r;
  int slot = 0, buf = 0;
  uint32_t a_phase = 0;
  rs_turns_open(wg);
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const int z = i / g.tiles_m, m0 = (i % g.tiles_m) * kRsBM;
    // This warpgroup's 64 rows: half a K-major box, or one of the two
    // MN-major boxes of a chunk (8 KB in either way).
    const uint32_t a_base = base + slot * g.kc * kRsChunk + wg * kWgMnBox;
    mbar_wait(&bars->a_full[slot], a_phase, g.spin);
    // Value x of the fragment is row 16 warp + lane / 4 + 8 ((x % 4) / 2),
    // column 8 (x / 4) + 2 tq + x % 2 of the tile.  Pass 1: each row's max
    // m of the scores and sum l of exp2((s - m) log2 e), the sum in four
    // partial chains (two a row).
    float m_r[2] = {-INFINITY, -INFINITY}, l_r[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < g.tiles_n; ++j) {
      float s[64];
      rs_scores<T, MnA, MnB>(s, r, g, bars, a_base, ring, wg);
      const int n0 = j * kRsBN;
      if (n0 + kRsBN > g.N) {
#pragma unroll
        for (int x = 0; x < 64; ++x)
          if (n0 + 8 * (x / 4) + 2 * tq + (x & 1) >= g.N) s[x] = -INFINITY;
      }
      float mx[4] = {m_r[0], m_r[0], m_r[1], m_r[1]};
#pragma unroll
      for (int x = 0; x < 64; ++x) mx[x % 4] = fmaxf(mx[x % 4], s[x]);
      float ml[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = fmaxf(mx[2 * h], mx[2 * h + 1]);
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
        const float corr = rs_ex2((m_r[h] - v) * kLog2e);  // 0 at the first tile (m_r -inf)
        l_r[2 * h] *= corr;
        l_r[2 * h + 1] *= corr;
        m_r[h] = v;
        ml[h] = v * kLog2e;
      }
#pragma unroll
      for (int x = 0; x < 64; ++x) l_r[x % 4] += rs_ex2(fmaf(s[x], kLog2e, -ml[(x % 4) >> 1]));
    }
    // Pass 2: P = exp2(s log2 e - (m log2 e + log2 l)), the 1 / l folded
    // into the exponent.
    float c[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_r[2 * h] + l_r[2 * h + 1];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      c[h] = m_r[h] * kLog2e + __log2f(l);
    }
    for (int j = 0; j < g.tiles_n; ++j) {
      float s[64];
      rs_scores<T, MnA, MnB>(s, r, g, bars, a_base, ring, wg);
      if (j == g.tiles_n - 1) mbar_arrive(&bars->a_empty[slot]);  // this thread's reads of A are over
#pragma unroll
      for (int x = 0; x < 64; ++x) s[x] = rs_ex2(fmaf(s[x], kLog2e, -c[(x % 4) >> 1]));
      // One staging buffer (fp32): the store that read it last has read it.
      if (boxes == 4) {
        if (tid == 0) bulk_wait_read<0>();
        named_sync(2 + wg, 128);
      }
      unsigned char* o = out + buf * boxes * kWgMnBox;
      switch (g.out_code) {
        case kBF16: rs_stage16<__nv_bfloat16>(o, s); break;
        case kF16: rs_stage16<__half>(o, s); break;
        default: rs_stage32(o, s); break;
      }
      fence_proxy_async_shared();
      // Two buffers (16-bit P): the store of the other one, issued a tile
      // ago, has read it before anyone passes this barrier to write it.
      if (tid == 0 && boxes == 2) bulk_wait_read<0>();
      named_sync(2 + wg, 128);
      if (tid == 0) {
        for (int b = 0; b < boxes; ++b)
          tma_store_3d(&g.mp, o + b * kWgMnBox, j * kRsBN + b * cols, m0 + 64 * wg, z);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
      if (boxes == 2) buf ^= 1;
    }
    if (++slot == g.a_slots) {
      slot = 0;
      a_phase ^= 1;
    }
  }
  rs_turns_close(wg);
  if (tid == 0) bulk_wait_all();  // the stores are done before the block exits
}

template <typename T, bool MnA, bool MnB>
__global__ void __launch_bounds__(kFwThreads, 1)
    row_softmax_wg_kernel(const __grid_constant__ RsWgArgs g) {
  extern __shared__ unsigned char dyn_smem[];
  unsigned char* smem = wg_align(dyn_smem);
  RsBars* bars = reinterpret_cast<RsBars*>(smem + (kRsAChunks + kRsStages) * kRsChunk + 2 * kRsOut);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRsStages; ++i) {
      mbar_init(&bars->full[i], 1);
      mbar_init(&bars->empty[i], 256);
    }
    for (int i = 0; i < kRsAChunks; ++i) {
      mbar_init(&bars->a_full[i], 1);
      mbar_init(&bars->a_empty[i], 256);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    reg_dealloc<40>();
    if (threadIdx.x == 0) rs_produce<MnA, MnB>(g, smem, bars);
  } else {
    reg_alloc<232>();
    rs_consume<T, MnA, MnB>(g, smem, bars);
  }
}

// MnA: A is held (K, M); MnB: B is held (K, N).
template <typename T, bool MnA, bool MnB>
int launch_rs_wg(const MxuWgCall& call, cudaStream_t st) {
  constexpr int esize = sizeof(T);
  constexpr bool f16 = std::is_same<T, __half>::value;
  RsWgArgs g{};
  const int ob = out_bytes(call.out_code);
  const int64_t p_dims[3] = {call.N, call.M, call.batch};
  const int64_t p_strides[2] = {static_cast<int64_t>(call.N) * ob,
                                static_cast<int64_t>(call.M) * call.N * ob};
  const int p_box[3] = {kWgRowBytes / ob, 64, 1};
  if (!encode_operand(&g.ma, call.a, MnA, call.M, call.K, call.lda, call.sa, call.batch, esize,
                      f16, kRsBM) ||
      !encode_operand(&g.mb, call.b, MnB, call.N, call.K, call.ldb, call.sb, call.batch, esize,
                      f16, kRsBN) ||
      !encode_nd(&g.mp, call.c, 3, p_dims, p_strides, p_box, ob, call.out_code == kF16))
    return kTmaEncodeFailed;
  g.batch = call.batch;
  g.M = call.M;
  g.N = call.N;
  g.tiles_m = (call.M + kRsBM - 1) / kRsBM;
  g.tiles_n = (call.N + kRsBN - 1) / kRsBN;
  g.kc = (call.K + kRsBK - 1) / kRsBK;
  g.a_slots = kRsAChunks / g.kc;
  g.out_code = call.out_code;
  g.out_bytes = ob;
  g.batch_maps = (call.sa ? 1 : 0) | (call.sb ? 2 : 0);
  g.spin = spin_cycles(10000);  // a stage wait is microseconds; 10 s means a lost load
  return launch_persistent(row_softmax_wg_kernel<T, MnA, MnB>, g, kRsSmem,
                           static_cast<int64_t>(call.batch) * g.tiles_m, st);
}

template <typename T>
int launch_rs_wg_16(const MxuWgCall& call, cudaStream_t st) {
  if (call.ta)
    return call.tb ? launch_rs_wg<T, true, false>(call, st) : launch_rs_wg<T, true, true>(call, st);
  return call.tb ? launch_rs_wg<T, false, false>(call, st) : launch_rs_wg<T, false, true>(call, st);
}

}  // namespace gemm_hls

using namespace gemm_hls;

// P (batch, M, N) row-major in ``out_code``'s dtype (fp32, bf16, fp16):
// mxu_wgmma's operand arguments (csrc/mxu_wgmma.cu) without the epilogue,
// bf16 / fp16 inputs with K <= 256, every base, row pitch and batch stride
// whole 16-byte units and N times the output's bytes too.  Returns 0, a
// CUDA error code, -1 for what the route does not take, or -2 for a tensor
// map cuTensorMapEncodeTiled refused.
extern "C" int row_softmax_wgmma(const void* a, const void* b, void* c, int64_t batch, int M,
                                 int N, int K, int64_t lda, int64_t ldb, int64_t sa, int64_t sb,
                                 int ta, int tb, int in_code, int out_code, void* stream) {
  if (M < 1 || N < 1 || K < 1 || K > kRsMaxK || batch < 1 || batch > INT_MAX) return kUnsupported;
  if (out_code != kF32 && out_code != kBF16 && out_code != kF16) return kUnsupported;
  if (static_cast<int64_t>(N) * out_bytes(out_code) % 16) return kUnsupported;
  if (batch * ((M + kRsBM - 1) / kRsBM) > INT_MAX) return kUnsupported;
  const MxuWgCall call{a,  b,  c,  static_cast<int>(batch), M, N, K, lda, ldb, sa, sb,
                       ta, tb, out_code, EpArgs{nullptr, nullptr, 0, kEpNone}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (in_code) {
    case kBF16: return launch_rs_wg_16<__nv_bfloat16>(call, st);
    case kF16: return launch_rs_wg_16<__half>(call, st);
    default: return kUnsupported;
  }
}
