// The GEMM tiles inside the fused distributed kernels (csrc/ring_gemm.cu,
// B18; csrc/cannon_gemm.cu, B19) that do not run on the Hopper tile engine
// (csrc/wgmma_tile.cuh), and what both kinds share: the output of a tile
// (TileOut / put, with Cannon's per-step rounding), the tile order, the
// staging transpose, the stamps and the cooperative launch.
//
// One output tile C[m0.., n0..] = A . B over all of K, with A (M, K) and B
// held transposed, B^T (N, K), both row-major, so each route reads both
// operands K-contiguous.  Every operand load here goes through the L2
// (tile_mma.cuh's loaders: cp.async.cg, ld.global.cg): B^T, and in Cannon
// A too, lives in buffers other ranks write during the launch
// (rank_sync.cuh).  The wrappers take these routes by shape where the
// engine's TMA cannot describe an operand (K bytes not a multiple of 16),
// and for fp32:
//   * bf16: tensor cores, mma.sync m16n8k16 with fp32 sums (mma_step), a
//     64 x 128 tile by eight warps, K steps of 32 double-buffered by
//     cp.async;
//   * int8: tensor cores, mma.sync m16n8k32 s8 x s8 -> s32 (mma_s8, the
//     fragment layout of csrc/w8a8_gemm.cu), the same tile, K steps of 64
//     bytes;
//   * fp32: IEEE fp32 FMA on the CUDA cores (simt_steps), a 64 x 64 tile by
//     128 threads, K steps of 32.
// One set of accumulators runs over all of K in those steps, so the bits do
// not depend on the TPU's block_k (which the ring's wrapper only checks).
// Ragged edges (M, N or K off the tile) are zero-filled at load, never
// padded in memory.
#pragma once

#include "rank_sync.cuh"
#include "tile_mma.cuh"

namespace gemm_hls {

// MINB: the resident blocks a SM the kernels ask of ptxas (a register cap
// of 64 a thread for the tensor-core routes: the tile needs ~57, B16's
// count; Cannon's per-step rounding spills 116-156 bytes beside it).
template <typename T> struct Route;
template <> struct Route<__nv_bfloat16> {
  using Acc = float;
  static constexpr int BM = 64, BN = 128, BK = 32, NT = 256, MINB = 4;
};
template <> struct Route<signed char> {
  using Acc = int;
  static constexpr int BM = 64, BN = 128, BK = 64, NT = 256, MINB = 4;
};
template <> struct Route<float> {
  using Acc = float;
  static constexpr int BM = SIMT_B, BN = SIMT_B, BK = 32, NT = SIMT_T, MINB = 4;
};

// Static shared memory of every route (the larger of the tensor-core
// routes' double buffers, 30 KB), also the staging transpose's tile and
// a sender block's bulk-copy slots.
constexpr int kTileSmem = 2 * (64 + 128) * 80;

// Where a tile goes: out[off + r * ldo + c] = acc (+ add[r * ld_add + c],
// Acc-typed, when add is set), cast to out_code.  With ``round`` (kBF16 or
// kF16; 0 for none) the value is rounded to that type, and so is its sum
// with ``add`` (then fp32): Cannon's running sum kept in a narrow
// out_dtype, as pallas_cannon.py's acc of out_dtype rounds each step's
// product and partial sum.
struct TileOut {
  const void* add;
  int64_t ld_add;
  void* out;
  int64_t off, ldo;
  int out_code;
  int round;
};

__device__ __forceinline__ float round_to(float v, int code) {
  return code == kBF16 ? __bfloat162float(__float2bfloat16(v)) : __half2float(__float2half(v));
}

// The value put() stores, before the cast to the output type.  ``add`` is
// read through the L2: on the wgmma route another SM wrote it.
template <typename Acc>
__device__ __forceinline__ float rounded_sum(const TileOut& o, int r, int c, Acc v) {
  float f = round_to(static_cast<float>(v), o.round);
  if (o.add)
    f = round_to(f + __ldcg(static_cast<const float*>(o.add) + static_cast<int64_t>(r) * o.ld_add + c),
                 o.round);
  return f;
}

template <typename Acc>
__device__ __forceinline__ void put(const TileOut& o, int r, int c, Acc v) {
  const int64_t idx = o.off + static_cast<int64_t>(r) * o.ldo + c;
  if (o.round) {
    store_out(o.out, idx, rounded_sum(o, r, c, v), o.out_code);
    return;
  }
  if (o.add) v += __ldcg(static_cast<const Acc*>(o.add) + static_cast<int64_t>(r) * o.ld_add + c);
  store_out(o.out, idx, v, o.out_code);
}

// Origin (m0, n0) of tile t of a tiles_m x tiles_n grid of bm x bn tiles,
// walked in groups of 8 tile rows, column by column within a group, so the
// blocks working at one time share A's and B's K-long panels in the L2
// (on an H100 it shortened B19 at bf16 8192^3, p = 2, against tiles in row
// order; the ring's compute blocks already covered 8 tile rows).
__device__ __forceinline__ void tile_origin(int t, int tiles_m, int tiles_n, int bm, int bn,
                                            int& m0, int& n0) {
  const int per = 8 * tiles_n, first = t / per * 8;
  const int gm = min(tiles_m - first, 8);
  m0 = (first + t % per % gm) * bm;
  n0 = t % per / gm * bn;
}

// d += the 64 x 128 product of the shared tiles at ``at`` / ``bt`` (one
// BK step), this warp's 32 x 32 part.
template <typename T, typename Acc>
__device__ __forceinline__ void tc_kstep(Acc (&d)[2][4][4], const T* at, const T* bt, int wm0,
                                         int wn0) {
  using R = Route<T>;
  const int lane = threadIdx.x % 32;
  if constexpr (sizeof(T) == 1) {
    constexpr int P = 80;
    const int a_row = wm0 + (lane % 8) + 8 * ((lane / 8) & 1), a_col = 16 * (lane / 16);
    const int b_row = wn0 + (lane % 8) + 8 * (lane / 16), b_col = 16 * ((lane / 8) & 1);
#pragma unroll
    for (int kk = 0; kk < R::BK; kk += 32) {
      uint32_t af[2][4], bf[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) ldsm_x4(af[mt], at + (a_row + mt * 16) * P + kk + a_col);
#pragma unroll
      for (int np = 0; np < 2; ++np) ldsm_x4(bf[np], bt + (b_row + np * 16) * P + kk + b_col);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_s8(d[mt][nt], af[mt], bf[nt / 2][2 * (nt % 2)], bf[nt / 2][2 * (nt % 2) + 1]);
    }
  } else {
    constexpr int P = R::BK + 8;
#pragma unroll
    for (int kk = 0; kk < R::BK; kk += 16)
      mma_step<T, 2, 4, true, P, P>(d, reinterpret_cast<const uint16_t*>(at),
                                    reinterpret_cast<const uint16_t*>(bt), wm0, wn0, kk);
  }
}

// One C tile on the tensor cores (T bf16 or int8), 256 threads.
template <typename T>
__device__ void tile_tc(unsigned char* smem, const void* a, int64_t lda, int vec_a, const void* bt,
                        int64_t ldb, int vec_b, int M, int N, int K, int m0, int n0,
                        const TileOut& o) {
  using R = Route<T>;
  using Acc = typename R::Acc;
  constexpr bool kS8 = sizeof(T) == 1;
  constexpr int P = kS8 ? 80 : R::BK + 8;  // pitch in elements (80 bytes for int8)
  constexpr int A_EL = R::BM * P, B_EL = R::BN * P;
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + 2 * A_EL;
  const int warp = threadIdx.x / 32;
  const int wm0 = (warp % 2) * 32, wn0 = (warp / 2) * 32;
  const int steps = (K + R::BK - 1) / R::BK;

  auto load = [&](int buf, int t) {
    const int k0 = t * R::BK;
    if constexpr (kS8) {
      load8<R::BM, R::BK, P, R::NT>(As + buf * A_EL, static_cast<const signed char*>(a), lda, m0,
                                    0, M, k0, K, vec_a);
      load8<R::BN, R::BK, P, R::NT>(Bs + buf * B_EL, static_cast<const signed char*>(bt), ldb, n0,
                                    0, N, k0, K, vec_b);
    } else {
      load16<R::BM, R::BK, P, R::NT>(reinterpret_cast<uint16_t*>(As + buf * A_EL),
                                     static_cast<const uint16_t*>(a), lda, m0, 0, M, k0, K, vec_a);
      load16<R::BN, R::BK, P, R::NT>(reinterpret_cast<uint16_t*>(Bs + buf * B_EL),
                                     static_cast<const uint16_t*>(bt), ldb, n0, 0, N, k0, K, vec_b);
    }
  };

  Acc acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = Acc(0);

  if (steps > 0) load(0, 0);
  cp_commit();
  for (int t = 0; t < steps; ++t) {
    const int cur = t & 1;
    if (t + 1 < steps) load(cur ^ 1, t + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    tc_kstep<T>(acc, As + cur * A_EL, Bs + cur * B_EL, wm0, wn0);
    __syncthreads();
  }
  cp_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + acc_row(wm0, mt, e), c = n0 + acc_col(wn0, nt, e);
        if (r < M && c < N) put(o, r, c, acc[mt][nt][e]);
      }
}

// One C tile in IEEE fp32 on the CUDA cores, 128 threads.
__device__ inline void tile_f32(unsigned char* smem, const void* a, int64_t lda, const void* bt,
                         int64_t ldb, int M, int N, int K, int m0, int n0, const TileOut& o) {
  constexpr int BK = Route<float>::BK;
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + BK * SIMT_P;
  float acc[8][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();
    load32<BK>(As, static_cast<const float*>(a), lda, true, m0, 0, M, k0, K);
    load32<BK>(Bs, static_cast<const float*>(bt), ldb, true, n0, 0, N, k0, K);
    __syncthreads();
    simt_steps<BK>(acc, As, Bs, min(BK, K - k0));
  }
  __syncthreads();  // the caller's next tile reuses the shared tiles
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + ty * 8 + i, c = n0 + tx * 4 + j;
      if (r < M && c < N) put(o, r, c, acc[i][j]);
    }
}

template <typename T>
__device__ __forceinline__ void gemm_tile(unsigned char* smem, const void* a, int64_t lda,
                                          int vec_a, const void* bt, int64_t ldb, int vec_b,
                                          int M, int N, int K, int m0, int n0, const TileOut& o) {
  if constexpr (std::is_same<T, float>::value)
    tile_f32(smem, a, lda, bt, ldb, M, N, K, m0, n0, o);
  else
    tile_tc<T>(smem, a, lda, vec_a, bt, ldb, vec_b, M, N, K, m0, n0, o);
}

// The element as raw bits (bf16 moves as uint16_t).
template <typename T>
using Bits = typename std::conditional<sizeof(T) == 2, uint16_t, T>::type;

// dst (N, K) = src (K, N)^T for rows [n_lo, n_hi) of dst, by the block,
// through a 32 x 33 shared tile (coalesced on both sides); T is the
// element's Bits.  src is an input no rank writes during the launch.  The
// fallback of stage_rows for rows that are not whole 16-byte vectors.
template <typename T>
__device__ void transpose_rows(T* dst, const T* src, int K, int N, int n_lo, int n_hi, T* tile) {
  for (int k0 = 0; k0 < K; k0 += 32)
    for (int n0 = n_lo; n0 < n_hi; n0 += 32) {
      for (int i = threadIdx.x; i < 32 * 32; i += blockDim.x) {
        const int r = i / 32, c = i % 32, gk = k0 + r, gn = n0 + c;
        tile[r * 33 + c] = gk < K && gn < n_hi ? src[static_cast<int64_t>(gk) * N + gn] : T(0);
      }
      __syncthreads();
      for (int i = threadIdx.x; i < 32 * 32; i += blockDim.x) {
        const int r = i / 32, c = i % 32, gn = n0 + r, gk = k0 + c;
        if (gn < n_hi && gk < K) dst[static_cast<int64_t>(gn) * K + gk] = tile[c * 33 + r];
      }
      __syncthreads();
    }
}

// The same in 16-byte vectors, for rows of both src and dst that are
// whole vectors (16-byte aligned bases, n_lo / n_hi multiples of a
// vector): each of the NT threads keeps V vector loads in flight (36 KB a
// block at 384 x 6; transpose_rows, a scalar load at a time, staged at
// ~0.2 TB/s over the card), then scatters them into a 64-row shared tile held
// transposed (the threads of a warp take consecutive K rows, so both the
// scatter and the vector reads out of the tile are conflict-free) and
// writes each dst row's piece of K as vectors.  Shared memory: 64 (NT V
// 16 / 64 + 16) bytes.
template <typename T, int NT, int V>
__device__ void transpose_rows_vec(T* dst, const T* src, int K, int N, int n_lo, int n_hi,
                                   T* tile) {
  constexpr int VN = 16 / sizeof(T), TN = 64, W = TN / VN, TK = NT * V / W, P = TK + VN;
  constexpr int KV = TK / VN;
  static_assert(NT * V % W == 0 && TK % VN == 0, "tile shape");
  for (int k0 = 0; k0 < K; k0 += TK)
    for (int n0 = n_lo; n0 < n_hi; n0 += TN) {
      uint4 v[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int i = threadIdx.x + j * NT, nv = i / TK, kr = i % TK;
        const int gk = k0 + kr, gn = n0 + nv * VN;
        v[j] = gk < K && gn < n_hi
                   ? __ldg(reinterpret_cast<const uint4*>(src + static_cast<int64_t>(gk) * N + gn))
                   : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int i = threadIdx.x + j * NT, nv = i / TK, kr = i % TK;
        const T* e = reinterpret_cast<const T*>(&v[j]);
#pragma unroll
        for (int q = 0; q < VN; ++q) tile[(nv * VN + q) * P + kr] = e[q];
      }
      __syncthreads();
      for (int u = threadIdx.x; u < TN * KV; u += NT) {
        const int n = u / KV, kv = u % KV, gn = n0 + n, gk = k0 + kv * VN;
        if (gn < n_hi && gk < K)
          *reinterpret_cast<uint4*>(dst + static_cast<int64_t>(gn) * K + gk) =
              *reinterpret_cast<const uint4*>(tile + n * P + kv * VN);
      }
      __syncthreads();
    }
}

// Bytes of shared memory stage_rows<T, NT, V> may use as its tile.
template <int NT, int V> __host__ __device__ constexpr int stage_tile_bytes() {
  return NT * V * 16 + 64 * 16;
}

// Part ``part`` of ``parts`` of dst (N, K) = src (K, N)^T, split by dst
// rows, by the block of NT threads: in vectors where every row is whole
// 16-byte vectors (then the parts are split at vector bounds), else
// element by element.
template <typename T, int NT, int V>
__device__ void stage_rows(T* dst, const T* src, int K, int N, int part, int parts, T* tile) {
  constexpr int VN = 16 / sizeof(T);
  const bool vec = static_cast<int64_t>(N) % VN == 0 && static_cast<int64_t>(K) % VN == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  const int align = vec ? VN : 1;
  const int lo = static_cast<int>(split_at(N, parts, part, align));
  const int hi = static_cast<int>(split_at(N, parts, part + 1, align));
  if (vec)
    transpose_rows_vec<T, NT, V>(dst, src, K, N, lo, hi, tile);
  else
    transpose_rows<T>(dst, src, K, N, lo, hi, tile);
}

// Optional time stamps of one launch (%globaltimer, ns), int64, per rank
// stamp_words(steps) of them, zeroed by the wrapper:
//   [0] launch start and [1] staging / skew done, as compute block 0 saw
//   them (its producer's wait for recv[0] ended), [2] the longest flag wait
//   of any compute block of the rank (ns), [3] unused, [4 + s] compute
//   block 0 begins step s, [4 + steps + s] it ends step s, [4 + 2 steps +
//   s] sender block 0 has sent step s's block.
constexpr int kStampHead = 4;
__host__ __device__ inline int stamp_words(int steps) { return kStampHead + 3 * steps; }

__device__ __forceinline__ void stamp_max(long long* at, long long v) {
  atomicMax(reinterpret_cast<unsigned long long*>(at), static_cast<unsigned long long>(v));
}

// Cooperative launch of ``kern`` over ``ranks`` ranks of n_send + n_comp
// blocks each (written into g), ``threads`` threads and ``smem`` bytes of
// dynamic shared memory a block: the grid is sized from the kernel's
// occupancy at that shared memory so that every block is resident at once,
// which the rank protocol needs; ``max_per_rank`` > 0 caps the blocks of a
// rank (tests).  ``n_send`` >= 0 is the wrapper's choice of sender blocks
// (ops/ring.py::send_blocks: each step's bytes against its operations),
// kept below the blocks of the rank; -1 takes one per 16 blocks (at least
// one).  Compute blocks up to the tiles of a step.  Returns 0 or the CUDA
// error (a refused launch included: a grid that does not fit is never run
// partly resident).
template <typename Kern, typename Args>
int launch_ranks(Kern kern, Args& g, int ranks, int threads, int smem, int tiles,
                 int max_per_rank, int n_send, cudaStream_t st, int* split_out) {
  int dev = 0, sms = 0, per_sm = 0;
  int err = cudaGetDevice(&dev);
  if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err && smem > 48 * 1024)
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kern),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (!err) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  if (err) return err;
  int per_rank = per_sm * sms / ranks;
  if (max_per_rank > 0 && max_per_rank < per_rank) per_rank = max_per_rank;
  if (per_rank < 2) return cudaErrorCooperativeLaunchTooLarge;
  if (n_send < 0) n_send = per_rank / 16 > 1 ? per_rank / 16 : 1;
  g.n_send = n_send < per_rank - 1 ? n_send : per_rank - 1;
  g.n_comp = per_rank - g.n_send < tiles ? per_rank - g.n_send : (tiles > 0 ? tiles : 1);
  if (split_out) {
    split_out[0] = g.n_send;
    split_out[1] = g.n_comp;
  }
  void* args[] = {&g};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                    dim3(ranks * (g.n_send + g.n_comp)), dim3(threads), args,
                                    smem, st);
  return err ? err : last_error();
}

}  // namespace gemm_hls
