// The GEMM inside the fused distributed kernels (csrc/ring_gemm.cu, B18;
// csrc/cannon_gemm.cu, B19): one output tile C[m0.., n0..] = A . B over all
// of K, with A (M, K) and B held transposed, B^T (N, K), both row-major,
// so each route reads both operands K-contiguous.  Every operand load goes
// through the L2 (tile_mma.cuh's loaders: cp.async.cg, ld.global.cg): B^T,
// and in Cannon A too, lives in buffers other ranks write during the
// launch (rank_sync.cuh).
//
// Routes by element type, on the port's tile code (tile_mma.cuh):
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
// count, and the sender path's eight 16-byte vectors fit beside it).
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
// routes' double buffers, 30 KB), also the staging transpose's tile.
constexpr int kTileSmem = 2 * (64 + 128) * 80;

// Where a tile goes: out[off + r * ldo + c] = acc (+ add[r * ld_add + c],
// Acc-typed, when add is set), cast to out_code.
struct TileOut {
  const void* add;
  int64_t ld_add;
  void* out;
  int64_t off, ldo;
  int out_code;
};

template <typename Acc>
__device__ __forceinline__ void put(const TileOut& o, int r, int c, Acc v) {
  if (o.add) v += static_cast<const Acc*>(o.add)[static_cast<int64_t>(r) * o.ld_add + c];
  store_out(o.out, o.off + static_cast<int64_t>(r) * o.ldo + c, v, o.out_code);
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
// element's Bits.  src is an input no rank writes during the launch.
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

// Cooperative launch of ``kern`` over ``ranks`` ranks of n_send + n_comp
// blocks each (written into g): the grid is sized from the kernel's
// occupancy so that every block is resident at once, which the rank
// protocol needs; ``max_per_rank`` > 0 caps the blocks of a rank (tests).
// One sender block per 16 (at least one); compute blocks up to the tiles
// of a step.  Returns 0 or the CUDA error (a refused launch included).
template <typename Kern, typename Args>
int launch_ranks(Kern kern, Args& g, int ranks, int threads, int tiles, int max_per_rank,
                 cudaStream_t st, int* split_out) {
  int dev = 0, sms = 0, per_sm = 0;
  int err = cudaGetDevice(&dev);
  if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, 0);
  if (err) return err;
  int per_rank = per_sm * sms / ranks;
  if (max_per_rank > 0 && max_per_rank < per_rank) per_rank = max_per_rank;
  if (per_rank < 2) return cudaErrorCooperativeLaunchTooLarge;
  g.n_send = per_rank / 16 > 1 ? per_rank / 16 : 1;
  g.n_comp = per_rank - g.n_send < tiles ? per_rank - g.n_send : (tiles > 0 ? tiles : 1);
  if (split_out) {
    split_out[0] = g.n_send;
    split_out[1] = g.n_comp;
  }
  void* args[] = {&g};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                    dim3(ranks * (g.n_send + g.n_comp)), dim3(threads), args, 0,
                                    st);
  return err ? err : last_error();
}

}  // namespace gemm_hls
