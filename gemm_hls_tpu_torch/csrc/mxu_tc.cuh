// The tensor-core tile of kernels B1 and B2 (WMMA 16x16x16 on bf16 / fp16 /
// int8), its templates in a header so a generated translation unit
// (gemm_hls_tpu_torch/ops/codegen.py: a Python callable's epilogue compiled
// at first use) instantiates the one layout its call takes with its own
// epilogue functor.  The design, the layouts and the bounds: csrc/mxu_gemm.cu,
// whose entry point instantiates the built-in tiles.
#pragma once

#include <mma.h>

#include <type_traits>

#include "simt_gemm.cuh"

namespace gemm_hls {

using namespace nvcuda;

constexpr int TBM = 128, TBN = 128, TBK = 32, TTHREADS = 256, TWARPS = 8;

template <typename T> struct TcTraits;
template <> struct TcTraits<__nv_bfloat16> {
  using Acc = float;
  using Raw = uint16_t;
  static constexpr int VEC = 8, LDP = 24;
};
template <> struct TcTraits<__half> {
  using Acc = float;
  using Raw = uint16_t;
  static constexpr int VEC = 8, LDP = 24;
};
template <> struct TcTraits<signed char> {
  using Acc = int;
  using Raw = signed char;
  static constexpr int VEC = 16, LDP = 32;
};

// Padded row, in elements, of a B tile kept in its natural [k][n] layout.
constexpr int ROW_LD = TBN + 8;

// Chunk ``ch`` of an operand K-slice -> (row r, first column col) in the
// operand's global orientation (columns = its contiguous axis).  With K
// contiguous, or with ROW (the tile keeps its natural layout), consecutive
// chunks run along a row.  With K strided into K planes, each chunk's VEC
// elements land in VEC different plane rows of shared memory; running
// consecutive chunks along a row would put a warp's stores in one bank
// (16-way conflicts), so a warp instead takes 16 K rows x 2 neighbouring
// chunks: full 32-byte sectors on the load, 2-way conflicts on the store.
template <int R, int VEC, bool ROW>
__device__ __forceinline__ void chunk_coords(int ch, bool k_contig, int& r, int& col) {
  if (k_contig || ROW) {
    const int cpr = (k_contig ? TBK : R) / VEC;
    r = ch / cpr;
    col = (ch % cpr) * VEC;
  } else {
    r = (ch / 2) % TBK;
    col = ((ch / (2 * TBK)) * 2 + ch % 2) * VEC;
  }
}

// One operand K-slice of R rows ("o": m for A, n for B) by TBK, read in
// VEC-element chunks along the operand's contiguous axis.
template <typename Tr, int R, bool ROW>
__device__ __forceinline__ void tc_load(uint4 (&reg)[R * TBK / Tr::VEC / TTHREADS],
                                        const typename Tr::Raw* __restrict__ g, int64_t ld,
                                        bool k_contig, int o0, int k0, int O, int K, bool vec_ok) {
  using Raw = typename Tr::Raw;
  constexpr int VEC = Tr::VEC, CH = R * TBK / VEC / TTHREADS;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    int r, col;
    chunk_coords<R, VEC, ROW>(threadIdx.x + c * TTHREADS, k_contig, r, col);
    const int64_t gr = (k_contig ? o0 : k0) + r;
    const int64_t gc = (k_contig ? k0 : o0) + col;
    const int64_t rlim = k_contig ? O : K, clim = k_contig ? K : O;
    if (vec_ok && gr < rlim && gc + VEC <= clim) {
      reg[c] = __ldg(reinterpret_cast<const uint4*>(g + gr * ld + gc));
    } else {
      Raw* e = reinterpret_cast<Raw*>(&reg[c]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) e[i] = (gr < rlim && gc + i < clim) ? g[gr * ld + gc + i] : Raw(0);
    }
  }
}

template <typename Tr, int R, bool ROW>
__device__ __forceinline__ void tc_store(typename Tr::Raw* s,
                                         const uint4 (&reg)[R * TBK / Tr::VEC / TTHREADS],
                                         bool k_contig) {
  using Raw = typename Tr::Raw;
  constexpr int VEC = Tr::VEC, LDP = Tr::LDP, CH = R * TBK / VEC / TTHREADS;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    int r, col;
    chunk_coords<R, VEC, ROW>(threadIdx.x + c * TTHREADS, k_contig, r, col);
    if (k_contig) {  // o = r, k = col .. col + VEC - 1, inside one K plane
      *reinterpret_cast<uint4*>(s + ((col >> 4) * R + r) * LDP + (col & 15)) = reg[c];
    } else if (ROW) {  // natural layout: k = r, o = col .. col + VEC - 1
      *reinterpret_cast<uint4*>(s + r * ROW_LD + col) = reg[c];
    } else {  // k = r, o = col + i
      const Raw* e = reinterpret_cast<const Raw*>(&reg[c]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) s[((r >> 4) * R + col + i) * LDP + (r & 15)] = e[i];
    }
  }
}

// Two blocks per SM (registers capped at 128, a few bytes spilled), which
// measured faster than 162 registers and one block per SM.
// B_ROW: B is row-major (K, N) and 16-bit, so its tile keeps the natural
// [k][n] layout (16-byte stores) and feeds a row-major matrix_b; otherwise
// it takes the K-plane layout.  (int8 cannot: its 16-column fragments would
// sit at 16-byte offsets of a row.)
// ep: the epilogue policy of the store (g.ep, or a generated functor).
template <typename T, bool B_ROW, typename Ep>
__device__ __forceinline__ void mxu_tc_tile(const Gemm& g, const int64_t z0, const Ep& ep) {
  using Tr = TcTraits<T>;
  using Acc = typename Tr::Acc;
  using Raw = typename Tr::Raw;
  constexpr int LDP = Tr::LDP, KP = TBK / 16;
  constexpr int CHA = TBM * TBK / Tr::VEC / TTHREADS, CHB = TBN * TBK / Tr::VEC / TTHREADS;
  __shared__ __align__(128) Raw As[KP * TBM * LDP];
  static_assert(TBK * ROW_LD <= KP * TBN * LDP, "natural B tile must fit");
  __shared__ __align__(128) Raw Bs[KP * TBN * LDP];
  __shared__ __align__(128) Acc Cs[TWARPS][16 * 16];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;  // each warp: 64 x 32 of C
  const int m0 = blockIdx.y * TBM, n0 = blockIdx.x * TBN;
  const int M = g.M, N = g.N, K = g.K;
  const int64_t lda = g.lda, ldb = g.ldb;
  const bool a_kc = !g.ta, b_kc = g.tb, a_vec = g.a_vec, b_vec = g.b_vec;
  const int64_t z = z0 + blockIdx.z;
  const Raw* Ag = static_cast<const Raw*>(g.a) + z * g.sa;
  const Raw* Bg = static_cast<const Raw*>(g.b) + z * g.sb;

  wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], Acc(0));

  uint4 ra[CHA], rb[CHB];
  tc_load<Tr, TBM, false>(ra, Ag, lda, a_kc, m0, 0, M, K, a_vec);
  tc_load<Tr, TBN, B_ROW>(rb, Bg, ldb, b_kc, n0, 0, N, K, b_vec);
  for (int k0 = 0; k0 < K; k0 += TBK) {
    tc_store<Tr, TBM, false>(As, ra, a_kc);
    tc_store<Tr, TBN, B_ROW>(Bs, rb, b_kc);
    __syncthreads();
    if (k0 + TBK < K) {
      tc_load<Tr, TBM, false>(ra, Ag, lda, a_kc, m0, k0 + TBK, M, K, a_vec);
      tc_load<Tr, TBN, B_ROW>(rb, Bg, ldb, b_kc, n0, k0 + TBK, N, K, b_vec);
    }
#pragma unroll
    for (int kp = 0; kp < KP; ++kp) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[4];
      using BLayout = typename std::conditional<B_ROW, wmma::row_major, wmma::col_major>::type;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, BLayout> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], reinterpret_cast<const T*>(As) + (kp * TBM + wm * 64 + i * 16) * LDP, LDP);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if constexpr (B_ROW)
          wmma::load_matrix_sync(fb[j], reinterpret_cast<const T*>(Bs) + kp * 16 * ROW_LD + wn * 32 + j * 16, ROW_LD);
        else
          wmma::load_matrix_sync(fb[j], reinterpret_cast<const T*>(Bs) + (kp * TBN + wn * 32 + j * 16) * LDP, LDP);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int64_t c0 = z * M * N;
  Acc* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gm = m0 + wm * 64 + i * 16 + e / 16;
        const int gn = n0 + wn * 32 + j * 16 + e % 16;
        if (gm < M && gn < N)
          store_ep(g.c, c0 + static_cast<int64_t>(gm) * N + gn, cs[e], ep, gn, g.out_code);
      }
      __syncwarp();
    }
}

template <typename T, bool B_ROW>
__global__ void __launch_bounds__(TTHREADS, 2)
mxu_tc_kernel(const Gemm g, const int64_t z0) {
  mxu_tc_tile<T, B_ROW>(g, z0, g.ep);
}

// The tile with a generated epilogue functor ``Ep`` at its store (a Python
// callable, ops/codegen.py).
template <typename T, bool B_ROW, typename Ep>
__global__ void __launch_bounds__(TTHREADS, 2)
mxu_tc_ep_kernel(const Gemm g, const int64_t z0, const __grid_constant__ Ep ep) {
  mxu_tc_tile<T, B_ROW>(g, z0, ep);
}

// Launch for input type T; both B layouts for 16-bit types.
template <typename T>
int launch_tc(const Gemm& g, int64_t batch, cudaStream_t stream) {
  const bool b_row = sizeof(T) == 2 && !g.tb;
  return for_batch_chunks(batch, [&](int64_t z0, unsigned nz) {
    const dim3 grid((g.N + TBN - 1) / TBN, (g.M + TBM - 1) / TBM, nz);
    if (b_row)
      mxu_tc_kernel<T, sizeof(T) == 2><<<grid, TTHREADS, 0, stream>>>(g, z0);
    else
      mxu_tc_kernel<T, false><<<grid, TTHREADS, 0, stream>>>(g, z0);
  });
}

// Launch of the one B layout a generated epilogue's library holds
// (B_ROW: a row-major 16-bit B, as launch_tc chooses it); -1 for another.
template <typename T, bool B_ROW, typename Ep>
int launch_tc_ep(const Gemm& g, int64_t batch, cudaStream_t stream, const Ep& ep) {
  if ((sizeof(T) == 2 && !g.tb) != B_ROW) return kUnsupported;
  return for_batch_chunks(batch, [&](int64_t z0, unsigned nz) {
    const dim3 grid((g.N + TBN - 1) / TBN, (g.M + TBM - 1) / TBM, nz);
    mxu_tc_ep_kernel<T, B_ROW, Ep><<<grid, TTHREADS, 0, stream>>>(g, z0, ep);
  });
}

}  // namespace gemm_hls
