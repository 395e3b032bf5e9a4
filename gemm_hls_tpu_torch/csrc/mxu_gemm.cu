// Kernels B1 and B2: dense plus_times GEMM on the tensor cores,
// C[z] (M, N) = epilogue(op(A[z]) . op(B[z])) for every batch entry z.
//
// Replaces two TPU kernels of gemm_hls_tpu/ops/pallas_mxu.py with one
// kernel family:
//   * _kernel (entry mxu_matmul, B1): the 2-D GEMM with its optional fused
//     per-column epilogue at the store (pallas_mxu.py:103-106); here
//     batch = 1.  The 2-D calls a TMA map can describe run on the Hopper
//     tile engine instead (csrc/mxu_wgmma.cuh); this kernel keeps the rest.
//   * _batched_kernel (entry mxu_matmul_batched, B2), plain and epilogue
//     variants: (B, M, K) x (B, K, N) with whole examples per grid step.
//     Here the batch is a grid axis (blockIdx.z, chunked past gridDim.z's
//     65535) and each operand carries a batch stride, 0 for a 2-D operand
//     broadcast over the batch, so no example is copied.  The TPU kernel
//     batched examples to amortise a per-grid-step latch; Hopper has none,
//     so one 128x128 C tile of one example per block is the whole design.
//     The batched calls a TMA map can describe run on the tile engine too
//     (csrc/mxu_wgmma.cuh, its batch as the engine's steps).  The row-wise
//     (softmax) epilogue variant, which needs whole rows in a block, is
//     csrc/row_softmax.cu.
// Same communication-avoiding schedule as the TPU kernels: one C tile stays
// in fast memory (here: registers) while K streams through.  On Hopper each
// 256-thread block owns one 128x128 C tile and loops over K itself; blocks
// carry nothing between them, so the TPU kernel's sequential K grid axis
// and its acc_ref scratch become this loop.
//
// Routes by input dtype (ops/mxu.py::mxu_route picks this kernel or the
// engine by shape):
//   bf16, fp16 -> tensor cores (WMMA 16x16x16), fp32 accumulator;
//   int8       -> tensor cores (WMMA 16x16x16), int32 accumulator;
//   fp32, int32 -> CUDA cores, IEEE fp32 FMA / wrapping int32
//                  (csrc/simt_gemm.cuh with the plus_times functor); this
//                  meets the reference's "high"/"highest" precision;
//   int16, uint8, uint16, uint32 -> the same CUDA-core tile on an int32
//                  accumulator (csrc/mxu_simt_int.cu);
//   float64     -> csrc/dmma_gemm.cu (the FP64 tensor cores), its own entry.
// The tensor-core tile here runs the calls, 2-D (B1) and batched (B2), that
// the engine does not take: int8 with an operand that is not K-major (int8
// wgmma reads nothing else), and any operand whose base, row pitch or batch
// stride is not a whole 16-byte unit.
// The epilogue (common.cuh) sees the fp32 accumulator before the output
// cast; an int32 accumulator is widened to fp32 for it.
//
// Layouts: A is (M, K) or, with ta, (K, M); B is (K, N) or, with tb,
// (N, K).  Each operand is read along its own contiguous axis, in 16-byte
// vectors where the row pitch, batch stride and base allow it, and written
// into shared memory as 16-deep K planes: element (o, k) of an operand tile
// sits at ((k / 16) * 128 + o) * LDP + k % 16.  A plane is a row-major
// matrix_a / column-major matrix_b for WMMA whatever the global layout, so
// no transpose is ever materialised, and every fragment pointer is 32-byte
// aligned (WMMA requires it; a flat int8 tile would put odd 16-column
// fragments at 16-byte offsets).  One exception, the main path's: a
// row-major 16-bit B keeps its natural [k][n] tile (see B_ROW).
//
// Ragged edges: the K tail of BOTH operands is zero-filled in shared memory,
// never loaded (0 * NaN garbage must not reach the sum; see
// pallas_mxu.py::_mask_k_tail); rows past M/N are zero-filled too and the
// store masks them.
//
// What bounds it on an H100: the tensor-core rate (bf16 8192^3: 1.1e12 FLOP
// at 989e12 FLOP/s, 1.11 ms), which WMMA cannot approach: it issues
// mma.sync, a quarter of wgmma's rate, from one shared buffer with two
// barriers per 32-deep K step and the next tile prefetched through
// registers, and stages C through shared memory one 16x16 fragment at a
// time.  Measured (H100 80GB HBM3, 700 W, chip_smoke.py): 6.01 ms at bf16
// 8192^3 while that shape ran here (the engine now takes it in 1.50 ms);
// B2 at 64 x 512^3 0.152 ms against torch.bmm's 0.042 while it ran here
// (the engine's time: PERF.md section 6).
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
template <typename T, bool B_ROW>
__global__ void __launch_bounds__(TTHREADS, 2)
mxu_tc_kernel(const Gemm g, const int64_t z0) {
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
          store_ep(g.c, c0 + static_cast<int64_t>(gm) * N + gn, cs[e], g.ep, gn, g.out_code);
      }
      __syncwarp();
    }
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

// int16 and the unsigned ints on the CUDA cores (csrc/mxu_simt_int.cu).
int launch_mxu_simt_int(int in_code, const Gemm& g, int64_t batch, cudaStream_t s);

}  // namespace gemm_hls

using namespace gemm_hls;

// C (batch, M, N) row-major, written in ``out_code``'s dtype.  lda / ldb:
// the operands' row pitch; sa / sb: their batch stride (0 broadcasts a 2-D
// operand).  a_vec / b_vec: the operand's base is 16-byte aligned and its
// row pitch and batch stride whole 16-byte vectors (the tensor-core route
// then loads 16 bytes at a time).  ep: an EpKind (common.cuh) reading the
// (N,) operands e0 / e1 of dtype ep_code.  Returns 0, a CUDA error code
// from a launch, or -1 for an input dtype or epilogue not built.
extern "C" int mxu_gemm(const void* a, const void* b, void* c, int64_t batch, int M, int N, int K,
                        int64_t lda, int64_t ldb, int64_t sa, int64_t sb, int ta, int tb, int a_vec,
                        int b_vec, int in_code, int out_code, int ep, const void* e0,
                        const void* e1, int ep_code, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ep < 0 || ep >= kEpKinds) return kUnsupported;
  const Gemm g{a, b, c, M, N, K, lda, ldb, sa, sb, ta, tb, a_vec, b_vec, out_code,
               EpArgs{e0, e1, ep_code, ep}};
  switch (in_code) {
    case kBF16: return launch_tc<__nv_bfloat16>(g, batch, s);
    case kF16: return launch_tc<__half>(g, batch, s);
    case kI8: return launch_tc<signed char>(g, batch, s);
    case kF32: return launch_simt<float, float, PlusTimes<float>, true>(g, batch, s);
    case kI32: return launch_simt<int, int, PlusTimes<int>, true>(g, batch, s);
    case kI16:
    case kU8:
    case kU16:
    case kU32: return launch_mxu_simt_int(in_code, g, batch, s);
    default: return kUnsupported;
  }
}
