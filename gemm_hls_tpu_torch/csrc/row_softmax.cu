// Kernel B2, row-softmax variant: P[z] = softmax_rows(op(A[z]) . op(B[z])),
// softmax over the last axis (N), for every batch entry z.
//
// Replaces the epilogue path of gemm_hls_tpu/ops/pallas_mxu.py::
// _batched_kernel (pallas_mxu.py:176-188, launched at :328) with the row
// softmax of gemm_hls_tpu/ops/attention.py::_softmax_rows as its epilogue:
// the fused attention scores.  It takes what the tile engine's route
// (csrc/row_softmax_wgmma.cu, ops/mxu.py::row_softmax_route) does
// not: fp32 inputs, operands whose bases, row pitches or batch strides are
// not whole 16-byte units, K past 256, and rows of P whose bytes are not
// whole 16-byte units.  A row softmax needs whole rows, so N is not
// gridded: one 256-thread block owns a strip of RBM = 16 rows of one batch
// entry and every column.  It walks N in 128-column tiles, each a
// 16 x 128 x K product (WMMA for bf16 / fp16, fp32 FMA on CUDA cores for
// fp32), and keeps the fp32 scores of the whole strip in shared memory.
// Then each warp takes two rows: max, exp(s - max) written back in place,
// sum, and the normalised probabilities cast to the output dtype at the
// store.  The scores never reach device memory.
//
// Bound: the strip takes RBM * (roundup(N, 128) + 4) * 4 bytes of the
// block's 227 KB of shared memory beside RS_STAGE_BYTES of operand
// staging, so N <= 3200.  gemm_hls_tpu_torch/config.py states the same
// bound (ROW_SOFTMAX_MAX_N); beyond it the caller takes the unfused branch
// (fp32 scores from B2's plain variant, then a softmax), as the JAX package
// does past its VMEM rule (gemm_hls_tpu/ops/attention.py:88-90).
//
// What bounds it at the attention shape (32 x 1024^2 x 128, bf16): not the
// tensor cores (8.6 GFLOP) nor the 64 MB written, but latency: one block
// per 16 rows re-stages its A strip for every N tile, two barriers per
// 32-deep K step, no prefetch (0.522 ms on an H100 80GB HBM3 at 700 W
// against a 0.025 ms bound; the engine route takes that shape now).
//
// Ragged edges as in csrc/mxu_gemm.cu: the K tail and rows / columns past
// M / N are zero-filled in shared memory, never loaded; the softmax reads
// only columns < N and stores only rows < M.  exp is the accurate expf.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace gemm_hls {

using namespace nvcuda;

// Must match ROW_SOFTMAX_* in gemm_hls_tpu_torch/config.py.
constexpr int RBM = 16, RBN = 128, RBK = 32, RTHREADS = 256, RWARPS = 8;
constexpr int RS_STAGE_BYTES = 19456;  // max(16-bit: 1536 + 12288, fp32: 2560 + 16896)
constexpr size_t RS_SMEM_LIMIT = 232448;
constexpr int RS_LDP = 24;  // 16-bit K-plane row pitch (TcTraits::LDP)

// Row pitch, in floats, of the score strip: whole 128-column tiles + 4.
__host__ __device__ inline int rs_pitch(int N) { return (N + RBN - 1) / RBN * RBN + 4; }
inline size_t rs_smem_bytes(int N) {
  return size_t(RBM) * rs_pitch(N) * sizeof(float) + RS_STAGE_BYTES;
}

template <typename T> struct RsTraits;
template <> struct RsTraits<__nv_bfloat16> { using Raw = uint16_t; static constexpr int VEC = 8; };
template <> struct RsTraits<__half> { using Raw = uint16_t; static constexpr int VEC = 8; };
template <> struct RsTraits<float> { using Raw = float; static constexpr int VEC = 4; };

// Shared-memory index of element (o, k) of an R-row operand K-slice:
// 16-bit types in 16-deep K planes (WMMA fragments, as csrc/mxu_gemm.cu),
// fp32 K-major with a padded row for the CUDA-core product.
template <typename T, int R>
__device__ __forceinline__ int rs_index(int o, int k) {
  if constexpr (std::is_same<T, float>::value) {
    return k * (R + 4) + o;
  } else {
    return ((k >> 4) * R + o) * RS_LDP + (k & 15);
  }
}

// Stage one operand K-slice (R rows "o" by RBK) from global to shared
// memory, read in VEC-element chunks along the operand's contiguous axis.
template <typename T, int R>
__device__ __forceinline__ void rs_stage(typename RsTraits<T>::Raw* s,
                                         const typename RsTraits<T>::Raw* __restrict__ g,
                                         int64_t ld, bool k_contig, int o0, int k0, int O, int K,
                                         bool vec_ok) {
  using Raw = typename RsTraits<T>::Raw;
  constexpr int VEC = RsTraits<T>::VEC;
  const int cpr = (k_contig ? RBK : R) / VEC;  // chunks per global row
  for (int ch = threadIdx.x; ch < R * RBK / VEC; ch += RTHREADS) {
    const int r = ch / cpr, col = (ch % cpr) * VEC;
    const int64_t gr = (k_contig ? o0 : k0) + r, gc = (k_contig ? k0 : o0) + col;
    const int64_t rlim = k_contig ? O : K, clim = k_contig ? K : O;
    uint4 v;
    Raw* e = reinterpret_cast<Raw*>(&v);
    if (vec_ok && gr < rlim && gc + VEC <= clim) {
      v = __ldg(reinterpret_cast<const uint4*>(g + gr * ld + gc));
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) e[i] = (gr < rlim && gc + i < clim) ? g[gr * ld + gc + i] : Raw(0);
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      s[k_contig ? rs_index<T, R>(r, col + i) : rs_index<T, R>(col + i, r)] = e[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(RTHREADS) row_softmax_kernel(const Gemm g, const int64_t z0) {
  using Raw = typename RsTraits<T>::Raw;
  constexpr bool kF32Route = std::is_same<T, float>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const int M = g.M, N = g.N, K = g.K, ld = rs_pitch(N);
  float* strip = reinterpret_cast<float*>(smem);
  Raw* As = reinterpret_cast<Raw*>(strip + RBM * ld);
  Raw* Bs = As + (kF32Route ? RBK * (RBM + 4) : (RBK / 16) * RBM * RS_LDP);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * RBM;
  const bool a_kc = !g.ta, b_kc = g.tb;
  const int64_t z = z0 + blockIdx.z;
  const Raw* Ag = static_cast<const Raw*>(g.a) + z * g.sa;
  const Raw* Bg = static_cast<const Raw*>(g.b) + z * g.sb;

  for (int n0 = 0; n0 < N; n0 += RBN) {
    if constexpr (kF32Route) {
      // Thread (ty, tx): rows 2ty, 2ty + 1; columns tx + 32 j.
      const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;
      float acc[2][4] = {};
      for (int k0 = 0; k0 < K; k0 += RBK) {
        __syncthreads();
        rs_stage<T, RBM>(As, Ag, g.lda, a_kc, m0, k0, M, K, g.a_vec);
        rs_stage<T, RBN>(Bs, Bg, g.ldb, b_kc, n0, k0, N, K, g.b_vec);
        __syncthreads();
        const int kl = min(RBK, K - k0);
        for (int kk = 0; kk < kl; ++kk) {
          const float a0 = As[kk * (RBM + 4) + 2 * ty], a1 = As[kk * (RBM + 4) + 2 * ty + 1];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float b = Bs[kk * (RBN + 4) + tx + 32 * j];
            acc[0][j] = fmaf(a0, b, acc[0][j]);
            acc[1][j] = fmaf(a1, b, acc[1][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) strip[(2 * ty + i) * ld + n0 + tx + 32 * j] = acc[i][j];
    } else {
      // Warp w: the 16 x 16 fragment of columns n0 + 16 w.
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k0 = 0; k0 < K; k0 += RBK) {
        __syncthreads();
        rs_stage<T, RBM>(As, Ag, g.lda, a_kc, m0, k0, M, K, g.a_vec);
        rs_stage<T, RBN>(Bs, Bg, g.ldb, b_kc, n0, k0, N, K, g.b_vec);
        __syncthreads();
#pragma unroll
        for (int kp = 0; kp < RBK / 16; ++kp) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, reinterpret_cast<const T*>(As) + kp * RBM * RS_LDP, RS_LDP);
          wmma::load_matrix_sync(fb, reinterpret_cast<const T*>(Bs) + (kp * RBN + warp * 16) * RS_LDP,
                                 RS_LDP);
          wmma::mma_sync(acc, fa, fb, acc);
        }
      }
      wmma::store_matrix_sync(strip + n0 + warp * 16, acc, ld, wmma::mem_row_major);
    }
  }
  __syncthreads();

  const int64_t c0 = z * M * N;
  for (int r = warp; r < RBM && m0 + r < M; r += RWARPS) {
    float* row = strip + r * ld;
    float mx = -INFINITY;
    for (int c = lane; c < N; c += 32) mx = dmax(mx, row[c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = dmax(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int c = lane; c < N; c += 32) {
      const float e = expf(row[c] - mx);
      row[c] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const int64_t o = c0 + static_cast<int64_t>(m0 + r) * N;
    for (int c = lane; c < N; c += 32) store_out(g.c, o + c, row[c] / sum, g.out_code);
  }
}

template <typename T>
int launch_rs(const Gemm& g, int64_t batch, cudaStream_t stream) {
  const size_t smem = rs_smem_bytes(g.N);
  if (smem > RS_SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const int err = static_cast<int>(cudaFuncSetAttribute(
      row_softmax_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  if (err) return err;
  return for_batch_chunks(batch, [&](int64_t z0, unsigned nz) {
    const dim3 grid((g.M + RBM - 1) / RBM, 1, nz);
    row_softmax_kernel<T><<<grid, RTHREADS, smem, stream>>>(g, z0);
  });
}

}  // namespace gemm_hls

using namespace gemm_hls;

// P (batch, M, N) row-major in ``out_code``'s dtype; arguments as
// mxu_gemm's (csrc/mxu_gemm.cu) without the epilogue.  Returns 0, a CUDA
// error code (cudaErrorInvalidValue for N past the shared-memory bound),
// or -1 for an input dtype not built (int8 / int32: a softmax of integer
// scores is not a use).
extern "C" int mxu_gemm_row_softmax(const void* a, const void* b, void* c, int64_t batch, int M,
                                    int N, int K, int64_t lda, int64_t ldb, int64_t sa,
                                    int64_t sb, int ta, int tb, int a_vec, int b_vec, int in_code,
                                    int out_code, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Gemm g{a, b, c, M, N, K, lda, ldb, sa, sb, ta, tb, a_vec, b_vec, out_code,
               EpArgs{nullptr, nullptr, 0, kEpNone}};
  switch (in_code) {
    case kBF16: return launch_rs<__nv_bfloat16>(g, batch, s);
    case kF16: return launch_rs<__half>(g, batch, s);
    case kF32: return launch_rs<float>(g, batch, s);
    default: return kUnsupported;
  }
}
