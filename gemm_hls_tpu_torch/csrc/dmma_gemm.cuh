// Kernels B1 and B2 for float64 on the FP64 tensor cores: the tile's
// templates in a header so a generated translation unit
// (gemm_hls_tpu_torch/ops/codegen.py: a Python callable's epilogue compiled
// at first use) instantiates the one layout its call takes with its own
// epilogue functor.  The design and the bounds: csrc/dmma_gemm.cu, whose
// entry point instantiates the built-in tiles.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace gemm_hls {

constexpr int DBM = 128, DBN = 128, DBK = 16, DTHREADS = 256, DSTAGES = 3;
// Row pitches (doubles) of the two shared-memory layouts, and one operand's
// slot in a stage (the larger of the two layouts).
constexpr int DP_KC = DBK + 4, DP_OC = DBM + 4;
constexpr int DSLOT = DBM * DP_KC > DBK * DP_OC ? DBM * DP_KC : DBK * DP_OC;
constexpr int kDmmaSmem = DSTAGES * 2 * DSLOT * 8;
static_assert(DBM == DBN, "both operands share one slot size");

__device__ __forceinline__ unsigned dm_smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// cp.async of 16 (or 8) bytes, zero-filling past ``bytes`` (0: nothing read).
__device__ __forceinline__ void dm_cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dm_smem(dst)), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void dm_cp8(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dm_smem(dst)), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void dm_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void dm_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a . b for one m16n8k4 f64 product: a = A[g][t], A[g + 8][t]; b =
// B[t][g]; d = the C entries (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8,
// 2t + 1) of the 16 x 8 tile.
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[2], double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

// Shared-memory index of operand element (o, k) in its layout.
template <bool KC>
__device__ __forceinline__ int dm_at(int o, int k) {
  return KC ? o * DP_KC + k : k * DP_OC + o;
}

// One operand K-slice (DBM rows "o" by DBK) into a stage slot.  KC: the
// operand's contiguous axis is K (A without ta, B with tb).  g points at
// the batch entry; O is the operand's M or N.
template <bool KC>
__device__ __forceinline__ void dm_load(double* s, const double* __restrict__ g, int64_t ld,
                                        int o0, int k0, int O, int K, bool vec) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < DBM * DBK / 2 / DTHREADS; ++i) {
      const int c = threadIdx.x + i * DTHREADS;
      // (row, first column) of the chunk in the operand's orientation.
      const int r = KC ? c / (DBK / 2) : c / (DBM / 2);
      const int col = KC ? (c % (DBK / 2)) * 2 : (c % (DBM / 2)) * 2;
      const int o = KC ? r : col, k = KC ? col : r;
      const int go = o0 + o, gk = k0 + k;
      int n = 0;
      if (KC && go < O) n = min(2, K - gk);
      if (!KC && gk < K) n = min(2, O - go);
      n = max(n, 0);
      const double* src = n ? g + (KC ? static_cast<int64_t>(go) * ld + gk
                                      : static_cast<int64_t>(gk) * ld + go)
                            : g;
      dm_cp16(s + dm_at<KC>(o, k), src, 8 * n);
    }
  } else {
#pragma unroll
    for (int i = 0; i < DBM * DBK / DTHREADS; ++i) {
      const int e = threadIdx.x + i * DTHREADS;
      const int o = KC ? e / DBK : e % DBM, k = KC ? e % DBK : e / DBM;
      const int go = o0 + o, gk = k0 + k;
      const bool in = go < O && gk < K;
      const double* src = in ? g + (KC ? static_cast<int64_t>(go) * ld + gk
                                       : static_cast<int64_t>(gk) * ld + go)
                             : g;
      dm_cp8(s + dm_at<KC>(o, k), src, in ? 8 : 0);
    }
  }
}

// C[idx] = epilogue(v) in the output type, out of line: the tile's 64
// unrolled stores each make one call, not a copy of the switches.  The
// built-in epilogues (g.ep) in double, or a generated functor ``ep``
// (ops/codegen.py).
static __device__ __noinline__ void dm_store(const Gemm& g, int64_t idx, double v, int gn) {
  store_any(g.c, idx, epilogue(v, g.ep, gn), g.out_code);
}
template <typename Ep>
static __device__ __noinline__ void dm_store_ep(const Gemm& g, const Ep& ep, int64_t idx, double v,
                                                int gn) {
  store_any(g.c, idx, ep(v, gn), g.out_code);
}

// ep: the epilogue policy of the store (g.ep, or a generated functor).
template <bool A_KC, bool B_KC, typename Ep>
__device__ __forceinline__ void dmma_tile(const Gemm& g, const int64_t z0, const Ep& ep) {
  extern __shared__ __align__(16) double dsm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;  // each warp: 64 x 32 of C
  const int gq = lane / 4, tq = lane % 4;
  const int m0 = blockIdx.y * DBM, n0 = blockIdx.x * DBN;
  const int M = g.M, N = g.N, K = g.K;
  const int64_t z = z0 + blockIdx.z;
  const double* A = static_cast<const double*>(g.a) + z * g.sa;
  const double* B = static_cast<const double*>(g.b) + z * g.sb;
  const bool a_vec = g.a_vec, b_vec = g.b_vec;

  double acc[4][4][4];  // [16-row block][8-column block][fragment entry]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;

  const int kt_n = (K + DBK - 1) / DBK;
  auto load = [&](int kt) {
    double* st = dsm + (kt % DSTAGES) * 2 * DSLOT;
    dm_load<A_KC>(st, A, g.lda, m0, kt * DBK, M, K, a_vec);
    dm_load<B_KC>(st + DSLOT, B, g.ldb, n0, kt * DBK, N, K, b_vec);
  };
#pragma unroll
  for (int s = 0; s < DSTAGES - 1; ++s) {
    if (s < kt_n) load(s);
    dm_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    dm_wait<DSTAGES - 2>();  // slice kt has landed
    __syncthreads();         // and every warp is done with slice kt - 1's stage
    if (kt + DSTAGES - 1 < kt_n) load(kt + DSTAGES - 1);
    dm_commit();
    const double* As = dsm + (kt % DSTAGES) * 2 * DSLOT;
    const double* Bs = As + DSLOT;
#pragma unroll
    for (int kk = 0; kk < DBK; kk += 4) {
      double fa[4][2], fb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          fa[i][h] = As[dm_at<A_KC>(wm * 64 + i * 16 + h * 8 + gq, kk + tq)];
#pragma unroll
      for (int j = 0; j < 4; ++j) fb[j] = Bs[dm_at<B_KC>(wn * 32 + j * 8 + gq, kk + tq)];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dmma(acc[i][j], fa[i], fb[j]);
    }
  }
  dm_wait<0>();

  const int64_t c0 = z * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + wm * 64 + i * 16 + h * 8 + gq;
      if (gm >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gn = n0 + wn * 32 + j * 8 + 2 * tq + e;
          if (gn >= N) continue;
          const int64_t idx = c0 + static_cast<int64_t>(gm) * N + gn;
          if (ep_none(ep) && g.out_code == kF64)
            static_cast<double*>(g.c)[idx] = acc[i][j][2 * h + e];
          else if constexpr (std::is_same<Ep, EpArgs>::value)
            dm_store(g, idx, acc[i][j][2 * h + e], gn);
          else
            dm_store_ep(g, ep, idx, acc[i][j][2 * h + e], gn);
        }
      }
    }
  }
}

template <bool A_KC, bool B_KC>
__global__ void __launch_bounds__(DTHREADS, 1) dmma_gemm_kernel(const Gemm g, const int64_t z0) {
  dmma_tile<A_KC, B_KC>(g, z0, g.ep);
}

// The tile with a generated epilogue functor ``Ep`` at its store (a Python
// callable, ops/codegen.py).
template <bool A_KC, bool B_KC, typename Ep>
__global__ void __launch_bounds__(DTHREADS, 1)
dmma_gemm_ep_kernel(const Gemm g, const int64_t z0, const __grid_constant__ Ep ep) {
  dmma_tile<A_KC, B_KC>(g, z0, ep);
}

template <typename Kernel, typename... Ep>
int launch_dmma_with(Kernel kernel, const Gemm& g, int64_t batch, cudaStream_t stream,
                     const Ep&... ep) {
  const int attr = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDmmaSmem));
  if (attr) return attr;
  return for_batch_chunks(batch, [&](int64_t z0, unsigned nz) {
    const dim3 grid((g.N + DBN - 1) / DBN, (g.M + DBM - 1) / DBM, nz);
    kernel<<<grid, DTHREADS, kDmmaSmem, stream>>>(g, z0, ep...);
  });
}

template <bool A_KC, bool B_KC>
int launch_dmma(const Gemm& g, int64_t batch, cudaStream_t stream) {
  return launch_dmma_with(dmma_gemm_kernel<A_KC, B_KC>, g, batch, stream);
}

// A generated epilogue's library holds the one layout of its call.
template <bool A_KC, bool B_KC, typename Ep>
int launch_dmma_ep(const Gemm& g, int64_t batch, cudaStream_t stream, const Ep& ep) {
  if (!g.ta != A_KC || static_cast<bool>(g.tb) != B_KC) return kUnsupported;
  return launch_dmma_with(dmma_gemm_ep_kernel<A_KC, B_KC, Ep>, g, batch, stream, ep);
}

}  // namespace gemm_hls
