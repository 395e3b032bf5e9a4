// CUDA-core tiled GEMM over a (map, reduce) functor: the tile shared by
// kernel B3 (csrc/semiring_gemm.cu and its per-dtype instantiations
// semiring_*.cu, every semiring) and by kernels B1 / B2's CUDA-core route
// (plus_times without tensor cores: fp32 / int32 in csrc/mxu_gemm.cu, int16
// and the unsigned ints in csrc/mxu_simt_int.cu).
//
// Accumulators: fp32 for fp32 / bf16 / fp16 inputs, float64 for float64,
// int32 for every integer type (each element widened, or wrapped, at the
// load as the reference's astype(int32) does: common.cuh::to_acc); every
// element is loaded alone, so 1- and 2-byte operands need no 16-byte
// alignment and any K or N.
//
// One 256-thread block owns a 128x128 C tile of one batch entry
// (blockIdx.z) and walks all of K in steps of 16 (the TPU kernel's
// sequential K grid axis becomes this loop: Hopper blocks carry nothing
// from one to the next).  Each thread keeps an 8x8 accumulator in
// registers, initialised to the reduce identity.  A and B K-slices are
// staged K-major in shared memory, converted to the accumulator type on
// the way in; the next slice is prefetched into registers while the
// current one is reduced.  The epilogue (common.cuh) transforms each
// accumulator at the store.
//
// Masking instead of padding: operands are read whole and unpadded.  Rows
// and columns past M/N are loaded as 0 and never stored; the K tail is
// excluded by the loop bound of the last step, which is exactly "masked to
// the reduce identity" and keeps INT_MAX + x from ever being formed.
//
// Operand layouts are read through their leading dimension and batch
// stride (common.cuh::Gemm).  Each load walks the operand's contiguous axis
// so a warp's reads coalesce.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace gemm_hls {

constexpr int SBM = 128, SBN = 128, SBK = 16, STHREADS = 256;
constexpr int SLOADS = SBM * SBK / STHREADS;  // elements per thread per operand

// ---- arithmetic of the functors ------------------------------------------
// int32 arithmetic wraps modulo 2^32, as in the reference (done unsigned,
// where wrapping is defined).
__device__ __forceinline__ float dadd(float a, float b) { return a + b; }
__device__ __forceinline__ int dadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ float dsub(float a, float b) { return a - b; }
__device__ __forceinline__ int dsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
__device__ __forceinline__ float dmul(float a, float b) { return a * b; }
__device__ __forceinline__ int dmul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}
__device__ __forceinline__ float dfma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ int dfma(int a, int b, int c) { return dadd(dmul(a, b), c); }
__device__ __forceinline__ double dadd(double a, double b) { return a + b; }
__device__ __forceinline__ double dsub(double a, double b) { return a - b; }
__device__ __forceinline__ double dmul(double a, double b) { return a * b; }
__device__ __forceinline__ double dfma(double a, double b, double c) { return fma(a, b, c); }

template <typename Acc> struct Lim;
template <> struct Lim<float> {
  static __device__ __forceinline__ float hi() { return INFINITY; }
  static __device__ __forceinline__ float lo() { return -INFINITY; }
};
template <> struct Lim<double> {
  static __device__ __forceinline__ double hi() { return INFINITY; }
  static __device__ __forceinline__ double lo() { return -INFINITY; }
};
template <> struct Lim<int> {
  static __device__ __forceinline__ int hi() { return INT_MAX; }
  static __device__ __forceinline__ int lo() { return INT_MIN; }
};

// A functor supplies identity() and step(acc, a, b) = reduce(acc, map(a, b)).
template <typename Acc> struct PlusTimes {
  static __device__ __forceinline__ Acc identity() { return Acc(0); }
  static __device__ __forceinline__ Acc step(Acc acc, Acc a, Acc b) { return dfma(a, b, acc); }
};

// The functor's form for a float64 K slice whose operands are all finite
// (its ``Num``, where it has one: the min / max semirings, semiring_ops.cuh),
// else the functor itself.
template <typename Op, typename = void> struct NumOf { using type = Op; };
template <typename Op> struct NumOf<Op, std::void_t<typename Op::Num>> {
  using type = typename Op::Num;
};

__device__ __forceinline__ bool all_finite(const double (&r)[SLOADS]) {
  bool ok = true;
#pragma unroll
  for (int i = 0; i < SLOADS; ++i) ok = ok && isfinite(r[i]);
  return ok;
}

// ---- staging -------------------------------------------------------------
// One operand K-slice: R=128 rows of the non-contracted axis ("o") by SBK.
// k_contig: the operand's contiguous axis is K (A without ta, B with tb).
template <typename TIn, typename Acc>
__device__ __forceinline__ void simt_load(Acc (&r)[SLOADS], const TIn* __restrict__ g,
                                          int64_t ld, bool k_contig, int o0, int k0,
                                          int O, int K) {
#pragma unroll
  for (int i = 0; i < SLOADS; ++i) {
    const int idx = threadIdx.x + i * STHREADS;
    const int kk = k_contig ? idx % SBK : idx / SBM;
    const int oo = k_contig ? idx / SBK : idx % SBM;
    const int go = o0 + oo, gk = k0 + kk;
    r[i] = Acc(0);
    if (go < O && gk < K) {
      const int64_t off = k_contig ? static_cast<int64_t>(go) * ld + gk
                                   : static_cast<int64_t>(gk) * ld + go;
      r[i] = to_acc(g[off], Acc(0));
    }
  }
}

template <typename Acc>
__device__ __forceinline__ void simt_store(Acc (*s)[SBM + 1], const Acc (&r)[SLOADS],
                                           bool k_contig) {
#pragma unroll
  for (int i = 0; i < SLOADS; ++i) {
    const int idx = threadIdx.x + i * STHREADS;
    const int kk = k_contig ? idx % SBK : idx / SBM;
    const int oo = k_contig ? idx / SBK : idx % SBM;
    s[kk][oo] = r[i];
  }
}

template <typename Acc, typename Op>
__device__ __forceinline__ void simt_step(Acc (&acc)[8][8], Acc (*As)[SBM + 1],
                                          Acc (*Bs)[SBN + 1], int kk, int tx, int ty) {
  Acc a[8], b[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
  for (int j = 0; j < 8; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = Op::step(acc[i][j], a[i], b[j]);
}

// The epilogue policy of the store: g.ep (the built-in epilogues), or a
// copy of the one generated functor a generated library passes
// (ops/codegen.py), stored through common.cuh::store_gen_ep.
__device__ __forceinline__ const EpArgs& ep_policy(const EpArgs& e) { return e; }
template <typename Ep>
__device__ __forceinline__ Ep ep_policy(const EpArgs&, const Ep& gen) { return gen; }

// kEpilogue: the store applies the epilogue policy (the plus_times routes
// of B1 / B2); the semiring functors of B3 take none, and skip its code.
// ``ep`` is empty for the library's kernels, one generated functor for a
// generated library's: the body stays in the kernel, reading g from its
// parameters (a __device__ tile taking g by reference cost the fp32
// instantiation 16 registers).
template <typename TIn, typename Acc, typename Op, bool kEpilogue, typename... Ep>
__global__ void __launch_bounds__(STHREADS) simt_gemm_kernel(const Gemm g, const int64_t z0,
                                                             const Ep... ep) {
  __shared__ Acc As[SBK][SBM + 1];
  __shared__ Acc Bs[SBK][SBN + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * SBM, n0 = blockIdx.x * SBN;
  const int M = g.M, N = g.N, K = g.K;
  const bool a_kc = !g.ta, b_kc = g.tb;
  const int64_t z = z0 + blockIdx.z;
  const TIn* A = static_cast<const TIn*>(g.a) + z * g.sa;
  const TIn* B = static_cast<const TIn*>(g.b) + z * g.sb;

  Acc acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = Op::identity();

  // float64 min / max semirings: a whole K slice with no NaN or infinity in
  // the block's operands runs the functor's Num form (one compare and
  // select a term, not three); the barrier after the staging tells every
  // thread whether any thread loaded one.
  constexpr bool kNumPath = std::is_same<Acc, double>::value &&
                            !std::is_same<typename NumOf<Op>::type, Op>::value;
  using NumOp = std::conditional_t<kNumPath, typename NumOf<Op>::type, Op>;
  Acc ra[SLOADS], rb[SLOADS];
  simt_load(ra, A, g.lda, a_kc, m0, 0, M, K);
  simt_load(rb, B, g.ldb, b_kc, n0, 0, N, K);
  for (int k0 = 0; k0 < K; k0 += SBK) {
    simt_store(As, ra, a_kc);
    simt_store(Bs, rb, b_kc);
    bool num = false;
    if constexpr (kNumPath)
      num = !__syncthreads_or(!(all_finite(ra) && all_finite(rb)));
    else
      __syncthreads();
    if (k0 + SBK < K) {
      simt_load(ra, A, g.lda, a_kc, m0, k0 + SBK, M, K);
      simt_load(rb, B, g.ldb, b_kc, n0, k0 + SBK, N, K);
    }
    const int kl = min(SBK, K - k0);
    if (num && kl == SBK) {
#pragma unroll
      for (int kk = 0; kk < SBK; ++kk) simt_step<Acc, NumOp>(acc, As, Bs, kk, tx, ty);
    } else if (kl == SBK && !kNumPath) {
#pragma unroll
      for (int kk = 0; kk < SBK; ++kk) simt_step<Acc, Op>(acc, As, Bs, kk, tx, ty);
    } else {  // the K tail, and a float64 slice with a NaN or an infinity
      for (int kk = 0; kk < kl; ++kk) simt_step<Acc, Op>(acc, As, Bs, kk, tx, ty);
    }
    __syncthreads();
  }

  const int64_t c0 = z * M * N;
  decltype(auto) ep_of = ep_policy(g.ep, ep...);
  if (g.out_code <= kI32) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int gm = m0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int gn = n0 + tx + 16 * j;
        if (gm < M && gn < N) {
          const int64_t idx = c0 + static_cast<int64_t>(gm) * N + gn;
          if constexpr (kEpilogue && sizeof...(Ep) > 0)
            store_gen_ep(g.c, idx, acc[i][j], ep_of, gn, g.out_code);
          else if constexpr (kEpilogue)
            store_ep(g.c, idx, acc[i][j], ep_of, gn, g.out_code);
          else
            store_out(g.c, idx, acc[i][j], g.out_code);
        }
      }
    }
  } else {  // the wide output types: one out-of-line call an element
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int gm = m0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int gn = n0 + tx + 16 * j;
        if (gm < M && gn < N)
          store_wide_ep<kEpilogue>(g.c, c0 + static_cast<int64_t>(gm) * N + gn, acc[i][j], ep_of,
                                   gn, g.out_code);
      }
    }
  }
}

template <typename TIn, typename Acc, typename Op, bool kEpilogue = false>
int launch_simt(const Gemm& g, int64_t batch, cudaStream_t stream) {
  return for_batch_chunks(batch, [&](int64_t z0, unsigned nz) {
    const dim3 grid((g.N + SBN - 1) / SBN, (g.M + SBM - 1) / SBM, nz);
    simt_gemm_kernel<TIn, Acc, Op, kEpilogue><<<grid, STHREADS, 0, stream>>>(g, z0);
  });
}

// The tile with a generated epilogue functor ``Ep`` at its store (B1 / B2's
// CUDA-core route for a Python callable, ops/codegen.py).
template <typename TIn, typename Acc, typename Op, typename Ep>
int launch_simt_ep(const Gemm& g, int64_t batch, cudaStream_t stream, const Ep& ep) {
  return for_batch_chunks(batch, [&](int64_t z0, unsigned nz) {
    const dim3 grid((g.N + SBN - 1) / SBN, (g.M + SBM - 1) / SBM, nz);
    simt_gemm_kernel<TIn, Acc, Op, true, Ep><<<grid, STHREADS, 0, stream>>>(g, z0, ep);
  });
}

}  // namespace gemm_hls
