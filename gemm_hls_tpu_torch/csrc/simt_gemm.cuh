// CUDA-core tiled GEMM over a (map, reduce) functor: the tile shared by
// kernel B3 (csrc/semiring_gemm.cu and its per-dtype instantiations
// semiring_*.cu, every semiring) and by kernels B1 / B2's CUDA-core route
// (plus_times without tensor cores: fp32 / int32 in csrc/mxu_gemm.cu, int16
// and the unsigned ints in csrc/mxu_simt_int.cu).
//
// Accumulators: fp32 for fp32 / bf16 / fp16 inputs, int32 for every
// integer type (each element widened, or wrapped, at the load as the
// reference's astype(int32) does: common.cuh::to_acc); every element is
// loaded alone, so 1- and 2-byte operands need no 16-byte alignment and any
// K or N.  float64 (B3 only) runs on a tile of its own below
// (simt_f64_kernel), which launch_simt picks for Acc = double.
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

  Acc ra[SLOADS], rb[SLOADS];
  simt_load(ra, A, g.lda, a_kc, m0, 0, M, K);
  simt_load(rb, B, g.ldb, b_kc, n0, 0, N, K);
  for (int k0 = 0; k0 < K; k0 += SBK) {
    simt_store(As, ra, a_kc);
    simt_store(Bs, rb, b_kc);
    __syncthreads();
    if (k0 + SBK < K) {
      simt_load(ra, A, g.lda, a_kc, m0, k0 + SBK, M, K);
      simt_load(rb, B, g.ldb, b_kc, n0, k0 + SBK, N, K);
    }
    const int kl = min(SBK, K - k0);
    if (kl == SBK) {
#pragma unroll
      for (int kk = 0; kk < SBK; ++kk) simt_step<Acc, Op>(acc, As, Bs, kk, tx, ty);
    } else {  // the K tail
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

// ---- the float64 tile (kernel B3) ---------------------------------------
// Every float64 semiring (the built-in functors and generated ones) runs on
// a tile of its own, launched by launch_simt for Acc = double.  The tile
// above kept the next K slice in registers beside 64 doubles of
// accumulator and 16 of fragments, and spilled (255 registers, 188 bytes,
// one block a SM).  Here:
//   * no register prefetch: each slice comes in by cp.async into a ring of
//     kF64Stages shared-memory stages, K-major ([k][o] rows of 128 + 2
//     doubles), 16-byte copies of two values where the operand's contiguous
//     axis is M or N and its base, row pitch and batch stride are whole
//     16-byte units (a_vec / b_vec), else one 8-byte copy a value (a
//     K-contiguous operand is transposed by its copies' destinations);
//   * each thread owns 8 x TN outputs, rows 32 i + 2 ty + {0, 1} and columns
//     32 j + 2 tx + {0, 1}, so a step's fragments are 16-byte reads;
//   * one barrier a slice: after its copies have landed, each thread reads
//     back what it staged and, for a functor with a Num form, ORs into the
//     slice's flags whether it saw a NaN, +inf, -inf or (a functor whose
//     map multiplies) an in-bounds zero; the functor's num_ok(flags) says
//     whether no mapped value of the slice can be NaN, and then the slice
//     runs the Num form (one compare and select a term, where NaN-keeping
//     min / max take three: sm_90 has no float64 min / max instruction).
//     The Num form keeps a NaN accumulator, and IEEE < / > order the
//     infinities, so the result is the same as the NaN-keeping form's.
// Each output's terms are reduced in K order, one at a time, as above:
// the same bits as the plain version's sequential reduction wherever that
// is exact (the min / max semirings).  TN = 8: a 128 x 128 tile, one block
// of 8 warps a SM (log_plus, whose terms call out of line, TN = 4).  The
// forms each slice ran are counted per translation unit (f64_forms: [0]
// Num, [1] the NaN-keeping form, full slices only), read by
// csrc/semiring_f64.cu's semiring_f64_forms.
constexpr int kF64BM = 128, kF64BK = 16, kF64Threads = 256, kF64Stages = 3;
constexpr int kF64TN = 8;
__host__ __device__ constexpr int f64_pitch(int width) { return width + 2; }
template <int TN>
constexpr int f64_smem() {
  return kF64Stages * kF64BK * (f64_pitch(kF64BM) + f64_pitch(16 * TN)) * 8;
}
// The thread tile's columns: the functor's kF64TN where it names one (a
// functor that calls out of line a term keeps fewer accumulators live
// around the calls), else kF64TN.
template <typename Op, typename = void> struct F64TileN {
  static constexpr int value = kF64TN;
};
template <typename Op> struct F64TileN<Op, std::void_t<decltype(Op::kF64TN)>> {
  static constexpr int value = Op::kF64TN;
};
// The unroll depth over a full slice's K steps of the form most slices run
// (a functor's Num form where it has one, else the functor): the functor's
// kF64Unroll where it names one, else the whole slice for a Num form and
// half of it for the others (plus_times spilled at 16).
template <typename Op, typename = void> struct F64Unroll {
  static constexpr int value = 0;
};
template <typename Op> struct F64Unroll<Op, std::void_t<decltype(Op::kF64Unroll)>> {
  static constexpr int value = Op::kF64Unroll;
};
static __device__ unsigned long long f64_forms[2];

// The flags a thread ORs for a slice's gate.
enum : unsigned { kSawNaN = 1, kSawPosInf = 2, kSawNegInf = 4, kSawZero = 8 };

// The functor's form for a slice whose gate holds (its ``Num``, where it
// has one: the min / max semirings, semiring_ops.cuh), else the functor.
template <typename Op, typename = void> struct NumOf { using type = Op; };
template <typename Op> struct NumOf<Op, std::void_t<typename Op::Num>> {
  using type = typename Op::Num;
};

__device__ __forceinline__ void f64_cp(double* dst, const double* src, int bytes, bool wide) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (wide)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

// One operand's K slice, R rows of its M or N ("o") by kF64BK, into
// s[k][o] (pitch P); k_contig: the operand's contiguous axis is K.  ``visit``
// is called with (the staged value's shared address, in bounds) for each
// value this thread copies, in the same order as the copies; with
// kCopy false nothing is copied (the read-back).
template <int R, bool kCopy, typename Visit>
__device__ __forceinline__ void f64_slice(double* s, const double* __restrict__ g, int64_t ld,
                                          bool k_contig, bool vec, int o0, int k0, int O, int K,
                                          Visit&& visit) {
  constexpr int P = f64_pitch(R);
  if (!k_contig && vec) {  // 16-byte copies of (o, o + 1)
#pragma unroll
    for (int i = 0; i < R * kF64BK / 2 / kF64Threads; ++i) {
      const int idx = threadIdx.x + i * kF64Threads;
      const int oo = 2 * (idx % (R / 2)), kk = idx / (R / 2);
      const int go = o0 + oo, gk = k0 + kk;
      const int n = gk < K ? max(0, min(2, O - go)) : 0;
      double* dst = s + kk * P + oo;
      if (kCopy) f64_cp(dst, n ? g + static_cast<int64_t>(gk) * ld + go : g, 8 * n, true);
      visit(dst, n > 0);
      visit(dst + 1, n > 1);
    }
  } else {
#pragma unroll
    for (int i = 0; i < R * kF64BK / kF64Threads; ++i) {
      const int idx = threadIdx.x + i * kF64Threads;
      const int kk = k_contig ? idx % kF64BK : idx / R;
      const int oo = k_contig ? idx / kF64BK : idx % R;
      const int go = o0 + oo, gk = k0 + kk;
      const bool in = go < O && gk < K;
      double* dst = s + kk * P + oo;
      if (kCopy) {
        const int64_t off = k_contig ? static_cast<int64_t>(go) * ld + gk
                                     : static_cast<int64_t>(gk) * ld + go;
        f64_cp(dst, in ? g + off : g, in ? 8 : 0, false);
      }
      visit(dst, in);
    }
  }
}

// acc = step(acc, A[:, kk], B[kk, :]) over the thread's 8 x TN outputs.
template <typename F, int TN, int PA, int PB>
__device__ __forceinline__ void f64_step(double (&acc)[8][TN], const double* As, const double* Bs,
                                         int kk, int tx, int ty) {
  double a[8], b[TN];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const double2 v = *reinterpret_cast<const double2*>(As + kk * PA + 32 * i + 2 * ty);
    a[2 * i] = v.x;
    a[2 * i + 1] = v.y;
  }
#pragma unroll
  for (int j = 0; j < TN / 2; ++j) {
    const double2 v = *reinterpret_cast<const double2*>(Bs + kk * PB + 32 * j + 2 * tx);
    b[2 * j] = v.x;
    b[2 * j + 1] = v.y;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = F::step(acc[i][j], a[i], b[j]);
}

template <typename Op>
__global__ void __launch_bounds__(kF64Threads, 1) simt_f64_kernel(const Gemm g, const int64_t z0) {
  constexpr int TN = F64TileN<Op>::value;
  constexpr int BN = 16 * TN, PA = f64_pitch(kF64BM), PB = f64_pitch(BN);
  constexpr int kStage = kF64BK * (PA + PB);
  using NumOp = typename NumOf<Op>::type;
  constexpr bool kGate = !std::is_same<NumOp, Op>::value;
  // The NaN-keeping form of a functor with a Num form is the rare slice's:
  // not unrolled, so its registers do not crowd the Num form's.
  constexpr int kUnroll = F64Unroll<Op>::value ? F64Unroll<Op>::value
                          : kGate                ? kF64BK
                                                 : kF64BK / 2;
  constexpr int kOpUnroll = kGate ? 1 : kUnroll;
  extern __shared__ __align__(16) double f64_smem_buf[];
  __shared__ unsigned saw[3];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kF64BM, n0 = blockIdx.x * BN;
  const int M = g.M, N = g.N, K = g.K;
  const bool a_kc = !g.ta, b_kc = g.tb;
  const int64_t z = z0 + blockIdx.z;
  const double* A = static_cast<const double*>(g.a) + z * g.sa;
  const double* B = static_cast<const double*>(g.b) + z * g.sb;
  const auto none = [](const double*, bool) {};
  auto load = [&](int kt) {
    double* st = f64_smem_buf + (kt % kF64Stages) * kStage;
    f64_slice<kF64BM, true>(st, A, g.lda, a_kc, g.a_vec, m0, kt * kF64BK, M, K, none);
    f64_slice<BN, true>(st + kF64BK * PA, B, g.ldb, b_kc, g.b_vec, n0, kt * kF64BK, N, K, none);
  };

  double acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Op::identity();
  if constexpr (kGate) {
    if (threadIdx.x < 3) saw[threadIdx.x] = 0;
    __syncthreads();
  }
  unsigned long long num_slices = 0, nan_slices = 0;  // full slices in each form

  const int kt_n = (K + kF64BK - 1) / kF64BK;
#pragma unroll
  for (int s = 0; s < kF64Stages - 1; ++s) {
    if (s < kt_n) load(s);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kF64Stages - 2));
    const double* As = f64_smem_buf + (kt % kF64Stages) * kStage;
    const double* Bs = As + kF64BK * PA;
    bool num = false;
    if constexpr (kGate) {
      // This thread's staged values: the exponent of each (a NaN or an
      // infinity has all of its bits set), then, where one was seen, which.
      unsigned top = 0, zero = 0;
      const auto scan = [&](const double* p, bool in) {
        const unsigned hi = static_cast<unsigned>(__double2hiint(*p));
        top = max(top, hi & 0x7ff00000u);
        if (Op::kGateZero) zero |= in && (hi & 0x7fffffffu) == 0 && __double2loint(*p) == 0;
      };
      f64_slice<kF64BM, false>(const_cast<double*>(As), A, g.lda, a_kc, g.a_vec, m0, kt * kF64BK,
                               M, K, scan);
      f64_slice<BN, false>(const_cast<double*>(Bs), B, g.ldb, b_kc, g.b_vec, n0, kt * kF64BK, N,
                           K, scan);
      unsigned bits = zero ? kSawZero : 0u;
      if (top == 0x7ff00000u) {
        const auto which = [&](const double* p, bool) {
          const double v = *p;
          bits |= v != v ? kSawNaN : v == INFINITY ? kSawPosInf : v == -INFINITY ? kSawNegInf : 0u;
        };
        f64_slice<kF64BM, false>(const_cast<double*>(As), A, g.lda, a_kc, g.a_vec, m0,
                                 kt * kF64BK, M, K, which);
        f64_slice<BN, false>(const_cast<double*>(Bs), B, g.ldb, b_kc, g.b_vec, n0, kt * kF64BK,
                             N, K, which);
      }
      bits = __reduce_or_sync(0xffffffffu, bits);
      if (threadIdx.x % 32 == 0 && bits) atomicOr(&saw[kt % 3], bits);
      __syncthreads();  // the slice has landed, and its flags are whole
      num = Op::num_ok(saw[kt % 3]);
      // Slot kt + 2's last reader read it before this barrier; its next
      // writers write after the next one.
      if (threadIdx.x == 0) saw[(kt + 2) % 3] = 0;
    } else {
      __syncthreads();  // the slice has landed; stage kt - 1 is free
    }
    if (kt + kF64Stages - 1 < kt_n) load(kt + kF64Stages - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    const int kl = min(kF64BK, K - kt * kF64BK);
    if (kl == kF64BK && num) {
#pragma unroll kUnroll
      for (int kk = 0; kk < kF64BK; ++kk) f64_step<NumOp, TN, PA, PB>(acc, As, Bs, kk, tx, ty);
    } else if (kl == kF64BK) {
#pragma unroll kOpUnroll
      for (int kk = 0; kk < kF64BK; ++kk) f64_step<Op, TN, PA, PB>(acc, As, Bs, kk, tx, ty);
    } else {  // the K tail
      for (int kk = 0; kk < kl; ++kk) f64_step<Op, TN, PA, PB>(acc, As, Bs, kk, tx, ty);
    }
    if (kGate && kl == kF64BK) {
      num_slices += num;
      nan_slices += !num;
    }
  }
  if (kGate && threadIdx.x == 0) {
    atomicAdd(&f64_forms[0], num_slices);
    atomicAdd(&f64_forms[1], nan_slices);
  }

  const int64_t c0 = z * M * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + 32 * (i / 2) + 2 * ty + i % 2;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + 32 * (j / 2) + 2 * tx + j % 2;
      if (gm < M && gn < N) {
        const int64_t idx = c0 + static_cast<int64_t>(gm) * N + gn;
        if (g.out_code == kF64)
          static_cast<double*>(g.c)[idx] = acc[i][j];
        else if (g.out_code <= kI32)
          store_out(g.c, idx, acc[i][j], g.out_code);
        else
          store_wide_ep<false>(g.c, idx, acc[i][j], g.ep, gn, g.out_code);
      }
    }
  }
}

// The tile's launch; it finds the 16-byte copies' rule (a_vec / b_vec: base,
// row pitch and batch stride whole 16-byte units) from ``g`` itself.
template <typename Op>
int launch_simt_f64(const Gemm& g0, int64_t batch, cudaStream_t stream) {
  constexpr int TN = F64TileN<Op>::value;
  constexpr int smem = f64_smem<TN>();
  Gemm g = g0;
  const auto vec = [](const void* p, int64_t ld, int64_t bs) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 2 == 0 && bs % 2 == 0;
  };
  g.a_vec = vec(g.a, g.lda, g.sa);
  g.b_vec = vec(g.b, g.ldb, g.sb);
  const int attr = static_cast<int>(cudaFuncSetAttribute(
      simt_f64_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (attr) return attr;
  return for_batch_chunks(batch, [&](int64_t z0, unsigned nz) {
    const dim3 grid((g.N + 16 * TN - 1) / (16 * TN), (g.M + kF64BM - 1) / kF64BM, nz);
    simt_f64_kernel<Op><<<grid, kF64Threads, smem, stream>>>(g, z0);
  });
}

template <typename TIn, typename Acc, typename Op, bool kEpilogue = false>
int launch_simt(const Gemm& g, int64_t batch, cudaStream_t stream) {
  if constexpr (std::is_same<Acc, double>::value) {
    static_assert(!kEpilogue, "float64 B1 / B2 run on csrc/dmma_gemm.cu / dmma_tma.cu");
    return launch_simt_f64<Op>(g, batch, stream);
  } else {
    return for_batch_chunks(batch, [&](int64_t z0, unsigned nz) {
      const dim3 grid((g.N + SBN - 1) / SBN, (g.M + SBM - 1) / SBM, nz);
      simt_gemm_kernel<TIn, Acc, Op, kEpilogue><<<grid, STHREADS, 0, stream>>>(g, z0);
    });
  }
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
