// Measurement kernels for kernel B3's routes (chip_smoke.py phases 36a and
// 36b, tools/b3_ab.py).  They replace no TPU kernel: they measure the
// rates B3's bound counts (models/perf_model.py::ChipSpec.vpu_ops_for) and
// check, over every pair of 16-bit values, the premise of the packed route
// (csrc/packed_gemm.cuh).
//
//  * b3_issue_rate: a throughput loop of one instruction, or of one term's
//    instruction sequence, on 8 independent chains a thread, 1024 threads a
//    block, one block an SM (its shared memory request keeps a second one
//    off); each block times its loop in SM clocks (clock64).  Each step of a
//    chain reads the next chain's value, so nothing is loop-invariant and
//    no algebra folds a step away.
//  * b3_pair_check: for every (a, b) of 2^16 x 2^16 16-bit patterns, the
//    packed tile's instruction (add / mul / min.NaN / max.NaN on .f16x2 or
//    .bf16x2, packed_gemm.cuh's Pair) against the fp32 instruction on the widened values and a
//    round to nearest even back to the type (the scalar tile's
//    arithmetic, csrc/simt_gemm.cuh, and its store, common.cuh::store_out).
//    Counts the results whose bits differ, apart from those where both are
//    NaN, and those where both are NaN with different bits.
#include "packed_gemm.cuh"

namespace gemm_hls {
namespace probe {

// ---- the instructions ------------------------------------------------------
__device__ __forceinline__ unsigned fadd(unsigned a, unsigned b) {
  unsigned r;
  asm volatile("add.rn.f32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ unsigned fmul(unsigned a, unsigned b) {
  unsigned r;
  asm volatile("mul.rn.f32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ unsigned ffma(unsigned a, unsigned b, unsigned c) {
  unsigned r;
  asm volatile("fma.rn.f32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ unsigned fmin_nan(unsigned a, unsigned b) {
  unsigned r;
  asm volatile("min.NaN.f32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ unsigned fmax_nan(unsigned a, unsigned b) {
  unsigned r;
  asm volatile("max.NaN.f32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ unsigned imin(unsigned a, unsigned b) {
  unsigned r;
  asm volatile("min.s32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ unsigned imax(unsigned a, unsigned b) {
  unsigned r;
  asm volatile("max.s32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ unsigned imul(unsigned a, unsigned b) {
  unsigned r;
  asm volatile("mul.lo.s32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ unsigned imad(unsigned a, unsigned b, unsigned c) {
  unsigned r;
  asm volatile("mad.lo.s32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
// sm_90's DPX: min(a + b, c) in one instruction (VIADDMNMX), and the
// three-input max.
__device__ __forceinline__ unsigned viaddmin(unsigned a, unsigned b, unsigned c) {
  return static_cast<unsigned>(
      __viaddmin_s32(static_cast<int>(a), static_cast<int>(b), static_cast<int>(c)));
}
__device__ __forceinline__ unsigned vimax3(unsigned a, unsigned b, unsigned c) {
  return static_cast<unsigned>(
      __vimax3_s32(static_cast<int>(a), static_cast<int>(b), static_cast<int>(c)));
}
// The packed tile's own pair instructions (packed_gemm.cuh).
using H2 = Pair<__half>;
using B2 = Pair<__nv_bfloat16>;
// The MUFU's base-2 exponential and logarithm (logaddexp's transcendentals).
__device__ __forceinline__ unsigned ex2(unsigned a) {
  unsigned r;
  asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=r"(r) : "r"(a));
  return r;
}
__device__ __forceinline__ unsigned lg2(unsigned a) {
  unsigned r;
  asm volatile("lg2.approx.ftz.f32 %0, %1;" : "=r"(r) : "r"(a));
  return r;
}

// ---- the throughput loops ---------------------------------------------------
// Must match ``SEQUENCES`` in gemm_hls_tpu_torch/tools/b3_ab.py: one
// instruction (results a lane a step: 1, or 2 for a packed pair), then one
// term's sequence (terms a lane a step).
enum Seq : int {
  kFadd, kFfma, kFmnmx, kImnmx, kImad, kViaddmnmx, kVimax3,
  kHadd2, kHmul2, kHmnmx2, kBadd2, kBmul2, kBmnmx2, kMufuEx2, kMufuLg2,
  // acc = reduce(acc, map(a, b)), as the tiles run a term
  kTermF32MinPlus,    // FADD, FMNMX
  kTermF32MaxMin,     // FMNMX, FMNMX
  kTermF32MaxTimes,   // FMUL, FMNMX
  kTermI32MinPlus,    // VIADDMNMX
  kTermI32MaxMin,     // IMNMX, IMNMX
  kTermI32MaxMin3,    // two terms: IMNMX, IMNMX, VIMNMX3
  kTermI32MaxTimes,   // IMUL, IMNMX
  kTermF16MinPlus,    // two terms: HADD2, HMNMX2
  kTermF16MaxMin,     // two terms: HMNMX2, HMNMX2
  kTermF16MaxTimes,   // two terms: HMUL2, HMNMX2
  kTermBF16MinPlus,   // two terms: HADD2.BF16, HMNMX2.BF16
  kTermBF16MaxMin,
  kTermBF16MaxTimes,
  kSeqs,
};

template <int kSeq>
__device__ __forceinline__ unsigned seq_step(unsigned x, unsigned next, unsigned next2,
                                             unsigned y) {
  switch (kSeq) {
    case kFadd: return fadd(x, next);
    case kFfma: return ffma(next, y, x);
    case kFmnmx: return fmin_nan(x, next);
    case kImnmx: return imin(x, next);
    case kImad: return imad(next, y, x);
    case kViaddmnmx: return viaddmin(next, y, x);
    case kVimax3: return vimax3(x, next, next2);
    case kHadd2: return H2::add(x, next);
    case kHmul2: return H2::mul(x, next);
    case kHmnmx2: return H2::min(x, next);
    case kBadd2: return B2::add(x, next);
    case kBmul2: return B2::mul(x, next);
    case kBmnmx2: return B2::min(x, next);
    case kMufuEx2: return ex2(next);
    case kMufuLg2: return lg2(next);
    case kTermF32MinPlus: return fmin_nan(x, fadd(next, y));
    case kTermF32MaxMin: return fmax_nan(x, fmin_nan(next, y));
    case kTermF32MaxTimes: return fmax_nan(x, fmul(next, y));
    case kTermI32MinPlus: return viaddmin(next, y, x);
    case kTermI32MaxMin: return imax(x, imin(next, y));
    case kTermI32MaxMin3: return vimax3(x, imin(next, y), imin(next2, y ^ 1u));
    case kTermI32MaxTimes: return imax(x, imul(next, y));
    case kTermF16MinPlus: return H2::min(x, H2::add(next, y));
    case kTermF16MaxMin: return H2::max(x, H2::min(next, y));
    case kTermF16MaxTimes: return H2::max(x, H2::mul(next, y));
    case kTermBF16MinPlus: return B2::min(x, B2::add(next, y));
    case kTermBF16MaxMin: return B2::max(x, B2::min(next, y));
    case kTermBF16MaxTimes: return B2::max(x, B2::mul(next, y));
    default: return x;
  }
}

constexpr int kRateThreads = 1024, kRateChains = 8, kRateUnroll = 4;
constexpr int kRateSmem = 160 * 1024;  // more than half an SM's: one block an SM

template <int kSeq>
__global__ void __launch_bounds__(kRateThreads, 1)
    rate_kernel(unsigned* sink, long long* clocks, int iters, unsigned seed) {
  extern __shared__ unsigned rate_smem[];
  const unsigned tid = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned x[kRateChains];
#pragma unroll
  for (int c = 0; c < kRateChains; ++c) x[c] = (seed ^ (tid * 2654435761u)) + 0x3c003c00u * c;
  const unsigned y = seed * 0x9e3779b9u + 0x3c00u;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < kRateUnroll; ++u)
#pragma unroll
      for (int c = 0; c < kRateChains; ++c)
        x[c] = seq_step<kSeq>(x[c], x[(c + 1) % kRateChains], x[(c + 2) % kRateChains], y);
  }
  __syncthreads();
  const long long t1 = clock64();
  unsigned acc = 0;
#pragma unroll
  for (int c = 0; c < kRateChains; ++c) acc ^= x[c];
  if (acc == seed) rate_smem[threadIdx.x] = acc;  // keeps the chains live
  if (acc == seed + 1u) sink[tid] = rate_smem[threadIdx.x ^ 1];
  if (threadIdx.x == 0) clocks[blockIdx.x] = t1 - t0;
}

template <int kSeq>
int launch_rate(int blocks, int iters, unsigned seed, unsigned* sink, long long* clocks,
                cudaStream_t s) {
  const int attr = static_cast<int>(cudaFuncSetAttribute(
      rate_kernel<kSeq>, cudaFuncAttributeMaxDynamicSharedMemorySize, kRateSmem));
  if (attr) return attr;
  rate_kernel<kSeq><<<blocks, kRateThreads, kRateSmem, s>>>(sink, clocks, iters, seed);
  return last_error();
}

template <int kSeq>
int rate_dispatch(int seq, int blocks, int iters, unsigned seed, unsigned* sink,
                  long long* clocks, cudaStream_t s) {
  if constexpr (kSeq == kSeqs) {
    return kUnsupported;
  } else {
    if (seq == kSeq) return launch_rate<kSeq>(blocks, iters, seed, sink, clocks, s);
    return rate_dispatch<kSeq + 1>(seq, blocks, iters, seed, sink, clocks, s);
  }
}

// ---- the exhaustive pair checks ---------------------------------------------
// Must match ``PAIR_OPS`` in gemm_hls_tpu_torch/tools/b3_ab.py.
enum PairOp : int { kPairAdd = 0, kPairMul = 1, kPairMin = 2, kPairMax = 3 };

__device__ __forceinline__ unsigned pair_packed(bool bf16, int op, unsigned a, unsigned b) {
  if (bf16) {
    switch (op) {
      case kPairAdd: return B2::add(a, b);
      case kPairMul: return B2::mul(a, b);
      case kPairMin: return B2::min(a, b);
      default: return B2::max(a, b);
    }
  }
  switch (op) {
    case kPairAdd: return H2::add(a, b);
    case kPairMul: return H2::mul(a, b);
    case kPairMin: return H2::min(a, b);
    default: return H2::max(a, b);
  }
}

// The scalar tile's term on two 16-bit values: widen exactly, the fp32
// instruction, round to nearest even back to the type.
__device__ __forceinline__ unsigned pair_scalar(bool bf16, int op, unsigned a, unsigned b) {
  const unsigned short as = static_cast<unsigned short>(a), bs = static_cast<unsigned short>(b);
  const float fa = bf16 ? __bfloat162float(__ushort_as_bfloat16(as)) : __half2float(__ushort_as_half(as));
  const float fb = bf16 ? __bfloat162float(__ushort_as_bfloat16(bs)) : __half2float(__ushort_as_half(bs));
  float r;
  switch (op) {
    case kPairAdd: r = __fadd_rn(fa, fb); break;
    case kPairMul: r = __fmul_rn(fa, fb); break;
    case kPairMin: r = dmin(fa, fb); break;
    default: r = dmax(fa, fb); break;
  }
  return bf16 ? __bfloat16_as_ushort(__float2bfloat16_rn(r)) : __half_as_ushort(__float2half_rn(r));
}

__device__ __forceinline__ bool is_nan16(bool bf16, unsigned v) {
  return (v & 0x7fffu) > (bf16 ? 0x7f80u : 0x7c00u);
}

// Block a: every b, two a packed instruction, (b, b + 1).  out[0] counts the
// results whose bits differ (not both NaN), out[1] those both NaN with other
// bits, out[2] the least (a << 16 | b) of a differing result.
__global__ void __launch_bounds__(256) pair_check_kernel(int bf16, int op,
                                                         unsigned long long* out) {
  const unsigned a = blockIdx.x;
  const unsigned a2 = a | (a << 16);
  unsigned long long bad = 0, nan_bits = 0, first = ~0ull;
  for (unsigned b = 2 * threadIdx.x; b < 65536u; b += 512) {
    const unsigned r = pair_packed(bf16, op, a2, b | ((b + 1) << 16));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned got = (r >> (16 * h)) & 0xffffu;
      const unsigned want = pair_scalar(bf16, op, a, b + h);
      if (got != want) {
        if (is_nan16(bf16, got) && is_nan16(bf16, want)) {
          ++nan_bits;
        } else {
          ++bad;
          first = min(first, static_cast<unsigned long long>((a << 16) | (b + h)));
        }
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) {
    bad += __shfl_xor_sync(0xffffffffu, bad, o);
    nan_bits += __shfl_xor_sync(0xffffffffu, nan_bits, o);
    first = min(first, __shfl_xor_sync(0xffffffffu, first, o));
  }
  if (threadIdx.x % 32 == 0) {
    if (bad) atomicAdd(&out[0], bad);
    if (nan_bits) atomicAdd(&out[1], nan_bits);
    if (first != ~0ull) atomicMin(&out[2], first);
  }
}

}  // namespace probe
}  // namespace gemm_hls

using namespace gemm_hls;

// One throughput loop of sequence ``seq`` on ``blocks`` blocks of 1024
// threads, ``iters`` rounds of 4 x 8 steps a thread; clocks[i] receives
// block i's SM clocks.  Returns 0, a CUDA error, or -1 for an unknown seq.
extern "C" int b3_issue_rate(int seq, int blocks, int iters, unsigned seed, void* sink,
                             void* clocks, void* stream) {
  return probe::rate_dispatch<0>(seq, blocks, iters, seed, static_cast<unsigned*>(sink),
                                 static_cast<long long*>(clocks),
                                 static_cast<cudaStream_t>(stream));
}

// Every 16-bit pair under one packed instruction (``bf16``: .bf16x2, else
// .f16x2; ``op``: probe::PairOp) against the scalar tile's fp32 term;
// ``out`` (3 x uint64 on the card) set to {0, 0, ~0} first, then filled as
// pair_check_kernel says.  Returns 0 or a CUDA error.
extern "C" int b3_pair_check(int bf16, int op, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned long long init[3] = {0, 0, ~0ull};
  int err = static_cast<int>(cudaMemcpyAsync(out, init, sizeof(init), cudaMemcpyHostToDevice, s));
  if (err) return err;
  probe::pair_check_kernel<<<65536, 256, 0, s>>>(bf16, op, static_cast<unsigned long long*>(out));
  return last_error();
}
