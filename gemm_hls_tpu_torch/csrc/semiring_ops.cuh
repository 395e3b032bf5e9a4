// The built-in semiring functors of kernel B3 and their dispatch by op
// code, shared by the translation units that instantiate them, one per
// input dtype so nvcc builds them in parallel: semiring_gemm.cu (int32 and
// the bit-packed or_and), semiring_f32.cu, semiring_bf16.cu,
// semiring_f16.cu, semiring_f64.cu and semiring_{i8,i16,u8,u16,u32,i64}.cu.
#pragma once

#include <type_traits>

#include "simt_gemm.cuh"

namespace gemm_hls {

enum Op : int {
  kPlusTimes = 0, kMinPlus = 1, kMaxPlus = 2, kMaxMin = 3, kMinMax = 4,
  kMaxTimes = 5, kPlusAbsdiff = 6, kPlusSqdiff = 7, kLogPlus = 8, kOrAndBits = 9,
};

// min / max of an accumulator (or operand) and a value known not to be NaN
// (kNum: a K slice whose gate holds, so no mapped value is NaN): for float64
// one compare and select, which keeps a NaN accumulator and orders the
// infinities as IEEE does, where dmin / dmax take three compares (sm_90 has
// no float64 min / max instruction).  The other types' dmin / dmax are one
// instruction already.
template <bool kNum, typename Acc>
__device__ __forceinline__ Acc rmin(Acc acc, Acc x) {
  if constexpr (kNum && std::is_same<Acc, double>::value) return x < acc ? x : acc;
  else return dmin(acc, x);
}
template <bool kNum, typename Acc>
__device__ __forceinline__ Acc rmax(Acc acc, Acc x) {
  if constexpr (kNum && std::is_same<Acc, double>::value) return x > acc ? x : acc;
  else return dmax(acc, x);
}

// The min / max functors name their kNum form (Num) and its gate: the float64
// tile (simt_gemm.cuh::simt_f64_kernel) runs Num on a K slice whose flags
// (kSawNaN, kSawPosInf, kSawNegInf, and kSawZero where kGateZero) say no
// mapped value can be NaN.  An added pair can be NaN only from a NaN or
// from +inf + -inf; a min or max of two values only from a NaN; a product
// from a NaN or from an infinity times a zero.  ops/vpu.py::num_gate is the
// same rule.
__host__ __device__ constexpr bool gate_sum(unsigned saw) {
  return !(saw & kSawNaN) && (saw & (kSawPosInf | kSawNegInf)) != (kSawPosInf | kSawNegInf);
}
__host__ __device__ constexpr bool gate_minmax(unsigned saw) { return !(saw & kSawNaN); }
__host__ __device__ constexpr bool gate_product(unsigned saw) {
  return !(saw & kSawNaN) && !((saw & (kSawPosInf | kSawNegInf)) && (saw & kSawZero));
}

template <typename Acc, bool kNum = false> struct MinPlus {
  using Num = MinPlus<Acc, true>;
  static constexpr bool kGateZero = false;
  static __device__ __forceinline__ bool num_ok(unsigned saw) { return gate_sum(saw); }
  static __device__ __forceinline__ Acc identity() { return Lim<Acc>::hi(); }
  static __device__ __forceinline__ Acc step(Acc acc, Acc a, Acc b) { return rmin<kNum>(acc, dadd(a, b)); }
};
template <typename Acc, bool kNum = false> struct MaxPlus {
  using Num = MaxPlus<Acc, true>;
  static constexpr bool kGateZero = false;
  static __device__ __forceinline__ bool num_ok(unsigned saw) { return gate_sum(saw); }
  static __device__ __forceinline__ Acc identity() { return Lim<Acc>::lo(); }
  static __device__ __forceinline__ Acc step(Acc acc, Acc a, Acc b) { return rmax<kNum>(acc, dadd(a, b)); }
};
template <typename Acc, bool kNum = false> struct MaxMin {
  using Num = MaxMin<Acc, true>;
  static constexpr bool kGateZero = false;
  static constexpr int kF64Unroll = 8;  // simt_gemm.cuh::F64Unroll: 1.19x faster than 16
  static __device__ __forceinline__ bool num_ok(unsigned saw) { return gate_minmax(saw); }
  static __device__ __forceinline__ Acc identity() { return Lim<Acc>::lo(); }
  static __device__ __forceinline__ Acc step(Acc acc, Acc a, Acc b) {
    return rmax<kNum>(acc, rmin<kNum>(a, b));
  }
};
template <typename Acc, bool kNum = false> struct MinMax {
  using Num = MinMax<Acc, true>;
  static constexpr bool kGateZero = false;
  static constexpr int kF64Unroll = 8;  // simt_gemm.cuh::F64Unroll: 1.19x faster than 16
  static __device__ __forceinline__ bool num_ok(unsigned saw) { return gate_minmax(saw); }
  static __device__ __forceinline__ Acc identity() { return Lim<Acc>::hi(); }
  static __device__ __forceinline__ Acc step(Acc acc, Acc a, Acc b) {
    return rmin<kNum>(acc, rmax<kNum>(a, b));
  }
};
template <typename Acc, bool kNum = false> struct MaxTimes {
  using Num = MaxTimes<Acc, true>;
  static constexpr bool kGateZero = true;
  static __device__ __forceinline__ bool num_ok(unsigned saw) { return gate_product(saw); }
  static __device__ __forceinline__ Acc identity() { return Lim<Acc>::lo(); }
  static __device__ __forceinline__ Acc step(Acc acc, Acc a, Acc b) { return rmax<kNum>(acc, dmul(a, b)); }
};
__device__ __forceinline__ float dabs(float x) { return fabsf(x); }
__device__ __forceinline__ double dabs(double x) { return fabs(x); }
__device__ __forceinline__ int dabs(int x) { return x < 0 ? dsub(0, x) : x; }
template <typename Acc> struct PlusAbsdiff {
  static __device__ __forceinline__ Acc identity() { return Acc(0); }
  static __device__ __forceinline__ Acc step(Acc acc, Acc a, Acc b) { return dadd(acc, dabs(dsub(a, b))); }
};
template <typename Acc> struct PlusSqdiff {
  static __device__ __forceinline__ Acc identity() { return Acc(0); }
  static __device__ __forceinline__ Acc step(Acc acc, Acc a, Acc b) {
    const Acc d = dsub(a, b);
    return dadd(acc, dmul(d, d));
  }
};

// numpy's logaddexp: equal arguments (both -inf included) return x + ln 2,
// so logaddexp(-inf, -inf) = -inf.  The naive m + log1p(exp(-|x - y|))
// forms -inf - -inf = NaN there.  In the accumulator's precision: fp32
// (fp32 / bf16 / fp16 inputs) or float64.
__device__ __forceinline__ float logaddexp(float x, float y) {
  if (x == y) return x + 0.693147180559945309f;
  const float d = x - y;
  if (d > 0.f) return x + log1pf(expf(-d));
  if (d <= 0.f) return y + log1pf(expf(d));
  return d;  // NaN operand
}
// Out of line: double exp and log1p inlined into every unrolled term of the
// tile's 16 x 64 steps would take ptxas minutes.
static __device__ __noinline__ double logaddexp(double x, double y) {
  if (x == y) return x + 0.693147180559945309;
  const double d = x - y;
  if (d > 0.0) return x + log1p(exp(-d));
  if (d <= 0.0) return y + log1p(exp(d));
  return d;  // NaN operand
}
template <typename Acc> struct LogPlus {
  static constexpr int kF64TN = 4;  // simt_gemm.cuh::F64TileN: 32 accumulators around the calls
  static constexpr int kF64Unroll = 1;  // simt_gemm.cuh::F64Unroll: 1.02x faster than 8
  static __device__ __forceinline__ Acc identity() { return Lim<Acc>::lo(); }
  static __device__ __forceinline__ Acc step(Acc acc, Acc a, Acc b) { return logaddexp(acc, a + b); }
};

// Bool or_and on bit-packed int32 words (32 contraction bits per word):
// map = (a AND b) != 0, reduce = max (= OR over 0/1).
struct OrAndBits {
  static __device__ __forceinline__ int identity() { return 0; }
  static __device__ __forceinline__ int step(int acc, int a, int b) { return max(acc, (a & b) != 0 ? 1 : 0); }
};

template <typename TIn, typename Acc>
int dispatch_op(int op, const Gemm& g, int64_t batch, cudaStream_t s) {
  switch (op) {
    case kPlusTimes: return launch_simt<TIn, Acc, PlusTimes<Acc>>(g, batch, s);
    case kMinPlus: return launch_simt<TIn, Acc, MinPlus<Acc>>(g, batch, s);
    case kMaxPlus: return launch_simt<TIn, Acc, MaxPlus<Acc>>(g, batch, s);
    case kMaxMin: return launch_simt<TIn, Acc, MaxMin<Acc>>(g, batch, s);
    case kMinMax: return launch_simt<TIn, Acc, MinMax<Acc>>(g, batch, s);
    case kMaxTimes: return launch_simt<TIn, Acc, MaxTimes<Acc>>(g, batch, s);
    case kPlusAbsdiff: return launch_simt<TIn, Acc, PlusAbsdiff<Acc>>(g, batch, s);
    case kPlusSqdiff: return launch_simt<TIn, Acc, PlusSqdiff<Acc>>(g, batch, s);
    case kLogPlus:  // a floating accumulator only (torch's logaddexp takes no integers)
      if constexpr (std::is_floating_point<Acc>::value)
        return launch_simt<TIn, Acc, LogPlus<Acc>>(g, batch, s);
      return kUnsupported;
    default: return kUnsupported;
  }
}

}  // namespace gemm_hls
