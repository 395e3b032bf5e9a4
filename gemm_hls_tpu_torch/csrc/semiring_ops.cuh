// The built-in semiring functors of kernel B3 and their dispatch by op
// code, shared by the translation units that instantiate them
// (semiring_gemm.cu, semiring_f32.cu, semiring_bf16.cu: one per input
// dtype, so nvcc builds them in parallel).
#pragma once

#include "simt_gemm.cuh"

namespace gemm_hls {

enum Op : int {
  kPlusTimes = 0, kMinPlus = 1, kMaxPlus = 2, kMaxMin = 3, kMinMax = 4,
  kMaxTimes = 5, kPlusAbsdiff = 6, kPlusSqdiff = 7, kLogPlus = 8, kOrAndBits = 9,
};

template <typename Acc> struct MinPlus {
  static __device__ __forceinline__ Acc identity() { return Lim<Acc>::hi(); }
  static __device__ __forceinline__ Acc step(Acc acc, Acc a, Acc b) { return dmin(acc, dadd(a, b)); }
};
template <typename Acc> struct MaxPlus {
  static __device__ __forceinline__ Acc identity() { return Lim<Acc>::lo(); }
  static __device__ __forceinline__ Acc step(Acc acc, Acc a, Acc b) { return dmax(acc, dadd(a, b)); }
};
template <typename Acc> struct MaxMin {
  static __device__ __forceinline__ Acc identity() { return Lim<Acc>::lo(); }
  static __device__ __forceinline__ Acc step(Acc acc, Acc a, Acc b) { return dmax(acc, dmin(a, b)); }
};
template <typename Acc> struct MinMax {
  static __device__ __forceinline__ Acc identity() { return Lim<Acc>::hi(); }
  static __device__ __forceinline__ Acc step(Acc acc, Acc a, Acc b) { return dmin(acc, dmax(a, b)); }
};
template <typename Acc> struct MaxTimes {
  static __device__ __forceinline__ Acc identity() { return Lim<Acc>::lo(); }
  static __device__ __forceinline__ Acc step(Acc acc, Acc a, Acc b) { return dmax(acc, dmul(a, b)); }
};
__device__ __forceinline__ float dabs(float x) { return fabsf(x); }
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
// forms -inf - -inf = NaN there.
__device__ __forceinline__ float logaddexp(float x, float y) {
  if (x == y) return x + 0.693147180559945309f;
  const float d = x - y;
  if (d > 0.f) return x + log1pf(expf(-d));
  if (d <= 0.f) return y + log1pf(expf(d));
  return d;  // NaN operand
}
struct LogPlus {
  static __device__ __forceinline__ float identity() { return -INFINITY; }
  static __device__ __forceinline__ float step(float acc, float a, float b) { return logaddexp(acc, a + b); }
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
    default: return kUnsupported;
  }
}

}  // namespace gemm_hls
