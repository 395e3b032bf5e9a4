// Kernel B3: generic semiring GEMM, C[i,j] = reduce_k map(A[i,k], B[k,j]).
//
// Replaces the TPU kernel gemm_hls_tpu/ops/pallas_vpu.py::_vpu_kernel
// (entry vpu_matmul).  The TPU version materialises a (bm, ck, bn) mapped
// block on the VPU and folds it with a tree; here each thread folds its 8x8
// C entries one K element at a time in registers (csrc/simt_gemm.cuh), on
// CUDA cores: the tensor cores only do (+, x).
//
// What bounds it on an H100: the CUDA-core issue rate.  A (map, reduce)
// pair such as min_plus costs two instructions per term (add, min); at
// 128 lanes x 132 SMs x ~1.98 GHz that is ~16.7e12 terms/s, i.e. a ceiling
// of ~33 TOp/s counted as 2*M*N*K.  Shared-memory reads (16 per 64 terms a
// thread) fit under that; device-memory traffic follows the io_volume law
// of a 128x128 tile and is far below the bandwidth bound at 4096^3.
// Left on the table by this simple design: no packed f16x2/bf16x2 math,
// no double-buffered shared memory, 8x8 register tiles read with scalar
// shared-memory loads.
//
// Each built-in semiring is a functor; ``op`` selects it and matches
// ``op_code`` in gemm_hls_tpu_torch/ops/semiring.py.  Inputs: f32 and bf16
// (f32 accumulator) and int32 (int32 accumulator, wrapping like the
// reference).  The accumulator is cast to the output dtype at the store.
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
int dispatch_op(int op, const void* a, const void* b, void* c, int M, int N, int K, int64_t lda,
                int64_t ldb, int ta, int tb, int out_code, cudaStream_t s) {
  switch (op) {
    case kPlusTimes: return launch_simt<TIn, Acc, PlusTimes<Acc>>(a, b, c, M, N, K, lda, ldb, ta, tb, out_code, s);
    case kMinPlus: return launch_simt<TIn, Acc, MinPlus<Acc>>(a, b, c, M, N, K, lda, ldb, ta, tb, out_code, s);
    case kMaxPlus: return launch_simt<TIn, Acc, MaxPlus<Acc>>(a, b, c, M, N, K, lda, ldb, ta, tb, out_code, s);
    case kMaxMin: return launch_simt<TIn, Acc, MaxMin<Acc>>(a, b, c, M, N, K, lda, ldb, ta, tb, out_code, s);
    case kMinMax: return launch_simt<TIn, Acc, MinMax<Acc>>(a, b, c, M, N, K, lda, ldb, ta, tb, out_code, s);
    case kMaxTimes: return launch_simt<TIn, Acc, MaxTimes<Acc>>(a, b, c, M, N, K, lda, ldb, ta, tb, out_code, s);
    case kPlusAbsdiff: return launch_simt<TIn, Acc, PlusAbsdiff<Acc>>(a, b, c, M, N, K, lda, ldb, ta, tb, out_code, s);
    case kPlusSqdiff: return launch_simt<TIn, Acc, PlusSqdiff<Acc>>(a, b, c, M, N, K, lda, ldb, ta, tb, out_code, s);
    default: return kUnsupported;
  }
}

}  // namespace gemm_hls

using namespace gemm_hls;

// C (M, N) row-major, written in ``out_code``'s dtype.  Returns 0, a CUDA
// error code from the launch, or -1 for a (dtype, op) pair not built.
extern "C" int semiring_gemm(const void* a, const void* b, void* c, int M, int N, int K,
                             int64_t lda, int64_t ldb, int ta, int tb, int in_code, int out_code,
                             int op, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (op == kLogPlus) {
    if (in_code == kF32) return launch_simt<float, float, LogPlus>(a, b, c, M, N, K, lda, ldb, ta, tb, out_code, s);
    if (in_code == kBF16) return launch_simt<__nv_bfloat16, float, LogPlus>(a, b, c, M, N, K, lda, ldb, ta, tb, out_code, s);
    return kUnsupported;
  }
  if (op == kOrAndBits) {
    if (in_code == kI32) return launch_simt<int, int, OrAndBits>(a, b, c, M, N, K, lda, ldb, ta, tb, out_code, s);
    return kUnsupported;
  }
  switch (in_code) {
    case kF32: return dispatch_op<float, float>(op, a, b, c, M, N, K, lda, ldb, ta, tb, out_code, s);
    case kBF16: return dispatch_op<__nv_bfloat16, float>(op, a, b, c, M, N, K, lda, ldb, ta, tb, out_code, s);
    case kI32: return dispatch_op<int, int>(op, a, b, c, M, N, K, lda, ldb, ta, tb, out_code, s);
    default: return kUnsupported;
  }
}
