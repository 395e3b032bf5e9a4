// Shared helpers of the port's kernels: dtype codes, element conversion to
// the accumulator type, the cast-at-store of a C element, the problem
// descriptor every GEMM kernel takes, the batch-chunked launch, and the
// per-column epilogues applied at the store.
//
// The dtype codes match ``_DTYPE_CODES`` in gemm_hls_tpu_torch/_build.py;
// the epilogue kinds match ``code`` of the registry entries in
// gemm_hls_tpu_torch/ops/epilogue.py.
#pragma once

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace gemm_hls {

// kF32 .. kI32 are the types every kernel's store writes; the wide ones
// after them (float64, int16, the unsigned ints, int64) only kernels B1 - B3
// take, as inputs and outputs (``store_wide``).
enum DType : int {
  kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3, kI32 = 4,
  kF64 = 5, kI16 = 6, kU8 = 7, kU16 = 8, kU32 = 9, kI64 = 10,
};

// Wrapper return code for a (dtype, op) combination no kernel is built for.
constexpr int kUnsupported = -1;

// gridDim.z limit: a batch above it is launched in chunks of this many.
constexpr int64_t kMaxGridZ = 65535;

__device__ __forceinline__ float to_acc(float x, float) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x, float) { return __bfloat162float(x); }
__device__ __forceinline__ float to_acc(__half x, float) { return __half2float(x); }
__device__ __forceinline__ int to_acc(int x, int) { return x; }
__device__ __forceinline__ int to_acc(signed char x, int) { return x; }
// The wide inputs: float64 keeps a float64 accumulator; every integer type
// meets the int32 accumulator as the reference's ``astype(int32)`` makes it
// (sign or zero extension, and uint32 / int64 wrapped to their low 32 bits,
// two's complement).
__device__ __forceinline__ double to_acc(double x, double) { return x; }
__device__ __forceinline__ int to_acc(short x, int) { return x; }
__device__ __forceinline__ int to_acc(unsigned char x, int) { return x; }
__device__ __forceinline__ int to_acc(unsigned short x, int) { return x; }
__device__ __forceinline__ int to_acc(unsigned int x, int) { return static_cast<int>(x); }
__device__ __forceinline__ int to_acc(long long x, int) {
  return static_cast<int>(static_cast<unsigned int>(static_cast<unsigned long long>(x)));
}

// C[idx] = v cast to the output dtype (round-to-nearest for floats, two's
// complement truncation for integers, as ``astype`` does in the reference).
template <typename Acc>
__device__ __forceinline__ void store_out(void* c, int64_t idx, Acc v, int out_code) {
  switch (out_code) {
    case kF32: static_cast<float*>(c)[idx] = static_cast<float>(v); break;
    case kBF16: static_cast<__nv_bfloat16*>(c)[idx] = __float2bfloat16(static_cast<float>(v)); break;
    case kF16: static_cast<__half*>(c)[idx] = __float2half(static_cast<float>(v)); break;
    case kI8: static_cast<signed char*>(c)[idx] = static_cast<signed char>(static_cast<int>(v)); break;
    case kI32: static_cast<int*>(c)[idx] = static_cast<int>(v); break;
  }
}

// The wide output types of kernels B1 - B3 (float64, int16, the unsigned
// ints, int64), out of line: callers make one call an element, in a branch
// of their own (an inline switch, or this call beside an inline epilogue,
// in every unrolled store of the CUDA-core tile took ptxas minutes).  A
// float value (an fp32 / float64 accumulator, or an epilogue's result) is
// stored as float64 or truncated to an integer type as ``astype`` does; an
// int32 one wraps to the output's width (int64 sign-extends).
static __device__ __noinline__ void store_wide(void* c, int64_t idx, int v, int out_code) {
  switch (out_code) {
    case kF64: static_cast<double*>(c)[idx] = v; break;
    case kI16: static_cast<short*>(c)[idx] = static_cast<short>(v); break;
    case kU8: static_cast<unsigned char*>(c)[idx] = static_cast<unsigned char>(v); break;
    case kU16: static_cast<unsigned short*>(c)[idx] = static_cast<unsigned short>(v); break;
    case kU32: static_cast<unsigned int*>(c)[idx] = static_cast<unsigned int>(v); break;
    case kI64: static_cast<long long*>(c)[idx] = v; break;
  }
}
static __device__ __noinline__ void store_wide(void* c, int64_t idx, double v, int out_code) {
  if (out_code == kF64)
    static_cast<double*>(c)[idx] = v;
  else
    store_wide(c, idx, static_cast<int>(v), out_code);
}
__device__ __forceinline__ double wide_of(float v) { return v; }
__device__ __forceinline__ double wide_of(double v) { return v; }
__device__ __forceinline__ int wide_of(int v) { return v; }

// store_out for every DType (the float64 tile's out-of-line store).
template <typename Acc>
__device__ __forceinline__ void store_any(void* c, int64_t idx, Acc v, int out_code) {
  if (out_code <= kI32)
    store_out(c, idx, v, out_code);
  else
    store_wide(c, idx, wide_of(v), out_code);
}

inline int last_error() { return static_cast<int>(cudaGetLastError()); }

// NaN-propagating min/max: fminf/fmaxf drop a NaN operand, while the
// reference's jnp.minimum / jnp.maximum (and torch's) return NaN.  PTX
// min.NaN (sm_80+) propagates it in one instruction.
__device__ __forceinline__ float dmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float dmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ int dmin(int a, int b) { return min(a, b); }
__device__ __forceinline__ int dmax(int a, int b) { return max(a, b); }
// PTX has no min.NaN.f64: a NaN operand is returned as it is.
__device__ __forceinline__ double dmin(double a, double b) {
  return a != a ? a : b != b ? b : fmin(a, b);
}
__device__ __forceinline__ double dmax(double a, double b) {
  return a != a ? a : b != b ? b : fmax(a, b);
}

// ---- per-column epilogues --------------------------------------------------
// The counterpart of the TPU kernels' ``epilogue(acc, *(1, bn) operands)``:
// applied to the accumulator of C[m, n] before the output cast, reading
// element n of up to two (N,) operands.  It runs in the accumulator's float
// type T: float on every route, double on the float64 tile
// (csrc/dmma_gemm.cu).  Operands are f32, bf16 or f16 (``code``; for T =
// double also f64), read in their own type and widened to T.  The epilogue
// is chosen at run time (``kind``): one uniform branch per stored element,
// where a template parameter per epilogue would multiply every kernel's
// instantiations (and the build time) by the number of epilogues.
// Transcendentals use the accurate exp / tanh of T, never the __expf
// intrinsics, so the card agrees with the plain version to T's rounding.
enum EpKind : int {
  kEpNone = 0, kEpBias = 1, kEpBiasRelu = 2, kEpBiasSigmoid = 3, kEpBiasTanh = 4,
  kEpColScale = 5, kEpScaleBias = 6, kEpBiasGelu = 7,
};
constexpr int kEpKinds = 8;

struct EpArgs {
  const void* e0;
  const void* e1;
  int code;  // DType of e0 / e1
  int kind;  // EpKind
};

template <typename T = float>
__device__ __forceinline__ T ep_load(const void* p, int code, int n) {
  if constexpr (sizeof(T) == 8) {
    if (code == kF64) return static_cast<const double*>(p)[n];
  }
  switch (code) {
    case kBF16: return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[n]);
    case kF16: return __half2float(static_cast<const __half*>(p)[n]);
    default: return static_cast<const float*>(p)[n];
  }
}

// Each product and sum rounded on its own (no contraction into an FMA), and
// the transcendentals, in T.
__device__ __forceinline__ float ep_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double ep_mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float ep_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double ep_add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float ep_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double ep_abs(double x) { return fabs(x); }
__device__ __forceinline__ float ep_exp(float x) { return expf(x); }
__device__ __forceinline__ double ep_exp(double x) { return exp(x); }
__device__ __forceinline__ float ep_tanh(float x) { return tanhf(x); }
__device__ __forceinline__ double ep_tanh(double x) { return tanh(x); }

// exp of a non-positive argument only: no 1 / inf.
template <typename T>
__device__ __forceinline__ T ep_sigmoid(T x) {
  const T t = ep_exp(-ep_abs(x));
  return x >= T(0) ? T(1) / (T(1) + t) : t / (T(1) + t);
}

// The tanh GELU, jax.nn.gelu's default form, in the order of PyTorch's
// gelu(approximate="tanh"): 0.5 x (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3))),
// each product and sum rounded on its own.
template <typename T>
__device__ __forceinline__ T ep_gelu_inline(T x) {
  constexpr T kBeta = T(0.7978845608028654);  // sqrt(2 / pi)
  constexpr T kKappa = T(0.044715);
  const T cube = ep_mul(ep_mul(x, x), x);
  const T inner = ep_mul(kBeta, ep_add(x, ep_mul(kKappa, cube)));
  return ep_mul(ep_mul(T(0.5), x), ep_add(T(1), ep_tanh(inner)));
}
// The per-element stores of the WMMA and CUDA-core routes call it out of
// line: inlined into every unrolled store of every instantiation it took
// mxu_gemm.cu's build to 170 s, the slowest source (the engine's epilogue,
// mxu_wgmma.cuh, keeps it inline over its registers).
template <typename T>
static __device__ __noinline__ T ep_gelu(T x) { return ep_gelu_inline(x); }

template <typename T>
__device__ __forceinline__ T epilogue(T acc, const EpArgs& e, int n) {
  if (e.kind == kEpNone) return acc;
  const T p = ep_load<T>(e.e0, e.code, n);
  switch (e.kind) {
    case kEpColScale: return ep_mul(acc, p);
    case kEpScaleBias: return ep_add(ep_mul(acc, p), ep_load<T>(e.e1, e.code, n));
    default: break;
  }
  const T x = ep_add(acc, p);
  switch (e.kind) {
    case kEpBiasRelu: return dmax(x, T(0));
    case kEpBiasSigmoid: return ep_sigmoid(x);
    case kEpBiasTanh: return ep_tanh(x);
    case kEpBiasGelu: return ep_gelu(x);
    default: return x;  // kEpBias
  }
}
// C[idx] = epilogue(acc) cast to the output dtype.  An int32 accumulator
// (int8 / int32 inputs) meets the epilogue widened to fp32, as the plain
// version's int32 + fp32 promotes (exact while |acc| < 2^24); without an
// epilogue it is stored as it is.
template <typename Acc>
__device__ __forceinline__ void store_ep(void* c, int64_t idx, Acc acc, const EpArgs& e, int n,
                                         int out_code) {
  if (e.kind == kEpNone)
    store_out(c, idx, acc, out_code);
  else
    store_out(c, idx, epilogue(static_cast<float>(acc), e, n), out_code);
}

// store_ep for the wide output types, out of line (see store_wide).
template <bool kEpilogue, typename Acc>
static __device__ __noinline__ void store_wide_ep(void* c, int64_t idx, Acc acc, const EpArgs& e,
                                                  int n, int out_code) {
  if constexpr (kEpilogue) {
    if (e.kind != kEpNone) {
      store_wide(c, idx, static_cast<double>(epilogue(static_cast<float>(acc), e, n)), out_code);
      return;
    }
  }
  store_wide(c, idx, wide_of(acc), out_code);
}

// ---- the problem every GEMM kernel takes ----------------------------------
// C[z] (M, N) = op(A[z]) . op(B[z]) for z < batch, C row-major and dense
// (batch stride M * N).  A is (M, K) or, with ta, (K, M); B is (K, N) or,
// with tb, (N, K); each is read through its row pitch and its batch
// stride, so a stride of 0 broadcasts one 2-D operand over the batch and
// nothing is ever copied per example.
struct Gemm {
  const void* a;
  const void* b;
  void* c;
  int M, N, K;
  int64_t lda, ldb;  // row pitch, in elements
  int64_t sa, sb;    // batch stride, in elements (0: broadcast)
  int ta, tb;
  int a_vec, b_vec;  // 16-byte loads allowed (tensor-core routes)
  int out_code;
  EpArgs ep;
};

// Launches ``launch(z0, nz)`` over batch chunks of at most kMaxGridZ
// (gridDim.z's limit), checking each launch.
template <typename Launch>
int for_batch_chunks(int64_t batch, Launch&& launch) {
  for (int64_t z0 = 0; z0 < batch; z0 += kMaxGridZ) {
    const int64_t left = batch - z0;
    launch(z0, static_cast<unsigned>(left < kMaxGridZ ? left : kMaxGridZ));
    const int err = last_error();
    if (err) return err;
  }
  return 0;
}

}  // namespace gemm_hls
