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

enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3, kI32 = 4 };

// Wrapper return code for a (dtype, op) combination no kernel is built for.
constexpr int kUnsupported = -1;

// gridDim.z limit: a batch above it is launched in chunks of this many.
constexpr int64_t kMaxGridZ = 65535;

__device__ __forceinline__ float to_acc(float x, float) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x, float) { return __bfloat162float(x); }
__device__ __forceinline__ float to_acc(__half x, float) { return __half2float(x); }
__device__ __forceinline__ int to_acc(int x, int) { return x; }
__device__ __forceinline__ int to_acc(signed char x, int) { return x; }

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

// ---- per-column epilogues --------------------------------------------------
// The counterpart of the TPU kernels' ``epilogue(acc, *(1, bn) operands)``:
// applied to the accumulator of C[m, n] before the output cast, reading
// element n of up to two (N,) operands.  Operands are f32, bf16 or f16
// (``code``), read in their own type and widened to f32.  The epilogue is
// chosen at run time (``kind``): one uniform branch per stored element,
// where a template parameter per epilogue would multiply every kernel's
// instantiations (and the build time) by the number of epilogues.
// Transcendentals use the accurate expf / tanhf, never the __expf
// intrinsics, so the card agrees with the plain version to fp32 rounding.
enum EpKind : int {
  kEpNone = 0, kEpBias = 1, kEpBiasRelu = 2, kEpBiasSigmoid = 3, kEpBiasTanh = 4,
  kEpColScale = 5, kEpScaleBias = 6,
};
constexpr int kEpKinds = 7;

struct EpArgs {
  const void* e0;
  const void* e1;
  int code;  // DType of e0 / e1
  int kind;  // EpKind
};

__device__ __forceinline__ float ep_load(const void* p, int code, int n) {
  switch (code) {
    case kBF16: return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[n]);
    case kF16: return __half2float(static_cast<const __half*>(p)[n]);
    default: return static_cast<const float*>(p)[n];
  }
}

// exp of a non-positive argument only: no 1 / inf.
__device__ __forceinline__ float ep_sigmoid(float x) {
  const float t = expf(-fabsf(x));
  return x >= 0.f ? 1.f / (1.f + t) : t / (1.f + t);
}

// Rounding as the plain version's separate torch ops: no contraction of
// acc * s + b into one FMA.
__device__ __forceinline__ float epilogue(float acc, const EpArgs& e, int n) {
  if (e.kind == kEpNone) return acc;
  const float p = ep_load(e.e0, e.code, n);
  switch (e.kind) {
    case kEpColScale: return __fmul_rn(acc, p);
    case kEpScaleBias: return __fadd_rn(__fmul_rn(acc, p), ep_load(e.e1, e.code, n));
    default: break;
  }
  const float x = __fadd_rn(acc, p);
  switch (e.kind) {
    case kEpBiasRelu: return dmax(x, 0.f);
    case kEpBiasSigmoid: return ep_sigmoid(x);
    case kEpBiasTanh: return tanhf(x);
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
