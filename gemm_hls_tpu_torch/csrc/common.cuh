// Shared helpers of the port's kernels: dtype codes, element conversion to
// the accumulator type, and the cast-at-store of a C element.
//
// The dtype codes match ``_DTYPE_CODES`` in gemm_hls_tpu_torch/_build.py.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace gemm_hls {

enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3, kI32 = 4 };

// Wrapper return code for a (dtype, op) combination no kernel is built for.
constexpr int kUnsupported = -1;

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

}  // namespace gemm_hls
