// The arithmetic of generated functors: user-defined semirings of kernel
// B3 and Python-callable epilogues of kernels B1 / B2, which
// gemm_hls_tpu_torch/ops/codegen.py translates from a torch.fx trace into a
// translation unit of their own and builds at first use
// (gemm_hls_tpu_torch/_build.py::generated_library).  Included only by those
// generated units, never by the built-in sources.
//
// The counterpart of Pallas tracing ``sr.map_op`` / ``sr.reduce_op`` and an
// ``epilogue`` callable into the TPU kernel's body
// (gemm_hls_tpu/ops/pallas_vpu.py:56-91, pallas_mxu.py:103-105).  Each
// helper keeps the semantics of the torch op it stands for, so that the
// card agrees with the plain version, and a re-expressed built-in gives the
// built-in's bits:
//   * semiring functors use the built-ins' helpers: dadd / dsub / dmul
//     (int32 wraps through unsigned, simt_gemm.cuh), the NaN-propagating
//     dmin / dmax (common.cuh) and logaddexp (semiring_ops.cuh);
//   * epilogues round each sum and product on its own (ep_add / ep_mul and
//     the _rn forms below, as the plain version's separate torch ops) and
//     use the accurate expf / tanhf of common.cuh, never __expf;
//   * a bf16 / fp16 value is computed in float and rounded to its type
//     after each op, as PyTorch computes its 16-bit floats;
//   * constants come in as hex floats cast to the op's type at compile
//     time, so a float functor does no double arithmetic.
#pragma once

#include "semiring_ops.cuh"

namespace gemm_hls {

// Rounding of a float to the 16-bit float types, kept in float.
__device__ __forceinline__ float g_rbf(float x) { return __bfloat162float(__float2bfloat16(x)); }
__device__ __forceinline__ float g_rhf(float x) { return __half2float(__float2half(x)); }

__device__ __forceinline__ float ep_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double ep_sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float g_div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double g_div(double a, double b) { return __ddiv_rn(a, b); }

// int32 helpers of the epilogues (sums and products wrap, as torch's).
__device__ __forceinline__ int ep_add(int a, int b) { return dadd(a, b); }
__device__ __forceinline__ int ep_sub(int a, int b) { return dsub(a, b); }
__device__ __forceinline__ int ep_mul(int a, int b) { return dmul(a, b); }
__device__ __forceinline__ int g_neg(int x) { return dsub(0, x); }
__device__ __forceinline__ float g_neg(float x) { return -x; }
__device__ __forceinline__ double g_neg(double x) { return -x; }
__device__ __forceinline__ int g_abs(int x) { return dabs(x); }
__device__ __forceinline__ float g_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double g_abs(double x) { return fabs(x); }

__device__ __forceinline__ float g_expm1(float x) { return expm1f(x); }
__device__ __forceinline__ double g_expm1(double x) { return expm1(x); }
__device__ __forceinline__ float g_log(float x) { return logf(x); }
__device__ __forceinline__ double g_log(double x) { return log(x); }
__device__ __forceinline__ float g_log1p(float x) { return log1pf(x); }
__device__ __forceinline__ double g_log1p(double x) { return log1p(x); }
__device__ __forceinline__ float g_sqrt(float x) { return __fsqrt_rn(x); }
__device__ __forceinline__ double g_sqrt(double x) { return __dsqrt_rn(x); }
__device__ __forceinline__ float g_erf(float x) { return erff(x); }
__device__ __forceinline__ double g_erf(double x) { return erf(x); }
__device__ __forceinline__ float g_pow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double g_pow(double x, double y) { return pow(x, y); }

// torch.rsqrt: 1 / sqrt(x), both rounded (rsqrtf is approximate).
template <typename T>
__device__ __forceinline__ T g_rsqrt(T x) { return g_div(T(1), g_sqrt(x)); }

// F.silu: x / (1 + exp(-x)), as PyTorch computes it.
template <typename T>
__device__ __forceinline__ T g_silu(T x) { return g_div(x, ep_add(T(1), ep_exp(-x))); }

// F.gelu(approximate="none"): x 0.5 (1 + erf(x / sqrt(2))).
template <typename T>
__device__ __forceinline__ T g_gelu_erf(T x) {
  constexpr T kAlpha = T(0.70710678118654752440);  // 1 / sqrt(2)
  return ep_mul(ep_mul(x, T(0.5)), ep_add(T(1), g_erf(ep_mul(x, kAlpha))));
}

// F.softplus with its defaults (beta 1, threshold 20): x past the
// threshold, else log1p(exp(x)).
template <typename T>
__device__ __forceinline__ T g_softplus(T x) { return x > T(20) ? x : g_log1p(ep_exp(x)); }

}  // namespace gemm_hls
