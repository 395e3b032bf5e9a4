// Kernels B1 and B2 on the tile engine (csrc/mxu_wgmma.cuh): the int8
// kernel (both operands K-major: A (M, K), B held as (N, K)) and the entry
// that takes the 16-bit types and int8 (fp32 has its own entry,
// mxu_wgmma_tf32, in csrc/mxu_wgmma_tf32.cu, and the other integers theirs,
// mxu_wgmma_int, in csrc/mxu_wgmma_int.cu).
#include "mxu_wgmma.cuh"

using namespace gemm_hls;

// C (batch, M, N) row-major = epilogue(op(A[z]) . op(B[z])) in
// ``out_code``'s dtype: mxu_gemm's arguments.  lda / ldb: the operands' row
// pitch, sa / sb: their batch stride (0: a 2-D operand broadcast over the
// batch, read through a 2-D map), in elements, each a 16-byte multiple with
// bases 16-byte aligned
// (the tensor maps' rule: ops/mxu.py::_launch packs an operand that is
// not, csrc/operand_pack.cu); ta: A held (K, M); tb: B held (N, K).  in_code
// bf16 / fp16 take every layout, int8 only ta = 0, tb = 1.  out_code: fp32,
// bf16 or fp16, and for int8 also int8, int16, int32 and the unsigned
// ints (each the int32 sum's wrapping cast).  ep, e0, e1, ep_code: as
// mxu_gemm's.  Returns 0, a CUDA error code, -1 for a type, layout, output
// or epilogue the route does not take, or -2 for a tensor map
// cuTensorMapEncodeTiled refused.
extern "C" int mxu_wgmma(const void* a, const void* b, void* c, int64_t batch, int M, int N, int K,
                         int64_t lda, int64_t ldb, int64_t sa, int64_t sb, int ta, int tb,
                         int in_code, int out_code, int ep, const void* e0, const void* e1,
                         int ep_code, void* stream) {
  if (ep < 0 || ep >= kEpKinds || M < 1 || N < 1 || K < 1) return kUnsupported;
  if (batch < 1 || batch > INT_MAX || !engine_stores(out_code, in_code == kI8))
    return kUnsupported;
  const MxuWgCall call{a,  b,  c,  static_cast<int>(batch), M, N, K, lda, ldb, sa, sb,
                       ta, tb, out_code, EpArgs{e0, e1, ep_code, ep}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (in_code) {
    case kBF16: return launch_mxu_wg_bf16(call, st);
    case kF16: return launch_mxu_wg_f16(call, st);
    case kI8: return !ta && tb ? launch_mxu_wg<signed char, false, false>(call, st) : kUnsupported;
    default: return kUnsupported;
  }
}
