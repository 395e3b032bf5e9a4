// Kernels B1 and B2 on the tile engine, fp32 inputs as TF32: the K-major
// kernel of csrc/mxu_wgmma.cuh on the workspaces of csrc/tf32_split.cu
// (A (M, passes * kp) and B held (N, passes * kp), every value already
// rounded to TF32, each row's pass segments one after another), in a
// translation unit of its own, so nvcc builds it beside the other types.
// k8 tf32 wgmma, 32 values a 128-byte swizzle row, so a stage holds the
// same 48 KB as the 16-bit types' and the ring keeps its four stages.
//   * one pass (the reference's Precision.DEFAULT): the engine as it is,
//     m64n256 into the tile's sums;
//   * three passes ("high" / "highest": hi.hi + hi.lo + lo.hi): the
//     tensor cores cut their fp32 sums toward zero, which over K grows to
//     tens of SGEMM's error, so each stage's products go to a fresh
//     m64n64 partial, a quarter of a warpgroup's tile at a time, added into
//     the tile's sums by IEEE fp32 adds (wgmma_tile.cuh, wg_consume's
//     kPromote).
// What bounds it on an H100: the TF32 rate, 494.7 TFLOP/s dense (H100 SXM
// data sheet, 700 W): at 8192^3 2.22 ms for one pass and 6.67 ms for
// three, against 16.43 ms for fp32 FFMA on the CUDA cores.
#include "mxu_wgmma.cuh"

using namespace gemm_hls;

// mxu_wgmma's arguments for the two workspaces (both K-major, so no
// transpose flags; lda / ldb their row pitch, sa / sb their batch stride,
// 0 for one example), ``passes`` 1 or 3 and no input code.  Returns 0, a
// CUDA error code, -1 for arguments it does not take, or -2 for a tensor
// map cuTensorMapEncodeTiled refused.
extern "C" int mxu_wgmma_tf32(const void* a, const void* b, void* c, int64_t batch, int M, int N,
                              int K, int64_t lda, int64_t ldb, int64_t sa, int64_t sb, int passes,
                              int out_code, int ep, const void* e0, const void* e1, int ep_code,
                              void* stream) {
  if (ep < 0 || ep >= kEpKinds || M < 1 || N < 1 || K < 1) return kUnsupported;
  if (batch < 1 || batch > INT_MAX || !(passes == 1 || passes == 3)) return kUnsupported;
  const MxuWgCall call{a,  b,  c, static_cast<int>(batch), M, N, K, lda, ldb, sa, sb,
                       0,  1,  out_code, EpArgs{e0, e1, ep_code, ep}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return passes == 3 ? launch_mxu_wg<float, false, false, true>(call, st)
                     : launch_mxu_wg<float, false, false>(call, st);
}
