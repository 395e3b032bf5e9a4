// Kernels B1 and B2 on the tile engine for int16, uint8, uint16, uint32 and
// int32 plus_times: the int32 sum that wraps modulo 2^32 (the reference's
// jacc_dtype, gemm_hls_tpu/config.py) as products of byte planes on the
// int8 tensor cores (csrc/wgmma_tile.cuh's ByteWalk), in a translation unit
// of its own, so nvcc builds it beside the other types.  The counterpart of
// gemm_hls_tpu/ops/pallas_mxu.py::_kernel (:69, its epilogue :103) and
// ::_batched_kernel (:143) for these types, in every layout and at every
// alignment: int16, uint16, uint32 and int32 are first cut into K-major
// byte planes by csrc/int_split.cu (one pass an operand); uint8 is its own
// plane, read in place where both operands are K-major with 16-byte rows,
// else after csrc/operand_pack.cu, as int8 is (ops/mxu.py::_launch).
//
// Passes (byte-plane pairs (i, j) with i + j <= 3) and their wgmma forms:
//   uint8           1: u8 . u8;
//   int16           4: s8 . s8 | u8 . s8, s8 . u8 | u8 . u8 (the high byte
//                      signed, the low unsigned);
//   uint16          4: u8 . u8 each;
//   uint32, int32  10: u8 . u8 each (one computation on the bit patterns).
// The store writes each input's own type (the reference's default
// out_dtype), int8, int32 and the floats; an epilogue sees the wrapped
// int32 sum widened to fp32, as int8's does.
//
// What bounds it on an H100: the int8 tensor-core rate, 1979 TOP/s dense
// (H100 SXM data sheet), times the passes: at 4096^3 0.069 ms a pass, so
// 0.069 / 0.28 / 0.69 ms for 1 / 4 / 10 passes, plus the split pass's
// bytes (ops/mxu.py::int_split_operand; models/perf_model.py::int_split_bound).
#include "mxu_wgmma.cuh"

using namespace gemm_hls;

// mxu_wgmma_tf32's arguments for byte planes: a / b both K-major (A (M, .),
// B held (N, .)), lda / ldb their row pitch and sa / sb their batch stride
// (0 for one example) in bytes; K one plane's K (a multiple of 128 for the
// split types, whose rows hold their planes one after another: 2 for
// int16 / uint16, 4 for uint32 / int32; uint8's own K).  in_code the
// inputs' type before the split (kU8, kI16, kU16, kU32, kI32), out_code
// as mxu_wgmma's for int8.  Returns 0, a CUDA error code, -1 for arguments
// it does not take, or -2 for a tensor map cuTensorMapEncodeTiled refused.
extern "C" int mxu_wgmma_int(const void* a, const void* b, void* c, int64_t batch, int M, int N,
                             int K, int64_t lda, int64_t ldb, int64_t sa, int64_t sb, int in_code,
                             int out_code, int ep, const void* e0, const void* e1, int ep_code,
                             void* stream) {
  if (ep < 0 || ep >= kEpKinds || M < 1 || N < 1 || K < 1) return kUnsupported;
  if (batch < 1 || batch > INT_MAX || !engine_stores(out_code, true)) return kUnsupported;
  const MxuWgCall call{a,  b,  c, static_cast<int>(batch), M, N, K, lda, ldb, sa, sb,
                       0,  1,  out_code, EpArgs{e0, e1, ep_code, ep}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (in_code) {
    case kU8: return launch_mxu_wg_int<ByteWalk<1, false>>(call, st);
    case kI16: return launch_mxu_wg_int<ByteWalk<2, true>>(call, st);
    case kU16: return launch_mxu_wg_int<ByteWalk<2, false>>(call, st);
    case kU32:
    case kI32: return launch_mxu_wg_int<ByteWalk<4, false>>(call, st);
    default: return kUnsupported;
  }
}
