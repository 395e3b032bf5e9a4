// Kernel B3 for bf16 inputs: every built-in semiring (log_plus included), on
// an fp32 accumulator, and the order semirings into a bf16 output on the
// packed tile (packed_gemm.cuh), in its own translation unit so it builds in
// parallel with the others.
#include "packed_gemm.cuh"

namespace gemm_hls {
template int dispatch_op<__nv_bfloat16, float>(int, const Gemm&, int64_t, cudaStream_t);
template int dispatch_packed<__nv_bfloat16>(int, const Gemm&, int64_t, cudaStream_t);
}  // namespace gemm_hls
