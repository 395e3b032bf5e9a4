// Kernel B3 for f16 inputs: every built-in semiring (log_plus included), on
// an fp32 accumulator, in its own translation unit so it builds in parallel
// with the others.
#include "semiring_ops.cuh"

namespace gemm_hls {
template int dispatch_op<__half, float>(int, const Gemm&, int64_t, cudaStream_t);
}  // namespace gemm_hls
