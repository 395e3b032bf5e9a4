// Kernel B3 for bf16 inputs: every built-in semiring (log_plus included), in
// its own translation unit so it builds in parallel with the others.
#include "semiring_ops.cuh"

namespace gemm_hls {
template int dispatch_op<__nv_bfloat16, float>(int, const Gemm&, int64_t, cudaStream_t);
}  // namespace gemm_hls
