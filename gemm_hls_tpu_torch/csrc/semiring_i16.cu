// Kernel B3 for int16 inputs: every built-in semiring but log_plus, on an
// int32 accumulator, in its own translation unit so it builds in parallel
// with the others.
#include "semiring_ops.cuh"

namespace gemm_hls {
template int dispatch_op<short, int>(int, const Gemm&, int64_t, cudaStream_t);
}  // namespace gemm_hls
