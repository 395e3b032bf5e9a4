// Kernel B3 for uint32 inputs: every built-in semiring but log_plus, on an
// int32 accumulator (each element wrapped to int32 at the load), in its own
// translation unit so it builds in parallel with the others.
#include "semiring_ops.cuh"

namespace gemm_hls {
template int dispatch_op<unsigned int, int>(int, const Gemm&, int64_t, cudaStream_t);
}  // namespace gemm_hls
