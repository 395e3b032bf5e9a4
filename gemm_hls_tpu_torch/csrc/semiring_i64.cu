// Kernel B3 for int64 inputs: every built-in semiring but log_plus, on an
// int32 accumulator (each element wrapped to its low 32 bits at the load), in
// its own translation unit so it builds in parallel with the others.
#include "semiring_ops.cuh"

namespace gemm_hls {
template int dispatch_op<long long, int>(int, const Gemm&, int64_t, cudaStream_t);
}  // namespace gemm_hls
