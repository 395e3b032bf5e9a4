// Kernel B3 for float64 inputs: every built-in semiring (log_plus included),
// on a float64 accumulator, in its own translation unit so it builds in
// parallel with the others.
#include "semiring_ops.cuh"

namespace gemm_hls {
template int dispatch_op<double, double>(int, const Gemm&, int64_t, cudaStream_t);
}  // namespace gemm_hls
