// Kernel B3 for float64 inputs: every built-in semiring (log_plus included),
// on a float64 accumulator, on the float64 tile (simt_gemm.cuh::
// simt_f64_kernel), in its own translation unit so it builds in parallel
// with the others.
#include "semiring_ops.cuh"

namespace gemm_hls {
template int dispatch_op<double, double>(int, const Gemm&, int64_t, cudaStream_t);
}  // namespace gemm_hls

// The K slices this library's float64 tiles ran in each form since the last
// reset, out[0] the Num form and out[1] the NaN-keeping one (full slices of
// the min / max semirings, summed over blocks); ``reset`` sets both to 0
// after the read.  Synchronises the device.  Returns 0 or a CUDA error.
extern "C" int semiring_f64_forms(unsigned long long* out, int reset) {
  int err = static_cast<int>(cudaMemcpyFromSymbol(out, gemm_hls::f64_forms, sizeof(gemm_hls::f64_forms)));
  if (!err && reset) {
    const unsigned long long zero[2] = {0, 0};
    err = static_cast<int>(cudaMemcpyToSymbol(gemm_hls::f64_forms, zero, sizeof(zero)));
  }
  return err;
}
