// Kernels B1 and B2's CUDA-core route for int16, uint8, uint16 and uint32
// inputs: plus_times on csrc/simt_gemm.cuh's tile, in its own translation
// unit so csrc/mxu_gemm.cu's build does not grow.
//
// The reference accumulates every integer input in int32
// (gemm_hls_tpu/config.py: jacc_dtype), its dot casting each operand with
// astype(int32) first: here each element is widened (or, for uint32,
// wrapped to int32) at the load (common.cuh::to_acc), the sums wrap modulo
// 2^32, and the store casts to the output type with the same wrap, applying
// the epilogue on the accumulator widened to fp32 as for int8 / int32
// inputs.  int8 keeps its tensor-core routes (csrc/mxu_gemm.cu, the tile
// engine); int64 has no kernel: the reference refuses int64 plus_times (an
// int32 accumulator narrower than its inputs), and so does the port.
// Each element is loaded alone, so 1- and 2-byte operands take any shape,
// pitch and alignment.
#include "simt_gemm.cuh"

namespace gemm_hls {

int launch_mxu_simt_int(int in_code, const Gemm& g, int64_t batch, cudaStream_t s) {
  switch (in_code) {
    case kI16: return launch_simt<short, int, PlusTimes<int>, true>(g, batch, s);
    case kU8: return launch_simt<unsigned char, int, PlusTimes<int>, true>(g, batch, s);
    case kU16: return launch_simt<unsigned short, int, PlusTimes<int>, true>(g, batch, s);
    case kU32: return launch_simt<unsigned int, int, PlusTimes<int>, true>(g, batch, s);
    default: return kUnsupported;
  }
}

}  // namespace gemm_hls
