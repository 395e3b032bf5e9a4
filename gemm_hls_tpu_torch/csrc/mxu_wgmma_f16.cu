// Kernel B1 on the tile engine, fp16 inputs: the four layouts of
// csrc/mxu_wgmma.cuh in a translation unit of their own, so nvcc builds
// them beside the other types.
#include "mxu_wgmma.cuh"

namespace gemm_hls {

int launch_mxu_wg_f16(const MxuWgCall& call, cudaStream_t st) {
  return launch_mxu_wg_16<__half>(call, st);
}

}  // namespace gemm_hls
