// Kernel B1 on the tile engine, bf16 inputs: the four layouts of
// csrc/mxu_wgmma.cuh in a translation unit of their own, so nvcc builds
// them beside the other types.
#include "mxu_wgmma.cuh"

namespace gemm_hls {

int launch_mxu_wg_bf16(const MxuWgCall& call, cudaStream_t st) {
  return launch_mxu_wg_16<__nv_bfloat16>(call, st);
}

}  // namespace gemm_hls
