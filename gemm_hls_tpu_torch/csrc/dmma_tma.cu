// Kernels B1 and B2 for float64 on the Hopper tile (csrc/dmma_tma.cuh: TMA,
// a producer thread and two consumer warpgroups on mma.sync .f64,
// persistent blocks): the four layouts of the built-in tile, in a
// translation unit of its own so it builds beside csrc/dmma_gemm.cu.
#include "dmma_tma.cuh"

using namespace gemm_hls;

// dmma_gemm's arguments less the vector flags: every operand is one a TMA
// map describes (16-byte base, row pitch and batch stride), which the
// wrapper's route rule guarantees.  Returns 0, a CUDA error code, -1 for
// inputs that are not float64, an epilogue not built or a batch past
// INT_MAX, or -2 for a tensor map cuTensorMapEncodeTiled refused.
extern "C" int dmma_tma_gemm(const void* a, const void* b, void* c, int64_t batch, int M, int N,
                             int K, int64_t lda, int64_t ldb, int64_t sa, int64_t sb, int ta,
                             int tb, int in_code, int out_code, int ep, const void* e0,
                             const void* e1, int ep_code, void* stream) {
  if (in_code != kF64 || ep < 0 || ep >= kEpKinds) return kUnsupported;
  const Gemm g{a, b, c, M, N, K, lda, ldb, sa, sb, ta, tb, 1, 1, out_code,
               EpArgs{e0, e1, ep_code, ep}};
  return launch_dmma_tma_any(g, batch, static_cast<cudaStream_t>(stream));
}
