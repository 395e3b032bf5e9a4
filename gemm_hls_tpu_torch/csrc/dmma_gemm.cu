// Kernels B1 and B2 for float64: dense plus_times GEMM on the FP64 tensor
// cores, C[z] (M, N) = epilogue(op(A[z]) . op(B[z])) for every batch entry z.
//
// Replaces, for float64 operands, the two TPU kernels of
// gemm_hls_tpu/ops/pallas_mxu.py that csrc/mxu_gemm.cu replaces for the
// other types: _kernel (entry mxu_matmul, B1, batch = 1) and
// _batched_kernel (entry mxu_matmul_batched, B2), each with its optional
// per-column epilogue at the store (pallas_mxu.py:103-106).  The TPU has no
// float64 unit (Mosaic refuses it, so the JAX front door sends float64 to
// XLA's emulation there); Hopper has float64 tensor cores (DMMA), so the
// card runs the reference's float64 GEMM as a kernel with a float64
// accumulator, IEEE double FMA, the same numbers as a float64 BLAS up to
// the order of the sums.
//
// Same schedule as the TPU kernels: one C tile stays in fast memory (here
// registers: a 128 x 128 tile of doubles over 256 threads, 64 each) while K
// streams through; the TPU kernel's sequential K grid axis and its acc_ref
// scratch become the loop over K inside the block.  The batch is a grid
// axis (blockIdx.z, chunked past gridDim.z's 65535); each operand carries a
// batch stride, 0 for a 2-D operand broadcast over the batch.
//
// The tile: 8 warps as 2 x 4, each warp 64 x 32 of C as 4 x 4 products of
// mma.sync m16n8k4 .f64 (sm_90; wgmma has no f64 form), its fragments read
// from shared memory.  sm_80's m8n8k4 issues at half the rate of the sm_90
// shapes on an H100: the same tile on it took 1.6x as long at 8192^3
// (PERF.md section 6); m16n8k8 / k16 hold larger fragments, which spill
// in this tile.  A and B K-slices of 16 doubles come
// in through cp.async into a ring of STAGES shared-memory stages, 16-byte
// copies where the operand's base, row pitch and batch stride are whole
// 16-byte units (a_vec / b_vec), 8-byte copies otherwise.  Each operand
// keeps its global orientation in shared memory (no transpose is
// materialised): a K-contiguous operand as [o][k] rows of DBK + 4 doubles,
// the other as [k][o] rows of DBM + 4.  The pads make a fragment read
// conflict-free: the 16 lanes of a half warp, (g, t) = (lane / 4, lane %
// 4) reading element (o0 + g, k0 + t) of a fragment, fall on 16 distinct 8-byte bank
// pairs in either layout (4g + t, resp. 4t + g, modulo 16).
//
// Ragged edges: the K tail of BOTH operands and the rows past M / N are
// zero-filled in shared memory by the copies' source size (nothing past
// the operand is read, so 0 * NaN garbage never reaches a sum; see
// pallas_mxu.py::_mask_k_tail); the store masks rows and columns past M /
// N.  The epilogue is common.cuh's in double (exp / tanh in double
// precision, each product and sum rounded on its own), reading its (N,)
// operands in their own type, widened exactly.
//
// What bounds it on an H100: the FP64 tensor-core rate, 67e12 FLOP/s (data
// sheet; 8192^3 is 1.1e12 FLOP, 16.4 ms), far above its bytes (three 512 MB
// matrices at 3.35e12 B/s: 0.48 ms).  This simple design runs one block of
// 8 warps a SM (64 doubles of accumulator a thread, 254 registers); deeper
// reuse and more warps in flight are left for a later redesign.  Times:
// PERF.md section 6.
#include "dmma_gemm.cuh"

using namespace gemm_hls;

// mxu_gemm's arguments for float64 operands: C (batch, M, N) row-major in
// ``out_code``'s dtype; lda / ldb the operands' row pitch, sa / sb their
// batch stride (0 broadcasts a 2-D operand); a_vec / b_vec: the operand's
// base is 16-byte aligned and its row pitch and batch stride whole 16-byte
// units (16-byte copies).  ep: an EpKind reading the (N,) operands e0 / e1
// of dtype ep_code (f64, f32, bf16 or f16).  Returns 0, a CUDA error code,
// or -1 for inputs that are not float64 or an epilogue not built.
extern "C" int dmma_gemm(const void* a, const void* b, void* c, int64_t batch, int M, int N, int K,
                         int64_t lda, int64_t ldb, int64_t sa, int64_t sb, int ta, int tb,
                         int a_vec, int b_vec, int in_code, int out_code, int ep, const void* e0,
                         const void* e1, int ep_code, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_code != kF64 || ep < 0 || ep >= kEpKinds) return kUnsupported;
  const Gemm g{a, b, c, M, N, K, lda, ldb, sa, sb, ta, tb, a_vec, b_vec, out_code,
               EpArgs{e0, e1, ep_code, ep}};
  const bool a_kc = !ta, b_kc = tb;
  if (a_kc && b_kc) return launch_dmma<true, true>(g, batch, s);
  if (a_kc) return launch_dmma<true, false>(g, batch, s);
  if (b_kc) return launch_dmma<false, true>(g, batch, s);
  return launch_dmma<false, false>(g, batch, s);
}
