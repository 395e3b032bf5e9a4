// Kernels B1 and B2: dense plus_times GEMM on the tensor cores,
// C[z] (M, N) = epilogue(op(A[z]) . op(B[z])) for every batch entry z.
//
// Replaces two TPU kernels of gemm_hls_tpu/ops/pallas_mxu.py with one
// kernel family:
//   * _kernel (entry mxu_matmul, B1): the 2-D GEMM with its optional fused
//     per-column epilogue at the store (pallas_mxu.py:103-106); here
//     batch = 1.  The route rule sends every bf16 / fp16 / int8 / fp32 call
//     to the Hopper tile engine instead (csrc/mxu_wgmma.cuh, after the pack
//     pass csrc/operand_pack.cu or the TF32 split where its TMA maps cannot
//     read an operand in place), and every int16 / uint8 / uint16 / uint32
//     / int32 call too, as byte planes (csrc/mxu_wgmma_int.cu); this kernel
//     runs them where a caller names its route ("wmma", "simt": a tuned
//     winner, a comparison), and fp32 and the integers into float64 (and
//     the integers into int64) by the rule.
//   * _batched_kernel (entry mxu_matmul_batched, B2), plain and epilogue
//     variants: (B, M, K) x (B, K, N) with whole examples per grid step.
//     Here the batch is a grid axis (blockIdx.z, chunked past gridDim.z's
//     65535) and each operand carries a batch stride, 0 for a 2-D operand
//     broadcast over the batch, so no example is copied.  The TPU kernel
//     batched examples to amortise a per-grid-step latch; Hopper has none,
//     so one 128x128 C tile of one example per block is the whole design.
//     The batched calls run on the tile engine too (csrc/mxu_wgmma.cuh,
//     its batch as the engine's steps), by the same rule.  The row-wise
//     (softmax) epilogue variant, which needs whole rows in a block, is
//     csrc/row_softmax.cu.
// Same communication-avoiding schedule as the TPU kernels: one C tile stays
// in fast memory (here: registers) while K streams through.  On Hopper each
// 256-thread block owns one 128x128 C tile and loops over K itself; blocks
// carry nothing between them, so the TPU kernel's sequential K grid axis
// and its acc_ref scratch become this loop.
//
// Routes by input dtype (ops/mxu.py::mxu_route gives the engine to bf16,
// fp16, int8 and fp32 into the base types and to the other integers into
// all but float64 / int64; a caller may name this kernel):
//   bf16, fp16 -> tensor cores (WMMA 16x16x16), fp32 accumulator;
//   int8       -> tensor cores (WMMA 16x16x16), int32 accumulator;
//   fp32, int32 -> CUDA cores, IEEE fp32 FMA / wrapping int32
//                  (csrc/simt_gemm.cuh with the plus_times functor); this
//                  meets the reference's "high"/"highest" precision (fp32
//                  reaches it into float64, or named "simt"; int32 into
//                  float64 / int64, or named);
//   int16, uint8, uint16, uint32 -> the same CUDA-core tile on an int32
//                  accumulator (csrc/mxu_simt_int.cu; into float64 / int64,
//                  or named);
//   float64     -> csrc/dmma_gemm.cu (the FP64 tensor cores), its own entry.
// The tensor-core tile here ran, until the pack pass, the calls that the
// engine's TMA maps cannot read in place: int8 with an operand that is not
// K-major (int8 wgmma reads nothing else), and any operand whose base, row
// pitch or batch stride is not a whole 16-byte unit.  The engine now packs
// such an operand into a K-major workspace first; this tile takes any
// layout and pitch in place, where a caller names it.
// The epilogue (common.cuh) sees the fp32 accumulator before the output
// cast; an int32 accumulator is widened to fp32 for it.
//
// Layouts: A is (M, K) or, with ta, (K, M); B is (K, N) or, with tb,
// (N, K).  Each operand is read along its own contiguous axis, in 16-byte
// vectors where the row pitch, batch stride and base allow it, and written
// into shared memory as 16-deep K planes: element (o, k) of an operand tile
// sits at ((k / 16) * 128 + o) * LDP + k % 16.  A plane is a row-major
// matrix_a / column-major matrix_b for WMMA whatever the global layout, so
// no transpose is ever materialised, and every fragment pointer is 32-byte
// aligned (WMMA requires it; a flat int8 tile would put odd 16-column
// fragments at 16-byte offsets).  One exception, the main path's: a
// row-major 16-bit B keeps its natural [k][n] tile (see B_ROW).
//
// Ragged edges: the K tail of BOTH operands is zero-filled in shared memory,
// never loaded (0 * NaN garbage must not reach the sum; see
// pallas_mxu.py::_mask_k_tail); rows past M/N are zero-filled too and the
// store masks them.
//
// What bounds it on an H100: the tensor-core rate (bf16 8192^3: 1.1e12 FLOP
// at 989e12 FLOP/s, 1.11 ms), which WMMA cannot approach: it issues
// mma.sync, a quarter of wgmma's rate, from one shared buffer with two
// barriers per 32-deep K step and the next tile prefetched through
// registers, and stages C through shared memory one 16x16 fragment at a
// time.  Measured (H100 80GB HBM3, 700 W, chip_smoke.py): 6.01 ms at bf16
// 8192^3 while that shape ran here (the engine now takes it in 1.50 ms);
// B2 at 64 x 512^3 0.152 ms against torch.bmm's 0.042 while it ran here
// (the engine's time: PERF.md section 6).
#include "mxu_tc.cuh"

namespace gemm_hls {

// int16 and the unsigned ints on the CUDA cores (csrc/mxu_simt_int.cu).
int launch_mxu_simt_int(int in_code, const Gemm& g, int64_t batch, cudaStream_t s);

}  // namespace gemm_hls

using namespace gemm_hls;

// C (batch, M, N) row-major, written in ``out_code``'s dtype.  lda / ldb:
// the operands' row pitch; sa / sb: their batch stride (0 broadcasts a 2-D
// operand).  a_vec / b_vec: the operand's base is 16-byte aligned and its
// row pitch and batch stride whole 16-byte vectors (the tensor-core route
// then loads 16 bytes at a time).  ep: an EpKind (common.cuh) reading the
// (N,) operands e0 / e1 of dtype ep_code.  Returns 0, a CUDA error code
// from a launch, or -1 for an input dtype or epilogue not built.
extern "C" int mxu_gemm(const void* a, const void* b, void* c, int64_t batch, int M, int N, int K,
                        int64_t lda, int64_t ldb, int64_t sa, int64_t sb, int ta, int tb, int a_vec,
                        int b_vec, int in_code, int out_code, int ep, const void* e0,
                        const void* e1, int ep_code, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ep < 0 || ep >= kEpKinds) return kUnsupported;
  const Gemm g{a, b, c, M, N, K, lda, ldb, sa, sb, ta, tb, a_vec, b_vec, out_code,
               EpArgs{e0, e1, ep_code, ep}};
  switch (in_code) {
    case kBF16: return launch_tc<__nv_bfloat16>(g, batch, s);
    case kF16: return launch_tc<__half>(g, batch, s);
    case kI8: return launch_tc<signed char>(g, batch, s);
    case kF32: return launch_simt<float, float, PlusTimes<float>, true>(g, batch, s);
    case kI32: return launch_simt<int, int, PlusTimes<int>, true>(g, batch, s);
    case kI16:
    case kU8:
    case kU16:
    case kU32: return launch_mxu_simt_int(in_code, g, batch, s);
    default: return kUnsupported;
  }
}
