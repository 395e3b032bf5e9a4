// Kernel B3: generic semiring GEMM, C[i,j] = reduce_k map(A[i,k], B[k,j]),
// over a batch axis (blockIdx.z) as well.
//
// Replaces the TPU kernel gemm_hls_tpu/ops/pallas_vpu.py::_vpu_kernel
// (entry vpu_matmul), and the jax.vmap over it that the JAX front door
// runs for a 3-D semiring call (gemm_hls_tpu/ops/matmul.py:618-626): here
// a batched call is one launch.  The TPU version materialises a (bm, ck,
// bn) mapped block on the VPU and folds it with a tree; here each thread
// folds its 8x8 C entries one K element at a time in registers
// (csrc/simt_gemm.cuh), on CUDA cores: the tensor cores only do (+, x).
//
// What bounds it on an H100: the CUDA-core issue rate.  A (map, reduce)
// pair such as min_plus costs two instructions per term (add, min); at
// 128 lanes x 132 SMs x ~1.98 GHz that is ~16.7e12 terms/s, i.e. a ceiling
// of 33.45 TOp/s counted as 2*M*N*K (models/perf_model.py's vpu_ops: 4.11
// ms at 4096^3).  Shared-memory reads (16 per 64 terms a
// thread) fit under that; device-memory traffic follows the io_volume law
// of a 128x128 tile and is far below the bandwidth bound at 4096^3.
// Left on the table by this simple design: no packed f16x2/bf16x2 math,
// no double-buffered shared memory, 8x8 register tiles read with scalar
// shared-memory loads.
//
// Each built-in semiring is a functor; ``op`` selects it and matches
// ``op_code`` in gemm_hls_tpu_torch/ops/semiring.py.  Inputs, each type
// instantiated in its own source (semiring_ops.cuh): f32, bf16 and f16
// (f32 accumulator; 16-bit inputs widen exactly), float64 (float64
// accumulator), and int32, int8, int16, uint8, uint16, uint32 and int64
// (int32 accumulator, each element widened or wrapped at the load as the
// reference's astype(int32) does, sums wrapping like the reference's).
// log_plus takes the floating types only.  The accumulator is cast to the
// output dtype at the store.
#include "semiring_ops.cuh"

namespace gemm_hls {

extern template int dispatch_op<float, float>(int, const Gemm&, int64_t, cudaStream_t);
extern template int dispatch_op<__nv_bfloat16, float>(int, const Gemm&, int64_t, cudaStream_t);
extern template int dispatch_op<__half, float>(int, const Gemm&, int64_t, cudaStream_t);
extern template int dispatch_op<double, double>(int, const Gemm&, int64_t, cudaStream_t);
extern template int dispatch_op<signed char, int>(int, const Gemm&, int64_t, cudaStream_t);
extern template int dispatch_op<short, int>(int, const Gemm&, int64_t, cudaStream_t);
extern template int dispatch_op<unsigned char, int>(int, const Gemm&, int64_t, cudaStream_t);
extern template int dispatch_op<unsigned short, int>(int, const Gemm&, int64_t, cudaStream_t);
extern template int dispatch_op<unsigned int, int>(int, const Gemm&, int64_t, cudaStream_t);
extern template int dispatch_op<long long, int>(int, const Gemm&, int64_t, cudaStream_t);

}  // namespace gemm_hls

using namespace gemm_hls;

// C (batch, M, N) row-major, written in ``out_code``'s dtype; A and B are
// read through their row pitch and batch stride (0 broadcasts a 2-D
// operand over the batch).  Returns 0, a CUDA error code from a launch, or
// -1 for a (dtype, op) pair not built.
extern "C" int semiring_gemm(const void* a, const void* b, void* c, int64_t batch, int M, int N,
                             int K, int64_t lda, int64_t ldb, int64_t sa, int64_t sb, int ta,
                             int tb, int in_code, int out_code, int op, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Gemm g{a, b, c, M, N, K, lda, ldb, sa, sb, ta, tb, 0, 0, out_code,
               EpArgs{nullptr, nullptr, 0, kEpNone}};
  if (op == kOrAndBits) {
    if (in_code == kI32) return launch_simt<int, int, OrAndBits>(g, batch, s);
    return kUnsupported;
  }
  switch (in_code) {
    case kF32: return dispatch_op<float, float>(op, g, batch, s);
    case kBF16: return dispatch_op<__nv_bfloat16, float>(op, g, batch, s);
    case kF16: return dispatch_op<__half, float>(op, g, batch, s);
    case kF64: return dispatch_op<double, double>(op, g, batch, s);
    case kI32: return dispatch_op<int, int>(op, g, batch, s);
    case kI8: return dispatch_op<signed char, int>(op, g, batch, s);
    case kI16: return dispatch_op<short, int>(op, g, batch, s);
    case kU8: return dispatch_op<unsigned char, int>(op, g, batch, s);
    case kU16: return dispatch_op<unsigned short, int>(op, g, batch, s);
    case kU32: return dispatch_op<unsigned int, int>(op, g, batch, s);
    case kI64: return dispatch_op<long long, int>(op, g, batch, s);
    default: return kUnsupported;
  }
}
