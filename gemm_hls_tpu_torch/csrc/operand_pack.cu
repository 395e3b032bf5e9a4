// The pack pass of B1 / B2 on the tile engine (ops/mxu.py::pack_operand):
// one bf16, fp16 or int8 operand copied, as it is, into the layout the
// engine's K-major instantiation reads, (rows, kp) an example, kp = K
// rounded up to whole 16-byte units (8 values of 16 bits, 16 of int8),
// every value past K zero.  The operand comes in held (rows, K) or (K,
// rows), at any base, row pitch and batch stride; a batch read with a
// stride of 0 is packed once.  ops/mxu.py::pack_operand_plain is the same
// workspace, bit for bit.
//
// It replaces no TPU kernel: the TPU's Pallas kernel reads any pitch
// (gemm_hls_tpu/ops/pallas_mxu.py::mxu_matmul takes any shape in the one
// kernel, with no host-side copy), while the Hopper engine's TMA maps need
// 16-byte bases, row pitches and batch strides, and int8 wgmma reads
// K-major operands only.  The engine's launch packs only an operand that
// its maps cannot read in place (ops/mxu.py::_launch, config.py's
// packed_operands), so an unaligned bf16 / fp16 call or an int8 call in
// any layout runs on the engine after one such copy, not on the WMMA tile
// (csrc/mxu_tc.cuh) at about a quarter of its rate.
//
// What bounds it on an H100: bytes, one read and one write of the operand
// at 3.35 TB/s: bf16 8192 x 8190, 134 MB read and 134 MB written, 0.080 ms;
// int8 8192^2, 0.040 ms.  Its tile walk is csrc/operand_tile.cuh's, shared
// with the byte-plane split (csrc/int_split.cu): a block turns a square of
// 128-byte sides (64 x 64 16-bit values, 128 x 128 int8) through shared
// memory, a thread moving one 32-bit word (2 or 4 values), so a warp reads
// and writes whole 128-byte lines.
#include "operand_tile.cuh"

namespace gemm_hls {
namespace {

// Writes one word of values: out[z] is (rows, kp) of T.
template <typename T>
struct PackPut {
  T* out;
  int rows, kp;
  __device__ __forceinline__ void operator()(int z, int r, int kk, uint32_t word) const {
    T* o = out + (static_cast<int64_t>(z) * rows + r) * kp + kk;
    *reinterpret_cast<uint32_t*>(o) = word;
  }
};

template <typename T>
int pack(const void* x, void* out, int64_t batch, int rows, int k, int64_t ld, int64_t bs,
         int mn_major, int kp, cudaStream_t st) {
  return launch_operand_tile(static_cast<const T*>(x), batch, rows, k, ld, bs, mn_major != 0, kp,
                             PackPut<T>{static_cast<T*>(out), rows, kp}, st);
}

}  // namespace
}  // namespace gemm_hls

using namespace gemm_hls;

// x: ``esize``-byte values (2: bf16 / fp16, copied as bits; 1: int8),
// ``batch`` examples ``bs`` elements apart (bs ignored for a batch of
// one), each (rows, k) at row pitch ld, or (k, rows) with mn_major; out:
// (batch, rows, kp) contiguous and 16-byte aligned, kp >= k whole 16-byte
// units.  Returns 0, a CUDA error code, or -1 for arguments it does not
// take.
extern "C" int operand_pack(const void* x, void* out, int64_t batch, int rows, int k, int64_t ld,
                            int64_t bs, int mn_major, int kp, int esize, void* stream) {
  if (batch < 1 || batch > INT_MAX || rows < 1 || k < 1 || kp < k) return kUnsupported;
  if (!(esize == 1 || esize == 2) || (kp * esize) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return kUnsupported;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return esize == 2 ? pack<unsigned short>(x, out, batch, rows, k, ld, bs, mn_major, kp, st)
                    : pack<unsigned char>(x, out, batch, rows, k, ld, bs, mn_major, kp, st);
}
