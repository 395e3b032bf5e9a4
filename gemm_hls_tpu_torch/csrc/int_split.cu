// The split pass of B1 / B2's integers on the tile engine
// (ops/mxu.py::int_split_operand): one int16, uint16, uint32 or int32
// operand cut into its bytes, written K-major as byte planes, lowest byte
// first: (rows, planes * kp) an example, plane i of a row at [i kp, (i + 1)
// kp), kp = K rounded up to the engine's 128-deep K step, every byte past
// K zero, so a plane's rows are whole K steps and no stage reads into the
// next plane.  2 planes for the 16-bit types, 4 for the 32-bit ones.  The
// bytes are the value's bit pattern; how a plane is read (.u8, or .s8 for
// int16's high byte) is the engine's (csrc/wgmma_tile.cuh, ByteWalk), so
// int32 and uint32 give the same planes.  The operand comes in held (rows,
// K) or (K, rows), at any base, row pitch and batch stride; a batch read
// with a stride of 0 is split once.  ops/mxu.py::int_split_operand_plain
// is the same workspace, bit for bit.
//
// It replaces no TPU kernel: the TPU's Pallas kernel multiplies these types
// in its int32 dot (gemm_hls_tpu/ops/pallas_mxu.py::_kernel), while Hopper's
// tensor cores take 8-bit integers only: the split turns one int32 sum
// into byte products, once an operand, not once a tile or a pair.
//
// What bounds it on an H100: bytes.  It reads each value once and writes
// its planes: at 4096^2 int32, 67 MB read and 67 MB written, 0.040 ms at
// 3.35 TB/s (int16: 34 + 34 MB, 0.020 ms).  Its tile walk is
// csrc/operand_tile.cuh's (one 128-byte-sided square a block through shared
// memory), which the pack and TF32 split passes share.
#include "operand_tile.cuh"

namespace gemm_hls {
namespace {

// Writes one word's values into their planes: out[z] is (rows, P kp) of
// bytes.  A 16-bit word holds two values (bytes 0 1 and 2 3): plane 0 gets
// bytes 0 and 2, plane 1 bytes 1 and 3, two bytes a store; a 32-bit word
// one value, a byte to each of the four planes.
template <typename T>
struct PlanePut {
  unsigned char* out;
  int rows, kp;
  __device__ __forceinline__ void operator()(int z, int r, int kk, uint32_t word) const {
    constexpr int P = sizeof(T);
    unsigned char* o = out + (static_cast<int64_t>(z) * rows + r) * (P * kp) + kk;
    if constexpr (P == 2) {
      *reinterpret_cast<uint16_t*>(o) = static_cast<uint16_t>(__byte_perm(word, 0, 0x20));
      *reinterpret_cast<uint16_t*>(o + kp) = static_cast<uint16_t>(__byte_perm(word, 0, 0x31));
    } else {
#pragma unroll
      for (int i = 0; i < P; ++i)
        o[static_cast<int64_t>(i) * kp] = static_cast<unsigned char>(word >> (8 * i));
    }
  }
};

template <typename T>
int split(const void* x, void* out, int64_t batch, int rows, int k, int64_t ld, int64_t bs,
          int mn_major, int kp, cudaStream_t st) {
  return launch_operand_tile(static_cast<const T*>(x), batch, rows, k, ld, bs, mn_major != 0, kp,
                             PlanePut<T>{static_cast<unsigned char*>(out), rows, kp}, st);
}

}  // namespace
}  // namespace gemm_hls

using namespace gemm_hls;

// x: ``esize``-byte integers (2: int16 / uint16, 4: uint32 / int32, read as
// bits), ``batch`` examples ``bs`` elements apart (bs ignored for a batch
// of one), each (rows, k) at row pitch ld, or (k, rows) with mn_major;
// out: (batch, rows, esize * kp) bytes, contiguous and 16-byte aligned,
// kp >= k a multiple of 128.  Returns 0, a CUDA error code, or -1 for
// arguments it does not take.
extern "C" int int_split(const void* x, void* out, int64_t batch, int rows, int k, int64_t ld,
                         int64_t bs, int mn_major, int kp, int esize, void* stream) {
  if (batch < 1 || batch > INT_MAX || rows < 1 || k < 1 || kp < k || kp % 128) return kUnsupported;
  if (!(esize == 2 || esize == 4) || reinterpret_cast<uintptr_t>(out) % 16) return kUnsupported;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return esize == 2 ? split<unsigned short>(x, out, batch, rows, k, ld, bs, mn_major, kp, st)
                    : split<unsigned int>(x, out, batch, rows, k, ld, bs, mn_major, kp, st);
}
