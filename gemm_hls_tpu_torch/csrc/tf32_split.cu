// The split pass of B1 / B2's fp32 route on the tile engine
// (ops/mxu.py::tf32_operand): every fp32 value x of one operand becomes
//   hi = x rounded to TF32 (10 mantissa bits, to nearest, ties to even; a
//        finite x whose rounding would overflow is cut toward zero instead,
//        so hi stays finite; NaN stays NaN, +-inf stays +-inf),
//   lo = (x - hi) rounded the same way (x - hi is exact in fp32; lo is 0
//        where x is +-inf or NaN),
// written K-major, (rows, segs * kp) an example, segment s of a row holding
// hi or, for s == lo_seg, lo, every value past K zero.  The engine
// (csrc/mxu_wgmma_tf32.cu) then multiplies two such workspaces as one
// K-major TF32 GEMM over segs * kp: one segment (hi) is the reference's
// Precision.DEFAULT; three, A [hi | hi | lo] against B [hi | lo | hi], are
// hi.hi + hi.lo + lo.hi in one fp32 accumulator (HIGHEST's fp32 accuracy,
// the lo.lo term dropped).  Of three segments, the hi that meets the other
// operand's lo (A's segment 1, B's segment 2) holds 0 where x is +-inf or
// NaN: only hi.hi carries them, so an infinite x gives the IEEE product's
// +-inf, not inf . 0 or inf - inf (NaN) from the cross terms.
// ops/mxu.py::tf32_operand_plain is the same workspace, built by integer
// operations on the fp32 bits, bit for bit.
//
// It replaces no TPU kernel: the TPU's MXU splits fp32 into bf16 passes
// inside its dot (gemm_hls_tpu/ops/pallas_mxu.py::_kernel at DEFAULT or
// HIGHEST).  On Hopper the split is a pass of its own because wgmma's
// .tf32 operands are K-major only (the transpose bit is for 16-bit types)
// and wgmma would truncate raw fp32 bits (twice the error, biased): the
// rounding and the turn of an MN-major operand happen here, once an
// operand, not once a tile.
//
// What bounds it on an H100: bytes.  It reads each value once and writes
// segs values: at 8192^2, three segments, 0.27 GB read and 0.81 GB
// written, 0.32 ms at 3.35 TB/s.  Its tile walk is csrc/operand_tile.cuh's
// (one 32 x 32 tile a block through shared memory: an MN-major operand is
// read along M or N and written along K; a K-major one passes straight
// through the same tile), which csrc/operand_pack.cu shares.
#include "operand_tile.cuh"

namespace gemm_hls {
namespace {

// TF32 bits of the fp32 bits u: round to nearest even at bit 13, the low
// 13 bits cleared; a rounding that reaches the all-ones exponent is a
// truncation instead; a NaN keeps its sign and is made quiet.
__device__ __forceinline__ uint32_t tf32_bits(uint32_t u) {
  if ((u & 0x7F800000u) == 0x7F800000u)
    return (u & 0x007FFFFFu) ? ((u | 0x00400000u) & ~0x1FFFu) : u;
  const uint32_t r = (u + 0xFFFu + ((u >> 13) & 1u)) & ~0x1FFFu;
  return (r & 0x7F800000u) == 0x7F800000u ? (u & ~0x1FFFu) : r;
}

// hi, lo, and the hi a cross term reads (0 where x is +-inf or NaN).
__device__ __forceinline__ void split(float x, float& hi, float& lo, float& hi_cross) {
  const uint32_t u = __float_as_uint(x);
  const bool special = (u & 0x7F800000u) == 0x7F800000u;
  hi = __uint_as_float(tf32_bits(u));
  lo = special ? 0.f : __uint_as_float(tf32_bits(__float_as_uint(__fsub_rn(x, hi))));
  hi_cross = special ? 0.f : hi;
}

// Writes one value's segments: out[z] is (rows, segs * kp).
struct SplitPut {
  float* out;
  int rows, kp, segs, lo_seg;
  __device__ __forceinline__ void operator()(int z, int r, int kk, uint32_t word) const {
    const int64_t kw = static_cast<int64_t>(segs) * kp;
    const int cross_seg = segs == 3 ? 3 - lo_seg : -1;  // the hi facing the other's lo
    float hi, lo, hi_cross;
    split(__uint_as_float(word), hi, lo, hi_cross);  // 0 past K: every part 0
    float* o = out + (static_cast<int64_t>(z) * rows + r) * kw + kk;
    for (int s = 0; s < segs; ++s)
      o[static_cast<int64_t>(s) * kp] = s == lo_seg ? lo : s == cross_seg ? hi_cross : hi;
  }
};

}  // namespace
}  // namespace gemm_hls

using namespace gemm_hls;

// x: fp32, ``batch`` examples ``bs`` elements apart (bs ignored for a batch
// of one), each (rows, k) at row pitch ld, or (k, rows) with mn_major;
// out: (batch, rows, segs * kp) contiguous, kp >= k a multiple of 4 (rows
// of whole 16-byte units, what the engine's TMA maps take).  segs: 1 (hi)
// or 3 (segment lo_seg, 1 or 2, holds lo, segment 3 - lo_seg hi with +-inf
// and NaN written as 0, segment 0 hi).  Returns 0, a CUDA error
// code, or -1 for arguments it does not take.
extern "C" int tf32_split(const void* x, void* out, int64_t batch, int rows, int k, int64_t ld,
                          int64_t bs, int mn_major, int kp, int segs, int lo_seg, void* stream) {
  if (batch < 1 || batch > INT_MAX || rows < 1 || k < 1 || kp < k || kp % 4) return kUnsupported;
  if (!(segs == 1 && lo_seg < 0) && !(segs == 3 && (lo_seg == 1 || lo_seg == 2)))
    return kUnsupported;
  return launch_operand_tile(static_cast<const float*>(x), batch, rows, k, ld, bs, mn_major != 0,
                             kp, SplitPut{static_cast<float*>(out), rows, kp, segs, lo_seg},
                             static_cast<cudaStream_t>(stream));
}
