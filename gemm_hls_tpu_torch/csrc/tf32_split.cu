// The split pass of B1 / B2's fp32 route on the tile engine
// (ops/mxu.py::tf32_operand): every value x of one operand becomes
//   hi = x rounded to TF32 (10 mantissa bits, to nearest, ties to even; a
//        finite x whose rounding would overflow is cut toward zero instead,
//        so hi stays finite; NaN stays NaN, made quiet; +-inf stays +-inf),
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
//
// The source is fp32, bfloat16 or float16 (one entry point each).  A
// 16-bit value widened to fp32 (the conversion PyTorch's ``.float()`` runs
// on the card) is its own TF32 value: hi is the value (a NaN made quiet)
// and lo is 0.  So a 16-bit operand is read at 2 bytes a value, never
// promoted first, and its workspace is bit for bit the one its fp32
// promotion gives.  ops/mxu.py::tf32_operand_plain is the same workspace,
// built by integer operations on the fp32 bits, bit for bit.
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
// segs fp32 values: fp32 at 8192^2, one segment, 0.27 GB read and 0.27 GB
// written, 0.160 ms at 3.35 TB/s; three segments 0.321 ms; a bf16 source,
// one segment, 0.134 + 0.268 GB, 0.120 ms.  So every store is 16 bytes a
// thread and every access of a warp whole 32-byte sectors, and nothing
// passes through shared memory:
//   * a source held (rows, K) (A (M, K), B (N, K)) streams: a thread loads
//     4 values along K (16 bytes of fp32, 8 of a 16-bit type) and stores
//     them as 16 bytes a segment; a row's threads are consecutive, so a
//     warp reads and writes whole lines (a 16-byte load of 8 16-bit values
//     made each of a warp's stores cover every other 16 bytes of its
//     lines: 18.7% of the bound on an H100 80GB HBM3 at 700 W);
//   * a source held (K, rows) (B (K, N), the weights' usual layout) is
//     turned in registers: a thread loads 16 bytes of each of 4 consecutive
//     K-rows (V = 4 or 8 rows of the operand) and stores each of those V
//     rows' 4 K values as one 16-byte store a segment.  Lane l takes K
//     group l % 8 and row group l / 8, so 4 lanes load 64 contiguous bytes
//     of a K-row and 8 lanes store 128 contiguous bytes of a workspace row
//     (the pass before moved one 32-bit word a thread through a 32 x 32
//     shared tile, csrc/operand_tile.cuh, and stored segs scalars: 39% of
//     its bound at one segment on an H100 80GB HBM3 at 700 W).
// A base, row pitch or batch stride off 16 bytes, a row group cut by the
// last row and the K tail take scalar loads at that thread; every store is
// 16 bytes (kp is a multiple of 4 and the workspace 16-byte aligned).
#include <cstring>
#include <type_traits>

#include "common.cuh"

namespace gemm_hls {
namespace {

constexpr int kSplitThreads = 256;

// The three source types, read as bits and widened to fp32.
struct SrcF32 {
  using Bits = uint32_t;
  static __device__ __forceinline__ float widen(uint32_t b) { return __uint_as_float(b); }
};
struct SrcBF16 {
  using Bits = uint16_t;
  static __device__ __forceinline__ float widen(uint16_t b) {
    return __bfloat162float(__ushort_as_bfloat16(b));
  }
};
struct SrcF16 {
  using Bits = uint16_t;
  static __device__ __forceinline__ float widen(uint16_t b) {
    return __half2float(__ushort_as_half(b));
  }
};

// TF32 bits of the fp32 bits u: round to nearest even at bit 13, the low
// 13 bits cleared; a rounding that reaches the all-ones exponent is a
// truncation instead; a NaN keeps its sign and is made quiet.
__device__ __forceinline__ uint32_t tf32_bits(uint32_t u) {
  if ((u & 0x7F800000u) == 0x7F800000u)
    return (u & 0x007FFFFFu) ? ((u | 0x00400000u) & ~0x1FFFu) : u;
  const uint32_t r = (u + 0xFFFu + ((u >> 13) & 1u)) & ~0x1FFFu;
  return (r & 0x7F800000u) == 0x7F800000u ? (u & ~0x1FFFu) : r;
}

// hi, lo, and the hi a cross term reads (0 where x is +-inf or NaN) of
// one source value.
template <typename S>
__device__ __forceinline__ void split(typename S::Bits b, float& hi, float& lo,
                                      float& hi_cross) {
  const float x = S::widen(b);
  const uint32_t u = __float_as_uint(x);
  const bool special = (u & 0x7F800000u) == 0x7F800000u;
  hi = __uint_as_float(tf32_bits(u));
  if constexpr (sizeof(typename S::Bits) == 4)
    lo = special ? 0.f : __uint_as_float(tf32_bits(__float_as_uint(__fsub_rn(x, hi))));
  else
    lo = 0.f;  // a widened 16-bit value is its own TF32 value: x - hi is 0
  hi_cross = special ? 0.f : hi;
}

// Writes the segments of 4 consecutive K values of one row, one 16-byte
// store each: o is segment 0's first value, segment s is s kp further.
template <typename S, int SEGS>
__device__ __forceinline__ void put4(float* o, int kp, int lo_seg,
                                     const typename S::Bits* v) {
  float4 hi, lo, cross;
  split<S>(v[0], hi.x, lo.x, cross.x);
  split<S>(v[1], hi.y, lo.y, cross.y);
  split<S>(v[2], hi.z, lo.z, cross.z);
  split<S>(v[3], hi.w, lo.w, cross.w);
  *reinterpret_cast<float4*>(o) = hi;
  if constexpr (SEGS == 3) {
    *reinterpret_cast<float4*>(o + kp) = lo_seg == 1 ? lo : cross;
    *reinterpret_cast<float4*>(o + 2 * static_cast<int64_t>(kp)) = lo_seg == 1 ? cross : lo;
  }
}

// The N values at p (8 or 16 bytes), the first ``valid`` of them (the
// rest 0): one vector load where all N are wanted and p is aligned to
// their size, else scalar loads of the wanted ones.
template <int N, typename B>
__device__ __forceinline__ void load_run(const B* p, int valid, B (&v)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(B));
  static_assert(kBytes == 8 || kBytes == 16, "a run is 8 or 16 bytes");
  using Vec = typename std::conditional<kBytes == 16, uint4, uint2>::type;
  if (valid >= N && (reinterpret_cast<uintptr_t>(p) & (kBytes - 1)) == 0) {
    const Vec w = __ldg(reinterpret_cast<const Vec*>(p));
    memcpy(v, &w, kBytes);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = j < valid ? p[j] : B(0);
  }
}

// A source held (rows, K).  Grid: (row blocks, examples), both walked in
// strides; a block is 2^(8 - tpr_log2) rows of 2^tpr_log2 threads, a
// thread walking its row's groups of 4 values tpr apart.
template <typename S, int SEGS>
__global__ void __launch_bounds__(kSplitThreads)
    tf32_split_kmajor_kernel(const typename S::Bits* __restrict__ x, float* __restrict__ out,
                             int batch, int rows, int k, int64_t ld, int64_t bs, int kp,
                             int lo_seg, int tpr_log2) {
  using B = typename S::Bits;
  const int groups = kp / 4, tpr = 1 << tpr_log2;
  const int rpb = kSplitThreads >> tpr_log2, lane = threadIdx.x & (tpr - 1);
  const int64_t kw = static_cast<int64_t>(SEGS) * kp;
  for (int z = blockIdx.y; z < batch; z += gridDim.y) {
    for (int64_t r = static_cast<int64_t>(blockIdx.x) * rpb + (threadIdx.x >> tpr_log2);
         r < rows; r += static_cast<int64_t>(gridDim.x) * rpb) {
      const B* xr = x + z * bs + r * ld;
      float* o = out + (static_cast<int64_t>(z) * rows + r) * kw;
#pragma unroll 2
      for (int g = lane; g < groups; g += tpr) {
        B v[4];
        load_run(xr + 4 * g, k - 4 * g, v);
        put4<S, SEGS>(o + 4 * g, kp, lo_seg, v);
      }
    }
  }
}

// A source held (K, rows).  Grid: (K tiles of 32, row tiles of 32 V,
// examples), the last two walked in strides; warp w's lane l turns K
// values 4 (l % 8) .. + 3 of the tile for rows (4 w + l / 8) V .. + V - 1.
template <typename S, int SEGS>
__global__ void __launch_bounds__(kSplitThreads)
    tf32_split_mn_kernel(const typename S::Bits* __restrict__ x, float* __restrict__ out,
                         int batch, int rows, int k, int64_t ld, int64_t bs, int kp,
                         int lo_seg) {
  using B = typename S::Bits;
  constexpr int V = 16 / static_cast<int>(sizeof(B));
  constexpr int kTileR = (kSplitThreads / 8) * V;
  const int lane = threadIdx.x & 31;
  const int kk = blockIdx.x * 32 + 4 * (lane & 7);
  if (kk >= kp) return;
  const int r_in = ((threadIdx.x >> 5) * 4 + (lane >> 3)) * V;
  const int64_t kw = static_cast<int64_t>(SEGS) * kp;
  const int row_tiles = (rows + kTileR - 1) / kTileR;
  for (int z = blockIdx.z; z < batch; z += gridDim.z) {
    for (int rt = blockIdx.y; rt < row_tiles; rt += gridDim.y) {
      const int r0 = rt * kTileR + r_in;
      if (r0 >= rows) continue;
      const int valid = min(V, rows - r0);
      B v[4][V];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        load_run(x + z * bs + static_cast<int64_t>(kk + j) * ld + r0, kk + j < k ? valid : 0,
                 v[j]);
      float* o = out + (static_cast<int64_t>(z) * rows + r0) * kw + kk;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (i < valid) {
          const B col[4] = {v[0][i], v[1][i], v[2][i], v[3][i]};
          put4<S, SEGS>(o + i * kw, kp, lo_seg, col);
        }
      }
    }
  }
}

template <typename S, int SEGS>
void launch(const typename S::Bits* x, float* out, int batch, int rows, int k, int64_t ld,
            int64_t bs, bool mn_major, int kp, int lo_seg, cudaStream_t st) {
  constexpr int V = 16 / static_cast<int>(sizeof(typename S::Bits));
  const unsigned gz = static_cast<unsigned>(batch < kMaxGridZ ? batch : kMaxGridZ);
  if (mn_major) {
    constexpr int kTileR = (kSplitThreads / 8) * V;
    const int row_tiles = (rows + kTileR - 1) / kTileR;
    const dim3 grid(static_cast<unsigned>((kp + 31) / 32),
                    static_cast<unsigned>(row_tiles < kMaxGridZ ? row_tiles : kMaxGridZ), gz);
    tf32_split_mn_kernel<S, SEGS><<<grid, kSplitThreads, 0, st>>>(x, out, batch, rows, k, ld,
                                                                  bs, kp, lo_seg);
  } else {
    // The fewest threads a row (a power of two, up to the block) that cover
    // its groups of 4 values at once.
    const int groups = kp / 4;
    int tpr_log2 = 0;
    while ((1 << tpr_log2) < groups && (1 << tpr_log2) < kSplitThreads) ++tpr_log2;
    const int64_t rpb = kSplitThreads >> tpr_log2, blocks = (rows + rpb - 1) / rpb;
    const dim3 grid(static_cast<unsigned>(blocks < INT_MAX ? blocks : INT_MAX), gz);
    tf32_split_kmajor_kernel<S, SEGS><<<grid, kSplitThreads, 0, st>>>(
        x, out, batch, rows, k, ld, bs, kp, lo_seg, tpr_log2);
  }
}

template <typename S>
int split_pass(const void* x, void* out, int64_t batch, int rows, int k, int64_t ld, int64_t bs,
               int mn_major, int kp, int segs, int lo_seg, void* stream) {
  if (batch < 1 || batch > INT_MAX || rows < 1 || k < 1 || kp < k || kp % 4) return kUnsupported;
  if (!(segs == 1 && lo_seg < 0) && !(segs == 3 && (lo_seg == 1 || lo_seg == 2)))
    return kUnsupported;
  const auto* src = static_cast<const typename S::Bits*>(x);
  auto* dst = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const int nb = static_cast<int>(batch);
  if (segs == 1)
    launch<S, 1>(src, dst, nb, rows, k, ld, bs, mn_major != 0, kp, lo_seg, st);
  else
    launch<S, 3>(src, dst, nb, rows, k, ld, bs, mn_major != 0, kp, lo_seg, st);
  return last_error();
}

}  // namespace
}  // namespace gemm_hls

using namespace gemm_hls;

// x: fp32 (tf32_split), bfloat16 (tf32_split_bf16) or float16
// (tf32_split_f16) values, ``batch`` examples ``bs`` elements apart (bs
// ignored for a batch of one), each (rows, k) at row pitch ld, or (k, rows)
// with mn_major, at any base, pitch and batch stride; out: (batch, rows,
// segs * kp) fp32, contiguous and 16-byte aligned, kp >= k a multiple of 4
// (rows of whole 16-byte units, what the engine's TMA maps take).  segs: 1
// (hi) or 3 (segment lo_seg, 1 or 2, holds lo, segment 3 - lo_seg hi with
// +-inf and NaN written as 0, segment 0 hi).  Returns 0, a CUDA error
// code, or -1 for arguments it does not take.
extern "C" int tf32_split(const void* x, void* out, int64_t batch, int rows, int k, int64_t ld,
                          int64_t bs, int mn_major, int kp, int segs, int lo_seg, void* stream) {
  return split_pass<SrcF32>(x, out, batch, rows, k, ld, bs, mn_major, kp, segs, lo_seg, stream);
}

extern "C" int tf32_split_bf16(const void* x, void* out, int64_t batch, int rows, int k,
                               int64_t ld, int64_t bs, int mn_major, int kp, int segs,
                               int lo_seg, void* stream) {
  return split_pass<SrcBF16>(x, out, batch, rows, k, ld, bs, mn_major, kp, segs, lo_seg, stream);
}

extern "C" int tf32_split_f16(const void* x, void* out, int64_t batch, int rows, int k,
                              int64_t ld, int64_t bs, int mn_major, int kp, int segs, int lo_seg,
                              void* stream) {
  return split_pass<SrcF16>(x, out, batch, rows, k, ld, bs, mn_major, kp, segs, lo_seg, stream);
}
