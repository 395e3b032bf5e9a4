// Kernel grouped_update: the weight gradient of the ragged grouped GEMM of a
// mixture-of-experts FFN, out[g] = lhs[rows(g)]^T . gbar[rows(g)] for every
// group g: (M, K) and (M, N) in, (G, K, N) out, summed in fp32, with rows(g)
// the span [ends[g-1], ends[g]) of the clamped device-side group ends (the
// row partition of csrc/grouped_gemm.cu).
//
// Replaces gemm_hls_tpu/ops/pallas_grouped.py::_tgmm_kernel (B17).  The TPU
// kernel walked (K tile, N tile, logical tile) with the logical tiles
// innermost and carried a group's sum in a VMEM-resident block from one grid
// step to the next.  Hopper blocks run in no order and carry nothing, so
// here one block owns one (N tile, K tile, group) output block: it reads its
// group's row span from the ends, loops over the span in chunks of rows,
// sums in registers and writes its block once.  No atomics: two launches
// give the same bits.  A group with no rows stores zeros.  Rows outside the
// span are zero-filled in the shared tile (never multiplied by a mask: 0 x
// NaN is NaN), so a stale NaN row reaches no output.
//
// Routes by element type: bf16 / fp16 -> tensor cores (mma.sync m16n8k16,
// fp32 accumulators), a 128 x 128 output block by eight warps (64 x 32
// each), chunks of 32 rows double-buffered by cp.async.  The bf16 / fp16
// calls a TMA map can describe (16-byte bases, K and N whole 16-byte
// units, at least one row) run on the tile engine instead
// (csrc/grouped_update_wgmma.cu, ops/gmm.py::grouped_update_route): this
// tile keeps rows that are not whole 16-byte units, and M = 0.  The contraction
// runs over rows, so the lhs chunk lands as [row][k], which is A transposed:
// ldmatrix.trans reads A's fragments from it, and gbar's chunk [row][n] is
// the [k][n] form of B.  fp32 -> CUDA cores (IEEE fp32 FMA, no TF32) on
// 64 x 64 blocks.  The output type is chosen by one switch around the tile
// store.
//
// What bounds it on an H100: at serving_bench's prefill (8192 routed slots,
// w1's gradient 2048 x 4096 for each of 8 experts, bf16) the tensor-core
// rate, 2 x 8192 x 2048 x 4096 operations in 139 us at 989 TFLOP/s, against
// 70 us for its 235 MB.  Measured there (H100 80GB HBM3, 700 W,
// chip_smoke.py) 0.780 ms while the MoE step ran here; the engine route's
// times are in PERF.md section 6.
#include "tile_mma.cuh"

namespace gemm_hls {

constexpr int UBK = 128, UBN = 128, UBR = 32, UT = 256;
constexpr int UPA = UBK + 8, UPB = UBN + 8;  // [row][k] and [row][n] pitches

struct Update {
  const void* lhs;  // (M, K)
  const void* g;    // (M, N)
  const int* ends;  // (G,) cumulative row ends, clamped to [0, M]
  void* out;        // (G, K, N), out_code
  int M, K, N, G, out_code, vec_a, vec_b;
};

// The tensor-core route's accumulator fragments (warp tile at wm0, wn0 of
// the block at k0, n0), stored as OUT: a compile-time code, so store_out's
// switch folds away.
template <int OUT>
__device__ __forceinline__ void store_tc(const Update& u, const float (&acc)[4][4][4],
                                         int64_t base, int k0, int n0, int wm0, int wn0) {
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = k0 + acc_row(wm0, mt, e), c = n0 + acc_col(wn0, nt, e);
        if (r < u.K && c < u.N)
          store_out(u.out, base + static_cast<int64_t>(r) * u.N + c, acc[mt][nt][e], OUT);
      }
}

template <typename T>
__global__ void __launch_bounds__(UT) update_tc(const Update u) {
  __shared__ __align__(128) uint16_t As[2][UBR * UPA];
  __shared__ __align__(128) uint16_t Bs[2][UBR * UPB];
  const int n0 = blockIdx.x * UBN, k0 = blockIdx.y * UBK, grp = blockIdx.z;
  const int lo = grp > 0 ? u.ends[grp - 1] : 0, hi = u.ends[grp];
  const int warp = threadIdx.x / 32;
  const int wm0 = (warp % 2) * 64, wn0 = (warp / 2) * 32;
  const uint16_t* a = static_cast<const uint16_t*>(u.lhs);
  const uint16_t* b = static_cast<const uint16_t*>(u.g);

  auto load = [&](int buf, int r0) {
    load16<UBR, UBK, UPA, UT>(As[buf], a, u.K, r0, lo, hi, k0, u.K, u.vec_a);
    load16<UBR, UBN, UPB, UT>(Bs[buf], b, u.N, r0, lo, hi, n0, u.N, u.vec_b);
  };

  float acc[4][4][4] = {};
  const int steps = hi > lo ? (hi - lo + UBR - 1) / UBR : 0;
  if (steps > 0) load(0, lo);
  cp_commit();
  for (int t = 0; t < steps; ++t) {
    const int cur = t & 1;
    if (t + 1 < steps) load(cur ^ 1, lo + (t + 1) * UBR);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < UBR; kk += 16)
      mma_step<T, 4, 4, false, UPA, UPB, true>(acc, As[cur], Bs[cur], wm0, wn0, kk);
    __syncthreads();
  }
  cp_wait<0>();

  const int64_t base = static_cast<int64_t>(grp) * u.K * u.N;
  switch (u.out_code) {
    case kBF16: store_tc<kBF16>(u, acc, base, k0, n0, wm0, wn0); break;
    case kF16: store_tc<kF16>(u, acc, base, k0, n0, wm0, wn0); break;
    default: store_tc<kF32>(u, acc, base, k0, n0, wm0, wn0); break;
  }
}

// The CUDA-core route's 8 x 4 per thread (simt_steps' layout), as OUT.
template <int OUT>
__device__ __forceinline__ void store_simt(const Update& u, const float (&acc)[8][4],
                                           int64_t base, int k0, int n0) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = k0 + ty * 8 + i, c = n0 + tx * 4 + j;
      if (r < u.K && c < u.N)
        store_out(u.out, base + static_cast<int64_t>(r) * u.N + c, acc[i][j], OUT);
    }
}

__global__ void __launch_bounds__(SIMT_T) update_simt(const Update u) {
  __shared__ __align__(16) float As[UBR * SIMT_P];
  __shared__ __align__(16) float Bs[UBR * SIMT_P];
  const int n0 = blockIdx.x * SIMT_B, k0 = blockIdx.y * SIMT_B, grp = blockIdx.z;
  const int lo = grp > 0 ? u.ends[grp - 1] : 0, hi = u.ends[grp];
  const float* a = static_cast<const float*>(u.lhs);
  const float* b = static_cast<const float*>(u.g);
  float acc[8][4] = {};
  // Chunks start at lo, so a row below the span is never loaded and the
  // loaders' k_lim (hi) masks the rows past it.
  for (int r0 = lo; r0 < hi; r0 += UBR) {
    __syncthreads();
    load32<UBR>(As, a, u.K, false, k0, 0, u.K, r0, hi);
    load32<UBR>(Bs, b, u.N, false, n0, 0, u.N, r0, hi);
    __syncthreads();
    simt_steps<UBR>(acc, As, Bs, min(UBR, hi - r0));
  }
  const int64_t base = static_cast<int64_t>(grp) * u.K * u.N;
  switch (u.out_code) {
    case kBF16: store_simt<kBF16>(u, acc, base, k0, n0); break;
    case kF16: store_simt<kF16>(u, acc, base, k0, n0); break;
    default: store_simt<kF32>(u, acc, base, k0, n0); break;
  }
}

}  // namespace gemm_hls

using namespace gemm_hls;

// lhs (M, K) and g (M, N) in ``in_code``'s type; ends (G,) int32 cumulative
// group ends clamped to [0, M] (nondecreasing); out (G, K, N) in
// ``out_code``'s type (bf16, fp16 or fp32).  vec_a / vec_b: the operand's
// base is 16-byte aligned and its rows whole 16-byte vectors (the
// tensor-core route's cp.async).  Returns 0, a CUDA error code, or -1.
extern "C" int grouped_update(const void* lhs, const void* g, const void* ends, void* out, int M,
                              int K, int N, int G, int in_code, int out_code, int vec_a,
                              int vec_b, void* stream) {
  if (G < 1 || K < 1 || N < 1) return 0;
  if (out_code != kF32 && out_code != kBF16 && out_code != kF16) return kUnsupported;
  const Update u{lhs, g, static_cast<const int*>(ends), out, M, K, N, G, out_code, vec_a, vec_b};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool tc = in_code == kBF16 || in_code == kF16;
  const int bk = tc ? UBK : SIMT_B, bn = tc ? UBN : SIMT_B;
  const int64_t k_tiles = (K + bk - 1) / bk;
  if (k_tiles > 65535 || G > 65535) return kUnsupported;
  const dim3 grid((N + bn - 1) / bn, static_cast<unsigned>(k_tiles), G);
  switch (in_code) {
    case kBF16: update_tc<__nv_bfloat16><<<grid, UT, 0, st>>>(u); break;
    case kF16: update_tc<__half><<<grid, UT, 0, st>>>(u); break;
    case kF32: update_simt<<<grid, SIMT_T, 0, st>>>(u); break;
    default: return kUnsupported;
  }
  return last_error();
}
