// Kernel grouped_gemm: the ragged grouped GEMM of a mixture-of-experts FFN,
// out[rows(g)] = lhs[rows(g)] . rhs[g] for every group g, with rows(g) the
// contiguous span [ends[g-1], ends[g]) of the row partition and the rows
// past the last group ([ends[G-1], M)) written as zeros.
//
// Replaces gemm_hls_tpu/ops/pallas_grouped.py::_gmm_kernel (B16).  The TPU
// kernel walked a static list of logical tiles (group x M-tile) in order
// and merged the rows of an M-tile shared by two groups into the
// VMEM-resident output block on each revisit.  Hopper blocks run in no
// order, so here each block owns one logical tile (one group's rows inside
// one M-tile, x one N-tile), computes it with the other rows masked to zero
// at load, and writes only its own rows: tiles sharing an M-tile write
// disjoint rows, and no output is ever read back.  Each block finds its
// logical tile from the device-side group ends (G + 1 segments, the last
// being the zero tail), so routing never reaches the host.  The grid's
// logical-tile count is the static bound cdiv(M, BM) + G: a partition into
// G + 1 contiguous segments meets at most that many (segment, M-tile)
// pairs; blocks past the live count return at once.
//
// Which calls take it (ops/gmm.py::grouped_route): bf16 / fp16 whose K rows
// (or N rows without transpose_rhs) are not whole 16-byte units, and every
// fp32 call; the aligned bf16 / fp16 calls take the tile engine's
// csrc/grouped_wgmma.cu.
//
// Routes by element type: bf16 / fp16 -> tensor cores (mma.sync m16n8k16,
// fp32 accumulators), a 64 x 128 block tile by eight warps (32 x 32 each),
// K steps of 32 double-buffered by cp.async; ``transpose_rhs`` (each expert
// (N, K)) reads B as [n][k] tiles, the plain layout as [k][n] tiles through
// ldmatrix.trans, so no transpose is materialised.  fp32 -> CUDA cores (fp32
// FMA) on 64 x 64 tiles.
//
// What bounds it on an H100: at prefill (8192 routed slots x 2048 -> 4096,
// 8 experts, bf16: 137 GFLOP) the tensor-core rate, 139 us at 989 TFLOP/s;
// at decode (128 slots) the expert weights, 134 MB read once, 40 us at
// 3.35 TB/s.  Measured (H100 80GB HBM3, 700 W, chip_smoke.py phase 18,
// timed as the engine route's other tensor-core route): ~0.9 ms at prefill
// (160 TFLOP/s), ~0.13 ms at 128 slots; see PERF.md §6.
#include "tile_mma.cuh"
#include "grouped_span.cuh"

namespace gemm_hls {

constexpr int GBM = 64, GBN = 128, GBK = 32, GT = 256;
constexpr int GPA = GBK + 8;                       // A [m][k] and B^T [n][k] pitch
constexpr int GPB = GBN + 8;                       // B [k][n] pitch
constexpr int GB_ELEMS = GBN * GPA > GBK * GPB ? GBN * GPA : GBK * GPB;

struct Grouped {
  const void* lhs;   // (M, K)
  const void* rhs;   // (G, K, N), or (G, N, K) with trb
  const int* ends;   // (G,) cumulative row ends, clamped to [0, M]
  void* out;         // (M, N), out_code
  int M, N, K, G, trb, out_code, vec_a, vec_b;
};

__device__ __forceinline__ bool locate(const Grouped& g, int t, int bm, int& grp, int& m0,
                                       int& r_lo, int& r_hi) {
  return locate_span(g.ends, g.G, g.M, t, bm, grp, m0, r_lo, r_hi);
}

__device__ __forceinline__ void store_zero_rows(const Grouped& g, int r_lo, int r_hi, int n0,
                                                int bn, int nt) {
  for (int i = threadIdx.x; i < (r_hi - r_lo) * bn; i += nt) {
    const int r = r_lo + i / bn, c = n0 + i % bn;
    if (c < g.N) store_out(g.out, static_cast<int64_t>(r) * g.N + c, 0.f, g.out_code);
  }
}

template <typename T, bool TRB>
__global__ void __launch_bounds__(GT) grouped_tc(const Grouped g) {
  __shared__ __align__(128) uint16_t As[2][GBM * GPA];
  __shared__ __align__(128) uint16_t Bs[2][GB_ELEMS];
  int grp, m0, r_lo, r_hi;
  if (!locate(g, blockIdx.y, GBM, grp, m0, r_lo, r_hi)) return;
  const int n0 = blockIdx.x * GBN;
  if (grp == g.G) {
    store_zero_rows(g, r_lo, r_hi, n0, GBN, GT);
    return;
  }
  const int warp = threadIdx.x / 32;
  const int wm0 = (warp % 2) * 32, wn0 = (warp / 2) * 32;
  const uint16_t* a = static_cast<const uint16_t*>(g.lhs);
  const uint16_t* b = static_cast<const uint16_t*>(g.rhs) + static_cast<int64_t>(grp) * g.K * g.N;

  auto load = [&](int buf, int k0) {
    load16<GBM, GBK, GPA, GT>(As[buf], a, g.K, m0, r_lo, r_hi, k0, g.K, g.vec_a);
    if constexpr (TRB)
      load16<GBN, GBK, GPA, GT>(Bs[buf], b, g.K, n0, 0, g.N, k0, g.K, g.vec_b);
    else
      load16<GBK, GBN, GPB, GT>(Bs[buf], b, g.N, k0, 0, g.K, n0, g.N, g.vec_b);
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int steps = (g.K + GBK - 1) / GBK;
  if (steps > 0) load(0, 0);
  cp_commit();
  for (int t = 0; t < steps; ++t) {
    const int cur = t & 1;
    if (t + 1 < steps) load(cur ^ 1, (t + 1) * GBK);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GBK; kk += 16)
      mma_step<T, 2, 4, TRB, GPA, TRB ? GPA : GPB>(acc, As[cur], Bs[cur], wm0, wn0, kk);
    __syncthreads();
  }
  cp_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + acc_row(wm0, mt, e), c = n0 + acc_col(wn0, nt, e);
        if (r >= r_lo && r < r_hi && c < g.N)
          store_out(g.out, static_cast<int64_t>(r) * g.N + c, acc[mt][nt][e], g.out_code);
      }
}

__global__ void __launch_bounds__(SIMT_T) grouped_simt(const Grouped g) {
  __shared__ __align__(16) float As[GBK * SIMT_P];
  __shared__ __align__(16) float Bs[GBK * SIMT_P];
  int grp, m0, r_lo, r_hi;
  if (!locate(g, blockIdx.y, SIMT_B, grp, m0, r_lo, r_hi)) return;
  const int n0 = blockIdx.x * SIMT_B;
  if (grp == g.G) {
    store_zero_rows(g, r_lo, r_hi, n0, SIMT_B, SIMT_T);
    return;
  }
  const float* a = static_cast<const float*>(g.lhs);
  const float* b = static_cast<const float*>(g.rhs) + static_cast<int64_t>(grp) * g.K * g.N;
  float acc[8][4] = {};
  for (int k0 = 0; k0 < g.K; k0 += GBK) {
    __syncthreads();
    load32<GBK>(As, a, g.K, true, m0, r_lo, r_hi, k0, g.K);
    if (g.trb)
      load32<GBK>(Bs, b, g.K, true, n0, 0, g.N, k0, g.K);
    else
      load32<GBK>(Bs, b, g.N, false, n0, 0, g.N, k0, g.K);
    __syncthreads();
    simt_steps<GBK>(acc, As, Bs, min(GBK, g.K - k0));
  }
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + ty * 8 + i, c = n0 + tx * 4 + j;
      if (r >= r_lo && r < r_hi && c < g.N)
        store_out(g.out, static_cast<int64_t>(r) * g.N + c, acc[i][j], g.out_code);
    }
}

}  // namespace gemm_hls

using namespace gemm_hls;

// lhs (M, K) and rhs (G, K, N) (trb: (G, N, K)) in ``in_code``'s type; ends
// (G,) int32 cumulative group ends clamped to [0, M] (nondecreasing); out
// (M, N) in ``out_code``'s type.  vec_a / vec_b: the operand's base is
// 16-byte aligned and its rows whole 16-byte vectors (the tensor-core
// route's cp.async).  Returns 0, a CUDA error code, or -1.
extern "C" int grouped_gemm(const void* lhs, const void* rhs, const void* ends, void* out, int M,
                            int N, int K, int G, int trb, int in_code, int out_code, int vec_a,
                            int vec_b, void* stream) {
  if (G < 1 || M < 1 || N < 1) return M < 1 || N < 1 ? 0 : kUnsupported;
  const Grouped g{lhs, rhs, static_cast<const int*>(ends), out, M, N, K, G, trb, out_code,
                  vec_a, vec_b};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool tc = in_code == kBF16 || in_code == kF16;
  const int bm = tc ? GBM : SIMT_B, bn = tc ? GBN : SIMT_B;
  const int64_t tiles = (M + bm - 1) / bm + G;
  if (tiles > 65535) return kUnsupported;
  const dim3 grid((N + bn - 1) / bn, static_cast<unsigned>(tiles));
  switch (in_code) {
    case kBF16:
      if (trb) grouped_tc<__nv_bfloat16, true><<<grid, GT, 0, st>>>(g);
      else grouped_tc<__nv_bfloat16, false><<<grid, GT, 0, st>>>(g);
      break;
    case kF16:
      if (trb) grouped_tc<__half, true><<<grid, GT, 0, st>>>(g);
      else grouped_tc<__half, false><<<grid, GT, 0, st>>>(g);
      break;
    case kF32: grouped_simt<<<grid, SIMT_T, 0, st>>>(g); break;
    default: return kUnsupported;
  }
  return last_error();
}
