// The W8A8 GEMM's modes and the fp32 steps after its int32 products, shared
// by its two kernels (csrc/w8a8_gemm.cu, mma.sync; csrc/w8a8_wgmma.cu, the
// tile engine) and the plain version's order (ops/dequant.py::w8a8_plain).
// Every K-block product P_b is exact in int32, so a kernel that folds it
// with these functions, block by block in K order, gives the same bits.
//   kFused (B14): x quantized per (row, K-block of bk); acc += (f32(P_b)
//     s_x[b, m]) (* s_w[b, n] when group-wise), a per-channel s_w at the
//     store;
//   kIntAcc (B15, per-channel scales and 127^2 K < 2^31): one int32 sum
//     over all of K, (f32(P) s_w[n]) s_x[m] at the store;
//   kPerBlock (B15 otherwise): acc += f32(P_b) s_w[b, n]; acc s_x[m] at
//     the store.
// A scale that does not apply is 1, an exact factor.  ``G`` is a kernel's
// argument struct: its sw (n_groups, N), sx ((K / bk, M) for kFused, else
// (M,)), M, N, n_groups and mode.
#pragma once

#include "common.cuh"

namespace gemm_hls {

constexpr int kFused = 0, kIntAcc = 1, kPerBlock = 2;

// K-block b's contribution (f32(P_b) rs) cs.
__device__ __forceinline__ float w8_part(int p, float rs, float cs) {
  return __fmul_rn(__fmul_rn(__int2float_rn(p), rs), cs);
}
// The stored value (b cs) rs.
__device__ __forceinline__ float w8_out(float b, float cs, float rs) {
  return __fmul_rn(__fmul_rn(b, cs), rs);
}

// The row and column scales of K-block kb's fold at (m, n), and of the
// store; 1 past M and N.
template <typename G>
__device__ __forceinline__ float w8_fold_rs(const G& g, int64_t kb, int m) {
  return g.mode == kFused && m < g.M ? g.sx[kb * g.M + m] : 1.f;
}
template <typename G>
__device__ __forceinline__ float w8_fold_cs(const G& g, int64_t kb, int n) {
  return n >= g.N ? 1.f : g.n_groups > 1 ? g.sw[kb * g.N + n] : g.mode == kPerBlock ? g.sw[n] : 1.f;
}
template <typename G>
__device__ __forceinline__ float w8_store_rs(const G& g, int m) {
  return g.mode != kFused && m < g.M ? g.sx[m] : 1.f;
}
template <typename G>
__device__ __forceinline__ float w8_store_cs(const G& g, int n) {
  return n < g.N && (g.mode == kIntAcc || (g.mode == kFused && g.n_groups == 1)) ? g.sw[n] : 1.f;
}

}  // namespace gemm_hls
