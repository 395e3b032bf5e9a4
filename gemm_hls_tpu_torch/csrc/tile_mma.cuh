// Shared tile pieces of the dequant GEMM (csrc/dequant_gemm.cu, kernel B13),
// the grouped GEMM and its weight gradient (csrc/grouped_gemm.cu,
// csrc/grouped_update.cu, kernels B16 / B17), the int8 GEMMs
// (csrc/int8_slices.cu, csrc/w8a8_gemm.cu: B4 / B5, B14 / B15) and the
// fused distributed GEMMs (csrc/dist_tile.cuh: B18 / B19): masked tile
// loaders for 16-bit and 8-bit operands (cp.async where rows are 16-byte
// aligned), one 16-deep tensor-core step of a warp tile (mma.sync m16n8k16,
// fp32 accumulators, A read from an [m][k] or a [k][m] shared tile, B from a
// [k][n] or an [n][k] one), the int8 mma.sync m16n8k32, and the CUDA-core
// pieces of the fp32 routes.  The mma / ldmatrix / cp.async helpers are
// flash_common.cuh's.  Every global load here goes through the L2
// (cp.async.cg, ld.global.cg), so a buffer that another block of the same
// launch writes is never read from a stale L1 line (rank_sync.cuh).
#pragma once

#include "flash_common.cuh"

namespace gemm_hls {

// tile[r][c] (pitch P elements) = src[(r0 + r) * ld + c0 + c] for r0 + r in
// [r_lo, r_hi) and c0 + c < c_lim, else 0; ROWS x COLS 16-bit elements,
// by all NT threads.  ``vec``: the base is 16-byte aligned and ld and c0 are
// multiples of 8, so each 8-element chunk is one cp.async (zero-filled past
// c_lim); the caller commits and waits.  Otherwise element loads.
template <int ROWS, int COLS, int P, int NT>
__device__ __forceinline__ void load16(uint16_t* tile, const uint16_t* src, int64_t ld, int r0,
                                       int r_lo, int r_hi, int c0, int c_lim, int vec) {
  constexpr int CPR = COLS / 8;
#pragma unroll
  for (int ch = threadIdx.x; ch < ROWS * CPR; ch += NT) {
    const int r = ch / CPR, c = (ch % CPR) * 8, gr = r0 + r, gc = c0 + c;
    uint16_t* dst = tile + r * P + c;
    const bool live = gr >= r_lo && gr < r_hi && gc < c_lim;
    if (vec) {
      const int bytes = live ? 2 * min(8, c_lim - gc) : 0;
      cp16(dst, live ? src + gr * ld + gc : src, bytes);
    } else {
      uint4 z = make_uint4(0u, 0u, 0u, 0u);
      uint16_t* e = reinterpret_cast<uint16_t*>(&z);
      if (live) {
        const uint16_t* s = src + gr * ld + gc;
        for (int i = 0; i < 8 && gc + i < c_lim; ++i) e[i] = __ldcg(s + i);
      }
      *reinterpret_cast<uint4*>(dst) = z;
    }
  }
}

// The same for 8-bit elements: ROWS x COLS bytes in 16-byte chunks (``vec``:
// the base is 16-byte aligned and ld and c0 are multiples of 16).
template <int ROWS, int COLS, int P, int NT>
__device__ __forceinline__ void load8(signed char* tile, const signed char* src, int64_t ld, int r0,
                                      int r_lo, int r_hi, int c0, int c_lim, int vec) {
  constexpr int CPR = COLS / 16;
#pragma unroll
  for (int ch = threadIdx.x; ch < ROWS * CPR; ch += NT) {
    const int r = ch / CPR, c = (ch % CPR) * 16, gr = r0 + r, gc = c0 + c;
    signed char* dst = tile + r * P + c;
    const bool live = gr >= r_lo && gr < r_hi && gc < c_lim;
    if (vec) {
      cp16(dst, live ? src + gr * ld + gc : src, live ? min(16, c_lim - gc) : 0);
    } else {
      uint4 z = make_uint4(0u, 0u, 0u, 0u);
      signed char* e = reinterpret_cast<signed char*>(&z);
      if (live) {
        const signed char* s = src + gr * ld + gc;
        for (int i = 0; i < 16 && gc + i < c_lim; ++i) e[i] = __ldcg(s + i);
      }
      *reinterpret_cast<uint4*>(dst) = z;
    }
  }
}

// c += A (16 x 32, row) . B (32 x 8, col), int8 in, int32 sums.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[MT][NT] (m16 x n8 tiles of the warp tile at rows wm0, columns wn0)
// += A . B over the 16 K columns at kk of the shared tiles.  A is [k][m]
// (TRA, read through ldmatrix.trans) or [m][k] at pitch PA; B is [n][k]
// (TRB) or [k][n] at pitch PB.
template <typename T, int MT, int NT, bool TRB, int PA, int PB, bool TRA = false>
__device__ __forceinline__ void mma_step(float (&acc)[MT][NT][4], const uint16_t* As,
                                         const uint16_t* Bs, int wm0, int wn0, int kk) {
  static_assert(NT % 2 == 0, "B fragments come two n8 tiles at a time");
  const int lane = threadIdx.x % 32;
  const int a_row = (lane % 8) + 8 * ((lane / 8) & 1), a_col = 8 * (lane / 16);
  const int b_row = (lane % 8) + 8 * (lane / 16), b_col = 8 * ((lane / 8) & 1);
  uint32_t af[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    // The four 8 x 8 matrices of A's fragment, (m, k) blocks (0, 0), (8,
    // 0), (0, 8), (8, 8): from a [k][m] tile each is read transposed.
    if constexpr (TRA)
      ldsm_x4_t(af[mt], As + (kk + b_row) * PA + wm0 + mt * 16 + b_col);
    else
      ldsm_x4(af[mt], As + (wm0 + mt * 16 + a_row) * PA + kk + a_col);
  }
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    uint32_t bf[4];
    if constexpr (TRB)
      ldsm_x4(bf, Bs + (wn0 + np * 16 + b_row) * PB + kk + b_col);
    else
      ldsm_x4_t(bf, Bs + (kk + a_row) * PB + wn0 + np * 16 + a_col);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma16816<T>(acc[mt][2 * np], af[mt], bf[0], bf[1]);
      mma16816<T>(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
    }
  }
}

// Row and column of element e of accumulator tile (mt, nt) in the block
// tile, for the mma.sync m16n8 accumulator layout.
__device__ __forceinline__ int acc_row(int wm0, int mt, int e) {
  return wm0 + mt * 16 + (threadIdx.x % 32) / 4 + (e >= 2 ? 8 : 0);
}
__device__ __forceinline__ int acc_col(int wn0, int nt, int e) {
  return wn0 + nt * 8 + 2 * (threadIdx.x % 4) + (e & 1);
}

// ---- fp32 on the CUDA cores ------------------------------------------------
// A 64 x 64 block tile by 128 threads: thread (tx = tid % 16, ty = tid / 16)
// owns rows ty * 8 .. + 7 and columns tx * 4 .. + 3.  Both shared tiles are
// K-major, [k][64 + 4] floats (16-byte aligned rows for float4 reads).
constexpr int SIMT_T = 128, SIMT_B = 64, SIMT_P = SIMT_B + 4;

// tile[k][o] = element (o0 + o, k0 + k) of fp32 ``src``: with ``k_contig``
// src is (O, K) row-major (element at o * ld + k), else (K, O) (k * ld + o).
// Rows o outside [o_lo, o_hi) and k at or past k_lim are 0.
template <int BK>
__device__ __forceinline__ void load32(float* tile, const float* src, int64_t ld, bool k_contig,
                                       int o0, int o_lo, int o_hi, int k0, int k_lim) {
  for (int i = threadIdx.x; i < SIMT_B * BK; i += SIMT_T) {
    // Walk the source's contiguous axis with consecutive threads.
    const int o = k_contig ? i / BK : i % SIMT_B, k = k_contig ? i % BK : i / SIMT_B;
    const int go = o0 + o, gk = k0 + k;
    float v = 0.f;
    if (go >= o_lo && go < o_hi && gk < k_lim)
      v = __ldcg(src + (k_contig ? go * ld + gk : gk * ld + go));
    tile[k * SIMT_P + o] = v;
  }
}

template <int BK>
__device__ __forceinline__ void simt_steps(float (&acc)[8][4], const float* As, const float* Bs,
                                           int kl) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int kk = 0; kk < kl; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + kk * SIMT_P + ty * 8);
    const float4 a1 = *reinterpret_cast<const float4*>(As + kk * SIMT_P + ty * 8 + 4);
    const float4 b = *reinterpret_cast<const float4*>(Bs + kk * SIMT_P + tx * 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
  }
}

}  // namespace gemm_hls
