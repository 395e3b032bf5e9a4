// Kernels of the W8A8 GEMM: y ~ x . dequant(w_q, s_w), int8 activations
// times int8 weights on the int8 tensor cores.
//
// Replaces two TPU kernels of gemm_hls_tpu/ops/pallas_dequant.py:
//   * _w8a8_fused_kernel (B14): x quantized per (row, K-block of bk) on
//     first touch into a VMEM-resident int8 (block_m, K) strip.  That strip
//     is 256 KB at 128 x 2048, over the 227 KB a Hopper block may hold, so
//     here a small kernel (w8a8_quantize) writes int8 x and the
//     per-(row, K-block) scales, and the GEMM (mode kFused) folds each
//     block's scales into its fp32 contribution: acc += (f32(P_b) s_x[b, m])
//     (* s_w[b, n] when group-wise), a per-channel s_w at the store;
//   * _w8a8_kernel (B15): x pre-quantized per row (the same quantize kernel
//     with bk = K, the two-pass formulas), then either one exact int32 sum
//     over all of K scaled once at the store, (f32(P) s_w[n]) s_x[m]
//     (mode kIntAcc: per-channel scales and 127^2 K < 2^31), or an fp32
//     sum of per-block f32(P_b) s_w[b, n] times s_x[m] (mode kPerBlock).
// The quantize formulas are the JAX ones, in IEEE single steps: fused r =
// 127 / ax (0 for an all-zero block), q = rint(x r), s = ax * fl(1/127);
// two-pass s = ax / 127 (1 for an all-zero row), q = rint(x / s); both
// clip to +-127 and round half to even, so q and every int32 block product
// P_b are the JAX package's bit for bit.  The fp32 steps after them use
// __fmul_rn / __fadd_rn (no FMA contraction), in the plain version's order.
//
// GEMM: mma.sync m16n8k32 s8 x s8 -> s32, a 64 x 128 block tile by eight
// warps (32 x 32 each), K steps of 64 bytes double-buffered in shared
// memory.  The x tile arrives by cp.async (zero-filled past M and K).  The
// MMA reads B K-major, and w_q is (K, N) row-major: each thread fetches two
// 4 x 4 byte blocks of the weight tile into registers while the previous
// step's MMAs issue, transposes them with byte permutes and stores them as
// rows of B^T, so ldmatrix serves both operands as in csrc/int8_slices.cu.
// The int32 block partial is flushed into the fp32 accumulator wherever a
// scale block ends, which must be at the end of a 64-deep K step.
//
// What bounds it on an H100: at the prefill projections ((4096, 2048) x
// (2048, 2048), 34.4 GOP) the int8 tensor-core rate, 17.4 us at 1979
// TOP/s; the bytes (16 MB of bf16 x, 4 MB of weights, 16 MB of bf16 y) take
// 11 us at 3.35 TB/s.  Left on the table: wgmma, TMA, quantizing x in the
// GEMM's own load stage, a persistent schedule.
#include "tile_mma.cuh"

namespace gemm_hls {

constexpr int WBM = 64, WBN = 128, WBK = 64, WTH = 256, WPITCH = 80;
constexpr int kFused = 0, kIntAcc = 1, kPerBlock = 2;

struct W8a8 {
  const signed char* xq;  // (M, K)
  const signed char* wq;  // (K, N)
  const float* sw;        // (n_groups, N)
  const float* sx;        // kFused: (K / bk, M); otherwise (M,)
  void* out;              // (M, N), out_code
  int M, N, K, bk, n_groups, mode, out_code, vec;
};

// ---- quantize --------------------------------------------------------------

__device__ __forceinline__ float load_x(const void* x, int64_t i, int code) {
  switch (code) {
    case kBF16: return __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]);
    case kF16: return __half2float(static_cast<const __half*>(x)[i]);
    default: return static_cast<const float*>(x)[i];
  }
}

// One warp per (row, K-block): the block's max |x|, then its int8 values.
__global__ void __launch_bounds__(256) w8a8_quantize_kernel(const void* x, signed char* xq,
                                                            float* sx, int M, int K, int bk,
                                                            int fused, int code) {
  const int lane = threadIdx.x % 32, row = blockIdx.y * 8 + threadIdx.x / 32, kb = blockIdx.x;
  if (row >= M) return;
  const int k_lo = kb * bk, k_hi = min(K, k_lo + bk);
  const int64_t base = static_cast<int64_t>(row) * K;
  float ax = 0.f;
  for (int k = k_lo + lane; k < k_hi; k += 32) ax = fmaxf(ax, fabsf(load_x(x, base + k, code)));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ax = fmaxf(ax, __shfl_xor_sync(0xffffffffu, ax, o));
  float r = 0.f, s;
  if (fused) {
    r = ax == 0.f ? 0.f : __fdiv_rn(127.f, ax);
    s = __fmul_rn(ax, static_cast<float>(1.0 / 127.0));
  } else {
    s = ax == 0.f ? 1.f : __fdiv_rn(ax, 127.f);
  }
  if (lane == 0) sx[static_cast<int64_t>(kb) * M + row] = s;
  for (int k = k_lo + lane; k < k_hi; k += 32) {
    const float v = load_x(x, base + k, code);
    const float q = rintf(fused ? __fmul_rn(v, r) : __fdiv_rn(v, s));
    xq[base + k] = static_cast<signed char>(static_cast<int>(fminf(fmaxf(q, -127.f), 127.f)));
  }
}

// ---- GEMM ------------------------------------------------------------------

// A 64-byte K step of the x tile (rows m0.., bytes k0..) into ``as`` (rows
// at WPITCH bytes): cp.async when every row is 16-byte aligned (vec), byte
// copies otherwise; zeros past M and K.
__device__ __forceinline__ void load_x_tile(signed char* as, const W8a8& g, int m0, int k0) {
#pragma unroll
  for (int i = 0; i < WBM * (WBK / 16) / WTH; ++i) {
    const int ch = threadIdx.x + i * WTH, r = ch / 4, c = (ch % 4) * 16;
    const int gm = m0 + r, gk = k0 + c;
    const bool live = gm < g.M && gk < g.K;
    signed char* dst = as + r * WPITCH + c;
    const signed char* src = g.xq + static_cast<int64_t>(gm) * g.K + gk;
    if (g.vec) {
      cp16(dst, live ? src : g.xq, live ? min(16, g.K - gk) : 0);
    } else {
      uint4 z = make_uint4(0u, 0u, 0u, 0u);
      signed char* e = reinterpret_cast<signed char*>(&z);
      if (live)
        for (int j = 0; j < 16 && gk + j < g.K; ++j) e[j] = src[j];
      *reinterpret_cast<uint4*>(dst) = z;
    }
  }
}

// This thread's two 4 (k) x 4 (n) byte blocks of a K step's weight tile:
// block i at k = k0 + 4 (s % 16), n = n0 + 4 (s / 16), s = tid + 256 i
// (sixteen k quads by two n quads a warp: conflict-free stores below).
__device__ __forceinline__ void fetch_w(uint32_t (&w)[2][4], const W8a8& g, int n0, int k0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = threadIdx.x + i * WTH, k = k0 + 4 * (s % 16), n = n0 + 4 * (s / 16);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[i][j] = 0u;
      if (k + j >= g.K || n >= g.N) continue;
      const signed char* src = g.wq + static_cast<int64_t>(k + j) * g.N + n;
      if (n + 4 <= g.N && g.N % 4 == 0) {
        w[i][j] = __ldg(reinterpret_cast<const unsigned int*>(src));
      } else {
        for (int b = 0; b < 4 && n + b < g.N; ++b)
          w[i][j] |= static_cast<uint32_t>(static_cast<unsigned char>(src[b])) << (8 * b);
      }
    }
  }
}

// Rows k .. k + 3 (one word each, 4 n bytes) -> words n .. n + 3 (4 k bytes
// each) of B^T.
__device__ __forceinline__ void store_w(signed char* bt, const uint32_t (&w)[2][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = threadIdx.x + i * WTH, kq = s % 16, nq = s / 16;
    const uint32_t t0 = __byte_perm(w[i][0], w[i][1], 0x5140), t1 = __byte_perm(w[i][2], w[i][3], 0x5140);
    const uint32_t t2 = __byte_perm(w[i][0], w[i][1], 0x7362), t3 = __byte_perm(w[i][2], w[i][3], 0x7362);
    const uint32_t o[4] = {__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                           __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632)};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint32_t*>(bt + (4 * nq + j) * WPITCH + 4 * kq) = o[j];
  }
}

// The thread's accumulator tile (rows r0 + 16 mt + 8 h, columns c0 + 8 nt +
// j of the m16n8 layout) stored as T, masked to M x N.
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void put(__half* p, float v) { *p = __float2half(v); }

template <typename T>
__device__ __forceinline__ void store_tile(const W8a8& g, const float (&v)[2][4][4], int r0,
                                           int c0) {
  T* out = static_cast<T*>(g.out);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gm = r0 + mt * 16 + 8 * (e >> 1), gn = c0 + nt * 8 + (e & 1);
        if (gm < g.M && gn < g.N) put(out + static_cast<int64_t>(gm) * g.N + gn, v[mt][nt][e]);
      }
}

__global__ void __launch_bounds__(WTH) w8a8_gemm_kernel(const W8a8 g) {
  __shared__ __align__(128) signed char As[2][WBM * WPITCH];
  __shared__ __align__(128) signed char Bt[2][WBN * WPITCH];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp % 2, wn = warp / 2;  // 32 x 32 warp tiles
  const int m0 = blockIdx.y * WBM, n0 = blockIdx.x * WBN;

  int part[2][4][4];
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        part[mt][nt][e] = 0;
        acc[mt][nt][e] = 0.f;
      }

  const int steps = (g.K + WBK - 1) / WBK;
  uint32_t w[2][4];
  if (steps > 0) {
    load_x_tile(As[0], g, m0, 0);
    fetch_w(w, g, n0, 0);
    store_w(Bt[0], w);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  const int a_row = wm * 32 + (lane % 8) + 8 * ((lane / 8) & 1), a_col = 16 * (lane / 16);
  const int b_row = wn * 32 + (lane % 8) + 8 * (lane / 16), b_col = 16 * ((lane / 8) & 1);

  for (int t = 0; t < steps; ++t) {
    const int cur = t & 1, k0 = t * WBK;
    const bool more = t + 1 < steps;
    if (more) {
      load_x_tile(As[cur ^ 1], g, m0, k0 + WBK);
      fetch_w(w, g, n0, k0 + WBK);
    }
    cp_commit();
#pragma unroll
    for (int kk = 0; kk < WBK; kk += 32) {
      uint32_t af[2][4], bf[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4(af[mt], As[cur] + (a_row + mt * 16) * WPITCH + kk + a_col);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldsm_x4(bf[np], Bt[cur] + (b_row + np * 16) * WPITCH + kk + b_col);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_s8(part[mt][nt], af[mt], bf[nt / 2][2 * (nt % 2)], bf[nt / 2][2 * (nt % 2) + 1]);
    }
    // A scale block ends with this K step: fold its int32 partial into acc,
    // (f32(P) s_x) s_w with the scales that do not apply set to 1 (exact).
    const int kend = min(k0 + WBK, g.K);
    if (g.mode != kIntAcc && (kend % g.bk == 0 || kend == g.K)) {
      const int64_t kb = (kend - 1) / g.bk;
      float rs[2][2], cs[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gm = m0 + wm * 32 + mt * 16 + gq + 8 * h;
          rs[mt][h] = g.mode == kFused && gm < g.M ? g.sx[kb * g.M + gm] : 1.f;
        }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int gn = n0 + wn * 32 + nt * 8 + 2 * tq + j;
          cs[nt][j] = gn >= g.N ? 1.f
                      : g.n_groups > 1 ? g.sw[kb * g.N + gn]
                      : g.mode == kPerBlock ? g.sw[gn] : 1.f;
        }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float c = __fmul_rn(__fmul_rn(__int2float_rn(part[mt][nt][e]), rs[mt][e >> 1]),
                                      cs[nt][e & 1]);
            acc[mt][nt][e] = __fadd_rn(acc[mt][nt][e], c);
            part[mt][nt][e] = 0;
          }
    }
    if (more) store_w(Bt[cur ^ 1], w);
    cp_wait<0>();
    __syncthreads();
  }

  // The store: kIntAcc (f32(P) s_w) s_x, kPerBlock acc s_x, kFused acc s_w
  // (per-channel) -- the scales that do not apply set to 1 (exact).
  float rs[2][2], cs[4][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + wm * 32 + mt * 16 + gq + 8 * h;
      rs[mt][h] = g.mode != kFused && gm < g.M ? g.sx[gm] : 1.f;
    }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int gn = n0 + wn * 32 + nt * 8 + 2 * tq + j;
      cs[nt][j] = gn < g.N && (g.mode == kIntAcc || (g.mode == kFused && g.n_groups == 1))
                      ? g.sw[gn] : 1.f;
    }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float b = g.mode == kIntAcc ? __int2float_rn(part[mt][nt][e]) : acc[mt][nt][e];
        acc[mt][nt][e] = __fmul_rn(__fmul_rn(b, cs[nt][e & 1]), rs[mt][e >> 1]);
      }
  const int r0 = m0 + wm * 32 + gq, c0 = n0 + wn * 32 + 2 * tq;
  switch (g.out_code) {
    case kBF16: store_tile<__nv_bfloat16>(g, acc, r0, c0); break;
    case kF16: store_tile<__half>(g, acc, r0, c0); break;
    default: store_tile<float>(g, acc, r0, c0); break;
  }
}

}  // namespace gemm_hls

using namespace gemm_hls;

// x (M, K) in ``code``'s type -> xq (M, K) int8 and sx (ceil(K / bk), M)
// fp32: per (row, K-block of bk) with the fused route's formulas, or per
// row (bk = K) with the two-pass route's (fused = 0).
extern "C" int w8a8_quantize(const void* x, void* xq, void* sx, int M, int K, int bk, int fused,
                             int code, void* stream) {
  if (bk < 1 || (code != kBF16 && code != kF16 && code != kF32)) return kUnsupported;
  const int64_t gy = (M + 7) / 8;
  if (gy > 65535) return kUnsupported;
  w8a8_quantize_kernel<<<dim3((K + bk - 1) / bk, static_cast<unsigned>(gy)), 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<signed char*>(xq), static_cast<float*>(sx), M, K, bk, fused, code);
  return last_error();
}

// out (M, N) = xq (M, K) int8 . wq (K, N) int8 with the scales of ``mode``
// (kFused 0, kIntAcc 1, kPerBlock 2; see the note at the top), scale blocks
// of bk rows (a multiple of 64 unless kIntAcc).  vec: K a multiple of 16
// (xq's rows 16-byte aligned).  Returns 0, a CUDA error code, or -1.
extern "C" int w8a8_gemm(const void* xq, const void* wq, const void* sw, const void* sx, void* out,
                         int M, int N, int K, int bk, int n_groups, int mode, int out_code, int vec,
                         void* stream) {
  if (mode < kFused || mode > kPerBlock || bk < 1 || (mode != kIntAcc && bk % WBK)) return kUnsupported;
  const int64_t gy = (M + WBM - 1) / WBM;
  if (gy > 65535) return kUnsupported;
  const W8a8 g{static_cast<const signed char*>(xq), static_cast<const signed char*>(wq),
               static_cast<const float*>(sw), static_cast<const float*>(sx), out, M, N, K, bk,
               n_groups, mode, out_code, vec};
  w8a8_gemm_kernel<<<dim3((N + WBN - 1) / WBN, static_cast<unsigned>(gy)), WTH, 0,
                     static_cast<cudaStream_t>(stream)>>>(g);
  return last_error();
}
