// Kernels of the W8A8 GEMM: y ~ x . dequant(w_q, s_w), int8 activations
// times int8 weights on the int8 tensor cores.  This file holds the
// quantize pass both routes run first, and the mma.sync tile: the route
// (ops/dequant.py::w8a8_route) for what the tile engine of
// csrc/w8a8_wgmma.cu does not take (K or N off 16 bytes, unaligned bases,
// per-block scales on a K-block that is not a whole 128-deep engine step).
//
// Replaces two TPU kernels of gemm_hls_tpu/ops/pallas_dequant.py:
//   * _w8a8_fused_kernel (B14): x quantized per (row, K-block of bk) on
//     first touch into a VMEM-resident int8 (block_m, K) strip.  That strip
//     is 256 KB at 128 x 2048, over the 227 KB a Hopper block may hold, so
//     here a pass of its own (w8a8_quantize) writes int8 x and the
//     per-(row, K-block) scales, and the GEMM (mode kFused) folds each
//     block's scales into its fp32 contribution;
//   * _w8a8_kernel (B15): x pre-quantized per row (the same pass with
//     bk = K, the two-pass formulas), then mode kIntAcc or kPerBlock.
// The modes and the fp32 steps after the int32 products are csrc/w8a8.cuh's.
// The quantize formulas are the JAX ones, in IEEE single steps: fused r =
// 127 / ax (0 for an all-zero block), q = rint(x r), s = ax * fl(1/127);
// two-pass s = ax / 127 (1 for an all-zero row), q = rint(x / s); both
// clip to +-127 and round half to even, so q and every int32 block product
// P_b are the JAX package's bit for bit.
//
// The quantize pass is bound by its bytes: at the prefill projections x is
// 4096 x 2048 bf16, 16 MB read and 8 MB of int8 written, 7.5 us at 3.35
// TB/s.  One warp a segment (the elements that share a scale), 16 elements
// a lane in 16-byte loads, the segment held in registers between its max
// and its values (up to 256 bytes a lane: 4096 16-bit or 2048 fp32
// elements; longer segments are read twice), the int8 values written 16
// bytes at a time; element loads and stores where a row or a block is not
// whole 16-byte units.
//
// GEMM: mma.sync m16n8k32 s8 x s8 -> s32, a 64 x 128 block tile by eight
// warps (32 x 32 each), K steps of 64 bytes double-buffered in shared
// memory.  The x tile arrives by cp.async (zero-filled past M and K).  The
// MMA reads B K-major, and w_q is (K, N) row-major: each thread fetches two
// 4 x 4 byte blocks of the weight tile into registers while the previous
// step's MMAs issue, transposes them with byte permutes and stores them as
// rows of B^T, so ldmatrix serves both operands as in csrc/int8_slices.cu.
// The int32 block partial is flushed into the fp32 accumulator wherever a
// scale block ends, which must be at the end of a 32-deep sub-step (bk a
// multiple of 32).
//
// What bounds the GEMM on an H100: at the prefill projections ((4096, 2048)
// x (2048, 2048), 34.4 GOP) the int8 tensor-core rate, 17.4 us at 1979
// TOP/s; the bytes (16 MB of bf16 x, 4 MB of weights, 16 MB of bf16 y)
// take 11 us at 3.35 TB/s.  This tile reaches about 6% of it; the engine
// route is the one built for that bound.
#include "tile_mma.cuh"
#include "w8a8.cuh"

namespace gemm_hls {

constexpr int WBM = 64, WBN = 128, WBK = 64, WTH = 256, WPITCH = 80;
// Where the mma.sync tile may fold a scale block: the end of an m16n8k32 sub-step.
constexpr int kW8FoldStep = 32;

struct W8a8 {
  const signed char* xq;  // (M, K)
  const signed char* wq;  // (K, N)
  const float* sw;        // (n_groups, N)
  const float* sx;        // kFused: (K / bk, M); otherwise (M,)
  void* out;              // (M, N), out_code
  int M, N, K, bk, n_groups, mode, out_code, vec;
};

// ---- quantize --------------------------------------------------------------

constexpr int kQWarps = 8;         // segments a block: one warp each
constexpr int kQLaneBytes = 256;   // bytes of x a lane holds between the max and the values

// 16 consecutive elements of x as the words of sizeof(T) 16-byte loads, and
// element e of them as a float (exact).
template <typename T>
__device__ __forceinline__ void q16_load(uint32_t (&w)[4 * sizeof(T)], const T* p) {
  const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(T)); ++i) {
    const uint4 u = __ldg(v + i);
    w[4 * i] = u.x;
    w[4 * i + 1] = u.y;
    w[4 * i + 2] = u.z;
    w[4 * i + 3] = u.w;
  }
}
template <typename T> __device__ __forceinline__ float q16_at(const uint32_t (&w)[4 * sizeof(T)], int e);
template <> __device__ __forceinline__ float q16_at<__nv_bfloat16>(const uint32_t (&w)[8], int e) {
  return __uint_as_float(e & 1 ? w[e / 2] & 0xFFFF0000u : w[e / 2] << 16);
}
template <> __device__ __forceinline__ float q16_at<__half>(const uint32_t (&w)[8], int e) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(e & 1 ? w[e / 2] >> 16 : w[e / 2])));
}
template <> __device__ __forceinline__ float q16_at<float>(const uint32_t (&w)[16], int e) {
  return __uint_as_float(w[e]);
}

// One value's int8 code (its low byte), by the route's formula.
__device__ __forceinline__ int w8_code(float v, float r, float s, int fused) {
  const float q = rintf(fused ? __fmul_rn(v, r) : __fdiv_rn(v, s));
  return static_cast<int>(fminf(fmaxf(q, -127.f), 127.f));
}

// The 16 values' codes as one 16-byte store.
template <typename T>
__device__ __forceinline__ void q16_store(signed char* q, const uint32_t (&w)[4 * sizeof(T)], float r,
                                          float s, int fused) {
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = w8_code(q16_at<T>(w, 4 * i + j), r, s, fused);
    o[i] = __byte_perm(__byte_perm(c[0], c[1], 0x0040), __byte_perm(c[2], c[3], 0x0040), 0x5410);
  }
  *reinterpret_cast<uint4*>(q) = make_uint4(o[0], o[1], o[2], o[3]);
}

// One warp a segment: (row, K-block kb of bk) of n_kb blocks a row.  Its
// max |x|, its scale, then its int8 values.  ``vec``: x's base is 16-byte
// aligned and K and bk are multiples of 16, so a lane takes 16 elements at
// a time (16-byte loads, one 16-byte store); a segment of up to
// kQLaneBytes a lane stays in registers between the two passes.
template <typename T>
__global__ void __launch_bounds__(32 * kQWarps) w8a8_quantize_kernel(const T* x, signed char* xq,
                                                                     float* sx, int M, int K, int bk,
                                                                     int n_kb, int fused, int vec) {
  constexpr int kW = 4 * static_cast<int>(sizeof(T));
  constexpr int kHeld = kQLaneBytes / (16 * static_cast<int>(sizeof(T)));
  const int lane = threadIdx.x % 32;
  const int64_t seg = static_cast<int64_t>(blockIdx.x) * kQWarps + threadIdx.x / 32;
  if (seg >= static_cast<int64_t>(M) * n_kb) return;
  const int row = static_cast<int>(seg / n_kb), kb = static_cast<int>(seg % n_kb);
  const int k_lo = kb * bk, len = min(K - k_lo, bk);
  const T* xs = x + static_cast<int64_t>(row) * K + k_lo;
  signed char* qs = xq + static_cast<int64_t>(row) * K + k_lo;
  const int units = vec ? len / 16 : 0;
  const bool held = vec && units <= 32 * kHeld;
  uint32_t w[kHeld][kW];
  float ax = 0.f;
  if (held) {
#pragma unroll
    for (int i = 0; i < kHeld; ++i)
      if (lane + 32 * i < units) {
        q16_load<T>(w[i], xs + 16 * (lane + 32 * i));
#pragma unroll
        for (int e = 0; e < 16; ++e) ax = fmaxf(ax, fabsf(q16_at<T>(w[i], e)));
      }
  } else if (vec) {  // a longer segment: read twice
    for (int u = lane; u < units; u += 32) {
      uint32_t v[kW];
      q16_load<T>(v, xs + 16 * u);
#pragma unroll
      for (int e = 0; e < 16; ++e) ax = fmaxf(ax, fabsf(q16_at<T>(v, e)));
    }
  } else {
    for (int k = lane; k < len; k += 32) ax = fmaxf(ax, fabsf(to_acc(xs[k], 0.f)));
  }
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
  if (held) {
#pragma unroll
    for (int i = 0; i < kHeld; ++i)
      if (lane + 32 * i < units) q16_store<T>(qs + 16 * (lane + 32 * i), w[i], r, s, fused);
  } else if (vec) {
    for (int u = lane; u < units; u += 32) {
      uint32_t v[kW];
      q16_load<T>(v, xs + 16 * u);
      q16_store<T>(qs + 16 * u, v, r, s, fused);
    }
  } else {
    for (int k = lane; k < len; k += 32)
      qs[k] = static_cast<signed char>(w8_code(to_acc(xs[k], 0.f), r, s, fused));
  }
}

template <typename T>
int w8_quantize(const void* x, void* xq, void* sx, int M, int K, int bk, int fused,
                cudaStream_t st) {
  const int n_kb = (K + bk - 1) / bk;
  const int64_t blocks = (static_cast<int64_t>(M) * n_kb + kQWarps - 1) / kQWarps;
  if (blocks > INT_MAX) return kUnsupported;
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && K % 16 == 0 && bk % 16 == 0;
  w8a8_quantize_kernel<T><<<static_cast<unsigned>(blocks), 32 * kQWarps, 0, st>>>(
      static_cast<const T*>(x), static_cast<signed char*>(xq), static_cast<float*>(sx), M, K, bk,
      n_kb, fused, vec);
  return last_error();
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
    for (int kk = 0; kk < WBK; kk += kW8FoldStep) {
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
      // A scale block ends with this 32-deep sub-step: fold its int32
      // partial into acc (csrc/w8a8.cuh).
      const int kend = min(k0 + kk + kW8FoldStep, g.K);
      if (g.mode != kIntAcc && k0 + kk < g.K && (kend % g.bk == 0 || kend == g.K)) {
        const int64_t kb = (kend - 1) / g.bk;
        float rs[2][2], cs[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) rs[mt][h] = w8_fold_rs(g, kb, m0 + wm * 32 + mt * 16 + gq + 8 * h);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) cs[nt][j] = w8_fold_cs(g, kb, n0 + wn * 32 + nt * 8 + 2 * tq + j);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[mt][nt][e] = __fadd_rn(acc[mt][nt][e],
                                         w8_part(part[mt][nt][e], rs[mt][e >> 1], cs[nt][e & 1]));
              part[mt][nt][e] = 0;
            }
      }
    }
    if (more) store_w(Bt[cur ^ 1], w);
    cp_wait<0>();
    __syncthreads();
  }

  // The store: kIntAcc (f32(P) s_w) s_x, kPerBlock acc s_x, kFused acc s_w
  // (per-channel) -- csrc/w8a8.cuh.
  float rs[2][2], cs[4][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) rs[mt][h] = w8_store_rs(g, m0 + wm * 32 + mt * 16 + gq + 8 * h);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) cs[nt][j] = w8_store_cs(g, n0 + wn * 32 + nt * 8 + 2 * tq + j);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float b = g.mode == kIntAcc ? __int2float_rn(part[mt][nt][e]) : acc[mt][nt][e];
        acc[mt][nt][e] = w8_out(b, cs[nt][e & 1], rs[mt][e >> 1]);
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
  if (bk < 1) return kUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (code) {
    case kBF16: return w8_quantize<__nv_bfloat16>(x, xq, sx, M, K, bk, fused, st);
    case kF16: return w8_quantize<__half>(x, xq, sx, M, K, bk, fused, st);
    case kF32: return w8_quantize<float>(x, xq, sx, M, K, bk, fused, st);
  }
  return kUnsupported;
}

// out (M, N) = xq (M, K) int8 . wq (K, N) int8 with the scales of ``mode``
// (csrc/w8a8.cuh), scale blocks of bk rows (a multiple of 32 unless
// kIntAcc).  vec: K a multiple of 16 (xq's rows 16-byte aligned).  Returns
// 0, a CUDA error code, or -1.
extern "C" int w8a8_gemm(const void* xq, const void* wq, const void* sw, const void* sx, void* out,
                         int M, int N, int K, int bk, int n_groups, int mode, int out_code, int vec,
                         void* stream) {
  if (mode < kFused || mode > kPerBlock || bk < 1 || (mode != kIntAcc && bk % kW8FoldStep))
    return kUnsupported;
  const int64_t gy = (M + WBM - 1) / WBM;
  if (gy > 65535) return kUnsupported;
  const W8a8 g{static_cast<const signed char*>(xq), static_cast<const signed char*>(wq),
               static_cast<const float*>(sw), static_cast<const float*>(sx), out, M, N, K, bk,
               n_groups, mode, out_code, vec};
  w8a8_gemm_kernel<<<dim3((N + WBN - 1) / WBN, static_cast<unsigned>(gy)), WTH, 0,
                     static_cast<cudaStream_t>(stream)>>>(g);
  return last_error();
}
