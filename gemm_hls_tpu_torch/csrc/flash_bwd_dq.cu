// Kernel flash_bwd_dq: dL/dq of flash attention from the forward's lse,
// recomputing the probabilities tile by tile (the O(S^2) matrix is never
// stored):
//   p  = exp(s - lse),  s = cap(scale q k^T) masked,
//   ds = p (dO v^T - delta) [x (1 - (s / cap)^2) under a soft cap],
//   dq = scale ds k,
// with delta = sum_d dO * O (computed in fp32 by the caller).
//
// Replaces two TPU kernels of gemm_hls_tpu/ops/pallas_flash.py:
//   * _flash_bwd_dq_kernel (B9): kv streamed over a rectangular grid, dead
//     causal blocks predicated off;
//   * _flash_bwd_dq_tri (B11): B9 over the table of live (q tile, kv tile)
//     pairs, interior blocks unmasked.
// Here one block owns one (q tile, q head) and loops over the live kv tiles
// only (flash_common.cuh::kv_range); a tile that straddles a mask edge, or
// any tile under segment ids, masks per element.  GQA: head b reads kv head
// b / group.  Offsets shift the causal / window positions as in the forward.
//
// Routes: bf16 / fp16 on the tensor cores (mma.sync m16n8k16, fp32
// accumulation), 128 threads, 64 q rows x 64 kv rows a tile, the q and dO
// tiles resident in shared memory and the K / V tiles double-buffered by
// cp.async; S and dO v^T come out of the MMA in registers, and ds, rounded
// to the input type as the TPU kernel's ds.astype(k.dtype) does, feeds the
// ds k MMA as A fragments.  fp32 on the CUDA cores in IEEE fp32, four
// threads a q row (flash_fwd.cu's layout).
//
// What bounds it on an H100: three products of 2 S_q S_kv D each (6 in
// all, halved under causal): 25.8 GFLOP at 32 heads x 1024^2 x 128 bf16,
// 26 us at 989 TFLOP/s; the bytes (q, k, v, dO, lse, delta read once, dq
// written once) take 12 us at 3.35 TB/s.  The bf16 / fp16 calls at a head
// dim of 64 or 128 with at least 64 q rows a head and 16-byte rows take
// the tile engine's kernel instead (csrc/flash_bwd_wgmma.cu: TMA and
// wgmma, 3.4-4.8x faster full / causal at 32 heads of 1024^2 x 128 bf16 on
// an H100 80GB HBM3); this file serves the rest
// (ops/flash.py::flash_bwd_route): fp32, other head dims, fewer than 64 q
// rows, rows that are not whole 16-byte units.
#include "flash_common.cuh"

namespace gemm_hls {

constexpr int BQ = 64, BKV = 64, BT = 128;
constexpr int SQ = 32, SKV = 32, ST = 128;

template <typename T, int DMAX>
__global__ void __launch_bounds__(BT) flash_dq_tc(const FlashArgs a) {
  constexpr int P = DMAX + 8, NT_D = DMAX / 8;
  extern __shared__ __align__(128) uint16_t dsm[];
  uint16_t* qs = dsm;
  uint16_t* dos = qs + BQ * P;
  uint16_t* kvs = dos + BQ * P;  // [2][K, V] tiles of BKV x P

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int b = a.b0 + blockIdx.y, kvh = b / a.group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const Mask mask = head_mask(a, b);
  int c_lo, c_hi;
  kv_range(mask, q0, min(q0 + BQ, a.S_q), c_lo, c_hi);
  const int j_lo = c_lo / BKV, j_hi = c_hi > c_lo ? (c_hi + BKV - 1) / BKV : j_lo;

  load_tile16<BQ, DMAX, BT>(qs, a.q, b, q0, a.S_q, a.D, a.vec);
  load_tile16<BQ, DMAX, BT>(dos, a.o, b, q0, a.S_q, a.D, a.vec);
  if (j_lo < j_hi) {
    load_tile16<BKV, DMAX, BT>(kvs, a.k, kvh, j_lo * BKV, a.S_kv, a.D, a.vec);
    load_tile16<BKV, DMAX, BT>(kvs + BKV * P, a.v, kvh, j_lo * BKV, a.S_kv, a.D, a.vec);
  }
  cp_commit();

  const int r_loc[2] = {warp * 16 + gq, warp * 16 + gq + 8};
  float lse_r[2] = {0.f, 0.f}, del_r[2] = {0.f, 0.f};
  int seg_q[2] = {0, 0};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + r_loc[h];
    if (r < a.S_q) {
      const int64_t i = static_cast<int64_t>(b) * a.S_q + r;
      lse_r[h] = a.lse[i];
      del_r[h] = a.delta[i];
      if (a.q_seg) seg_q[h] = a.q_seg[i];
    }
  }
  const float lse2[2] = {lse_r[0] * kLog2e, lse_r[1] * kLog2e};
  float acc[NT_D][4];
#pragma unroll
  for (int t = 0; t < NT_D; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  const int a_row = (lane % 8) + 8 * ((lane / 8) & 1), a_col = 8 * (lane / 16);
  const int b_row = (lane % 8) + 8 * (lane / 16), b_col = 8 * ((lane / 8) & 1);

  for (int j = j_lo; j < j_hi; ++j) {
    const int buf = (j - j_lo) & 1;
    if (j + 1 < j_hi) {
      uint16_t* nxt = kvs + (buf ^ 1) * 2 * BKV * P;
      load_tile16<BKV, DMAX, BT>(nxt, a.k, kvh, (j + 1) * BKV, a.S_kv, a.D, a.vec);
      load_tile16<BKV, DMAX, BT>(nxt + BKV * P, a.v, kvh, (j + 1) * BKV, a.S_kv, a.D, a.vec);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const uint16_t* ks = kvs + buf * 2 * BKV * P;
    const uint16_t* vs = ks + BKV * P;

    // A warp whose 16 rows all lie past S_q skips the tile's arithmetic.
    if (q0 + warp * 16 < a.S_q) {
      float s[BKV / 8][4], dp[BKV / 8][4];
#pragma unroll
      for (int t = 0; t < BKV / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk) {
        uint32_t qf[4], df[4];
        ldsm_x4(qf, qs + (warp * 16 + a_row) * P + kk * 16 + a_col);
        ldsm_x4(df, dos + (warp * 16 + a_row) * P + kk * 16 + a_col);
#pragma unroll
        for (int np = 0; np < BKV / 16; ++np) {
          uint32_t kf[4], vf[4];
          ldsm_x4(kf, ks + (np * 16 + b_row) * P + kk * 16 + b_col);
          ldsm_x4(vf, vs + (np * 16 + b_row) * P + kk * 16 + b_col);
          mma16816<T>(s[2 * np], qf, kf[0], kf[1]);
          mma16816<T>(s[2 * np + 1], qf, kf[2], kf[3]);
          mma16816<T>(dp[2 * np], df, vf[0], vf[1]);
          mma16816<T>(dp[2 * np + 1], df, vf[2], vf[3]);
        }
      }

      // p = exp2(s log2(e) - lse log2(e)); the cap and the mask are uniform
      // branches around whole loops (flash_fwd.cu's rule), and a masked
      // entry's ds is overwritten with 0 after the fact.
      if (a.cap > 0.f) {
#pragma unroll
        for (int t = 0; t < BKV / 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = score(s[t][e], a.scale, a.cap), u = x / a.cap;
            const float p = exp2f(x * kLog2e - lse2[e >> 1]);
            s[t][e] = p * (dp[t][e] - del_r[e >> 1]) * (1.f - u * u);
          }
      } else {
        const float sl2 = a.scale * kLog2e;
#pragma unroll
        for (int t = 0; t < BKV / 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2f(s[t][e] * sl2 - lse2[e >> 1]);
            s[t][e] = p * (dp[t][e] - del_r[e >> 1]);
          }
      }
      const int c0 = j * BKV;
      if (a.q_seg || !interior(mask, q0, BQ, c0, BKV)) {
#pragma unroll
        for (int t = 0; t < BKV / 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1, c = c0 + t * 8 + 2 * tq + (e & 1);
            bool ok = mask.ok(q0 + r_loc[h], c);
            if (ok && a.q_seg) ok = seg_q[h] == a.kv_seg[static_cast<int64_t>(kvh) * a.S_kv + c];
            if (!ok) s[t][e] = 0.f;
          }
      }
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        uint32_t da[4];
        da[0] = MmaType<T>::pack(s[2 * kk][0], s[2 * kk][1]);
        da[1] = MmaType<T>::pack(s[2 * kk][2], s[2 * kk][3]);
        da[2] = MmaType<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        da[3] = MmaType<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int dn = 0; dn < DMAX / 16; ++dn) {
          uint32_t kf[4];
          ldsm_x4_t(kf, ks + (kk * 16 + a_row) * P + dn * 16 + a_col);
          mma16816<T>(acc[2 * dn], da, kf[0], kf[1]);
          mma16816<T>(acc[2 * dn + 1], da, kf[2], kf[3]);
        }
      }
    }
    __syncthreads();
  }
  cp_wait<0>();

  void* dq = const_cast<void*>(a.g0.p);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + r_loc[h];
    if (r >= a.S_q) continue;
    const int64_t base = a.g0.row(b, r);
#pragma unroll
    for (int t = 0; t < NT_D; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = t * 8 + 2 * tq + e;
        if (d < a.D) MmaType<T>::store(dq, base + d, acc[t][2 * h + e] * a.scale);
      }
  }
}

// fp32 on the CUDA cores, flash_fwd.cu's layout: thread (row, sub) holds
// kv columns sub + 4i of its q row and dq columns sub + 4i.
template <int DMAX>
__global__ void __launch_bounds__(ST) flash_dq_simt(const FlashArgs a) {
  constexpr int P = DMAX + 1, NC = SKV / 4, ND = DMAX / 4;
  extern __shared__ float dsm32[];
  float* qs = dsm32;
  float* dos = qs + SQ * P;
  float* ks = dos + SQ * P;
  float* vs = ks + SKV * P;
  const int row = threadIdx.x / 4, sub = threadIdx.x % 4, lane = threadIdx.x % 32;
  const int b = a.b0 + blockIdx.y, kvh = b / a.group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * SQ, r = q0 + row;
  const Mask mask = head_mask(a, b);
  int c_lo, c_hi;
  kv_range(mask, q0, min(q0 + SQ, a.S_q), c_lo, c_hi);
  const int j_lo = c_lo / SKV, j_hi = c_hi > c_lo ? (c_hi + SKV - 1) / SKV : j_lo;
  const int64_t ri = static_cast<int64_t>(b) * a.S_q + r;
  const bool live = r < a.S_q;
  const float lse = live ? a.lse[ri] : 0.f, del = live ? a.delta[ri] : 0.f;
  const int seg_q = (a.q_seg && live) ? a.q_seg[ri] : 0;

  load_tile32<SQ, DMAX, ST>(qs, a.q, b, q0, a.S_q, a.D);
  load_tile32<SQ, DMAX, ST>(dos, a.o, b, q0, a.S_q, a.D);
  float acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0.f;
  for (int j = j_lo; j < j_hi; ++j) {
    const int c0 = j * SKV;
    __syncthreads();
    load_tile32<SKV, DMAX, ST>(ks, a.k, kvh, c0, a.S_kv, a.D);
    load_tile32<SKV, DMAX, ST>(vs, a.v, kvh, c0, a.S_kv, a.D);
    __syncthreads();
    const bool edge = a.q_seg || !interior(mask, q0, SQ, c0, SKV);
    float ds[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = sub + 4 * i;
      float dot = 0.f, dpv = 0.f;
      for (int d = 0; d < a.D; ++d) {
        dot = fmaf(qs[row * P + d], ks[c * P + d], dot);
        dpv = fmaf(dos[row * P + d], vs[c * P + d], dpv);
      }
      bool ok = true;
      if (edge) {
        ok = mask.ok(r, c0 + c);
        if (ok && a.q_seg) ok = seg_q == a.kv_seg[static_cast<int64_t>(kvh) * a.S_kv + c0 + c];
      }
      const float x = score(dot, a.scale, a.cap);
      const float p = ok ? expf(x - lse) : 0.f;
      ds[i] = p * (dpv - del);
      if (a.cap > 0.f) {
        const float u = x / a.cap;
        ds[i] *= 1.f - u * u;
      }
    }
#pragma unroll
    for (int i = 0; i < NC; ++i)
#pragma unroll
      for (int src = 0; src < 4; ++src) {
        const float g = __shfl_sync(0xffffffffu, ds[i], (lane & ~3) | src);
        const float* krow = ks + (src + 4 * i) * P;
#pragma unroll
        for (int dd = 0; dd < ND; ++dd) acc[dd] = fmaf(g, krow[sub + 4 * dd], acc[dd]);
      }
  }
  if (!live) return;
  float* dq = static_cast<float*>(const_cast<void*>(a.g0.p)) + a.g0.row(b, r);
#pragma unroll
  for (int dd = 0; dd < ND; ++dd)
    if (sub + 4 * dd < a.D) dq[sub + 4 * dd] = acc[dd] * a.scale;
}

template <typename K>
int launch_dq(K kernel, int rows, int threads, int smem, const FlashArgs& a, cudaStream_t st) {
  const int attr = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (attr) return attr;
  const unsigned n_q = (a.S_q + rows - 1) / rows;
  return for_head_chunks(a, a.B, [&](const FlashArgs& c, unsigned n) {
    kernel<<<dim3(n_q, n), threads, smem, st>>>(c);
  });
}

}  // namespace gemm_hls

using namespace gemm_hls;

// seqs: (pointer, heads, sb, sh, ss) x {q, k, v, dO, dq}; dims as
// flash_fwd's; lse and delta: (B, S_q) fp32; q_seg / kv_seg / offs as
// flash_fwd's, each or null.  Returns 0, a CUDA error code, or -1.
extern "C" int flash_bwd_dq(const int64_t* seqs, const void* lse, const void* delta,
                            const void* q_seg, const void* kv_seg, const void* offs,
                            const int* dims, float cap, float scale, int dtype, void* stream) {
  FlashArgs a{};
  a.q = seq_from(seqs);
  a.k = seq_from(seqs + 5);
  a.v = seq_from(seqs + 10);
  a.o = seq_from(seqs + 15);
  a.g0 = seq_from(seqs + 20);
  a.lse = static_cast<float*>(const_cast<void*>(lse));
  a.delta = static_cast<const float*>(delta);
  a.q_seg = static_cast<const int*>(q_seg);
  a.kv_seg = static_cast<const int*>(kv_seg);
  a.offs = static_cast<const int*>(offs);
  dims_into(a, dims);
  a.cap = cap;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.D < 1 || a.D > 128) return kUnsupported;
  const bool small = a.D <= 64;
  const int tc64 = (2 * BQ + 4 * BKV) * (64 + 8) * 2, tc128 = (2 * BQ + 4 * BKV) * (128 + 8) * 2;
  const int f64 = 2 * (SQ + SKV) * (64 + 1) * 4, f128 = 2 * (SQ + SKV) * (128 + 1) * 4;
  switch (dtype) {
    case kBF16:
      return small ? launch_dq(flash_dq_tc<__nv_bfloat16, 64>, BQ, BT, tc64, a, st)
                   : launch_dq(flash_dq_tc<__nv_bfloat16, 128>, BQ, BT, tc128, a, st);
    case kF16:
      return small ? launch_dq(flash_dq_tc<__half, 64>, BQ, BT, tc64, a, st)
                   : launch_dq(flash_dq_tc<__half, 128>, BQ, BT, tc128, a, st);
    case kF32:
      return small ? launch_dq(flash_dq_simt<64>, SQ, ST, f64, a, st)
                   : launch_dq(flash_dq_simt<128>, SQ, ST, f128, a, st);
    default: return kUnsupported;
  }
}
