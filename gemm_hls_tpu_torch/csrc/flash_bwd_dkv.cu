// Kernel flash_bwd_dkv: dL/dk and dL/dv of flash attention from the
// forward's lse, recomputing the probabilities tile by tile:
//   p^T  = exp(s^T - lse),  s^T = cap(scale k q^T) masked,
//   ds^T = p^T (v dO^T - delta) [x (1 - (s / cap)^2) under a soft cap],
//   dv = p^T dO,   dk = scale ds^T q.
//
// Replaces two TPU kernels of gemm_hls_tpu/ops/pallas_flash.py:
//   * _flash_bwd_dkv_kernel (B10): q streamed over a rectangular grid with
//     the (block_kv, D) dk / dv accumulators stationary;
//   * _flash_bwd_dkv_tri (B12): B10 over the kv-major table of live pairs.
// Here one block owns one (kv tile, kv head) and loops over the live q
// tiles only (flash_common.cuh::q_range): a kv tile with no live q tile,
// which a sliding window can leave, writes zeros without loading a q tile.
// Tiles that straddle a mask edge, the q overhang (rows past S_q, whose
// zero-filled q and dO must not meet a stale lse: pallas_flash.py:1117-1129)
// or segment ids mask per element.
//
// GQA: the block also loops over the `group` q heads that share its kv
// head, so dk and dv come out per kv head, summed in fp32 in registers, and
// no (B * H_q, S_kv, D) per-q-head buffer is written or folded afterwards
// (the TPU kernel emitted per-q-head tiles that the caller summed).
//
// Routes: bf16 / fp16 on the tensor cores (mma.sync m16n8k16, fp32
// accumulation), 128 threads, 64 kv rows (16 a warp) x 32 q rows a step;
// the K and V tiles resident in shared memory (A operands), the q and dO
// tiles double-buffered by cp.async.  p^T and ds^T, rounded to the input
// type as the TPU kernel does, feed the dv and dk MMAs as A fragments.
// fp32 on the CUDA cores in IEEE fp32, four threads a kv row.
//
// What bounds it on an H100: four products of 2 S_q S_kv D each (8 in all,
// halved under causal): 34.4 GFLOP at 32 heads x 1024^2 x 128 bf16, 35 us
// at 989 TFLOP/s; bytes take 13 us at 3.35 TB/s.  The bf16 / fp16 calls at
// a head dim of 64 or 128 with at least 64 kv rows a head and 16-byte rows
// take the tile engine's kernel instead (csrc/flash_bwd_wgmma.cu: the two
// D-wide sums of two consumer warpgroups at 232 registers, 3.5-4.6x faster
// full / causal at 32 heads of 1024^2 x 128 bf16 on an H100 80GB HBM3);
// this file serves the rest (ops/flash.py::flash_bwd_route):
// fp32, other head dims, fewer than 64 kv rows, rows that are not whole
// 16-byte units.
#include "flash_common.cuh"

namespace gemm_hls {

constexpr int KQ = 32, KKV = 64, KT = 128;
constexpr int SQ = 32, SKV = 32, ST = 128;

template <typename T, int DMAX>
__global__ void __launch_bounds__(KT) flash_dkv_tc(const FlashArgs a) {
  constexpr int P = DMAX + 8, NT_D = DMAX / 8;
  extern __shared__ __align__(128) uint16_t ksm[];
  uint16_t* ks = ksm;
  uint16_t* vs = ks + KKV * P;
  uint16_t* qd = vs + KKV * P;  // [2][q, dO] tiles of KQ x P

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int kvh = a.b0 + blockIdx.y, c0 = blockIdx.x * KKV;
  // Every head of the group shares the mask (no kv_lengths here).
  const Mask mask = head_mask(a, kvh * a.group);
  int r_lo, r_hi;
  q_range(mask, c0, min(c0 + KKV, a.S_kv), a.S_q, r_lo, r_hi);
  const int i_lo = r_lo / KQ, n_i = r_hi > r_lo ? (r_hi + KQ - 1) / KQ - i_lo : 0;
  const int steps = n_i * a.group;

  load_tile16<KKV, DMAX, KT>(ks, a.k, kvh, c0, a.S_kv, a.D, a.vec);
  load_tile16<KKV, DMAX, KT>(vs, a.v, kvh, c0, a.S_kv, a.D, a.vec);
  if (steps > 0) {
    load_tile16<KQ, DMAX, KT>(qd, a.q, kvh * a.group, i_lo * KQ, a.S_q, a.D, a.vec);
    load_tile16<KQ, DMAX, KT>(qd + KQ * P, a.o, kvh * a.group, i_lo * KQ, a.S_q, a.D, a.vec);
  }
  cp_commit();

  float dk[NT_D][4], dv[NT_D][4];
#pragma unroll
  for (int t = 0; t < NT_D; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[t][e] = dv[t][e] = 0.f;
  const int c_loc[2] = {warp * 16 + gq, warp * 16 + gq + 8};
  int seg_kv[2] = {0, 0};
  if (a.kv_seg)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (c0 + c_loc[h] < a.S_kv)
        seg_kv[h] = a.kv_seg[static_cast<int64_t>(kvh) * a.S_kv + c0 + c_loc[h]];

  const int a_row = (lane % 8) + 8 * ((lane / 8) & 1), a_col = 8 * (lane / 16);
  const int b_row = (lane % 8) + 8 * (lane / 16), b_col = 8 * ((lane / 8) & 1);

  for (int it = 0; it < steps; ++it) {
    const int buf = it & 1, b = kvh * a.group + it / n_i, r0 = (i_lo + it % n_i) * KQ;
    if (it + 1 < steps) {
      const int nb = kvh * a.group + (it + 1) / n_i, nr = (i_lo + (it + 1) % n_i) * KQ;
      uint16_t* nxt = qd + (buf ^ 1) * 2 * KQ * P;
      load_tile16<KQ, DMAX, KT>(nxt, a.q, nb, nr, a.S_q, a.D, a.vec);
      load_tile16<KQ, DMAX, KT>(nxt + KQ * P, a.o, nb, nr, a.S_q, a.D, a.vec);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const uint16_t* qs = qd + buf * 2 * KQ * P;
    const uint16_t* dos = qs + KQ * P;

    float s[KQ / 8][4], dp[KQ / 8][4];
#pragma unroll
    for (int t = 0; t < KQ / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      uint32_t kf[4], vf[4];
      ldsm_x4(kf, ks + (warp * 16 + a_row) * P + kk * 16 + a_col);
      ldsm_x4(vf, vs + (warp * 16 + a_row) * P + kk * 16 + a_col);
#pragma unroll
      for (int np = 0; np < KQ / 16; ++np) {
        uint32_t qf[4], df[4];
        ldsm_x4(qf, qs + (np * 16 + b_row) * P + kk * 16 + b_col);
        ldsm_x4(df, dos + (np * 16 + b_row) * P + kk * 16 + b_col);
        mma16816<T>(s[2 * np], kf, qf[0], qf[1]);
        mma16816<T>(s[2 * np + 1], kf, qf[2], qf[3]);
        mma16816<T>(dp[2 * np], vf, df[0], df[1]);
        mma16816<T>(dp[2 * np + 1], vf, df[2], df[3]);
      }
    }

    // p^T = exp2(s log2(e) - lse log2(e)) per q column; the cap and the
    // mask are uniform branches around whole loops (flash_fwd.cu's rule);
    // a masked entry's p and ds are overwritten with 0 after the fact.
    float lse2[KQ / 8][2], del[KQ / 8][2];
#pragma unroll
    for (int t = 0; t < KQ / 8; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = r0 + t * 8 + 2 * tq + e;
        const int64_t ri = static_cast<int64_t>(b) * a.S_q + r;
        lse2[t][e] = r < a.S_q ? a.lse[ri] * kLog2e : 0.f;
        del[t][e] = r < a.S_q ? a.delta[ri] : 0.f;
      }
    if (a.cap > 0.f) {
#pragma unroll
      for (int t = 0; t < KQ / 8; ++t)
#pragma unroll
        for (int idx = 0; idx < 4; ++idx) {
          const float x = score(s[t][idx], a.scale, a.cap), u = x / a.cap;
          const float p = exp2f(x * kLog2e - lse2[t][idx & 1]);
          s[t][idx] = p;
          dp[t][idx] = p * (dp[t][idx] - del[t][idx & 1]) * (1.f - u * u);
        }
    } else {
      const float sl2 = a.scale * kLog2e;
#pragma unroll
      for (int t = 0; t < KQ / 8; ++t)
#pragma unroll
        for (int idx = 0; idx < 4; ++idx) {
          const float p = exp2f(s[t][idx] * sl2 - lse2[t][idx & 1]);
          s[t][idx] = p;
          dp[t][idx] = p * (dp[t][idx] - del[t][idx & 1]);
        }
    }
    if (a.q_seg || r0 + KQ > a.S_q || !interior(mask, r0, KQ, c0, KKV)) {
#pragma unroll
      for (int t = 0; t < KQ / 8; ++t)
#pragma unroll
        for (int idx = 0; idx < 4; ++idx) {
          // Column (q row) r of this thread's kv row c_loc[idx >> 1].
          const int r = r0 + t * 8 + 2 * tq + (idx & 1);
          bool ok = r < a.S_q && mask.ok(r, c0 + c_loc[idx >> 1]);
          if (ok && a.q_seg) ok = a.q_seg[static_cast<int64_t>(b) * a.S_q + r] == seg_kv[idx >> 1];
          if (!ok) s[t][idx] = dp[t][idx] = 0.f;
        }
    }
#pragma unroll
    for (int kk = 0; kk < KQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      pa[0] = MmaType<T>::pack(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = MmaType<T>::pack(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = MmaType<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = MmaType<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      da[0] = MmaType<T>::pack(dp[2 * kk][0], dp[2 * kk][1]);
      da[1] = MmaType<T>::pack(dp[2 * kk][2], dp[2 * kk][3]);
      da[2] = MmaType<T>::pack(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      da[3] = MmaType<T>::pack(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < DMAX / 16; ++dn) {
        uint32_t df[4], qf[4];
        ldsm_x4_t(df, dos + (kk * 16 + a_row) * P + dn * 16 + a_col);
        ldsm_x4_t(qf, qs + (kk * 16 + a_row) * P + dn * 16 + a_col);
        mma16816<T>(dv[2 * dn], pa, df[0], df[1]);
        mma16816<T>(dv[2 * dn + 1], pa, df[2], df[3]);
        mma16816<T>(dk[2 * dn], da, qf[0], qf[1]);
        mma16816<T>(dk[2 * dn + 1], da, qf[2], qf[3]);
      }
    }
    __syncthreads();
  }
  cp_wait<0>();

  void* gk = const_cast<void*>(a.g0.p);
  void* gv = const_cast<void*>(a.g1.p);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = c0 + c_loc[h];
    if (c >= a.S_kv) continue;
    const int64_t bk = a.g0.row(kvh, c), bv = a.g1.row(kvh, c);
#pragma unroll
    for (int t = 0; t < NT_D; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = t * 8 + 2 * tq + e;
        if (d < a.D) {
          MmaType<T>::store(gk, bk + d, dk[t][2 * h + e] * a.scale);
          MmaType<T>::store(gv, bv + d, dv[t][2 * h + e]);
        }
      }
  }
}

// fp32 on the CUDA cores: thread (row = kv row, sub) holds q columns
// sub + 4i of each q tile and dk / dv columns sub + 4i of its kv row.
template <int DMAX>
__global__ void __launch_bounds__(ST) flash_dkv_simt(const FlashArgs a) {
  constexpr int P = DMAX + 1, NC = SQ / 4, ND = DMAX / 4;
  extern __shared__ float ksm32[];
  float* ks = ksm32;
  float* vs = ks + SKV * P;
  float* qs = vs + SKV * P;
  float* dos = qs + SQ * P;
  const int row = threadIdx.x / 4, sub = threadIdx.x % 4, lane = threadIdx.x % 32;
  const int kvh = a.b0 + blockIdx.y, c0 = blockIdx.x * SKV, c = c0 + row;
  const Mask mask = head_mask(a, kvh * a.group);
  int r_lo, r_hi;
  q_range(mask, c0, min(c0 + SKV, a.S_kv), a.S_q, r_lo, r_hi);
  const int i_lo = r_lo / SQ, i_hi = r_hi > r_lo ? (r_hi + SQ - 1) / SQ : i_lo;
  const int seg_kv = (a.kv_seg && c < a.S_kv) ? a.kv_seg[static_cast<int64_t>(kvh) * a.S_kv + c] : 0;

  load_tile32<SKV, DMAX, ST>(ks, a.k, kvh, c0, a.S_kv, a.D);
  load_tile32<SKV, DMAX, ST>(vs, a.v, kvh, c0, a.S_kv, a.D);
  float dk[ND], dv[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) dk[i] = dv[i] = 0.f;
  for (int g = 0; g < a.group; ++g) {
    const int b = kvh * a.group + g;
    for (int i = i_lo; i < i_hi; ++i) {
      const int r0 = i * SQ;
      __syncthreads();
      load_tile32<SQ, DMAX, ST>(qs, a.q, b, r0, a.S_q, a.D);
      load_tile32<SQ, DMAX, ST>(dos, a.o, b, r0, a.S_q, a.D);
      __syncthreads();
      const bool edge = a.q_seg || r0 + SQ > a.S_q || !interior(mask, r0, SQ, c0, SKV);
      float p[NC], ds[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int r = r0 + sub + 4 * j;
        const bool rl = r < a.S_q;
        const int64_t ri = static_cast<int64_t>(b) * a.S_q + r;
        float dot = 0.f, dpv = 0.f;
        for (int d = 0; d < a.D; ++d) {
          dot = fmaf(ks[row * P + d], qs[(sub + 4 * j) * P + d], dot);
          dpv = fmaf(vs[row * P + d], dos[(sub + 4 * j) * P + d], dpv);
        }
        bool ok = true;
        if (edge) {
          ok = rl && mask.ok(r, c);
          if (ok && a.q_seg) ok = a.q_seg[ri] == seg_kv;
        }
        const float x = score(dot, a.scale, a.cap);
        p[j] = ok ? expf(x - a.lse[ri]) : 0.f;
        ds[j] = ok ? p[j] * (dpv - a.delta[ri]) : 0.f;
        if (a.cap > 0.f) {
          const float u = x / a.cap;
          ds[j] *= 1.f - u * u;
        }
      }
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int src = 0; src < 4; ++src) {
          const int from = (lane & ~3) | src;
          const float pj = __shfl_sync(0xffffffffu, p[j], from);
          const float dj = __shfl_sync(0xffffffffu, ds[j], from);
          const float* qrow = qs + (src + 4 * j) * P;
          const float* drow = dos + (src + 4 * j) * P;
#pragma unroll
          for (int dd = 0; dd < ND; ++dd) {
            dv[dd] = fmaf(pj, drow[sub + 4 * dd], dv[dd]);
            dk[dd] = fmaf(dj, qrow[sub + 4 * dd], dk[dd]);
          }
        }
    }
  }
  if (c >= a.S_kv) return;
  float* gk = static_cast<float*>(const_cast<void*>(a.g0.p)) + a.g0.row(kvh, c);
  float* gv = static_cast<float*>(const_cast<void*>(a.g1.p)) + a.g1.row(kvh, c);
#pragma unroll
  for (int dd = 0; dd < ND; ++dd)
    if (sub + 4 * dd < a.D) {
      gk[sub + 4 * dd] = dk[dd] * a.scale;
      gv[sub + 4 * dd] = dv[dd];
    }
}

template <typename K>
int launch_dkv(K kernel, int rows, int threads, int smem, const FlashArgs& a, cudaStream_t st) {
  const int attr = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (attr) return attr;
  const unsigned n_kv = (a.S_kv + rows - 1) / rows;
  return for_head_chunks(a, a.B / a.group, [&](const FlashArgs& c, unsigned n) {
    kernel<<<dim3(n_kv, n), threads, smem, st>>>(c);
  });
}

}  // namespace gemm_hls

using namespace gemm_hls;

// seqs: (pointer, heads, sb, sh, ss) x {q, k, v, dO, dk, dv}, dk / dv with
// B_kv = B / group heads; dims, lse, delta, q_seg, kv_seg and offs as
// flash_bwd_dq's.  Returns 0, a CUDA error code, or -1.
extern "C" int flash_bwd_dkv(const int64_t* seqs, const void* lse, const void* delta,
                             const void* q_seg, const void* kv_seg, const void* offs,
                             const int* dims, float cap, float scale, int dtype, void* stream) {
  FlashArgs a{};
  a.q = seq_from(seqs);
  a.k = seq_from(seqs + 5);
  a.v = seq_from(seqs + 10);
  a.o = seq_from(seqs + 15);
  a.g0 = seq_from(seqs + 20);
  a.g1 = seq_from(seqs + 25);
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
  const int tc64 = (2 * KKV + 4 * KQ) * (64 + 8) * 2, tc128 = (2 * KKV + 4 * KQ) * (128 + 8) * 2;
  const int f64 = 2 * (SQ + SKV) * (64 + 1) * 4, f128 = 2 * (SQ + SKV) * (128 + 1) * 4;
  switch (dtype) {
    case kBF16:
      return small ? launch_dkv(flash_dkv_tc<__nv_bfloat16, 64>, KKV, KT, tc64, a, st)
                   : launch_dkv(flash_dkv_tc<__nv_bfloat16, 128>, KKV, KT, tc128, a, st);
    case kF16:
      return small ? launch_dkv(flash_dkv_tc<__half, 64>, KKV, KT, tc64, a, st)
                   : launch_dkv(flash_dkv_tc<__half, 128>, KKV, KT, tc128, a, st);
    case kF32:
      return small ? launch_dkv(flash_dkv_simt<64>, SKV, ST, f64, a, st)
                   : launch_dkv(flash_dkv_simt<128>, SKV, ST, f128, a, st);
    default: return kUnsupported;
  }
}
