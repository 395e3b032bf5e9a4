// Kernel flash_fwd: the flash-attention forward, o = softmax(scale q k^T) v
// per head, with the optional per-row log-sum-exp lse = m + log(l).
//
// Replaces three TPU kernels of gemm_hls_tpu/ops/pallas_flash.py:
//   * _flash_kernel (B6): the online-softmax step over a rectangular
//     (head, q tile, kv tile) grid, with causal, window, kv_lengths,
//     segment ids, offsets, GQA and the soft cap;
//   * _flash_kernel_tri (B7): B6 over a scalar-prefetched table of live
//     (q tile, kv tile) pairs, with an "interior" flag that skips the
//     in-block mask;
//   * _flash_kernel_onepass (B8): B6 with the whole KV resident and one grid
//     step per q tile.
// B7 and B8 exist to cut the TPU grid's per-step overhead, which Hopper does
// not have.  Here one block owns one (q tile, head) and loops over kv tiles
// itself; the loop's first and last tile come from causal, window,
// kv_lengths and offsets (flash_common.cuh::kv_range), so a dead tile is
// never loaded, and only a tile that straddles a mask edge (or any tile,
// under segment ids) evaluates the mask per element.  The carries m, l and
// the (tile, D) accumulator stay in registers for the whole loop; the q
// tile is read once.  GQA: head b reads kv head b / group, never a copy.
//
// Which calls take it (ops/flash.py::flash_route): bf16 / fp16 with a head
// dim other than 64 or 128 or with rows that are not whole 16-byte units;
// bf16 / fp16 at D 64 or 128 with aligned rows where a head has fewer than
// 64 query rows and its kv head more than 16 (group x S_q); every fp32
// call.  The other bf16 / fp16 calls at D 64 or 128 with aligned rows take
// the tile engine's csrc/flash_wgmma.cu (64 rows a head or more) or the
// split-KV decode csrc/flash_decode.cu (16 rows a kv head or fewer).
//
// Routes by element type:
//   bf16, fp16 -> tensor cores, mma.sync m16n8k16 with fp32 accumulation.
//     256 threads, BQ = 128 q rows (16 a warp: eight warps share each K / V
//     tile), BKV = 64 kv rows a tile; the head dimension is a compiled bound
//     DMAX (64 or 128), a smaller D zero-filled at load, whose columns then
//     add zeros (a run-time bound on the 16-deep steps would split every
//     ldmatrix + MMA step into its own basic block: 1.5x slower).  The q
//     fragments stay in registers; K and V tiles are double-buffered in
//     shared memory by cp.async; S = q k^T comes out of the MMA in
//     registers, is scaled (in log2 units, for exp2f), capped, masked and
//     exponentiated there, the cap and the mask as uniform branches around
//     whole loops, and the probabilities, rounded to the input type as the
//     TPU kernel's p.astype(v.dtype) does, feed the p v MMA as A fragments
//     without a trip through shared memory.
//   fp32 -> CUDA cores in IEEE fp32 (the rule of B1's fp32 route): 128
//     threads, BQ = 32 rows, four threads a row, BKV = 32.
//
// What bounds it on an H100: at the main path's shapes (32 heads x 1024^2 x
// 128 bf16, 17.2 GFLOP full, 8.6 causal) the tensor-core rate, 17 us at
// 989 TFLOP/s, against 34 MB of q, k, v and o, 10 us at 3.35 TB/s.  The
// padded-cache decode step (64 x 4 kv heads x ~3000 cached rows, 4 q rows a
// kv head, ~400 MB of cache, bound by bytes) left it for the split-KV
// decode (csrc/flash_decode.cu): one block a kv head here walks the whole
// cache and leaves SMs idle (H100 80GB HBM3, 700 W, chip_smoke.py phase 15
// in turns: 0.3198 ms against the split-KV decode's 0.1245).  Measured
// (the same card and phase, where it is timed as the other routes'
// mma.sync tile, named):
// ~0.15 ms at 32 x 1024^2 x 128 bf16 full or causal, 110 TFLOP/s; see
// PERF.md §6.
#include "flash_common.cuh"

namespace gemm_hls {

constexpr int FQ = 128, FKV = 64, FT = 256;  // tensor-core tile
constexpr int SQ = 32, SKV = 32, ST = 128;  // CUDA-core tile

template <typename T, int DMAX>
__global__ void __launch_bounds__(FT) flash_fwd_tc(const FlashArgs a) {
  constexpr int P = DMAX + 8, NT_D = DMAX / 8;
  extern __shared__ __align__(128) uint16_t fsm[];
  uint16_t* qs = fsm;
  uint16_t* kvs = fsm + FQ * P;  // [2][K, V] tiles of FKV x P

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int b = a.b0 + blockIdx.y, kvh = b / a.group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FQ;  // longest causal rows first
  const Mask mask = head_mask(a, b);
  int c_lo, c_hi;
  kv_range(mask, q0, min(q0 + FQ, a.S_q), c_lo, c_hi);
  const int j_lo = c_lo / FKV, j_hi = c_hi > c_lo ? (c_hi + FKV - 1) / FKV : j_lo;

  load_tile16<FQ, DMAX, FT>(qs, a.q, b, q0, a.S_q, a.D, a.vec);
  // K and V rows at or past kv_lim (a padded cache's stale slots) are
  // zero-filled, never read: 0 * NaN would poison the p v product.
  if (j_lo < j_hi) {
    load_tile16<FKV, DMAX, FT>(kvs, a.k, kvh, j_lo * FKV, mask.kv_lim, a.D, a.vec);
    load_tile16<FKV, DMAX, FT>(kvs + FKV * P, a.v, kvh, j_lo * FKV, mask.kv_lim, a.D, a.vec);
  }
  cp_commit();

  float acc[NT_D][4];
#pragma unroll
  for (int t = 0; t < NT_D; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  float m_r[2] = {kMask, kMask}, l_r[2] = {0.f, 0.f};
  uint32_t qf[DMAX / 16][4];
  const int r_loc[2] = {warp * 16 + gq, warp * 16 + gq + 8};
  int seg_q[2] = {0, 0};
  if (a.q_seg)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (q0 + r_loc[h] < a.S_q) seg_q[h] = a.q_seg[static_cast<int64_t>(b) * a.S_q + q0 + r_loc[h]];

  const int a_row = (lane % 8) + 8 * ((lane / 8) & 1), a_col = 8 * (lane / 16);
  const int b_row = (lane % 8) + 8 * (lane / 16), b_col = 8 * ((lane / 8) & 1);

  for (int j = j_lo; j < j_hi; ++j) {
    const int buf = (j - j_lo) & 1;
    if (j + 1 < j_hi) {
      uint16_t* nxt = kvs + (buf ^ 1) * 2 * FKV * P;
      load_tile16<FKV, DMAX, FT>(nxt, a.k, kvh, (j + 1) * FKV, mask.kv_lim, a.D, a.vec);
      load_tile16<FKV, DMAX, FT>(nxt + FKV * P, a.v, kvh, (j + 1) * FKV, mask.kv_lim, a.D,
                                 a.vec);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    // A warp whose 16 rows all lie past S_q skips the tile's arithmetic
    // (decode packs a GQA group of 4 rows: 7 of 8 warps idle).
    if (q0 + warp * 16 < a.S_q) {
      if (j == j_lo) {
#pragma unroll
        for (int kk = 0; kk < DMAX / 16; ++kk)
          ldsm_x4(qf[kk], qs + (warp * 16 + a_row) * P + kk * 16 + a_col);
      }
      const uint16_t* ks = kvs + buf * 2 * FKV * P;
      const uint16_t* vs = ks + FKV * P;

      float s[FKV / 8][4];
#pragma unroll
      for (int t = 0; t < FKV / 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < FKV / 16; ++np) {
          uint32_t kf[4];
          ldsm_x4(kf, ks + (np * 16 + b_row) * P + kk * 16 + b_col);
          mma16816<T>(s[2 * np], qf[kk], kf[0], kf[1]);
          mma16816<T>(s[2 * np + 1], qf[kk], kf[2], kf[3]);
        }
      }

      const int c0 = j * FKV;
      const bool edge = a.q_seg || !interior(mask, q0, FQ, c0, FKV);
      // Scores in log2 units (exp2 is one MUFU op): the cap and the mask
      // are uniform branches around whole loops, never per-element selects.
      if (a.cap > 0.f) {
#pragma unroll
        for (int t = 0; t < FKV / 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[t][e] = score(s[t][e], a.scale, a.cap) * kLog2e;
      } else {
        const float sl2 = a.scale * kLog2e;
#pragma unroll
        for (int t = 0; t < FKV / 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[t][e] *= sl2;
      }
      if (edge) {
#pragma unroll
        for (int t = 0; t < FKV / 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1, c = c0 + t * 8 + 2 * tq + (e & 1);
            bool ok = mask.ok(q0 + r_loc[h], c);
            if (ok && a.q_seg) ok = seg_q[h] == a.kv_seg[static_cast<int64_t>(kvh) * a.S_kv + c];
            if (!ok) s[t][e] = kMask;
          }
      }
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int t = 0; t < FKV / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[t][e]);
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        corr[h] = exp2f(m_r[h] - mx[h]);
        m_r[h] = mx[h];
        l_r[h] *= corr[h];
      }
      if (edge) {
#pragma unroll
        for (int t = 0; t < FKV / 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // A masked probability is exactly 0 (kMask - kMask would give 1).
            const float p = s[t][e] == kMask ? 0.f : exp2f(s[t][e] - m_r[e >> 1]);
            s[t][e] = p;
            l_r[e >> 1] += p;
          }
      } else {
#pragma unroll
        for (int t = 0; t < FKV / 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2f(s[t][e] - m_r[e >> 1]);
            s[t][e] = p;
            l_r[e >> 1] += p;
          }
      }
#pragma unroll
      for (int t = 0; t < NT_D; ++t) {
        acc[t][0] *= corr[0];
        acc[t][1] *= corr[0];
        acc[t][2] *= corr[1];
        acc[t][3] *= corr[1];
      }
#pragma unroll
      for (int kk = 0; kk < FKV / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = MmaType<T>::pack(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = MmaType<T>::pack(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = MmaType<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = MmaType<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int dn = 0; dn < DMAX / 16; ++dn) {
          uint32_t vf[4];
          ldsm_x4_t(vf, vs + (kk * 16 + a_row) * P + dn * 16 + a_col);
          mma16816<T>(acc[2 * dn], pa, vf[0], vf[1]);
          mma16816<T>(acc[2 * dn + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // the next iteration refills the other buffer's twin
  }
  cp_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
  }
  void* o = const_cast<void*>(a.o.p);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + r_loc[h];
    if (r >= a.S_q) continue;
    const float inv = 1.f / (l_r[h] == 0.f ? 1.f : l_r[h]);
    const int64_t base = a.o.row(b, r);
    if (a.o_f32) {  // fp32 o (ops/flash.py out_dtype=float32): the sum / l unrounded
      float* of = static_cast<float*>(o) + base;
#pragma unroll
      for (int t = 0; t < NT_D; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = t * 8 + 2 * tq + e;
          if (d < a.D) of[d] = acc[t][2 * h + e] * inv;
        }
    } else {
#pragma unroll
      for (int t = 0; t < NT_D; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = t * 8 + 2 * tq + e;
          if (d < a.D) MmaType<T>::store(o, base + d, acc[t][2 * h + e] * inv);
        }
    }
    if (a.lse && tq == 0) a.lse[static_cast<int64_t>(b) * a.S_q + r] = m_r[h] * kLn2 + logf(l_r[h]);
  }
}

// fp32 on the CUDA cores: thread (row = tid / 4, sub = tid % 4) holds the
// scores of kv columns sub + 4i and the output columns d = sub + 4i of its
// row; a probability reaches the other three threads of its row by shuffle.
template <int DMAX>
__global__ void __launch_bounds__(ST) flash_fwd_simt(const FlashArgs a) {
  constexpr int P = DMAX + 1, NC = SKV / 4, ND = DMAX / 4;
  extern __shared__ float fsm32[];
  float* qs = fsm32;
  float* ks = qs + SQ * P;
  float* vs = ks + SKV * P;
  const int row = threadIdx.x / 4, sub = threadIdx.x % 4, lane = threadIdx.x % 32;
  const int b = a.b0 + blockIdx.y, kvh = b / a.group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * SQ, r = q0 + row;
  const Mask mask = head_mask(a, b);
  int c_lo, c_hi;
  kv_range(mask, q0, min(q0 + SQ, a.S_q), c_lo, c_hi);
  const int j_lo = c_lo / SKV, j_hi = c_hi > c_lo ? (c_hi + SKV - 1) / SKV : j_lo;
  const int seg_q = (a.q_seg && r < a.S_q) ? a.q_seg[static_cast<int64_t>(b) * a.S_q + r] : 0;

  load_tile32<SQ, DMAX, ST>(qs, a.q, b, q0, a.S_q, a.D);
  float acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0.f;
  float m = kMask, l = 0.f;
  for (int j = j_lo; j < j_hi; ++j) {
    const int c0 = j * SKV;
    __syncthreads();
    load_tile32<SKV, DMAX, ST>(ks, a.k, kvh, c0, mask.kv_lim, a.D);
    load_tile32<SKV, DMAX, ST>(vs, a.v, kvh, c0, mask.kv_lim, a.D);
    __syncthreads();
    const bool edge = a.q_seg || !interior(mask, q0, SQ, c0, SKV);
    float s[NC], mx = m;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = sub + 4 * i;
      float dot = 0.f;
      for (int d = 0; d < a.D; ++d) dot = fmaf(qs[row * P + d], ks[c * P + d], dot);
      float x = score(dot, a.scale, a.cap);
      if (edge) {
        bool ok = mask.ok(r, c0 + c);
        if (ok && a.q_seg) ok = seg_q == a.kv_seg[static_cast<int64_t>(kvh) * a.S_kv + c0 + c];
        if (!ok) x = kMask;
      }
      s[i] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float corr = expf(m - mx);
    m = mx;
    l *= corr;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      s[i] = (edge && s[i] == kMask) ? 0.f : expf(s[i] - m);
      l += s[i];
    }
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] *= corr;
#pragma unroll
    for (int i = 0; i < NC; ++i)
#pragma unroll
      for (int src = 0; src < 4; ++src) {
        const float p = __shfl_sync(0xffffffffu, s[i], (lane & ~3) | src);
        const float* vrow = vs + (src + 4 * i) * P;
#pragma unroll
        for (int dd = 0; dd < ND; ++dd) acc[dd] = fmaf(p, vrow[sub + 4 * dd], acc[dd]);
      }
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  if (r >= a.S_q) return;
  const float inv = 1.f / (l == 0.f ? 1.f : l);
  float* o = static_cast<float*>(const_cast<void*>(a.o.p)) + a.o.row(b, r);
#pragma unroll
  for (int dd = 0; dd < ND; ++dd)
    if (sub + 4 * dd < a.D) o[sub + 4 * dd] = acc[dd] * inv;
  if (a.lse && sub == 0) a.lse[static_cast<int64_t>(b) * a.S_q + r] = m + logf(l);
}

template <typename K>
int launch_flash(K kernel, int rows, int threads, int smem, const FlashArgs& a, cudaStream_t st) {
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

// seqs: (pointer, heads, sb, sh, ss) x {q, k, v, o}; dims: B, group, S_q,
// S_kv, D, causal, window, vec, o_f32 (o in fp32 for a 16-bit q); lse:
// (B, S_q) fp32 or null; kv_len (B_kv,), q_seg (B, S_q), kv_seg (B_kv,
// S_kv) and offs (2,) int32, each or null;
// cap 0 for none.  Returns 0, a CUDA error code, or -1 for a dtype or D no
// kernel is built for (D <= 128).
extern "C" int flash_fwd(const int64_t* seqs, void* lse, const void* kv_len, const void* q_seg,
                         const void* kv_seg, const void* offs, const int* dims, float cap,
                         float scale, int dtype, void* stream) {
  FlashArgs a{};
  a.q = seq_from(seqs);
  a.k = seq_from(seqs + 5);
  a.v = seq_from(seqs + 10);
  a.o = seq_from(seqs + 15);
  a.lse = static_cast<float*>(lse);
  a.kv_len = static_cast<const int*>(kv_len);
  a.q_seg = static_cast<const int*>(q_seg);
  a.kv_seg = static_cast<const int*>(kv_seg);
  a.offs = static_cast<const int*>(offs);
  dims_into(a, dims);
  a.o_f32 = dims[8];
  a.cap = cap;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.D < 1 || a.D > 128) return kUnsupported;
  const bool small = a.D <= 64;
  const int tc64 = (FQ + 4 * FKV) * (64 + 8) * 2, tc128 = (FQ + 4 * FKV) * (128 + 8) * 2;
  const int f64 = (SQ + 2 * SKV) * (64 + 1) * 4, f128 = (SQ + 2 * SKV) * (128 + 1) * 4;
  switch (dtype) {
    case kBF16:
      return small ? launch_flash(flash_fwd_tc<__nv_bfloat16, 64>, FQ, FT, tc64, a, st)
                   : launch_flash(flash_fwd_tc<__nv_bfloat16, 128>, FQ, FT, tc128, a, st);
    case kF16:
      return small ? launch_flash(flash_fwd_tc<__half, 64>, FQ, FT, tc64, a, st)
                   : launch_flash(flash_fwd_tc<__half, 128>, FQ, FT, tc128, a, st);
    case kF32:
      return small ? launch_flash(flash_fwd_simt<64>, SQ, ST, f64, a, st)
                   : launch_flash(flash_fwd_simt<128>, SQ, ST, f128, a, st);
    default: return kUnsupported;
  }
}
