// Kernel flash_fwd on Hopper's tile engine: the flash-attention forward
// o = softmax(scale q k^T) v per head, with lse = m + log(l) in fp32, for
// bf16 / fp16 at a head dim of 64 or 128.
//
// Replaces, as csrc/flash_fwd.cu does and with its conventions
// (csrc/flash_common.cuh), three TPU kernels of
// gemm_hls_tpu/ops/pallas_flash.py: _flash_kernel (B6), _flash_kernel_tri
// (B7: live tiles only, the mask evaluated only on tiles at its edge) and
// _flash_kernel_onepass (B8: the carries held for a whole q tile).  Every
// mask option (causal, window, kv_lengths, segment ids, offsets), the soft
// cap and GQA stay run-time arguments.  The shapes this route does not take
// (fp32, other head dims, fewer than 64 query rows a head, rows that are
// not whole 16-byte units) stay on flash_fwd.cu (ops/flash.py::flash_route).
//
// What bounds it on an H100: the tensor-core rate.  At the main path's
// shapes, 32 heads of 1024^2 x 128 bf16, 17.2 GFLOP full and 8.6 causal,
// 17 / 9 us at 989 TFLOP/s against 34 MB of q, k, v and o (10 us at 3.35
// TB/s).  flash_fwd.cu's mma.sync design reached 110 TFLOP/s there: eight
// warps that both load and compute, one __syncthreads() a kv tile, every
// K / V fragment through ldmatrix, 256 blocks in under two waves.
//
// The design, the engine's (csrc/wgmma_tile.cuh) turned to attention:
//   * one persistent block a SM of 384 threads walks (q tile, head) items,
//     the longest causal items first (item i: q tile n_qt - 1 - i / B of
//     head i % B), in rounds of alternating direction (block c takes items
//     c, 2 grid - 1 - c, 2 grid + c, ...), so the causal work evens out;
//   * warpgroup 0, the producer (setmaxnreg 40): one thread TMA-loads an
//     item's 128-row q tile once, then its live kv tiles of 128 rows, K and
//     V, into a ring of full / empty mbarriers (2 stages of 64 KB at D 128,
//     4 of 32 KB at D 64; a third stage at D 128 measured level).  The
//     maps are 4-D, (D, H, S, batch): the (batch, S, H, D) layout of
//     flash_attention is read in place, a (B, S, D) tensor is the case
//     H = 1; rows past S are zero-filled by TMA.  Only live tiles are
//     loaded (flash_common.cuh::kv_range);
//   * warpgroups 1 and 2, the consumers (setmaxnreg 232), own 64 q rows
//     each: S = q k^T by wgmma m64n128k16 with both operands K-major in
//     shared memory (k held [kv][d] is B^T), then the scale, the cap, the
//     mask and the online softmax in registers (uniform branches around
//     whole loops, as flash_fwd.cu: per-element selects cost 1.4x there;
//     a tile at a mask edge compares each column with two bounds a row,
//     set once an item),
//     P rounded to v's type and packed to 16 bits in registers, where the
//     accumulator's fragment is the A fragment of the next product, and
//     O += P V by wgmma with A from registers and V read MN-major through
//     the transpose bit (boxes of 64 kv rows by 64 d, wgmma_tile.cuh's
//     wg_desc_mn);
//   * O leaves through shared memory: each consumer warpgroup writes its
//     64 rows into a staging tile in the O map's swizzled boxes (no bank
//     conflict) and one thread issues a TMA store a 64-column chunk, which
//     clips the rows past S_q (4-byte stores scattered over 8 rows a warp
//     took ~2 us an item); an fp32 o (out_dtype=float32, the ring
//     attention's partials) is stored from registers, 8 bytes a store;
//   * kv slots at or past kv_lengths inside the last live tile (a padded
//     cache's stale NaN / inf, which TMA cannot stop at) are zeroed in
//     shared memory by the consumers before P V, then fenced to the async
//     proxy: 0 * NaN never reaches a sum.  K's stale rows only reach
//     scores that the mask replaces.
// No atomics: every launch gives the same bits.  Spill: 104 bytes at D
// 128, in the epilogue's staging (none before it).  Tried and
// dropped (PERF.md §6): P_{j-1} V_{j-1} issued after S_j with tile
// j's softmax under it (no spill with this mask, 1.3x slower), the
// consumers taking turns at the tensor cores through named barriers (level,
// and 104 bytes of spill), and both together (spills, slower).
// Measured (H100 80GB HBM3, 700 W, chip_smoke.py phase 15, device time in
// turns): 0.0296 / 0.0411 ms causal / full at 32 heads of 1024^2 x 128 bf16
// (cuDNN's SDPA 0.0294 / 0.0317), 0.2664 ms causal at 8 x 8192^2 x 128
// (0.2658); flash_fwd.cu's tile 0.142 / 0.148 and 1.261.
// The wgmma forms, the item walk, the mask bounds, the staging and the maps
// are csrc/flash_wgmma.cuh's, shared with the backward pair
// (csrc/flash_bwd_wgmma.cu).
#include "flash_wgmma.cuh"

namespace gemm_hls {

constexpr int kFwBQ = 128, kFwBKV = 128, kFwMaxStages = 4;
// One 64-column chunk of a 128-row K-major tile (the 128-byte swizzle's
// row): 16 KB.  V's MN-major boxes are kWgMnBox (64 kv rows x 64 d).
constexpr int kFwChunk = 128 * kWgRowBytes;

struct FwBars {
  uint64_t full[kFwMaxStages], empty[kFwMaxStages], q_full, q_empty;
};

// Shared memory: the q tile, the K / V ring (2 stages of 64 KB at D 128, 4
// of 32 KB at D 64), O's staging tile (a tile's size), the barriers.
template <int DMAX> struct FwSize {
  static constexpr int kChunks = DMAX / 64;
  static constexpr int kTile = kChunks * kFwChunk;  // one 128-row tile: q, K or V
  static constexpr int kStage = 2 * kTile;          // K then V
  static constexpr int kStages = DMAX == 128 ? 2 : 4;
  static constexpr int kSmem =
      1024 + 2 * kTile + kStages * kStage + static_cast<int>(sizeof(FwBars));
};

struct FwArgs {
  CUtensorMap mq, mk, mv, mo;  // (D, H, S, batch) maps, launch parameters
  FlashArgs a;
  int n_qt;  // q tiles a head
  long long spin;
};

template <int DMAX>
__device__ void fw_produce(const FwArgs& g, unsigned char* smem, FwBars* bars, int items) {
  using Z = FwSize<DMAX>;
  const FlashArgs& a = g.a;
  unsigned char* kv = smem + Z::kTile;
  int stage = 0;
  uint32_t phase = 0, q_phase = 0;
  for (int r = 0; r * static_cast<int>(gridDim.x) < items; ++r) {
    const int i = fw_round_item(r, items);
    if (i < 0) continue;
    const FwItem it = fw_item(a, g.n_qt, i, kFwBQ, kFwBKV);
    if (it.j_lo == it.j_hi) continue;
    const int qn = it.b / a.q.heads, qh = it.b % a.q.heads;
    const int kn = it.kvh / a.k.heads, kh = it.kvh % a.k.heads;
    mbar_wait(&bars->q_empty, q_phase ^ 1, g.spin);
    mbar_expect_tx(&bars->q_full, Z::kTile);
#pragma unroll
    for (int c = 0; c < Z::kChunks; ++c)
      tma_load_4d(smem + c * kFwChunk, &g.mq, 64 * c, qh, it.q0, qn, &bars->q_full);
    q_phase ^= 1;
    for (int j = it.j_lo; j < it.j_hi; ++j) {
      mbar_wait(&bars->empty[stage], phase ^ 1, g.spin);
      mbar_expect_tx(&bars->full[stage], Z::kStage);
      unsigned char* st = kv + stage * Z::kStage;
#pragma unroll
      for (int c = 0; c < Z::kChunks; ++c)
        tma_load_4d(st + c * kFwChunk, &g.mk, 64 * c, kh, j * kFwBKV, kn, &bars->full[stage]);
      // V as [64-row half][64-column chunk] boxes of kWgMnBox.
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < Z::kChunks; ++c)
          tma_load_4d(st + Z::kTile + (h * Z::kChunks + c) * kWgMnBox, &g.mv, 64 * c, kh,
                      j * kFwBKV + 64 * h, kn, &bars->full[stage]);
      if (++stage == Z::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// Rows [z0, z1) of the V tile at ``vt`` to zero, by the 128 threads of one
// consumer warpgroup, then fenced for the async proxy (wgmma's reads).
template <int DMAX>
__device__ __forceinline__ void fw_zero_v(unsigned char* vt, int z0, int z1, int wg) {
  using Z = FwSize<DMAX>;
  constexpr int kUnits = 8 * Z::kChunks;  // 16-byte units of one kv row
  for (int u = threadIdx.x % 128; u < (z1 - z0) * kUnits; u += 128) {
    const int r = z0 + u / kUnits, c = u % kUnits / 8, piece = u % 8;
    *reinterpret_cast<uint4*>(vt + ((r / 64) * Z::kChunks + c) * kWgMnBox + (r % 64) * kWgRowBytes +
                              16 * piece) = make_uint4(0u, 0u, 0u, 0u);
  }
  fence_proxy_async_shared();
  named_sync(2 + wg, 128);
}

template <typename T, int DMAX>
__device__ void fw_consume(const FwArgs& g, unsigned char* smem, FwBars* bars, int items) {
  using Z = FwSize<DMAX>;
  constexpr int NO = DMAX / 2;  // O values a thread
  const FlashArgs& a = g.a;
  const int wg = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, tq = lane & 3;
  const int r_loc = 64 * wg + 16 * warp + lane / 4;  // this thread's rows: r_loc, r_loc + 8
  unsigned char* kv = smem + Z::kTile;
  unsigned char* o_stage = kv + Z::kStages * Z::kStage + wg * Z::kChunks * kWgMnBox;
  const uint32_t q_base = smem_u32(smem) + wg * 64 * kWgRowBytes;
  int stage = 0;
  uint32_t phase = 0, q_phase = 0;
  for (int r = 0; r * static_cast<int>(gridDim.x) < items; ++r) {
    const int i = fw_round_item(r, items);
    if (i < 0) continue;
    const FwItem it = fw_item(a, g.n_qt, i, kFwBQ, kFwBKV);
    float o[NO];
#pragma unroll
    for (int x = 0; x < NO; ++x) o[x] = 0.f;
    float m_r[2] = {kMask, kMask}, l_r[2] = {0.f, 0.f};
    // Columns [c_min[h], c_max[h]) of this thread's rows pass the position
    // mask (Mask::ok as two bounds a row: the kv limit, causal, window).
    int seg_q[2] = {0, 0}, c_min[2], c_max[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = it.q0 + r_loc + 8 * h;
      row_bounds(it.mask, r, c_min[h], c_max[h]);
      if (a.q_seg && r < a.S_q) seg_q[h] = a.q_seg[static_cast<int64_t>(it.b) * a.S_q + r];
    }
    if (it.j_lo < it.j_hi) {
      mbar_wait(&bars->q_full, q_phase, g.spin);
      q_phase ^= 1;
    }
    for (int j = it.j_lo; j < it.j_hi; ++j) {
      mbar_wait(&bars->full[stage], phase, g.spin);
      unsigned char* st = kv + stage * Z::kStage;
      const uint32_t k_base = smem_u32(st);
      float s[64];
      wg_fence();
#pragma unroll
      for (int c = 0; c < Z::kChunks; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          fw_qk<T>(s, wg_desc(q_base + c * kFwChunk) + 2 * kk, wg_desc(k_base + c * kFwChunk) + 2 * kk,
                   c > 0 || kk > 0);
      wg_commit();
      wg_wait<0>();
      wg_pin(s);
      if (j == it.j_hi - 1) mbar_arrive(&bars->q_empty);  // this thread's reads of q are over

      const int c0 = j * kFwBKV;
      const bool edge = a.q_seg || !interior(it.mask, it.q0 + 64 * wg, 64, c0, kFwBKV);
      // Scores in log2 units (exp2 is one MUFU op): the cap and the mask are
      // uniform branches around whole loops, never per-element selects.
      if (a.cap > 0.f) {
#pragma unroll
        for (int x = 0; x < 64; ++x) s[x] = score(s[x], a.scale, a.cap) * kLog2e;
      } else {
        const float sl2 = a.scale * kLog2e;
#pragma unroll
        for (int x = 0; x < 64; ++x) s[x] *= sl2;
      }
      // Value x is (row r_loc + 8 ((x % 4) / 2), column c0 + 8 (x / 4) +
      // 2 tq + x % 2): the wgmma accumulator fragment.
      if (edge) {
#pragma unroll
        for (int x = 0; x < 64; ++x) {
          const int h = (x % 4) >> 1, c = c0 + 8 * (x / 4) + 2 * tq + (x & 1);
          if (c < c_min[h] || c >= c_max[h]) s[x] = kMask;
        }
        if (a.q_seg) {
          const int* kv_seg = a.kv_seg + static_cast<int64_t>(it.kvh) * a.S_kv;
#pragma unroll
          for (int x = 0; x < 64; ++x) {
            const int h = (x % 4) >> 1, c = c0 + 8 * (x / 4) + 2 * tq + (x & 1);
            if (c < it.mask.kv_lim && seg_q[h] != kv_seg[c]) s[x] = kMask;
          }
        }
      }
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int x = 0; x < 64; ++x) mx[(x % 4) >> 1] = fmaxf(mx[(x % 4) >> 1], s[x]);
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
        for (int x = 0; x < 64; ++x) {
          // A masked probability is exactly 0 (kMask - kMask would give 1).
          const float p = s[x] == kMask ? 0.f : exp2f(s[x] - m_r[(x % 4) >> 1]);
          s[x] = p;
          l_r[(x % 4) >> 1] += p;
        }
      } else {
#pragma unroll
        for (int x = 0; x < 64; ++x) {
          const float p = exp2f(s[x] - m_r[(x % 4) >> 1]);
          s[x] = p;
          l_r[(x % 4) >> 1] += p;
        }
      }
#pragma unroll
      for (int x = 0; x < NO; ++x) o[x] *= corr[(x % 4) >> 1];
      // p.astype(v.dtype): k16 slice kk of P is values 8 kk .. 8 kk + 7.
      uint32_t pa[8][4];
      fw_pack<T, 8>(pa, s);
      // A padded cache's stale slots inside this tile: zero V's rows.
      if (it.mask.kv_lim < c0 + kFwBKV && it.mask.kv_lim < a.S_kv)
        fw_zero_v<DMAX>(st + Z::kTile, it.mask.kv_lim - c0, min(kFwBKV, a.S_kv - c0), wg);
      const uint32_t v_base = smem_u32(st + Z::kTile);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        fw_pv<T, DMAX>(o, pa[kk], wg_desc_mn(v_base + (kk / 4) * Z::kChunks * kWgMnBox) + 128 * (kk % 4));
      wg_commit();
      wg_wait<0>();
      wg_pin(o);
      mbar_arrive(&bars->empty[stage]);
      if (++stage == Z::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
      l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
    }
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      inv[h] = 1.f / (l_r[h] == 0.f ? 1.f : l_r[h]);
      const int r = it.q0 + r_loc + 8 * h;
      if (a.lse && tq == 0 && r < a.S_q)
        a.lse[static_cast<int64_t>(it.b) * a.S_q + r] = m_r[h] * kLn2 + logf(l_r[h]);
    }
    if (a.o_f32) {
      // fp32 o (the ring's partials, ops/flash.py out_dtype=float32): each
      // thread stores its fragment's column pairs as 8-byte stores, no
      // staging (fp32 would double the staging tiles to 64 KB at D 128,
      // 230.5 KB of the block's 232 KB; the direct store is the simple
      // first form).  The wrapper allocates o, so its rows are whole
      // 8-byte pairs.
      float* of = static_cast<float*>(const_cast<void*>(a.o.p));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = it.q0 + r_loc + 8 * h;
        if (r >= a.S_q) continue;
        float* row = of + a.o.row(it.b, r) + 2 * tq;
#pragma unroll
        for (int jj = 0; jj < DMAX / 8; ++jj)
          *reinterpret_cast<float2*>(row + 8 * jj) =
              make_float2(o[4 * jj + 2 * h] * inv[h], o[4 * jj + 2 * h + 1] * inv[h]);
      }
      continue;
    }
    // O goes out through this warpgroup's staging tile (64 rows, the O
    // map's 128-byte-swizzled boxes: 16-byte unit u of row r at u ^ (r % 8),
    // no bank conflict) and one TMA store a 64-column chunk, which clips the
    // rows past S_q; the previous item's store has read the tile first.
    if (tid == 0) bulk_wait_read<0>();
    named_sync(2 + wg, 128);
    fw_stage<T, DMAX>(o_stage, o, inv);
    fence_proxy_async_shared();
    named_sync(2 + wg, 128);
    if (tid == 0) {
#pragma unroll
      for (int c = 0; c < Z::kChunks; ++c)
        tma_store_4d(&g.mo, o_stage + c * kWgMnBox, 64 * c, it.b % a.o.heads, it.q0 + 64 * wg,
                     it.b / a.o.heads);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  if (tid == 0) bulk_wait_all();  // the stores are done before the block exits
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kFwThreads, 1) flash_wg_kernel(const __grid_constant__ FwArgs g) {
  extern __shared__ unsigned char dyn_smem[];
  unsigned char* smem = wg_align(dyn_smem);
  FwBars* bars = reinterpret_cast<FwBars*>(smem + 2 * FwSize<DMAX>::kTile +
                                           FwSize<DMAX>::kStages * FwSize<DMAX>::kStage);
  if (threadIdx.x == 0) {
    for (int i = 0; i < FwSize<DMAX>::kStages; ++i) {
      mbar_init(&bars->full[i], 1);
      mbar_init(&bars->empty[i], 256);
    }
    mbar_init(&bars->q_full, 1);
    mbar_init(&bars->q_empty, 256);
    mbar_init_fence();
  }
  __syncthreads();
  const int items = g.a.B * g.n_qt;
  if (threadIdx.x < 128) {
    reg_dealloc<40>();
    if (threadIdx.x == 0) fw_produce<DMAX>(g, smem, bars, items);
  } else {
    reg_alloc<232>();
    fw_consume<T, DMAX>(g, smem, bars, items);
  }
}

template <typename T, int DMAX>
int launch_flash_wg(FwArgs& g, cudaStream_t st) {
  const FlashArgs& a = g.a;
  constexpr bool f16 = std::is_same<T, __half>::value;
  const int b_kv = a.B / a.group;
  if (!encode_seq(&g.mq, a.q, a.B, a.S_q, a.D, f16, kFwBQ) ||
      !encode_seq(&g.mk, a.k, b_kv, a.S_kv, a.D, f16, kFwBKV) ||
      !encode_seq(&g.mv, a.v, b_kv, a.S_kv, a.D, f16, 64) ||
      (!a.o_f32 && !encode_seq(&g.mo, a.o, a.B, a.S_q, a.D, f16, 64)))
    return kTmaEncodeFailed;
  return launch_persistent(flash_wg_kernel<T, DMAX>, g, FwSize<DMAX>::kSmem,
                           static_cast<int64_t>(a.B) * g.n_qt, st);
}

}  // namespace gemm_hls

using namespace gemm_hls;

// flash_fwd's arguments (csrc/flash_fwd.cu, o_f32 included), for bf16 /
// fp16 with D 64 or 128, S_q >= 64, every base and row / head / batch
// stride of q, k and v whole 16-byte units (what a TMA map describes).  Returns 0, a CUDA
// error code, -1 for what the route does not take, or -2 for a tensor map
// cuTensorMapEncodeTiled refused.
extern "C" int flash_wgmma(const int64_t* seqs, void* lse, const void* kv_len, const void* q_seg,
                           const void* kv_seg, const void* offs, const int* dims, float cap,
                           float scale, int dtype, void* stream) {
  FwArgs g{};
  FlashArgs& a = g.a;
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
  if ((a.D != 64 && a.D != 128) || a.S_q < 64 || a.S_kv < 1 || a.B < 1 || a.group < 1)
    return kUnsupported;
  g.n_qt = (a.S_q + kFwBQ - 1) / kFwBQ;
  g.spin = spin_cycles(10000);  // a stage wait is microseconds; 10 s means a lost load
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool small = a.D == 64;
  switch (dtype) {
    case kBF16:
      return small ? launch_flash_wg<__nv_bfloat16, 64>(g, st)
                   : launch_flash_wg<__nv_bfloat16, 128>(g, st);
    case kF16:
      return small ? launch_flash_wg<__half, 64>(g, st) : launch_flash_wg<__half, 128>(g, st);
    default: return kUnsupported;
  }
}
