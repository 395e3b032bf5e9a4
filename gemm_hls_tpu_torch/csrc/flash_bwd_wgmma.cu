// Kernels flash_bwd_dq and flash_bwd_dkv on Hopper's tile engine: the
// flash-attention backward for bf16 / fp16 at a head dim of 64 or 128,
// from the forward's lse and delta = sum_d dO * O (fp32, the caller's):
//   p  = exp(s - lse),  s = cap(scale q k^T) masked,
//   ds = p (dO v^T - delta) [x (1 - (s / cap)^2) under a soft cap],
//   dq = scale ds k,   dv = p^T dO,   dk = scale ds^T q.
//
// Replaces, as csrc/flash_bwd_dq.cu and csrc/flash_bwd_dkv.cu do and with
// their conventions (csrc/flash_common.cuh), four TPU kernels of
// gemm_hls_tpu/ops/pallas_flash.py: _flash_bwd_dq_kernel (B9) and
// _flash_bwd_dq_tri (B11: live tiles only, the mask only at its edge), and
// _flash_bwd_dkv_kernel (B10) and _flash_bwd_dkv_tri (B12).  Every mask
// option (causal, window, segment ids, offsets), the soft cap and GQA stay
// run-time arguments.  The shapes this route does not take (fp32, other
// head dims, fewer than 64 rows -- S_q for dq, S_kv for dkv -- rows that
// are not whole 16-byte units) stay on those two files
// (ops/flash.py::flash_bwd_route).
//
// What bounds it on an H100: the tensor-core rate.  dq is three products of
// 2 S_q S_kv D each and dk / dv four, halved under causal: 25.8 + 34.4
// GFLOP at 32 heads of 1024^2 x 128 bf16, 61 us at 989 TFLOP/s against 25
// us for their bytes at 3.35 TB/s.  The mma.sync pair reached 123-125
// TFLOP/s there: 4 warps a block that both load and compute, every K
// fragment read twice through ldmatrix, a __syncthreads() a tile, and
// dkv's two D-wide sums holding 128 registers of a 4-warp block.
//
// The design, the forward's (csrc/flash_wgmma.cu) turned to the backward,
// both kernels one persistent block a SM of 384 threads walking items in
// the forward's rounds of alternating direction (csrc/flash_wgmma.cuh):
//   * flash_dq_wg_kernel: an item is (q tile of 128 rows, q head), the
//     longest causal items first.  Warpgroup 0, the producer (setmaxnreg
//     40): one thread TMA-loads the item's q and dO tiles once, then its
//     live K / V tiles of 64 rows (kv_range) into a ring of 4 full / empty
//     mbarrier stages (32 KB each at D 128).  Warpgroups 1 and 2, the
//     consumers (setmaxnreg 232), own 64 q rows each: S = q k^T and
//     dP = dO v^T by wgmma m64n64k16 with both operands K-major in shared
//     memory, p (formed while dP's products run) and ds in registers, ds
//     rounded to the input type, then dq += ds K with ds as the A fragments
//     in registers and K read MN-major through the transpose bit -- the K
//     tile's 64-row boxes of 64 columns are both layouts, so K is read once
//     from device memory and never through ldmatrix.  dq leaves through a
//     swizzled staging tile and a TMA store, which clips the rows past S_q.
//   * flash_dkv_wg_kernel: an item is (kv tile of 128 rows, kv head), the
//     kv tiles with the most live q tiles first; K and V stay resident in
//     shared memory for the item.  The producer rings (q tile of 64 rows,
//     its dO tile) over the group's q heads x live q tiles (q_range); a
//     second producer warp writes the step's 64 lse (log2 units), delta and
//     q segment ids beside them, read as they are stored, never stale.  Each
//     consumer owns 64 kv rows: S^T = K q^T and dP^T = V dO^T by m64n64k16,
//     p^T and ds^T in registers, rounded, then dv += p^T dO and dk += ds^T
//     q with dO and q read MN-major.  A GQA group's q heads are summed in
//     fp32 in registers, in one fixed order (head, then q tile): no
//     per-q-head buffer.  dk and dv are staged in the warpgroup's own rows
//     of K and V, whose last reads are over, and leave by TMA store; the
//     producer loads the next item's K and V once those stores have read
//     them, after the item's first q steps are in flight.  Where the
//     128-row items would fill at most one round of the SMs (a GQA prefill
//     on few kv heads: the longest causal item would set the pace), items
//     are 64 kv rows that both consumers own, taking the steps in turn;
//     warpgroup 1's partial sums are added into warpgroup 0's through
//     shared memory, in that fixed order (split mode; on an H100 80GB HBM3
//     at 700 W 1.6x faster at 16 kv heads of 1024 causal rows, 6-13% slower
//     at 32 heads, where the 128-row items fill two rounds).
// The mask: a tile at a mask edge compares each column with two bounds a
// row, set once an item (dq: two kv bounds a q row; dkv: two q bounds a kv
// row, q rows past S_q excluded), and a masked p or ds is replaced by 0 --
// a select, never a product, since a row that every position masks has lse
// = -inf and exp(s - lse) = inf there.  A warpgroup skips the products of a
// tile that is dead for all of its rows.
// No atomics: every dq row and every dk / dv row is written by one block,
// in a fixed order, so every launch gives the same bits.  Tried and dropped
// (PERF.md §6): dv's products issued apart from dk's to overlap ds
// (13-15% slower), the dk / dv item size as a run-time branch (5-8% slower
// in both modes: it is a template parameter).
// Measured (H100 80GB HBM3, 700 W, chip_smoke.py phase 15, device time in
// turns): the pair 0.0868 / 0.1407 ms causal / full at 32 heads of 1024^2 x
// 128 bf16 (cuDNN's SDPA backward 0.1046 / 0.1158; the mma.sync pair
// 0.4074 / 0.4882), 0.8969 ms causal at 8 x 8192^2 x 128 (0.7636), 0.1536
// ms at the GQA prefill, 4 x 1024 rows of 16 / 4 heads (0.1774).
#include "flash_wgmma.cuh"

namespace gemm_hls {

// A 128-row box of 64 columns (16 KB); the 64-row box is kWgMnBox (8 KB).
constexpr int kBwBox128 = 128 * kWgRowBytes;
constexpr int kBwStages = 4;

struct BwArgs {
  CUtensorMap mq, mdo, mk, mv, m0, m1;  // (D, H, S, batch) maps; m0 dq or dk, m1 dv
  FlashArgs a;
  int n_tiles;  // an item's tiles a head: 128-row q tiles (dq), kv tiles (dkv)
  long long spin;
};

// ---- dq ---------------------------------------------------------------------

constexpr int kDqBQ = 128, kDqBKV = 64;

struct DqBars {
  uint64_t full[kBwStages], empty[kBwStages], q_full, q_empty;
};

// Shared memory: the q and dO tiles (128 rows), the K / V ring (64 rows a
// tile), dq's staging (64 rows a consumer), the barriers.
template <int DMAX> struct DqSize {
  static constexpr int kChunks = DMAX / 64;
  static constexpr int kQTile = kChunks * kBwBox128;
  static constexpr int kKvTile = kChunks * kWgMnBox;
  static constexpr int kStage = 2 * kKvTile;  // K then V
  static constexpr int kStagesOff = 2 * kQTile;
  static constexpr int kStagingOff = kStagesOff + kBwStages * kStage;
  static constexpr int kBarsOff = kStagingOff + 2 * kKvTile;
  static constexpr int kSmem = 1024 + kBarsOff + static_cast<int>(sizeof(DqBars));
};

template <int DMAX>
__device__ void dq_produce(const BwArgs& g, unsigned char* smem, DqBars* bars, int items) {
  using Z = DqSize<DMAX>;
  const FlashArgs& a = g.a;
  int stage = 0;
  uint32_t phase = 0, q_phase = 0;
  for (int r = 0; r * static_cast<int>(gridDim.x) < items; ++r) {
    const int i = fw_round_item(r, items);
    if (i < 0) continue;
    const FwItem it = fw_item(a, g.n_tiles, i, kDqBQ, kDqBKV);
    if (it.j_lo == it.j_hi) continue;
    mbar_wait(&bars->q_empty, q_phase ^ 1, g.spin);
    mbar_expect_tx(&bars->q_full, 2 * Z::kQTile);
#pragma unroll
    for (int c = 0; c < Z::kChunks; ++c) {
      tma_load_4d(smem + c * kBwBox128, &g.mq, 64 * c, it.b % a.q.heads, it.q0, it.b / a.q.heads,
                  &bars->q_full);
      tma_load_4d(smem + Z::kQTile + c * kBwBox128, &g.mdo, 64 * c, it.b % a.o.heads, it.q0,
                  it.b / a.o.heads, &bars->q_full);
    }
    q_phase ^= 1;
    for (int j = it.j_lo; j < it.j_hi; ++j) {
      mbar_wait(&bars->empty[stage], phase ^ 1, g.spin);
      mbar_expect_tx(&bars->full[stage], Z::kStage);
      unsigned char* st = smem + Z::kStagesOff + stage * Z::kStage;
#pragma unroll
      for (int c = 0; c < Z::kChunks; ++c) {
        tma_load_4d(st + c * kWgMnBox, &g.mk, 64 * c, it.kvh % a.k.heads, j * kDqBKV,
                    it.kvh / a.k.heads, &bars->full[stage]);
        tma_load_4d(st + Z::kKvTile + c * kWgMnBox, &g.mv, 64 * c, it.kvh % a.v.heads, j * kDqBKV,
                    it.kvh / a.v.heads, &bars->full[stage]);
      }
      if (++stage == kBwStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

template <typename T, int DMAX>
__device__ void dq_consume(const BwArgs& g, unsigned char* smem, DqBars* bars, int items) {
  using Z = DqSize<DMAX>;
  constexpr int ND = DMAX / 2;  // dq values a thread
  const FlashArgs& a = g.a;
  const int wg = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, tq = lane & 3;
  const int r_loc = 64 * wg + 16 * warp + lane / 4;  // this thread's rows: r_loc, r_loc + 8
  unsigned char* staging = smem + Z::kStagingOff + wg * Z::kKvTile;
  const uint32_t q_base = smem_u32(smem) + wg * 64 * kWgRowBytes;
  const uint32_t do_base = q_base + Z::kQTile;
  int stage = 0;
  uint32_t phase = 0, q_phase = 0;
  for (int r = 0; r * static_cast<int>(gridDim.x) < items; ++r) {
    const int i = fw_round_item(r, items);
    if (i < 0) continue;
    const FwItem it = fw_item(a, g.n_tiles, i, kDqBQ, kDqBKV);
    float dq[ND];
#pragma unroll
    for (int x = 0; x < ND; ++x) dq[x] = 0.f;
    // Columns [c_min[h], c_max[h]) of this thread's rows pass the position
    // mask; rows past S_q (zero-filled q and dO) take lse = delta = 0, so
    // their ds stays finite (their dq rows are clipped by the store).
    float lse2[2] = {0.f, 0.f}, del[2] = {0.f, 0.f};
    int seg_q[2] = {0, 0}, c_min[2], c_max[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = it.q0 + r_loc + 8 * h;
      row_bounds(it.mask, rr, c_min[h], c_max[h]);
      if (rr < a.S_q) {
        const int64_t ri = static_cast<int64_t>(it.b) * a.S_q + rr;
        lse2[h] = a.lse[ri] * kLog2e;
        del[h] = a.delta[ri];
        if (a.q_seg) seg_q[h] = a.q_seg[ri];
      }
    }
    // The live kv columns of this warpgroup's 64 rows.
    const int w0 = it.q0 + 64 * wg;
    int w_lo = 0, w_hi = 0;
    if (w0 < a.S_q) kv_range(it.mask, w0, min(w0 + 64, a.S_q), w_lo, w_hi);
    if (it.j_lo < it.j_hi) {
      mbar_wait(&bars->q_full, q_phase, g.spin);
      q_phase ^= 1;
    }
    for (int j = it.j_lo; j < it.j_hi; ++j) {
      mbar_wait(&bars->full[stage], phase, g.spin);
      const int c0 = j * kDqBKV;
      if (c0 < w_hi && c0 + kDqBKV > w_lo) {
        const uint32_t k_base = smem_u32(smem + Z::kStagesOff + stage * Z::kStage);
        const uint32_t v_base = k_base + Z::kKvTile;
        float s[32], dp[32];
        wg_fence();
#pragma unroll
        for (int c = 0; c < Z::kChunks; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            fw_ss64<T>(s, wg_desc(q_base + c * kBwBox128) + 2 * kk,
                       wg_desc(k_base + c * kWgMnBox) + 2 * kk, c > 0 || kk > 0);
        wg_commit();
#pragma unroll
        for (int c = 0; c < Z::kChunks; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            fw_ss64<T>(dp, wg_desc(do_base + c * kBwBox128) + 2 * kk,
                       wg_desc(v_base + c * kWgMnBox) + 2 * kk, c > 0 || kk > 0);
        wg_commit();
        wg_wait<1>();
        wg_pin(s);
        // p in s while dP's products run (under a soft cap, times the
        // cap's derivative).  Value x is (row r_loc + 8 ((x % 4) / 2),
        // column c0 + 8 (x / 4) + 2 tq + x % 2); the cap and the mask are
        // uniform branches around whole loops (flash_fwd.cu's rule).
        if (a.cap > 0.f) {
#pragma unroll
          for (int x = 0; x < 32; ++x) {
            const float xs = score(s[x], a.scale, a.cap), u = xs / a.cap;
            s[x] = exp2f(xs * kLog2e - lse2[(x % 4) >> 1]) * (1.f - u * u);
          }
        } else {
          const float sl2 = a.scale * kLog2e;
#pragma unroll
          for (int x = 0; x < 32; ++x) s[x] = exp2f(s[x] * sl2 - lse2[(x % 4) >> 1]);
        }
        wg_wait<0>();
        wg_pin(dp);
        if (j == it.j_hi - 1) mbar_arrive(&bars->q_empty);  // this thread's reads of q, dO are over
        // ds in s.
#pragma unroll
        for (int x = 0; x < 32; ++x) s[x] *= dp[x] - del[(x % 4) >> 1];
        if (a.q_seg || !interior(it.mask, w0, 64, c0, kDqBKV)) {
#pragma unroll
          for (int x = 0; x < 32; ++x) {
            const int h = (x % 4) >> 1, c = c0 + 8 * (x / 4) + 2 * tq + (x & 1);
            if (c < c_min[h] || c >= c_max[h]) s[x] = 0.f;
          }
          if (a.q_seg) {
            const int* kv_seg = a.kv_seg + static_cast<int64_t>(it.kvh) * a.S_kv;
#pragma unroll
            for (int x = 0; x < 32; ++x) {
              const int h = (x % 4) >> 1, c = c0 + 8 * (x / 4) + 2 * tq + (x & 1);
              if (c < it.mask.kv_lim && seg_q[h] != kv_seg[c]) s[x] = 0.f;
            }
          }
        }
        uint32_t da[4][4];
        fw_pack<T, 4>(da, s);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fw_pv<T, DMAX>(dq, da[kk], wg_desc_mn(k_base) + 128 * kk);
        wg_commit();
        wg_wait<0>();
        wg_pin(dq);
      } else if (j == it.j_hi - 1) {
        mbar_arrive(&bars->q_empty);
      }
      mbar_arrive(&bars->empty[stage]);
      if (++stage == kBwStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    // dq goes out through this warpgroup's staging tile and one TMA store a
    // 64-column chunk; the previous item's store has read the tile first.
    if (tid == 0) bulk_wait_read<0>();
    named_sync(2 + wg, 128);
    const float mul[2] = {a.scale, a.scale};
    fw_stage<T, DMAX>(staging, dq, mul);
    fence_proxy_async_shared();
    named_sync(2 + wg, 128);
    if (tid == 0) {
#pragma unroll
      for (int c = 0; c < Z::kChunks; ++c)
        tma_store_4d(&g.m0, staging + c * kWgMnBox, 64 * c, it.b % a.g0.heads, w0,
                     it.b / a.g0.heads);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  if (tid == 0) bulk_wait_all();  // the stores are done before the block exits
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kFwThreads, 1) flash_dq_wg_kernel(const __grid_constant__ BwArgs g) {
  extern __shared__ unsigned char dyn_smem[];
  unsigned char* smem = wg_align(dyn_smem);
  DqBars* bars = reinterpret_cast<DqBars*>(smem + DqSize<DMAX>::kBarsOff);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kBwStages; ++i) {
      mbar_init(&bars->full[i], 1);
      mbar_init(&bars->empty[i], 256);
    }
    mbar_init(&bars->q_full, 1);
    mbar_init(&bars->q_empty, 256);
    mbar_init_fence();
  }
  __syncthreads();
  const int items = g.a.B * g.n_tiles;
  if (threadIdx.x < 128) {
    reg_dealloc<40>();
    if (threadIdx.x == 0) dq_produce<DMAX>(g, smem, bars, items);
  } else {
    reg_alloc<232>();
    dq_consume<T, DMAX>(g, smem, bars, items);
  }
}

// ---- dk, dv -------------------------------------------------------------------

constexpr int kKvBQ = 64;

struct KvBars {
  uint64_t full[kBwStages], empty[kBwStages], kv_full, kv_empty;
};

// A ring stage's row values: the q step's lse (log2 units), delta and q
// segment ids, written by the second producer warp (0 past S_q).
struct KvSide {
  float lse2[kKvBQ], delta[kKvBQ];
  int seg[kKvBQ];
};

// Shared memory: K and V (up to 128 rows, resident an item; at its end dk
// and dv's staging, and in split mode first the consumers' exchange of
// partial sums), the q / dO ring (64 rows a tile), the stages' row values,
// the barriers.  K and V are 64-column chunks of 128-row boxes, of which a
// 64-row item fills the first half.
template <int DMAX> struct KvSize {
  static constexpr int kChunks = DMAX / 64;
  static constexpr int kKvTile = kChunks * kBwBox128;
  static constexpr int kQTile = kChunks * kWgMnBox;
  static constexpr int kStage = 2 * kQTile;  // q then dO
  static constexpr int kStagesOff = 2 * kKvTile;
  static constexpr int kSideOff = kStagesOff + kBwStages * kStage;
  static constexpr int kBarsOff = kSideOff + kBwStages * static_cast<int>(sizeof(KvSide));
  static constexpr int kSmem = 1024 + kBarsOff + static_cast<int>(sizeof(KvBars));
  // One warpgroup's fp32 partial of dk or dv fills K's rows exactly.
  static_assert(64 * DMAX * 4 == kKvTile, "partial sums");
};

// Item i: kv head kvh, kv rows [c0, c0 + rows), ``steps`` = group x n_i
// (q head, q tile) steps over the live q tiles [i_lo, i_lo + n_i) of 64
// rows.  Kv tile i / B_kv: under causal the first tiles have the most.
struct KvItem {
  int kvh, c0, i_lo, n_i, steps;
  Mask mask;
};

__device__ __forceinline__ KvItem kv_item(const FlashArgs& a, int i, int rows) {
  KvItem it;
  const int b_kv = a.B / a.group;
  it.kvh = i % b_kv;
  it.c0 = (i / b_kv) * rows;
  // Every head of the group shares the mask (the backward takes no kv_lengths).
  it.mask = head_mask(a, it.kvh * a.group);
  int r_lo, r_hi;
  q_range(it.mask, it.c0, min(it.c0 + rows, a.S_kv), a.S_q, r_lo, r_hi);
  it.i_lo = r_lo / kKvBQ;
  it.n_i = r_hi > r_lo ? (r_hi + kKvBQ - 1) / kKvBQ - it.i_lo : 0;
  it.steps = it.n_i * a.group;
  return it;
}

// Thread 0 loads the tiles, the 32 lanes of warp 1 write the row values;
// both walk the same steps, and a stage is full once both have arrived.
template <int DMAX, bool SPLIT>
__device__ void kv_produce(const BwArgs& g, unsigned char* smem, KvBars* bars, KvSide* side,
                           int items) {
  using Z = KvSize<DMAX>;
  constexpr int rows = SPLIT ? 64 : 128;  // an item's kv rows, K and V's TMA box
  const FlashArgs& a = g.a;
  const bool loader = threadIdx.x == 0;
  const int lane = threadIdx.x % 32;
  int stage = 0;
  uint32_t phase = 0, kv_phase = 0;
  for (int r = 0; r * static_cast<int>(gridDim.x) < items; ++r) {
    const int i = fw_round_item(r, items);
    if (i < 0) continue;
    const KvItem it = kv_item(a, i, rows);
    if (it.steps == 0) continue;
    // K and V wait for the previous item's dk / dv stores to have read
    // them: the item's first steps are issued before.
    const int pre = min(kBwStages, it.steps);
    for (int s = 0; s <= it.steps; ++s) {
      if (s == pre && loader) {
        mbar_wait(&bars->kv_empty, kv_phase ^ 1, g.spin);
        mbar_expect_tx(&bars->kv_full, 2 * Z::kChunks * rows * kWgRowBytes);
#pragma unroll
        for (int c = 0; c < Z::kChunks; ++c) {
          tma_load_4d(smem + c * kBwBox128, &g.mk, 64 * c, it.kvh % a.k.heads, it.c0,
                      it.kvh / a.k.heads, &bars->kv_full);
          tma_load_4d(smem + Z::kKvTile + c * kBwBox128, &g.mv, 64 * c, it.kvh % a.v.heads, it.c0,
                      it.kvh / a.v.heads, &bars->kv_full);
        }
      }
      if (s == it.steps) break;
      const int b = it.kvh * a.group + s / it.n_i, r0 = (it.i_lo + s % it.n_i) * kKvBQ;
      mbar_wait(&bars->empty[stage], phase ^ 1, g.spin);
      if (loader) {
        mbar_expect_tx(&bars->full[stage], Z::kStage);
        unsigned char* st = smem + Z::kStagesOff + stage * Z::kStage;
#pragma unroll
        for (int c = 0; c < Z::kChunks; ++c) {
          tma_load_4d(st + c * kWgMnBox, &g.mq, 64 * c, b % a.q.heads, r0, b / a.q.heads,
                      &bars->full[stage]);
          tma_load_4d(st + Z::kQTile + c * kWgMnBox, &g.mdo, 64 * c, b % a.o.heads, r0,
                      b / a.o.heads, &bars->full[stage]);
        }
      } else {
        KvSide& sd = side[stage];
        for (int e = lane; e < kKvBQ; e += 32) {
          const int rr = r0 + e;
          const bool in = rr < a.S_q;
          const int64_t ri = static_cast<int64_t>(b) * a.S_q + rr;
          sd.lse2[e] = in ? a.lse[ri] * kLog2e : 0.f;
          sd.delta[e] = in ? a.delta[ri] : 0.f;
          sd.seg[e] = in && a.q_seg ? a.q_seg[ri] : 0;
        }
        mbar_arrive(&bars->full[stage]);
      }
      if (++stage == kBwStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    kv_phase ^= 1;
  }
}

// One warpgroup's 64 x DMAX fp32 partial sums (``acc``) to or from ``buf``
// (64 * DMAX floats), 16 bytes a thread and value group: no bank conflict.
template <int ND>
__device__ __forceinline__ void kv_put(float* buf, const float (&acc)[ND]) {
  const int tid = threadIdx.x % 128;
#pragma unroll
  for (int x = 0; x < ND; x += 4)
    reinterpret_cast<float4*>(buf)[(x / 4) * 128 + tid] =
        make_float4(acc[x], acc[x + 1], acc[x + 2], acc[x + 3]);
}
template <int ND>
__device__ __forceinline__ void kv_add(float (&acc)[ND], const float* buf) {
  const int tid = threadIdx.x % 128;
#pragma unroll
  for (int x = 0; x < ND; x += 4) {
    const float4 v = reinterpret_cast<const float4*>(buf)[(x / 4) * 128 + tid];
    acc[x] += v.x;
    acc[x + 1] += v.y;
    acc[x + 2] += v.z;
    acc[x + 3] += v.w;
  }
}

// The consumers.  An item of 128 kv rows gives each warpgroup 64 of them
// and every step; in split mode (items of 64 rows) both warpgroups own the
// item's rows and take its steps in turn (warpgroup w the steps s = w mod
// 2), so an item is half as long and there are twice the items: where the
// 128-row items fill at most one round of the SMs (a GQA group's heads on
// few kv heads), the longest item no longer sets the pace of the launch.
// The mode is a template parameter: as a run-time branch it cost both
// modes 5-8%.
template <typename T, int DMAX, bool SPLIT>
__device__ void kv_consume(const BwArgs& g, unsigned char* smem, KvBars* bars, const KvSide* side,
                           int items) {
  using Z = KvSize<DMAX>;
  constexpr int ND = DMAX / 2;  // dk (and dv) values a thread
  const FlashArgs& a = g.a;
  const int wg = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, tq = lane & 3;
  const int c_loc = 16 * warp + lane / 4;  // this thread's kv rows of its 64: c_loc, c_loc + 8
  constexpr int rows = SPLIT ? 64 : 128;
  const int row0 = SPLIT ? 0 : 64 * wg;
  // This warpgroup's 64 rows of K and V (A operands), later its staging.
  unsigned char* k_rows = smem + row0 * kWgRowBytes;
  unsigned char* v_rows = k_rows + Z::kKvTile;
  float* partial = reinterpret_cast<float*>(smem);  // K's rows, once their reads are over
  const uint32_t k_base = smem_u32(k_rows), v_base = smem_u32(v_rows);
  int stage = 0;
  uint32_t phase = 0, kv_phase = 0;
  for (int r = 0; r * static_cast<int>(gridDim.x) < items; ++r) {
    const int i = fw_round_item(r, items);
    if (i < 0) continue;
    const KvItem it = kv_item(a, i, rows);
    if (it.steps == 0) {
      // No live q row: zeros, stored directly (K and V were never loaded,
      // and their rows may be the next item's already).
      for (int u = threadIdx.x - 128; u < rows * a.D; u += 256) {
        const int c = it.c0 + u / a.D, d = u % a.D;
        if (c >= a.S_kv) break;
        MmaType<T>::store(const_cast<void*>(a.g0.p), a.g0.row(it.kvh, c) + d, 0.f);
        MmaType<T>::store(const_cast<void*>(a.g1.p), a.g1.row(it.kvh, c) + d, 0.f);
      }
      continue;
    }
    const int w0 = it.c0 + row0;
    float dk[ND], dv[ND];
#pragma unroll
    for (int x = 0; x < ND; ++x) dk[x] = dv[x] = 0.f;
    // q rows [r_min[h], r_max[h]) of this thread's kv rows pass the
    // position mask; the live q rows of this warpgroup's 64 kv rows.
    int seg_kv[2] = {0, 0}, r_min[2], r_max[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = w0 + c_loc + 8 * h;
      col_bounds(it.mask, c, a.S_q, r_min[h], r_max[h]);
      if (a.kv_seg && c < a.S_kv) seg_kv[h] = a.kv_seg[static_cast<int64_t>(it.kvh) * a.S_kv + c];
    }
    int w_lo = 0, w_hi = 0;
    if (w0 < a.S_kv) q_range(it.mask, w0, min(w0 + 64, a.S_kv), a.S_q, w_lo, w_hi);
    mbar_wait(&bars->kv_full, kv_phase, g.spin);
    for (int s = 0; s < it.steps; ++s) {
      if (!SPLIT || (s & 1) == wg) {
        mbar_wait(&bars->full[stage], phase, g.spin);
        const int r0 = (it.i_lo + s % it.n_i) * kKvBQ;
        if (r0 < w_hi && r0 + kKvBQ > w_lo) {
          const uint32_t q_base = smem_u32(smem + Z::kStagesOff + stage * Z::kStage);
          const uint32_t do_base = q_base + Z::kQTile;
          const KvSide& sd = side[stage];
          float st[32], dp[32];
          wg_fence();
#pragma unroll
          for (int c = 0; c < Z::kChunks; ++c)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              fw_ss64<T>(st, wg_desc(k_base + c * kBwBox128) + 2 * kk,
                         wg_desc(q_base + c * kWgMnBox) + 2 * kk, c > 0 || kk > 0);
#pragma unroll
          for (int c = 0; c < Z::kChunks; ++c)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              fw_ss64<T>(dp, wg_desc(v_base + c * kBwBox128) + 2 * kk,
                         wg_desc(do_base + c * kWgMnBox) + 2 * kk, c > 0 || kk > 0);
          wg_commit();
          wg_wait<0>();
          wg_pin(st);
          wg_pin(dp);
          // p^T in st, ds^T in dp.  Value x is (kv row c_loc + 8 ((x % 4) /
          // 2), q row r0 + e, e = 8 (x / 4) + 2 tq + x % 2).
          if (a.cap > 0.f) {
#pragma unroll
            for (int x = 0; x < 32; ++x) {
              const int e = 8 * (x / 4) + 2 * tq + (x & 1);
              const float xs = score(st[x], a.scale, a.cap), u = xs / a.cap;
              const float p = exp2f(xs * kLog2e - sd.lse2[e]);
              st[x] = p;
              dp[x] = p * (dp[x] - sd.delta[e]) * (1.f - u * u);
            }
          } else {
            const float sl2 = a.scale * kLog2e;
#pragma unroll
            for (int x = 0; x < 32; ++x) {
              const int e = 8 * (x / 4) + 2 * tq + (x & 1);
              const float p = exp2f(st[x] * sl2 - sd.lse2[e]);
              st[x] = p;
              dp[x] = p * (dp[x] - sd.delta[e]);
            }
          }
          if (a.q_seg || r0 + kKvBQ > a.S_q || !interior(it.mask, r0, kKvBQ, w0, 64)) {
#pragma unroll
            for (int x = 0; x < 32; ++x) {
              const int h = (x % 4) >> 1, e = 8 * (x / 4) + 2 * tq + (x & 1), rr = r0 + e;
              bool ok = rr >= r_min[h] && rr < r_max[h];
              if (a.q_seg) ok = ok && sd.seg[e] == seg_kv[h];
              if (!ok) st[x] = dp[x] = 0.f;
            }
          }
          uint32_t pa[4][4], da[4][4];
          fw_pack<T, 4>(pa, st);
          fw_pack<T, 4>(da, dp);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) fw_pv<T, DMAX>(dv, pa[kk], wg_desc_mn(do_base) + 128 * kk);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) fw_pv<T, DMAX>(dk, da[kk], wg_desc_mn(q_base) + 128 * kk);
          wg_commit();
          wg_wait<0>();
          wg_pin(dv);
          wg_pin(dk);
        }
        mbar_arrive(&bars->empty[stage]);
      }
      if (++stage == kBwStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    // In split mode the two partial sums meet in K's rows, whose reads are
    // over (barrier 1 over both warpgroups): warpgroup 0 adds warpgroup 1's,
    // dk then dv, in this fixed order, and stores the sums alone.  dk and dv
    // are staged in the storing warpgroup's rows of K and V (the other
    // warpgroup reads only its own) and leave by TMA store, which clips the
    // rows past S_kv; K and V are free for the next item once the stores
    // have read them.
    bool stores = true;
    if constexpr (SPLIT) {
      named_sync(1, 256);
      if (wg == 1) kv_put(partial, dk);
      named_sync(1, 256);
      if (wg == 0) kv_add(dk, partial);
      named_sync(1, 256);
      if (wg == 1) kv_put(partial, dv);
      named_sync(1, 256);
      if (wg == 0) kv_add(dv, partial);
      stores = wg == 0;
    }
    if (stores) {
      named_sync(2 + wg, 128);
      const float mk[2] = {a.scale, a.scale}, mv[2] = {1.f, 1.f};
      fw_stage<T, DMAX>(k_rows, dk, mk, kBwBox128);
      fw_stage<T, DMAX>(v_rows, dv, mv, kBwBox128);
      fence_proxy_async_shared();
      named_sync(2 + wg, 128);
      if (tid == 0) {
#pragma unroll
        for (int c = 0; c < Z::kChunks; ++c) {
          tma_store_4d(&g.m0, k_rows + c * kBwBox128, 64 * c, it.kvh % a.g0.heads, w0,
                       it.kvh / a.g0.heads);
          tma_store_4d(&g.m1, v_rows + c * kBwBox128, 64 * c, it.kvh % a.g1.heads, w0,
                       it.kvh / a.g1.heads);
        }
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        bulk_wait_read<0>();
      }
    }
    mbar_arrive(&bars->kv_empty);
    kv_phase ^= 1;
  }
  if (tid == 0) bulk_wait_all();  // the stores are done before the block exits
}

template <typename T, int DMAX, bool SPLIT>
__global__ void __launch_bounds__(kFwThreads, 1) flash_dkv_wg_kernel(const __grid_constant__ BwArgs g) {
  extern __shared__ unsigned char dyn_smem[];
  unsigned char* smem = wg_align(dyn_smem);
  KvSide* side = reinterpret_cast<KvSide*>(smem + KvSize<DMAX>::kSideOff);
  KvBars* bars = reinterpret_cast<KvBars*>(smem + KvSize<DMAX>::kBarsOff);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kBwStages; ++i) {
      mbar_init(&bars->full[i], 1 + 32);  // the loader and warp 1's lanes
      mbar_init(&bars->empty[i], SPLIT ? 128 : 256);  // the consumers that took the step
    }
    mbar_init(&bars->kv_full, 1);
    mbar_init(&bars->kv_empty, 256);
    mbar_init_fence();
  }
  __syncthreads();
  const int items = (g.a.B / g.a.group) * g.n_tiles;
  if (threadIdx.x < 128) {
    reg_dealloc<40>();
    if (threadIdx.x == 0 || threadIdx.x / 32 == 1)
      kv_produce<DMAX, SPLIT>(g, smem, bars, side, items);
  } else {
    reg_alloc<232>();
    kv_consume<T, DMAX, SPLIT>(g, smem, bars, side, items);
  }
}

// ---- host -------------------------------------------------------------------

template <typename T, int DMAX>
int launch_dq_wg(BwArgs& g, cudaStream_t st) {
  const FlashArgs& a = g.a;
  constexpr bool f16 = std::is_same<T, __half>::value;
  const int b_kv = a.B / a.group;
  if (!encode_seq(&g.mq, a.q, a.B, a.S_q, a.D, f16, kDqBQ) ||
      !encode_seq(&g.mdo, a.o, a.B, a.S_q, a.D, f16, kDqBQ) ||
      !encode_seq(&g.mk, a.k, b_kv, a.S_kv, a.D, f16, kDqBKV) ||
      !encode_seq(&g.mv, a.v, b_kv, a.S_kv, a.D, f16, kDqBKV) ||
      !encode_seq(&g.m0, a.g0, a.B, a.S_q, a.D, f16, 64))
    return kTmaEncodeFailed;
  return launch_persistent(flash_dq_wg_kernel<T, DMAX>, g, DqSize<DMAX>::kSmem,
                           static_cast<int64_t>(a.B) * g.n_tiles, st);
}

template <typename T, int DMAX>
int launch_dkv_wg(BwArgs& g, cudaStream_t st) {
  const FlashArgs& a = g.a;
  constexpr bool f16 = std::is_same<T, __half>::value;
  const int b_kv = a.B / a.group;
  // Items of 128 kv rows, unless they would fill at most one round of the
  // SMs: then items of 64 rows, each half as long (split mode).
  int sms = 0;
  const int err = sm_count(sms);
  if (err) return err;
  const bool split = static_cast<int64_t>(b_kv) * ((a.S_kv + 127) / 128) <= sms;
  const int rows = split ? 64 : 128;
  if (!encode_seq(&g.mq, a.q, a.B, a.S_q, a.D, f16, kKvBQ) ||
      !encode_seq(&g.mdo, a.o, a.B, a.S_q, a.D, f16, kKvBQ) ||
      !encode_seq(&g.mk, a.k, b_kv, a.S_kv, a.D, f16, rows) ||
      !encode_seq(&g.mv, a.v, b_kv, a.S_kv, a.D, f16, rows) ||
      !encode_seq(&g.m0, a.g0, b_kv, a.S_kv, a.D, f16, 64) ||
      !encode_seq(&g.m1, a.g1, b_kv, a.S_kv, a.D, f16, 64))
    return kTmaEncodeFailed;
  g.n_tiles = (a.S_kv + rows - 1) / rows;
  const int64_t items = static_cast<int64_t>(b_kv) * g.n_tiles;
  return split ? launch_persistent(flash_dkv_wg_kernel<T, DMAX, true>, g, KvSize<DMAX>::kSmem,
                                   items, st)
               : launch_persistent(flash_dkv_wg_kernel<T, DMAX, false>, g, KvSize<DMAX>::kSmem,
                                   items, st);
}

// The entry points' arguments (flash_bwd_dq / flash_bwd_dkv's) into g;
// false for what the route does not take.
inline bool bw_args(BwArgs& g, const int64_t* seqs, int n_out, const void* lse, const void* delta,
                    const void* q_seg, const void* kv_seg, const void* offs, const int* dims,
                    float cap, float scale) {
  FlashArgs& a = g.a;
  a.q = seq_from(seqs);
  a.k = seq_from(seqs + 5);
  a.v = seq_from(seqs + 10);
  a.o = seq_from(seqs + 15);
  a.g0 = seq_from(seqs + 20);
  if (n_out > 1) a.g1 = seq_from(seqs + 25);
  a.lse = static_cast<float*>(const_cast<void*>(lse));
  a.delta = static_cast<const float*>(delta);
  a.q_seg = static_cast<const int*>(q_seg);
  a.kv_seg = static_cast<const int*>(kv_seg);
  a.offs = static_cast<const int*>(offs);
  dims_into(a, dims);
  a.cap = cap;
  a.scale = scale;
  g.spin = spin_cycles(10000);  // a stage wait is microseconds; 10 s means a lost load
  return (a.D == 64 || a.D == 128) && a.S_q >= 1 && a.S_kv >= 1 && a.B >= 1 && a.group >= 1 &&
         a.B % a.group == 0;
}

}  // namespace gemm_hls

using namespace gemm_hls;

// flash_bwd_dq's arguments (csrc/flash_bwd_dq.cu), for bf16 / fp16 with D
// 64 or 128, S_q >= 64, every base and row / head / batch stride of q, k,
// v, dO and dq whole 16-byte units.  Returns 0, a CUDA error code, -1 for
// what the route does not take, or -2 for a tensor map
// cuTensorMapEncodeTiled refused.
extern "C" int flash_bwd_dq_wgmma(const int64_t* seqs, const void* lse, const void* delta,
                                  const void* q_seg, const void* kv_seg, const void* offs,
                                  const int* dims, float cap, float scale, int dtype,
                                  void* stream) {
  BwArgs g{};
  if (!bw_args(g, seqs, 1, lse, delta, q_seg, kv_seg, offs, dims, cap, scale) || g.a.S_q < 64)
    return kUnsupported;
  g.n_tiles = (g.a.S_q + kDqBQ - 1) / kDqBQ;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool small = g.a.D == 64;
  switch (dtype) {
    case kBF16:
      return small ? launch_dq_wg<__nv_bfloat16, 64>(g, st) : launch_dq_wg<__nv_bfloat16, 128>(g, st);
    case kF16:
      return small ? launch_dq_wg<__half, 64>(g, st) : launch_dq_wg<__half, 128>(g, st);
    default: return kUnsupported;
  }
}

// flash_bwd_dkv's arguments (csrc/flash_bwd_dkv.cu), dk and dv per kv
// head, for what flash_bwd_dq_wgmma takes with S_kv >= 64 in place of S_q.
extern "C" int flash_bwd_dkv_wgmma(const int64_t* seqs, const void* lse, const void* delta,
                                   const void* q_seg, const void* kv_seg, const void* offs,
                                   const int* dims, float cap, float scale, int dtype,
                                   void* stream) {
  BwArgs g{};
  if (!bw_args(g, seqs, 2, lse, delta, q_seg, kv_seg, offs, dims, cap, scale) || g.a.S_kv < 64)
    return kUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool small = g.a.D == 64;
  switch (dtype) {
    case kBF16:
      return small ? launch_dkv_wg<__nv_bfloat16, 64>(g, st)
                   : launch_dkv_wg<__nv_bfloat16, 128>(g, st);
    case kF16:
      return small ? launch_dkv_wg<__half, 64>(g, st) : launch_dkv_wg<__half, 128>(g, st);
    default: return kUnsupported;
  }
}
