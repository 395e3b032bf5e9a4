// Kernel flash_decode: the flash-attention forward for few query rows a kv
// head (decode), o = softmax(scale q k^T) v per head with lse = m + log(l)
// in fp32, as a split-KV flash decode for bf16 / fp16 at a head dim of 64
// or 128.
//
// Replaces, for these shapes, the TPU kernel _flash_kernel (B6,
// gemm_hls_tpu/ops/pallas_flash.py:62, pallas_call at :920) as the JAX
// decode fast path runs it (gemm_hls_tpu/ops/attention.py:161-186: a kv
// head's group of q heads packed as the q rows of one head against the
// padded cache), with csrc/flash_common.cuh's conventions: a masked score
// is kMask and a masked probability exactly 0, a row that sees no key
// gives o = 0 and lse = -inf, p is rounded to v's type before p v, and
// kv_lengths with causal anchor the queries at the cache end.  Every mask
// option of flash_fwd (kv_lengths, causal, window, offsets, segment ids),
// the soft cap, lse and an fp32 o stay run-time arguments.  Which calls
// take it (ops/flash.py::flash_route): group x S_q <= 16 rows a kv head,
// D 64 or 128, every base and row / head / batch stride of q, k and v a
// whole 16-byte unit; the rest stays on csrc/flash_wgmma.cu (>= 64 rows)
// and csrc/flash_fwd.cu.
//
// What bounds it on an H100: the cache's bytes.  At the serving decode (64
// sequences x 4096 slots, H_q 16 / H_kv 4, D 128 bf16, mean length 3018)
// the live K and V are 395 MB, 0.118 ms at 3.35 TB/s, and 4 q rows make
// ~4 operations a byte, far below the ~295 at which the tensor cores
// become the limit.  So the design keeps bytes in flight on every SM until
// the end of the launch:
//   * grid (split, kv head): a split is a fixed run of cache slots chosen
//     on the host from S_kv and the kv heads (ops/flash.py::splitkv_plan,
//     never from the device lengths, which would synchronise the stream):
//     at 4096 slots and 256 kv heads 8 splits of 512, 2048 blocks of 160
//     threads and ~72 KB, three a SM.  A block owns every q row of its kv
//     head (group x S_q <= 16), so each cache byte is read once; a split
//     outside its head's live range (flash_common.cuh::kv_range) loads
//     nothing and contributes l = 0, m = kMask;
//   * one producer thread loads the split's K and V tiles (32 kv rows at D
//     128, 64 at D 64: 16 KB a stage) by TMA into a ring of 4 stages with
//     full / empty mbarriers, through the (D, H, S, batch) maps of
//     csrc/flash_wgmma.cuh (the (batch, S, H, D) cache read in place, rows
//     past S_kv zero-filled);
//   * four consumer warps each take whole tiles (tile t to warp t % 4) with
//     their own m, l and accumulator.  The products run on mma.sync
//     m16n8k16 with the kv rows as the M side: S^T = K q^T (K from the
//     swizzled stage by ldmatrix, q's rows as N, 8 or 16 of them: 4 live q
//     rows fill half of each n8 tile, where q rows as M would fill a
//     quarter of m16 and 1/16 of a wgmma m64).  The softmax runs along M
//     (each q column's max over the warp's rows by shuffles); P^T, rounded
//     to v's type, becomes the B fragment of O^T += V^T P^T by one
//     movmatrix transpose per 8 x 8 block, with no trip through shared
//     memory, and V^T is read by ldmatrix.trans.  wgmma would put the kv
//     rows on M as well, but an m64 step a warpgroup is 64 kv rows of 4
//     columns and its B operand (q) would have to sit in shared memory
//     K-major per tile; at ~4 operations a byte the warp-level form is not
//     the limit;
//   * stale slots at or past kv_lim in the last live tile (a padded cache's
//     NaN / +inf, which TMA cannot stop at) are zeroed in shared memory by
//     the warp that owns the tile before P^T meets V (0 * inf would poison
//     the sum); K's stale rows only reach scores that the mask replaces;
//   * the warps' partials merge in shared memory in warp order, then the
//     splits of a kv head, one thread block cluster, merge through
//     distributed shared memory: each rank owns a share of the (row, d)
//     outputs, every rank writes its partial of that share and its (m, l)
//     into the owner's shared memory, and after one cluster barrier each
//     rank combines its share in split order and stores it (as
//     csrc/dequant_wgmma.cu's split K).  One launch, no workspace, no
//     atomics: the same bits on every launch.
#include <cooperative_groups.h>

#include "flash_wgmma.cuh"

namespace gemm_hls {

namespace dcg = cooperative_groups;

constexpr int kDcWarps = 4, kDcThreads = 32 * kDcWarps + 32;  // consumers, then the producer warp
constexpr int kDcStages = 4;
constexpr int kDcMaxRows = 16, kDcMaxSplits = 8;  // q rows a kv head; a portable cluster
constexpr int kDcSplitAlign = 64;  // splits start on whole tiles of either head dim

template <int DMAX, int NQ> struct Dc {
  static constexpr int kBKV = DMAX == 128 ? 32 : 64;  // kv rows a tile: 16 KB of K and V
  static constexpr int kChunks = DMAX / 64;
  static constexpr int kBox = kBKV * kWgRowBytes;  // one 64-column box of a K or V tile
  static constexpr int kTile = kChunks * kBox;
  static constexpr int kStage = 2 * kTile;
  static constexpr int kNR = 8 * NQ;  // q rows a block, padded to n8 tiles
  static constexpr int kNE = kNR * DMAX;  // o values a block
  static constexpr int kQPitch = DMAX + 8;  // the q tile's pitch (conflict-free ldmatrix)
  // Shared memory from the 1024-aligned base: the ring (the warps' partials
  // after it drains), q, the cluster's partials, their (m, l), the warps'
  // (m, l), the barriers.
  static constexpr int kRing = kDcStages * kStage;
  static constexpr int kQ = kRing;
  static constexpr int kPart = kQ + kNR * kQPitch * 2;
  static constexpr int kPm = kPart + (kNE + kDcMaxSplits) * 4;
  static constexpr int kPl = kPm + kDcMaxSplits * kNR * 4;
  static constexpr int kWm = kPl + kDcMaxSplits * kNR * 4;
  static constexpr int kWl = kWm + kDcWarps * kNR * 4;
  static constexpr int kBars = kWl + kDcWarps * kNR * 4;
  static constexpr int kSmem = 1024 + kBars + 2 * kDcStages * 8;
  static_assert(kDcWarps * kNR * DMAX * 4 <= kRing, "the warps' partials fit the ring");
  static_assert(kBars % 8 == 0, "mbarrier alignment");
};

struct DcArgs {
  CUtensorMap mk, mv;  // (D, H, S, batch) maps of K and V, boxes of 64 x kBKV
  FlashArgs a;
  int splits, split_len;  // the plan: cluster size, slots a split
  int rows;               // q rows a kv head: group x S_q
  long long spin;
};

// The byte address of element (r, col) of a K or V tile TMA wrote with the
// 128-byte swizzle: 64-column boxes, 16-byte unit u of row r at u ^ (r % 8).
template <int DMAX>
__device__ __forceinline__ const void* dc_at(const unsigned char* tile, int r, int col) {
  using Z = Dc<DMAX, 1>;
  return tile + (col / 64) * Z::kBox + r * kWgRowBytes + ((((col % 64) / 8) ^ (r & 7)) << 4);
}

// The 8 x 8 block of 16-bit values a warp holds as an m16n8 fragment's half
// (thread t: row t / 4, columns 2 (t % 4) and + 1), transposed.
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

template <int DMAX>
__device__ void dc_produce(const DcArgs& g, unsigned char* ring, uint64_t* full, uint64_t* empty,
                           int kvh, int j_lo, int n_tiles) {
  using Z = Dc<DMAX, 1>;
  const FlashArgs& a = g.a;
  const int kn = kvh / a.k.heads, kh = kvh % a.k.heads;
  const int vn = kvh / a.v.heads, vh = kvh % a.v.heads;
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kDcStages;
    mbar_wait(&empty[st], ((t / kDcStages) & 1) ^ 1, g.spin);
    mbar_expect_tx(&full[st], Z::kStage);
    unsigned char* dst = ring + st * Z::kStage;
    const int row = (j_lo + t) * Z::kBKV;
#pragma unroll
    for (int c = 0; c < Z::kChunks; ++c) {
      tma_load_4d(dst + c * Z::kBox, &g.mk, 64 * c, kh, row, kn, &full[st]);
      tma_load_4d(dst + Z::kTile + c * Z::kBox, &g.mv, 64 * c, vh, row, vn, &full[st]);
    }
  }
}

template <typename T, int DMAX, int NQ>
__global__ void __launch_bounds__(kDcThreads, NQ == 1 ? 3 : 2)
    flash_decode_kernel(const __grid_constant__ DcArgs g) {
  using Z = Dc<DMAX, NQ>;
  constexpr int BKV = Z::kBKV, NR = Z::kNR, NM = BKV / 16, ND = DMAX / 16;
  extern __shared__ unsigned char dyn_smem[];
  unsigned char* smem = wg_align(dyn_smem);
  unsigned char* ring = smem;
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem + Z::kQ);
  float* part = reinterpret_cast<float*>(smem + Z::kPart);
  float* pm = reinterpret_cast<float*>(smem + Z::kPm);
  float* pl = reinterpret_cast<float*>(smem + Z::kPl);
  float* wm = reinterpret_cast<float*>(smem + Z::kWm);
  float* wl = reinterpret_cast<float*>(smem + Z::kWl);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Z::kBars);
  uint64_t* empty = full + kDcStages;
  const FlashArgs& a = g.a;
  const int split = blockIdx.x, kvh = a.b0 + blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // Every q row of the block reads kv head kvh: one mask (head_mask reads
  // kv_lengths by kv head), live columns [c_lo, c_hi) over rows [0, S_q).
  const Mask mask = head_mask(a, kvh * a.group);
  int c_lo, c_hi;
  kv_range(mask, 0, a.S_q, c_lo, c_hi);
  const int s0 = max(c_lo, split * g.split_len), s1 = min(c_hi, (split + 1) * g.split_len);
  const int j_lo = s0 / BKV, n_tiles = s1 > s0 ? (s1 + BKV - 1) / BKV - j_lo : 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kDcStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();
  // Every rank of the cluster has started before any writes another's
  // shared memory (the wait, before the partials go out).
  cluster_arrive(false);
  if (warp == kDcWarps) {
    if (lane == 0) dc_produce<DMAX>(g, ring, full, empty, kvh, j_lo, n_tiles);
    __syncwarp();
    cluster_wait();
    cluster_arrive(true);
    cluster_wait();
    return;
  }

  const int tid = threadIdx.x, gq = lane >> 2, tq = lane & 3;
  // q rows n < rows (q head kvh * group + n / S_q, row n % S_q) into a
  // padded tile, zeros past them.
  for (int i = tid; i < NR * (DMAX / 8); i += 32 * kDcWarps) {
    const int n = i / (DMAX / 8), c = (i % (DMAX / 8)) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (n < g.rows)
      x = *reinterpret_cast<const uint4*>(static_cast<const uint16_t*>(a.q.p) +
                                          a.q.row(kvh * a.group + n / a.S_q, n % a.S_q) + c);
    *reinterpret_cast<uint4*>(qs + n * Z::kQPitch + c) = x;
  }
  named_sync(1, 32 * kDcWarps);
  // q^T as the B fragments of S^T = K q^T: n8 tile nt, k16 slice kk.
  uint32_t qf[ND][NQ][2];
#pragma unroll
  for (int kk = 0; kk < ND; kk += 2)
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {
      uint32_t r[4];
      ldsm_x4(r, qs + (8 * nt + (lane & 7)) * Z::kQPitch + 16 * kk + 8 * (lane >> 3));
      qf[kk][nt][0] = r[0];
      qf[kk][nt][1] = r[1];
      qf[kk + 1][nt][0] = r[2];
      qf[kk + 1][nt][1] = r[3];
    }
  // This thread's q columns 8 nt + 2 tq + j: the kv columns [c_min, c_max)
  // that pass the position mask (none for a padding row), segment ids.
  int c_min[NQ][2], c_max[NQ][2], seg_q[NQ][2];
#pragma unroll
  for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = 8 * nt + 2 * tq + j;
      c_min[nt][j] = c_max[nt][j] = seg_q[nt][j] = 0;
      if (n < g.rows) {
        row_bounds(mask, n % a.S_q, c_min[nt][j], c_max[nt][j]);
        if (a.q_seg)
          seg_q[nt][j] = a.q_seg[static_cast<int64_t>(kvh * a.group + n / a.S_q) * a.S_q + n % a.S_q];
      }
    }

  float acc[ND][NQ][4];
#pragma unroll
  for (int dt = 0; dt < ND; ++dt)
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) acc[dt][nt][0] = acc[dt][nt][1] = acc[dt][nt][2] = acc[dt][nt][3] = 0.f;
  float m_r[NQ][2], l_r[NQ][2];
#pragma unroll
  for (int nt = 0; nt < NQ; ++nt) m_r[nt][0] = m_r[nt][1] = kMask, l_r[nt][0] = l_r[nt][1] = 0.f;
  const int* kv_seg = a.kv_seg ? a.kv_seg + static_cast<int64_t>(kvh) * a.S_kv : nullptr;

  for (int t = warp; t < n_tiles; t += kDcWarps) {
    const int st = t % kDcStages;
    mbar_wait(&full[st], (t / kDcStages) & 1, g.spin);
    const unsigned char* kt = ring + st * Z::kStage;
    unsigned char* vt = ring + st * Z::kStage + Z::kTile;
    const int c0 = (j_lo + t) * BKV;
    // S^T (kv rows 16 mt + gq (+ 8), q columns 8 nt + 2 tq (+ 1)) = K q^T.
    float s[NM][NQ][4];
#pragma unroll
    for (int mt = 0; mt < NM; ++mt)
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt) s[mt][nt][0] = s[mt][nt][1] = s[mt][nt][2] = s[mt][nt][3] = 0.f;
#pragma unroll
    for (int mt = 0; mt < NM; ++mt)
#pragma unroll
      for (int kk = 0; kk < ND; ++kk) {
        uint32_t ka[4];
        ldsm_x4(ka, dc_at<DMAX>(kt, 16 * mt + (lane & 7) + 8 * ((lane >> 3) & 1),
                                    16 * kk + 8 * (lane >> 4)));
#pragma unroll
        for (int nt = 0; nt < NQ; ++nt) mma16816<T>(s[mt][nt], ka, qf[kk][nt][0], qf[kk][nt][1]);
      }

    const bool edge = a.q_seg || !interior(mask, 0, a.S_q, c0, BKV);
    // Scores in log2 units (exp2 is one MUFU op): the cap and the mask are
    // uniform branches around whole loops, never per-element selects.
    if (a.cap > 0.f) {
#pragma unroll
      for (int mt = 0; mt < NM; ++mt)
#pragma unroll
        for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][nt][e] = score(s[mt][nt][e], a.scale, a.cap) * kLog2e;
    } else {
      const float sl2 = a.scale * kLog2e;
#pragma unroll
      for (int mt = 0; mt < NM; ++mt)
#pragma unroll
        for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][nt][e] *= sl2;
    }
    if (edge) {
#pragma unroll
      for (int mt = 0; mt < NM; ++mt)
#pragma unroll
        for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = c0 + 16 * mt + gq + 8 * (e >> 1), j = e & 1;
            if (c < c_min[nt][j] || c >= c_max[nt][j] || (kv_seg && seg_q[nt][j] != kv_seg[c]))
              s[mt][nt][e] = kMask;
          }
    }
    // Each q column's max over the tile: the thread's rows, then the eight
    // lanes of its tq (lane bits 2-4).
    float corr[NQ][2];
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float mx = m_r[nt][j];
#pragma unroll
        for (int mt = 0; mt < NM; ++mt) mx = fmaxf(mx, fmaxf(s[mt][nt][j], s[mt][nt][j + 2]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        corr[nt][j] = exp2f(m_r[nt][j] - mx);
        m_r[nt][j] = mx;
        l_r[nt][j] *= corr[nt][j];
      }
#pragma unroll
    for (int mt = 0; mt < NM; ++mt)
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // A masked probability is exactly 0 (kMask - kMask would give 1).
          const float p = (edge && s[mt][nt][e] == kMask) ? 0.f : exp2f(s[mt][nt][e] - m_r[nt][e & 1]);
          s[mt][nt][e] = p;
          l_r[nt][e & 1] += p;
        }
#pragma unroll
    for (int dt = 0; dt < ND; ++dt)
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[dt][nt][e] *= corr[nt][e & 1];
    // P^T rounded to v's type (p.astype(v.dtype)) as the B fragments of
    // O^T += V^T P^T: k16 slice mt, its two 8 x 8 halves transposed.
    uint32_t pb[NM][NQ][2];
#pragma unroll
    for (int mt = 0; mt < NM; ++mt)
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt) {
        pb[mt][nt][0] = movmatrix_t(MmaType<T>::pack(s[mt][nt][0], s[mt][nt][1]));
        pb[mt][nt][1] = movmatrix_t(MmaType<T>::pack(s[mt][nt][2], s[mt][nt][3]));
      }
    // A padded cache's stale slots inside this tile: zero V's rows.
    if (mask.kv_lim < c0 + BKV) {
      const int z0 = mask.kv_lim - c0, z1 = min(BKV, a.S_kv - c0);
      for (int u = lane; u < (z1 - z0) * 8 * Z::kChunks; u += 32) {
        const int r = z0 + u / (8 * Z::kChunks), c = u % (8 * Z::kChunks);
        *reinterpret_cast<uint4*>(vt + (c / 8) * Z::kBox + r * kWgRowBytes + (c % 8) * 16) =
            make_uint4(0u, 0u, 0u, 0u);
      }
      // The stage's next TMA write (async proxy) comes after these.
      fence_proxy_async_shared();
      __syncwarp();
    }
#pragma unroll
    for (int mt = 0; mt < NM; ++mt)
#pragma unroll
      for (int dt = 0; dt < ND; ++dt) {
        uint32_t va[4];
        ldsm_x4_t(va, dc_at<DMAX>(vt, 16 * mt + (lane & 7) + 8 * (lane >> 4),
                                      16 * dt + 8 * ((lane >> 3) & 1)));
#pragma unroll
        for (int nt = 0; nt < NQ; ++nt) mma16816<T>(acc[dt][nt], va, pb[mt][nt][0], pb[mt][nt][1]);
      }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // l over the warp's rows: the eight lanes of each tq.
#pragma unroll
  for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      l_r[nt][j] += __shfl_xor_sync(0xffffffffu, l_r[nt][j], 4);
      l_r[nt][j] += __shfl_xor_sync(0xffffffffu, l_r[nt][j], 8);
      l_r[nt][j] += __shfl_xor_sync(0xffffffffu, l_r[nt][j], 16);
    }
  // Every warp is past its tiles, so every load has landed and been read:
  // the ring holds the warps' partials (unnormalised O, m, l) now.
  named_sync(1, 32 * kDcWarps);
  float* wacc = reinterpret_cast<float*>(ring);  // [warp][row][d]
#pragma unroll
  for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = 8 * nt + 2 * tq + j;
      if (gq == 0) {
        wm[warp * NR + n] = m_r[nt][j];
        wl[warp * NR + n] = l_r[nt][j];
      }
#pragma unroll
      for (int dt = 0; dt < ND; ++dt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          wacc[(warp * NR + n) * DMAX + 16 * dt + gq + 8 * h] = acc[dt][nt][2 * h + j];
    }
  named_sync(1, 32 * kDcWarps);

  // The block's partial, the warps merged in warp order, goes to the rank
  // that owns each value: value e (row e / DMAX, column e % DMAX) to rank
  // e / most, at [split][e - its share's first].
  dcg::cluster_group cluster = dcg::this_cluster();
  const int S = g.splits, most = (Z::kNE + S - 1) / S;
  cluster_wait();  // every rank has started
  for (int e = tid; e < Z::kNE; e += 32 * kDcWarps) {
    const int n = e / DMAX;
    float mb = wm[n];
#pragma unroll
    for (int w = 1; w < kDcWarps; ++w) mb = fmaxf(mb, wm[w * NR + n]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kDcWarps; ++w)
      sum += exp2f(wm[w * NR + n] - mb) * wacc[(w * NR) * DMAX + e];
    const int owner = e / most;
    cluster.map_shared_rank(part, owner)[split * most + e - owner * most] = sum;
  }
  if (tid < NR) {
    float mb = wm[tid];
#pragma unroll
    for (int w = 1; w < kDcWarps; ++w) mb = fmaxf(mb, wm[w * NR + tid]);
    float lb = 0.f;
#pragma unroll
    for (int w = 0; w < kDcWarps; ++w) lb += exp2f(wm[w * NR + tid] - mb) * wl[w * NR + tid];
    for (int r = 0; r < S; ++r) {
      cluster.map_shared_rank(pm, r)[split * NR + tid] = mb;
      cluster.map_shared_rank(pl, r)[split * NR + tid] = lb;
    }
  }
  cluster_arrive(true);
  cluster_wait();  // every rank's partial of this rank's share has landed

  // This rank's share: each value summed over the splits in split order.
  const int e0 = split * most, e1 = min(Z::kNE, e0 + most);
  for (int e = e0 + tid; e < e1; e += 32 * kDcWarps) {
    const int n = e / DMAX, d = e % DMAX;
    if (n >= g.rows) continue;
    float mx = pm[n];
    for (int r = 1; r < S; ++r) mx = fmaxf(mx, pm[r * NR + n]);
    float l = 0.f, o = 0.f;
    for (int r = 0; r < S; ++r) {
      const float w = exp2f(pm[r * NR + n] - mx);
      l += w * pl[r * NR + n];
      o += w * part[r * most + e - e0];
    }
    const int b = kvh * a.group + n / a.S_q, sr = n % a.S_q;
    const float x = o / (l == 0.f ? 1.f : l);
    const int64_t at = a.o.row(b, sr) + d;
    if (a.o_f32)
      static_cast<float*>(const_cast<void*>(a.o.p))[at] = x;
    else
      MmaType<T>::store(const_cast<void*>(a.o.p), at, x);
    if (d == 0 && a.lse) a.lse[static_cast<int64_t>(b) * a.S_q + sr] = mx * kLn2 + logf(l);
  }
}

template <typename T, int DMAX, int NQ>
int dc_launch(DcArgs& g, int b_kv, cudaStream_t st) {
  using Z = Dc<DMAX, NQ>;
  const auto kern = flash_decode_kernel<T, DMAX, NQ>;
  static const int attr = static_cast<int>(
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Z::kSmem));
  if (attr) return attr;
  const FlashArgs& a = g.a;
  constexpr bool f16 = std::is_same<T, __half>::value;
  if (!encode_seq(&g.mk, a.k, b_kv, a.S_kv, a.D, f16, Z::kBKV) ||
      !encode_seq(&g.mv, a.v, b_kv, a.S_kv, a.D, f16, Z::kBKV))
    return kTmaEncodeFailed;
  for (int b0 = 0; b0 < b_kv; b0 += static_cast<int>(kMaxGridZ)) {
    g.a.b0 = b0;
    const int n = static_cast<int>(b_kv - b0 < kMaxGridZ ? b_kv - b0 : kMaxGridZ);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(g.splits), static_cast<unsigned>(n));
    cfg.blockDim = dim3(kDcThreads);
    cfg.dynamicSmemBytes = Z::kSmem;
    cfg.stream = st;
    cudaLaunchAttribute cl;
    cl.id = cudaLaunchAttributeClusterDimension;
    cl.val.clusterDim.x = static_cast<unsigned>(g.splits);
    cl.val.clusterDim.y = 1;
    cl.val.clusterDim.z = 1;
    cfg.attrs = &cl;
    cfg.numAttrs = 1;
    const int err = static_cast<int>(cudaLaunchKernelEx(&cfg, kern, g));
    if (err) return err;
    if (const int late = last_error()) return late;
  }
  return 0;
}

template <typename T>
int dc_dispatch(DcArgs& g, int b_kv, cudaStream_t st) {
  const bool wide = g.rows > 8;
  if (g.a.D == 64)
    return wide ? dc_launch<T, 64, 2>(g, b_kv, st) : dc_launch<T, 64, 1>(g, b_kv, st);
  return wide ? dc_launch<T, 128, 2>(g, b_kv, st) : dc_launch<T, 128, 1>(g, b_kv, st);
}

}  // namespace gemm_hls

using namespace gemm_hls;

// flash_fwd's arguments (csrc/flash_fwd.cu), dims extended by the split
// plan: B, group, S_q, S_kv, D, causal, window, vec, o_f32, splits,
// split_len.  For bf16 / fp16 with D 64 or 128, group x S_q <= 16, every
// base and row / head / batch stride of q, k and v whole 16-byte units,
// 1-8 splits of split_len slots (a multiple of 64) covering S_kv with none
// empty.  Returns 0, a CUDA error code, -1 for what the route does not
// take, or -2 for a tensor map cuTensorMapEncodeTiled refused.
extern "C" int flash_decode(const int64_t* seqs, void* lse, const void* kv_len, const void* q_seg,
                            const void* kv_seg, const void* offs, const int* dims, float cap,
                            float scale, int dtype, void* stream) {
  DcArgs g{};
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
  g.splits = dims[9];
  g.split_len = dims[10];
  a.cap = cap;
  a.scale = scale;
  if ((a.D != 64 && a.D != 128) || a.B < 1 || a.group < 1 || a.B % a.group || a.S_q < 1 ||
      a.S_kv < 1 || a.S_q * a.group > kDcMaxRows || g.splits < 1 || g.splits > kDcMaxSplits ||
      g.split_len < 1 || g.split_len % kDcSplitAlign ||
      static_cast<int64_t>(g.splits) * g.split_len < a.S_kv ||
      static_cast<int64_t>(g.splits - 1) * g.split_len >= a.S_kv)
    return kUnsupported;
  g.rows = a.group * a.S_q;
  g.spin = spin_cycles(10000);  // a stage wait is microseconds; 10 s means a lost load
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int b_kv = a.B / a.group;
  switch (dtype) {
    case kBF16: return dc_dispatch<__nv_bfloat16>(g, b_kv, st);
    case kF16: return dc_dispatch<__half>(g, b_kv, st);
    default: return kUnsupported;
  }
}
