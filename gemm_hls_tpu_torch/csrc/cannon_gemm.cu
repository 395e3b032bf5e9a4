// Kernel cannon_gemm: 2-D Cannon on a p x p grid with the skew and the
// torus shifts fused into the GEMM.  Rank d = i p + j holds the blocks
// A_ij (M/p, K/p) and B_ij (K/p, N/p) and ends with C_ij = sum_l A_il B_lj.
//
// Replaces gemm_hls_tpu/ops/pallas_cannon.py::_cannon_kernel (B19).  All
// p^2 ranks run in one cooperative launch, n_send + n_comp blocks each, the
// rank table (A, B, C, the running sum, two ring buffers per operand,
// flags) in the launch parameters.  The protocol is pallas_cannon.py's:
//   * skew: one arbitrary-destination copy per operand, A_ij to rank (i,
//     j - i)'s comm_a[0] and B_ij, transposed to (N/p, K/p), to rank (i - j,
//     j)'s comm_b[0], each counted on the destination's recv_a[0] /
//     recv_b[0]; every block of the rank copies a share (the compute blocks
//     would idle through it anyway);
//   * p steps: the compute blocks wait for recv_a[s] and recv_b[s], add
//     comm_a[s % 2] . comm_b[s % 2] into the rank's sum (C itself at the
//     last step, cast there) and count done[s]; the sender blocks shift
//     both blocks, A to the left neighbour's and B to the upper one's
//     buffer (s + 1) % 2 (bulk copies, rank_sync.cuh's BulkRing), after
//     their acks from step 1 on;
//   * after step s <= p - 3, sender block 0 waits until every block of the
//     rank is done with step s and acks the right neighbour (A's source)
//     and the lower one (B's source).
// Counters per step, as in csrc/ring_gemm.cu, and the same flag protocol
// (rank_sync.cuh).
//
// The running sum: fp32 for floating inputs, int32 for int8, rounded once
// at the last store.  With a bfloat16 or float16 output it is kept at that
// precision instead, as pallas_cannon.py's acc of out_dtype is: each
// step's product is rounded to out_dtype, and so is its sum with the
// running sum (held in an fp32 buffer, exactly).
//
// Two compute routes, as in ring_gemm.cu: bf16 and int8 with K/p bytes a
// multiple of 16 on the Hopper tile engine (wgmma_tile.cuh; a tile's
// consecutive steps may fall to different blocks, so each step's
// consumers count the tile on a per-tile flag, and the next step's wait
// for it before they read the sum), the rest on dist_tile.cuh's tiles,
// where a tile belongs to the same block at every step.
//
// What bounds it on one H100: 2 M N K operations, the skew (|A| + |B|
// read and written) and (p - 1) shifts of |A| / p and |B| / p per grid row
// and column; at bf16 8192^3 and p = 2 the tensor-core rate, 1.11 ms,
// against 0.48 ms of bytes (fp32 C).  On one card it cannot beat one GEMM.
// Measured there (H100 80GB HBM3, 700 W; chip_smoke.py phase 24): 2.3-2.4
// ms at p = 2, of which the skew ~0.23 ms; each step's epilogue stores (and
// from the second step reads) a 128 x 256 fp32 tile of the running sum
// per 64 K-slabs, against 128 slabs a tile in the ring, so its items run
// ~20% slower than the ring's.
#include "wgmma_tile.cuh"

namespace gemm_hls {

// p <= 4: the rank table stays inside the 4 KB of launch parameters.
constexpr int kMaxRanks = 16;
// Flags: ackA, ackB, then recv_a[p], recv_b[p], done[p], then (wgmma
// route) one per tile.
constexpr int kAckA = 0, kAckB = 1, kRecv = 8;
constexpr int kMapsPerRank = 4;  // comm_a[0], comm_a[1], comm_b[0], comm_b[1]

struct CannonRank {
  const void* a;    // (ml, kl)
  const void* b;    // (kl, nl)
  void* c;          // (ml, nl), out_code
  void* sum;        // (ml, nl), sum_code
  void* ca[2];      // (ml, kl) each
  void* cb[2];      // (nl, kl) each: B^T
  int* flags;
};

struct CannonArgs {
  CannonRank r[kMaxRanks];
  const CUtensorMap* maps;  // kMapsPerRank a rank (wgmma route)
  long long* stamps;        // stamp_words(p) a rank, or null
  int p, ml, nl, kl;
  int n_send, n_comp;
  int out_code, sum_code, round, vec_a, vec_b;
  long long spin;  // wait budget in cycles (rank_sync.cuh)
};

// Step s's output: the running sum, or C at the last step.
__device__ __forceinline__ TileOut cannon_out(const CannonArgs& g, const CannonRank& R, int s) {
  const bool last = s + 1 == g.p;
  return TileOut{s > 0 ? R.sum : nullptr, g.nl, last ? R.c : R.sum, 0, g.nl,
                 last ? g.out_code : g.sum_code, g.round};
}

// Every block of the rank: its share of the skew.  Thread 0 copies its
// share of A_ij by bulk copies (``ring``), then all threads transpose their
// rows of B_ij; each part is counted on its destination's recv flag
// (target: the bpr blocks of a rank).
template <typename T, int NT, int V>
__device__ void cannon_skew(const CannonArgs& g, int me, int lb, int bpr, BulkRing& ring,
                            unsigned char* tile) {
  const int p = g.p, i = me / p, j = me % p;
  const CannonRank& R = g.r[me];
  const CannonRank& to_a = g.r[i * p + (j - i + p) % p];
  const CannonRank& to_b = g.r[(i - j + p) % p * p + j];
  const int64_t a_bytes = static_cast<int64_t>(g.ml) * g.kl * sizeof(T);
  if (threadIdx.x == 0) {
    ring.copy(to_a.ca[0], R.a, split_at(a_bytes, bpr, lb, kSendAlign),
              split_at(a_bytes, bpr, lb + 1, kSendAlign), g.spin);
    release_add(to_a.flags + kRecv, 1);
  }
  using B = Bits<T>;
  stage_rows<B, NT, V>(static_cast<B*>(to_b.cb[0]), static_cast<const B*>(R.b), g.kl, g.nl, lb,
                       bpr, reinterpret_cast<B*>(tile));
  signal_flag(to_b.flags + kRecv + p, 1);
}

// A sender block: thread 0 alone shifts this block's share of both blocks
// at each step and runs the flags.
template <typename T>
__device__ void cannon_send(const CannonArgs& g, int me, int lb, int bpr, BulkRing& ring) {
  if (threadIdx.x != 0) return;
  const int p = g.p, i = me / p, j = me % p;
  const CannonRank& R = g.r[me];
  int* recv_a = R.flags + kRecv;
  int* recv_b = recv_a + p;
  int* done = recv_b + p;
  long long* st = g.stamps ? g.stamps + static_cast<int64_t>(me) * stamp_words(p) : nullptr;
  const int64_t a_bytes = static_cast<int64_t>(g.ml) * g.kl * sizeof(T);
  const int64_t b_bytes = static_cast<int64_t>(g.nl) * g.kl * sizeof(T);
  const int64_t a_lo = split_at(a_bytes, g.n_send, lb, kSendAlign);
  const int64_t a_hi = split_at(a_bytes, g.n_send, lb + 1, kSendAlign);
  const int64_t b_lo = split_at(b_bytes, g.n_send, lb, kSendAlign);
  const int64_t b_hi = split_at(b_bytes, g.n_send, lb + 1, kSendAlign);
  // Shifts: A left, B up; acks go right (A's source) and down (B's).
  const CannonRank& left = g.r[i * p + (j + p - 1) % p];
  const CannonRank& up = g.r[(i + p - 1) % p * p + j];
  const CannonRank& right = g.r[i * p + (j + 1) % p];
  const CannonRank& down = g.r[(i + 1) % p * p + j];
  for (int s = 0; s + 1 < p; ++s) {
    const int cur = s & 1, target = s == 0 ? bpr : g.n_send;
    if (s >= 1) {
      wait_flag_thread(R.flags + kAckA, s, g.spin);
      wait_flag_thread(R.flags + kAckB, s, g.spin);
    }
    wait_flag_thread(&recv_a[s], target, g.spin);
    wait_flag_thread(&recv_b[s], target, g.spin);
    fence_proxy_async_global();
    ring.copy(left.ca[cur ^ 1], R.ca[cur], a_lo, a_hi, g.spin);
    release_add(left.flags + kRecv + s + 1, 1);
    ring.copy(up.cb[cur ^ 1], R.cb[cur], b_lo, b_hi, g.spin);
    release_add(up.flags + kRecv + p + s + 1, 1);
    if (st && lb == 0) st[kStampHead + 2 * p + s] = global_ns();
    release_add(&done[s], 1);
    if (lb == 0 && s <= p - 3) {
      wait_flag_thread(&done[s], bpr, g.spin);
      release_add(right.flags + kAckA, 1);
      release_add(down.flags + kAckB, 1);
    }
  }
}

// The mma.sync / CUDA-core route (fp32, or K/p bytes not a multiple of 16).
template <typename T>
__global__ void __launch_bounds__(Route<T>::NT, Route<T>::MINB)
    cannon_kernel(const __grid_constant__ CannonArgs g) {
  __shared__ __align__(128) unsigned char smem[kTileSmem];
  __shared__ uint64_t send_bars[3];
  const int p = g.p, bpr = g.n_send + g.n_comp;
  const int me = blockIdx.x / bpr, lb = blockIdx.x % bpr;
  const CannonRank& R = g.r[me];
  int* recv_a = R.flags + kRecv;
  int* recv_b = recv_a + p;
  int* done = recv_b + p;
  long long* st = g.stamps ? g.stamps + static_cast<int64_t>(me) * stamp_words(p) : nullptr;
  const bool stamper = st && lb == g.n_send && threadIdx.x == 0;
  if (stamper) st[0] = global_ns();

  // The bulk slots sit past the transpose's tile.
  constexpr int NT = Route<T>::NT, V = 1024 / NT;  // a 16 KB staging tile
  constexpr int kTile = stage_tile_bytes<NT, V>(), kChunk = (kTileSmem - kTile) / 3 / 16 * 16;
  static_assert(kChunk >= 1024, "bulk slots");
  BulkRing ring{smem + kTile, send_bars, 3, kChunk, 0};
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  cannon_skew<T, NT, V>(g, me, lb, bpr, ring, smem);
  if (lb < g.n_send) {
    cannon_send<T>(g, me, lb, bpr, ring);
    return;
  }

  using R_ = Route<T>;
  const int tiles_m = (g.ml + R_::BM - 1) / R_::BM, tiles_n = (g.nl + R_::BN - 1) / R_::BN;
  for (int s = 0; s < p; ++s) {
    const long long t0 = stamper ? global_ns() : 0;
    wait_flag(&recv_a[s], s == 0 ? bpr : g.n_send, g.spin);
    wait_flag(&recv_b[s], s == 0 ? bpr : g.n_send, g.spin);
    if (stamper) {
      const long long now = global_ns();
      if (s == 0) st[1] = now;
      stamp_max(st + 2, now - t0);
      st[kStampHead + s] = now;
    }
    const TileOut o = cannon_out(g, R, s);
    for (int t = lb - g.n_send; t < tiles_m * tiles_n; t += g.n_comp) {
      int m0, n0;
      tile_origin(t, tiles_m, tiles_n, R_::BM, R_::BN, m0, n0);
      gemm_tile<T>(smem, R.ca[s & 1], g.kl, g.vec_a, R.cb[s & 1], g.kl, g.vec_b, g.ml, g.nl,
                   g.kl, m0, n0, o);
    }
    signal_flag(&done[s], 1);
    if (stamper) st[kStampHead + p + s] = global_ns();
  }
}

// The Hopper tile engine's route (bf16, int8; K/p bytes a multiple of 16).
template <typename T>
__global__ void __launch_bounds__(kWgThreads, 1)
    cannon_wg_kernel(const __grid_constant__ CannonArgs g) {
  extern __shared__ unsigned char dyn_smem[];
  unsigned char* smem = wg_align(dyn_smem);
  WgBars* bars = reinterpret_cast<WgBars*>(smem + kWgStages * kWgStage);
  const int p = g.p, bpr = g.n_send + g.n_comp;
  const int me = blockIdx.x / bpr, lb = blockIdx.x % bpr;
  const CannonRank& R = g.r[me];
  long long* st = g.stamps ? g.stamps + static_cast<int64_t>(me) * stamp_words(p) : nullptr;
  if (st && lb == g.n_send && threadIdx.x == 0) st[0] = global_ns();

  if (threadIdx.x == 0) wg_init_bars(bars);
  __syncthreads();
  // Bulk slots from the second stage on, the transpose's tile in the first.
  BulkRing ring{smem + kWgStage, bars->send, kWgSendSlots - 2, kWgSendChunk, 0};
  cannon_skew<T, kWgThreads, kWgStageV>(g, me, lb, bpr, ring, smem);
  fence_proxy_async_shared();  // the transpose's tile, before TMA writes into it
  __syncthreads();
  if (lb < g.n_send) {
    cannon_send<T>(g, me, lb, bpr, ring);
    return;
  }
  const CUtensorMap* maps = g.maps + static_cast<int64_t>(me) * kMapsPerRank;
  int* recv_a = R.flags + kRecv;
  const WgJob job{{maps, maps + 1}, {maps + 2, maps + 3}, {recv_a, recv_a + p}, bpr, g.n_send,
                  recv_a + 2 * p, recv_a + 3 * p, st, g.spin, g.ml, g.nl, g.kl, p, g.n_comp,
                  lb - g.n_send};
  wg_compute<T>(job, smem, bars, [&](int s) { return cannon_out(g, R, s); });
}

}  // namespace gemm_hls

using namespace gemm_hls;

// ranks: p^2 rows of (a, b, c, sum, ca0, ca1, cb0, cb1, flags) device
// pointers, flat grid order i p + j.  dims: p, ml, nl, kl, in_code,
// out_code, vec_a, vec_b, max_per_rank, spin budget in ms, route (1: the
// wgmma engine, 0: mma.sync / CUDA cores), sender blocks a rank (-1: the
// kernel's default), round (kBF16 / kF16: the running sum kept at that
// precision, in fp32 sums; 0: fp32 / int32 sums).  maps: device buffer of
// p^2 * 4 tensor maps (wgmma route).  stamps: p^2 * stamp_words(p) zeroed
// int64, or null.  split_out (host, may be null) receives the blocks per
// rank.  The flags must be zero (the wgmma route's tile flags included).
// Returns 0, a CUDA error, -1 for a type or grid no kernel takes, or -2
// for a tensor map cuTensorMapEncodeTiled refused.
extern "C" int cannon_gemm(const int64_t* ranks, const int* dims, int* split_out, void* maps,
                           void* stamps, void* stream) {
  CannonArgs g{};
  g.p = dims[0];
  if (g.p < 1 || g.p * g.p > kMaxRanks) return kUnsupported;
  g.ml = dims[1];
  g.nl = dims[2];
  g.kl = dims[3];
  g.out_code = dims[5];
  g.vec_a = dims[6];
  g.vec_b = dims[7];
  g.spin = spin_cycles(dims[9]);
  const bool wg = dims[10] == 1;
  g.round = dims[12];
  g.maps = static_cast<const CUtensorMap*>(maps);
  g.stamps = static_cast<long long*>(stamps);
  const int ranks_n = g.p * g.p;
  for (int d = 0; d < ranks_n; ++d) {
    const int64_t* q = ranks + 9 * d;
    auto ptr = [&](int k) { return reinterpret_cast<void*>(q[k]); };
    g.r[d] = CannonRank{ptr(0), ptr(1), ptr(2), ptr(3), {ptr(4), ptr(5)}, {ptr(6), ptr(7)},
                        static_cast<int*>(ptr(8))};
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int max_per_rank = dims[8], n_send = dims[11];
  g.sum_code = dims[4] == kI8 && !g.round ? kI32 : kF32;
  if (wg) {
    const int esize = dims[4] == kBF16 ? 2 : dims[4] == kI8 ? 1 : 0;
    if (!esize || (static_cast<int64_t>(g.kl) * esize) % 16) return kUnsupported;
    std::vector<CUtensorMap> host(static_cast<size_t>(ranks_n) * kMapsPerRank);
    for (int d = 0; d < ranks_n; ++d) {
      CUtensorMap* m = &host[static_cast<size_t>(d) * kMapsPerRank];
      if (!encode_kmajor(m, g.r[d].ca[0], g.ml, g.kl, esize, kWgBM) ||
          !encode_kmajor(m + 1, g.r[d].ca[1], g.ml, g.kl, esize, kWgBM) ||
          !encode_kmajor(m + 2, g.r[d].cb[0], g.nl, g.kl, esize, kWgBN) ||
          !encode_kmajor(m + 3, g.r[d].cb[1], g.nl, g.kl, esize, kWgBN))
        return kTmaEncodeFailed;
    }
    const int err = upload_maps(maps, host, st);
    if (err) return err;
    const int tiles = (g.ml + kWgBM - 1) / kWgBM * ((g.nl + kWgBN - 1) / kWgBN);
    if (esize == 2)
      return launch_ranks(cannon_wg_kernel<__nv_bfloat16>, g, ranks_n, kWgThreads, kWgSmem, tiles,
                          max_per_rank, n_send, st, split_out);
    return launch_ranks(cannon_wg_kernel<signed char>, g, ranks_n, kWgThreads, kWgSmem, tiles,
                        max_per_rank, n_send, st, split_out);
  }
  auto launch = [&](auto kern, auto route) {
    using R = decltype(route);
    const int tiles = (g.ml + R::BM - 1) / R::BM * ((g.nl + R::BN - 1) / R::BN);
    return launch_ranks(kern, g, ranks_n, R::NT, 0, tiles, max_per_rank, n_send, st, split_out);
  };
  switch (dims[4]) {
    case kBF16: return launch(cannon_kernel<__nv_bfloat16>, Route<__nv_bfloat16>{});
    case kI8: return launch(cannon_kernel<signed char>, Route<signed char>{});
    case kF32: return launch(cannon_kernel<float>, Route<float>{});
    default:
      return kUnsupported;
  }
}
