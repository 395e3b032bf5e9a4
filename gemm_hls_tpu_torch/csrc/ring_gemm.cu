// Kernel ring_gemm: the 1-D ring GEMM with the transfer fused into the
// GEMM, C_r (M/n, N) = A_r (M/n, K) . [B_0 | ... | B_{n-1}], where rank r
// holds A's row block A_r and B's column block B_r (K, N/n).
//
// Replaces both bodies of gemm_hls_tpu/ops/pallas_ring.py (B18):
// _ring_kernel (operands held in VMEM) and _ring_kernel_tiled (K streamed
// in block_k chunks).  They differ only in where the TPU keeps the blocks
// (VMEM or HBM); here both are one kernel, whose tile streams K through
// shared memory in steps of its own, so block_k is only checked by the
// wrapper and every block_k gives the same bits.
//
// All n ranks run in one cooperative launch, n_send + n_comp blocks each
// (blockIdx gives the rank); the rank table in the launch parameters holds
// each rank's A, B, C, its two ring buffers and its flags, so ranks may sit
// anywhere in memory (the same table would hold peer pointers for ranks
// on other cards).  The protocol is pallas_ring.py's, step for step:
//   * every block of the rank stages its share of B_r into comm[0]
//     transposed, (N/n, K), so every later copy is a flat one and the GEMM
//     reads B K-contiguous, and counts recv[0] (the compute blocks would
//     idle through the staging anyway);
//   * at step s the sender blocks forward comm[s % 2] to the right
//     neighbour's comm[(s + 1) % 2] (one thread a block, bulk copies
//     through shared memory, rank_sync.cuh's BulkRing) and count its
//     recv[s + 1]; from step 1 on, only after the right neighbour's ack;
//   * the compute blocks wait for recv[s], write C_r's column block of the
//     source rank (r - s) mod n and count done[s];
//   * after step s <= n - 3, sender block 0 waits until every block of the
//     rank is done with step s (the compute reads of comm[s % 2] and the
//     sends from it) and acks the left neighbour: signals equal waits at
//     n - 2, no ack when n <= 2, and n = 1 runs one step and sends nothing.
// Every counter that blocks of one step add to is per step (recv[s],
// done[s]): a block may run a step ahead of its peers, so a shared running
// count could be met by the wrong step's arrivals.  The only running count
// is the ack, which one block sends, in step order.
//
// Two compute routes, chosen by shape in the wrapper (ops/ring.py::
// ring_route): bf16 and int8 with K bytes a multiple of 16 (what a TMA map
// can describe) run ring_wg_kernel on the Hopper tile engine
// (wgmma_tile.cuh: TMA ring, warp-specialised wgmma, one 384-thread block a
// SM, (step, tile) pairs walked in flattened order); other K and fp32 run
// ring_kernel on dist_tile.cuh's mma.sync / CUDA-core tiles, each step's
// tiles round robin over the compute blocks.  The protocol is the same
// code for both.
//
// What bounds it on one H100: the same 2 M N K operations as one GEMM plus
// the algorithm's (n - 1) copies of |B| (each read and written once), so
// at bf16 8192^3 over 4 ranks the tensor-core rate, 1.11 ms at 989
// TFLOP/s, against 0.40 ms for the bytes (fp32 C).  On one card a ring can
// never beat one GEMM: it does the same operations and moves more, and 2
// of the 33 blocks a rank forward instead of multiplying.  Measured there
// (H100 80GB HBM3, 700 W; chip_smoke.py phase 24): 1.9-2.1 ms over 4
// ranks against bf16 torch.matmul's 1.4-1.6 ms; the engine's blocks run
// at ~5.5 TFLOP/s a SM, the staging takes ~0.13 ms, and a sender block
// forwards 20-45 GB/s beside the busy card, so at 8 ranks (2.6-2.9 ms)
// the forwards, not the tiles, set the pace.
#include "wgmma_tile.cuh"

namespace gemm_hls {

// n <= 64: the rank table stays inside the 4 KB of launch parameters.
constexpr int kMaxRanks = 64;
constexpr int kAck = 0, kRecv = 8;  // flags: ack, then recv[n], done[n]
constexpr int kMapsPerRank = 4;     // A, A, comm[0], comm[1] (wgmma route)

struct RingRank {
  const void* a;  // (ml, K)
  const void* b;  // (K, nl)
  void* c;        // (ml, n * nl)
  void* comm[2];  // (nl, K) each: B^T blocks in flight
  int* flags;     // ack, recv[0..n), done[0..n) from kRecv on
};

struct RingArgs {
  RingRank r[kMaxRanks];
  const CUtensorMap* maps;  // kMapsPerRank a rank (wgmma route)
  long long* stamps;        // stamp_words(n) a rank, or null
  int n, ml, nl, K;
  int n_send, n_comp;
  int out_code, vec_a, vec_b;
  long long spin;  // wait budget in cycles (rank_sync.cuh)
};

// Every block of the rank (NT threads): its share of B_r transposed into
// comm[0], counted on recv[0] (target: all bpr blocks of the rank).
template <typename T, int NT, int V>
__device__ void ring_stage(const RingArgs& g, const RingRank& R, int lb, int bpr,
                           unsigned char* tile) {
  using B = Bits<T>;
  stage_rows<B, NT, V>(static_cast<B*>(R.comm[0]), static_cast<const B*>(R.b), g.K, g.nl, lb,
                       bpr, reinterpret_cast<B*>(tile));
  signal_flag(R.flags + kRecv, 1);
}

// A sender block: thread 0 alone forwards this block's share of each
// step's block and runs the flags; the others are done.
template <typename T>
__device__ void ring_send(const RingArgs& g, int me, int lb, int bpr, BulkRing ring) {
  if (threadIdx.x != 0) return;
  const int n = g.n;
  const RingRank& R = g.r[me];
  const RingRank& right = g.r[(me + 1) % n];
  const RingRank& left = g.r[(me + n - 1) % n];
  int* recv = R.flags + kRecv;
  int* done = recv + n;
  long long* st = g.stamps ? g.stamps + static_cast<int64_t>(me) * stamp_words(n) : nullptr;
  const int64_t bytes = static_cast<int64_t>(g.nl) * g.K * sizeof(T);
  const int64_t lo = split_at(bytes, g.n_send, lb, kSendAlign);
  const int64_t hi = split_at(bytes, g.n_send, lb + 1, kSendAlign);
  for (int s = 0; s + 1 < n; ++s) {
    const int cur = s & 1;
    // The right neighbour freed comm[cur ^ 1]; step s's block is whole here.
    if (s >= 1) wait_flag_thread(R.flags + kAck, s, g.spin);
    wait_flag_thread(&recv[s], s == 0 ? bpr : g.n_send, g.spin);
    fence_proxy_async_global();
    ring.copy(right.comm[cur ^ 1], R.comm[cur], lo, hi, g.spin);
    release_add(right.flags + kRecv + s + 1, 1);
    if (st && lb == 0) st[kStampHead + 2 * n + s] = global_ns();
    release_add(&done[s], 1);
    if (lb == 0 && s <= n - 3) {
      wait_flag_thread(&done[s], bpr, g.spin);
      release_add(left.flags + kAck, 1);
    }
  }
}

// The mma.sync / CUDA-core route (fp32, or K bytes not a multiple of 16).
template <typename T>
__global__ void __launch_bounds__(Route<T>::NT, Route<T>::MINB)
    ring_kernel(const __grid_constant__ RingArgs g) {
  __shared__ __align__(128) unsigned char smem[kTileSmem];
  __shared__ uint64_t send_bars[3];
  const int n = g.n, bpr = g.n_send + g.n_comp;
  const int me = blockIdx.x / bpr, lb = blockIdx.x % bpr;
  const RingRank& R = g.r[me];
  int* recv = R.flags + kRecv;
  int* done = recv + n;
  long long* st = g.stamps ? g.stamps + static_cast<int64_t>(me) * stamp_words(n) : nullptr;
  const bool stamper = st && lb == g.n_send && threadIdx.x == 0;
  if (stamper) st[0] = global_ns();

  constexpr int NT = Route<T>::NT, V = 1024 / NT;  // a 16 KB staging tile
  static_assert(stage_tile_bytes<NT, V>() <= kTileSmem, "staging tile");
  ring_stage<T, NT, V>(g, R, lb, bpr, smem);
  if (lb < g.n_send) {
    fence_proxy_async_shared();  // the transpose's tile, before bulk loads into it
    BulkRing ring{smem, send_bars, 3, kTileSmem / 3 / 16 * 16, 0};
    if (threadIdx.x == 0) ring.init();
    __syncthreads();
    ring_send<T>(g, me, lb, bpr, ring);
    return;
  }

  using R_ = Route<T>;
  const int tiles_m = (g.ml + R_::BM - 1) / R_::BM, tiles_n = (g.nl + R_::BN - 1) / R_::BN;
  for (int s = 0; s < n; ++s) {
    const long long t0 = stamper ? global_ns() : 0;
    wait_flag(&recv[s], s == 0 ? bpr : g.n_send, g.spin);
    if (stamper) {
      const long long now = global_ns();
      if (s == 0) st[1] = now;
      stamp_max(st + 2, now - t0);
      st[kStampHead + s] = now;
    }
    const int src = (me - s + n) % n;
    const TileOut o{nullptr, 0, R.c, static_cast<int64_t>(src) * g.nl,
                    static_cast<int64_t>(n) * g.nl, g.out_code, 0};
    for (int t = lb - g.n_send; t < tiles_m * tiles_n; t += g.n_comp) {
      int m0, n0;
      tile_origin(t, tiles_m, tiles_n, R_::BM, R_::BN, m0, n0);
      gemm_tile<T>(smem, R.a, g.K, g.vec_a, R.comm[s & 1], g.K, g.vec_b, g.ml, g.nl, g.K, m0,
                   n0, o);
    }
    signal_flag(&done[s], 1);
    if (stamper) st[kStampHead + n + s] = global_ns();
  }
}

// The Hopper tile engine's route (bf16, int8; K bytes a multiple of 16).
template <typename T>
__global__ void __launch_bounds__(kWgThreads, 1) ring_wg_kernel(const __grid_constant__ RingArgs g) {
  extern __shared__ unsigned char dyn_smem[];
  unsigned char* smem = wg_align(dyn_smem);
  WgBars* bars = reinterpret_cast<WgBars*>(smem + kWgStages * kWgStage);
  const int n = g.n, bpr = g.n_send + g.n_comp;
  const int me = blockIdx.x / bpr, lb = blockIdx.x % bpr;
  const RingRank& R = g.r[me];
  long long* st = g.stamps ? g.stamps + static_cast<int64_t>(me) * stamp_words(n) : nullptr;
  if (st && lb == g.n_send && threadIdx.x == 0) st[0] = global_ns();

  ring_stage<T, kWgThreads, kWgStageV>(g, R, lb, bpr, smem);
  fence_proxy_async_shared();  // the transpose's tile, before TMA / bulk writes into it
  if (threadIdx.x == 0) wg_init_bars(bars);
  __syncthreads();
  if (lb < g.n_send) {
    ring_send<T>(g, me, lb, bpr, BulkRing{smem, bars->send, kWgSendSlots, kWgSendChunk, 0});
    return;
  }
  const CUtensorMap* maps = g.maps + static_cast<int64_t>(me) * kMapsPerRank;
  int* recv = R.flags + kRecv;
  const WgJob job{{maps, maps + 1}, {maps + 2, maps + 3}, {recv, recv}, bpr, g.n_send,
                  recv + n, nullptr, st, g.spin, g.ml, g.nl, g.K, n, g.n_comp, lb - g.n_send};
  wg_compute<T>(job, smem, bars, [&](int s) {
    return TileOut{nullptr, 0, R.c, static_cast<int64_t>((me - s + n) % n) * g.nl,
                   static_cast<int64_t>(n) * g.nl, g.out_code, 0};
  });
}

}  // namespace gemm_hls

using namespace gemm_hls;

// ranks: n rows of (a, b, c, comm0, comm1, flags) device pointers, rank
// order (the ring), any placement.  dims: n, ml, nl, K, in_code, out_code,
// vec_a, vec_b, max_per_rank, spin budget in ms, route (1: the wgmma
// engine, 0: mma.sync / CUDA cores), sender blocks a rank (-1: the
// kernel's default).  maps: device buffer of n * 4 tensor maps (wgmma
// route).  stamps: n * stamp_words(n) zeroed int64, or null.  split_out
// (host, may be null) receives the blocks per rank (senders, compute).
// The flags must be zero.  Returns 0, a CUDA error (a refused cooperative
// launch included), -1 for a type, route or rank count no kernel takes,
// or -2 for a tensor map cuTensorMapEncodeTiled refused.
extern "C" int ring_gemm(const int64_t* ranks, const int* dims, int* split_out, void* maps,
                         void* stamps, void* stream) {
  RingArgs g{};
  g.n = dims[0];
  if (g.n < 1 || g.n > kMaxRanks) return kUnsupported;
  g.ml = dims[1];
  g.nl = dims[2];
  g.K = dims[3];
  g.out_code = dims[5];
  g.vec_a = dims[6];
  g.vec_b = dims[7];
  g.spin = spin_cycles(dims[9]);
  const bool wg = dims[10] == 1;
  g.maps = static_cast<const CUtensorMap*>(maps);
  g.stamps = static_cast<long long*>(stamps);
  for (int i = 0; i < g.n; ++i) {
    const int64_t* p = ranks + 6 * i;
    g.r[i] = RingRank{reinterpret_cast<const void*>(p[0]), reinterpret_cast<const void*>(p[1]),
                      reinterpret_cast<void*>(p[2]),
                      {reinterpret_cast<void*>(p[3]), reinterpret_cast<void*>(p[4])},
                      reinterpret_cast<int*>(p[5])};
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int max_per_rank = dims[8], n_send = dims[11];
  if (wg) {
    const int esize = dims[4] == kBF16 ? 2 : dims[4] == kI8 ? 1 : 0;
    if (!esize || (static_cast<int64_t>(g.K) * esize) % 16) return kUnsupported;
    std::vector<CUtensorMap> host(static_cast<size_t>(g.n) * kMapsPerRank);
    for (int i = 0; i < g.n; ++i) {
      CUtensorMap* m = &host[static_cast<size_t>(i) * kMapsPerRank];
      if (!encode_kmajor(m, g.r[i].a, g.ml, g.K, esize, kWgBM) ||
          !encode_kmajor(m + 1, g.r[i].a, g.ml, g.K, esize, kWgBM) ||
          !encode_kmajor(m + 2, g.r[i].comm[0], g.nl, g.K, esize, kWgBN) ||
          !encode_kmajor(m + 3, g.r[i].comm[1], g.nl, g.K, esize, kWgBN))
        return kTmaEncodeFailed;
    }
    const int err = upload_maps(maps, host, st);
    if (err) return err;
    const int tiles = (g.ml + kWgBM - 1) / kWgBM * ((g.nl + kWgBN - 1) / kWgBN);
    if (esize == 2)
      return launch_ranks(ring_wg_kernel<__nv_bfloat16>, g, g.n, kWgThreads, kWgSmem, tiles,
                          max_per_rank, n_send, st, split_out);
    return launch_ranks(ring_wg_kernel<signed char>, g, g.n, kWgThreads, kWgSmem, tiles,
                        max_per_rank, n_send, st, split_out);
  }
  auto launch = [&](auto kern, auto route) {
    using R = decltype(route);
    const int tiles = (g.ml + R::BM - 1) / R::BM * ((g.nl + R::BN - 1) / R::BN);
    return launch_ranks(kern, g, g.n, R::NT, 0, tiles, max_per_rank, n_send, st, split_out);
  };
  switch (dims[4]) {
    case kBF16: return launch(ring_kernel<__nv_bfloat16>, Route<__nv_bfloat16>{});
    case kI8: return launch(ring_kernel<signed char>, Route<signed char>{});
    case kF32: return launch(ring_kernel<float>, Route<float>{});
    default:
      return kUnsupported;
  }
}
