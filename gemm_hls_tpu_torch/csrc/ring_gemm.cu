// Kernel ring_gemm: the 1-D ring GEMM with the transfer fused into the
// GEMM, C_r (M/n, N) = A_r (M/n, K) . [B_0 | ... | B_{n-1}], where rank r
// holds A's row block A_r and B's column block B_r (K, N/n).
//
// Replaces both bodies of gemm_hls_tpu/ops/pallas_ring.py (B18):
// _ring_kernel (operands held in VMEM) and _ring_kernel_tiled (K streamed
// in block_k chunks).  They differ only in where the TPU keeps the blocks
// (VMEM or HBM); here both are one kernel, whose tile streams K through
// shared memory in steps of its own (dist_tile.cuh), so block_k is only
// checked by the wrapper and every block_k gives the same bits.
//
// All n ranks run in one cooperative launch, n_send + n_comp blocks each
// (blockIdx gives the rank); the rank table in the launch parameters holds
// each rank's A, B, C, its two ring buffers and its flags, so ranks may sit
// anywhere in memory (the same table would hold peer pointers for ranks
// on other cards).  The protocol is pallas_ring.py's, step for step:
//   * the sender blocks (the TPU's DMA engine) stage B_r into comm[0]
//     transposed, (N/n, K), so every later copy is a flat one and the GEMM
//     reads B K-contiguous, and count recv[0];
//   * at step s they forward comm[s % 2] to the right neighbour's
//     comm[(s + 1) % 2] (16-byte vectors through the L2) and count its
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
// What bounds it on one H100: the same 2 M N K operations as one GEMM plus
// the algorithm's (n - 1) copies of |B| (each read and written once), so
// at bf16 8192^3 over 4 ranks the tensor-core rate, 1.11 ms at 989
// TFLOP/s, against 0.40 ms for the bytes (fp32 C).  On one card a ring can
// never beat one GEMM: it does the same operations and moves more.  Its point
// here is the protocol under real concurrency; its time is written down,
// not a target.  Left on the table: wgmma and TMA, sender blocks that turn
// to compute once their sends are done.
#include "dist_tile.cuh"

namespace gemm_hls {

// n <= 64: the rank table stays inside the 4 KB of launch parameters.
constexpr int kMaxRanks = 64;
constexpr int kAck = 0, kRecv = 8;  // flags: ack, then recv[n], done[n]

struct RingRank {
  const void* a;  // (ml, K)
  const void* b;  // (K, nl)
  void* c;        // (ml, n * nl)
  void* comm[2];  // (nl, K) each: B^T blocks in flight
  int* flags;     // ack, recv[0..n), done[0..n) from kRecv on
};

struct RingArgs {
  RingRank r[kMaxRanks];
  int n, ml, nl, K;
  int n_send, n_comp;
  int out_code, vec_a, vec_b;
  long long spin;  // wait budget in cycles (rank_sync.cuh)
};

template <typename T>
__global__ void __launch_bounds__(Route<T>::NT, Route<T>::MINB)
    ring_kernel(const __grid_constant__ RingArgs g) {
  __shared__ __align__(128) unsigned char smem[kTileSmem];
  const int n = g.n, bpr = g.n_send + g.n_comp;
  const int me = blockIdx.x / bpr, lb = blockIdx.x % bpr;
  const RingRank& R = g.r[me];
  int* recv = R.flags + kRecv;
  int* done = recv + n;

  if (lb < g.n_send) {
    const RingRank& right = g.r[(me + 1) % n];
    const RingRank& left = g.r[(me + n - 1) % n];
    using B = Bits<T>;
    transpose_rows<B>(static_cast<B*>(R.comm[0]), static_cast<const B*>(R.b), g.K, g.nl,
                      static_cast<int>(split_at(g.nl, g.n_send, lb, 1)),
                      static_cast<int>(split_at(g.nl, g.n_send, lb + 1, 1)),
                      reinterpret_cast<B*>(smem));
    signal_flag(&recv[0], 1);
    const int64_t bytes = static_cast<int64_t>(g.nl) * g.K * sizeof(T);
    const int64_t lo = split_at(bytes, g.n_send, lb, 16), hi = split_at(bytes, g.n_send, lb + 1, 16);
    for (int s = 0; s + 1 < n; ++s) {
      const int cur = s & 1;
      // The right neighbour freed comm[cur ^ 1]; step s's block is whole here.
      if (s >= 1) wait_flag(R.flags + kAck, s, g.spin);
      wait_flag(&recv[s], g.n_send, g.spin);
      copy_cg(right.comm[cur ^ 1], R.comm[cur], lo, hi);
      signal_flag(right.flags + kRecv + s + 1, 1);
      signal_flag(&done[s], 1);
      if (lb == 0 && s <= n - 3) {
        wait_flag(&done[s], bpr, g.spin);
        signal_flag(left.flags + kAck, 1);
      }
    }
    return;
  }

  using R_ = Route<T>;
  const int tiles_m = (g.ml + R_::BM - 1) / R_::BM, tiles_n = (g.nl + R_::BN - 1) / R_::BN;
  for (int s = 0; s < n; ++s) {
    wait_flag(&recv[s], g.n_send, g.spin);
    const int src = (me - s + n) % n;
    const TileOut o{nullptr, 0, R.c, static_cast<int64_t>(src) * g.nl,
                    static_cast<int64_t>(n) * g.nl, g.out_code};
    for (int t = lb - g.n_send; t < tiles_m * tiles_n; t += g.n_comp) {
      int m0, n0;
      tile_origin(t, tiles_m, tiles_n, R_::BM, R_::BN, m0, n0);
      gemm_tile<T>(smem, R.a, g.K, g.vec_a, R.comm[s & 1], g.K, g.vec_b, g.ml, g.nl, g.K, m0,
                   n0, o);
    }
    signal_flag(&done[s], 1);
  }
}

}  // namespace gemm_hls

using namespace gemm_hls;

// ranks: n rows of (a, b, c, comm0, comm1, flags) device pointers, rank
// order (the ring), any placement.  dims: n, ml, nl, K, in_code, out_code,
// vec_a, vec_b, max_per_rank, spin budget in ms.  split_out (host, may be null)
// receives the blocks per rank (senders, compute).  The flags must be
// zero.  Returns 0, a CUDA error (a refused cooperative launch included),
// or -1 for a type or rank count no kernel takes.
extern "C" int ring_gemm(const int64_t* ranks, const int* dims, int* split_out, void* stream) {
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
  for (int i = 0; i < g.n; ++i) {
    const int64_t* p = ranks + 6 * i;
    g.r[i] = RingRank{reinterpret_cast<const void*>(p[0]), reinterpret_cast<const void*>(p[1]),
                      reinterpret_cast<void*>(p[2]),
                      {reinterpret_cast<void*>(p[3]), reinterpret_cast<void*>(p[4])},
                      reinterpret_cast<int*>(p[5])};
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int max_per_rank = dims[8];
  auto launch = [&](auto kern, auto route) {
    using R = decltype(route);
    const int tiles = (g.ml + R::BM - 1) / R::BM * ((g.nl + R::BN - 1) / R::BN);
    return launch_ranks(kern, g, g.n, R::NT, tiles, max_per_rank, st, split_out);
  };
  switch (dims[4]) {
    case kBF16: return launch(ring_kernel<__nv_bfloat16>, Route<__nv_bfloat16>{});
    case kI8: return launch(ring_kernel<signed char>, Route<signed char>{});
    case kF32: return launch(ring_kernel<float>, Route<float>{});
    default:
      return kUnsupported;
  }
}
