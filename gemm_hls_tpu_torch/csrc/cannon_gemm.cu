// Kernel cannon_gemm: 2-D Cannon on a p x p grid with the skew and the
// torus shifts fused into the GEMM.  Rank d = i p + j holds the blocks
// A_ij (M/p, K/p) and B_ij (K/p, N/p) and ends with C_ij = sum_l A_il B_lj.
//
// Replaces gemm_hls_tpu/ops/pallas_cannon.py::_cannon_kernel (B19).  All
// p^2 ranks run in one cooperative launch, n_send + n_comp blocks each, the
// rank table (A, B, C, the fp32 / int32 sum, two ring buffers per operand,
// flags) in the launch parameters.  The protocol is pallas_cannon.py's:
//   * skew: one arbitrary-destination copy per operand, A_ij to rank (i,
//     j - i)'s comm_a[0] and B_ij, transposed to (N/p, K/p), to rank (i - j,
//     j)'s comm_b[0], each counted on the destination's recv_a[0] /
//     recv_b[0];
//   * p steps: the compute blocks wait for recv_a[s] and recv_b[s], add
//     comm_a[s % 2] . comm_b[s % 2] into the rank's sum (C itself at the
//     last step, cast there) and count done[s]; the sender blocks shift
//     both blocks, A to the left neighbour's and B to the upper one's
//     buffer (s + 1) % 2, after their acks from step 1 on;
//   * after step s <= p - 3, sender block 0 waits until every block of the
//     rank is done with step s and acks the right neighbour (A's source)
//     and the lower one (B's source).
// Counters per step, as in csrc/ring_gemm.cu, and the same flag protocol
// (rank_sync.cuh).  A tile belongs to the same block at every step, so the
// running sum is read back by the thread that wrote it.
//
// What bounds it on one H100: 2 M N K operations, the skew (|A| + |B|
// read and written) and (p - 1) shifts of |A| / p and |B| / p per grid row
// and column; at bf16 8192^3 and p = 2 the tensor-core rate, 1.11 ms,
// against 0.48 ms of bytes (fp32 C).  On one card it cannot beat one GEMM.  Left on
// the table: wgmma and TMA, keeping the sum in registers when a block
// owns one tile.
#include "dist_tile.cuh"

namespace gemm_hls {

// p <= 4: the rank table stays inside the 4 KB of launch parameters.
constexpr int kMaxRanks = 16;
constexpr int kAckA = 0, kAckB = 1, kRecv = 8;  // then recv_a[p], recv_b[p], done[p]

struct CannonRank {
  const void* a;    // (ml, kl)
  const void* b;    // (kl, nl)
  void* c;          // (ml, nl), out_code
  void* sum;        // (ml, nl), fp32 (int32 for int8)
  void* ca[2];      // (ml, kl) each
  void* cb[2];      // (nl, kl) each: B^T
  int* flags;
};

struct CannonArgs {
  CannonRank r[kMaxRanks];
  int p, ml, nl, kl;
  int n_send, n_comp;
  int out_code, sum_code, vec_a, vec_b;
  long long spin;  // wait budget in cycles (rank_sync.cuh)
};

template <typename T>
__global__ void __launch_bounds__(Route<T>::NT, Route<T>::MINB)
    cannon_kernel(const __grid_constant__ CannonArgs g) {
  __shared__ __align__(128) unsigned char smem[kTileSmem];
  const int p = g.p, bpr = g.n_send + g.n_comp;
  const int me = blockIdx.x / bpr, lb = blockIdx.x % bpr;
  const int i = me / p, j = me % p;
  const CannonRank& R = g.r[me];
  int* recv_a = R.flags + kRecv;
  int* recv_b = recv_a + p;
  int* done = recv_b + p;

  if (lb < g.n_send) {
    const int64_t a_bytes = static_cast<int64_t>(g.ml) * g.kl * sizeof(T);
    const int64_t b_bytes = static_cast<int64_t>(g.nl) * g.kl * sizeof(T);
    const int64_t a_lo = split_at(a_bytes, g.n_send, lb, 16);
    const int64_t a_hi = split_at(a_bytes, g.n_send, lb + 1, 16);
    const int64_t b_lo = split_at(b_bytes, g.n_send, lb, 16);
    const int64_t b_hi = split_at(b_bytes, g.n_send, lb + 1, 16);
    // Skew.
    const CannonRank& to_a = g.r[i * p + (j - i + p) % p];
    const CannonRank& to_b = g.r[(i - j + p) % p * p + j];
    copy_cg(to_a.ca[0], R.a, a_lo, a_hi);
    signal_flag(to_a.flags + kRecv, 1);
    using B = Bits<T>;
    transpose_rows<B>(static_cast<B*>(to_b.cb[0]), static_cast<const B*>(R.b), g.kl, g.nl,
                      static_cast<int>(split_at(g.nl, g.n_send, lb, 1)),
                      static_cast<int>(split_at(g.nl, g.n_send, lb + 1, 1)),
                      reinterpret_cast<B*>(smem));
    signal_flag(to_b.flags + kRecv + p, 1);
    // Shifts: A left, B up; acks go right (A's source) and down (B's).
    const CannonRank& left = g.r[i * p + (j + p - 1) % p];
    const CannonRank& up = g.r[(i + p - 1) % p * p + j];
    const CannonRank& right = g.r[i * p + (j + 1) % p];
    const CannonRank& down = g.r[(i + 1) % p * p + j];
    for (int s = 0; s + 1 < p; ++s) {
      const int cur = s & 1;
      if (s >= 1) {
        wait_flag(R.flags + kAckA, s, g.spin);
        wait_flag(R.flags + kAckB, s, g.spin);
      }
      wait_flag(&recv_a[s], g.n_send, g.spin);
      wait_flag(&recv_b[s], g.n_send, g.spin);
      copy_cg(left.ca[cur ^ 1], R.ca[cur], a_lo, a_hi);
      signal_flag(left.flags + kRecv + s + 1, 1);
      copy_cg(up.cb[cur ^ 1], R.cb[cur], b_lo, b_hi);
      signal_flag(up.flags + kRecv + p + s + 1, 1);
      signal_flag(&done[s], 1);
      if (lb == 0 && s <= p - 3) {
        wait_flag(&done[s], bpr, g.spin);
        signal_flag(right.flags + kAckA, 1);
        signal_flag(down.flags + kAckB, 1);
      }
    }
    return;
  }

  using R_ = Route<T>;
  const int tiles_m = (g.ml + R_::BM - 1) / R_::BM, tiles_n = (g.nl + R_::BN - 1) / R_::BN;
  for (int s = 0; s < p; ++s) {
    wait_flag(&recv_a[s], g.n_send, g.spin);
    wait_flag(&recv_b[s], g.n_send, g.spin);
    const bool last = s + 1 == p;
    const TileOut o{s > 0 ? R.sum : nullptr, g.nl, last ? R.c : R.sum, 0, g.nl,
                    last ? g.out_code : g.sum_code};
    for (int t = lb - g.n_send; t < tiles_m * tiles_n; t += g.n_comp) {
      int m0, n0;
      tile_origin(t, tiles_m, tiles_n, R_::BM, R_::BN, m0, n0);
      gemm_tile<T>(smem, R.ca[s & 1], g.kl, g.vec_a, R.cb[s & 1], g.kl, g.vec_b, g.ml, g.nl,
                   g.kl, m0, n0, o);
    }
    signal_flag(&done[s], 1);
  }
}

}  // namespace gemm_hls

using namespace gemm_hls;

// ranks: p^2 rows of (a, b, c, sum, ca0, ca1, cb0, cb1, flags) device
// pointers, flat grid order i p + j.  dims: p, ml, nl, kl, in_code,
// out_code, vec_a, vec_b, max_per_rank, spin budget in ms.  split_out (host, may be null)
// receives the blocks per rank.  The flags must be zero.  Returns 0, a
// CUDA error, or -1 for a type or grid no kernel takes.
extern "C" int cannon_gemm(const int64_t* ranks, const int* dims, int* split_out, void* stream) {
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
  const int ranks_n = g.p * g.p;
  for (int d = 0; d < ranks_n; ++d) {
    const int64_t* q = ranks + 9 * d;
    auto ptr = [&](int k) { return reinterpret_cast<void*>(q[k]); };
    g.r[d] = CannonRank{ptr(0), ptr(1), ptr(2), ptr(3), {ptr(4), ptr(5)}, {ptr(6), ptr(7)},
                        static_cast<int*>(ptr(8))};
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int max_per_rank = dims[8];
  auto launch = [&](auto kern, auto route, int sum_code) {
    using R = decltype(route);
    g.sum_code = sum_code;
    const int tiles = (g.ml + R::BM - 1) / R::BM * ((g.nl + R::BN - 1) / R::BN);
    return launch_ranks(kern, g, ranks_n, R::NT, tiles, max_per_rank, st, split_out);
  };
  switch (dims[4]) {
    case kBF16: return launch(cannon_kernel<__nv_bfloat16>, Route<__nv_bfloat16>{}, kF32);
    case kI8: return launch(cannon_kernel<signed char>, Route<signed char>{}, kI32);
    case kF32: return launch(cannon_kernel<float>, Route<float>{}, kF32);
    default:
      return kUnsupported;
  }
}
