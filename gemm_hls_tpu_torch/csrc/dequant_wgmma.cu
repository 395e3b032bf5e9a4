// Kernel dequant_wg_kernel: y[M, N] = x[M, K] . dequant(w_q, s) on the
// Hopper tile engine -- B13, gemm_hls_tpu/ops/pallas_dequant.py::
// _dequant_kernel, for bf16 / fp16 x (ops/dequant.py::dequant_route; the
// rest stays on csrc/dequant_gemm.cu).
//
// Weights: int8 (K, N), or planar int4 (K/2, N): byte row i of a K-group of
// g rows holds row i in its low nibble and row i + g/2 in its high nibble,
// both sign-extended.  Group-wise scales are folded into the weights as
// they are expanded, w = (q * s) rounded once to the compute type (the
// plain version's and csrc/dequant_gemm.cu's arithmetic); a per-channel
// scale multiplies the fp32 sum at the store.
//
// What bounds it on an H100: the weight bytes.  At the serving decode's q
// projection (64 x 2048 -> 2048, int4 g128) 2 MB of packed weights, 128 KB
// of scales and 256 KB each of x and y: 0.8 us at 3.35 TB/s, well under
// one launch.  So the design is about reaching every SM's share of those
// bytes in one launch, with no device-memory workspace:
//   * a block owns a (64-row, BN-column) tile of y and a range of 128-deep
//     K steps.  One thread of a producer warp keeps a 3-stage mbarrier ring
//     full by TMA: per step, two 64-column boxes of x (K-major, 128-byte
//     swizzled: wgmma's A), one box of the packed weights as raw bytes (128
//     int8 or 64 int4 rows by BN columns, unswizzled) and, for group-wise
//     scales, the step's rows of scales (BN columns), so no thread waits
//     on a global load;
//   * BN / 32 consumer warpgroups expand each step's bytes together, one unit of 8 rows x 4 columns a thread, and
//     write them into a K-major, 128-byte-swizzled B tile (8 K values of one
//     column per 16-byte store, the 4 columns of a thread rotated so a
//     quarter warp's stores meet 8 different swizzle positions), fence them
//     for the async proxy (fence.proxy.async.shared::cta), and each runs
//     eight wgmma m64n32k16 over the step on its 32 columns, fp32 sums in
//     registers; step t + 1 is expanded into the other of two B tiles while
//     step t's products run.  The expansion is the kernel's work: a value
//     is one byte permute into a float's pattern, a subtraction, the scale's
//     multiply and half a pack, and a unit's offsets are the same every step.
//     With one warpgroup a SM it waited on its own latencies (~2.9 us a
//     128-column step), so the warps that expand are as many as the tile's
//     columns allow;
//   * K is split over the blocks of a thread block cluster (up to 8, a
//     portable cluster, along grid z): rank r owns a share of the tile's
//     values, and every rank writes its fp32 partial of that share into
//     rank r's shared memory (distributed shared memory, stores only); after
//     one cluster barrier each rank sums its share in rank order from its
//     own memory and stores it.  One launch, no atomics, one fixed order:
//     the same bits every run.
// The N tile and the split come from the shape and from how many clusters
// the card holds at once (dequant_engine_plan; an H100 holds 15 of 8 and
// 17 of 6 at one block a SM): at the q projection 16 tiles of 128 columns
// x 6 ranks, 96 blocks of up to three steps; at the k / v one (N 512) 16
// tiles of 32 x 6.  Narrow N tiles over the whole K (no sum across blocks,
// every block reading all of x) measured slower at both (PERF.md, section
// 6), so no such plan is built.
//
// K order inside a step.  A step is 128 K values: 128 int8 rows, or 64
// packed int4 rows.  For int4 groups of at most 128 rows the step holds
// whole groups, so its x columns are 128 contiguous ones and the nibbles
// land at their own K; for larger groups (per-channel: g = K) the step's 64
// packed rows sit in one group's first half, their high nibbles in its
// second half: x columns [p, p + 64) and [p + g/2, p + g/2 + 64), the B
// tile's first and second slab.  Rows past K and columns past N are
// zero-filled by TMA (their q and scales are 0).
#include <cooperative_groups.h>

#include "wgmma_tile.cuh"

namespace gemm_hls {

namespace cgrp = cooperative_groups;

constexpr int kDqBM = 64;        // rows of x a tile: one wgmma M
constexpr int kDqStep = 128;     // K values a step
constexpr int kDqStages = 3;

// An N tile of BN columns: BN / 32 consumer warpgroups of kDqNS columns
// each (kDqE fp32 sums a thread), then the producer warp.
constexpr int kDqNS = 32, kDqE = kDqNS / 2;
template <int BN> struct DqTile {
  static constexpr int kConsumers = 4 * BN, kThreads = kConsumers + 32;
};
constexpr int kDqBox = kDqBM * kWgRowBytes;           // one 64-column box of x: 8 KB
constexpr int kDqRawMax = 128 * 128;                  // the packed box: at most 128 rows x 128 bytes
constexpr int kDqScaleMax = 8 * 128 * 4;              // the scales: at most 8 groups x 128 columns
constexpr int kDqStage = 2 * kDqBox + kDqRawMax + kDqScaleMax;  // 36 KB
constexpr int kDqBTile = 2 * 128 * kWgRowBytes;       // the expanded B: 2 K slabs x at most 128 rows
constexpr int kDqMaxSplits = 8;
// The partials a rank receives: its share of a consumer's 16 values (at
// most ceil(16 / splits)) from each of the splits ranks, for 512 consumers.
constexpr int kDqPartials = 48 * 1024;
struct DqBars {
  uint64_t full[kDqStages], empty[kDqStages];
};
constexpr int kDqSmem = 1024 + kDqStages * kDqStage + 2 * kDqBTile + kDqPartials +
                        static_cast<int>(sizeof(DqBars));

struct DqArgs {
  CUtensorMap x;   // (M, K) in the compute type: boxes of 64 K by 64 rows
  CUtensorMap w;   // packed weights (rows, N) as bytes: boxes of BN by a step's rows
  CUtensorMap sc;  // group-wise scales (n_groups, N): boxes of BN by a step's groups
  const float* s;  // (n_groups, N)
  void* out;       // (M, N), out_code
  int M, N, K, bits, group, n_groups, splits, steps, out_code;
  int step_groups;  // rows of the scale box: the groups a step spans (1 per-channel)
  long long spin;
};

// ---- wgmma m64n32k16, both operands K-major in shared memory ---------------

#define DQ_R8(o) \
    "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), \
    "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define DQ_MMA(TY) \
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n" \
               "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {%0, %1, %2, %3, %4, " \
               "%5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}" \
               : DQ_R8(0), DQ_R8(8) : "l"(da), "l"(db), "r"(scale_d))

template <typename T>
__device__ __forceinline__ void dq_mma(float (&d)[kDqE], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) DQ_MMA("f16");
  else DQ_MMA("bf16");
}
#undef DQ_R8
#undef DQ_MMA

// ---- the step ----------------------------------------------------------------

// The x columns of step s's two 64-column boxes.
__device__ __forceinline__ void dq_x_cols(const DqArgs& a, int s, int& ka, int& kb) {
  if (a.bits == 4 && a.group > kDqStep) {
    const int h = a.group / 2, p = 64 * s;  // the step's first packed row
    ka = p / h * a.group + p % h;
    kb = ka + h;
  } else {
    ka = kDqStep * s;
    kb = ka + 64;
  }
}

// One consumer thread's unit of every step: 8 packed rows x 4 columns of
// the step's box (8 32-bit words), their 32 values of int8 or their low or
// high nibbles of int4, into 4 16-byte chunks of the B tile (8 K values of
// one column each).  4 BN units a step, one a consumer.  Its offsets are the
// same every step.
struct DqUnit {
  int raw;          // byte offset of its first word in the packed box
  int scale[4];     // float offset of each column's scale in the scale box
  int chunk[4];     // byte offset of each column's chunk in the B tile
  uint32_t sel[4];  // byte permutes: the column's byte into a float's pattern
  uint32_t shift;   // int4: 0 (low nibbles) or 4 (high)
};

template <int BN>
__device__ __forceinline__ DqUnit dq_unit(const DqArgs& a, int tid) {
  constexpr int kCols = BN / 4;  // 4-column groups of the tile
  DqUnit u{};
  const int cg = tid % kCols, rest = tid / kCols, nl = 4 * cg;
  const bool int4 = a.bits == 4, small = a.group <= kDqStep, high = int4 && rest >= 8;
  const int p = 8 * (int4 ? rest % 8 : rest), h = a.group / 2;  // the unit's first packed row
  // The K position of the unit's 8 values in the step (int4: the high
  // nibbles' sit h, or 64, further) and their scale group's row in the
  // step's scale box.
  int j, sg;
  if (int4) {
    j = (small ? p / h * a.group + p % h : p) + (high ? (small ? h : 64) : 0);
    sg = small ? p / h : 0;
  } else {
    j = p;
    sg = small ? p / a.group : 0;
  }
  u.raw = p * BN + nl;
  u.shift = high ? 4 : 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int cc = (c + (cg >> 1)) & 3, row = nl + cc, chunk = (j % 64) / 8;
    u.scale[c] = sg * BN + row;
    u.chunk[c] = (j / 64) * BN * kWgRowBytes + row * kWgRowBytes + ((chunk ^ (row & 7)) << 4);
    // Result bytes: byte cc of the word, 0x00, 0x00, 0x4B (0x4B0000bb: 2^23 + bb).
    u.sel[c] = 0x7440u + static_cast<uint32_t>(cc);
  }
  return u;
}

// Two floats as the packed pair of the compute type (lo at the lower address).
template <typename T> __device__ __forceinline__ uint32_t dq_pack(float lo, float hi);
template <> __device__ __forceinline__ uint32_t dq_pack<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t dq_pack<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The unit's values of one step: the packed box ``raw``, the step's scales
// ``sc`` (groups x BN floats), into the B tile ``bt``.  A value is q + bias
// placed in a float's low mantissa bits (2^23 + q + bias exactly), minus
// 2^23 + bias, times the scale (1 for per-channel scales: exact), rounded
// once to T.
template <typename T, int BN>
__device__ __forceinline__ void dq_expand(const DqArgs& a, const DqUnit& u, const unsigned char* raw,
                                          const float* sc, unsigned char* bt) {
  const bool int4 = a.bits == 4, fold = a.n_groups > 1;
  const uint32_t flip = int4 ? 0x88888888u : 0x80808080u;
  const uint32_t mask = int4 ? 0x0F0F0F0Fu : 0xFFFFFFFFu;
  const float bias = int4 ? 8388616.f : 8388736.f;
  uint32_t w[8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
    w[r] = ((*reinterpret_cast<const uint32_t*>(raw + u.raw + r * BN) ^ flip) >> u.shift) & mask;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float scale = fold ? sc[u.scale[c]] : 1.f;
    uint4 v;
    uint32_t* pk = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float lo = __fsub_rn(__uint_as_float(__byte_perm(w[2 * i], 0x4B000000u, u.sel[c])), bias);
      const float hi = __fsub_rn(__uint_as_float(__byte_perm(w[2 * i + 1], 0x4B000000u, u.sel[c])),
                                 bias);
      pk[i] = dq_pack<T>(__fmul_rn(lo, scale), __fmul_rn(hi, scale));
    }
    *reinterpret_cast<uint4*>(bt + u.chunk[c]) = v;
  }
}

// ---- the store ---------------------------------------------------------------

// Value e of the m64n32 fragment of consumer thread ``tid`` (warpgroup
// tid / 128, its columns from 32 (tid / 128)): row 16 w + l / 4 + 8 ((e %
// 4) / 2), column 8 (e / 4) + 2 (l % 4) + e % 2.
template <typename Out>
__device__ __forceinline__ void dq_put(const DqArgs& a, int m0, int n0, int tid, int e, float v) {
  const int lane = tid % 32;
  const int r = m0 + 16 * (tid % 128 / 32) + lane / 4 + 8 * ((e % 4) / 2);
  const int c = n0 + kDqNS * (tid / 128) + 8 * (e / 4) + 2 * (lane % 4) + e % 2;
  if (r >= a.M || c >= a.N) return;
  if (a.n_groups == 1) v = __fmul_rn(v, a.s[c]);
  static_cast<Out*>(a.out)[static_cast<int64_t>(r) * a.N + c] = cast_out<Out>(v);
}

// The consumer values [e0, e1) that rank r of ``splits`` owns.
__device__ __forceinline__ void dq_share(int ne, int r, int splits, int& e0, int& e1) {
  e0 = ne * r / splits;
  e1 = ne * (r + 1) / splits;
}

// Every rank's partial of rank o's share goes to rank o's ``part``: value e
// of consumer t from rank q at ((q * most + e - e0) * consumers + t), most
// the largest share, by distributed-shared-memory stores.
template <int BN>
__device__ __forceinline__ void dq_push(const DqArgs& a, const float (&acc)[kDqE], float* part,
                                        int rank, int tid) {
  using D = DqTile<BN>;
  constexpr int kE = kDqE;
  cgrp::cluster_group cluster = cgrp::this_cluster();
  const int most = (kE + a.splits - 1) / a.splits;
  int owner = 0, e0 = 0, e1 = 0;
  dq_share(kE, 0, a.splits, e0, e1);
  float* to = cluster.map_shared_rank(part, 0);
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    while (e >= e1) {
      dq_share(kE, ++owner, a.splits, e0, e1);
      to = cluster.map_shared_rank(part, owner);
    }
    to[(rank * most + e - e0) * D::kConsumers + tid] = acc[e];
  }
}

// Rank ``rank``'s share of the tile's values, each summed over the ranks'
// partials in rank order, stored.
template <typename Out, int BN>
__device__ void dq_reduce(const DqArgs& a, const float* part, int m0, int n0, int rank, int tid) {
  using D = DqTile<BN>;
  constexpr int kE = kDqE;
  const int most = (kE + a.splits - 1) / a.splits;
  int e0, e1;
  dq_share(kE, rank, a.splits, e0, e1);
  for (int e = e0; e < e1; ++e) {
    const float* at = part + (e - e0) * D::kConsumers + tid;
    float sum = at[0];
    for (int q = 1; q < a.splits; ++q) sum = __fadd_rn(sum, at[q * most * D::kConsumers]);
    dq_put<Out>(a, m0, n0, tid, e, sum);
  }
}

template <typename Out>
__device__ __forceinline__ void dq_store(const DqArgs& a, const float (&acc)[kDqE], int m0, int n0,
                                         int tid) {
#pragma unroll
  for (int e = 0; e < kDqE; ++e) dq_put<Out>(a, m0, n0, tid, e, acc[e]);
}

// ---- the kernel --------------------------------------------------------------

// The first scale group of step s (its scale box's first row).
__device__ __forceinline__ int dq_group0(const DqArgs& a, int s) { return kDqStep * s / a.group; }

template <typename T, int BN>
__global__ void __launch_bounds__(DqTile<BN>::kThreads, 1)
    dequant_wg_kernel(const __grid_constant__ DqArgs a) {
  using D = DqTile<BN>;
  extern __shared__ unsigned char dyn_smem[];
  unsigned char* smem = wg_align(dyn_smem);
  unsigned char* btiles = smem + kDqStages * kDqStage;
  float* part = reinterpret_cast<float*>(btiles + 2 * kDqBTile);
  DqBars* bars = reinterpret_cast<DqBars*>(btiles + 2 * kDqBTile + kDqPartials);
  const int rank = blockIdx.z, per = (a.steps + a.splits - 1) / a.splits;
  const int s0 = rank * per, s1 = min(a.steps, s0 + per);
  const int m0 = blockIdx.y * kDqBM, n0 = blockIdx.x * BN;
  const int raw_rows = a.bits == 4 ? 64 : kDqStep;
  const bool split = a.splits > 1;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kDqStages; ++i) {
      mbar_init(&bars->full[i], 1);
      mbar_init(&bars->empty[i], D::kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();
  // Every rank of the cluster has started before any writes another's
  // shared memory (the wait, before the partials go out).
  if (split) cluster_arrive(false);
  const int tid = threadIdx.x;
  if (tid >= D::kConsumers) {
    if (tid == D::kConsumers)
      for (int s = s0; s < s1; ++s) {
        const int t = s - s0, stage = t % kDqStages;
        mbar_wait(&bars->empty[stage], ((t / kDqStages) & 1) ^ 1, a.spin);
        unsigned char* st = smem + stage * kDqStage;
        const bool fold = a.n_groups > 1;
        mbar_expect_tx(&bars->full[stage], 2 * kDqBox + raw_rows * BN +
                                               (fold ? a.step_groups * BN * 4 : 0));
        int ka, kb;
        dq_x_cols(a, s, ka, kb);
        tma_load_2d(st, &a.x, ka, m0, &bars->full[stage]);
        tma_load_2d(st + kDqBox, &a.x, kb, m0, &bars->full[stage]);
        tma_load_2d(st + 2 * kDqBox, &a.w, n0, s * raw_rows, &bars->full[stage]);
        if (fold)
          tma_load_2d(st + 2 * kDqBox + kDqRawMax, &a.sc, n0, dq_group0(a, s), &bars->full[stage]);
      }
    __syncwarp();
    if (split) {
      cluster_wait();
      cluster_arrive(true);
      cluster_wait();
    }
    return;
  }
  const DqUnit unit = dq_unit<BN>(a, tid);
  float acc[kDqE];
  int prev = 0;
  for (int s = s0; s < s1; ++s) {
    const int t = s - s0, stage = t % kDqStages;
    mbar_wait(&bars->full[stage], (t / kDqStages) & 1, a.spin);
    unsigned char* st = smem + stage * kDqStage;
    unsigned char* bt = btiles + (t & 1) * kDqBTile;
    // The B tile of step t - 2 was last read by its products, which every
    // warp saw retire before the barrier that ended step t - 1.
    dq_expand<T, BN>(a, unit, st + 2 * kDqBox,
                     reinterpret_cast<const float*>(st + 2 * kDqBox + kDqRawMax), bt);
    fence_proxy_async_shared();
    named_sync(1, D::kConsumers);
    // This warpgroup's 32 rows of each K slab of the B tile.
    const uint32_t sa = smem_u32(st), sb = smem_u32(bt) + tid / 128 * kDqNS * kWgRowBytes;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      dq_mma<T>(acc, wg_desc(sa + (kk / 4) * kDqBox) + 2 * (kk % 4),
                       wg_desc(sb + (kk / 4) * BN * kWgRowBytes) + 2 * (kk % 4), t > 0 || kk > 0);
    wg_commit();
    if (t > 0) {
      wg_wait<1>();  // step t - 1's products have retired: its stage is free
      mbar_arrive(&bars->empty[prev]);
      named_sync(2, D::kConsumers);
    }
    prev = stage;
  }
  wg_wait<0>();
  wg_pin(acc);
  if (split) {
    cluster_wait();  // every rank has started
    dq_push<BN>(a, acc, part, rank, tid);
    cluster_arrive(true);
    cluster_wait();  // every rank's partials of this rank's share have landed
    switch (a.out_code) {
      case kF32: dq_reduce<float, BN>(a, part, m0, n0, rank, tid); break;
      case kBF16: dq_reduce<__nv_bfloat16, BN>(a, part, m0, n0, rank, tid); break;
      case kF16: dq_reduce<__half, BN>(a, part, m0, n0, rank, tid); break;
    }
  } else {
    switch (a.out_code) {
      case kF32: dq_store<float>(a, acc, m0, n0, tid); break;
      case kBF16: dq_store<__nv_bfloat16>(a, acc, m0, n0, tid); break;
      case kF16: dq_store<__half>(a, acc, m0, n0, tid); break;
    }
  }
}

// The launch of grid (N tiles, row tiles, splits), each split a block of a
// (1, 1, splits) cluster: ``cfg`` with its cluster attribute in ``attr``.
template <int BN>
void dq_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int n, int tiles_m, int splits,
               cudaStream_t st) {
  cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((n + BN - 1) / BN), static_cast<unsigned>(tiles_m),
                     static_cast<unsigned>(splits));
  cfg.blockDim = dim3(DqTile<BN>::kThreads);
  cfg.dynamicSmemBytes = kDqSmem;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = static_cast<unsigned>(splits);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

template <typename T, int BN>
int dq_ready() {
  static const int attr = static_cast<int>(cudaFuncSetAttribute(
      dequant_wg_kernel<T, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem));
  return attr;
}

// A launch (``a`` given), or the number of its clusters the card holds at
// once (``clusters`` given: cudaOccupancyMaxActiveClusters).
template <typename T, int BN>
int dq_launch(const DqArgs* a, int n, int tiles_m, int splits, int* clusters, cudaStream_t st) {
  if (const int err = dq_ready<T, BN>()) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  dq_config<BN>(cfg, attr, n, tiles_m, splits, st);
  if (clusters)
    return static_cast<int>(cudaOccupancyMaxActiveClusters(
        clusters, reinterpret_cast<const void*>(dequant_wg_kernel<T, BN>), &cfg));
  const int err = static_cast<int>(cudaLaunchKernelEx(&cfg, dequant_wg_kernel<T, BN>, *a));
  return err ? err : last_error();
}

template <typename T>
int dq_launch_bn(const DqArgs* a, int bn, int n, int tiles_m, int splits, int* clusters,
                 cudaStream_t st) {
  switch (bn) {
    case 128: return dq_launch<T, 128>(a, n, tiles_m, splits, clusters, st);
    case 64: return dq_launch<T, 64>(a, n, tiles_m, splits, clusters, st);
    case 32: return dq_launch<T, 32>(a, n, tiles_m, splits, clusters, st);
  }
  return kUnsupported;
}

}  // namespace gemm_hls

using namespace gemm_hls;

// x (M, K) bf16 / fp16 (x_code), 16-byte base, K % 8 == 0; w_q (K, N) int8
// (bits 8) or (K/2, N) planar int4 (bits 4, packed per group of ``group``
// rows), 16-byte base, N % 16 == 0; s (n_groups, N) fp32 (n_groups 1:
// per-channel); out (M, N) fp32 / bf16 / fp16 (out_code).  ``group``
// divides the 128-deep step (and is at least 16) or is a multiple of it.
// bn: the N tile (32, 64, 128); splits: K split over a cluster of that many
// blocks (1-8), each a whole number of steps and none empty.  Returns 0, a
// CUDA error code, -1 for arguments no kernel is built for, or -2 for a
// tensor map cuTensorMapEncodeTiled refused.
extern "C" int dequant_wgmma(const void* x, const void* wq, const void* s, void* out,
                             int M, int N, int K, int bits, int group, int n_groups,
                             int bn, int splits, int x_code, int out_code, void* stream) {
  const bool tiles = (group >= 16 && kDqStep % group == 0) || group % kDqStep == 0;
  if ((bits != 8 && bits != 4) || !tiles || M < 1 || K < 1 || K % 8 || N < 16 || N % 16 ||
      n_groups != K / group || (out_code != kF32 && out_code != kBF16 && out_code != kF16))
    return kUnsupported;
  const int steps = (K + kDqStep - 1) / kDqStep;
  const int per = splits > 0 ? (steps + splits - 1) / splits : 0;
  if (splits < 1 || splits > kDqMaxSplits || (splits - 1) * per >= steps) return kUnsupported;
  const int64_t tiles_m = (M + kDqBM - 1) / kDqBM;
  if (tiles_m > 65535) return kUnsupported;
  DqArgs a{};
  const bool f16 = x_code == kF16;
  a.step_groups = group < kDqStep ? kDqStep / group : 1;
  if (!encode_kmajor(&a.x, x, M, K, 2, kDqBM, K, f16) ||
      !encode_rows(&a.w, wq, bits == 4 ? K / 2 : K, N, false, bn, bits == 4 ? 64 : kDqStep) ||
      (n_groups > 1 && !encode_rows(&a.sc, s, n_groups, N, true, bn, a.step_groups)))
    return kTmaEncodeFailed;
  a.s = static_cast<const float*>(s);
  a.out = out;
  a.M = M;
  a.N = N;
  a.K = K;
  a.bits = bits;
  a.group = group;
  a.n_groups = n_groups;
  a.splits = splits;
  a.steps = steps;
  a.out_code = out_code;
  a.spin = spin_cycles(10000);  // a stage wait is microseconds; 10 s means a lost load
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tm = static_cast<int>(tiles_m);
  switch (x_code) {
    case kBF16: return dq_launch_bn<__nv_bfloat16>(&a, bn, N, tm, splits, nullptr, st);
    case kF16: return dq_launch_bn<__half>(&a, bn, N, tm, splits, nullptr, st);
  }
  return kUnsupported;
}

// How many (1, 1, splits) clusters of the bf16 kernel with N tiles of ``bn``
// the current device holds at once, into ``clusters``.  Returns 0, a CUDA
// error code, or -1 for a plan no kernel is built for.
extern "C" int dequant_wgmma_clusters(int bn, int splits, int* clusters) {
  if (splits < 1 || splits > kDqMaxSplits) return kUnsupported;
  return dq_launch_bn<__nv_bfloat16>(nullptr, bn, bn, 1, splits, clusters, nullptr);
}
