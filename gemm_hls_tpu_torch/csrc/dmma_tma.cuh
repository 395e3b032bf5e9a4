// Kernels B1 and B2 for float64 on the FP64 tensor cores, the Hopper tile:
// TMA loads into a ring of shared-memory stages, one producer thread, two
// consumer warpgroups on mma.sync .f64, persistent blocks over the tiles in
// grouped order.  Its templates are in a header so a generated translation
// unit (gemm_hls_tpu_torch/ops/codegen.py: a Python callable's epilogue)
// instantiates the one layout its call takes with its own epilogue functor;
// csrc/dmma_tma.cu instantiates the built-in tiles.
//
// Replaces, as csrc/dmma_gemm.cu does, gemm_hls_tpu/ops/pallas_mxu.py's
// _kernel (:69, epilogue :103) and _batched_kernel (:143) for float64
// operands.  It takes the operands a TMA map describes (16-byte base, row
// pitch and batch stride: ``ops/mxu.py::mxu_route``'s ``aligned``);
// csrc/dmma_gemm.cu's cp.async tile keeps the rest.
//
// What bounds it on an H100: the FP64 tensor cores, 67e12 FLOP/s (8192^3:
// 16.4 ms).  A 128 x 128 tile of doubles is half of a SM's registers, so
// the tile cannot grow; what the design removes is everything else the
// cp.async tile spent issue slots and barriers on:
//   * one thread of warpgroup 0 (registers given back: setmaxnreg 40) issues
//     the TMA loads of each 16-deep K slice (A's and B's 16 KB) into a ring
//     of kDtStages stages, each with a full and an empty mbarrier; no
//     address math, no copies and no block barrier in the consumers;
//   * warpgroups 1 and 2 (setmaxnreg 232) own 64 rows each of the tile as
//     2 x 4 warps of 64 x 32, 64 doubles of accumulator a thread, and run
//     mma.sync m16n8k8 on the stages that have landed, each warp releasing a
//     stage once its MMAs have issued, its reads fenced against the next TMA
//     load;
//   * the blocks are persistent, one a SM, over the (example, tile) items,
//     the tiles of an example in groups of 8 tile rows (dist_tile.cuh's
//     tile_origin), so a wave shares A's and B's panels in the L2 and a
//     tile's store overlaps the producer's loads of the next one.
//
// Shared memory: TMA writes unpadded 128-byte rows with the 128-byte
// swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)).  A K-contiguous
// operand (A (M, K), B held (N, K)) is one box of 128 rows x 16 K; an
// MN-contiguous one (A held (K, M), the main path's B (K, N)) eight boxes
// of 16 K rows x 16 values.  The fragments are read conflict-free in both
// orientations by choosing which K, M and N a lane's fragment entries
// stand for (any permutation of K common to A and B, and of the tile's
// rows and columns undone at the store, leaves the product unchanged):
//   * K: the lane (g, t) = (lane / 4, lane % 4) takes K 8j + 2t + e for
//     its entry e of k4 pair j, so a K-contiguous row gives both of a
//     lane's entries in one 16-byte read (chunk t + 4j), and the four K
//     rows an MN-contiguous read touches (t = 0..3) lie in four different
//     swizzle pairs;
//   * rows of a K-contiguous operand: the fragment's row g is the tile row
//     (g >> 1) + 4 (g & 1) of its group of 8, so the two rows a quarter warp
//     reads lie in the two halves of the swizzle;
//   * an MN-contiguous operand keeps its order (its 16 values of a box row
//     span the swizzle already).
// The tile's edges: M, N and K past the operands are zero-filled by TMA (a
// box counts its bytes whole), so nothing past K reaches a sum
// (pallas_mxu.py::_mask_k_tail), and the store masks rows and columns past
// M / N.  Every built-in epilogue in double and every output type through
// dm_store (csrc/dmma_gemm.cuh), a generated functor through dm_store_ep.
// Each output's sum runs over K in one fixed order: the same bits every
// launch.
#pragma once

#include "dmma_gemm.cuh"
#include "wgmma_tile.cuh"

namespace gemm_hls {

constexpr int kDtBM = 128, kDtBN = 128, kDtBK = 16;
constexpr int kDtStages = 6, kDtThreads = 384;
constexpr int kDtOp = kDtBM * kDtBK * 8;  // 16 KB: one operand's slice
constexpr int kDtStage = 2 * kDtOp;

struct DtBars {
  uint64_t full[kDtStages], empty[kDtStages];
};
// 1024 bytes of slack align the stages to the swizzle's 1024-byte period.
constexpr int kDtSmem = 1024 + kDtStages * kDtStage + static_cast<int>(sizeof(DtBars));

// The launch's arguments: both operands' maps (2-D, or 3-D over the batch
// where the operand has a batch stride: batch_maps bit 0 for A, bit 1 for
// B), the problem (C, its output type and epilogue in g) and the items.
struct DtArgs {
  CUtensorMap ma, mb;
  Gemm g;
  int batch, batch_maps;
  long long spin;
};

// d += a . b for one m16n8k8 f64 product: a[2q + h] = A[g + 8h][t +
// 4q], b[q] = B[t + 4q][g]; d as for m16n8k4 (dmma_gemm.cuh::dmma).
__device__ __forceinline__ void dmma8(double (&d)[4], const double (&a)[4], const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// The tile row (or column) of fragment row g of a group of 8 in a
// K-contiguous operand.
__device__ __forceinline__ int dt_perm(int g) { return 2 * (g & 3) + (g >> 2); }
// The K (inside a 16-deep slice) of lane t's entries in k4 step q.
__device__ __forceinline__ int dt_k(int q, int t) {
  return 8 * (q >> 1) + 2 * t + ((q & 1) ^ (t & 1) ^ (t >> 1));
}

// The block's walk: the item count; item i's example z and tile origin.
struct DtWalk {
  int tiles_m, tn;
  int64_t items;
  __device__ __forceinline__ DtWalk(const DtArgs& p) {
    tiles_m = (p.g.M + kDtBM - 1) / kDtBM;
    tn = (p.g.N + kDtBN - 1) / kDtBN;
    items = static_cast<int64_t>(p.batch) * tiles_m * tn;
  }
  __device__ __forceinline__ void at(int64_t i, int& z, int& m0, int& n0) const {
    const int per = tiles_m * tn;
    z = static_cast<int>(i / per);
    tile_origin(static_cast<int>(i % per), tiles_m, tn, kDtBM, kDtBN, m0, n0);
  }
};

// The producer: one thread walking the block's items, one stage a K slice.
template <bool A_KC, bool B_KC>
__device__ void dt_produce(const DtArgs& p, unsigned char* smem, DtBars* bars, int ksteps) {
  const DtWalk w(p);
  const bool za = p.batch_maps & 1, zb = p.batch_maps & 2;
  int stage = 0;
  uint32_t phase = 0;
  for (int64_t i = blockIdx.x; i < w.items; i += gridDim.x) {
    int z, m0, n0;
    w.at(i, z, m0, n0);
    for (int kt = 0; kt < ksteps; ++kt) {
      mbar_wait(&bars->empty[stage], phase ^ 1, p.spin);
      uint64_t* full = &bars->full[stage];
      mbar_expect_tx(full, kDtStage);
      unsigned char* sa = smem + stage * kDtStage;
      unsigned char* sb = sa + kDtOp;
      const int k0 = kt * kDtBK;
      // A K-contiguous operand: one box (K, rows); an MN-contiguous one:
      // eight boxes (16 values, K rows).
      if (A_KC) {
        if (za) tma_load_3d(sa, &p.ma, k0, m0, z, full);
        else tma_load_2d(sa, &p.ma, k0, m0, full);
      } else {
#pragma unroll
        for (int b = 0; b < kDtBM / 16; ++b) {
          if (za) tma_load_3d(sa + b * 2048, &p.ma, m0 + 16 * b, k0, z, full);
          else tma_load_2d(sa + b * 2048, &p.ma, m0 + 16 * b, k0, full);
        }
      }
      if (B_KC) {
        if (zb) tma_load_3d(sb, &p.mb, k0, n0, z, full);
        else tma_load_2d(sb, &p.mb, k0, n0, full);
      } else {
#pragma unroll
        for (int b = 0; b < kDtBN / 16; ++b) {
          if (zb) tma_load_3d(sb + b * 2048, &p.mb, n0 + 16 * b, k0, z, full);
          else tma_load_2d(sb + b * 2048, &p.mb, n0 + 16 * b, k0, full);
        }
      }
      if (++stage == kDtStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// A lane's byte offsets of its fragment reads of k4 step q in a slice
// (relative to the operand's 16-row block or its 8-column block).
//   * K-contiguous (A or B): row r of the block at dt_perm(g) (+ 8 for A's
//     row g + 8), entry (r, dt_k(q, t)): one 8-byte read each, straight into
//     the MMA's registers;
//   * MN-contiguous A: the block is one box of 16 values, fragment rows g
//     and g + 8 at values 2g and 2g + 1, so one 16-byte read at K row
//     dt_k(q, t) gives both, in the MMA's order;
//   * MN-contiguous B: value 8 (jn % 2) + g of its box at K row dt_k(q, t).
template <bool KC, bool kA>
struct DtFrag {
  static constexpr int H = KC || kA ? 1 : 2;
  int off[4][H];  // [q][MN B: jn % 2]
  __device__ __forceinline__ DtFrag(int g, int t) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = dt_k(q, t);
#pragma unroll
      for (int h = 0; h < H; ++h) {
        if (KC) {
          const int pg = dt_perm(g);
          off[q][h] = pg * 128 + ((((k >> 1) ^ pg)) << 4) + (k & 1) * 8;
        } else if (kA) {
          off[q][h] = k * 128 + ((g ^ (k & 7)) << 4);
        } else {
          off[q][h] = k * 128 + ((((4 * h + (g >> 1)) ^ (k & 7))) << 4) + (g & 1) * 8;
        }
      }
    }
  }
  // A's entries (rows g and g + 8) of its 16-row block i in step q.
  __device__ __forceinline__ void read_a(const unsigned char* s, int i, int q, double& lo,
                                         double& hi) const {
    if (KC) {
      lo = *reinterpret_cast<const double*>(s + i * 2048 + off[q][0]);
      hi = *reinterpret_cast<const double*>(s + i * 2048 + 1024 + off[q][0]);
    } else {
      const double2 v = *reinterpret_cast<const double2*>(s + i * 2048 + off[q][0]);
      lo = v.x;
      hi = v.y;
    }
  }
  // B's entry of its 8-column block jn in step q.
  __device__ __forceinline__ double read_b(const unsigned char* s, int jn, int q) const {
    if constexpr (H == 1) return *reinterpret_cast<const double*>(s + jn * 1024 + off[q][0]);
    else return *reinterpret_cast<const double*>(s + (jn >> 1) * 2048 + off[q][jn & 1]);
  }
};

// The consumers: warp (wm, wn) owns rows wm * 64 .. + 63 and columns wn * 32
// .. + 31 of each of the block's tiles; acc[i][jn][q] is the m16n8 block
// (i, jn)'s entry q: fragment row g + 8 (q / 2), column 2t + q % 2.
template <bool A_KC, bool B_KC, typename Ep>
__device__ void dt_consume(const DtArgs& p, unsigned char* smem, DtBars* bars, const Ep& ep,
                           int ksteps) {
  const int ct = threadIdx.x - 128;
  const int warp = ct / 32, lane = ct % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const Gemm& gm = p.g;
  const int M = gm.M, N = gm.N;
  const DtWalk w(p);
  const DtFrag<A_KC, true> fa_at(g, t);
  const DtFrag<B_KC, false> fb_at(g, t);
  int stage = 0;
  uint32_t phase = 0;
  for (int64_t item = blockIdx.x; item < w.items; item += gridDim.x) {
    int z, m0, n0;
    w.at(item, z, m0, n0);
    double acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][jn][q] = 0.0;
    for (int kt = 0; kt < ksteps; ++kt) {
      mbar_wait(&bars->full[stage], phase, p.spin);
      // This warp's 64 rows of A and 32 columns of B in the stage.
      const unsigned char* sa = smem + stage * kDtStage + wm * 4 * 2048;
      const unsigned char* sb = smem + stage * kDtStage + kDtOp + wn * 4 * 1024;
      // Two k4 steps an MMA: fa[i][s][0 / 1] = rows g / g + 8 of step
      // q0 + s, fb[jn][s].  A warp releases the stage after its MMAs, each
      // thread first fencing its generic-proxy reads against the TMA
      // (async-proxy) writes the release lets in: without the fence a
      // refill overwrote fragments still being read (8192^3 and a 4096^3
      // gradient went wrong, 1 launch in a few).
#pragma unroll
      for (int q0 = 0; q0 < 4; q0 += 2) {
        double fa[4][2][2], fb[4][2];
#pragma unroll
        for (int s_ = 0; s_ < 2; ++s_) {
#pragma unroll
          for (int i = 0; i < 4; ++i) fa_at.read_a(sa, i, q0 + s_, fa[i][s_][0], fa[i][s_][1]);
#pragma unroll
          for (int jn = 0; jn < 4; ++jn) fb[jn][s_] = fb_at.read_b(sb, jn, q0 + s_);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jn = 0; jn < 4; ++jn) {
            const double a[4] = {fa[i][0][0], fa[i][0][1], fa[i][1][0], fa[i][1][1]};
            const double b[2] = {fb[jn][0], fb[jn][1]};
            dmma8(acc[i][jn], a, b);
          }
      }
      fence_proxy_async_shared();
      __syncwarp();
      if (lane == 0) mbar_arrive(&bars->empty[stage]);
      if (++stage == kDtStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // The store: fragment row g + 8h of block i is tile row 16i + 8h +
    // dt_perm(g) where A is K-contiguous, else 16i + 2g + h; column 2t + e
    // of block jn is 8jn + dt_perm(2t + e) where B is K-contiguous, else
    // 8jn + 2t + e.
    const int64_t c0 = static_cast<int64_t>(z) * M * N;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 64 + i * 16 + (A_KC ? 8 * h + dt_perm(g) : 2 * g + h);
        if (row >= M) continue;
#pragma unroll
        for (int jn = 0; jn < 4; ++jn)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n0 + wn * 32 + jn * 8 + (B_KC ? dt_perm(2 * t + e) : 2 * t + e);
            if (col >= N) continue;
            const int64_t idx = c0 + static_cast<int64_t>(row) * N + col;
            const double v = acc[i][jn][2 * h + e];
            if (ep_none(ep) && gm.out_code == kF64)
              static_cast<double*>(gm.c)[idx] = v;
            else if constexpr (std::is_same<Ep, EpArgs>::value)
              dm_store(gm, idx, v, col);
            else
              dm_store_ep(gm, ep, idx, v, col);
          }
      }
  }
}

template <bool A_KC, bool B_KC, typename Ep>
__device__ __forceinline__ void dt_block(const DtArgs& p, const Ep& ep) {
  extern __shared__ unsigned char dt_dyn[];
  unsigned char* smem = wg_align(dt_dyn);
  DtBars* bars = reinterpret_cast<DtBars*>(smem + kDtStages * kDtStage);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kDtStages; ++i) {
      mbar_init(&bars->full[i], 1);
      mbar_init(&bars->empty[i], 8);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int ksteps = (p.g.K + kDtBK - 1) / kDtBK;
  if (threadIdx.x < 128) {
    reg_dealloc<40>();
    if (threadIdx.x == 0) dt_produce<A_KC, B_KC>(p, smem, bars, ksteps);
  } else {
    reg_alloc<232>();
    dt_consume<A_KC, B_KC>(p, smem, bars, ep, ksteps);
  }
}

template <bool A_KC, bool B_KC>
__global__ void __launch_bounds__(kDtThreads, 1) dmma_tma_kernel(const __grid_constant__ DtArgs p) {
  dt_block<A_KC, B_KC>(p, p.g.ep);
}

// The tile with a generated epilogue functor ``Ep`` at its store.
template <bool A_KC, bool B_KC, typename Ep>
__global__ void __launch_bounds__(kDtThreads, 1)
dmma_tma_ep_kernel(const __grid_constant__ DtArgs p, const __grid_constant__ Ep ep) {
  dt_block<A_KC, B_KC>(p, ep);
}

// ---- host ------------------------------------------------------------------

// The map of one float64 operand (rows "o" of M or N, K deep) as the caller
// holds it, at row pitch ``ld`` and batch stride ``bs`` (elements; 0: a 2-D
// map): K-contiguous, boxes of 16 K x 128 rows; else boxes of 16 values x
// 16 K rows.
inline bool dt_encode(CUtensorMap* map, const void* base, bool kc, int rows, int k, int64_t ld,
                      int64_t bs, int batch) {
  const int64_t dims[3] = {kc ? k : rows, kc ? rows : k, batch};
  const int64_t strides[2] = {ld * 8, bs * 8};
  const int box[3] = {16, kc ? kDtBM : kDtBK, 1};
  return encode_nd(map, base, bs ? 3 : 2, dims, strides, box, 8, false);
}

// The arguments of ``g`` (its maps encoded) and the grid: one persistent
// block a SM, at most one an item.  0, a CUDA error, kUnsupported or
// kTmaEncodeFailed.
inline int dt_setup(const Gemm& g, int64_t batch, DtArgs& p, unsigned& blocks) {
  if (batch < 1 || batch > INT_MAX) return kUnsupported;
  // cuTensorMapEncodeTiled encodes a map in the calling thread's current context: make
  // the device's primary context current first (an autograd thread's
  // first CUDA call can be this launch: a float64 backward converts
  // nothing before it).
  int dev = 0, sms = 0;
  int err = cudaGetDevice(&dev);
  if (!err) err = cudaSetDevice(dev);
  if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return err;
  const bool a_kc = !g.ta, b_kc = g.tb;
  if (!dt_encode(&p.ma, g.a, a_kc, g.M, g.K, g.lda, g.sa, static_cast<int>(batch)) ||
      !dt_encode(&p.mb, g.b, b_kc, g.N, g.K, g.ldb, g.sb, static_cast<int>(batch)))
    return kTmaEncodeFailed;
  p.g = g;
  p.batch = static_cast<int>(batch);
  p.batch_maps = (g.sa ? 1 : 0) | (g.sb ? 2 : 0);
  p.spin = spin_cycles(10000);  // a stage wait is microseconds; 10 s means a lost load
  const int64_t items = batch * ((g.M + kDtBM - 1) / kDtBM) * ((g.N + kDtBN - 1) / kDtBN);
  blocks = static_cast<unsigned>(items < sms ? items : sms);
  return 0;
}

template <typename Kernel, typename... Ep>
int dt_launch(Kernel kernel, const Gemm& g, int64_t batch, cudaStream_t st, const Ep&... ep) {
  DtArgs p{};
  unsigned blocks = 0;
  const int rc = dt_setup(g, batch, p, blocks);
  if (rc) return rc;
  const int attr = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDtSmem));
  if (attr) return attr;
  kernel<<<blocks, kDtThreads, kDtSmem, st>>>(p, ep...);
  return last_error();
}

template <bool A_KC, bool B_KC>
int launch_dmma_tma(const Gemm& g, int64_t batch, cudaStream_t st) {
  return dt_launch(dmma_tma_kernel<A_KC, B_KC>, g, batch, st);
}

// A generated epilogue's library holds the one layout of its call.
template <bool A_KC, bool B_KC, typename Ep>
int launch_dmma_tma_ep(const Gemm& g, int64_t batch, cudaStream_t st, const Ep& ep) {
  if (!g.ta != A_KC || static_cast<bool>(g.tb) != B_KC) return kUnsupported;
  return dt_launch(dmma_tma_ep_kernel<A_KC, B_KC, Ep>, g, batch, st, ep);
}

// The four layouts of the built-in tile.
inline int launch_dmma_tma_any(const Gemm& g, int64_t batch, cudaStream_t st) {
  const bool a_kc = !g.ta, b_kc = g.tb;
  if (a_kc && b_kc) return launch_dmma_tma<true, true>(g, batch, st);
  if (a_kc) return launch_dmma_tma<true, false>(g, batch, st);
  if (b_kc) return launch_dmma_tma<false, true>(g, batch, st);
  return launch_dmma_tma<false, false>(g, batch, st);
}

}  // namespace gemm_hls
