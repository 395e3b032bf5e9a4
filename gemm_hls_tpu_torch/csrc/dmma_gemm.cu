// Kernels B1 and B2 for float64: dense plus_times GEMM on the FP64 tensor
// cores, C[z] (M, N) = epilogue(op(A[z]) . op(B[z])) for every batch entry z.
//
// Replaces, for float64 operands, the two TPU kernels of
// gemm_hls_tpu/ops/pallas_mxu.py that csrc/mxu_gemm.cu replaces for the
// other types: _kernel (entry mxu_matmul, B1, batch = 1) and
// _batched_kernel (entry mxu_matmul_batched, B2), each with its optional
// per-column epilogue at the store (pallas_mxu.py:103-106).  The TPU has no
// float64 unit (Mosaic refuses it, so the JAX front door sends float64 to
// XLA's emulation there); Hopper has float64 tensor cores (DMMA), so the
// card runs the reference's float64 GEMM as a kernel with a float64
// accumulator, IEEE double FMA, the same numbers as a float64 BLAS up to
// the order of the sums.
//
// Same schedule as the TPU kernels: one C tile stays in fast memory (here
// registers: a 128 x 128 tile of doubles over 256 threads, 64 each) while K
// streams through; the TPU kernel's sequential K grid axis and its acc_ref
// scratch become the loop over K inside the block.  The batch is a grid
// axis (blockIdx.z, chunked past gridDim.z's 65535); each operand carries a
// batch stride, 0 for a 2-D operand broadcast over the batch.
//
// The tile: 8 warps as 2 x 4, each warp 64 x 32 of C as 4 x 4 products of
// mma.sync m16n8k4 .f64 (sm_90; wgmma has no f64 form), its fragments read
// from shared memory.  sm_80's m8n8k4 issues at half the rate of the sm_90
// shapes on an H100: the same tile on it took 1.6x as long at 8192^3
// (PERF.md section 6); m16n8k8 / k16 hold larger fragments, which spill
// in this tile.  A and B K-slices of 16 doubles come
// in through cp.async into a ring of STAGES shared-memory stages, 16-byte
// copies where the operand's base, row pitch and batch stride are whole
// 16-byte units (a_vec / b_vec), 8-byte copies otherwise.  Each operand
// keeps its global orientation in shared memory (no transpose is
// materialised): a K-contiguous operand as [o][k] rows of DBK + 4 doubles,
// the other as [k][o] rows of DBM + 4.  The pads make a fragment read
// conflict-free: the 16 lanes of a half warp, (g, t) = (lane / 4, lane %
// 4) reading element (o0 + g, k0 + t) of a fragment, fall on 16 distinct 8-byte bank
// pairs in either layout (4g + t, resp. 4t + g, modulo 16).
//
// Ragged edges: the K tail of BOTH operands and the rows past M / N are
// zero-filled in shared memory by the copies' source size (nothing past
// the operand is read, so 0 * NaN garbage never reaches a sum; see
// pallas_mxu.py::_mask_k_tail); the store masks rows and columns past M /
// N.  The epilogue is common.cuh's in double (exp / tanh in double
// precision, each product and sum rounded on its own), reading its (N,)
// operands in their own type, widened exactly.
//
// What bounds it on an H100: the FP64 tensor-core rate, 67e12 FLOP/s (data
// sheet; 8192^3 is 1.1e12 FLOP, 16.4 ms), far above its bytes (three 512 MB
// matrices at 3.35e12 B/s: 0.48 ms).  This simple design runs one block of
// 8 warps a SM (64 doubles of accumulator a thread, 254 registers); deeper
// reuse and more warps in flight are left for a later redesign.  Times:
// PERF.md section 6.
#include "common.cuh"

namespace gemm_hls {

constexpr int DBM = 128, DBN = 128, DBK = 16, DTHREADS = 256, DSTAGES = 3;
// Row pitches (doubles) of the two shared-memory layouts, and one operand's
// slot in a stage (the larger of the two layouts).
constexpr int DP_KC = DBK + 4, DP_OC = DBM + 4;
constexpr int DSLOT = DBM * DP_KC > DBK * DP_OC ? DBM * DP_KC : DBK * DP_OC;
constexpr int kDmmaSmem = DSTAGES * 2 * DSLOT * 8;
static_assert(DBM == DBN, "both operands share one slot size");

__device__ __forceinline__ unsigned dm_smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// cp.async of 16 (or 8) bytes, zero-filling past ``bytes`` (0: nothing read).
__device__ __forceinline__ void dm_cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dm_smem(dst)), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void dm_cp8(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dm_smem(dst)), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void dm_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void dm_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a . b for one m16n8k4 f64 product: a = A[g][t], A[g + 8][t]; b =
// B[t][g]; d = the C entries (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8,
// 2t + 1) of the 16 x 8 tile.
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[2], double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

// Shared-memory index of operand element (o, k) in its layout.
template <bool KC>
__device__ __forceinline__ int dm_at(int o, int k) {
  return KC ? o * DP_KC + k : k * DP_OC + o;
}

// One operand K-slice (DBM rows "o" by DBK) into a stage slot.  KC: the
// operand's contiguous axis is K (A without ta, B with tb).  g points at
// the batch entry; O is the operand's M or N.
template <bool KC>
__device__ __forceinline__ void dm_load(double* s, const double* __restrict__ g, int64_t ld,
                                        int o0, int k0, int O, int K, bool vec) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < DBM * DBK / 2 / DTHREADS; ++i) {
      const int c = threadIdx.x + i * DTHREADS;
      // (row, first column) of the chunk in the operand's orientation.
      const int r = KC ? c / (DBK / 2) : c / (DBM / 2);
      const int col = KC ? (c % (DBK / 2)) * 2 : (c % (DBM / 2)) * 2;
      const int o = KC ? r : col, k = KC ? col : r;
      const int go = o0 + o, gk = k0 + k;
      int n = 0;
      if (KC && go < O) n = min(2, K - gk);
      if (!KC && gk < K) n = min(2, O - go);
      n = max(n, 0);
      const double* src = n ? g + (KC ? static_cast<int64_t>(go) * ld + gk
                                      : static_cast<int64_t>(gk) * ld + go)
                            : g;
      dm_cp16(s + dm_at<KC>(o, k), src, 8 * n);
    }
  } else {
#pragma unroll
    for (int i = 0; i < DBM * DBK / DTHREADS; ++i) {
      const int e = threadIdx.x + i * DTHREADS;
      const int o = KC ? e / DBK : e % DBM, k = KC ? e % DBK : e / DBM;
      const int go = o0 + o, gk = k0 + k;
      const bool in = go < O && gk < K;
      const double* src = in ? g + (KC ? static_cast<int64_t>(go) * ld + gk
                                       : static_cast<int64_t>(gk) * ld + go)
                             : g;
      dm_cp8(s + dm_at<KC>(o, k), src, in ? 8 : 0);
    }
  }
}

// C[idx] = epilogue(v) in the output type, out of line: the tile's 64
// unrolled stores each make one call, not a copy of the switches.
static __device__ __noinline__ void dm_store(const Gemm& g, int64_t idx, double v, int gn) {
  store_any(g.c, idx, epilogue(v, g.ep, gn), g.out_code);
}

template <bool A_KC, bool B_KC>
__global__ void __launch_bounds__(DTHREADS, 1) dmma_gemm_kernel(const Gemm g, const int64_t z0) {
  extern __shared__ __align__(16) double dsm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;  // each warp: 64 x 32 of C
  const int gq = lane / 4, tq = lane % 4;
  const int m0 = blockIdx.y * DBM, n0 = blockIdx.x * DBN;
  const int M = g.M, N = g.N, K = g.K;
  const int64_t z = z0 + blockIdx.z;
  const double* A = static_cast<const double*>(g.a) + z * g.sa;
  const double* B = static_cast<const double*>(g.b) + z * g.sb;
  const bool a_vec = g.a_vec, b_vec = g.b_vec;

  double acc[4][4][4];  // [16-row block][8-column block][fragment entry]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;

  const int kt_n = (K + DBK - 1) / DBK;
  auto load = [&](int kt) {
    double* st = dsm + (kt % DSTAGES) * 2 * DSLOT;
    dm_load<A_KC>(st, A, g.lda, m0, kt * DBK, M, K, a_vec);
    dm_load<B_KC>(st + DSLOT, B, g.ldb, n0, kt * DBK, N, K, b_vec);
  };
#pragma unroll
  for (int s = 0; s < DSTAGES - 1; ++s) {
    if (s < kt_n) load(s);
    dm_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    dm_wait<DSTAGES - 2>();  // slice kt has landed
    __syncthreads();         // and every warp is done with slice kt - 1's stage
    if (kt + DSTAGES - 1 < kt_n) load(kt + DSTAGES - 1);
    dm_commit();
    const double* As = dsm + (kt % DSTAGES) * 2 * DSLOT;
    const double* Bs = As + DSLOT;
#pragma unroll
    for (int kk = 0; kk < DBK; kk += 4) {
      double fa[4][2], fb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          fa[i][h] = As[dm_at<A_KC>(wm * 64 + i * 16 + h * 8 + gq, kk + tq)];
#pragma unroll
      for (int j = 0; j < 4; ++j) fb[j] = Bs[dm_at<B_KC>(wn * 32 + j * 8 + gq, kk + tq)];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dmma(acc[i][j], fa[i], fb[j]);
    }
  }
  dm_wait<0>();

  const int64_t c0 = z * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + wm * 64 + i * 16 + h * 8 + gq;
      if (gm >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gn = n0 + wn * 32 + j * 8 + 2 * tq + e;
          if (gn >= N) continue;
          const int64_t idx = c0 + static_cast<int64_t>(gm) * N + gn;
          if (g.ep.kind == kEpNone && g.out_code == kF64)
            static_cast<double*>(g.c)[idx] = acc[i][j][2 * h + e];
          else
            dm_store(g, idx, acc[i][j][2 * h + e], gn);
        }
      }
    }
  }
}

template <bool A_KC, bool B_KC>
int launch_dmma(const Gemm& g, int64_t batch, cudaStream_t stream) {
  const auto kernel = dmma_gemm_kernel<A_KC, B_KC>;
  const int attr = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDmmaSmem));
  if (attr) return attr;
  return for_batch_chunks(batch, [&](int64_t z0, unsigned nz) {
    const dim3 grid((g.N + DBN - 1) / DBN, (g.M + DBM - 1) / DBM, nz);
    kernel<<<grid, DTHREADS, kDmmaSmem, stream>>>(g, z0);
  });
}

}  // namespace gemm_hls

using namespace gemm_hls;

// mxu_gemm's arguments for float64 operands: C (batch, M, N) row-major in
// ``out_code``'s dtype; lda / ldb the operands' row pitch, sa / sb their
// batch stride (0 broadcasts a 2-D operand); a_vec / b_vec: the operand's
// base is 16-byte aligned and its row pitch and batch stride whole 16-byte
// units (16-byte copies).  ep: an EpKind reading the (N,) operands e0 / e1
// of dtype ep_code (f64, f32, bf16 or f16).  Returns 0, a CUDA error code,
// or -1 for inputs that are not float64 or an epilogue not built.
extern "C" int dmma_gemm(const void* a, const void* b, void* c, int64_t batch, int M, int N, int K,
                         int64_t lda, int64_t ldb, int64_t sa, int64_t sb, int ta, int tb,
                         int a_vec, int b_vec, int in_code, int out_code, int ep, const void* e0,
                         const void* e1, int ep_code, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_code != kF64 || ep < 0 || ep >= kEpKinds) return kUnsupported;
  const Gemm g{a, b, c, M, N, K, lda, ldb, sa, sb, ta, tb, a_vec, b_vec, out_code,
               EpArgs{e0, e1, ep_code, ep}};
  const bool a_kc = !ta, b_kc = tb;
  if (a_kc && b_kc) return launch_dmma<true, true>(g, batch, s);
  if (a_kc) return launch_dmma<true, false>(g, batch, s);
  if (b_kc) return launch_dmma<false, true>(g, batch, s);
  return launch_dmma<false, false>(g, batch, s);
}
