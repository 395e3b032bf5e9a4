// Kernel B3's packed tile: float16 and bfloat16 inputs under the order
// semirings (min_plus, max_plus, max_min, min_max, max_times) with an
// output of the input's type, reduced two terms an instruction on sm_90's
// .f16x2 / .bf16x2 ALU ops.  Instantiated in csrc/semiring_f16.cu and
// csrc/semiring_bf16.cu (dispatch_packed), launched where
// ops/vpu.py::b3_route says "packed"; every other B3 call stays on the
// scalar tile (simt_gemm.cuh).  Replaces, as that tile does, the TPU kernel
// gemm_hls_tpu/ops/pallas_vpu.py::_vpu_kernel.
//
// Why the same bits as the reference: the reference widens both operands
// to fp32, reduces in fp32 and rounds to the 16-bit type at the store
// (pallas_vpu.py:74-75, 113).  Rounding to a 16-bit type is monotone, so it
// commutes with min and max; a min or max of two 16-bit values is one of
// them; a sum or product of two float16 values rounded to fp32 and then to
// float16 is the exact one rounded once (fp32 carries more than 2 x 11 + 2
// bits, and a float16 product is exact in fp32); a bfloat16 sum likewise
// (2 x 8 + 2 bits), and a bfloat16 product is exact in fp32 but where it
// falls below fp32's normal range, where tests/test_torch_b3_packed.py
// checks every significand product at every such exponent.  So the whole
// fold may run in the 16-bit type: add / mul .rn and min.NaN / max.NaN on
// pairs (NaN kept, as jnp.minimum / jnp.maximum keep it).  chip_smoke.py
// phase 36b checks each instruction against the scalar tile's fp32 term
// over all 2^32 pairs, 36c the tile against the scalar one bit for bit.
//
// What bounds it on an H100: the CUDA cores' issue rate, one instruction
// a term (a pair's map and its reduce for two terms), half the scalar
// tile's two (models/perf_model.py::ChipSpec.vpu_ops_for: 2.05 ms at
// 4096^3 for min_plus).  The design keeps everything else off that path:
//   * operands staged in shared memory in their 16-bit type, K-major
//     ([k][m] and [k][n] rows), through a ring of kPkStages stages and one
//     barrier a slice: 16-byte cp.async copies where the operand's
//     contiguous axis is M or N and its base, row pitch and batch stride
//     are whole 16-byte units; else each thread loads its 8-element chunks
//     of the slice after next into registers (16-byte loads where those
//     rules hold along K, single elements otherwise) before reducing this
//     slice and stores them, a K-contiguous operand transposed by the
//     stores' addresses, after it;
//   * each thread owns 8 rows x 16 columns as 64 packed accumulators:
//     rows 8 ty + i, columns 8 tx + c and 128 + 8 tx + c (c < 8), so a
//     step's fragments are three 16-byte shared reads, A's 8 values each
//     broadcast into both halves of a pair once a step;
//   * a step is 64 pairs: reduce(acc, map(a_i a_i, b_j b_j+1)), two
//     instructions for two terms;
//   * the store writes the pairs straight to the 16-bit output, 16 bytes
//     at a time where N is a multiple of 8, masking M and N; the K tail is
//     the last slice's loop bound, as in the scalar tile.
// Every layout (the transposes through the operands' strides), any pitch
// and alignment, unpadded operands and the batch axis (a batch stride of 0
// broadcasts an operand) are the scalar tile's.
#pragma once

#include "semiring_ops.cuh"

namespace gemm_hls {

constexpr int kPkBM = 128, kPkBN = 256, kPkBK = 32, kPkThreads = 256, kPkStages = 3;
constexpr int kPkUnroll = 8;  // full K steps a loop iteration
constexpr int kPkStage = kPkBK * (kPkBM + kPkBN);  // 16-bit elements a stage
constexpr int kPkSmem = kPkStages * kPkStage * 2;  // 73,728 bytes

// The packed instructions of a 16-bit type, on 32-bit words of two values.
template <typename T> struct Pair;
template <> struct Pair<__half> {
  static constexpr unsigned kPosInf = 0x7c007c00u, kNegInf = 0xfc00fc00u;
  static __device__ __forceinline__ unsigned add(unsigned a, unsigned b) {
    unsigned r;
    asm("add.rn.f16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
  }
  static __device__ __forceinline__ unsigned mul(unsigned a, unsigned b) {
    unsigned r;
    asm("mul.rn.f16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
  }
  static __device__ __forceinline__ unsigned min(unsigned a, unsigned b) {
    unsigned r;
    asm("min.NaN.f16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
  }
  static __device__ __forceinline__ unsigned max(unsigned a, unsigned b) {
    unsigned r;
    asm("max.NaN.f16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
  }
};
template <> struct Pair<__nv_bfloat16> {
  static constexpr unsigned kPosInf = 0x7f807f80u, kNegInf = 0xff80ff80u;
  static __device__ __forceinline__ unsigned add(unsigned a, unsigned b) {
    unsigned r;
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
  }
  static __device__ __forceinline__ unsigned mul(unsigned a, unsigned b) {
    unsigned r;
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
  }
  static __device__ __forceinline__ unsigned min(unsigned a, unsigned b) {
    unsigned r;
    asm("min.NaN.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
  }
  static __device__ __forceinline__ unsigned max(unsigned a, unsigned b) {
    unsigned r;
    asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
  }
};

// The low / high value of a pair in both halves.
__device__ __forceinline__ unsigned pk_lo2(unsigned x) {
  unsigned r;
  asm("{\n .reg .b16 l, h;\n mov.b32 {l, h}, %1;\n mov.b32 %0, {l, l};\n}" : "=r"(r) : "r"(x));
  return r;
}
__device__ __forceinline__ unsigned pk_hi2(unsigned x) {
  unsigned r;
  asm("{\n .reg .b16 l, h;\n mov.b32 {l, h}, %1;\n mov.b32 %0, {h, h};\n}" : "=r"(r) : "r"(x));
  return r;
}

// The order semirings on pairs: identity and reduce(acc, map(a, b)).
template <typename T, int kOp> struct PackedOp;
template <typename T> struct PackedOp<T, kMinPlus> {
  static constexpr unsigned kIdentity = Pair<T>::kPosInf;
  static __device__ __forceinline__ unsigned step(unsigned acc, unsigned a, unsigned b) {
    return Pair<T>::min(acc, Pair<T>::add(a, b));
  }
};
template <typename T> struct PackedOp<T, kMaxPlus> {
  static constexpr unsigned kIdentity = Pair<T>::kNegInf;
  static __device__ __forceinline__ unsigned step(unsigned acc, unsigned a, unsigned b) {
    return Pair<T>::max(acc, Pair<T>::add(a, b));
  }
};
template <typename T> struct PackedOp<T, kMaxMin> {
  static constexpr unsigned kIdentity = Pair<T>::kNegInf;
  static __device__ __forceinline__ unsigned step(unsigned acc, unsigned a, unsigned b) {
    return Pair<T>::max(acc, Pair<T>::min(a, b));
  }
};
template <typename T> struct PackedOp<T, kMinMax> {
  static constexpr unsigned kIdentity = Pair<T>::kPosInf;
  static __device__ __forceinline__ unsigned step(unsigned acc, unsigned a, unsigned b) {
    return Pair<T>::min(acc, Pair<T>::max(a, b));
  }
};
template <typename T> struct PackedOp<T, kMaxTimes> {
  static constexpr unsigned kIdentity = Pair<T>::kNegInf;
  static __device__ __forceinline__ unsigned step(unsigned acc, unsigned a, unsigned b) {
    return Pair<T>::max(acc, Pair<T>::mul(a, b));
  }
};

// ---- staging ---------------------------------------------------------------
// One operand's K slice is R rows of its M or N ("o") by kPkBK, stored
// s[k][o]; o_contig: the operand's contiguous axis is o (A with ta, B
// without tb), else K.  It moves as 8-element chunks along that axis,
// kChunks a thread; a warp's chunks are 32 neighbours along o (K-contiguous:
// one chunk of 32 rows each, whose 2-byte stores then fill 64 bytes of one
// shared row) or along the row (o-contiguous: 16-byte stores side by side).
template <int R> struct PkSlice {
  static constexpr int kChunks = R * kPkBK / 8 / kPkThreads;
  static __device__ __forceinline__ void chunk(int i, bool o_contig, int& o, int& k) {
    const int c = threadIdx.x + i * kPkThreads;
    if (o_contig) {
      k = c / (R / 8);
      o = (c % (R / 8)) * 8;
    } else {
      o = c % R;
      k = (c / R) * 8;
    }
  }
  // 16-byte cp.async copies (o_contig and the 16-byte rule): the chunk's
  // elements in bounds are a prefix, the rest zero-filled.
  static __device__ __forceinline__ void copy(unsigned short* s, const unsigned short* g,
                                              int64_t ld, int o0, int k0, int O, int K) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      int o, k;
      chunk(i, true, o, k);
      const int go = o0 + o, gk = k0 + k;
      const int n = gk < K ? max(0, min(8, O - go)) : 0;
      const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(s + k * R + o));
      const unsigned short* src = n ? g + static_cast<int64_t>(gk) * ld + go : g;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                   "r"(2 * n));
    }
  }
  // The register path: the chunks into r (zero out of bounds).
  static __device__ __forceinline__ void fetch(uint4 (&r)[kChunks], const unsigned short* g,
                                               int64_t ld, bool o_contig, bool vec, int o0,
                                               int k0, int O, int K) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      int o, k;
      chunk(i, o_contig, o, k);
      const int go = o0 + o, gk = k0 + k;
      const int64_t base = o_contig ? static_cast<int64_t>(gk) * ld + go
                                    : static_cast<int64_t>(go) * ld + gk;
      const bool full = o_contig ? gk < K && go + 8 <= O : go < O && gk + 8 <= K;
      if (vec && full) {
        r[i] = *reinterpret_cast<const uint4*>(g + base);
      } else {
        unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const bool in = o_contig ? gk < K && go + j < O : go < O && gk + j < K;
          if (in) w[j / 2] |= static_cast<unsigned>(g[base + j]) << (16 * (j % 2));
        }
        r[i] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
  static __device__ __forceinline__ void put(unsigned short* s, const uint4 (&r)[kChunks],
                                             bool o_contig) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      int o, k;
      chunk(i, o_contig, o, k);
      if (o_contig) {
        *reinterpret_cast<uint4*>(s + k * R + o) = r[i];
      } else {
        const unsigned w[4] = {r[i].x, r[i].y, r[i].z, r[i].w};
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s[(k + j) * R + o] = static_cast<unsigned short>(w[j / 2] >> (16 * (j % 2)));
      }
    }
  }
};

// acc = step(acc, A[:, kk], B[kk, :]) over the thread's 8 x 8 pairs.
template <typename F>
__device__ __forceinline__ void pk_step(unsigned (&acc)[8][8], const unsigned short* As,
                                        const unsigned short* Bs, int kk, int tx, int ty) {
  const uint4 av = *reinterpret_cast<const uint4*>(As + kk * kPkBM + 8 * ty);
  const uint4 b0 = *reinterpret_cast<const uint4*>(Bs + kk * kPkBN + 8 * tx);
  const uint4 b1 = *reinterpret_cast<const uint4*>(Bs + kk * kPkBN + 128 + 8 * tx);
  const unsigned aw[4] = {av.x, av.y, av.z, av.w};
  const unsigned b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const unsigned a = i % 2 ? pk_hi2(aw[i / 2]) : pk_lo2(aw[i / 2]);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = F::step(acc[i][j], a, b[j]);
  }
}

template <typename T, int kOp>
__global__ void __launch_bounds__(kPkThreads, 1) packed_gemm_kernel(const Gemm g,
                                                                    const int64_t z0) {
  using F = PackedOp<T, kOp>;
  using SA = PkSlice<kPkBM>;
  using SB = PkSlice<kPkBN>;
  extern __shared__ __align__(16) unsigned short pk_smem[];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kPkBM, n0 = blockIdx.x * kPkBN;
  const int M = g.M, N = g.N, K = g.K;
  const int64_t z = z0 + blockIdx.z;
  const unsigned short* A = static_cast<const unsigned short*>(g.a) + z * g.sa;
  const unsigned short* B = static_cast<const unsigned short*>(g.b) + z * g.sb;
  // The contiguous axis: A's is M with ta, else K; B's is N without tb.
  const bool a_oc = g.ta, b_oc = !g.tb;
  const bool a_async = a_oc && g.a_vec, b_async = b_oc && g.b_vec;
  uint4 ra[SA::kChunks], rb[SB::kChunks];

  // Slice kt's copies (issued) and its register path's loads (into ra / rb),
  // then their stores (put), into stage kt % kPkStages.
  const auto issue = [&](int kt) {
    unsigned short* st = pk_smem + (kt % kPkStages) * kPkStage;
    const int k0 = kt * kPkBK;
    if (a_async) SA::copy(st, A, g.lda, m0, k0, M, K);
    else SA::fetch(ra, A, g.lda, a_oc, g.a_vec, m0, k0, M, K);
    if (b_async) SB::copy(st + kPkBK * kPkBM, B, g.ldb, n0, k0, N, K);
    else SB::fetch(rb, B, g.ldb, b_oc, g.b_vec, n0, k0, N, K);
  };
  const auto put = [&](int kt) {
    unsigned short* st = pk_smem + (kt % kPkStages) * kPkStage;
    if (!a_async) SA::put(st, ra, a_oc);
    if (!b_async) SB::put(st + kPkBK * kPkBM, rb, b_oc);
  };

  unsigned acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = F::kIdentity;

  const int kt_n = (K + kPkBK - 1) / kPkBK;
#pragma unroll
  for (int s = 0; s < kPkStages - 1; ++s) {
    if (s < kt_n) {
      issue(s);
      put(s);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kPkStages - 2));
    // Slice kt has landed (its copies, and its stores a slice or more ago);
    // stage kt - 1's readers are done, so its slot takes slice kt + 2.
    __syncthreads();
    const int next = kt + kPkStages - 1;
    if (next < kt_n) issue(next);
    asm volatile("cp.async.commit_group;\n" ::);
    const unsigned short* As = pk_smem + (kt % kPkStages) * kPkStage;
    const unsigned short* Bs = As + kPkBK * kPkBM;
    const int kl = min(kPkBK, K - kt * kPkBK);
    if (kl == kPkBK) {
#pragma unroll kPkUnroll
      for (int kk = 0; kk < kPkBK; ++kk) pk_step<F>(acc, As, Bs, kk, tx, ty);
    } else {  // the K tail
#pragma unroll 1
      for (int kk = 0; kk < kl; ++kk) pk_step<F>(acc, As, Bs, kk, tx, ty);
    }
    if (next < kt_n) put(next);
  }

  unsigned short* C = static_cast<unsigned short*>(g.c) + z * M * N;
  const bool c_vec = N % 8 == 0;  // 16-byte rows (the output is allocated whole)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + 8 * ty + i;
    if (gm >= M) continue;
    unsigned short* row = C + static_cast<int64_t>(gm) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gn = n0 + 128 * h + 8 * tx;
      if (c_vec && gn < N) {
        *reinterpret_cast<uint4*>(row + gn) =
            make_uint4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (gn + e < N)
            row[gn + e] = static_cast<unsigned short>(acc[i][4 * h + e / 2] >> (16 * (e % 2)));
      }
    }
  }
}

// The tile's launch; it finds the 16-byte rule (a_vec / b_vec: base, row
// pitch and batch stride whole 16-byte units) from ``g`` itself.
template <typename T, int kOp>
int launch_packed(const Gemm& g0, int64_t batch, cudaStream_t stream) {
  Gemm g = g0;
  const auto vec = [](const void* p, int64_t ld, int64_t bs) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 8 == 0 && bs % 8 == 0;
  };
  g.a_vec = vec(g.a, g.lda, g.sa);
  g.b_vec = vec(g.b, g.ldb, g.sb);
  const int attr = static_cast<int>(cudaFuncSetAttribute(
      packed_gemm_kernel<T, kOp>, cudaFuncAttributeMaxDynamicSharedMemorySize, kPkSmem));
  if (attr) return attr;
  return for_batch_chunks(batch, [&](int64_t z0, unsigned nz) {
    const dim3 grid((g.N + kPkBN - 1) / kPkBN, (g.M + kPkBM - 1) / kPkBM, nz);
    packed_gemm_kernel<T, kOp><<<grid, kPkThreads, kPkSmem, stream>>>(g, z0);
  });
}

// B3's packed route for T inputs: the order semirings into T's own output
// type; kUnsupported for any other (op, output).
template <typename T>
int dispatch_packed(int op, const Gemm& g, int64_t batch, cudaStream_t s) {
  if (g.out_code != (std::is_same<T, __half>::value ? kF16 : kBF16)) return kUnsupported;
  switch (op) {
    case kMinPlus: return launch_packed<T, kMinPlus>(g, batch, s);
    case kMaxPlus: return launch_packed<T, kMaxPlus>(g, batch, s);
    case kMaxMin: return launch_packed<T, kMaxMin>(g, batch, s);
    case kMinMax: return launch_packed<T, kMinMax>(g, batch, s);
    case kMaxTimes: return launch_packed<T, kMaxTimes>(g, batch, s);
    default: return kUnsupported;
  }
}

}  // namespace gemm_hls
