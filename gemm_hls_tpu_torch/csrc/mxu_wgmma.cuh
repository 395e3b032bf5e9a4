// Kernels B1 and B2 on the Hopper tile engine (csrc/wgmma_tile.cuh): the
// dense GEMM C[z] (M, N) = epilogue(op(A[z]) . op(B[z])) for bf16 / fp16
// inputs with fp32 sums, and int8 inputs with int32 sums where both
// operands are K-major; one example (B1) or a batch of them (B2).  The
// counterpart of gemm_hls_tpu/ops/pallas_mxu.py::_kernel and its fused
// per-column epilogue (:69, :103), and of ::_batched_kernel (:143, called
// at :298 with the epilogue and :328 without); the shapes it does not take
// stay on csrc/mxu_gemm.cu (see there).  The row softmax has its own
// engine kernel (csrc/row_softmax_wgmma.cu, which reads its operands
// through encode_operand's maps) and csrc/row_softmax.cu off the engine.
//
// One persistent block a SM (the engine's 384 threads: two consumer
// warpgroups own 64 rows each of a 128 x 256 tile, one producer thread
// keeps a 4-stage TMA ring full) walks the (example, tile) pairs, the
// tiles of an example in the engine's grouped order.  A batch is the
// engine's steps: step z reads a 3-D operand through a 3-D map (contiguous
// axis, outer axis, batch) at coordinate z, so TMA zero-fills each
// example's own K and M / N edges (a flattened (B K, .) map would read the
// next example's rows into an MN-major operand's K tail), and a 2-D
// operand broadcast over the batch through a 2-D map every step reads
// alike; C[z] starts z M N elements in.  The operands are read where the
// caller holds them, through their row pitch and batch stride, so neither
// a transpose nor a strided view is copied: a
// K-major operand (A (M, K), or B held as (N, K)) by 128-byte K boxes, an
// MN-major one (A held as (K, M), or the main path's row-major B (K, N))
// by 64-value boxes that wgmma reads through its transpose bit.  TMA zero-fills M, N and K
// past the edges, so no garbage past K reaches a sum
// (pallas_mxu.py::_mask_k_tail's rule).
//
// The epilogue (common.cuh's EpKind, chosen at run time) is applied from
// registers before the output cast: its kind and its operands' type are
// resolved once a tile, never per element (a per-element switch over 128
// unrolled values stalls ptxas), and it rounds as the plain version's
// separate torch ops (no FMA contraction).  Its column operands are
// staged in shared memory, once a tile.
//
// What bounds it on an H100: the tensor-core rate (bf16 8192^3: 1.1e12
// FLOP at 989e12 FLOP/s, 1.11 ms); B2 at 64 x 512^3 the bytes (100 MB of
// operands and output, 30 us at 3.35 TB/s, against 17 us of products).
// Measured (H100 80GB HBM3, 700 W, chip_smoke.py): 1.499 ms at bf16
// 8192^3 (733 TFLOP/s) against torch.matmul's 1.514; with bias + ReLU at
// 8192 x 4096 . 4096 x 16384, 1.620 ms against torch._addmm_activation's
// 1.499 (the store does not overlap the next tile's wgmma).  B2's times:
// PERF.md section 6.
#pragma once

#include <type_traits>

#include "wgmma_tile.cuh"

namespace gemm_hls {

// Where a B1 tile goes: C row-major at row pitch ldc, the epilogue, the
// output type, and the block's staging of the epilogue's column operands
// (kEpStage floats a consumer warpgroup).
struct EpOut {
  void* c;
  int64_t ldc;
  int out_code;
  EpArgs ep;
  float* cols;
};
__device__ __forceinline__ bool wg_reads_sum(const EpOut&) { return false; }

// The epilogue works on the tile in place (a second 128-value array beside
// the accumulator, which stays live into the next tile, spilled): a float
// tile as it is, an int32 one widened to fp32 and kept as the float's bits.
__device__ __forceinline__ float as_f(float v) { return v; }
__device__ __forceinline__ float as_f(int v) { return __int_as_float(v); }
__device__ __forceinline__ void set_f(float& d, float x) { d = x; }
__device__ __forceinline__ void set_f(int& d, float x) { d = __float_as_int(x); }

// Floats of shared memory a consumer warpgroup stages its tile's column
// operands in: the scale and the shift of each of the tile's kWgBN columns.
constexpr int kEpStage = 2 * kWgBN;

// x = x * s + b for the kind, s = 1 and b = -0 (both exact identities, -0
// keeps a -0 sum) where it has no scale or no shift, then the activation.
// The warpgroup first stages the tile's columns in ``cols`` (two a thread:
// one load round trip a tile, where loads beside their values went one
// column pair at a time), read back in the fragment's order: value 4 j +
// 2 h + q is column c0 + 8 j + q.
template <typename Acc>
__device__ __forceinline__ void ep_apply(Acc (&f)[128], const EpArgs& e, float* cols, int n0,
                                         int c0, int N) {
  const bool scale = e.kind == kEpColScale || e.kind == kEpScaleBias;
  const bool shift = e.kind != kEpColScale;
  const void* bsrc = e.kind == kEpScaleBias ? e.e1 : e.e0;
  const int tid = threadIdx.x % 128, bar = 2 + (threadIdx.x / 128 - 1);
#pragma unroll
  for (int h = 0; h < kWgBN / 128; ++h) {
    const int cl = tid + 128 * h, c = n0 + cl;
    cols[cl] = scale && c < N ? ep_load(e.e0, e.code, c) : 1.f;
    cols[kWgBN + cl] = shift && c < N ? ep_load(bsrc, e.code, c) : -0.f;
  }
  named_sync(bar, 128);
  const int cb = c0 - n0;
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float s = cols[cb + 8 * j + q], b = cols[kWgBN + cb + 8 * j + q];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        Acc& x = f[4 * j + 2 * h + q];
        set_f(x, __fadd_rn(__fmul_rn(as_f(x), s), b));
      }
    }
  named_sync(bar, 128);  // the next tile stages over these columns
  switch (e.kind) {
    case kEpBiasRelu:
#pragma unroll
      for (int i = 0; i < 128; ++i) set_f(f[i], dmax(as_f(f[i]), 0.f));
      break;
    case kEpBiasSigmoid:
#pragma unroll
      for (int i = 0; i < 128; ++i) set_f(f[i], ep_sigmoid(as_f(f[i])));
      break;
    case kEpBiasTanh:
#pragma unroll
      for (int i = 0; i < 128; ++i) set_f(f[i], tanhf(as_f(f[i])));
      break;
    case kEpBiasGelu:
#pragma unroll
      for (int i = 0; i < 128; ++i) set_f(f[i], ep_gelu_inline(as_f(f[i])));
      break;
    default: break;
  }
}

// The 128 values as Out (kBits: floats kept as an int tile's bits), (c,
// c + 1) of a row as one store where both are inside and aligned.
template <typename Out, bool kBits, typename V>
__device__ __forceinline__ void ep_store_as(const V (&v)[128], const EpOut& o, int r0, int c0,
                                            int M, int N) {
  using Pair = PairOf<Out>;
  Out* out = static_cast<Out*>(o.c);
  const bool pairs =
      o.ldc % 2 == 0 && reinterpret_cast<uintptr_t>(out) % sizeof(typename Pair::P) == 0;
  auto val = [&](int i) {
    if constexpr (kBits) return cast_out<Out>(as_f(v[i]));
    else return cast_out<Out>(v[i]);
  };
#pragma unroll
  for (int i = 0; i < 128; i += 2) {
    const int r = r0 + 8 * ((i % 4) / 2), c = c0 + 8 * (i / 4);
    if (r >= M || c >= N) continue;
    Out* p = out + static_cast<int64_t>(r) * o.ldc + c;
    if (pairs && c + 1 < N) {
      *reinterpret_cast<typename Pair::P*>(p) = Pair::make(val(i), val(i + 1));
    } else {
      p[0] = val(i);
      if (c + 1 < N) p[1] = val(i + 1);
    }
  }
}

// kInt: integer outputs are possible (int8 inputs).
template <bool kInt, bool kBits, typename V>
__device__ __forceinline__ void ep_store(const V (&v)[128], const EpOut& o, int r0, int c0, int M,
                                         int N) {
  switch (o.out_code) {
    case kF32: ep_store_as<float, kBits>(v, o, r0, c0, M, N); break;
    case kBF16: ep_store_as<__nv_bfloat16, kBits>(v, o, r0, c0, M, N); break;
    case kF16: ep_store_as<__half, kBits>(v, o, r0, c0, M, N); break;
    default:
      if constexpr (kInt) {
        if (o.out_code == kI8) ep_store_as<signed char, kBits>(v, o, r0, c0, M, N);
        else ep_store_as<int, kBits>(v, o, r0, c0, M, N);
      }
      break;
  }
}

// A consumer warpgroup's 64 x 256 part of the tile at (row0, n0).  An int32
// sum meets the epilogue widened to fp32, as the plain version's int32 +
// fp32 promotes; without an epilogue it is stored as it is.
template <typename Acc>
__device__ void wg_put(Acc (&d)[128], const EpOut& o, int row0, int n0, int M, int N) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x % 128 / 32;
  const int r0 = row0 + 16 * warp + lane / 4, c0 = n0 + 2 * (lane % 4);
  constexpr bool kInt = std::is_same<Acc, int>::value;
  if (o.ep.kind == kEpNone) {
    ep_store<kInt, false>(d, o, r0, c0, M, N);
    return;
  }
  if constexpr (kInt) {
#pragma unroll
    for (int i = 0; i < 128; ++i) set_f(d[i], static_cast<float>(d[i]));
  }
  ep_apply(d, o.ep, o.cols + (threadIdx.x / 128 - 1) * kEpStage, n0, c0, N);
  ep_store<kInt, kInt>(d, o, r0, c0, M, N);
}

// The engine's stages and barriers, then both consumer warpgroups' column
// staging.
constexpr int kMxuWgSmem = kWgSmem + 2 * kEpStage * static_cast<int>(sizeof(float));

struct MxuWgArgs {
  CUtensorMap ma, mb;  // A and B as the caller holds them (launch parameters)
  void* c;
  int64_t ldc, c_step;  // C's row pitch (elements); bytes from C[z] to C[z + 1]
  int out_code;
  EpArgs ep;
  int M, N, K, batch, batch_maps;
  long long spin;
};

// MnA: A is held (K, M); MnB: B is held (K, N) (the main path's layout).
template <typename T, bool MnA, bool MnB>
__global__ void __launch_bounds__(kWgThreads, 1) mxu_wg_kernel(const __grid_constant__ MxuWgArgs g) {
  extern __shared__ unsigned char dyn_smem[];
  unsigned char* smem = wg_align(dyn_smem);
  WgBars* bars = reinterpret_cast<WgBars*>(smem + kWgStages * kWgStage);
  float* cols = reinterpret_cast<float*>(bars + 1);
  if (threadIdx.x == 0) wg_init_bars(bars);
  __syncthreads();
  const WgJob job{{&g.ma, &g.ma}, {&g.mb, &g.mb}, {nullptr, nullptr}, 0, 0, nullptr, nullptr,
                  nullptr, g.spin, g.M, g.N, g.K, g.batch, static_cast<int>(gridDim.x),
                  static_cast<int>(blockIdx.x), 1, g.batch_maps};
  wg_compute<T, MnA, MnB>(job, smem, bars, [&](int z) {
    return EpOut{static_cast<char*>(g.c) + z * g.c_step, g.ldc, g.out_code, g.ep, cols};
  });
}

// B1's and B2's operands: a / b at row pitch lda / ldb and batch stride
// sa / sb (elements; 0: a 2-D operand broadcast over the batch, or a batch
// of one), ta: A held (K, M), tb: B held (N, K); C (batch, M, N)
// row-major.
struct MxuWgCall {
  const void* a;
  const void* b;
  void* c;
  int batch, M, N, K;
  int64_t lda, ldb, sa, sb;
  int ta, tb, out_code;
  EpArgs ep;
};

// The map of one operand: MN-major (mn values contiguous, k rows) or
// K-major (rows of k, box_rows of them a box); 3-D over ``batch`` examples
// ``bs`` elements apart where bs != 0, else 2-D.
inline bool encode_operand(CUtensorMap* map, const void* base, bool mn_major, int rows, int k,
                           int64_t ld, int64_t bs, int batch, int esize, bool f16, int box_rows) {
  if (!bs) {
    return mn_major ? encode_mnmajor(map, base, k, rows, ld, f16)
                    : encode_kmajor(map, base, rows, k, esize, box_rows, ld, f16);
  }
  const int64_t strides[2] = {ld * esize, bs * esize};
  if (mn_major) {
    const int64_t dims[3] = {rows, k, batch};
    const int box[3] = {kWgRowBytes / 2, WgType<__nv_bfloat16>::BK, 1};
    return encode_nd(map, base, 3, dims, strides, box, 2, f16);
  }
  const int64_t dims[3] = {k, rows, batch};
  const int box[3] = {kWgRowBytes / esize, box_rows, 1};
  return encode_nd(map, base, 3, dims, strides, box, esize, f16);
}

constexpr int out_bytes(int code) { return code == kF32 || code == kI32 ? 4 : code == kI8 ? 1 : 2; }

// One persistent block a SM, at most one an (example, tile) pair.  Returns
// 0, a CUDA error, kUnsupported, or kTmaEncodeFailed.
template <typename T, bool MnA, bool MnB>
int launch_mxu_wg(const MxuWgCall& call, cudaStream_t st) {
  constexpr int esize = sizeof(T);
  constexpr bool f16 = std::is_same<T, __half>::value;
  // A batch stride of 0 is a 2-D map: no tensor map relies on a stride of 0.
  MxuWgArgs g{};
  const bool ok = encode_operand(&g.ma, call.a, MnA, call.M, call.K, call.lda, call.sa, call.batch,
                                 esize, f16, kWgBM) &&
                  encode_operand(&g.mb, call.b, MnB, call.N, call.K, call.ldb, call.sb, call.batch,
                                 esize, f16, kWgBN);
  if (!ok) return kTmaEncodeFailed;
  g.c = call.c;
  g.ldc = call.N;
  g.c_step = static_cast<int64_t>(call.M) * call.N * out_bytes(call.out_code);
  g.out_code = call.out_code;
  g.ep = call.ep;
  g.M = call.M;
  g.N = call.N;
  g.K = call.K;
  g.batch = call.batch;
  g.batch_maps = (call.sa ? 1 : 0) | (call.sb ? 2 : 0);
  g.spin = spin_cycles(10000);  // a stage wait is microseconds; 10 s means a lost load
  auto kern = mxu_wg_kernel<T, MnA, MnB>;
  static const int attr = static_cast<int>(
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMxuWgSmem));
  if (attr) return attr;
  int dev = 0, sms = 0;
  int err = cudaGetDevice(&dev);
  if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return err;
  const int64_t items = static_cast<int64_t>(call.batch) * ((call.M + kWgBM - 1) / kWgBM) *
                        ((call.N + kWgBN - 1) / kWgBN);
  if (items > INT_MAX) return kUnsupported;
  kern<<<static_cast<unsigned>(items < sms ? items : sms), kWgThreads, kMxuWgSmem, st>>>(g);
  return last_error();
}

// The four layouts of a 16-bit type.
template <typename T>
int launch_mxu_wg_16(const MxuWgCall& call, cudaStream_t st) {
  if (call.ta)
    return call.tb ? launch_mxu_wg<T, true, false>(call, st) : launch_mxu_wg<T, true, true>(call, st);
  return call.tb ? launch_mxu_wg<T, false, false>(call, st) : launch_mxu_wg<T, false, true>(call, st);
}

// Defined in mxu_wgmma_bf16.cu / mxu_wgmma_f16.cu (one translation unit a
// type, compiled side by side).
int launch_mxu_wg_bf16(const MxuWgCall& call, cudaStream_t st);
int launch_mxu_wg_f16(const MxuWgCall& call, cudaStream_t st);

}  // namespace gemm_hls
