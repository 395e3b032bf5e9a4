// Kernel dequant_gemm: y[M, N] = x[M, K] . dequant(w_q, s), the weights
// streamed quantized (int8, or int4 packed two to a byte) and expanded in
// the kernel.
//
// The calls ops/dequant.py::dequant_route does not send to the Hopper tile
// engine (csrc/dequant_wgmma.cu) run here: fp32 x (dequant_simt), and bf16
// / fp16 x whose rows or packed weight rows are not whole 16-byte units
// (N = 1001, ragged N) or whose scale groups do not tile the engine's
// 128-deep K step (dequant_tc).  The serving decode's projections run on
// the engine.
//
// Replaces gemm_hls_tpu/ops/pallas_dequant.py::_dequant_kernel (B13).  The
// TPU kernel walked K as a sequential grid axis into a VMEM accumulator;
// here a block loops over its K range itself and keeps the accumulator in
// registers.  Weights: int8 (K, N), or planar int4 (K/2, N): byte row i of
// a K-group of g rows holds row i in its low nibble and row i + g/2 in its
// high nibble, both sign-extended ((v << 28) >> 28 and v >> 4 on the
// sign-extended byte; the TPU kernel's detour through int32 was a Mosaic
// workaround).  Scales: group-wise ones are folded into the weights as they
// are expanded, w = (q * s) rounded to the compute type (the TPU kernel's
// form when a K-block holds several groups, and the decode default); a
// per-channel scale multiplies the fp32 accumulator at the store (exact
// fold: sum_k x q s = s sum_k x q).
//
// Routes by x's type: bf16 / fp16 -> tensor cores (mma.sync m16n8k16, fp32
// accumulators), a 64 x 64 block tile by four warps, K steps of 64: x tiles
// by cp.async, weight tiles fetched into registers (bytes and scales) while
// the previous step's MMAs issue, expanded into shared memory after them,
// double-buffered.  fp32 -> CUDA cores (fp32 FMA) on the same tile.
//
// What bounds it on an H100: at decode (M = 64 rows) the weight bytes.  A
// (2048, 2048) int4 g128 projection moves 2 MB of weights, 128 KB of
// scales, 256 KB of x and 256 KB of y: 0.8 us at 3.35 TB/s, under one
// launch.  64 x 64 tiles give only 32 blocks there, so a launch with fewer
// tiles than the card has SMs splits K (grid z); each split writes fp32
// partials and a second pass sums them in split order (deterministic, no
// atomics) and applies the store.  The engine route has the wgmma, TMA and
// one-launch split-K sum; left on the table here: a persistent schedule.
#include "tile_mma.cuh"

namespace gemm_hls {

constexpr int DBM = 64, DBN = 64, DBK = 64, DT = 128;
constexpr int DPA = DBK + 8, DPB = DBN + 8;  // shared pitches (16-bit elements)
constexpr int DCH = DBK * DBN / 8 / DT;      // 8-column weight chunks a thread loads

struct Dequant {
  const void* x;             // (M, K), compute type
  const signed char* wq;     // (K, N) int8 or (K/2, N) planar int4
  const float* s;            // (n_groups, N)
  void* out;                 // (M, N), out_code
  float* ws;                 // (splits, M, N) fp32 partials, or null
  int M, N, K, bits, group, n_groups, kchunk, out_code, vec;
};

// The raw bytes and scales of one 8-column weight chunk (row k, columns n ..
// n + 7), fetched ahead of the MMAs that hide their latency.
struct WChunk {
  uint32_t b[2];
  float s[8];
};

__device__ __forceinline__ void wfetch(WChunk& c, const Dequant& d, int k, int n, int k_lim) {
  c.b[0] = c.b[1] = 0u;
  if (d.n_groups > 1)
#pragma unroll
    for (int i = 0; i < 8; ++i) c.s[i] = 0.f;
  if (k >= k_lim || n >= d.N) return;
  int64_t row = k;
  if (d.bits == 4) {
    const int h = d.group / 2, i = k % d.group;
    row = static_cast<int64_t>(k / d.group) * h + (i % h);
  }
  const signed char* src = d.wq + row * d.N + n;
  if (n + 8 <= d.N && d.N % 8 == 0) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
    c.b[0] = v.x;
    c.b[1] = v.y;
  } else {
    unsigned char* e = reinterpret_cast<unsigned char*>(c.b);
    for (int i = 0; i < 8 && n + i < d.N; ++i) e[i] = static_cast<unsigned char>(src[i]);
  }
  if (d.n_groups > 1) {
    const float* sp = d.s + static_cast<int64_t>(k / d.group) * d.N + n;
    if (n + 8 <= d.N && d.N % 4 == 0) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(sp));
      const float4 b = __ldg(reinterpret_cast<const float4*>(sp + 4));
      c.s[0] = a.x, c.s[1] = a.y, c.s[2] = a.z, c.s[3] = a.w;
      c.s[4] = b.x, c.s[5] = b.y, c.s[6] = b.z, c.s[7] = b.w;
    } else {
      for (int i = 0; i < 8 && n + i < d.N; ++i) c.s[i] = __ldg(sp + i);
    }
  }
}

// Element i of the chunk as the float the kernel multiplies: q (int8 or the
// row's nibble), times the group's scale when scales are group-wise.
__device__ __forceinline__ float wvalue(const WChunk& c, const Dequant& d, int k, int i) {
  const int v = static_cast<signed char>((c.b[i / 4] >> (8 * (i % 4))) & 0xffu);
  int q = v;
  if (d.bits == 4)
    q = (k % d.group) < d.group / 2 ? static_cast<int>(static_cast<unsigned>(v) << 28) >> 28
                                    : v >> 4;
  const float f = static_cast<float>(q);
  return d.n_groups > 1 ? __fmul_rn(f, c.s[i]) : f;
}

template <typename T>
__device__ __forceinline__ void wstore16(uint16_t* tile, const WChunk& c, const Dequant& d, int k,
                                         int kr, int nc) {
  uint4 z;
  uint32_t* w = reinterpret_cast<uint32_t*>(&z);
#pragma unroll
  for (int p = 0; p < 4; ++p) w[p] = MmaType<T>::pack(wvalue(c, d, k, 2 * p), wvalue(c, d, k, 2 * p + 1));
  *reinterpret_cast<uint4*>(tile + kr * DPB + nc) = z;
}

// Chunk j of this thread in a K step: row kr, first column nc of the tile.
__device__ __forceinline__ void chunk_at(int j, int& kr, int& nc) {
  const int ch = threadIdx.x + j * DT;
  kr = ch / (DBN / 8);
  nc = (ch % (DBN / 8)) * 8;
}

__device__ __forceinline__ void store_result(const Dequant& d, int row, int col, float v) {
  if (row >= d.M || col >= d.N) return;
  const int64_t idx = static_cast<int64_t>(row) * d.N + col;
  if (d.ws) {
    d.ws[blockIdx.z * static_cast<int64_t>(d.M) * d.N + idx] = v;
    return;
  }
  if (d.n_groups == 1) v = __fmul_rn(v, d.s[col]);
  store_out(d.out, idx, v, d.out_code);
}

template <typename T>
__global__ void __launch_bounds__(DT) dequant_tc(const Dequant d) {
  __shared__ __align__(128) uint16_t As[2][DBM * DPA];
  __shared__ __align__(128) uint16_t Bs[2][DBK * DPB];
  const int warp = threadIdx.x / 32;
  const int wm0 = (warp % 2) * 32, wn0 = (warp / 2) * 32;
  const int m0 = blockIdx.y * DBM, n0 = blockIdx.x * DBN;
  const int kb = blockIdx.z * d.kchunk, ke = min(d.K, kb + d.kchunk);
  const int steps = (ke - kb + DBK - 1) / DBK;
  const uint16_t* x = static_cast<const uint16_t*>(d.x);

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  WChunk wc[DCH];
  if (steps > 0) {
    load16<DBM, DBK, DPA, DT>(As[0], x, d.K, m0, 0, d.M, kb, ke, d.vec);
#pragma unroll
    for (int j = 0; j < DCH; ++j) {
      int kr, nc;
      chunk_at(j, kr, nc);
      wfetch(wc[j], d, kb + kr, n0 + nc, ke);
      wstore16<T>(Bs[0], wc[j], d, kb + kr, kr, nc);
    }
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    const int cur = t & 1, k1 = kb + (t + 1) * DBK;
    const bool more = t + 1 < steps;
    if (more) {
      load16<DBM, DBK, DPA, DT>(As[cur ^ 1], x, d.K, m0, 0, d.M, k1, ke, d.vec);
#pragma unroll
      for (int j = 0; j < DCH; ++j) {
        int kr, nc;
        chunk_at(j, kr, nc);
        wfetch(wc[j], d, k1 + kr, n0 + nc, ke);
      }
    }
    cp_commit();
#pragma unroll
    for (int kk = 0; kk < DBK; kk += 16)
      mma_step<T, 2, 4, false, DPA, DPB>(acc, As[cur], Bs[cur], wm0, wn0, kk);
    if (more) {
#pragma unroll
      for (int j = 0; j < DCH; ++j) {
        int kr, nc;
        chunk_at(j, kr, nc);
        wstore16<T>(Bs[cur ^ 1], wc[j], d, k1 + kr, kr, nc);
      }
    }
    cp_wait<0>();
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store_result(d, m0 + acc_row(wm0, mt, e), n0 + acc_col(wn0, nt, e), acc[mt][nt][e]);
}

__global__ void __launch_bounds__(SIMT_T) dequant_simt(const Dequant d) {
  __shared__ __align__(16) float As[DBK * SIMT_P];
  __shared__ __align__(16) float Bs[DBK * SIMT_P];
  const int m0 = blockIdx.y * DBM, n0 = blockIdx.x * DBN;
  const int kb = blockIdx.z * d.kchunk, ke = min(d.K, kb + d.kchunk);
  float acc[8][4] = {};
  for (int k0 = kb; k0 < ke; k0 += DBK) {
    __syncthreads();
    load32<DBK>(As, static_cast<const float*>(d.x), d.K, true, m0, 0, d.M, k0, ke);
#pragma unroll
    for (int j = 0; j < DCH; ++j) {
      int kr, nc;
      chunk_at(j, kr, nc);
      WChunk c;
      wfetch(c, d, k0 + kr, n0 + nc, ke);
#pragma unroll
      for (int i = 0; i < 8; ++i) Bs[kr * SIMT_P + nc + i] = wvalue(c, d, k0 + kr, i);
    }
    __syncthreads();
    simt_steps<DBK>(acc, As, Bs, min(DBK, ke - k0));
  }
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) store_result(d, m0 + ty * 8 + i, n0 + tx * 4 + j, acc[i][j]);
}

// The split-K sum: splits' partials added in split order, then the store.
__global__ void dequant_reduce(const Dequant d, int splits) {
  const int64_t mn = static_cast<int64_t>(d.M) * d.N;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; idx < mn;
       idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float v = d.ws[idx];
    for (int z = 1; z < splits; ++z) v = __fadd_rn(v, d.ws[z * mn + idx]);
    if (d.n_groups == 1) v = __fmul_rn(v, d.s[idx % d.N]);
    store_out(d.out, idx, v, d.out_code);
  }
}

}  // namespace gemm_hls

using namespace gemm_hls;

// x (M, K) in ``x_code``'s type, w_q (K, N) int8 (bits 8) or (K/2, N)
// planar int4 (bits 4, packed per group of ``group`` rows), s (n_groups, N)
// fp32 (n_groups 1: per-channel), out (M, N) in ``out_code``'s type.  With
// splits > 1, ws is an (splits, M, N) fp32 workspace and K is cut into
// splits chunks of whole 64-deep steps.  vec: x's base 16-byte aligned and
// K a multiple of 8.  Returns 0, a CUDA error code, or -1 for a type no
// kernel is built for.
extern "C" int dequant_gemm(const void* x, const void* wq, const void* s, void* out, void* ws,
                            int M, int N, int K, int bits, int group, int n_groups, int splits,
                            int x_code, int out_code, int vec, void* stream) {
  if ((bits != 8 && bits != 4) || group < 1 || splits < 1 || (splits > 1 && !ws))
    return kUnsupported;
  const int steps = (K + DBK - 1) / DBK, per = (steps + splits - 1) / splits;
  Dequant d{x, static_cast<const signed char*>(wq), static_cast<const float*>(s), out,
            splits > 1 ? static_cast<float*>(ws) : nullptr, M, N, K, bits, group, n_groups,
            per * DBK, out_code, vec};
  const int64_t gy = (M + DBM - 1) / DBM;
  if (gy > 65535) return kUnsupported;
  const dim3 grid((N + DBN - 1) / DBN, static_cast<unsigned>(gy), splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_code) {
    case kBF16: dequant_tc<__nv_bfloat16><<<grid, DT, 0, st>>>(d); break;
    case kF16: dequant_tc<__half><<<grid, DT, 0, st>>>(d); break;
    case kF32: dequant_simt<<<grid, SIMT_T, 0, st>>>(d); break;
    default: return kUnsupported;
  }
  int err = last_error();
  if (err || splits == 1) return err;
  const int64_t mn = static_cast<int64_t>(M) * N;
  const int64_t want = (mn + 255) / 256;
  const unsigned blocks = static_cast<unsigned>(want < 4096 ? want : 4096);
  dequant_reduce<<<blocks, 256, 0, st>>>(d, splits);
  return last_error();
}
