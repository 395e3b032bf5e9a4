// What the flash kernels on Hopper's tile engine share: the forward
// (csrc/flash_wgmma.cu, B6-B8) and the backward pair (csrc/flash_bwd_wgmma.cu,
// B9-B12).  The wgmma forms of attention, the persistent walk of items in
// rounds of alternating direction, the mask as two bounds a row (or, in the
// backward's transposed products, a kv row), the TMA store and the 4-D
// (D, H, S, batch) tensor maps of a sequence view.  Conventions as in
// csrc/flash_common.cuh; the engine's TMA, mbarrier and descriptor helpers
// are csrc/wgmma_tile.cuh's.
#pragma once

#include "wgmma_tile.cuh"

namespace gemm_hls {

constexpr int kFwThreads = 384;

// ---- the wgmma forms of attention ------------------------------------------

#define FW_R64 \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define FW_R32 \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define FW_F32(d, o) \
    "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), \
    "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7]), \
    "+f"(d[o + 8]), "+f"(d[o + 9]), "+f"(d[o + 10]), "+f"(d[o + 11]), \
    "+f"(d[o + 12]), "+f"(d[o + 13]), "+f"(d[o + 14]), "+f"(d[o + 15]), \
    "+f"(d[o + 16]), "+f"(d[o + 17]), "+f"(d[o + 18]), "+f"(d[o + 19]), \
    "+f"(d[o + 20]), "+f"(d[o + 21]), "+f"(d[o + 22]), "+f"(d[o + 23]), \
    "+f"(d[o + 24]), "+f"(d[o + 25]), "+f"(d[o + 26]), "+f"(d[o + 27]), \
    "+f"(d[o + 28]), "+f"(d[o + 29]), "+f"(d[o + 30]), "+f"(d[o + 31])

// S (64 x 128 of this warpgroup, 64 a thread) (+)= q . k^T for one k16
// slice, both operands K-major in shared memory; scale_d 0 overwrites.
template <typename T>
__device__ __forceinline__ void fw_qk(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {" FW_R64
        "}, %64, %65, p, 1, 1, 0, 0;\n}"
        : FW_F32(d, 0), FW_F32(d, 32)
        : "l"(da), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" FW_R64
        "}, %64, %65, p, 1, 1, 0, 0;\n}"
        : FW_F32(d, 0), FW_F32(d, 32)
        : "l"(da), "l"(db), "r"(scale_d));
  }
}

// The backward's score tiles (64 x 64 of this warpgroup, 32 a thread) (+)=
// A . B^T for one k16 slice, both operands K-major in shared memory: S = q
// k^T and dP = dO v^T (dq), S^T = k q^T and dP^T = v dO^T (dk, dv).  Half
// the registers of fw_qk's 64-wide tile, where the backward's two D-wide
// sums leave no room for 64.
template <typename T>
__device__ __forceinline__ void fw_ss64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {" FW_R32
        "}, %32, %33, p, 1, 1, 0, 0;\n}"
        : FW_F32(d, 0)
        : "l"(da), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" FW_R32
        "}, %32, %33, p, 1, 1, 0, 0;\n}"
        : FW_F32(d, 0)
        : "l"(da), "l"(db), "r"(scale_d));
  }
}

// O (64 x DMAX of this warpgroup, DMAX / 2 a thread) += P . V for one k16
// slice of kv: P from registers (the m16n8k16 A fragment of each warp's 16
// rows), V MN-major in shared memory (transpose bit set).  The backward's
// dq += ds k, dv += p^T dO and dk += ds^T q take the same form.
template <typename T, int DMAX>
__device__ __forceinline__ void fw_pv(float (&d)[DMAX / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DMAX == 128) {
    if constexpr (std::is_same<T, __half>::value) {
      asm volatile(
          "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {" FW_R64
          "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}"
          : FW_F32(d, 0), FW_F32(d, 32)
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
    } else {
      asm volatile(
          "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" FW_R64
          "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}"
          : FW_F32(d, 0), FW_F32(d, 32)
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
    }
  } else {
    if constexpr (std::is_same<T, __half>::value) {
      asm volatile(
          "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {" FW_R32
          "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
          : FW_F32(d, 0)
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
    } else {
      asm volatile(
          "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" FW_R32
          "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
          : FW_F32(d, 0)
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
    }
  }
}
#undef FW_R64
#undef FW_R32
#undef FW_F32

// The A fragments of the next product from a 64-column accumulator
// fragment (m64nN: value x at row 8 ((x % 4) / 2) of the thread's pair,
// column 8 (x / 4) + 2 (lane % 4) + x % 2): k16 slice kk is values 8 kk ..
// 8 kk + 7, rounded to T.  The probabilities (P, p^T) and ds (ds, ds^T)
// meet their second product this way, in the input type as the TPU kernels'
// astype does.
template <typename T, int KK>
__device__ __forceinline__ void fw_pack(uint32_t (&a)[KK][4], const float* s) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    a[kk][0] = MmaType<T>::pack(s[8 * kk + 0], s[8 * kk + 1]);
    a[kk][1] = MmaType<T>::pack(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = MmaType<T>::pack(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = MmaType<T>::pack(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// ---- the walk --------------------------------------------------------------

// This block's item of round r, or -1: the rounds alternate direction
// (block c takes items c, 2 grid - 1 - c, 2 grid + c, ...), so a block that
// took one of the longest causal items takes one of the shortest next.
__device__ __forceinline__ int fw_round_item(int r, int items) {
  const int g = gridDim.x, b = blockIdx.x;
  const int i = r * g + ((r & 1) ? g - 1 - b : b);
  return i < items ? i : -1;
}

// Item i of a q-major walk (the forward, dq): head b (kv head kvh), q rows
// [q0, q0 + bq), live kv tiles [j_lo, j_hi) of ``bkv`` rows (none: every
// row is masked).  The longest causal items come first: item i is q tile
// n_qt - 1 - i / B of head i % B.
struct FwItem {
  int b, kvh, q0, j_lo, j_hi;
  Mask mask;
};

__device__ __forceinline__ FwItem fw_item(const FlashArgs& a, int n_qt, int i, int bq, int bkv) {
  FwItem it;
  it.b = i % a.B;
  it.kvh = it.b / a.group;
  it.q0 = (n_qt - 1 - i / a.B) * bq;
  it.mask = head_mask(a, it.b);
  int c_lo, c_hi;
  kv_range(it.mask, it.q0, min(it.q0 + bq, a.S_q), c_lo, c_hi);
  it.j_lo = c_lo / bkv;
  it.j_hi = c_hi > c_lo ? (c_hi + bkv - 1) / bkv : it.j_lo;
  return it;
}

// Columns [c_min, c_max) of q row r pass the position mask (Mask::ok as two
// bounds a row: the kv limit, causal, window), set once an item.
__device__ __forceinline__ void row_bounds(const Mask& m, int r, int& c_min, int& c_max) {
  c_min = 0;
  c_max = m.kv_lim;
  if (m.causal) {
    c_max = min(c_max, m.qp0 + r + 1);
    if (m.window) c_min = max(0, m.qp0 + r - m.window + 1);
  }
}

// The transposed bounds: q rows [r_min, r_max) of kv row c pass the
// position mask and lie before S_q (a kv row past the kv limit has none).
__device__ __forceinline__ void col_bounds(const Mask& m, int c, int S_q, int& r_min, int& r_max) {
  r_min = 0;
  r_max = c < m.kv_lim ? S_q : 0;
  if (m.causal) {
    r_min = max(0, c - m.qp0);
    if (m.window) r_max = min(r_max, c - m.qp0 + m.window);
  }
}

// ---- stores and maps --------------------------------------------------------

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, %3, %4}], [%5];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(src))
      : "memory");
}

// One warpgroup's 64 x DMAX accumulator fragment (``acc``, DMAX / 2 a
// thread; row h of the thread's pair times ``mul[h]``) rounded to T into a
// staging tile of 64-row boxes of 64 columns, ``pitch`` bytes apart, in the
// 128-byte swizzle of the output's map (16-byte unit u of row r at
// u ^ (r % 8): no bank conflict), ready for TMA stores.
template <typename T, int DMAX>
__device__ __forceinline__ void fw_stage(unsigned char* stage, const float* acc,
                                         const float (&mul)[2], int pitch = kWgMnBox) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, tq = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rs = 16 * warp + lane / 4 + 8 * h;
#pragma unroll
    for (int jj = 0; jj < DMAX / 8; ++jj)
      *reinterpret_cast<uint32_t*>(stage + (jj / 8) * pitch + rs * kWgRowBytes +
                                   ((jj % 8) ^ (rs % 8)) * 16 + 4 * tq) =
          MmaType<T>::pack(acc[4 * jj + 2 * h] * mul[h], acc[4 * jj + 2 * h + 1] * mul[h]);
  }
}

// The (D, H, S, batch) map of a sequence view with ``B`` heads of S rows:
// boxes of 64 columns by ``rows`` rows.  A 3-D view (heads 1, no head
// stride) takes its row pitch as the head stride, which dimension 1 of
// extent 1 never uses.
inline bool encode_seq(CUtensorMap* map, const Seq& x, int B, int S, int D, bool f16, int rows) {
  const int64_t dims[4] = {D, x.heads, S, B / x.heads};
  const int64_t strides[3] = {2 * (x.heads > 1 ? x.sh : x.ss), 2 * x.ss, 2 * x.sb};
  const int box[4] = {64, 1, rows, 1};
  return encode_nd(map, x.p, 4, dims, strides, box, 2, f16);
}

// The current device's SMs into ``sms``; a CUDA error code or 0.
inline int sm_count(int& sms) {
  int dev = 0;
  int err = cudaGetDevice(&dev);
  if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

// Launches ``kern`` as one persistent block a SM (at most ``items``), 384
// threads and ``smem`` bytes of dynamic shared memory.
template <typename K, typename G>
int launch_persistent(K kern, const G& g, int smem, int64_t items, cudaStream_t st) {
  const int attr = static_cast<int>(
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (attr) return attr;
  int sms = 0;
  const int err = sm_count(sms);
  if (err) return err;
  if (items > INT_MAX) return kUnsupported;
  if (items < 1) return 0;
  kern<<<static_cast<unsigned>(items < sms ? items : sms), kFwThreads, smem, st>>>(g);
  return last_error();
}

}  // namespace gemm_hls
