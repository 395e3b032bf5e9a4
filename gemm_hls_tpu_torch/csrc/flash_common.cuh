// Shared pieces of the flash-attention kernels (csrc/flash_fwd.cu,
// csrc/flash_bwd_dq.cu, csrc/flash_bwd_dkv.cu): the strided sequence view,
// the argument block, the mask and its live ranges, and the tensor-core
// (mma.sync m16n8k16) and cp.async helpers.
//
// Conventions, the same as gemm_hls_tpu/ops/pallas_flash.py's and as the
// plain versions in gemm_hls_tpu_torch/ops/flash.py:
//   * a masked score is the finite kMask = -0.7 * FLT_MAX, so exp(m - m_new)
//     is never inf - inf; a masked probability is exactly 0, so a row that
//     every position masks (segment ids, offsets, a cache shorter than the
//     query chunk) ends with l = 0: o = 0 and lse = -inf;
//   * q row r and kv column c sit at positions q_off + causal_off + r and
//     kv_off + c; causal keeps kv_pos <= q_pos, a window also
//     kv_pos > q_pos - window; with kv_lengths and causal the queries are
//     anchored at the cache end (causal_off = kv_len - S_q);
//   * rows past the sequence ends, kv rows at or past the kv limit (the
//     sequence end, or kv_lengths: a padded cache's stale slots) and
//     head-dim columns past D are zero-filled in shared memory, never read
//     from device memory, so a stale value cannot reach a contraction as
//     0 * NaN (the forward's loads are bounded by Mask::kv_lim; the backward
//     takes no kv_lengths, so its limit is S_kv).
// Every mask choice (causal, window, kv_lengths, segment ids, offsets, the
// soft cap, the lse output) is a run-time argument: a template parameter per
// option would multiply each kernel's instantiations and the build time.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace gemm_hls {

constexpr float kMask = -0.7f * 3.40282347e38f;
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// Element (b, s, d) of a (B, S, D) view at p + (b / heads) * sb +
// (b % heads) * sh + s * ss + d, in elements: a packed (B, S, D) tensor has
// heads = 1, and the (batch, S, H, D) layout is read in place (heads = H),
// so no transpose is ever materialised.
struct Seq {
  const void* p;
  int heads;
  int64_t sb, sh, ss;
  __device__ __forceinline__ int64_t row(int b, int s) const {
    return (b / heads) * sb + (b % heads) * sh + static_cast<int64_t>(s) * ss;
  }
};

// Host layout of one Seq in the entry points' descriptor arrays:
// (pointer, heads, sb, sh, ss) as five int64.
inline Seq seq_from(const int64_t* d) {
  return Seq{reinterpret_cast<const void*>(d[0]), static_cast<int>(d[1]), d[2], d[3], d[4]};
}

struct FlashArgs {
  Seq q, k, v;
  Seq o;        // forward: the output; backward: dO
  Seq g0, g1;   // backward: dq (dq kernel) or dk, dv (dkv kernel)
  float* lse;   // (B, S_q) fp32, packed: the forward's output (may be null), the backward's input
  const float* delta;  // (B, S_q) fp32: sum_d dO * O
  const int* kv_len;   // (B_kv,) or null
  const int* q_seg;    // (B, S_q) or null
  const int* kv_seg;   // (B_kv, S_kv)
  const int* offs;     // (2,) (q_off, kv_off) or null
  int B, group, S_q, S_kv, D;
  int causal, window;  // window 0: none
  float cap, scale;    // cap 0: none
  int vec;             // every row start 16-byte aligned: cp.async tiles
  int b0;              // first head (fwd, dq) or kv head (dkv) of this launch
  int o_f32;           // forward: o stored in fp32 whatever q's type (the ring's partials)
};

// The dims block of the entry points: B, group, S_q, S_kv, D, causal,
// window, vec (the forward's block adds o_f32 as its ninth entry).
inline void dims_into(FlashArgs& a, const int* dims) {
  a.B = dims[0];
  a.group = dims[1];
  a.S_q = dims[2];
  a.S_kv = dims[3];
  a.D = dims[4];
  a.causal = dims[5];
  a.window = dims[6];
  a.vec = dims[7];
}

// Launches ``launch(args, n)`` over chunks of n <= kMaxGridZ heads (the
// grid's y limit), each chunk's first head in args.b0, checking each launch.
template <typename Launch>
int for_head_chunks(FlashArgs a, int heads, Launch&& launch) {
  for (int b0 = 0; b0 < heads; b0 += static_cast<int>(kMaxGridZ)) {
    a.b0 = b0;
    const int64_t left = heads - b0;
    launch(a, static_cast<unsigned>(left < kMaxGridZ ? left : kMaxGridZ));
    const int err = last_error();
    if (err) return err;
  }
  return 0;
}

// Validity of (q row r, kv column c) of one head, without segment ids:
// q_pos - kv_pos = qp0 + r - c.
struct Mask {
  int kv_lim;  // columns c >= kv_lim are masked (sequence end or kv_len)
  int causal, window;
  int qp0;
  __device__ __forceinline__ bool ok(int r, int c) const {
    if (c >= kv_lim) return false;
    if (causal) {
      const int dpos = qp0 + r - c;
      if (dpos < 0 || (window && dpos >= window)) return false;
    }
    return true;
  }
};

// The mask of head b (kv head b / group).  kv_lengths shortens the kv
// sequence and, with causal, anchors the queries at its end.
__device__ __forceinline__ Mask head_mask(const FlashArgs& a, int b) {
  Mask m{a.S_kv, a.causal, a.window, 0};
  int q_off = 0, kv_off = 0;
  if (a.offs) {
    q_off = a.offs[0];
    kv_off = a.offs[1];
  }
  int anchor = 0;
  if (a.kv_len) {
    const int len = a.kv_len[b / a.group];
    m.kv_lim = min(m.kv_lim, len);
    if (a.causal) anchor = len - a.S_q;
  }
  m.qp0 = q_off + anchor - kv_off;
  return m;
}

// Live kv columns [c_lo, c_hi) of q rows [r0, r1): no kv tile outside them
// is loaded (the predicate of pallas_flash.py::_live_blocks, as loop bounds).
__device__ __forceinline__ void kv_range(const Mask& m, int r0, int r1, int& c_lo, int& c_hi) {
  c_lo = 0;
  c_hi = m.kv_lim;
  if (m.causal) {
    c_hi = min(c_hi, m.qp0 + r1);
    if (m.window) c_lo = max(0, m.qp0 + r0 - m.window + 1);
  }
}

// Live q rows [r_lo, r_hi) of kv columns [c0, c1), S_q rows in all.
__device__ __forceinline__ void q_range(const Mask& m, int c0, int c1, int S_q, int& r_lo,
                                        int& r_hi) {
  r_lo = 0;
  r_hi = S_q;
  if (m.causal) {
    r_lo = max(0, c0 - m.qp0);
    if (m.window) r_hi = min(S_q, c1 - 1 - m.qp0 + m.window);
  }
}

// Every (r, c) of rows [r0, r0 + nr) x columns [c0, c0 + nc) is valid under
// the position mask: such a tile skips the per-element mask (B7's
// "interior" flag, pallas_flash.py:296-304).  Rows past S_q are included
// (their results are never stored), which only makes the test stricter.
__device__ __forceinline__ bool interior(const Mask& m, int r0, int nr, int c0, int nc) {
  if (c0 + nc > m.kv_lim) return false;
  if (!m.causal) return true;
  if (m.qp0 + r0 - (c0 + nc - 1) < 0) return false;
  return !m.window || m.qp0 + (r0 + nr - 1) - c0 < m.window;
}

// Soft-capped, scaled score of the fp32 product x.
__device__ __forceinline__ float score(float x, float scale, float cap) {
  const float s = x * scale;
  return cap > 0.f ? cap * tanhf(s / cap) : s;
}

// ---- tensor-core helpers ---------------------------------------------------

template <typename T> struct MmaType;
template <> struct MmaType<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ float load(const void* p, int64_t i) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  }
  static __device__ __forceinline__ void store(void* p, int64_t i, float x) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(x);
  }
};
template <> struct MmaType<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ float load(const void* p, int64_t i) {
    return __half2float(static_cast<const __half*>(p)[i]);
  }
  static __device__ __forceinline__ void store(void* p, int64_t i, float x) {
    static_cast<__half*>(p)[i] = __float2half(x);
  }
};

// D = A (16x16, row) . B (16x8, col) + D in fp32.
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ uint32_t fsmem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(fsmem(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(fsmem(p)));
}

__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(fsmem(dst)), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [s0, s0 + ROWS) of head b of ``x`` (16-bit elements) into a shared
// tile of ROWS x DMAX at a pitch of DMAX + 8 elements (conflict-free
// ldmatrix), by all NT threads of the block: cp.async 16-byte chunks where
// every row start is 16-byte aligned (``vec``), element copies otherwise.
// Rows past ``S`` and columns past ``D`` are zeros, so the kernels run every
// 16-deep step of DMAX (a run-time bound would make each ldmatrix + MMA
// step its own basic block: flash_fwd ran 1.5x slower).  With ``vec`` the
// copies are only issued: the caller commits and waits.
template <int ROWS, int DMAX, int NT>
__device__ __forceinline__ void load_tile16(uint16_t* tile, const Seq& x, int b, int s0, int S,
                                            int D, int vec) {
  constexpr int P = DMAX + 8, CPR = DMAX / 8;  // 16-byte chunks per row
  const uint16_t* base = static_cast<const uint16_t*>(x.p);
  for (int ch = threadIdx.x; ch < ROWS * CPR; ch += NT) {
    const int r = ch / CPR, col = (ch % CPR) * 8, s = s0 + r;
    uint16_t* dst = tile + r * P + col;
    const bool live = s < S && col < D;
    if (vec) {
      const int bytes = live ? 2 * min(8, D - col) : 0;
      cp16(dst, live ? base + x.row(b, s) + col : base, bytes);
    } else {
      uint4 z = make_uint4(0u, 0u, 0u, 0u);
      uint16_t* e = reinterpret_cast<uint16_t*>(&z);
      if (live) {
        const uint16_t* src = base + x.row(b, s) + col;
        for (int i = 0; i < 8 && col + i < D; ++i) e[i] = src[i];
      }
      *reinterpret_cast<uint4*>(dst) = z;
    }
  }
}

// ---- CUDA-core (fp32) helpers ----------------------------------------------

// Rows [s0, s0 + ROWS) of head b of fp32 ``x`` into a shared ROWS x (DMAX + 1)
// tile (the odd pitch keeps column reads of neighbouring rows in different
// banks); zeros past S and D.
template <int ROWS, int DMAX, int NT>
__device__ __forceinline__ void load_tile32(float* tile, const Seq& x, int b, int s0, int S,
                                            int D) {
  const float* base = static_cast<const float*>(x.p);
  for (int i = threadIdx.x; i < ROWS * DMAX; i += NT) {
    const int r = i / DMAX, col = i % DMAX, s = s0 + r;
    tile[r * (DMAX + 1) + col] = (s < S && col < D) ? base[x.row(b, s) + col] : 0.f;
  }
}

}  // namespace gemm_hls
