// The Hopper tile engine: a warp-specialised block that walks its share of
// (step, tile) pairs, loading A and B K-slabs by TMA into a ring of
// shared-memory stages and multiplying them with wgmma.  Its users:
//   * the fused distributed GEMMs (csrc/ring_gemm.cu, B18;
//     csrc/cannon_gemm.cu, B19): a rank's steps, each gated on recv flags
//     and acknowledged through done[] (and Cannon's per-tile flags);
//   * the dense GEMM B1 and the batched GEMM B2 (csrc/mxu_wgmma.cuh): no
//     flags (a WgJob with null recv / done / tile_flags; the producer and
//     the consumers test them once a step, outside the K loop), one step
//     for B1 and one step an example for B2 (a 3-D operand is read through
//     a 3-D map at the step's batch coordinate, a broadcast 2-D one
//     through a 2-D map), its operands K-major or MN-major as the caller
//     holds them, the epilogue applied at the store.
// The Ozaki slice GEMM B5 (csrc/int8_slices.cu) keeps its own walk over
// (K block, diagonal, slice pair) on the same primitives; the grouped GEMM
// B16 (csrc/grouped_wgmma.cu) and its weight gradient B17
// (csrc/grouped_update_wgmma.cu) their walks over (group, tile) jobs on the
// same block, stages and products; the flash forward B6
// (csrc/flash_wgmma.cu) its own block on the TMA loads, the barriers and
// the descriptors, with the attention products' wgmma forms.
//
// Block of 384 threads, one a SM (192 KB of stages):
//   * warpgroup 0, the producer, gives up registers (setmaxnreg 40); one
//     thread of it waits for a step's operands to arrive (recv flags, an
//     acquire load, then fence.proxy.async.global: the TMA engine reads
//     through the async proxy what other SMs wrote through the generic or
//     the bulk-copy path) and issues cp.async.bulk.tensor loads of a
//     128-row A box and a 256-row B box per K-slab into a 4-stage ring,
//     each stage with a full and an empty mbarrier;
//   * warpgroups 1 and 2, the consumers (setmaxnreg 232), each own 64 rows
//     of the 128 x 256 tile: per stage, four wgmma.mma_async of m64n256 --
//     k16 bf16 / fp16 with fp32 sums, or k32 s8 x s8 -> s32 -- on
//     128-byte-swizzled slabs, one wgmma group kept in flight, a stage
//     released once the group that read it has retired.  The tile's sums
//     stay in registers (128 a thread) and go out from there (TileOut,
//     dist_tile.cuh; B1's EpOut).  ptxas reports such a kernel at 168
//     registers, what 384 threads may hold at launch; setmaxnreg is what
//     gives the consumers more (a block of 288 threads, whose warps the
//     card allocates in fours, is held to 168 all the same).
// Operand layouts: a K-major slab row holds 128 bytes of K (64 16-bit or
// 128 int8 values: the swizzle's whole row), one box of 128 or 256 rows.
// An MN-major 16-bit operand (B1's row-major B, or A read transposed) is
// loaded as boxes of 64 M or N values (128 bytes) by 64 K rows, 8 KB each,
// and wgmma reads it through its transpose bit; int8 wgmma reads K-major
// operands only.
// K is summed in one fixed order (stage by stage, k16 / k32 within it):
// no split-K, no atomics on data, so every launch and every TPU block_k
// gives the same bits.  Ragged M, N and K are zero-filled by TMA.
//
// The walk: a rank's n_comp compute blocks take its steps x tiles pairs
// in flattened order, pair i to block i mod n_comp, so a wave left over in
// one step is filled from the next (at 4 ranks of bf16 8192^3, 512 pairs
// over 31 blocks: 17 waves, where per-step round robin ran 4 x 5).  Every
// block's share of a step is whole before it signals done[s]: its
// consumers' last wgmma reading the step's buffer has retired
// (wgmma.wait_group 0), and a named barrier over both consumer warpgroups
// comes before the signal, so the ack that frees the buffer never
// overtakes a read.  A tile may be computed at consecutive steps by
// different blocks; where the step reads the tile's running sum (Cannon),
// each consumer warpgroup counts its half on a per-tile flag, and the next
// step's warpgroup waits for both halves before it reads.  B1 is one step
// over persistent blocks, one a SM, so the order of tile_origin (groups of
// 8 tile rows) keeps a wave's A and B panels in the L2, and a tile's store
// overlaps the producer's loads of the next tile.  B2 is one step an
// example: a wave takes the tiles of a few neighbouring examples, and a
// batch past gridDim's limits needs no chunking.
//
// No flag wait or __syncthreads() follows the role split: a barrier over
// the whole block there would deadlock against the producer's loop.  The
// waits are thread-scoped, spread by named barriers (1: both consumer
// warpgroups; 2 and 3: one each).
#pragma once

#include <cuda.h>

#include <vector>

#include "dist_tile.cuh"

namespace gemm_hls {

constexpr int kWgBM = 128, kWgBN = 256;   // the tile
constexpr int kWgRowBytes = 128;          // one K-slab row: the 128-byte swizzle's row
constexpr int kWgStages = 4, kWgThreads = 384;
// An MN-major box: 64 values of M or N (128 bytes) by the 64 K rows of a
// 16-bit slab.
constexpr int kWgMnBox = 64 * kWgRowBytes;
constexpr int kWgTileA = kWgBM * kWgRowBytes, kWgTileB = kWgBN * kWgRowBytes;
constexpr int kWgStage = kWgTileA + kWgTileB;  // 48 KB
// A sender block reuses the stages as its bulk-copy slots.
constexpr int kWgSendSlots = 6, kWgSendChunk = kWgStages * kWgStage / kWgSendSlots;
// Vector loads in flight a thread in the staging transpose (stage_rows):
// its tile fits the first stage, where Cannon's skew keeps it clear of
// the bulk slots.
constexpr int kWgStageV = 6;
static_assert(stage_tile_bytes<kWgThreads, kWgStageV>() <= kWgStage, "staging tile");

struct WgBars {
  uint64_t full[kWgStages], empty[kWgStages], send[kWgSendSlots];
};
// 1024 bytes of slack align the stages to the swizzle's 1024-byte period.
constexpr int kWgSmem = 1024 + kWgStages * kWgStage + static_cast<int>(sizeof(WgBars));

template <typename T> struct WgType;
template <> struct WgType<__nv_bfloat16> {
  using Acc = float;
  static constexpr int BK = 64;
};
template <> struct WgType<__half> {
  using Acc = float;
  static constexpr int BK = 64;
};
template <> struct WgType<signed char> {
  using Acc = int;
  static constexpr int BK = 128;
};

__device__ __forceinline__ unsigned char* wg_align(unsigned char* dyn) {
  return dyn + ((1024 - (smem_u32(dyn) & 1023)) & 1023);
}

// ---- TMA and wgmma ---------------------------------------------------------

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// shared -> global: a box at (c0, c1) of a 2-D map, in the bulk group the
// caller commits (W8A8's output tile, csrc/w8a8_wgmma.cu).
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(smem_u32(src))
      : "memory");
}

// The 3-D and 4-D loads: the batched GEMM's examples and the grouped
// GEMM's experts (the example or group as the last coordinate,
// csrc/mxu_wgmma.cuh, csrc/grouped_wgmma.cu) and the flash forward's (D, H,
// S, batch) sequences (csrc/flash_wgmma.cu).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// The maps sit in a device buffer the host wrote before the launch; the
// tensormap proxy may cache an earlier launch's map at the same address.
__device__ __forceinline__ void tensormap_acquire(const CUtensorMap* map) {
#if CUDART_VERSION >= 12030
  asm volatile("fence.proxy.tensormap::generic.acquire.gpu [%0], 128;" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
#endif
}

// Shared-memory matrix descriptor of a K-major slab written by TMA with the
// 128-byte swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO),
// leading offset unused (1).  Adding 2 (32 bytes) steps one k16 (16-bit) or
// k32 (int8) slice along K inside the swizzled row.
__device__ __forceinline__ uint64_t wg_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}
// The descriptor of an MN-major 16-bit slab: kWgMnBox boxes of 64 values
// (one 128-byte swizzled row) by 64 K rows, side by side along M or N, so
// the leading offset (LBO) is the box, 8192 bytes, and the 8-row K groups
// are 1024 bytes apart (SBO).  Adding 128 (2048 bytes: 16 K rows) steps
// one k16 slice.
__device__ __forceinline__ uint64_t wg_desc_mn(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kWgMnBox >> 4) << 16) | (64ull << 32) | (1ull << 62);
}
template <bool MN> struct WgSlab {
  static __device__ __forceinline__ uint64_t desc(uint32_t saddr) {
    return MN ? wg_desc_mn(saddr) : wg_desc(saddr);
  }
  static constexpr int kStep = MN ? 128 : 2;  // descriptor units a k slice
};
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator accesses across the async
// wgmma boundaries.
template <int R> __device__ __forceinline__ void wg_pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R> __device__ __forceinline__ void wg_pin(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int R> __device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R> __device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The accumulator operands of m64n256 (128 a thread) and m64n128 (64).
#define WG_REGS128 \
    "%0, %1, %2, %3, %4, %5, %6, %7, " \
    "%8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, " \
    "%24, %25, %26, %27, %28, %29, %30, %31, " \
    "%32, %33, %34, %35, %36, %37, %38, %39, " \
    "%40, %41, %42, %43, %44, %45, %46, %47, " \
    "%48, %49, %50, %51, %52, %53, %54, %55, " \
    "%56, %57, %58, %59, %60, %61, %62, %63, " \
    "%64, %65, %66, %67, %68, %69, %70, %71, " \
    "%72, %73, %74, %75, %76, %77, %78, %79, " \
    "%80, %81, %82, %83, %84, %85, %86, %87, " \
    "%88, %89, %90, %91, %92, %93, %94, %95, " \
    "%96, %97, %98, %99, %100, %101, %102, %103, " \
    "%104, %105, %106, %107, %108, %109, %110, %111, " \
    "%112, %113, %114, %115, %116, %117, %118, %119, " \
    "%120, %121, %122, %123, %124, %125, %126, %127 "
#define WG_REGS64 \
    "%0, %1, %2, %3, %4, %5, %6, %7, " \
    "%8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, " \
    "%24, %25, %26, %27, %28, %29, %30, %31, " \
    "%32, %33, %34, %35, %36, %37, %38, %39, " \
    "%40, %41, %42, %43, %44, %45, %46, %47, " \
    "%48, %49, %50, %51, %52, %53, %54, %55, " \
    "%56, %57, %58, %59, %60, %61, %62, %63 "
#define WG_F128 \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
    "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
    "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
    "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
    "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
    "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
    "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
    "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
    "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
    "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
    "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
    "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
    "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
    "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
    "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
    "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), \
    "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
    "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
    "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
    "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
    "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
    "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), \
    "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
    "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
    "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
    "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
    "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
    "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
    "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
    "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), \
    "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
#define WG_R128 \
    "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), \
    "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), \
    "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), \
    "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), \
    "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), \
    "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), \
    "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), \
    "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), \
    "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), \
    "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), \
    "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), \
    "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), \
    "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), \
    "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), \
    "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), \
    "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), \
    "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), \
    "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), \
    "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), \
    "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), \
    "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), \
    "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), \
    "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), \
    "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), \
    "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), \
    "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), \
    "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), \
    "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), \
    "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), \
    "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), \
    "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), \
    "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
#define WG_R64 \
    "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), \
    "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), \
    "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), \
    "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), \
    "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), \
    "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), \
    "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), \
    "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), \
    "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), \
    "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), \
    "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), \
    "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), \
    "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), \
    "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), \
    "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), \
    "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])

// d (+)= A . B for one k16 slice of 16-bit inputs, d 64 x 256 of this
// warpgroup; scale_d 0 overwrites d (the tile's first slice).  TA / TB:
// the operand is MN-major (wgmma's transpose bits).
template <bool TA, bool TB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" WG_REGS128
      "}, %128, %129, p, 1, 1, %131, %132;\n}"
      : WG_F128
      : "l"(da), "l"(db), "r"(scale_d), "n"(static_cast<int>(TA)), "n"(static_cast<int>(TB)));
}
template <bool TA, bool TB>
__device__ __forceinline__ void wgmma_f16(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 {" WG_REGS128
      "}, %128, %129, p, 1, 1, %131, %132;\n}"
      : WG_F128
      : "l"(da), "l"(db), "r"(scale_d), "n"(static_cast<int>(TA)), "n"(static_cast<int>(TB)));
}
// k32 of int8, both operands K-major, exact int32 sums.
__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {" WG_REGS128 "}, %128, %129, p;\n}"
      : WG_R128
      : "l"(da), "l"(db), "r"(scale_d));
}
// m64n128k32 of int8: B5's diagonal accumulator (64 a thread).
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" WG_REGS64 "}, %64, %65, p;\n}"
      : WG_R64
      : "l"(da), "l"(db), "r"(scale_d));
}
// m64n64k32 of int8: B4's 4-diagonal tile, W8A8's narrow N tile (32 a
// thread).
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef WG_REGS128
#undef WG_REGS64
#undef WG_F128
#undef WG_R128
#undef WG_R64

template <typename T, bool TA, bool TB> struct WgMma;
template <bool TA, bool TB> struct WgMma<__nv_bfloat16, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[128], uint64_t da, uint64_t db, int sd) {
    wgmma_bf16<TA, TB>(d, da, db, sd);
  }
};
template <bool TA, bool TB> struct WgMma<__half, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[128], uint64_t da, uint64_t db, int sd) {
    wgmma_f16<TA, TB>(d, da, db, sd);
  }
};
template <> struct WgMma<signed char, false, false> {
  static __device__ __forceinline__ void run(int (&d)[128], uint64_t da, uint64_t db, int sd) {
    wgmma_s8(d, da, db, sd);
  }
};

// ---- the tile's output -----------------------------------------------------

template <typename Out, typename V>
__device__ __forceinline__ Out cast_out(V v) {
  if constexpr (std::is_same<Out, float>::value) return static_cast<float>(v);
  else if constexpr (std::is_same<Out, __nv_bfloat16>::value) return __float2bfloat16(static_cast<float>(v));
  else if constexpr (std::is_same<Out, __half>::value) return __float2half(static_cast<float>(v));
  else if constexpr (std::is_same<Out, signed char>::value)
    return static_cast<signed char>(static_cast<int>(v));
  else return static_cast<int>(v);
}

// Two neighbouring outputs of a row as one store.
template <typename Out> struct PairOf;
template <> struct PairOf<float> {
  using P = float2;
  static __device__ __forceinline__ P make(float x, float y) { return make_float2(x, y); }
};
template <> struct PairOf<int> {
  using P = int2;
  static __device__ __forceinline__ P make(int x, int y) { return make_int2(x, y); }
};
template <> struct PairOf<__nv_bfloat16> {
  using P = __nv_bfloat162;
  static __device__ __forceinline__ P make(__nv_bfloat16 x, __nv_bfloat16 y) {
    return __halves2bfloat162(x, y);
  }
};
template <> struct PairOf<__half> {
  using P = __half2;
  static __device__ __forceinline__ P make(__half x, __half y) { return __halves2half2(x, y); }
};
template <> struct PairOf<signed char> {
  using P = char2;
  static __device__ __forceinline__ P make(signed char x, signed char y) { return make_char2(x, y); }
};

// The accumulator fragment of m64nN: thread (warp w, lane l) of the
// warpgroup holds rows 16 w + l / 4 (+ 8) and columns 8 j + 2 (l % 4) (+ 1)
// as d[4 j + {0, 1, 2, 3}] = (r, c), (r, c + 1), (r + 8, c), (r + 8, c + 1).
// put()'s arithmetic, with the output type fixed once for the whole tile
// (a per-element switch over 128 unrolled values is what stalls ptxas);
// (c, c + 1) go out as one store where both are inside and aligned.
template <typename Out, typename Acc>
__device__ __forceinline__ void wg_store_as(const Acc (&d)[128], const TileOut& o, int r0, int c0,
                                            int M, int N) {
  using Pair = PairOf<Out>;
  Out* out = static_cast<Out*>(o.out);
  const bool pairs = o.off % 2 == 0 && o.ldo % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % sizeof(typename Pair::P) == 0;
  auto row = [&](int i) { return r0 + 8 * ((i % 4) / 2); };
  auto col = [&](int i) { return c0 + 8 * (i / 4) + i % 2; };
  auto at = [&](int i) { return static_cast<int64_t>(row(i)) * o.ldo + col(i) + o.off; };
  auto in = [&](int i) { return row(i) < M && col(i) < N; };
  // Values i and i + 1 (i even: one row, columns c and c + 1).
  auto put2 = [&](int i, Out x, Out y) {
    if (pairs && in(i + 1)) {
      *reinterpret_cast<typename Pair::P*>(out + at(i)) = Pair::make(x, y);
    } else {
      if (in(i)) out[at(i)] = x;
      if (in(i + 1)) out[at(i + 1)] = y;
    }
  };
  if (!o.add && !o.round) {
#pragma unroll
    for (int i = 0; i < 128; i += 2) put2(i, cast_out<Out>(d[i]), cast_out<Out>(d[i + 1]));
    return;
  }
  // Cannon's running sum, read 8 values ahead of their use so that the
  // loads are in flight together (one at a time, they made the step that
  // reads the sum 45% longer; 32 at a time spilled).
  auto add_at = [&](int i) { return static_cast<int64_t>(row(i)) * o.ld_add + col(i); };
  // Rounding stores floats only: the fp32 running sum, or C of bf16 / fp16.
  constexpr bool kFloatOut = std::is_same<Out, float>::value ||
                             std::is_same<Out, __nv_bfloat16>::value ||
                             std::is_same<Out, __half>::value;
  if (kFloatOut && o.round) {
    const float* add = static_cast<const float*>(o.add);
    auto sum = [&](int i, float a) {
      const float f = round_to(static_cast<float>(d[i]), o.round);
      return cast_out<Out>(add ? round_to(f + a, o.round) : f);
    };
#pragma unroll
    for (int q = 0; q < 128; q += 8) {
      float a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = add && in(q + i) ? __ldcg(add + add_at(q + i)) : 0.f;
#pragma unroll
      for (int i = 0; i < 8; i += 2) put2(q + i, sum(q + i, a[i]), sum(q + i + 1, a[i + 1]));
    }
    return;
  }
  const Acc* add = static_cast<const Acc*>(o.add);
#pragma unroll
  for (int q = 0; q < 128; q += 8) {
    Acc a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = in(q + i) ? __ldcg(add + add_at(q + i)) : Acc(0);
#pragma unroll
    for (int i = 0; i < 8; i += 2)
      put2(q + i, cast_out<Out>(d[q + i] + a[i]), cast_out<Out>(d[q + i + 1] + a[i + 1]));
  }
}

template <typename Acc>
__device__ void wg_store(const Acc (&d)[128], const TileOut& o, int row0, int n0, int M, int N) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x % 128 / 32;
  const int r0 = row0 + 16 * warp + lane / 4, c0 = n0 + 2 * (lane % 4);
  switch (o.out_code) {
    case kF32: wg_store_as<float>(d, o, r0, c0, M, N); break;
    case kBF16: wg_store_as<__nv_bfloat16>(d, o, r0, c0, M, N); break;
    case kF16: wg_store_as<__half>(d, o, r0, c0, M, N); break;
    case kI8: wg_store_as<signed char>(d, o, r0, c0, M, N); break;
    case kI32: wg_store_as<int>(d, o, r0, c0, M, N); break;
  }
}

// The consumer's store of a TileOut, and whether it reads the running sum
// another block stored (then the tile flag orders the two).  B1's EpOut
// has its own pair (csrc/mxu_wgmma.cuh).
template <typename Acc>
__device__ __forceinline__ void wg_put(const Acc (&d)[128], const TileOut& o, int row0, int n0,
                                       int M, int N) {
  wg_store(d, o, row0, n0, M, N);
}
__device__ __forceinline__ bool wg_reads_sum(const TileOut& o) { return o.add != nullptr; }

// ---- the compute block -----------------------------------------------------

// One rank's compute work: ``steps`` products of (M, K) . (K, N), step s
// reading its operands through map_a[s % 2] / map_b[s % 2] once
// recv[0][s] and recv[1][s] reach recv_first (s = 0) or recv_next.  A job
// without a ring (B1, B2) has null recv, done and tile_flags, and its maps
// in the launch parameters (maps_in_params: no tensormap acquire).
struct WgJob {
  const CUtensorMap* map_a[2];
  const CUtensorMap* map_b[2];
  const int* recv[2];
  int recv_first, recv_next;
  int* done;        // done[s]: +1 from each block once its share of step s is over, or null
  int* tile_flags;  // per tile, +1 per consumer warpgroup and step (Cannon), or null
  long long* stamps;  // this rank's (dist_tile.cuh), or null
  long long spin;
  int M, N, K, steps;
  int n_comp, cb;  // the rank's compute blocks, this block's index among them
  int maps_in_params;  // else they sit in a device buffer the host wrote before the launch
  // Bit 0 / 1: A / B is a 3-D map read at batch coordinate s (B2's
  // examples); else a 2-D map every step reads alike.
  int batch_maps = 0;
};

// A box at (c0, c1) of a 2-D map, or of example z of a 3-D one (z >= 0).
__device__ __forceinline__ void tma_load_z(void* dst, const CUtensorMap* map, int c0, int c1, int z,
                                           uint64_t* bar) {
  if (z >= 0) tma_load_3d(dst, map, c0, c1, z, bar);
  else tma_load_2d(dst, map, c0, c1, bar);
}

// One stage of K-slab kt of the tile at (m0, n0): A's 128 rows and B's
// 256, one box each where the operand is K-major, else 2 / 4 MN-major
// boxes of kWgMnBox; za / zb: the example of a 3-D map, or -1.
template <typename T, bool MnA, bool MnB>
__device__ __forceinline__ void wg_load_stage(unsigned char* st, const CUtensorMap* ma,
                                              const CUtensorMap* mb, int kt, int m0, int n0,
                                              int za, int zb, uint64_t* bar) {
  constexpr int BK = WgType<T>::BK;
  if constexpr (MnA) {
#pragma unroll
    for (int h = 0; h < kWgBM / 64; ++h) tma_load_z(st + h * kWgMnBox, ma, m0 + 64 * h, kt * BK, za, bar);
  } else {
    tma_load_z(st, ma, kt * BK, m0, za, bar);
  }
  if constexpr (MnB) {
#pragma unroll
    for (int h = 0; h < kWgBN / 64; ++h)
      tma_load_z(st + kWgTileA + h * kWgMnBox, mb, n0 + 64 * h, kt * BK, zb, bar);
  } else {
    tma_load_z(st + kWgTileA, mb, kt * BK, n0, zb, bar);
  }
}

template <typename T, bool MnA, bool MnB>
__device__ void wg_produce(const WgJob& j, unsigned char* smem, WgBars* bars, int tiles_m,
                           int tiles_n, int ksteps) {
  const int tiles = tiles_m * tiles_n;
  const int64_t items = static_cast<int64_t>(j.steps) * tiles;
  if (!j.maps_in_params)
    for (int q = 0; q < 2; ++q) {
      tensormap_acquire(j.map_a[q]);
      tensormap_acquire(j.map_b[q]);
    }
  int cur = -1, stage = 0;
  uint32_t phase = 0;
  long long longest = 0;
  for (int64_t i = j.cb; i < items; i += j.n_comp) {
    const int s = static_cast<int>(i / tiles), t = static_cast<int>(i % tiles);
    if (s != cur && j.recv[0]) {
      // Nothing of step s is loaded before it has arrived, prefetch included.
      const long long t0 = j.stamps ? global_ns() : 0;
      const int target = s == 0 ? j.recv_first : j.recv_next;
      wait_flag_thread(j.recv[0] + s, target, j.spin);
      wait_flag_thread(j.recv[1] + s, target, j.spin);
      fence_proxy_async_global();
      if (j.stamps) {
        const long long t1 = global_ns();
        longest = t1 - t0 > longest ? t1 - t0 : longest;
        if (s == 0 && j.cb == 0) j.stamps[1] = t1;
      }
    }
    cur = s;
    int m0, n0;
    tile_origin(t, tiles_m, tiles_n, kWgBM, kWgBN, m0, n0);
    const CUtensorMap* ma = j.map_a[s & 1];
    const CUtensorMap* mb = j.map_b[s & 1];
    const int za = j.batch_maps & 1 ? s : -1, zb = j.batch_maps & 2 ? s : -1;
    for (int kt = 0; kt < ksteps; ++kt) {
      mbar_wait(&bars->empty[stage], phase ^ 1, j.spin);
      mbar_expect_tx(&bars->full[stage], kWgStage);
      wg_load_stage<T, MnA, MnB>(smem + stage * kWgStage, ma, mb, kt, m0, n0, za, zb,
                                 &bars->full[stage]);
      if (++stage == kWgStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  if (j.stamps) stamp_max(j.stamps + 2, longest);
}

template <typename T, bool MnA, bool MnB, typename OutOf>
__device__ void wg_consume(const WgJob& j, unsigned char* smem, WgBars* bars, OutOf out_of,
                           int tiles_m, int tiles_n, int ksteps) {
  using Acc = typename WgType<T>::Acc;
  using SA = WgSlab<MnA>;
  using SB = WgSlab<MnB>;
  const int wg = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
  const int tiles = tiles_m * tiles_n;
  const int64_t items = static_cast<int64_t>(j.steps) * tiles;
  const uint32_t base = smem_u32(smem);
  const bool stamper = j.stamps && j.cb == 0 && threadIdx.x == 128;
  // Steps [from, to) are over for this block.
  auto finish = [&](int from, int to) {
    if (!j.done) return;
    named_sync(1, 256);
    if (threadIdx.x == 128)
      for (int q = from; q < to; ++q) {
        if (stamper) j.stamps[kStampHead + j.steps + q] = global_ns();
        release_add(&j.done[q], 1);
      }
  };
  Acc d[128];
  int cur = -1, stage = 0, prev = 0;
  uint32_t phase = 0;
  long long longest = 0;
  for (int64_t i = j.cb; i < items; i += j.n_comp) {
    const int s = static_cast<int>(i / tiles), t = static_cast<int>(i % tiles);
    if (s != cur) {
      if (cur >= 0) finish(cur, s);
      if (stamper) j.stamps[kStampHead + s] = global_ns();
      cur = s;
    }
    int m0, n0;
    tile_origin(t, tiles_m, tiles_n, kWgBM, kWgBN, m0, n0);
    wg_pin(d);
    for (int kt = 0; kt < ksteps; ++kt) {
      mbar_wait(&bars->full[stage], phase, j.spin);
      const uint32_t st = base + stage * kWgStage;
      // A warpgroup's 64 rows: half the K-major box, or the whole of one
      // of the two MN-major boxes (8 KB either way).
      const uint64_t da = SA::desc(st + wg * kWgMnBox), db = SB::desc(st + kWgTileA);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgMma<T, MnA, MnB>::run(d, da + SA::kStep * kk, db + SB::kStep * kk, kt > 0 || kk > 0);
      wg_commit();
      if (kt > 0) {
        wg_wait<1>();  // the group that read stage prev has retired
        mbar_arrive(&bars->empty[prev]);
      }
      prev = stage;
      if (++stage == kWgStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wg_wait<0>();
    mbar_arrive(&bars->empty[prev]);
    wg_pin(d);
    const auto o = out_of(s);
    int* flag = j.tile_flags ? j.tile_flags + t : nullptr;
    if (flag && wg_reads_sum(o)) {
      // The running sum of (s - 1, t), both halves, is stored.
      if (tid == 0) {
        const long long t0 = j.stamps ? global_ns() : 0;
        wait_flag_thread(flag, 2 * s, j.spin);
        if (j.stamps && global_ns() - t0 > longest) longest = global_ns() - t0;
      }
      named_sync(2 + wg, 128);
    }
    wg_put(d, o, m0 + 64 * wg, n0, j.M, j.N);
    if (flag && s + 1 < j.steps) {
      named_sync(2 + wg, 128);
      if (tid == 0) release_add(flag, 1);
    }
  }
  finish(cur < 0 ? 0 : cur, j.steps);
  if (j.stamps && tid == 0) stamp_max(j.stamps + 2, longest);
}

// The compute block: ``smem`` the aligned dynamic shared memory, the
// barriers initialised; out_of(s) is step s's output (TileOut or EpOut).
// MnA / MnB: the operand is MN-major (16-bit types only).
template <typename T, bool MnA = false, bool MnB = false, typename OutOf>
__device__ void wg_compute(const WgJob& j, unsigned char* smem, WgBars* bars, OutOf out_of) {
  static_assert(sizeof(T) == 2 || !(MnA || MnB), "int8 wgmma reads K-major operands only");
  const int tiles_m = (j.M + kWgBM - 1) / kWgBM, tiles_n = (j.N + kWgBN - 1) / kWgBN;
  const int ksteps = (j.K + WgType<T>::BK - 1) / WgType<T>::BK;
  if (threadIdx.x < 128) {
    reg_dealloc<40>();
    if (threadIdx.x == 0) wg_produce<T, MnA, MnB>(j, smem, bars, tiles_m, tiles_n, ksteps);
  } else {
    reg_alloc<232>();
    wg_consume<T, MnA, MnB>(j, smem, bars, out_of, tiles_m, tiles_n, ksteps);
  }
}

// The stage barriers (thread 0; the caller syncs the block after).
__device__ __forceinline__ void wg_init_bars(WgBars* bars) {
  for (int i = 0; i < kWgStages; ++i) {
    mbar_init(&bars->full[i], 1);
    mbar_init(&bars->empty[i], 256);
  }
  for (int i = 0; i < kWgSendSlots; ++i) mbar_init(&bars->send[i], 1);
  mbar_init_fence();
}

// ---- host: tensor maps -----------------------------------------------------

// cuTensorMapEncodeTiled, looked up through cudaGetDriverEntryPoint, so
// the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                 : nullptr;
  }();
  return fn;
}

// Return code of a tensor map cuTensorMapEncodeTiled refused.
constexpr int kTmaEncodeFailed = -2;

inline CUtensorMapDataType tma_type(int esize, bool f16) {
  return esize == 1   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
         : esize == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
         : esize == 8 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT64
         : f16        ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// A map of ``rank`` dimensions, 128-byte swizzled, elements past the edges
// read as zero: dims[0] the contiguous one, strides[i] the byte stride of
// dimension i + 1 (each a multiple of 16), base 16-byte aligned, boxes of
// box[0] (at most 128 bytes) x box[1] x ...
inline bool encode_nd(CUtensorMap* map, const void* base, int rank, const int64_t* dims,
                      const int64_t* strides, const int* box, int esize, bool f16) {
  const EncodeTiled fn = encode_tiled();
  if (!fn || rank < 1 || rank > 5) return false;
  cuuint64_t d[5], st[4];
  cuuint32_t bx[5], unit[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = static_cast<cuuint64_t>(dims[i]);
    bx[i] = static_cast<cuuint32_t>(box[i]);
    unit[i] = 1;
    if (i + 1 < rank) st[i] = static_cast<cuuint64_t>(strides[i]);
  }
  return fn(map, tma_type(esize, f16), rank, const_cast<void*>(base), d, st, bx, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 2-D map: ``inner`` x ``outer`` esize-byte elements at ``base``, ``ld``
// elements a row (ld * esize a multiple of 16), boxes of ``box_inner`` x
// ``box_outer``.
inline bool encode_2d(CUtensorMap* map, const void* base, int64_t inner, int64_t outer, int64_t ld,
                      int esize, bool f16, int box_inner, int box_outer) {
  const int64_t dims[2] = {inner, outer}, strides[1] = {ld * esize};
  const int box[2] = {box_inner, box_outer};
  return encode_nd(map, base, 2, dims, strides, box, esize, f16);
}

// The map of a K-major operand (rows, k) at row pitch ``ld`` (0: k):
// boxes of 128 bytes of K by ``box_rows`` rows (wg_desc's layout).
inline bool encode_kmajor(CUtensorMap* map, const void* base, int rows, int k, int esize,
                          int box_rows, int64_t ld = 0, bool f16 = false) {
  return encode_2d(map, base, k, rows, ld ? ld : k, esize, f16, kWgRowBytes / esize, box_rows);
}

// The map of an MN-major 16-bit operand: k rows of ``mn`` values (M or N
// contiguous) at row pitch ``ld``, boxes of 64 values by the slab's 64 K
// rows (wg_desc_mn's layout).
inline bool encode_mnmajor(CUtensorMap* map, const void* base, int k, int mn, int64_t ld, bool f16) {
  return encode_2d(map, base, mn, k, ld, 2, f16, kWgRowBytes / 2, WgType<__nv_bfloat16>::BK);
}

// An unswizzled map of a row-major (rows, n) array of bytes (B13's packed
// weights, the W8A8 weights) or floats (B13's scales): boxes of box_n x
// box_rows.
inline bool encode_rows(CUtensorMap* map, const void* base, int64_t rows, int64_t n, bool f32,
                        int box_n, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n * (f32 ? 4 : 1))};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_n), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
            const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Each rank's four maps (A and B^T of an even and an odd step), copied on
// the stream into the device buffer ``dev`` before the launch that reads
// them.  The device buffer, not the launch parameters: 4 x 128 bytes a rank
// would not fit 4 KB of parameters past 8 ranks, and the ring takes 64.
inline int upload_maps(void* dev, const std::vector<CUtensorMap>& maps, cudaStream_t st) {
  return static_cast<int>(cudaMemcpyAsync(dev, maps.data(), maps.size() * sizeof(CUtensorMap),
                                          cudaMemcpyHostToDevice, st));
}

}  // namespace gemm_hls
