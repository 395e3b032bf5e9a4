// The tile walk of the passes that write one B1 / B2 operand K-major for
// the tile engine: csrc/operand_pack.cu (bf16 / fp16 / int8, copied as they
// are) and csrc/int_split.cu (int16 / 32-bit integers cut into byte
// planes).  Each block turns a square tile of 128-byte sides through shared
// memory: 32 x 32 32-bit values, 64 x 64 16-bit ones, 128 x 128 int8 ones.  A thread moves
// one 32-bit word, V = 4 / sizeof(T) values, at a time, so a warp reads
// 128 contiguous bytes of the operand (along K when it is held (rows, K),
// along the rows when it is held (K, rows)) and writes 128 contiguous
// bytes of the workspace, along K.  The operand is read at any base and
// pitch: a word load where the thread's V values are whole and 4-byte
// aligned, V scalar loads where they are not.  Values past K (up to the
// workspace's kp) and past the rows read 0.
//
// Shared memory holds whole words only, [row][word of K].  An operand held
// (rows, K) passes a row at a time, its rows padded to 33 words.  One
// held (K, rows) is stored V rows a thread (each thread reads V K-rows of
// one word each and turns the V x V block of values in registers,
// tile_transpose), its word columns XORed with (row / V) mod 32 and not
// padded, so that a warp's 32 words land in 32 banks both when it stores
// them and when it reads one row of the tile (storing V values of 1 or 2
// bytes a thread into padded rows put four or two of a warp's stores in
// one bank: the int8 pass ran at 53% of its bound, 78% so; tools/pack_ab).
#pragma once

#include "common.cuh"

namespace gemm_hls {

constexpr int kTileWarps = 8;

template <typename T>
struct OperandTile {
  static constexpr int V = 4 / static_cast<int>(sizeof(T));  // values a word
  static constexpr int kSide = 32 * V;                       // values a side
};

// The V values of x[0], x[step], ..., x[(V - 1) step] (step 1: one run of
// contiguous values), the first ``valid`` of them, the rest 0, as a word.
template <typename T>
__device__ __forceinline__ uint32_t load_word(const T* x, int valid) {
  constexpr int V = OperandTile<T>::V;
  if (valid >= V && reinterpret_cast<uintptr_t>(x) % 4 == 0)
    return *reinterpret_cast<const uint32_t*>(x);
  union {
    T v[V];
    uint32_t w;
  } u;
#pragma unroll
  for (int j = 0; j < V; ++j) u.v[j] = j < valid ? x[j] : T(0);
  return u.w;
}

// A V x V block of values turned in registers: on entry w[jj] holds V
// consecutive rows' values at the block's K index jj (value j: row j); on
// return w[j] holds row j's values at the block's V K indices (value jj:
// K index jj).
template <int V>
__device__ __forceinline__ void tile_transpose(uint32_t (&w)[V]) {
  if constexpr (V == 2) {
    const uint32_t a = w[0], b = w[1];
    w[0] = __byte_perm(a, b, 0x5410);  // the low halves: row 0
    w[1] = __byte_perm(a, b, 0x7632);  // the high halves: row 1
  } else if constexpr (V == 4) {
    const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[0], w[1], 0x7362);
    const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140), t3 = __byte_perm(w[2], w[3], 0x7362);
    w[0] = __byte_perm(t0, t2, 0x5410);
    w[1] = __byte_perm(t0, t2, 0x7632);
    w[2] = __byte_perm(t1, t3, 0x5410);
    w[3] = __byte_perm(t1, t3, 0x7632);
  }
}

// Grid: (K tiles of kp, row tiles, examples), the last two walked in
// strides.  x[z] is held (k, rows) with kMn (rows contiguous), else (rows,
// k), at row pitch ld, examples bs apart.  ``put(z, r, kk, word)`` writes
// the word holding values kk .. kk + V - 1 of row r of example z, for
// every r < rows and kk < kp (kp a multiple of V).
template <typename T, bool kMn, typename Put>
__global__ void __launch_bounds__(32 * kTileWarps)
    operand_tile_kernel(const T* __restrict__ x, int batch, int rows, int k, int64_t ld,
                        int64_t bs, int kp, Put put) {
  constexpr int V = OperandTile<T>::V, S = OperandTile<T>::kSide;
  // [row][word of K], or with kMn [row][word of K ^ (row / V) % 32].
  __shared__ uint32_t tile[S][kMn ? 32 : 33];
  const auto col = [](int i, int w) { return kMn ? w ^ ((i / V) & 31) : w; };
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int k0 = blockIdx.x * S;
  const int row_tiles = (rows + S - 1) / S;
  for (int z = blockIdx.z; z < batch; z += gridDim.z) {
    const T* xz = x + z * bs;
    for (int rt = blockIdx.y; rt < row_tiles; rt += gridDim.y) {
      const int r0 = rt * S;
      if constexpr (kMn) {
        // Word column c of the tile: its V K-rows, V rows of the operand
        // (tile rows tx V .. tx V + V - 1) a thread, turned in registers.
#pragma unroll 4
        for (int c = ty; c < 32; c += kTileWarps) {
          const int r = r0 + tx * V, valid_r = min(V, rows - r);
          uint32_t w[V];
#pragma unroll
          for (int jj = 0; jj < V; ++jj) {
            const int kk = k0 + c * V + jj;
            w[jj] = load_word(xz + static_cast<int64_t>(kk) * ld + r, kk < k ? valid_r : 0);
          }
          tile_transpose<V>(w);
#pragma unroll
          for (int j = 0; j < V; ++j) tile[tx * V + j][c ^ tx] = w[j];
        }
      } else {
#pragma unroll 4
        for (int i = ty; i < S; i += kTileWarps) {
          const int kk = k0 + tx * V, r = r0 + i;
          const int valid = r < rows ? min(V, k - kk) : 0;
          tile[i][tx] = load_word(xz + static_cast<int64_t>(r) * ld + kk, valid);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int i = ty; i < S; i += kTileWarps) {
        const int kk = k0 + tx * V, r = r0 + i;
        if (r < rows && kk < kp) put(z, r, kk, tile[i][col(i, tx)]);
      }
      __syncthreads();  // the next tile reuses the shared one
    }
  }
}

// The kernel over ``batch`` examples; returns 0 or a CUDA error code.
template <typename T, typename Put>
int launch_operand_tile(const T* x, int64_t batch, int rows, int k, int64_t ld, int64_t bs,
                        bool mn_major, int kp, const Put& put, cudaStream_t st) {
  constexpr int S = OperandTile<T>::kSide;
  const dim3 block(32, kTileWarps);
  const int64_t row_tiles = (rows + S - 1) / S;
  const dim3 grid(static_cast<unsigned>((kp + S - 1) / S),
                  static_cast<unsigned>(row_tiles < kMaxGridZ ? row_tiles : kMaxGridZ),
                  static_cast<unsigned>(batch < kMaxGridZ ? batch : kMaxGridZ));
  const int nb = static_cast<int>(batch);
  if (mn_major)
    operand_tile_kernel<T, true><<<grid, block, 0, st>>>(x, nb, rows, k, ld, bs, kp, put);
  else
    operand_tile_kernel<T, false><<<grid, block, 0, st>>>(x, nb, rows, k, ld, bs, kp, put);
  return last_error();
}

}  // namespace gemm_hls
