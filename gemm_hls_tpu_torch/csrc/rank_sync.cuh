// Device-side signal / wait between the ranks of the fused distributed
// GEMMs (csrc/ring_gemm.cu, kernel B18; csrc/cannon_gemm.cu, kernel B19):
// the counterpart of the DMA and REGULAR semaphores of
// gemm_hls_tpu/ops/pallas_ring.py and pallas_cannon.py.
//
// A flag is an int counter in device memory that only grows; the wrappers
// zero every flag on the stream before each launch, so two calls never
// share flag state.  Ordering, at GPU scope (all ranks of a launch live on
// one card):
//   * signal: the block's writes come first (the caller has passed a
//     __syncthreads()), then thread 0 issues __threadfence() and an atomic
//     add on the receiver's flag: the fence is cumulative over the writes
//     the barrier ordered before it;
//   * wait: thread 0 spins on an acquire load (ld.acquire.gpu) until the
//     flag reaches its target, then __syncthreads() spreads the acquire to
//     the block.  Data that another rank wrote is then read only through
//     the L2 (cp.async.cg, ld.global.cg): an SM's L1 is not coherent and
//     may hold a line of the same buffer from an earlier step.
// Every wait is bounded: past ``spin`` clock64() cycles it calls __trap(),
// so a protocol fault fails the next synchronize loudly instead of
// hanging.  A wait may legitimately last as long as the whole launch (a
// sender waits on a neighbour's whole compute step), so the wrappers size
// the budget from the launch's own work (ops/ring.py::spin_budget_ms) and
// pass it in milliseconds; spin_cycles counts 2e6 cycles a millisecond,
// above the H100's 1.98 GHz top clock, so each millisecond of budget lasts
// at least a millisecond.  The waits are only safe when every block of
// every rank is resident at once: the launches are cooperative
// (cudaLaunchCooperativeKernel), which CUDA refuses rather than run a grid
// that does not fit.
#pragma once

#include <cstdint>

namespace gemm_hls {

__host__ __device__ inline long long spin_cycles(int budget_ms) {
  return static_cast<long long>(budget_ms) * 2000000LL;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Block-wide: returns when *flag >= target (all threads), traps after
// ``spin`` cycles of waiting.
__device__ __forceinline__ void wait_flag(const int* flag, int target, long long spin) {
  if (threadIdx.x == 0) {
    const long long t0 = clock64();
    while (ld_acquire(flag) < target) {
      if (clock64() - t0 > spin) __trap();
      __nanosleep(100);
    }
  }
  __syncthreads();
}

// Block-wide: publishes the block's earlier writes, then adds ``inc`` to
// *flag.  Every thread calls it.
__device__ __forceinline__ void signal_flag(int* flag, int inc) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(flag, inc);
  }
}

// [lo, hi) of a partition of ``total`` into ``parts`` pieces whose bounds
// are multiples of ``align`` (the last ends at ``total``).
__device__ __forceinline__ int64_t split_at(int64_t total, int parts, int i, int64_t align) {
  const int64_t units = (total + align - 1) / align;
  const int64_t at = units * i / parts * align;
  return at < total ? at : total;
}

// Bytes [lo, hi) of ``src`` to ``dst`` by the block, in 16-byte vectors
// through the L2 (both bases 16-byte aligned, lo a multiple of 16; a tail
// past the last whole vector goes byte by byte).  Eight loads per thread
// are in flight before their stores: one vector at a time would leave a
// block at a few GB/s, bound by the load latency.
__device__ __forceinline__ void copy_cg(void* dst, const void* src, int64_t lo, int64_t hi) {
  constexpr int U = 8;
  const uint4* s = static_cast<const uint4*>(src);
  uint4* d = static_cast<uint4*>(dst);
  const int64_t tail = hi / 16 * 16 > lo ? hi / 16 * 16 : lo;
  for (int64_t b = tail + threadIdx.x; b < hi; b += blockDim.x)
    static_cast<unsigned char*>(dst)[b] = __ldcg(static_cast<const unsigned char*>(src) + b);
  const int64_t end = hi / 16, step = static_cast<int64_t>(blockDim.x) * U;
  for (int64_t i0 = lo / 16 + threadIdx.x; i0 < end; i0 += step) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t i = i0 + static_cast<int64_t>(u) * blockDim.x;
      if (i < end) v[u] = __ldcg(s + i);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t i = i0 + static_cast<int64_t>(u) * blockDim.x;
      if (i < end) __stcg(d + i, v[u]);
    }
  }
}

}  // namespace gemm_hls
