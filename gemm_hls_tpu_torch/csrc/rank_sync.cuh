// Device-side signal / wait between the ranks of the fused distributed
// GEMMs (csrc/ring_gemm.cu, kernel B18; csrc/cannon_gemm.cu, kernel B19):
// the counterpart of the DMA and REGULAR semaphores of
// gemm_hls_tpu/ops/pallas_ring.py and pallas_cannon.py, and the bulk copies
// that move a block from one rank's buffer to another's.
//
// A flag is an int counter in device memory that only grows; the wrappers
// zero every flag on the stream before each launch, so two calls never
// share flag state.  Ordering, at GPU scope (all ranks of a launch live on
// one card):
//   * release (release_add): the writes come first, then the thread issues
//     __threadfence() and an atomic add on the flag.  A block-wide signal
//     (signal_flag) passes a __syncthreads() first, so the fence is
//     cumulative over every thread's writes; a thread that made all the
//     writes itself (the bulk-copy thread of a sender block) releases alone.
//   * acquire (wait_flag_thread): the thread spins on an acquire load
//     (ld.acquire.gpu) until the flag reaches its target.  The block-wide
//     wait_flag spreads it with a __syncthreads().  Inside a warp-specialised
//     block (csrc/wgmma_tile.cuh) a block-wide barrier would deadlock, so
//     there only the thread that issues the loads waits (the TMA producer
//     for recv[s], one thread of a consumer warpgroup for a tile flag),
//     and named barriers spread it to the threads that need it.
//   * proxies: data another rank wrote is read either through the L2
//     (cp.async.cg, ld.global.cg: an SM's L1 is not coherent and may hold a
//     line of the same buffer from an earlier step) or by the TMA engine,
//     which reads through the async proxy.  After its acquire, a thread
//     that goes on to issue TMA or bulk loads of that data first issues
//     fence.proxy.async.global, or a load may see a stale line.  A sender
//     that wrote with bulk stores (async proxy) waits for them to complete
//     (cp.async.bulk.wait_group 0: written, not only read), fences the
//     async proxy and only then releases.  Shared memory that generic
//     stores used (the staging transpose's tile) is fenced
//     (fence.proxy.async.shared::cta) before TMA writes into it.
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

// The calling thread alone: returns when *flag >= target, traps after
// ``spin`` cycles of waiting.
__device__ __forceinline__ void wait_flag_thread(const int* flag, int target, long long spin) {
  const long long t0 = clock64();
  while (ld_acquire(flag) < target) {
    if (clock64() - t0 > spin) __trap();
    __nanosleep(64);
  }
}

// Block-wide: returns when *flag >= target (all threads).
__device__ __forceinline__ void wait_flag(const int* flag, int target, long long spin) {
  if (threadIdx.x == 0) wait_flag_thread(flag, target, spin);
  __syncthreads();
}

// The calling thread: publishes its earlier writes (and, behind a barrier
// it passed, its block's), then adds ``inc`` to *flag.
__device__ __forceinline__ void release_add(int* flag, int inc) {
  __threadfence();
  atomicAdd(flag, inc);
}

// Block-wide: publishes the block's earlier writes, then adds ``inc`` to
// *flag.  Every thread calls it.
__device__ __forceinline__ void signal_flag(int* flag, int inc) {
  __syncthreads();
  if (threadIdx.x == 0) release_add(flag, inc);
}

__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The card's nanosecond clock (%globaltimer), for the optional time stamps.
__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

// [lo, hi) of a partition of ``total`` into ``parts`` pieces whose bounds
// are multiples of ``align`` (the last ends at ``total``).
__device__ __forceinline__ int64_t split_at(int64_t total, int parts, int i, int64_t align) {
  const int64_t units = (total + align - 1) / align;
  const int64_t at = units * i / parts * align;
  return at < total ? at : total;
}

// ---- mbarriers and bulk asynchronous copies (the TMA engine) --------------

// Where a block's share of a bulk forward may start: on 4 KB bounds, so
// that every bulk copy moves whole cache lines.
constexpr int64_t kSendAlign = 4096;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// After the barriers' init, before any thread uses them.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.b32 %0, 1, 0, p;\n}"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}
// Returns once the phase of ``parity`` has completed; traps past ``spin``
// cycles (a lost transfer must not hang the card).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity, long long spin) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > spin) __trap();
}

// global -> shared, ``bytes`` a multiple of 16, both ends 16-byte aligned;
// completes ``bytes`` of the barrier's expected transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// shared -> global, committed as one bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// All but the newest N bulk groups have read their shared memory.
template <int N> __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}
// Every bulk group has completed: its writes are done.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Global-to-global copies by ONE thread through ``ns`` (> kLag) shared-
// memory slots of ``ch`` bytes: bulk loads land on a barrier per slot,
// each slot then goes out as a bulk store, and a slot is loaded again once
// its store has read it, so ns - kLag loads and kLag stores are in flight
// (128 KB of loads per SM in the wgmma kernels' 6 x 32 KB; 16-byte vectors
// from 256 threads held 32 KB).  ``uses`` carries each slot's barrier phase from one
// call to the next.  The caller initialises the barriers (count 1) and
// fences any generic use of the slots first.
struct BulkRing {
  // A slot is loaded again kLag chunks after its store was issued, so the
  // thread never waits on the store it has just issued (with 1, a bf16 ring
  // of 8 ranks on an H100 took 3.17 ms against 2.83-2.85 with 2; 12 x 16
  // KB or 24 x 8 KB slots did no better).
  static constexpr int kLag = 2;
  unsigned char* buf;
  uint64_t* bars;
  int ns, ch;
  unsigned uses;

  __device__ void init() {
    for (int i = 0; i < ns; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
  }

  // Bytes [lo, hi) of src to dst (lo a multiple of 16, both bases 16-byte
  // aligned).  On return the writes are complete and fenced for the
  // generic proxy: the caller may release a flag.  A tail past the last
  // 16-byte multiple goes byte by byte through the L2.
  __device__ void copy(void* dst, const void* src, int64_t lo, int64_t hi, long long spin) {
    const int64_t body = hi > lo ? (hi - lo) / 16 * 16 : 0;
    const int64_t n_ch = (body + ch - 1) / ch;
    unsigned char* d = static_cast<unsigned char*>(dst) + lo;
    const unsigned char* s = static_cast<const unsigned char*>(src) + lo;
    auto bytes_of = [&](int64_t c) {
      const int64_t left = body - c * ch;
      return static_cast<uint32_t>(left < ch ? left : ch);
    };
    auto load = [&](int64_t c) {
      const unsigned slot = (uses + static_cast<unsigned>(c)) % ns;
      mbar_expect_tx(&bars[slot], bytes_of(c));
      bulk_load(buf + static_cast<int64_t>(slot) * ch, s + c * ch, bytes_of(c), &bars[slot]);
    };
    for (int64_t c = 0; c < n_ch && c < ns; ++c) load(c);
    for (int64_t c = 0; c < n_ch; ++c) {
      const unsigned u = uses + static_cast<unsigned>(c), slot = u % ns;
      mbar_wait(&bars[slot], (u / ns) & 1, spin);
      bulk_store(d + c * ch, buf + static_cast<int64_t>(slot) * ch, bytes_of(c));
      if (c >= kLag && c - kLag + ns < n_ch) {
        bulk_wait_read<kLag>();  // the store of chunk c - kLag has read its slot
        load(c - kLag + ns);
      }
    }
    bulk_wait_all();
    fence_proxy_async_global();
    for (int64_t b = lo + body; b < hi; ++b)
      static_cast<unsigned char*>(dst)[b] = __ldcg(static_cast<const unsigned char*>(src) + b);
    uses += static_cast<unsigned>(n_ch);
  }
};

}  // namespace gemm_hls
