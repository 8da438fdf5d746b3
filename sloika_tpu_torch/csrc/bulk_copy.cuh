// Hopper's bulk asynchronous copies and the shared-memory mbarriers they
// complete on, as csrc/hbm_ring.cu and csrc/lstm_fwd.cu use them (through
// recurrence.cuh for the latter).  A copy of `bytes` (a multiple of 16,
// both ends 16-byte aligned) from device to shared memory is one
// instruction of one thread; it adds its bytes to the barrier's transaction
// count when it lands.  A slot's "full" barrier is armed with the slot's
// bytes (mbar_expect_tx, which is also its one arrival), and a thread that
// waits on the barrier's phase parity then sees the slot's data.  An "empty"
// barrier counts the arrivals of the slot's readers (mbar_arrive), so the
// producer waits on it before it refills the slot.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// after the barriers' init, before any thread or copy uses them
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of copies to land
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// one arrival (release: this thread's reads of the slot come before it)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait until the phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// order this thread's earlier generic-proxy writes to shared memory before
// its later bulk copies into it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// a box of a 4-D tensor map (coordinates innermost first; elements outside
// the tensor are filled with zeros), completing on `bar` with the box's
// bytes
__device__ __forceinline__ void tensor_copy_4d(void* dst, const void* tmap,
                                               int x, int y, int z, int w,
                                               uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(tmap), "r"(x), "r"(y), "r"(z), "r"(w), "r"(smem_u32(bar))
      : "memory");
}

// whether the phase of this parity has completed, without blocking
__device__ __forceinline__ bool mbar_test(uint64_t* bar, unsigned parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// wait until the phase of this parity has completed, testing first: a
// blocking try_wait on a completed phase costs ~200 cycles (PERF.md §6)
__device__ __forceinline__ void mbar_wait_tested(uint64_t* bar,
                                                 unsigned parity) {
  if (!mbar_test(bar, parity)) mbar_wait(bar, parity);
}

}  // namespace

// Phase clocks of a kernel's clocked build: PHASE_CLOCK(k) adds the SM
// cycles since the last stamp to clk[k].  A stamp reads %clock64 behind a
// memory clobber, so the compiler moves no memory access across it.
#define PHASE_CLOCK(k)                                                 \
  do {                                                                 \
    long long now_;                                                    \
    asm volatile("mov.u64 %0, %%clock64;\n" : "=l"(now_) : : "memory"); \
    clk[k] += now_ - stamp;                                            \
    stamp = now_;                                                      \
  } while (0)
#define PHASE_CLOCK_START()                                            \
  long long clk[8] = {0, 0, 0, 0, 0, 0, 0, 0}, stamp;                  \
  asm volatile("mov.u64 %0, %%clock64;\n" : "=l"(stamp) : : "memory"); \
  const long long clock_start_ = stamp
#define PHASE_CLOCK_TOTAL() (stamp - clock_start_)
