// Bulk copies global -> shared on the TMA engine (cp.async.bulk), whose
// completion is counted in bytes by an mbarrier: one thread calls
// mbar_expect_tx with the bytes of a batch and starts its copies; every
// thread that reads the data first waits on the barrier's phase.  Used by
// the resident (T) kernel (triples_resident.cu) and the p3 dots probe
// (triples_probe.cu), both through wgmma_bf16.cuh.
//
// Shared memory that ordinary stores or loads touched before a bulk copy
// overwrites it is handed to the copy engine (the async proxy) with
// fence_proxy_async() before the barrier that precedes the copy; data of
// bulk copies is visible once their mbarrier phase has completed.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bulk {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
// makes initialised barriers visible to the copy engine
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// arrive (the barrier counts one) and expect bytes more of copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// arrive (the barrier counts one), with no bytes: a consumer releasing a
// stage to the thread that refills it
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}
// bytes (a multiple of 16; both addresses 16-byte aligned) from src to dst
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

}  // namespace bulk
