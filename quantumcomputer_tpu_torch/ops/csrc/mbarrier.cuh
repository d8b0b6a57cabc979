// Shared-memory mbarriers and 1-D bulk copies (TMA, cp.async.bulk) for
// Hopper (sm_90a): the staging primitives of the matrix groups' table ring
// (fused_segment.cuh) and of the camodc permutation's tile ring
// (camodc_permute.cu).  One thread arms a barrier with the bytes it expects
// and issues the copies; every thread that reads the copied bytes waits for
// the barrier's phase.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr long long MBAR_WAIT_CYCLES = 20000000000LL;  // a wait this long is a fault: trap, do not hang

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try(bar, parity)) {
    if (clock64() - start > MBAR_WAIT_CYCLES) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// Copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from global
// memory to shared address dst, completing on barrier `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

}  // namespace
