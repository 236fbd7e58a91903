// Asynchronous copies into shared memory on Hopper, shared by the kernels
// that stream tiles through a ring: per-thread cp.async (16, 8 or 4
// bytes, zero-filled when not valid) and the TMA unit's bulk copy of one
// contiguous span with its completion on an mbarrier (bulk_copy_once for
// data read once: its lines are the first the L2 cache evicts).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace async_copy {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  const uint32_t d = smem_u32(dst);
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;"
                 ::"r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
  else if (BYTES == 8)
    asm volatile("cp.async.ca.shared.global.L2::128B [%0], [%1], 8, %2;"
                 ::"r"(d), "l"(src), "r"(valid ? 8 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global.L2::128B [%0], [%1], 4, %2;"
                 ::"r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// waits until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// spins until the phase with the given parity has completed; a copy that
// never lands (a fault) traps after ~10 s instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  do {
    if (clock64() - t0 > 20000000000LL) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// one contiguous span of global memory into shared memory by the TMA unit
// (bytes a multiple of 16, both ends 16-byte aligned)
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(smem_u32(bar))
      : "memory");
}

// bulk_copy for a span read only once (a streamed table): marked evict
// first in L2, so that it does not push out what is still to be used
__device__ __forceinline__ void bulk_copy_once(float* dst, const float* src,
                                               uint32_t bytes, uint64_t* bar) {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

}  // namespace async_copy
