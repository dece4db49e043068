// Hopper primitives shared by the kernels of csrc/: shared-memory addresses,
// mbarriers and 1-D bulk copies from global memory that complete on one.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rgmf {

// ---- Hopper copy primitives -------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival that also expects `bytes` of bulk copies to complete on `bar`.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra WAIT;\n}" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Orders this thread's earlier generic-proxy accesses of shared memory before
// later async-proxy (bulk copy) accesses.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Bulk copy of `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// global to this CTA's shared memory, completing on `bar`. Issued in pieces of
// at most 32 KiB.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  const char* s = static_cast<const char*>(src);
  char* d = static_cast<char*>(dst);
  for (uint32_t off = 0; off < bytes; off += 32768u) {
    const uint32_t n = bytes - off < 32768u ? bytes - off : 32768u;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_u32(d + off)),
        "l"(s + off), "r"(n), "r"(smem_u32(bar))
        : "memory");
  }
}

}  // namespace rgmf
