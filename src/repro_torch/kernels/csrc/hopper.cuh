// Hopper (sm_90a) building blocks shared by the kernels of this directory:
// shared-memory addresses, mbarriers, 1-D bulk copies (TMA) and 4-byte
// cp.async completing on an mbarrier, the wgmma matrix descriptor of a
// 128-byte swizzled tile, and the wgmma fence / commit / wait.
#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first ALIGN-byte-aligned byte of the dynamic shared array `base`,
// reached by an offset from the array itself: the compiler then keeps the
// accesses through it in the shared window (LDS / STS), where a round trip
// through an integer would leave them generic loads and stores.
template <int ALIGN>
__device__ __forceinline__ uint8_t* smem_align(uint8_t* base) {
  return base + ((ALIGN - (smem_u32(base) & (ALIGN - 1))) & (ALIGN - 1));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// 1-D bulk copy (TMA) of `bytes` global -> shared, completing as
// transaction bytes on `bar`: addresses and size multiples of 16.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 4 bytes global -> shared, asynchronously (any 4-byte-aligned address).
__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// One more arrival on `bar`, made when every cp.async this thread issued
// before it has landed (the expected count is raised first, so the
// barrier's count at init is unchanged).
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle (the layout TMA
// writes with CU_TENSOR_MAP_SWIZZLE_128B), tile base 1024-byte aligned.
// K-major operands: rows of 128 bytes, 8-row groups 1024 bytes apart
// (SBO); a k-step moves the start address within the row.  MN-major: 8
// k-rows of 128 bytes per 1024-byte group (SBO), the next 128 bytes of N
// `lbo` bytes further (LBO).
__device__ __forceinline__ uint64_t sw128_desc(const void* p,
                                               uint32_t lbo = 0) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pin accumulator registers in place: no use of them is moved across the
// asynchronous wgmma's issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
