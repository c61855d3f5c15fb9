// Asynchronous copies from global memory into shared memory (cp.async,
// sm_80 and later): a thread starts 16-byte copies that bypass its
// registers and L1, groups them with commit, and later waits for all but
// the newest groups. The fused FeedForward forward (fused_ff.cu) streams
// its weights through a ring of shared-memory stages with them, so that
// the copy of the next slice overlaps the products on the current one; the
// spectral pass (spectral_mix.cu) streams its x rows so, and in f32 its
// factor slices too. Both addresses
// must be 16-byte aligned. A wait covers only the calling
// thread's copies: a __syncthreads after it makes every thread's copies
// visible to the block.
#pragma once

#include "common.cuh"

namespace rpde {

__device__ __forceinline__ void cp_async_16(void* smem_dst, const void* gmem_src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :
               : "r"(smem_u32(smem_dst)), "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `Pending` of the calling thread's groups are in flight
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" : : "n"(Pending) : "memory");
}

// Bulk asynchronous copies (the Tensor Memory Accelerator, sm_90): one
// thread copies a contiguous block of bytes (a multiple of 16, both
// addresses 16-byte aligned) from global into shared memory, and the
// copy's completion counts its bytes on an mbarrier in shared memory. The
// spectral pass (spectral_mix.cu) streams its weight modes so, one copy a
// mode.

__device__ __forceinline__ void mbarrier_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes initialized mbarriers visible to the bulk copies
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// orders the block's earlier accesses to shared memory before the bulk
// copies this thread issues next
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// arrives on bar, which then completes its phase once `bytes` more have
// landed
__device__ __forceinline__ void mbarrier_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy_to_shared(void* dst, const void* src, uint32_t bytes,
                                                    uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// waits until bar has completed the phase of the given parity
__device__ __forceinline__ void mbarrier_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

}  // namespace rpde
