// Asynchronous copies from global memory into shared memory (cp.async,
// sm_80 and later): a thread starts 16-byte copies that bypass its
// registers and L1, groups them with commit, and later waits for all but
// the newest groups. The fused FeedForward forward (fused_ff.cu) streams
// its weights through a ring of shared-memory stages with them, so that
// the copy of the next slice overlaps the products on the current one; the
// spectral passes stream their slices so (the f32 pass, spectral_mix.cu,
// its factor and x slices; the bf16 staged route, spectral_staged.cu, the
// slices of its three products). Both addresses must be 16-byte aligned.
// A wait covers only the calling thread's copies: a __syncthreads after it
// makes every thread's copies visible to the block.
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

}  // namespace rpde
