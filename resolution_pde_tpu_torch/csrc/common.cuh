// Shared device helpers for the port's hand-written Hopper kernels.
//
// block_gemm is the CUDA-core matrix-product routine of the fused
// FeedForward forward's f32 products for chains too wide for
// f32_tile_gemm's buffers (fused_ff.cu); its bf16 products run on the
// tensor cores instead (mma.cuh), and both directions' other f32 products
// on weights streamed through shared memory (f32_tile_gemm, fused_ff.cuh). The
// spectral passes (spectral_mix.cu in f32, spectral_staged.cu in bf16)
// have block products of their own. load_rows stages rows of a tile into shared memory for both
// FeedForward kernels.
// In block_gemm every thread of the block owns RM x RN outputs of a
// product and keeps them in registers while it walks the
// contraction axis with IEEE f32 FMAs. Operands are read
// through functors, so one routine serves every layout the kernels stage in
// shared memory or read from global memory (L2). The sum over k runs in
// order, so a result does not depend on the launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace rpde {

constexpr int kThreads = 256;
// dynamic shared memory a block may use (of the 227 KB Hopper offers)
constexpr int kSmemBudget = 200 * 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// the value a cast to T leaves, back in f32
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// For i < M, j < N: store(i, j, sum_k a(i, k) * bm(k, j)).
template <int RM, int RN, typename AFn, typename BFn, typename StoreFn>
__device__ void block_gemm(int M, int N, int K, AFn a, BFn bm, StoreFn store) {
  const int mt = (M + RM - 1) / RM;
  const int nt = (N + RN - 1) / RN;
  const int items = mt * nt;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int i0 = (it / nt) * RM;
    const int j0 = (it % nt) * RN;
    float acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < K; ++k) {
      float av[RM], bv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) av[i] = (i0 + i < M) ? a(i0 + i, k) : 0.f;
#pragma unroll
      for (int j = 0; j < RN; ++j) bv[j] = (j0 + j < N) ? bm(k, j0 + j) : 0.f;
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j)
        if (i0 + i < M && j0 + j < N) store(i0 + i, j0 + j, acc[i][j]);
  }
}

// Picks the register tile from the product's shape: 1x8 for products of
// fewer than four rows, otherwise 8x8 when that still gives every thread of
// the block work and 4x4 when it would not.
template <typename AFn, typename BFn, typename StoreFn>
__device__ void gemm(int M, int N, int K, AFn a, BFn bm, StoreFn store) {
  if (M < 4) {
    block_gemm<1, 8>(M, N, K, a, bm, store);
  } else if (((M + 7) / 8) * ((N + 7) / 8) >= static_cast<int>(blockDim.x)) {
    block_gemm<8, 8>(M, N, K, a, bm, store);
  } else {
    block_gemm<4, 4>(M, N, K, a, bm, store);
  }
}

// dst[r * ld + c] = src[r * width + c] converted to D, for r < rows and
// c < width; src is read 16 bytes a thread where it is 16-byte aligned,
// those loads in flight together.
template <typename D, typename S>
__device__ void load_rows(D* dst, int ld, const S* __restrict__ src, int rows, int width) {
  constexpr int kVec = 16 / sizeof(S);
  const int n = rows * width;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
    const int nv = n / kVec;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
#pragma unroll 4
    for (int v = threadIdx.x; v < nv; v += blockDim.x) {
      const uint4 u = __ldg(s4 + v);
      const S* e = reinterpret_cast<const S*>(&u);
      int r = (v * kVec) / width;
      int c = v * kVec - r * width;
#pragma unroll
      for (int q = 0; q < kVec; ++q) {
        dst[r * ld + c] = from_f<D>(to_f(e[q]));
        if (++c == width) {
          c = 0;
          ++r;
        }
      }
    }
    done = nv * kVec;
  }
  for (int idx = done + threadIdx.x; idx < n; idx += blockDim.x) {
    const int r = idx / width;
    dst[r * ld + idx - r * width] = from_f<D>(to_f(src[idx]));
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace rpde
