// Shared device helpers for the port's hand-written Hopper kernels.
//
// block_gemm is the one matrix-product routine both kernels use: every
// thread of the block owns RM x RN outputs of a (batched) product and keeps
// them in registers while it walks the contraction axis with IEEE f32 FMAs.
// Operands are read through functors, so one routine serves every layout
// the kernels stage in shared memory or read from global memory (L2).
// The sum over k runs in order, so a result does not depend on the launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rpde {

constexpr int kThreads = 256;
// dynamic shared memory a block may use (of the 227 KB Hopper offers)
constexpr int kSmemBudget = 200 * 1024;

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

// For b < batch, i < M, j < N: store(b, i, j, sum_k a(b, i, k) * bm(b, k, j)).
template <int RM, int RN, typename AFn, typename BFn, typename StoreFn>
__device__ void block_gemm(int batch, int M, int N, int K, AFn a, BFn bm,
                           StoreFn store) {
  const int mt = (M + RM - 1) / RM;
  const int nt = (N + RN - 1) / RN;
  const int per_batch = mt * nt;
  const int items = batch * per_batch;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int bi = it / per_batch;
    const int rem = it - bi * per_batch;
    const int i0 = (rem / nt) * RM;
    const int j0 = (rem % nt) * RN;
    float acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < K; ++k) {
      float av[RM], bv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) av[i] = (i0 + i < M) ? a(bi, i0 + i, k) : 0.f;
#pragma unroll
      for (int j = 0; j < RN; ++j) bv[j] = (j0 + j < N) ? bm(bi, k, j0 + j) : 0.f;
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j)
        if (i0 + i < M && j0 + j < N) store(bi, i0 + i, j0 + j, acc[i][j]);
  }
}

// Picks the register tile from the product's shape: 1x8 for products of
// fewer than four rows, otherwise 8x8 when that still gives every thread of
// the block work and 4x4 when it would not.
template <typename AFn, typename BFn, typename StoreFn>
__device__ void gemm(int batch, int M, int N, int K, AFn a, BFn bm,
                     StoreFn store) {
  if (M < 4) {
    block_gemm<1, 8>(batch, M, N, K, a, bm, store);
  } else if (batch * ((M + 7) / 8) * ((N + 7) / 8) >= static_cast<int>(blockDim.x)) {
    block_gemm<8, 8>(batch, M, N, K, a, bm, store);
  } else {
    block_gemm<4, 4>(batch, M, N, K, a, bm, store);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace rpde
