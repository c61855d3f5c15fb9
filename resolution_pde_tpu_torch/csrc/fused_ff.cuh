// What the fused FeedForward's forward (fused_ff.cu) and backward
// (fused_ff_bwd.cu) kernels share: the layer limit, the LayerNorm epsilon,
// GELU and its derivative, written as the JAX kernel writes them
// (resolution_pde_tpu/ops/pallas/fused_ff.py `_gelu`, `_gelu_grad`).
#pragma once

#include "common.cuh"

namespace rpde {

constexpr int kMaxLayers = 32;
constexpr float kLnEps = 1e-5f;  // torch.nn.LayerNorm default

__device__ __forceinline__ float gelu(float z, bool approx) {
  if (approx) {
    const float u = 0.7978845608028654f * (z + 0.044715f * z * z * z);
    return 0.5f * z * (1.0f + tanhf(u));
  }
  return 0.5f * z * (1.0f + erff(z * 0.7071067811865476f));
}

__device__ __forceinline__ float gelu_grad(float z, bool approx) {
  if (approx) {
    const float z2 = z * z;
    const float t = tanhf(0.7978845608028654f * (z + 0.044715f * z * z2));
    const float du = 0.7978845608028654f * (1.0f + 3.0f * 0.044715f * z2);
    return 0.5f * (1.0f + t) + 0.5f * z * (1.0f - t * t) * du;
  }
  const float cdf = 0.5f * (1.0f + erff(z * 0.7071067811865476f));
  return cdf + z * (0.3989422804014327f * expf(-0.5f * z * z));
}

// GELU and its derivative as calls: the tensor-core epilogues apply them to
// each of a thread's 64 sums, unrolled, and inlined there they would swell
// the kernel past what the instruction caches hold.
static __device__ __noinline__ float gelu_call(float z, bool approx) { return gelu(z, approx); }
static __device__ __noinline__ float gelu_grad_call(float z, bool approx) {
  return gelu_grad(z, approx);
}

}  // namespace rpde
