// What the fused FeedForward's forward (fused_ff.cu) and backward
// (fused_ff_bwd.cu) kernels share: the layer limit, the LayerNorm epsilon,
// GELU and its derivative, written as the JAX kernel writes them
// (resolution_pde_tpu/ops/pallas/fused_ff.py `_gelu`, `_gelu_grad`), and
// f32_tile_gemm, the IEEE f32 product of a tile of rows with a layer's
// weight that the backward's f32 mode runs.
#pragma once

#include "async_copy.cuh"
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

// f32_tile_gemm's weight ring: two stages of kF32SliceRows rows of the
// contraction each.
constexpr int kF32SliceRows = 32;

// Floats of shared memory f32_tile_gemm's ring takes for outputs up to np
// (a multiple of 4) wide in a block of `threads`: its two stages, and at
// least the 16 floats a thread through which the contraction groups' sums
// are added.
__host__ __device__ inline int f32_ring_floats(int np, int threads) {
  const int stages = 2 * kF32SliceRows * np;
  return stages > 16 * threads ? stages : 16 * threads;
}

// Threads f32_tile_gemm needs for rows x np outputs: one a register tile
// of 8 rows x 4 columns, the columns in blocks of 32. The caller keeps it
// within the block's threads.
__host__ __device__ inline int f32_tile_gemm_threads(int rows, int np) {
  return (np + 31) / 32 * ((rows + 7) / 8) * 8;
}

// Starts the copies of slice s of f32_tile_gemm's b (kp x np) into its
// stage of the ring, 16 bytes a copy, and commits them as one group.
__device__ __forceinline__ void f32_start_slice(float* ring, const float* __restrict__ b, int kp,
                                                int np, int s) {
  const int k0 = s * kF32SliceRows;
  const int pieces = min(kF32SliceRows, kp - k0) * (np / 4);
  float* dst = ring + (s & 1) * kF32SliceRows * np;
  const float* src = b + static_cast<long long>(k0) * np;
  for (int i = threadIdx.x; i < pieces; i += blockDim.x) cp_async_16(dst + 4 * i, src + 4 * i);
  cp_async_commit();
}

// For r < rows and j0 = 0, 4, .. < np: store(r, j0, v) with
// v[q] = sum over k < kp of a[r * lda + k] * b[k * np + j0 + q], in IEEE
// f32 FMAs on the CUDA cores.
//   a: shared memory, row-major, lda a multiple of 4 and rows 16-byte
//      aligned; read on columns < kp and on rows up to the next multiple of
//      8 (the sums of rows >= rows are dropped), which must be finite.
//   b: global memory, (kp, np) row-major, both multiples of 4, 16-byte
//      aligned, zero on the rows and columns the caller padded. It is
//      streamed in slices of kF32SliceRows rows through the ring's two
//      stages (f32_ring_floats) by 16-byte cp.async copies: a slice is
//      contiguous in b and in its stage, and the next one's copy overlaps
//      the products on this one.
// A thread owns a register tile of 8 rows x 4 columns: rows rg, rg + m8,
// .. of the m8 row groups, so that neighbouring row groups read rows one
// apart, in other banks for lda = 4 mod 32. A warp's lanes hold 4 row
// groups x 8 column groups, so each of a k-step's 12 16-byte shared loads
// (8 of A, 4 of B, for 128 FMAs) reads 4 or 8 distinct 16-byte pieces, 64
// or 128 bytes: one pass of the banks.
// The contraction is split over G groups of threads (G = 1, 2, 4, 8, as
// many as the block's threads hold): group g takes rows g * 32 / G .. of
// every slice, each thread summing its k in order, and the G sums are then
// added pairwise through the ring in a fixed tree order, each group ending
// with 8 / G rows of the tile, whose stores it makes: the epilogue is
// spread over every group. So the order of every sum is fixed by the
// shapes and the block size.
// Every thread of the block calls it, after a barrier that follows the
// block's last use of the ring, with f32_tile_gemm_threads(rows, np) <=
// blockDim.x; it ends with the stores, without a barrier.
// With `started` the caller has already started slice 0
// (f32_start_slice), so that its copy overlaps other work.
template <typename StoreFn>
__device__ void f32_tile_gemm(int rows, int kp, int np, const float* a, int lda,
                              const float* __restrict__ b, float* ring, bool started,
                              StoreFn store) {
  const int m8 = (rows + 7) / 8;
  const int n4 = np / 4;
  // register tiles in blocks of 8 column groups, each block's row groups
  // in turn, so that a warp's 32 lanes take 4 row groups x 8 column groups
  const int tiles = f32_tile_gemm_threads(rows, np);
  const int threads = static_cast<int>(blockDim.x);
  const int t = static_cast<int>(threadIdx.x);
  int groups = 1;
  while (groups < 8 && 2 * groups * tiles <= threads) groups *= 2;
  const int part = kF32SliceRows / groups;
  const int stage = kF32SliceRows * np;
  const int n_slices = (kp + kF32SliceRows - 1) / kF32SliceRows;
  const int g = t / tiles;
  const int tile = t - g * tiles;
  const int rg = (tile >> 3) % m8;
  const int cg = (tile >> 3) / m8 * 8 + (tile & 7);
  const bool active = g < groups && cg < n4;
  const int j0 = active ? cg * 4 : 0;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
  if (!started) f32_start_slice(ring, b, kp, np, 0);
  for (int s = 0; s < n_slices; ++s) {
    // slice s has landed (this thread's copies, then everyone's), and
    // every thread is done with the stage that slice s + 1 overwrites
    cp_async_wait<0>();
    __syncthreads();
    if (s + 1 < n_slices) f32_start_slice(ring, b, kp, np, s + 1);
    if (!active) continue;
    const int k0 = s * kF32SliceRows;
    const int kb = k0 + g * part;
    const int ke = min(kb + part, kp);
    const float* st = ring + (s & 1) * stage + j0;
#pragma unroll 1
    for (int k = kb; k < ke; k += 4) {
      float4 av[8], bv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = *reinterpret_cast<const float4*>(a + (rg + i * m8) * lda + k);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        bv[q] = *reinterpret_cast<const float4*>(st + (k - k0 + q) * np);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float ak[4] = {av[i].x, av[i].y, av[i].z, av[i].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[i][0] = fmaf(ak[q], bv[q].x, acc[i][0]);
          acc[i][1] = fmaf(ak[q], bv[q].y, acc[i][1]);
          acc[i][2] = fmaf(ak[q], bv[q].z, acc[i][2]);
          acc[i][3] = fmaf(ak[q], bv[q].w, acc[i][3]);
        }
      }
    }
  }
  // the groups' sums by recursive halving, so that every group stores 8 /
  // G of the tile's rows: in the round of distance h, groups g and g ^ h
  // hold the same rows; each keeps one half of them (the upper where g &
  // h), hands the other to its partner through the ring (element-major,
  // so that neighbouring lanes touch neighbouring floats) and adds the
  // partner's sums of its own half. Rows are picked by predicates in
  // unrolled loops, so acc stays in registers.
  int lo = 0, held = 8;  // the rows i = lo .. lo + held - 1 still held
  for (int h = groups / 2; h >= 1; h /= 2) {
    held /= 2;
    const int keep = (g & h) ? lo + held : lo;
    const int give = (g & h) ? lo : lo + held;
    __syncthreads();  // the ring is free: no product or add still reads it
    if (active)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i >= give && i < give + held)
#pragma unroll
          for (int q = 0; q < 4; ++q) ring[((i - give) * 4 + q) * threads + t] = acc[i][q];
    __syncthreads();
    const int partner = (g ^ h) * tiles + tile;
    if (active)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i >= keep && i < keep + held)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] += ring[((i - keep) * 4 + q) * threads + partner];
    lo = keep;
  }
  if (active)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = rg + i * m8;
      if (i >= lo && i < lo + held && r < rows) store(r, j0, acc[i]);
    }
}

}  // namespace rpde
