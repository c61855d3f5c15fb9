// Warp-level bf16 matrix products on Hopper's tensor cores (mma.sync).
//
// Serves the bf16 products of the fused FeedForward backward (fused_ff_bwd.cu,
// which replaces resolution_pde_tpu/ops/pallas/fused_ff.py `_bwd_pallas`,
// whose three products a layer run on the TPU's MXU in bf16 with f32
// accumulation) and forward (fused_ff.cu, `_fwd_pallas`), and of the bf16
// spectral axis pass (spectral_staged.cu, ops/pallas/spectral_mix2.py
// `_pass_pallas`). block_gemm (common.cuh) does the same sums in scalar f32
// FMAs on the CUDA cores, at 67 TFLOP/s at most on an H100; the tensor
// cores offer 989 TFLOP/s in bf16.
//
// mma_gemm splits an (M x N) product into warp tiles of (16 MT) x (8 NT)
// outputs, which the block's warps take in turn. A warp keeps its tile's
// f32 sums in registers and walks the contraction axis 16 at a time:
// mma.sync.m16n8k16 (bf16 in, f32 sums) on fragments that the caller's
// loaders fill, from shared memory with ldmatrix (plain or transposed, so
// that no operand is copied into another layout) or from global memory
// (L2) with 32-bit loads of two neighbouring elements. The epilogue hands
// each (row, col, f32 sum) inside M x N to the caller's store, as
// block_gemm's does, so bias, GELU and the rounding to bf16 stay with the
// caller; mma_gemm_add instead adds the sums into f32 memory laid out in
// the products' own tile order, a float4 a lane. warp_tile_accumulate is
// the step underneath, for a caller that owns its warp tiles: it adds one
// range of the contraction into sums the caller keeps, so the operands can
// arrive in slices (the forward streams its weights through shared memory).
//
// What bounds it: the latency of the operands' loads, not the tensor
// cores. The fused backward gives each SM one block, whose products read
// weights from L2 and whose epilogues wait on device memory, so the design
// keeps loads in flight: B fragments two steps ahead in a ring of
// registers, every A fragment of a step issued before its products, and
// warp tiles small enough (64 x 16) for 16 warps a block in 128 registers
// a thread. Edges: the caller's operands are padded to multiples of 16 in
// the contraction and of 8 in N and hold finite values there, zeros past K
// in one of them, so any width works; fragments past M or N are neither
// loaded nor stored. The products of bf16 values are exact in f32; only
// the order of the f32 sums differs from a scalar loop, and it is fixed by
// the shapes, so a result does not depend on the launch.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace rpde {

// four 8x8 b16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// two matrices; the addresses of lanes 0..15 are read
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 products summed in f32
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragment loaders. Fragment layouts of m16n8k16, with g = lane / 4 and
// t = lane % 4: A (16 x 16) a0 = (g, 2t..2t+1), a1 = (g + 8, 2t..),
// a2 = (g, 2t + 8..), a3 = (g + 8, 2t + 8..); B (16 x 8) b0 = (2t..2t+1, g),
// b1 = (2t + 8.., g); sums c0, c1 = (g, 2t), (g, 2t + 1), c2, c3 the same
// at row g + 8.

// A[m][k] = s[m * ld + k] in shared memory (k contiguous)
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const __nv_bfloat16* s, int ld,
                                       int m0, int k0) {
  const int l = threadIdx.x % 32;
  ldsm_x4(a, s + (m0 + (l % 8) + ((l / 8) % 2) * 8) * ld + k0 + (l / 16) * 8);
}

// A[m][k] = s[k * ld + m] in shared memory (m contiguous): A read transposed
__device__ __forceinline__ void frag_a_trans(uint32_t (&a)[4], const __nv_bfloat16* s, int ld,
                                             int m0, int k0) {
  const int l = threadIdx.x % 32;
  ldsm_x4_trans(a, s + (k0 + (l % 8) + (l / 16) * 8) * ld + m0 + ((l / 8) % 2) * 8);
}

// B[k][n] = s[k * ld + n] in shared memory (n contiguous)
__device__ __forceinline__ void frag_b_trans(uint32_t (&b)[2], const __nv_bfloat16* s, int ld,
                                             int k0, int n0) {
  const int l = threadIdx.x % 32;
  ldsm_x2_trans(b, s + (k0 + (l % 8) + ((l / 8) % 2) * 8) * ld + n0);
}

// B[k][n] = m[n * ld + k] in global memory (k contiguous), read through
// the read-only cache. m is zero-padded to whole fragments: rows to a
// multiple of 8 past the last fragment read, ld to a multiple of 16.
__device__ __forceinline__ void frag_b_global(uint32_t (&b)[2], const __nv_bfloat16* m, int ld,
                                              int k0, int n0) {
  const int l = threadIdx.x % 32;
  const uint32_t* p = reinterpret_cast<const uint32_t*>(m + (n0 + l / 4) * ld + k0 + (l % 4) * 2);
  b[0] = __ldg(p);
  b[1] = __ldg(p + 4);
}

// Adds into acc, the sums of the warp tile of rows m0.. and columns n0.. of
// an (M x N) product, the terms of the contraction range [k_begin, k_end):
// acc[i][j] holds the fragment of rows m0 + 16 i.., columns n0 + 8 j...
// load_a(a, m0, k0) fills the A fragment of rows m0.., columns k0..;
// load_b(b, k0, n0) the B fragment of rows k0.., columns n0... The range is
// read in steps of 16 from k_begin (a multiple of 16): the loaders must
// give finite values up to k_end rounded up to 16, and zeros past the
// contraction's end in one of the two operands. B fragments are loaded BS
// - 1 steps ahead, in a ring of BS steps: a load from L2 then has BS - 1
// steps of products to arrive (BS = 1 loads each step's B just before its
// products, for operands in shared memory).
constexpr int kBStages = 3;

template <int MT, int NT, int BS, typename LoadA, typename LoadB>
__device__ __forceinline__ void warp_tile_accumulate(float (&acc)[MT][NT][4], int m0, int n0,
                                                     int M, int N, int k_begin, int k_end,
                                                     LoadA& load_a, LoadB& load_b) {
  uint32_t b[BS][NT][2];
  auto fetch_b = [&](uint32_t (&bs)[NT][2], int k0) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (n0 + 8 * j < N) load_b(bs[j], k0, n0 + 8 * j);
  };
#pragma unroll
  for (int st = 0; st < BS - 1; ++st)
    if (k_begin + 16 * st < k_end) fetch_b(b[st], k_begin + 16 * st);
  for (int k0 = k_begin; k0 < k_end; k0 += 16 * BS) {
#pragma unroll
    for (int st = 0; st < BS; ++st) {
      const int k = k0 + 16 * st;
      if (k >= k_end) break;
      const int ahead = k + 16 * (BS - 1);
      if (ahead < k_end) fetch_b(b[(st + BS - 1) % BS], ahead);
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        if (m0 + 16 * i < M) load_a(a[i], m0 + 16 * i, k);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (m0 + 16 * i >= M) continue;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          if (n0 + 8 * j < N) mma_bf16_16816(acc[i][j], a[i], b[st][j]);
      }
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero_sums(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
}

// The sums acc of the warp tile of rows m0.. and columns n0.. of an (M x N)
// product over the whole contraction K, as warp_tile_accumulate reads it,
// with B fragments kBStages - 1 steps ahead.
template <int MT, int NT, typename LoadA, typename LoadB>
__device__ __forceinline__ void warp_tile_sums(float (&acc)[MT][NT][4], int m0, int n0,
                                               int M, int N, int K, LoadA& load_a,
                                               LoadB& load_b) {
  zero_sums(acc);
  warp_tile_accumulate<MT, NT, kBStages>(acc, m0, n0, M, N, 0, K, load_a, load_b);
}

// row and column of sum c of fragment (i, j) of a warp tile at (m0, n0)
__device__ __forceinline__ int frag_row(int m0, int i, int c) {
  return m0 + 16 * i + (threadIdx.x % 32) / 4 + (c / 2) * 8;
}
__device__ __forceinline__ int frag_col(int n0, int j, int c) {
  return n0 + 8 * j + 2 * (threadIdx.x % 4) + c % 2;
}

// For i < M, j < N: store(i, j, sum over k < K of A[i][k] B[k][j]), the
// operands from load_a and load_b as warp_tile_sums reads them.
template <int MT, int NT, typename LoadA, typename LoadB, typename StoreFn>
__device__ void mma_block_gemm(int M, int N, int K, LoadA load_a, LoadB load_b,
                               StoreFn store) {
  const int mt = (M + 16 * MT - 1) / (16 * MT);
  const int nt = (N + 8 * NT - 1) / (8 * NT);
  for (int it = threadIdx.x / 32; it < mt * nt; it += blockDim.x / 32) {
    const int m0 = (it / nt) * 16 * MT;
    const int n0 = (it % nt) * 8 * NT;
    float acc[MT][NT][4];
    warp_tile_sums(acc, m0, n0, M, N, K, load_a, load_b);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = frag_row(m0, i, c), col = frag_col(n0, j, c);
          if (r < M && col < N) store(r, col, acc[i][j][c]);
        }
  }
}

// Index of the sum (r, c) of an (M x N) product in tile order: warp tile
// it (of 16 MT x 8 NT outputs, row-major over the tiles), fragment (i, j)
// of it, one float4 a lane holding the lane's sums c0..c3.
__host__ __device__ inline long long tile_order_index(int r, int c, int N, int MT, int NT) {
  const int nt = (N + 8 * NT - 1) / (8 * NT);
  const int it = (r / (16 * MT)) * nt + c / (8 * NT);
  const int i = (r % (16 * MT)) / 16, j = (c % (8 * NT)) / 8;
  const int rr = r % 16, cc = c % 8;
  const int lane = (rr % 8) * 4 + cc / 2;
  return (static_cast<long long>(it * MT * NT + i * NT + j) * 32 + lane) * 4 + (rr / 8) * 2 +
         cc % 2;
}

// Floats of an (M x N) product in tile order: whole warp tiles.
__host__ __device__ inline long long tile_order_size(int M, int N, int MT, int NT) {
  return static_cast<long long>((M + 16 * MT - 1) / (16 * MT)) * ((N + 8 * NT - 1) / (8 * NT)) *
         MT * NT * 32 * 4;
}

// dst = (add ? dst : 0) + the sums, dst in global memory in tile order
// (16-byte aligned): each lane reads and writes its sums as float4s, a
// warp 512 contiguous bytes at a time, and a warp tile's old sums are all
// loaded before the first is stored, so that their loads are in flight
// together. Fragments past M or N hold zeros.
template <int MT, int NT, typename LoadA, typename LoadB>
__device__ void mma_block_gemm_add(int M, int N, int K, LoadA load_a, LoadB load_b,
                                   float* __restrict__ dst, bool add) {
  const int mt = (M + 16 * MT - 1) / (16 * MT);
  const int nt = (N + 8 * NT - 1) / (8 * NT);
  for (int it = threadIdx.x / 32; it < mt * nt; it += blockDim.x / 32) {
    const int m0 = (it / nt) * 16 * MT;
    const int n0 = (it % nt) * 8 * NT;
    float acc[MT][NT][4];
    warp_tile_sums(acc, m0, n0, M, N, K, load_a, load_b);
    float4* d = reinterpret_cast<float4*>(dst) + static_cast<long long>(it) * MT * NT * 32 +
                threadIdx.x % 32;
    if (add) {
      float4 old[MT][NT];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) old[i][j] = d[(i * NT + j) * 32];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          acc[i][j][0] += old[i][j].x;
          acc[i][j][1] += old[i][j].y;
          acc[i][j][2] += old[i][j].z;
          acc[i][j][3] += old[i][j].w;
        }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        d[(i * NT + j) * 32] = make_float4(acc[i][j][0], acc[i][j][1], acc[i][j][2], acc[i][j][3]);
  }
}

// The warp tiles of mma_gemm and mma_gemm_add: wide ones (64 x 16
// outputs) when they give each of a block's `warps` warps a tile,
// otherwise narrow ones (32 x 8). Their sums, operands and three steps of
// B fragments fit the 128 registers a thread of a 512-thread block has.
constexpr int kWideMT = 4, kWideNT = 2, kNarrowMT = 2, kNarrowNT = 1;

__host__ __device__ inline bool wide_warp_tiles(int M, int N, int warps) {
  return ((M + 16 * kWideMT - 1) / (16 * kWideMT)) * ((N + 8 * kWideNT - 1) / (8 * kWideNT)) >=
         warps;
}

// mma_block_gemm with the warp tile picked from the product's shape
template <typename LoadA, typename LoadB, typename StoreFn>
__device__ void mma_gemm(int M, int N, int K, LoadA load_a, LoadB load_b, StoreFn store) {
  if (wide_warp_tiles(M, N, static_cast<int>(blockDim.x) / 32))
    mma_block_gemm<kWideMT, kWideNT>(M, N, K, load_a, load_b, store);
  else
    mma_block_gemm<kNarrowMT, kNarrowNT>(M, N, K, load_a, load_b, store);
}

// mma_block_gemm_add with wide or narrow warp tiles, as the caller laid dst
// out
template <typename LoadA, typename LoadB>
__device__ void mma_gemm_add(int M, int N, int K, LoadA load_a, LoadB load_b, float* dst,
                             bool add, bool wide) {
  if (wide)
    mma_block_gemm_add<kWideMT, kWideNT>(M, N, K, load_a, load_b, dst, add);
  else
    mma_block_gemm_add<kNarrowMT, kNarrowNT>(M, N, K, load_a, load_b, dst, add);
}

}  // namespace rpde
