// What the fused FeedForward's forward (fused_ff.cu) and backward
// (fused_ff_bwd.cu) kernels share: the layer limit, the LayerNorm epsilon,
// GELU and its derivative, written as the JAX kernel writes them
// (resolution_pde_tpu/ops/pallas/fused_ff.py `_gelu`, `_gelu_grad`), and
// f32_tile_gemm, the IEEE f32 product of a tile of rows with a layer's
// weight that both kernels' f32 modes run.
#pragma once

#include <type_traits>

#include "async_copy.cuh"
#include "common.cuh"

namespace rpde {

constexpr int kMaxLayers = 32;
constexpr float kLnEps = 1e-5f;  // torch.nn.LayerNorm default

__host__ __device__ inline int pad4(int d) { return (d + 3) / 4 * 4; }

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
// contraction each, a row holding the columns of one chunk of the output:
// all of them up to kF32ChunkCols, else chunks of kF32ChunkCols (the last
// one narrower), each streamed and multiplied in turn.
constexpr int kF32SliceRows = 32;
constexpr int kF32ChunkCols = 256;

// Columns of the first (and widest) chunk of an output np wide.
__host__ __device__ inline int f32_chunk_cols(int np) {
  return np < kF32ChunkCols ? np : kF32ChunkCols;
}

// Floats of shared memory f32_tile_gemm's ring takes for outputs up to np
// (a multiple of 4) wide in a block of `threads`: its two stages, as wide
// as a chunk, and at least the 16 floats a thread through which the
// contraction groups' sums are added.
__host__ __device__ inline int f32_ring_floats(int np, int threads) {
  const int stages = 2 * kF32SliceRows * f32_chunk_cols(np);
  return stages > 16 * threads ? stages : 16 * threads;
}

// Threads f32_tile_gemm needs for rows x np outputs (np the columns of a
// chunk: f32_chunk_cols): one a register tile of 8 rows x 4 columns, the
// columns in blocks of 32. The caller keeps it within the block's threads;
// up to 64 rows a chunk takes at most 512.
__host__ __device__ inline int f32_tile_gemm_threads(int rows, int np) {
  return (np + 31) / 32 * ((rows + 7) / 8) * 8;
}

// Starts the copies of slice s of f32_tile_gemm's b (kp x np) into its
// stage of the ring, 16 bytes a copy, and commits them as one group: the
// chunk of nc columns from c0, each slice row of the stage nc floats.
// A slice of the whole width is contiguous in b; a chunk's rows lie np
// apart there.
__device__ __forceinline__ void f32_start_slice(float* ring, const float* __restrict__ b, int kp,
                                                int np, int c0, int nc, int s) {
  const int k0 = s * kF32SliceRows;
  const int k_rows = min(kF32SliceRows, kp - k0);
  float* dst = ring + (s & 1) * kF32SliceRows * nc;
  const float* src = b + static_cast<long long>(k0) * np + c0;
  if (nc == np) {
    const int pieces = k_rows * (np / 4);
    for (int i = threadIdx.x; i < pieces; i += blockDim.x) cp_async_16(dst + 4 * i, src + 4 * i);
  } else {
    const int per_row = nc / 4;
    for (int i = threadIdx.x; i < k_rows * per_row; i += blockDim.x) {
      const int r = i / per_row, q = i - r * per_row;
      cp_async_16(dst + r * nc + 4 * q, src + static_cast<long long>(r) * np + 4 * q);
    }
  }
  cp_async_commit();
}

// Starts slice 0 of f32_tile_gemm<kChunks>'s b (kp x np): its first
// chunk's.
template <bool kChunks>
__device__ __forceinline__ void f32_start_first_slice(float* ring, const float* __restrict__ b,
                                                      int kp, int np) {
  f32_start_slice(ring, b, kp, np, 0, kChunks ? f32_chunk_cols(np) : np, 0);
}

// f32_tile_gemm's default for `then`: nothing, and no barrier for it.
struct F32NoThen {
  __device__ void operator()() const {}
};

// One column chunk of f32_tile_gemm: columns c0 .. c0 + nc of its output,
// nc <= kF32ChunkCols (or all of them where np fits the ring whole); with
// `more`, the first slice of the next chunk is started once the ring is
// free, else `then` is called there, where one is given.
template <typename StoreFn, typename ThenFn>
__device__ __forceinline__ void f32_tile_chunk(int rows, int kp, int np, int c0, int nc,
                                               const float* a, int lda,
                                               const float* __restrict__ b, float* ring,
                                               bool started, StoreFn& store, ThenFn& then,
                                               bool more) {
  constexpr bool kThen = !std::is_same<ThenFn, F32NoThen>::value;
  const int m8 = (rows + 7) / 8;
  const int n4 = nc / 4;
  // register tiles in blocks of 8 column groups, each block's row groups
  // in turn, so that a warp's 32 lanes take 4 row groups x 8 column groups
  const int tiles = f32_tile_gemm_threads(rows, nc);
  const int threads = static_cast<int>(blockDim.x);
  const int t = static_cast<int>(threadIdx.x);
  int groups = 1;
  while (groups < 8 && 2 * groups * tiles <= threads) groups *= 2;
  const int part = kF32SliceRows / groups;
  const int stage = kF32SliceRows * nc;
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
  if (!started) f32_start_slice(ring, b, kp, np, c0, nc, 0);
  for (int s = 0; s < n_slices; ++s) {
    // slice s has landed (this thread's copies, then everyone's), and
    // every thread is done with the stage that slice s + 1 overwrites
    cp_async_wait<0>();
    __syncthreads();
    if (s + 1 < n_slices) f32_start_slice(ring, b, kp, np, c0, nc, s + 1);
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
        bv[q] = *reinterpret_cast<const float4*>(st + (k - k0 + q) * nc);
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
  // the next chunk's first slice (or the caller's copies) while this
  // chunk's sums are stored
  if (more || kThen) {
    __syncthreads();  // every thread is done with the ring
    if (more)
      f32_start_slice(ring, b, kp, np, c0 + nc, min(np - c0 - nc, kF32ChunkCols), 0);
    else
      then();
  }
  if (active)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = rg + i * m8;
      if (i >= lo && i < lo + held && r < rows) store(r, c0 + j0, acc[i]);
    }
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
//      stages (f32_ring_floats) by 16-byte cp.async copies, and the next
//      slice's copy overlaps the products on this one.
// kChunks: an output wider than kF32ChunkCols runs in column chunks
// (f32_chunk_cols), one after another, each streaming its own columns of
// every slice, the copy of a chunk's first slice overlapping the stores
// of the one before. Without it np must fit the ring whole: a kernel for
// chains no wider than kF32ChunkCols compiles no chunk code at all (the
// f32 backward at the bench widths runs 5 % slower with it, PERF.md).
// A thread owns a register tile of 8 rows x 4 columns: rows rg, rg + m8,
// .. of the m8 row groups, so that neighbouring row groups read rows one
// apart, in other banks for lda = 4 mod 32. A warp's lanes hold 4 row
// groups x 8 column groups, so each of a k-step's 12 16-byte shared loads
// (8 of A, 4 of B, for 128 FMAs) reads 4 or 8 distinct 16-byte pieces, 64
// or 128 bytes: one pass of the banks.
// The contraction is split over G groups of threads (G = 1, 2, 4, 8, as
// many as the block's threads hold beside a chunk's tiles): group g takes
// rows g * 32 / G .. of every slice, each thread summing its k in order,
// and the G sums are then added pairwise through the ring in a fixed tree
// order, each group ending with 8 / G rows of the tile, whose stores it
// makes: the epilogue is spread over every group. So the order of every
// sum is fixed by the shapes and the block size.
// Every thread of the block calls it, after a barrier that follows the
// block's last use of the ring, with f32_tile_gemm_threads(rows,
// f32_chunk_cols(np)) <= blockDim.x; it ends with the stores, without a
// barrier. With `started` the caller has already started slice 0
// (f32_start_first_slice<kChunks>), so that its copy overlaps other work. `then`,
// where given, is called by every thread once the ring is free (after a
// barrier), before the last chunk's stores: the caller starts its next
// copies into the ring there.
template <bool kChunks, typename StoreFn, typename ThenFn = F32NoThen>
__device__ void f32_tile_gemm(int rows, int kp, int np, const float* a, int lda,
                              const float* __restrict__ b, float* ring, bool started,
                              StoreFn store, ThenFn then = ThenFn{}) {
  if constexpr (!kChunks) {
    f32_tile_chunk(rows, kp, np, 0, np, a, lda, b, ring, started, store, then, false);
  } else {
    for (int c0 = 0; c0 < np; c0 += kF32ChunkCols) {
      const int nc = min(np - c0, kF32ChunkCols);
      f32_tile_chunk(rows, kp, np, c0, nc, a, lda, b, ring, started || c0 > 0, store, then,
                     c0 + nc < np);
    }
  }
}

}  // namespace rpde
