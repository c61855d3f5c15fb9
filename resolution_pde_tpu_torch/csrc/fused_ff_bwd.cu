// Fused FFNO FeedForward, backward.
//
// Replaces the TPU kernel resolution_pde_tpu/ops/pallas/fused_ff.py
// `_bwd_pallas` (the custom VJP of `fused_feedforward`). Per tile of rows:
//   1. the layer inputs h_l (compute type) and pre-activations z_l (f32),
//      recomputed as the forward kernel computes them, or, with `zs`, read
//      from the pre-activations the forward saved (rounded to the compute
//      type) with each h_{l+1} = GELU(z_l);
//   2. dz of the last layer: the LayerNorm backward in f32 from the
//      cotangent g, or g itself without LayerNorm;
//   3. for l = L-1 .. 0, with dz rounded to the compute type before both
//      products:  dW_l += h_l^T dz,  db_l += sum_rows dz,
//      dh = dz W_l^T,  dz_{l-1} = dh * GELU'(z_{l-1})  (dx = dh for l = 0);
//   4. dLN_scale += sum_rows g * xhat, dLN_bias += sum_rows g.
// dx is stored in x's type; every weight, bias and LayerNorm gradient is
// summed in f32.
//
// The TPU kernel sums the weight gradients over a *sequential* grid into
// output blocks of constant index. Blocks of a CUDA grid run concurrently,
// so here a persistent grid (as many blocks as the SMs hold) walks the row
// tiles, block b taking tiles b, b + G, b + 2G, ...; each block sums its
// tiles' gradients in tile order into its own f32 slab in device memory
// (every slab element belongs to one thread of one block), and a second
// kernel sums the G slabs element by element in block order. There are no
// float atomics, so a run repeats bit for bit on the same card. Rows past
// the end of the last tile are left out of every sum (the TPU pads them
// with a zero cotangent instead).
//
// What bounds it on an H100. In bf16 (every FeedForward backward of the
// bf16 train step) the three products a layer (the recompute, dW and dh,
// about 3 x 103 GFLOP at the bench shape of 524,288 rows, 64 -> 256 -> 256
// -> 64) run on the tensor cores (mma.cuh: mma.sync on ldmatrix fragments
// and on weights read from L2), 0.3 ms of tensor-core time at the card's
// peak. What is left is memory traffic and its latency: each 64-row tile
// reads every weight twice from L2 (the recompute from `wt`, dh from `w`,
// 393 KB at bench dims) and reads and rewrites its block's f32 slab (396
// KB), some 9.7 GB a call; the 132 slabs (52 MB) do not stay in L2, so the
// slab traffic goes to device memory. So:
//   - a block has 16 warps (one block an SM: the tile takes the shared
//     memory), to keep more loads in flight (in f32 too);
//   - the slabs hold dW in the products' tile order (mma.cuh
//     tile_order_index), so a lane reads and writes its sums as float4s
//     and a warp moves 512 contiguous bytes at a time; the reduction puts
//     them back in row-major order;
//   - the weights are zero-padded to whole fragments by the caller, so
//     their loads need no masks, and are loaded two steps ahead;
//   - x and the saved zs are read 16 bytes a thread; the column sums of
//     db and of the LayerNorm gradients use every thread of the block;
//   - GELU and GELU' are calls in the unrolled epilogues, which keeps the
//     kernel's code within what the instruction caches hold.
// A tile's z (f32) and dz stay in shared memory, with only h_0 kept: each
// h_l (l >= 1) is rebuilt from z_{l-1} just before the product that reads
// it, which leaves room for 64-row tiles (all 227 KB at bench dims, the
// bf16 rows padded to whole fragments plus 8 columns so that ldmatrix
// meets no bank conflict). The bf16 buffers are zeroed once and dz is
// zero on the rows past the end of the last tile, so the products run on
// whole fragments. The z buffer takes two thirds of a row's bytes in bf16
// and half in f32 (about 36 w of 54 w and of 72 w at width w, factor 4),
// so past width 256 not even the least tile (16 rows in bf16, 8 in f32
// beside the weight ring) fits with it: for such chains z lives in device
// memory instead, a (tile rows, z row) f32 buffer a block after the slabs
// in partials, which stays in L2 (a block rewrites its own buffer every
// tile), and h_0, h, dz, the statistics and the ring stay in shared
// memory. The planner picks that from the shape, and it is a compile-time
// flag (kZGlobal), so the kernels of the chains that fit are unchanged.
//
// In f32 (the f32-exact mode, held to 1e-5: fused_ff_bwd_f32_kernel) the
// products stay IEEE f32 FMAs on the CUDA cores, no TF32: the same 309
// GFLOP at the bench shape are 4.6 ms at the card's 67 TFLOP/s, which
// bounds the kernel; the slabs (row-major here) add 12.9 GB, some 3.9 ms
// of device memory traffic. To run near the FMA rate the operands must
// come from shared memory in wide loads, with each loaded value used many
// times from registers. So:
//   - the recompute and dh (f32_tile_gemm, fused_ff.cuh) stream the
//     layer's weight (zero-padded to multiples of 4 by the caller) through
//     a ring of two shared-memory stages of 32 contraction rows by 16-byte
//     cp.async copies (dh's first slice while dW runs); a thread keeps 8 x
//     4 sums whose operands are 16-byte shared loads, a warp's lanes 4 row
//     groups x 8 column groups, so that a load reads 64 or 128 bytes; the
//     threads the outputs leave idle take part of the contraction, and the
//     groups' sums are reduce-scattered in a fixed order, so that every
//     group shares the epilogue;
//   - dW (f32_dw_add) runs in the same register tiles and reads and
//     rewrites the slab 16 bytes a lane, the earlier tiles' sums loaded
//     before its products so that their latency is hidden;
//   - 32-row tiles (all that fits beside the ring at bench dims), the rows
//     padded to whole float4s plus 4 floats so that the rows a warp's A
//     loads read fall in other banks;
//   - layers wider than 256 run their products in column chunks of 256
//     (f32_tile_gemm), so the ring is never wider than a chunk and chains
//     up to 256 -> 1024 -> 1024 -> 256 keep a tile of 8 rows.
// On an H100 its products run at 28-30 % of the FMA rate (PERF.md).

#include <algorithm>
#include <type_traits>

#include "fused_ff.cuh"
#include "mma.cuh"

namespace rpde {
namespace {

constexpr int kBwdMaxTileRows = 64;
// all of the 227 KB a block may use: one block an SM, the tile as tall as fits
constexpr int kBwdSmemBudget = 232448;
constexpr int kColumnSums = 3;  // the most column sums a pass takes (db, dLN)
// 16 warps a block (one block an SM): 8 left the SM idle on the latency of
// their loads from L2 and device memory
constexpr int kBwdThreads = 512;

struct BwdParams {
  int n_layers;
  int tile_rows;
  int approx_gelu;
  int has_ln;
  int tiled_slab;                    // dW in the slabs in tile order (bf16)
  int dims[kMaxLayers + 1];
  long long w_off[kMaxLayers + 1];   // offset of dW_l in grads (w_off[L]: all of dW)
  long long wp_off[kMaxLayers];      // offset of layer l in the packed w and wt
  long long sw_off[kMaxLayers + 1];  // offset of dW_l in a slab
  int dw_wide[kMaxLayers];           // dW_l's warp tiles are mma.cuh's wide ones
  int b_off[kMaxLayers];             // offset of layer l in the packed biases (and in db)
  int z_off[kMaxLayers + 1];         // per-row offset of z_l in the z buffer (and in zs)
  int z_ld, dz_ld;                   // row strides of the z buffer and of h / dz
  int h0_ld;                         // row stride of h_0
  int zs_ld;                         // per-row elements of the saved zs (0: recompute)
  long long db_base, ln_base;        // offsets of db and dLN in a slab
  long long slab;                    // floats of a slab, a multiple of 4
  long long n_grads;                 // floats of grads
  long long n_tiles;
  int smem_bytes;                    // dynamic shared memory, a multiple of 16
  int z_global;                      // the z buffer in device memory (partials), not shared
};

#ifdef RPDE_K1B_PHASES
// Clock cycles of each phase of the kernel, from one barrier to the next,
// summed over thread 0 of every block (scripts/torch_k1b_phases.py builds
// the kernel with RPDE_K1B_PHASES; the library never does): 0 x -> h_0,
// 1 the recompute or the saved zs, 2 the last layer's dz, then 3 + 3 l
// dW_l, 4 + 3 l dh of layer l (dx for l = 0), 5 + 3 l db_{l-1} and
// h_{l-1}, and kPhaseTail the end of a tile.
constexpr int kPhaseTail = 3 + 3 * kMaxLayers;
__device__ unsigned long long k1b_phase_cycles[kPhaseTail + 1];
#endif

// For each column j < n: out(j, s), s[k] the sum over r < rows of what
// row(r, j, s) adds into s[k]. With G = blockDim.x / n >= 2 the rows are
// split into G groups (r = gi, gi + G, ...), each summed in order by its
// own thread and the G sums then added in group order through scratch
// (NS x blockDim.x floats); otherwise one thread sums a column in row
// order. Every thread of the block calls it.
template <int NS, typename RowFn, typename OutFn>
__device__ void column_sums(int n, int rows, float* scratch, RowFn row, OutFn out) {
  const int groups = static_cast<int>(blockDim.x) / n;
  if (groups < 2) {
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      float s[NS] = {};
#pragma unroll 8
      for (int r = 0; r < rows; ++r) row(r, j, s);
      out(j, s);
    }
    return;
  }
  const int gi = threadIdx.x / n;
  if (gi < groups) {
    const int j = threadIdx.x - gi * n;
    float s[NS] = {};
#pragma unroll 4
    for (int r = gi; r < rows; r += groups) row(r, j, s);
#pragma unroll
    for (int k = 0; k < NS; ++k) scratch[(k * groups + gi) * n + j] = s[k];
  }
  __syncthreads();
  if (threadIdx.x < n) {
    float s[NS] = {};
    for (int q = 0; q < groups; ++q)
#pragma unroll
      for (int k = 0; k < NS; ++k) s[k] += scratch[(k * groups + q) * n + threadIdx.x];
    out(static_cast<int>(threadIdx.x), s);
  }
}

// The z buffer of block b, (tr, z_ld) f32, where it lives in device memory
// (kZGlobal): after the gridDim.x slabs of partials, one buffer a block.
__device__ __forceinline__ float* global_zbuf(float* partials, const BwdParams& p) {
  return partials + static_cast<long long>(gridDim.x) * p.slab +
         static_cast<long long>(blockIdx.x) * p.tile_rows * p.z_ld;
}

// bf16 compute type: the products on the tensor cores (mma.cuh). kZGlobal:
// the z buffer in device memory (chains whose least tile does not fit
// beside it in shared memory), compiled in only for them.
template <typename IO, bool kZGlobal>
__global__ void __launch_bounds__(kBwdThreads)
fused_ff_bwd_kernel(const IO* __restrict__ x, const IO* __restrict__ g,
                    const __nv_bfloat16* __restrict__ zs, IO* __restrict__ dx,
                    const __nv_bfloat16* __restrict__ w, const __nv_bfloat16* __restrict__ wt,
                    const float* __restrict__ b, const float* __restrict__ ln_s,
                    float* __restrict__ partials, long long n_rows, BwdParams p) {
  using CD = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tr = p.tile_rows;
  const int L = p.n_layers;
  const int c_in = p.dims[0];
  const int c_out = p.dims[L];
  const int z_ld = p.z_ld, dz_ld = p.dz_ld, h0_ld = p.h0_ld;
  // (tr, z_ld): z_l, then dz_l
  float* zbuf = kZGlobal ? global_zbuf(partials, p) : reinterpret_cast<float*>(smem);
  // (tr, 4): LayerNorm row statistics
  float* stats = kZGlobal ? reinterpret_cast<float*>(smem) : zbuf + tr * z_ld;
  CD* h0 = reinterpret_cast<CD*>(stats + tr * 4);  // (tr, h0_ld): h_0 = x
  CD* hbuf = h0 + tr * h0_ld;                      // (tr, dz_ld): some h_l, l >= 1
  CD* dzc = hbuf + tr * dz_ld;                     // (tr, dz_ld): dz rounded to CD
  float* scratch = reinterpret_cast<float*>(dzc + tr * dz_ld);  // column sums
  float* slab = partials + blockIdx.x * p.slab;
  const bool approx = p.approx_gelu != 0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;

  // the fragments read past the chain's widths and past the last tile's
  // rows: finite from here on
  for (int i = threadIdx.x; i < p.smem_bytes / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

#ifdef RPDE_K1B_PHASES
  long long t_mark = clock64();
  auto mark = [&](int phase) {
    __syncthreads();
    if (threadIdx.x == 0) {
      const long long t = clock64();
      atomicAdd(&k1b_phase_cycles[phase], static_cast<unsigned long long>(t - t_mark));
      t_mark = t;
    }
  };
#else
  auto mark = [](int) {};
#endif

  bool first = true;  // a block's first tile stores its sums, later tiles add
  for (long long tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const long long row0 = tile * tr;
    const int rows = static_cast<int>(min(static_cast<long long>(tr), n_rows - row0));
    // the dW products contract over whole fragments of 16 rows
    const int rows_pad = (rows + 15) / 16 * 16;
    auto add = [first](float* dst, float v) { *dst = first ? v : *dst + v; };
    // h_l = GELU(z_{l-1}) in CD, rebuilt into dst (row stride dz_ld)
    auto rebuild_h = [&](int l, CD* dst) {
      const int N = p.dims[l];
      const float* z = zbuf + p.z_off[l - 1];
      // a thread walks one column (or a few) down rows spaced by the
      // block's threads per column: no division per element
      const int per_row = min(N, static_cast<int>(blockDim.x));
      const int r_step = static_cast<int>(blockDim.x) / per_row;
      const int r_first = threadIdx.x / per_row;
      if (r_first >= r_step) return;
      for (int j = threadIdx.x - r_first * per_row; j < N; j += per_row)
        for (int r = r_first; r < rows; r += r_step)
          dst[r * dz_ld + j] = from_f<CD>(gelu(z[r * z_ld + j], approx));
    };

    // 1. h_0 = x in the compute type; z from zs or recomputed
    load_rows(h0, h0_ld, x + row0 * c_in, rows, c_in);
    mark(0);
    if (p.zs_ld > 0) {
      load_rows(zbuf, z_ld, zs + row0 * p.zs_ld, rows, p.zs_ld);
    } else {
      __syncthreads();
      // the chain's inputs ping-pong between hbuf and dzc (free until step
      // 2); without LayerNorm the last layer's z is never read: skip it
      const int n_fwd = p.has_ln ? L : L - 1;
      for (int l = 0; l < n_fwd; ++l) {
        const int K = p.dims[l];
        const int N = p.dims[l + 1];
        const float* bl = b + p.b_off[l];
        const CD* h = l == 0 ? h0 : (l % 2 == 1 ? hbuf : dzc);
        const int h_ld = l == 0 ? h0_ld : dz_ld;
        float* zl = zbuf + p.z_off[l];
        CD* hn = l < L - 1 ? (l % 2 == 0 ? hbuf : dzc) : nullptr;
        auto store = [=](int r, int j, float acc) {
          const float z = acc + __ldg(bl + j);
          zl[r * z_ld + j] = z;
          if (hn != nullptr) hn[r * dz_ld + j] = from_f<CD>(gelu_call(z, approx));
        };
        // W_l[k][j] read from the transposed copy, k contiguous
        const CD* wtl = wt + p.wp_off[l];
        const int kp = (K + 15) / 16 * 16;
        mma_gemm(
            rows, N, K,
            [h, h_ld](uint32_t (&a)[4], int m0, int k0) { frag_a(a, h, h_ld, m0, k0); },
            [wtl, kp](uint32_t (&bf)[2], int k0, int n0) { frag_b_global(bf, wtl, kp, k0, n0); },
            store);
        __syncthreads();
      }
    }
    __syncthreads();

    mark(1);

    // 2. dz of the last layer, its bias gradient and the LayerNorm gradients
    const IO* gt = g + row0 * c_out;
    float* db_last = slab + p.db_base + p.b_off[L - 1];
    if (p.has_ln) {
      const float* zl = zbuf + p.z_off[L - 1];
#pragma unroll 4
      for (int r = warp; r < rows; r += n_warps) {  // one warp a row
        const float* z = zl + r * z_ld;
        float s = 0.f;
        for (int c = lane; c < c_out; c += 32) s += z[c];
        const float mu = warp_sum(s) / c_out;
        float v = 0.f;
        for (int c = lane; c < c_out; c += 32) {
          const float d = z[c] - mu;
          v += d * d;
        }
        const float rstd = rsqrtf(warp_sum(v) / c_out + kLnEps);
        float s1 = 0.f, s2 = 0.f;
        for (int c = lane; c < c_out; c += 32) {
          const float dxhat = to_f(gt[r * c_out + c]) * ln_s[c];
          s1 += dxhat;
          s2 += dxhat * ((z[c] - mu) * rstd);
        }
        s1 = warp_sum(s1);
        s2 = warp_sum(s2);
        if (lane == 0) {
          stats[r * 4 + 0] = mu;
          stats[r * 4 + 1] = rstd;
          stats[r * 4 + 2] = s1 / c_out;
          stats[r * 4 + 3] = s2 / c_out;
        }
      }
      __syncthreads();
      column_sums<3>(
          c_out, rows, scratch,
          [&](int r, int j, float (&s)[3]) {
            const float* st = stats + r * 4;
            const float gv = to_f(gt[r * c_out + j]);
            const float xhat = (zl[r * z_ld + j] - st[0]) * st[1];
            const float dxhat = gv * __ldg(ln_s + j);
            const float dz = st[1] * (dxhat - st[2] - xhat * st[3]);
            dzc[r * dz_ld + j] = from_f<CD>(dz);
            s[0] += dz;
            s[1] += gv * xhat;
            s[2] += gv;
          },
          [&](int j, const float (&s)[3]) {
            add(db_last + j, s[0]);
            add(slab + p.ln_base + j, s[1]);
            add(slab + p.ln_base + c_out + j, s[2]);
          });
    } else {
      column_sums<1>(
          c_out, rows, scratch,
          [&](int r, int j, float (&s)[1]) {
            const float gv = to_f(gt[r * c_out + j]);
            dzc[r * dz_ld + j] = from_f<CD>(gv);
            s[0] += gv;
          },
          [&](int j, const float (&s)[1]) { add(db_last + j, s[0]); });
    }
    // dz is 0 on the rows past the tile's end (they stay so through step 3:
    // no store reaches them)
    for (int idx = threadIdx.x; idx < (rows_pad - rows) * dz_ld; idx += blockDim.x)
      dzc[rows * dz_ld + idx] = from_f<CD>(0.f);
    if (L > 1) rebuild_h(L - 1, hbuf);
    __syncthreads();

    mark(2);

    // 3. the chain backwards; on entry dzc holds dz_l and, for l >= 1, hbuf h_l
    for (int l = L - 1; l >= 0; --l) {
      const int K = p.dims[l];
      const int N = p.dims[l + 1];
      const CD* h = l == 0 ? h0 : hbuf;
      const int h_ld = l == 0 ? h0_ld : dz_ld;
      const CD* dz = dzc;
      // dW_l (K x N) += h_l^T dz over the tile's rows
      float* dwl = slab + p.sw_off[l];
      mma_gemm_add(
          K, N, rows_pad,
          [h, h_ld](uint32_t (&a)[4], int m0, int k0) { frag_a_trans(a, h, h_ld, m0, k0); },
          [dz, dz_ld](uint32_t (&bf)[2], int k0, int n0) { frag_b_trans(bf, dz, dz_ld, k0, n0); },
          dwl, !first, p.dw_wide[l] != 0);
      mark(3 + 3 * l);
      // dh (rows x K) = dz W_l^T, handing each element to store
      auto dh_product = [&](auto store) {
        // W_l^T[j][i] = W_l[i][j] read from the packed copy, j contiguous
        const CD* wl = w + p.wp_off[l];
        const int np = (N + 15) / 16 * 16;
        mma_gemm(
            rows, K, N,
            [dz, dz_ld](uint32_t (&a)[4], int m0, int k0) { frag_a(a, dz, dz_ld, m0, k0); },
            [wl, np](uint32_t (&bf)[2], int k0, int n0) { frag_b_global(bf, wl, np, k0, n0); },
            store);
      };
      if (l > 0) {
        float* zp = zbuf + p.z_off[l - 1];
        dh_product([=](int r, int i, float acc) {
          float* z = zp + r * z_ld + i;
          *z = acc * gelu_grad_call(*z, approx);  // dz_{l-1}, over z_{l-1}
        });
        mark(4 + 3 * l);
        __syncthreads();
        column_sums<1>(
            K, rows, scratch,
            [&](int r, int j, float (&s)[1]) {
              const float v = zp[r * z_ld + j];
              dzc[r * dz_ld + j] = from_f<CD>(v);
              s[0] += v;
            },
            [&](int j, const float (&s)[1]) {
              add(slab + p.db_base + p.b_off[l - 1] + j, s[0]);
            });
        if (l > 1) rebuild_h(l - 1, hbuf);
        __syncthreads();
        mark(5 + 3 * l);
      } else {
        IO* dxt = dx + row0 * c_in;
        dh_product([=](int r, int i, float acc) { dxt[r * c_in + i] = from_f<IO>(acc); });
        mark(4);
      }
    }
    __syncthreads();
#ifdef RPDE_K1B_PHASES
    mark(kPhaseTail);
#endif
    first = false;
  }
}

// dst (f32 slab) = v on a block's first tile, dst + v on later ones
__device__ __forceinline__ void slab_add(float* dst, float v, bool first) {
  *dst = first ? v : *dst + v;
}

// The f32 kernel's LayerNorm, db and h steps, below, are the bf16
// kernel's code, which keeps its own copy: compiled through these
// functions it took an 8-byte stack frame and 2 % more time on an H100
// (PERF.md).

// h_l = GELU(z_{l-1}), rebuilt into dst (row stride dz_ld): a thread
// walks one column (or a few) down rows spaced by the block's threads per
// column, so there is no division per element
__device__ __forceinline__ void f32_rebuild_h(const BwdParams& p, int l, const float* zbuf,
                                              float* dst, int rows, bool approx) {
  const int N = p.dims[l];
  const float* z = zbuf + p.z_off[l - 1];
  const int per_row = min(N, static_cast<int>(blockDim.x));
  const int r_step = static_cast<int>(blockDim.x) / per_row;
  const int r_first = threadIdx.x / per_row;
  if (r_first >= r_step) return;
  for (int j = threadIdx.x - r_first * per_row; j < N; j += per_row)
    for (int r = r_first; r < rows; r += r_step)
      dst[r * p.dz_ld + j] = gelu(z[r * p.z_ld + j], approx);
}

// Step 2 of a tile: dz of the last layer into dzc, from the LayerNorm
// backward on the tile's z (zbuf) and the cotangent rows gt, or gt itself
// without LayerNorm; the last layer's bias gradient and the LayerNorm
// gradients added into the slab. Ends with column_sums (no barrier after
// it).
template <typename IO>
__device__ __forceinline__ void f32_last_layer_dz(const BwdParams& p, const IO* __restrict__ gt,
                                                  const float* __restrict__ ln_s,
                                                  const float* zbuf, float* stats, float* dzc,
                                                  float* scratch, float* slab, int rows,
                                                  bool first) {
  const int L = p.n_layers;
  const int c_out = p.dims[L];
  const int z_ld = p.z_ld, dz_ld = p.dz_ld;
  float* db_last = slab + p.db_base + p.b_off[L - 1];
  if (p.has_ln) {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int n_warps = blockDim.x / 32;
    const float* zl = zbuf + p.z_off[L - 1];
#pragma unroll 4
    for (int r = warp; r < rows; r += n_warps) {  // one warp a row
      const float* z = zl + r * z_ld;
      float s = 0.f;
      for (int c = lane; c < c_out; c += 32) s += z[c];
      const float mu = warp_sum(s) / c_out;
      float v = 0.f;
      for (int c = lane; c < c_out; c += 32) {
        const float d = z[c] - mu;
        v += d * d;
      }
      const float rstd = rsqrtf(warp_sum(v) / c_out + kLnEps);
      float s1 = 0.f, s2 = 0.f;
      for (int c = lane; c < c_out; c += 32) {
        const float dxhat = to_f(gt[r * c_out + c]) * ln_s[c];
        s1 += dxhat;
        s2 += dxhat * ((z[c] - mu) * rstd);
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        stats[r * 4 + 0] = mu;
        stats[r * 4 + 1] = rstd;
        stats[r * 4 + 2] = s1 / c_out;
        stats[r * 4 + 3] = s2 / c_out;
      }
    }
    __syncthreads();
    column_sums<3>(
        c_out, rows, scratch,
        [&](int r, int j, float (&s)[3]) {
          const float* st = stats + r * 4;
          const float gv = to_f(gt[r * c_out + j]);
          const float xhat = (zl[r * z_ld + j] - st[0]) * st[1];
          const float dxhat = gv * __ldg(ln_s + j);
          const float dz = st[1] * (dxhat - st[2] - xhat * st[3]);
          dzc[r * dz_ld + j] = dz;
          s[0] += dz;
          s[1] += gv * xhat;
          s[2] += gv;
        },
        [&](int j, const float (&s)[3]) {
          slab_add(db_last + j, s[0], first);
          slab_add(slab + p.ln_base + j, s[1], first);
          slab_add(slab + p.ln_base + c_out + j, s[2], first);
        });
  } else {
    column_sums<1>(
        c_out, rows, scratch,
        [&](int r, int j, float (&s)[1]) {
          const float gv = to_f(gt[r * c_out + j]);
          dzc[r * dz_ld + j] = gv;
          s[0] += gv;
        },
        [&](int j, const float (&s)[1]) { slab_add(db_last + j, s[0], first); });
  }
}

// Step 3's hand-over from layer l to l - 1: dz_{l-1}, which the dh
// product left over z_{l-1} in zbuf, copied into dzc, and db_{l-1} (its
// sum over rows) added into the slab.
__device__ __forceinline__ void f32_hidden_dz(const BwdParams& p, int l, const float* zbuf,
                                              float* dzc, float* scratch, float* slab, int rows,
                                              bool first) {
  const float* zp = zbuf + p.z_off[l - 1];
  const int z_ld = p.z_ld, dz_ld = p.dz_ld;
  column_sums<1>(
      p.dims[l], rows, scratch,
      [&](int r, int j, float (&s)[1]) {
        const float v = zp[r * z_ld + j];
        dzc[r * dz_ld + j] = v;
        s[0] += v;
      },
      [&](int j, const float (&s)[1]) {
        slab_add(slab + p.db_base + p.b_off[l - 1] + j, s[0], first);
      });
}

// dst (k x n, row-major: a slab's dW_l) = sum over r < rows of
// h[r * h_ld + i] dz[r * dz_ld + j], plus dst's value unless first; the sum
// over the rows runs in order before it is added. A thread owns 8 x 4 sums
// (i x j): h and dz are read as float4s (rows 16-byte aligned, h finite up
// to the next multiple of 8 columns, dz up to the next multiple of 4), a
// warp's lanes holding 4 groups of i x 8 groups of j, so that each of its
// shared loads reads 4 or 8 distinct 16-byte pieces; dst is read and
// written as float4s where n % 4 == 0 and dst is 16-byte aligned, so that
// a warp moves four runs of 128 contiguous bytes, and one float at a time
// otherwise.
__device__ __forceinline__ void f32_dw_add(int k, int n, int rows, const float* h, int h_ld,
                                           const float* dz, int dz_ld, float* dst, bool first) {
  const int n4 = (n + 3) / 4;
  const int m8 = (k + 7) / 8;
  // in blocks of 8 groups of j, each block's groups of i in turn
  const int items = (n4 + 7) / 8 * m8 * 8;
  const bool vec = n % 4 == 0 && (reinterpret_cast<uintptr_t>(dst) & 15u) == 0;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int cg = (it >> 3) / m8 * 8 + (it & 7);
    if (cg >= n4) continue;
    const int i0 = (it >> 3) % m8 * 8;
    const int j0 = cg * 4;
    // the slab's sums of the earlier tiles, loaded before the products so
    // that their latency (device memory: the slabs outgrow L2) is hidden
    float4 old[8];
    if (vec && !first)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i0 + i < k)
          old[i] = *reinterpret_cast<const float4*>(dst + static_cast<long long>(i0 + i) * n + j0);
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
#pragma unroll 2
    for (int r = 0; r < rows; ++r) {
      const float4 a0 = *reinterpret_cast<const float4*>(h + r * h_ld + i0);
      const float4 a1 = *reinterpret_cast<const float4*>(h + r * h_ld + i0 + 4);
      const float4 bv = *reinterpret_cast<const float4*>(dz + r * dz_ld + j0);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][0] = fmaf(av[i], bv.x, acc[i][0]);
        acc[i][1] = fmaf(av[i], bv.y, acc[i][1]);
        acc[i][2] = fmaf(av[i], bv.z, acc[i][2]);
        acc[i][3] = fmaf(av[i], bv.w, acc[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i0 + i >= k) break;
      float* d = dst + static_cast<long long>(i0 + i) * n + j0;
      if (vec) {
        float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        if (!first) {
          const float4 o = old[i];
          v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
        }
        *reinterpret_cast<float4*>(d) = v;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j0 + q < n) slab_add(d + q, acc[i][q], first);
      }
    }
  }
}

// f32 compute type (the f32-exact mode): IEEE f32 products on the CUDA
// cores, the weights streamed through shared memory (f32_tile_gemm), dW
// in float4 register tiles (f32_dw_add); the phases, the slabs and the
// column sums are the bf16 kernel's. kChunks: f32_tile_gemm's column
// chunks, compiled in only for chains wider than kF32ChunkCols; kZGlobal
// (with kChunks): the z buffer in device memory, as in the bf16 kernel.
template <typename IO, bool kChunks, bool kZGlobal>
__global__ void __launch_bounds__(kBwdThreads)
fused_ff_bwd_f32_kernel(const IO* __restrict__ x, const IO* __restrict__ g,
                        const float* __restrict__ zs, IO* __restrict__ dx,
                        const float* __restrict__ w, const float* __restrict__ wt,
                        const float* __restrict__ b, const float* __restrict__ ln_s,
                        float* __restrict__ partials, long long n_rows, BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tr = p.tile_rows;  // a multiple of 8, so every buffer is 16-byte aligned
  const int L = p.n_layers;
  const int c_in = p.dims[0];
  const int c_out = p.dims[L];
  const int z_ld = p.z_ld, dz_ld = p.dz_ld, h0_ld = p.h0_ld;
  // (tr, z_ld): z_l, then dz_l
  float* zbuf = kZGlobal ? global_zbuf(partials, p) : reinterpret_cast<float*>(smem);
  // (tr, 4): LayerNorm row statistics
  float* stats = kZGlobal ? reinterpret_cast<float*>(smem) : zbuf + tr * z_ld;
  float* h0 = stats + tr * 4;                    // (tr, h0_ld): h_0 = x
  float* hbuf = h0 + tr * h0_ld;                 // (tr, dz_ld): some h_l, l >= 1
  float* dzc = hbuf + tr * dz_ld;                // (tr, dz_ld): dz, the products' A
  float* scratch = dzc + tr * dz_ld;             // column sums
  float* ring = scratch + kColumnSums * kBwdThreads;  // f32_tile_gemm's weight ring
  float* slab = partials + blockIdx.x * p.slab;
  const bool approx = p.approx_gelu != 0;

  // the columns the products read past the chain's widths, and the rows
  // past the last tile's end: finite from here on
  for (int i = threadIdx.x; i < p.smem_bytes / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

#ifdef RPDE_K1B_PHASES
  long long t_mark = clock64();
  auto mark = [&](int phase) {
    __syncthreads();
    if (threadIdx.x == 0) {
      const long long t = clock64();
      atomicAdd(&k1b_phase_cycles[phase], static_cast<unsigned long long>(t - t_mark));
      t_mark = t;
    }
  };
#else
  auto mark = [](int) {};
#endif

  bool first = true;  // a block's first tile stores its sums, later tiles add
  for (long long tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const long long row0 = tile * tr;
    const int rows = static_cast<int>(min(static_cast<long long>(tr), n_rows - row0));

    // 1. h_0 = x; z from zs or recomputed
    load_rows(h0, h0_ld, x + row0 * c_in, rows, c_in);
    mark(0);
    if (p.zs_ld > 0) {
      load_rows(zbuf, z_ld, zs + row0 * p.zs_ld, rows, p.zs_ld);
    } else {
      __syncthreads();
      // the chain's inputs ping-pong between hbuf and dzc (free until step
      // 2); without LayerNorm the last layer's z is never read: skip it
      const int n_fwd = p.has_ln ? L : L - 1;
      for (int l = 0; l < n_fwd; ++l) {
        const int N = p.dims[l + 1];
        const float* bl = b + p.b_off[l];
        const float* h = l == 0 ? h0 : (l % 2 == 1 ? hbuf : dzc);
        float* zl = zbuf + p.z_off[l];
        float* hn = l < L - 1 ? (l % 2 == 0 ? hbuf : dzc) : nullptr;
        f32_tile_gemm<kChunks>(rows, pad4(p.dims[l]), pad4(N), h, l == 0 ? h0_ld : dz_ld,
                      w + p.wp_off[l], ring, false, [=](int r, int j0, const float (&v)[4]) {
#pragma unroll
                        for (int q = 0; q < 4; ++q) {
                          const int j = j0 + q;
                          if (j >= N) break;
                          const float z = v[q] + __ldg(bl + j);
                          zl[r * z_ld + j] = z;
                          if (hn != nullptr) hn[r * dz_ld + j] = gelu_call(z, approx);
                        }
                      });
        __syncthreads();
      }
    }
    __syncthreads();

    mark(1);

    // 2. dz of the last layer, its bias gradient and the LayerNorm gradients
    f32_last_layer_dz(p, g + row0 * c_out, ln_s, zbuf, stats, dzc, scratch, slab, rows, first);
    if (L > 1) f32_rebuild_h(p, L - 1, zbuf, hbuf, rows, approx);
    __syncthreads();

    mark(2);

    // 3. the chain backwards; on entry dzc holds dz_l and, for l >= 1, hbuf
    // h_l. dW reads neither the ring nor zbuf: dh's first weight slice is
    // copied while dW runs, and dh needs no barrier after dW (the
    // product's own first barrier waits for every thread's dW)
    for (int l = L - 1; l >= 0; --l) {
      const int K = p.dims[l];
      const int N = p.dims[l + 1];
      // dh (rows x K) = dz W_l^T, W_l^T from the transposed copy
      const float* wtl = wt + p.wp_off[l];
      f32_start_first_slice<kChunks>(ring, wtl, pad4(N), pad4(K));
      f32_dw_add(K, N, rows, l == 0 ? h0 : hbuf, l == 0 ? h0_ld : dz_ld, dzc, dz_ld,
                 slab + p.sw_off[l], first);
      mark(3 + 3 * l);
      if (l > 0) {
        float* zp = zbuf + p.z_off[l - 1];
        f32_tile_gemm<kChunks>(rows, pad4(N), pad4(K), dzc, dz_ld, wtl, ring, true,
                      [=](int r, int i0, const float (&v)[4]) {
#pragma unroll
                        for (int q = 0; q < 4; ++q) {
                          if (i0 + q >= K) break;
                          float* z = zp + r * z_ld + i0 + q;
                          *z = v[q] * gelu_grad_call(*z, approx);  // dz_{l-1}, over z_{l-1}
                        }
                      });
        mark(4 + 3 * l);
        __syncthreads();
        f32_hidden_dz(p, l, zbuf, dzc, scratch, slab, rows, first);
        if (l > 1) f32_rebuild_h(p, l - 1, zbuf, hbuf, rows, approx);
        __syncthreads();
        mark(5 + 3 * l);
      } else {
        IO* dxt = dx + row0 * c_in;
        f32_tile_gemm<kChunks>(rows, pad4(N), pad4(K), dzc, dz_ld, wtl, ring, true,
                      [=](int r, int i0, const float (&v)[4]) {
#pragma unroll
                        for (int q = 0; q < 4; ++q)
                          if (i0 + q < c_in) dxt[r * c_in + i0 + q] = from_f<IO>(v[q]);
                      });
        mark(4);
      }
    }
    __syncthreads();
#ifdef RPDE_K1B_PHASES
    mark(kPhaseTail);
#endif
    first = false;
  }
}

// out[e] = sum over blocks b = 0, 1, ... of the slab element of partials[b]
// that holds grads element e, in that order
__global__ void __launch_bounds__(kThreads)
reduce_slabs_kernel(const float* __restrict__ partials, float* __restrict__ out, BwdParams p,
                    int blocks) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= p.n_grads) return;
  const int L = p.n_layers;
  long long s = e - p.w_off[L] + p.db_base;  // db and dLN: row-major after dW
  if (e < p.w_off[L]) {
    int l = 0;
    while (e >= p.w_off[l + 1]) ++l;
    const long long k = e - p.w_off[l];
    s = p.sw_off[l] + k;
    if (p.tiled_slab) {
      const int n = p.dims[l + 1];
      const bool wide = p.dw_wide[l] != 0;
      s = p.sw_off[l] + tile_order_index(static_cast<int>(k / n), static_cast<int>(k % n), n,
                                         wide ? kWideMT : kNarrowMT, wide ? kWideNT : kNarrowNT);
    }
  }
  float acc = 0.f;
  for (int bi = 0; bi < blocks; ++bi) acc += partials[bi * p.slab + s];
  out[e] = acc;
}

// Fills p's layout from the chain's widths: offsets, strides, the slab and
// the tile of rows; its shared memory in smem. False if the widths are
// invalid or no tile fits.
bool plan(BwdParams& p, bool bf16, const int* dims, int n_layers, bool has_ln,
          size_t& smem) {
  if (n_layers < 1 || n_layers > kMaxLayers) return false;
  p = BwdParams{};
  p.n_layers = n_layers;
  p.has_ln = has_ln;
  p.tiled_slab = bf16;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1) return false;
    p.dims[l] = dims[l];
  }
  // the packed weights: in bf16 each kernel zero-padded to whole 16 x 16
  // fragments, in f32 to multiples of 4 (f32_tile_gemm's float4s)
  auto pad_w = [bf16](long long d) { return bf16 ? (d + 15) / 16 * 16 : (d + 3) / 4 * 4; };
  long long wp = 0;
  int b_off = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int k = dims[l], n = dims[l + 1];
    p.wp_off[l] = wp;
    p.b_off[l] = b_off;
    p.z_off[l] = p.z_ld;
    p.w_off[l + 1] = p.w_off[l] + static_cast<long long>(k) * n;
    const bool wide = wide_warp_tiles(k, n, kBwdThreads / 32);
    p.dw_wide[l] = wide;
    p.sw_off[l + 1] =
        p.sw_off[l] + (bf16 ? tile_order_size(k, n, wide ? kWideMT : kNarrowMT,
                                              wide ? kWideNT : kNarrowNT)
                            : static_cast<long long>(k) * n);
    wp += pad_w(k) * pad_w(n);
    b_off += n;
    p.z_ld += n;
    if (n > p.dz_ld) p.dz_ld = n;
  }
  p.z_off[n_layers] = p.z_ld;
  p.db_base = p.sw_off[n_layers];
  p.ln_base = p.db_base + b_off;
  p.slab = (p.ln_base + (has_ln ? 2 * dims[n_layers] : 0) + 3) / 4 * 4;
  p.n_grads = p.w_off[n_layers] + b_off + (has_ln ? 2 * dims[n_layers] : 0);
  size_t fixed = static_cast<size_t>(kColumnSums) * kBwdThreads * sizeof(float);
  int widest = 0;  // f32: the widest layer, padded to a multiple of 4
  if (bf16) {
    // tensor-core fragments: the bf16 rows padded to whole fragments of 16
    // columns plus 8, so that the 8 rows an ldmatrix reads fall in 8
    // different 16-byte bank groups; the f32 rows by 4 against conflicts
    // in the epilogues' stores
    p.h0_ld = static_cast<int>(pad_w(dims[0])) + 8;
    p.dz_ld = static_cast<int>(pad_w(p.dz_ld)) + 8;
    p.z_ld += 4;
  } else {
    // the products' and dW's rows: whole float4s (dW reads h up to the
    // next multiple of 8 columns) plus 4 floats, so that rows one apart
    // fall in other banks; the weight ring, as wide as the widest layer's
    // first column chunk (f32_chunk_cols: wider layers run in chunks)
    for (int l = 0; l <= n_layers; ++l) widest = std::max(widest, pad4(dims[l]));
    p.h0_ld = pad4(dims[0]) + 4;
    p.dz_ld = pad4(p.dz_ld) + 4;
    fixed += static_cast<size_t>(f32_ring_floats(widest, kBwdThreads)) * sizeof(float);
  }
  const size_t cd_size = bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  // a row's buffers: z (f32), its LayerNorm statistics, h_0 and two rows
  // as wide as the widest layer in the compute type
  const size_t z_row = static_cast<size_t>(p.z_ld) * sizeof(float);
  const size_t rest_row = 4 * sizeof(float) +
                          (static_cast<size_t>(p.h0_ld) + 2 * p.dz_ld) * cd_size;
  // the tallest tile of rows of per_row bytes that fits the budget, or 0
  const auto tallest = [fixed](size_t per_row) {
    int tr = kBwdMaxTileRows;
    while (tr > 1 && tr * per_row + fixed > static_cast<size_t>(kBwdSmemBudget)) tr /= 2;
    return tr * per_row + fixed <= static_cast<size_t>(kBwdSmemBudget) ? tr : 0;
  };
  // the tensor-core products read whole fragments of 16 rows; the f32
  // products' register tiles 8 rows, a thread each. Where the least tile
  // does not fit with its z, z goes to device memory (partials)
  const int least = bf16 ? 16 : 8;
  int tr = tallest(z_row + rest_row);
  p.z_global = tr < least;
  if (p.z_global) tr = tallest(rest_row);
  if (tr < least) return false;
  const size_t per_row = p.z_global ? rest_row : z_row + rest_row;
  if (!bf16 && f32_tile_gemm_threads(tr, f32_chunk_cols(widest)) > kBwdThreads) return false;
  p.tile_rows = tr;
  smem = (tr * per_row + fixed + 15) / 16 * 16;
  p.smem_bytes = static_cast<int>(smem);
  return true;
}

template <typename CD, typename IO>
cudaError_t launch(const void* x, const void* g, const void* zs, void* dx, const void* w,
                   const void* wt, const float* b, const float* ln_s, float* partials,
                   float* grads, long long n_rows, BwdParams& p, size_t smem,
                   int max_blocks, cudaStream_t stream) {
  void (*kernel)(const IO*, const IO*, const CD*, IO*, const CD*, const CD*, const float*,
                 const float*, float*, long long, BwdParams);
  if constexpr (std::is_same<CD, float>::value) {
    int widest = 0;
    for (int l = 0; l <= p.n_layers; ++l) widest = std::max(widest, pad4(p.dims[l]));
    kernel = p.z_global               ? fused_ff_bwd_f32_kernel<IO, true, true>
             : widest > kF32ChunkCols ? fused_ff_bwd_f32_kernel<IO, true, false>
                                      : fused_ff_bwd_f32_kernel<IO, false, false>;
  } else {
    kernel = p.z_global ? fused_ff_bwd_kernel<IO, true> : fused_ff_bwd_kernel<IO, false>;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBwdThreads,
                                                           smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // one resident block per slot of the card: the grid is fixed by the card
  // and the shapes, so the order of every sum is too
  long long blocks = static_cast<long long>(sms) * per_sm;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks > p.n_tiles) blocks = p.n_tiles;
  kernel<<<static_cast<unsigned>(blocks), kBwdThreads, smem, stream>>>(
      static_cast<const IO*>(x), static_cast<const IO*>(g), static_cast<const CD*>(zs),
      static_cast<IO*>(dx), static_cast<const CD*>(w), static_cast<const CD*>(wt), b, ln_s,
      partials, n_rows, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long rblocks = (p.n_grads + kThreads - 1) / kThreads;
  reduce_slabs_kernel<<<static_cast<unsigned>(rblocks), kThreads, 0, stream>>>(
      partials, grads, p, static_cast<int>(blocks));
  return cudaGetLastError();
}

}  // namespace
}  // namespace rpde

// Floats of the backward's scratch (partials) a block takes for the chain
// dims[0] -> ... -> dims[n_layers] in the compute type (bf16 or f32), with
// or without LayerNorm: its slab, and where the tile's z does not fit the
// shared memory, its z buffer (tile rows x the z row); -1 if the widths are
// invalid or no tile of rows fits the shared memory.
extern "C" int rpde_fused_ff_backward_slab(int cd_bf16, const int* dims, int n_layers,
                                           int has_ln) {
  rpde::BwdParams p;
  size_t smem = 0;
  if (!rpde::plan(p, cd_bf16 != 0, dims, n_layers, has_ln != 0, smem)) return -1;
  return static_cast<int>(p.slab + (p.z_global ? static_cast<long long>(p.tile_rows) * p.z_ld : 0));
}

// Rows of the backward's tile of rows for the same chain, or -1 where
// rpde_fused_ff_backward_slab gives -1 (the launcher's Python mirror of
// plan is checked against it).
extern "C" int rpde_fused_ff_backward_tile_rows(int cd_bf16, const int* dims, int n_layers,
                                                int has_ln) {
  rpde::BwdParams p;
  size_t smem = 0;
  if (!rpde::plan(p, cd_bf16 != 0, dims, n_layers, has_ln != 0, smem)) return -1;
  return p.tile_rows;
}

// x (n_rows, dims[0]), g (n_rows, dims[n_layers]) and dx (n_rows, dims[0]),
// row-major in the io type. zs: null to recompute, or the forward kernel's
// saved pre-activations (n_rows, dims[1] + ... + dims[n_save]) in the
// compute type, n_save = n_layers with LayerNorm and n_layers - 1 without.
// w: every layer's (dims[l], dims[l+1]) kernel packed row-major, and wt the
// same kernels transposed, (dims[l+1], dims[l]) each, both in the compute
// type; each kernel is zero-padded to multiples of 16 (bf16) or 4 (f32) in
// both of its dimensions before it is packed. b: the biases packed in f32; ln_s: the
// LayerNorm scale (f32), null for no LayerNorm. partials: f32 scratch,
// max_blocks x rpde_fused_ff_backward_slab floats. grads (f32)
// receives dW_0 .. dW_{L-1} packed row-major, then db_0 .. db_{L-1} packed
// as b, then with LayerNorm dLN_scale and dLN_bias. Returns a cudaError_t.
extern "C" int rpde_fused_ff_backward(int cd_bf16, int io_bf16, const void* x,
                                      const void* g, const void* zs, void* dx,
                                      const void* w, const void* wt, const float* b,
                                      const float* ln_s, float* partials, float* grads,
                                      const int* dims, int n_layers, long long n_rows,
                                      int approx_gelu, int max_blocks, void* stream) {
  using namespace rpde;
  if (n_rows < 1 || max_blocks < 1) return cudaErrorInvalidValue;
  BwdParams p;
  size_t smem = 0;
  if (!plan(p, cd_bf16 != 0, dims, n_layers, ln_s != nullptr, smem))
    return cudaErrorInvalidValue;
  p.approx_gelu = approx_gelu;
  if (zs != nullptr) p.zs_ld = p.z_off[p.has_ln ? n_layers : n_layers - 1];
  p.n_tiles = (n_rows + p.tile_rows - 1) / p.tile_rows;
  auto s = static_cast<cudaStream_t>(stream);
  if (cd_bf16 && io_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, g, zs, dx, w, wt, b, ln_s, partials,
                                                 grads, n_rows, p, smem, max_blocks, s);
  if (cd_bf16)
    return launch<__nv_bfloat16, float>(x, g, zs, dx, w, wt, b, ln_s, partials, grads,
                                        n_rows, p, smem, max_blocks, s);
  if (io_bf16)
    return launch<float, __nv_bfloat16>(x, g, zs, dx, w, wt, b, ln_s, partials, grads,
                                        n_rows, p, smem, max_blocks, s);
  return launch<float, float>(x, g, zs, dx, w, wt, b, ln_s, partials, grads, n_rows, p,
                              smem, max_blocks, s);
}

#ifdef RPDE_K1B_PHASES
// Copies the phase counters into out (kPhaseTail + 1 of them), or with
// reset sets them to 0. Returns a cudaError_t.
extern "C" int rpde_k1b_phase_cycles(unsigned long long* out, int reset) {
  unsigned long long zero[rpde::kPhaseTail + 1] = {};
  if (reset) return cudaMemcpyToSymbol(rpde::k1b_phase_cycles, zero, sizeof(zero));
  return cudaMemcpyFromSymbol(out, rpde::k1b_phase_cycles, sizeof(zero));
}
#endif
