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
// What bounds it on an H100: the products (three per layer: the recompute,
// dW and dh, about 3 x 103 GFLOP at the bench shape of 524,288 rows,
// 64 -> 256 -> 256 -> 64), on the CUDA cores in f32 FMA (block_gemm), as in
// the forward kernel. A tile's z (f32) and dz stay in shared memory, with
// only h_0 kept: each h_l (l >= 1) is rebuilt from z_{l-1} just before the
// product that reads it, which leaves room for 64-row tiles (222 KB at
// bench dims in bf16), where every product gets 8 x 8 register tiles. Only
// x, g, dx (and the saved z) cross device memory, plus each block's slab,
// read and written once per tile (396 KB at bench dims). Tensor cores, and
// keeping the weight gradient in registers across tiles, are later work.

#include "fused_ff.cuh"

namespace rpde {
namespace {

constexpr int kBwdMaxTileRows = 64;
// all of the 227 KB a block may use: one block an SM, the tile as tall as fits
constexpr int kBwdSmemBudget = 232448;

struct BwdParams {
  int n_layers;
  int tile_rows;
  int approx_gelu;
  int has_ln;
  int dims[kMaxLayers + 1];
  long long w_off[kMaxLayers];  // offset of layer l in the packed weights (and in dW)
  int b_off[kMaxLayers];        // offset of layer l in the packed biases (and in db)
  int z_off[kMaxLayers + 1];    // per-row offset of z_l in the z buffer (and in zs)
  int z_ld, dz_ld;              // per-row elements of the z buffer and of h / dz
  int zs_ld;                    // per-row elements of the saved zs (0: recompute)
  long long db_base, ln_base;   // offsets of db and dLN in a slab
  long long slab;               // elements of a slab
  long long n_tiles;
};

template <typename CD, typename IO>
__global__ void __launch_bounds__(kThreads)
fused_ff_bwd_kernel(const IO* __restrict__ x, const IO* __restrict__ g,
                    const CD* __restrict__ zs, IO* __restrict__ dx,
                    const CD* __restrict__ w, const CD* __restrict__ wt,
                    const float* __restrict__ b, const float* __restrict__ ln_s,
                    float* __restrict__ partials, long long n_rows, BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tr = p.tile_rows;
  const int L = p.n_layers;
  const int c_in = p.dims[0];
  const int c_out = p.dims[L];
  const int z_ld = p.z_ld, dz_ld = p.dz_ld;
  float* zbuf = reinterpret_cast<float*>(smem);    // (tr, z_ld): z_l, then dz_l
  float* stats = zbuf + tr * z_ld;                 // (tr, 4): LayerNorm row statistics
  CD* h0 = reinterpret_cast<CD*>(stats + tr * 4);  // (tr, c_in): h_0 = x
  CD* hbuf = h0 + tr * c_in;                       // (tr, dz_ld): some h_l, l >= 1
  CD* dzc = hbuf + tr * dz_ld;                     // (tr, dz_ld): dz rounded to CD
  float* slab = partials + blockIdx.x * p.slab;
  const bool approx = p.approx_gelu != 0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;

  bool first = true;  // a block's first tile stores its sums, later tiles add
  for (long long tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const long long row0 = tile * tr;
    const int rows = static_cast<int>(min(static_cast<long long>(tr), n_rows - row0));
    auto add = [first](float* dst, float v) { *dst = first ? v : *dst + v; };
    // h_l = GELU(z_{l-1}) in CD, rebuilt into dst (row stride dz_ld)
    auto rebuild_h = [&](int l, CD* dst) {
      const int N = p.dims[l];
      const float* z = zbuf + p.z_off[l - 1];
      for (int idx = threadIdx.x; idx < rows * N; idx += blockDim.x) {
        const int r = idx / N;
        const int j = idx - r * N;
        dst[r * dz_ld + j] = from_f<CD>(gelu(z[r * z_ld + j], approx));
      }
    };

    // 1. h_0 = x in the compute type; z from zs or recomputed
    for (int idx = threadIdx.x; idx < rows * c_in; idx += blockDim.x)
      h0[idx] = from_f<CD>(to_f(x[row0 * c_in + idx]));
    if (p.zs_ld > 0) {
      const int zs_ld = p.zs_ld;
      for (int idx = threadIdx.x; idx < rows * zs_ld; idx += blockDim.x) {
        const int r = idx / zs_ld;
        zbuf[r * z_ld + (idx - r * zs_ld)] = to_f(zs[row0 * zs_ld + idx]);
      }
    } else {
      __syncthreads();
      // the chain's inputs ping-pong between hbuf and dzc (free until step
      // 2); without LayerNorm the last layer's z is never read: skip it
      const int n_fwd = p.has_ln ? L : L - 1;
      for (int l = 0; l < n_fwd; ++l) {
        const int K = p.dims[l];
        const int N = p.dims[l + 1];
        const CD* wl = w + p.w_off[l];
        const float* bl = b + p.b_off[l];
        const CD* h = l == 0 ? h0 : (l % 2 == 1 ? hbuf : dzc);
        const int h_ld = l == 0 ? c_in : dz_ld;
        float* zl = zbuf + p.z_off[l];
        CD* hn = l < L - 1 ? (l % 2 == 0 ? hbuf : dzc) : nullptr;
        gemm(1, rows, N, K,
             [h, h_ld](int, int r, int k) { return to_f(h[r * h_ld + k]); },
             [wl, N](int, int k, int j) { return to_f(wl[k * N + j]); },
             [=](int, int r, int j, float acc) {
               const float z = acc + bl[j];
               zl[r * z_ld + j] = z;
               if (hn != nullptr) hn[r * dz_ld + j] = from_f<CD>(gelu(z, approx));
             });
        __syncthreads();
      }
    }
    __syncthreads();

    // 2. dz of the last layer, its bias gradient and the LayerNorm gradients
    const IO* gt = g + row0 * c_out;
    if (p.has_ln) {
      const float* zl = zbuf + p.z_off[L - 1];
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
      for (int j = threadIdx.x; j < c_out; j += blockDim.x) {  // one thread a column
        float sdb = 0.f, sls = 0.f, slb = 0.f;
        for (int r = 0; r < rows; ++r) {
          const float* st = stats + r * 4;
          const float gv = to_f(gt[r * c_out + j]);
          const float xhat = (zl[r * z_ld + j] - st[0]) * st[1];
          const float dxhat = gv * ln_s[j];
          const float dz = st[1] * (dxhat - st[2] - xhat * st[3]);
          dzc[r * dz_ld + j] = from_f<CD>(dz);
          sdb += dz;
          sls += gv * xhat;
          slb += gv;
        }
        add(slab + p.db_base + p.b_off[L - 1] + j, sdb);
        add(slab + p.ln_base + j, sls);
        add(slab + p.ln_base + c_out + j, slb);
      }
    } else {
      for (int j = threadIdx.x; j < c_out; j += blockDim.x) {
        float sdb = 0.f;
        for (int r = 0; r < rows; ++r) {
          const float gv = to_f(gt[r * c_out + j]);
          dzc[r * dz_ld + j] = from_f<CD>(gv);
          sdb += gv;
        }
        add(slab + p.db_base + p.b_off[L - 1] + j, sdb);
      }
    }
    if (L > 1) rebuild_h(L - 1, hbuf);
    __syncthreads();

    // 3. the chain backwards; on entry dzc holds dz_l and, for l >= 1, hbuf h_l
    for (int l = L - 1; l >= 0; --l) {
      const int K = p.dims[l];
      const int N = p.dims[l + 1];
      const CD* h = l == 0 ? h0 : hbuf;
      const int h_ld = l == 0 ? c_in : dz_ld;
      const CD* dz = dzc;
      // dW_l (K x N) += h_l^T dz over the tile's rows
      float* dwl = slab + p.w_off[l];
      gemm(1, K, N, rows,
           [h, h_ld](int, int i, int r) { return to_f(h[r * h_ld + i]); },
           [dz, dz_ld](int, int r, int j) { return to_f(dz[r * dz_ld + j]); },
           [=](int, int i, int j, float acc) { add(dwl + i * N + j, acc); });
      // dh (rows x K) = dz W_l^T, with W_l^T read from the transposed copy
      const CD* wtl = wt + p.w_off[l];
      auto a = [dz, dz_ld](int, int r, int k) { return to_f(dz[r * dz_ld + k]); };
      auto bm = [wtl, K](int, int k, int i) { return to_f(wtl[k * K + i]); };
      if (l > 0) {
        float* zp = zbuf + p.z_off[l - 1];
        gemm(1, rows, K, N, a, bm, [=](int, int r, int i, float acc) {
          float* z = zp + r * z_ld + i;
          *z = acc * gelu_grad(*z, approx);  // dz_{l-1}, over z_{l-1}
        });
        __syncthreads();
        for (int j = threadIdx.x; j < K; j += blockDim.x) {
          float sdb = 0.f;
          for (int r = 0; r < rows; ++r) {
            const float v = zp[r * z_ld + j];
            dzc[r * dz_ld + j] = from_f<CD>(v);
            sdb += v;
          }
          add(slab + p.db_base + p.b_off[l - 1] + j, sdb);
        }
        if (l > 1) rebuild_h(l - 1, hbuf);
        __syncthreads();
      } else {
        IO* dxt = dx + row0 * c_in;
        gemm(1, rows, K, N, a, bm, [=](int, int r, int i, float acc) {
          dxt[r * c_in + i] = from_f<IO>(acc);
        });
      }
    }
    __syncthreads();
    first = false;
  }
}

// out[e] = sum over blocks b = 0, 1, ... of partials[b][e], in that order
__global__ void __launch_bounds__(kThreads)
reduce_slabs_kernel(const float* __restrict__ partials, float* __restrict__ out,
                    long long slab, int blocks) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= slab) return;
  float s = 0.f;
  for (int bi = 0; bi < blocks; ++bi) s += partials[bi * slab + e];
  out[e] = s;
}

template <typename CD, typename IO>
cudaError_t launch(const void* x, const void* g, const void* zs, void* dx, const void* w,
                   const void* wt, const float* b, const float* ln_s, float* partials,
                   float* grads, long long n_rows, BwdParams& p, size_t smem,
                   int max_blocks, cudaStream_t stream) {
  auto kernel = fused_ff_bwd_kernel<CD, IO>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                           smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // one resident block per slot of the card: the grid is fixed by the card
  // and the shapes, so the order of every sum is too
  long long blocks = static_cast<long long>(sms) * per_sm;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks > p.n_tiles) blocks = p.n_tiles;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const IO*>(x), static_cast<const IO*>(g), static_cast<const CD*>(zs),
      static_cast<IO*>(dx), static_cast<const CD*>(w), static_cast<const CD*>(wt), b, ln_s,
      partials, n_rows, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long rblocks = (p.slab + kThreads - 1) / kThreads;
  reduce_slabs_kernel<<<static_cast<unsigned>(rblocks), kThreads, 0, stream>>>(
      partials, grads, p.slab, static_cast<int>(blocks));
  return cudaGetLastError();
}

}  // namespace
}  // namespace rpde

// x (n_rows, dims[0]), g (n_rows, dims[n_layers]) and dx (n_rows, dims[0]),
// row-major in the io type. zs: null to recompute, or the forward kernel's
// saved pre-activations (n_rows, dims[1] + ... + dims[n_save]) in the
// compute type, n_save = n_layers with LayerNorm and n_layers - 1 without.
// w: every layer's (dims[l], dims[l+1]) kernel packed row-major, and wt the
// same kernels transposed, (dims[l+1], dims[l]) each, both in the compute
// type; b: the biases packed in f32; ln_s: the LayerNorm scale (f32), null
// for no LayerNorm. partials: max_blocks slabs of f32 scratch, each as
// large as grads. grads (f32) receives dW_0 .. dW_{L-1} packed as w, then
// db_0 .. db_{L-1} packed as b, then with LayerNorm dLN_scale and dLN_bias.
// Returns a cudaError_t.
extern "C" int rpde_fused_ff_backward(int cd_bf16, int io_bf16, const void* x,
                                      const void* g, const void* zs, void* dx,
                                      const void* w, const void* wt, const float* b,
                                      const float* ln_s, float* partials, float* grads,
                                      const int* dims, int n_layers, long long n_rows,
                                      int approx_gelu, int max_blocks, void* stream) {
  using namespace rpde;
  if (n_layers < 1 || n_layers > kMaxLayers || n_rows < 1 || max_blocks < 1)
    return cudaErrorInvalidValue;
  BwdParams p{};
  p.n_layers = n_layers;
  p.approx_gelu = approx_gelu;
  p.has_ln = ln_s != nullptr;
  long long w_off = 0;
  int b_off = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1) return cudaErrorInvalidValue;
    p.dims[l] = dims[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    p.w_off[l] = w_off;
    p.b_off[l] = b_off;
    p.z_off[l] = p.z_ld;
    w_off += static_cast<long long>(dims[l]) * dims[l + 1];
    b_off += dims[l + 1];
    p.z_ld += dims[l + 1];
    if (dims[l + 1] > p.dz_ld) p.dz_ld = dims[l + 1];
  }
  p.z_off[n_layers] = p.z_ld;
  if (zs != nullptr) p.zs_ld = p.z_off[p.has_ln ? n_layers : n_layers - 1];
  p.db_base = w_off;
  p.ln_base = w_off + b_off;
  p.slab = p.ln_base + (p.has_ln ? 2 * dims[n_layers] : 0);
  const size_t cd_size = cd_bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  // largest tile of rows whose buffers fit the shared-memory budget
  const size_t per_row = (static_cast<size_t>(p.z_ld) + 4) * sizeof(float) +
                         (static_cast<size_t>(dims[0]) + 2 * p.dz_ld) * cd_size;
  int tr = kBwdMaxTileRows;
  while (tr > 1 && tr * per_row > static_cast<size_t>(kBwdSmemBudget)) tr /= 2;
  if (tr * per_row > static_cast<size_t>(kBwdSmemBudget)) return cudaErrorInvalidValue;
  p.tile_rows = tr;
  p.n_tiles = (n_rows + tr - 1) / tr;
  const size_t smem = tr * per_row;
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
