// Fused FFNO FeedForward, forward only.
//
// Replaces the TPU kernel resolution_pde_tpu/ops/pallas/fused_ff.py
// `_fwd_pallas` (entry `fused_feedforward`): per tile of rows it runs
//     x @ W1 + b1 -> GELU -> @ W2 + b2 -> ... -> @ WL + bL [-> LayerNorm]
//     [+ residual]
// with products in the compute type (bf16 or f32) accumulated in f32, the
// bias, GELU, LayerNorm and residual in f32, each hidden activation rounded
// to the compute type before the next product, and the output in x's type.
//
// What bounds it on an H100: unfused, the (rows, hidden) activations make
// several round trips through device memory (at the serving shape each is
// 524,288 x 256 values); fused, only x, the residual and the output move.
// The TPU kernel keeps 8192-row tiles in VMEM, which do not fit in the
// 227 KB of shared memory a block has, so a block here takes a tile of up
// to 64 rows, keeps the tile's hidden activations in shared memory (two
// ping-pong buffers in the compute type, plus the last layer's f32
// pre-activations for LayerNorm), and reads the weights through L2, where
// all blocks share them. Rows are independent in the forward pass, so
// blocks need no reduction across them; the ragged last tile is masked in
// the kernel. The products run on the CUDA cores in f32 FMA (block_gemm);
// tensor-core MMA, TMA staging of the weights and pipelining are later work,
// so this kernel is bound by its instruction issue, not by memory.

#include "common.cuh"

namespace rpde {
namespace {

constexpr int kMaxLayers = 32;
constexpr int kMaxTileRows = 64;
constexpr float kLnEps = 1e-5f;  // torch.nn.LayerNorm default

struct FFParams {
  int n_layers;
  int max_dim;
  int tile_rows;
  int approx_gelu;
  int dims[kMaxLayers + 1];
  long long w_off[kMaxLayers];  // element offset of layer l in the packed weights
  int b_off[kMaxLayers];        // element offset of layer l in the packed biases
};

__device__ __forceinline__ float gelu(float z, bool approx) {
  if (approx) {
    const float u = 0.7978845608028654f * (z + 0.044715f * z * z * z);
    return 0.5f * z * (1.0f + tanhf(u));
  }
  return 0.5f * z * (1.0f + erff(z * 0.7071067811865476f));
}

template <typename CD, typename IO>
__global__ void __launch_bounds__(kThreads)
fused_ff_fwd_kernel(const IO* __restrict__ x, const IO* __restrict__ residual,
                    IO* __restrict__ out, const CD* __restrict__ w,
                    const float* __restrict__ b, const float* __restrict__ ln_s,
                    const float* __restrict__ ln_b, long long n_rows, FFParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tr = p.tile_rows;
  CD* buf_a = reinterpret_cast<CD*>(smem);
  CD* buf_b = buf_a + tr * p.max_dim;
  float* zf = reinterpret_cast<float*>(buf_b + tr * p.max_dim);

  const long long row0 = static_cast<long long>(blockIdx.x) * tr;
  const int rows = static_cast<int>(min(static_cast<long long>(tr), n_rows - row0));
  const int c_in = p.dims[0];
  const int n_layers = p.n_layers;
  const int c_out = p.dims[n_layers];

  // x tile -> compute type; rows past the end read as zero and are never stored
  for (int idx = threadIdx.x; idx < tr * c_in; idx += blockDim.x) {
    const int r = idx / c_in;
    const float v = r < rows ? to_f(x[row0 * c_in + idx]) : 0.f;
    buf_a[idx] = from_f<CD>(v);
  }
  __syncthreads();

  CD* hin = buf_a;
  CD* hout = buf_b;
  const bool approx = p.approx_gelu != 0;
  for (int l = 0; l < n_layers; ++l) {
    const int K = p.dims[l];
    const int N = p.dims[l + 1];
    const CD* wl = w + p.w_off[l];
    const float* bl = b + p.b_off[l];
    const CD* h = hin;
    auto a = [h, K](int, int i, int k) { return to_f(h[i * K + k]); };
    auto bm = [wl, N](int, int k, int j) { return to_f(wl[k * N + j]); };
    if (l < n_layers - 1) {
      CD* ho = hout;
      gemm(1, tr, N, K, a, bm, [ho, bl, N, approx](int, int i, int j, float acc) {
        ho[i * N + j] = from_f<CD>(gelu(acc + bl[j], approx));
      });
      __syncthreads();
      CD* t = hin;
      hin = hout;
      hout = t;
    } else {
      gemm(1, tr, N, K, a, bm, [zf, bl, N](int, int i, int j, float acc) {
        zf[i * N + j] = acc + bl[j];
      });
      __syncthreads();
    }
  }

  // LayerNorm (two-pass mean and variance in f32) and the residual, one warp per row
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  for (int r = warp; r < rows; r += n_warps) {
    const float* z = zf + r * c_out;
    float mu = 0.f, rstd = 1.f;
    if (ln_s != nullptr) {
      float s = 0.f;
      for (int c = lane; c < c_out; c += 32) s += z[c];
      mu = warp_sum(s) / c_out;
      float v = 0.f;
      for (int c = lane; c < c_out; c += 32) {
        const float d = z[c] - mu;
        v += d * d;
      }
      rstd = rsqrtf(warp_sum(v) / c_out + kLnEps);
    }
    const long long base = (row0 + r) * c_out;
    for (int c = lane; c < c_out; c += 32) {
      float y = z[c];
      if (ln_s != nullptr) y = (y - mu) * rstd * ln_s[c] + ln_b[c];
      if (residual != nullptr) y += to_f(residual[base + c]);
      out[base + c] = from_f<IO>(y);
    }
  }
}

template <typename CD, typename IO>
cudaError_t launch(const void* x, const void* residual, void* out, const void* w,
                   const float* b, const float* ln_s, const float* ln_b,
                   long long n_rows, const FFParams& p, size_t smem,
                   cudaStream_t stream) {
  auto kernel = fused_ff_fwd_kernel<CD, IO>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = (n_rows + p.tile_rows - 1) / p.tile_rows;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const IO*>(x), static_cast<const IO*>(residual),
      static_cast<IO*>(out), static_cast<const CD*>(w), b, ln_s, ln_b, n_rows, p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rpde

// x, residual, out: (n_rows, dims[0]) and (n_rows, dims[n_layers]) row-major
// in the io type; w: every layer's (dims[l], dims[l+1]) row-major kernel,
// packed one after another in the compute type; b: the biases packed in f32;
// ln_s, ln_b: (dims[n_layers],) f32, both null for no LayerNorm; residual may
// be null. Returns a cudaError_t.
extern "C" int rpde_fused_ff_forward(int cd_bf16, int io_bf16, const void* x,
                                     const void* residual, void* out, const void* w,
                                     const float* b, const float* ln_s,
                                     const float* ln_b, const int* dims, int n_layers,
                                     long long n_rows, int approx_gelu, void* stream) {
  using namespace rpde;
  if (n_layers < 1 || n_layers > kMaxLayers || n_rows < 1 || (ln_s == nullptr) != (ln_b == nullptr))
    return cudaErrorInvalidValue;
  FFParams p{};
  p.n_layers = n_layers;
  p.approx_gelu = approx_gelu;
  const size_t cd_size = cd_bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  long long w_off = 0;
  int b_off = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1) return cudaErrorInvalidValue;
    p.dims[l] = dims[l];
    p.max_dim = dims[l] > p.max_dim ? dims[l] : p.max_dim;
    if (l < n_layers) {
      p.w_off[l] = w_off;
      p.b_off[l] = b_off;
      w_off += static_cast<long long>(dims[l]) * dims[l + 1];
      b_off += dims[l + 1];
    }
  }
  // largest tile of rows whose buffers fit the shared-memory budget
  size_t smem = 0;
  int tr = kMaxTileRows;
  for (; tr >= 1; tr /= 2) {
    smem = 2 * static_cast<size_t>(tr) * p.max_dim * cd_size +
           static_cast<size_t>(tr) * dims[n_layers] * sizeof(float);
    if (smem <= static_cast<size_t>(kSmemBudget)) break;
  }
  if (tr < 1) return cudaErrorInvalidValue;
  p.tile_rows = tr;
  auto s = static_cast<cudaStream_t>(stream);
  if (cd_bf16 && io_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, residual, out, w, b, ln_s, ln_b, n_rows, p, smem, s);
  if (cd_bf16)
    return launch<__nv_bfloat16, float>(x, residual, out, w, b, ln_s, ln_b, n_rows, p, smem, s);
  if (io_bf16)
    return launch<float, __nv_bfloat16>(x, residual, out, w, b, ln_s, ln_b, n_rows, p, smem, s);
  return launch<float, float>(x, residual, out, w, b, ln_s, ln_b, n_rows, p, smem, s);
}
