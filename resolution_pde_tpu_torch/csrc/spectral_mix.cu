// One FFNO axis pass: truncated forward DFT -> per-mode complex channel mix
// -> zero-padded inverse DFT, fused, forward only.
//
// Replaces two TPU kernels: resolution_pde_tpu/ops/pallas/spectral_mix2.py
// `_pass_pallas` (packed re/im, bf16 or f32; entry `packed_spectral_mix_1d`)
// and, as this kernel's f32 instantiation, ops/pallas/spectral_mix.py
// `_mix_pallas` (the f32-exact pass; entry `truncated_spectral_mix_1d`).
// Per row of the axis (n points, C channels):
//     z  = x^T (C, n) @ f2 (n, 2m)              spectrum, re | im lanes
//     mk = per mode k: z_k (2C) @ wpk[k] (2C, 2O) complex mix, packed
//     y  = mk (O, 2m) @ i2 (2m, n)              Hermitian-weighted inverse
// with every product in the compute type (bf16 or f32, IEEE f32 FMA, never
// TF32) accumulated in f32, and each intermediate rounded to the compute
// type, as the TPU kernel does; out is in x's type.
//
// What bounds it on an H100: the XLA form of the pass writes the spectra
// to device memory between its three products; here they stay in shared
// memory, and only x and out move. The TPU kernel takes 256-row tiles and
// the whole packed weight (2 MB in bf16 at m = 64, C = O = 64) into VMEM;
// neither fits a block's 227 KB, so a block takes a few rows (as many as
// fit the budget, at most 2), keeps each row's (n, C) input, then its
// (O, 2m) mixed spectrum in one buffer and its (m, 2C) spectrum in another,
// and reads the DFT factors and the packed weight through L2, where all
// blocks share them; the weight is reused across the block's rows. The
// products run on the CUDA cores (block_gemm), so the pass is bound by
// instruction issue; tensor cores, TMA and pipelining are later work.
//
// Strides: rows are r = r_hi * rows_lo + r_lo, and element (r, t, c) of x
// lies at r_hi * x_hi + r_lo * x_lo + t * x_ax + c. The W-axis pass of a
// channels-last (B, H, W, C) tensor and its H-axis pass both read the tensor
// in place, with no transposed copy. With `accumulate`, the pass adds its
// result (rounded to x's type) into out, rounding the sum to x's type, which
// is the TPU path's `yy + xx` of the two axis passes.

#include "common.cuh"

namespace rpde {
namespace {

// two rows a block: at the serving shape in bf16, 98 KB of shared memory,
// so two blocks share an SM (measured 20-25 % faster than four rows)
constexpr int kMaxTileRows = 2;
// padding of the mixed spectrum's rows in shared memory, so that threads
// reading one column of it hit different banks
constexpr int kMkPad = 2;

struct SpecParams {
  int n, m, c, o;
  int tile_rows;
  int xs_elems;  // per-row elements of the input / mixed-spectrum buffer
  int accumulate;
  long long rows;
  long long rows_lo;
  long long x_hi, x_lo, x_ax;
  long long y_hi, y_lo, y_ax;
};

template <typename CD, typename IO>
__global__ void __launch_bounds__(kThreads)
spectral_pass_kernel(const IO* __restrict__ x, const CD* __restrict__ f2,
                     const CD* __restrict__ i2, const CD* __restrict__ wpk,
                     IO* __restrict__ out, SpecParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tr = p.tile_rows, n = p.n, m = p.m, C = p.c, O = p.o;
  const int m2 = 2 * m, c2 = 2 * C, o2 = 2 * O;
  const int mk_ld = m2 + kMkPad;
  const int xe = p.xs_elems;
  CD* xs = reinterpret_cast<CD*>(smem);  // (tr, n, C), later (tr, O, mk_ld)
  CD* zs = xs + tr * xe;                 // (tr, m, 2C), mode-major

  const long long r0 = static_cast<long long>(blockIdx.x) * tr;
  const int rows = static_cast<int>(min(static_cast<long long>(tr), p.rows - r0));

  for (int idx = threadIdx.x; idx < tr * n * C; idx += blockDim.x) {
    const int t = idx / (n * C);
    const int rem = idx - t * n * C;
    const int w = rem / C;
    const int c = rem - w * C;
    float v = 0.f;
    if (t < rows) {
      const long long r = r0 + t;
      const long long hi = r / p.rows_lo;
      v = to_f(x[hi * p.x_hi + (r - hi * p.rows_lo) * p.x_lo + w * p.x_ax + c]);
    }
    xs[t * xe + w * C + c] = from_f<CD>(v);
  }
  __syncthreads();

  // forward DFT: z[t][c][j] = sum_w x[t][w][c] f2[w][j], j = s*m + k
  gemm(tr, C, m2, n,
       [xs, xe, C](int t, int c, int w) { return to_f(xs[t * xe + w * C + c]); },
       [f2, m2](int, int w, int j) { return to_f(f2[w * m2 + j]); },
       [zs, m, C, c2](int t, int c, int j, float acc) {
         const int s = j >= m;
         zs[(t * m + (j - s * m)) * c2 + s * C + c] = from_f<CD>(acc);
       });
  __syncthreads();

  // mix, batched over modes: mixed[t][k][q'] = sum_q z[t][k][q] wpk[k][q][q'],
  // q' = s*O + o, stored as mk[t][o][s*m + k] over the dead input buffer
  gemm(m, tr, o2, c2,
       [zs, m, c2](int k, int t, int q) { return to_f(zs[(t * m + k) * c2 + q]); },
       [wpk, c2, o2](int k, int q, int qo) {
         return to_f(wpk[(static_cast<long long>(k) * c2 + q) * o2 + qo]);
       },
       [xs, xe, O, m, mk_ld](int k, int t, int qo, float acc) {
         const int s = qo >= O;
         xs[t * xe + (qo - s * O) * mk_ld + s * m + k] = from_f<CD>(acc);
       });
  __syncthreads();

  // inverse DFT, transposed so consecutive threads store consecutive
  // channels: y[t][w][o] = sum_j i2[j][w] mk[t][o][j]
  const bool acc_out = p.accumulate != 0;
  const long long rows_lo = p.rows_lo, y_hi = p.y_hi, y_lo = p.y_lo, y_ax = p.y_ax;
  gemm(tr, n, O, m2,
       [i2, n](int, int w, int j) { return to_f(i2[j * n + w]); },
       [xs, xe, mk_ld](int t, int j, int o) { return to_f(xs[t * xe + o * mk_ld + j]); },
       [=](int t, int w, int o, float acc) {
         if (t >= rows) return;
         const long long r = r0 + t;
         const long long hi = r / rows_lo;
         IO* dst = out + hi * y_hi + (r - hi * rows_lo) * y_lo + w * y_ax + o;
         float v = round_to<IO>(acc);
         if (acc_out) v += to_f(*dst);
         *dst = from_f<IO>(v);
       });
}

template <typename CD, typename IO>
cudaError_t launch(const void* x, const void* f2, const void* i2, const void* wpk,
                   void* out, const SpecParams& p, size_t smem, cudaStream_t stream) {
  auto kernel = spectral_pass_kernel<CD, IO>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = (p.rows + p.tile_rows - 1) / p.tile_rows;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const IO*>(x), static_cast<const CD*>(f2), static_cast<const CD*>(i2),
      static_cast<const CD*>(wpk), static_cast<IO*>(out), p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rpde

// x: rows of an axis of length n with c channels (strides above), io type;
// f2 (n, 2m), i2 (2m, n), wpk (m, 2c, 2o): row-major, compute type;
// out: rows of o channels (strides above), io type. Returns a cudaError_t.
extern "C" int rpde_spectral_pass(int cd_bf16, int io_bf16, const void* x,
                                  const void* f2, const void* i2, const void* wpk,
                                  void* out, int n, int m, int c, int o,
                                  long long rows, long long rows_lo, long long x_hi,
                                  long long x_lo, long long x_ax, long long y_hi,
                                  long long y_lo, long long y_ax, int accumulate,
                                  void* stream) {
  using namespace rpde;
  if (n < 1 || m < 1 || c < 1 || o < 1 || rows < 1 || rows_lo < 1)
    return cudaErrorInvalidValue;
  SpecParams p{};
  p.n = n;
  p.m = m;
  p.c = c;
  p.o = o;
  p.rows = rows;
  p.rows_lo = rows_lo;
  p.x_hi = x_hi;
  p.x_lo = x_lo;
  p.x_ax = x_ax;
  p.y_hi = y_hi;
  p.y_lo = y_lo;
  p.y_ax = y_ax;
  p.accumulate = accumulate;
  const int mk_elems = (2 * m + kMkPad) * o;
  p.xs_elems = n * c > mk_elems ? n * c : mk_elems;
  const size_t cd_size = cd_bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  const size_t per_row = (static_cast<size_t>(p.xs_elems) + 2 * static_cast<size_t>(m) * c) * cd_size;
  int tr = kMaxTileRows;
  while (tr > 1 && tr * per_row > static_cast<size_t>(kSmemBudget)) tr /= 2;
  if (tr * per_row > static_cast<size_t>(kSmemBudget)) return cudaErrorInvalidValue;
  p.tile_rows = tr;
  const size_t smem = tr * per_row;
  auto s = static_cast<cudaStream_t>(stream);
  if (cd_bf16 && io_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, f2, i2, wpk, out, p, smem, s);
  if (cd_bf16) return launch<__nv_bfloat16, float>(x, f2, i2, wpk, out, p, smem, s);
  if (io_bf16) return launch<float, __nv_bfloat16>(x, f2, i2, wpk, out, p, smem, s);
  return launch<float, float>(x, f2, i2, wpk, out, p, smem, s);
}
