// The four Cauchy sums of the S4 DPLR kernel, forward only.
//
// Replaces the TPU kernel resolution_pde_tpu/ops/pallas/cauchy.py
// `cauchy_pallas` (its `_kernel`; reached through `dplr_kernel_pallas`). For
// row r (a kernel channel folded with a feature), position l and t = 0..3:
//     k_t[r, l] = sum_n v_t[r, n] / (g[r, l] - Lambda[r, n])
// on f32 real and imaginary planes, with the TPU kernel's arithmetic:
//     d = g - Lambda, inv = 1 / (dr^2 + di^2), dr *= inv, di *= inv,
//     Re k_t += vr dr + vi di,  Im k_t += vi dr - vr di.
//
// What bounds it on an H100: at the S4 serving shape (128 rows = 2
// channels x 64 features, N = 64 states, L = 512) the sums are
// 128 * 64 * 512 = 4.2 M (row, n, l) terms of about 40 flops, 168 MFLOP,
// about 2.5 us at 67 TFLOP/s f32, and they move about 2.9 MB (v, Lambda,
// g in, the two (4, rows, L) planes out), about 0.9 us at 3.35 TB/s: on the
// order of a launch's own cost. The kernel is launch-bound at these shapes,
// so the design is the simple one: one thread per (row, l) holding the
// eight sums in registers, a block per (row, 128 positions), the row's
// v and Lambda staged in shared memory chunk by chunk, the ragged end of L
// masked. Rows of any length need no padding (the TPU wrapper pads Lambda
// with 1.0 only to keep its padded rows finite).
//
// No fast-math intrinsics: the library is built without --use_fast_math,
// and the reciprocal is the IEEE division 1.0f / x, never __fdividef, which
// is approximate and returns 0 for |x| > 2^126. At the root l = L/2 the
// bilinear point g is about 4.6e7 / dt, so |g|^2 reaches 2e21 at dt = 1e-3
// and grows as a trained dt shrinks; the IEEE division stays correctly
// rounded at every magnitude, as the plain version's does.

#include <cuda_runtime.h>

namespace rpde {
namespace {

constexpr int kCauchyThreads = 128;  // positions per block
constexpr int kCauchyChunk = 128;    // states staged in shared memory at once

__global__ void __launch_bounds__(kCauchyThreads)
cauchy_kernel(const float* __restrict__ vr, const float* __restrict__ vi,
              const float* __restrict__ lr, const float* __restrict__ li,
              const float* __restrict__ gr, const float* __restrict__ gi,
              float* __restrict__ outr, float* __restrict__ outi, int rows,
              int n, int L, int l_tiles) {
  __shared__ float s_vr[4][kCauchyChunk], s_vi[4][kCauchyChunk];
  __shared__ float s_lr[kCauchyChunk], s_li[kCauchyChunk];
  const long long row = blockIdx.x / l_tiles;
  const int l = (blockIdx.x - row * l_tiles) * kCauchyThreads + threadIdx.x;
  const bool live = l < L;
  const long long plane = static_cast<long long>(rows) * n;  // one v_t plane
  const float g_r = live ? gr[row * L + l] : 0.f;
  const float g_i = live ? gi[row * L + l] : 0.f;
  float acc_r[4] = {0.f, 0.f, 0.f, 0.f};
  float acc_i[4] = {0.f, 0.f, 0.f, 0.f};
  for (int n0 = 0; n0 < n; n0 += kCauchyChunk) {
    const int cn = min(kCauchyChunk, n - n0);
    for (int j = threadIdx.x; j < cn; j += blockDim.x) {
      const long long at = row * n + n0 + j;
      s_lr[j] = lr[at];
      s_li[j] = li[at];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        s_vr[t][j] = vr[t * plane + at];
        s_vi[t][j] = vi[t * plane + at];
      }
    }
    __syncthreads();
    if (live) {
      for (int j = 0; j < cn; ++j) {
        float dr = g_r - s_lr[j];
        float di = g_i - s_li[j];
        const float inv = 1.0f / (dr * dr + di * di);
        dr *= inv;
        di *= inv;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          acc_r[t] += s_vr[t][j] * dr + s_vi[t][j] * di;
          acc_i[t] += s_vi[t][j] * dr - s_vr[t][j] * di;
        }
      }
    }
    __syncthreads();
  }
  if (live) {
    const long long out_plane = static_cast<long long>(rows) * L;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      outr[t * out_plane + row * L + l] = acc_r[t];
      outi[t * out_plane + row * L + l] = acc_i[t];
    }
  }
}

}  // namespace
}  // namespace rpde

// vr, vi: (4, rows, n); lr, li: (rows, n); gr, gi: (rows, L); outr, outi:
// (4, rows, L); all f32 row-major. Returns a cudaError_t.
extern "C" int rpde_cauchy(const void* vr, const void* vi, const void* lr,
                           const void* li, const void* gr, const void* gi,
                           void* outr, void* outi, int rows, int n, int L,
                           void* stream) {
  using namespace rpde;
  if (rows < 1 || n < 1 || L < 1) return cudaErrorInvalidValue;
  const int l_tiles = (L + kCauchyThreads - 1) / kCauchyThreads;
  const long long blocks = static_cast<long long>(rows) * l_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cauchy_kernel<<<static_cast<unsigned>(blocks), kCauchyThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vr), static_cast<const float*>(vi),
      static_cast<const float*>(lr), static_cast<const float*>(li),
      static_cast<const float*>(gr), static_cast<const float*>(gi),
      static_cast<float*>(outr), static_cast<float*>(outi), rows, n, L,
      l_tiles);
  return cudaGetLastError();
}
