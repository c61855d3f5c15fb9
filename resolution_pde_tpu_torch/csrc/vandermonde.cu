// S4D kernel materialization, the log-Vandermonde reduction, forward only.
//
// Replaces the TPU kernel resolution_pde_tpu/ops/pallas/vandermonde.py
// `s4d_kernel_pallas` (its `_kernel`). For row r (a kernel channel folded
// with a feature) and position l:
//     K[r, l] = 2 * sum_n (cr[r, n] e^{ar l} cos(ai l)
//                          - ci[r, n] e^{ar l} sin(ai l))
// with (ar, ai) = Re/Im(dt A) and (cr, ci) = Re/Im(C (e^{dt A} - 1) / A), all
// f32 planes. The products and sums follow the TPU kernel: a = ar * l and
// b = ai * l in f32, e = exp(a), re = e cos b, im = e sin b, then the two
// sums over n, then 2 (sum_re - sum_im).
//
// What bounds it on an H100: at the S4D serving shape (128 rows = 2
// channels x 64 features, N/2 = 32 states, L = 512) the reduction is
// 128 * 32 * 512 = 2.1 M terms, each 3 transcendentals and about 8 flops
// (under 1 us at the f32 rate), and it moves 0.33 MB (about 0.1 us at
// 3.35 TB/s): far below the few microseconds a launch costs. The kernel is
// launch-bound, so the design is the simple one: one thread per (row, l),
// a block per (row, 128 positions), the row's parameters staged in shared
// memory chunk by chunk, the ragged end of L masked (the TPU wrapper's
// padding has no counterpart here).
//
// No fast-math intrinsics: the library is built without --use_fast_math,
// and the code calls the accurate expf and sincosf, never __expf or
// __sinf. Im(dt A) * l reaches thousands of radians (dt = 0.1, Im A up to
// pi * 31, L = 512), and the intrinsics' error is bounded only on
// [-pi, pi] and grows with the argument outside it; sincosf reduces the
// argument exactly.

#include <cuda_runtime.h>

namespace rpde {
namespace {

constexpr int kVdmThreads = 128;  // positions per block
constexpr int kVdmChunk = 256;    // states staged in shared memory at once

__global__ void __launch_bounds__(kVdmThreads)
vandermonde_kernel(const float* __restrict__ ar, const float* __restrict__ ai,
                   const float* __restrict__ cr, const float* __restrict__ ci,
                   float* __restrict__ out, int n, int L, int l_tiles) {
  __shared__ float s_ar[kVdmChunk], s_ai[kVdmChunk], s_cr[kVdmChunk],
      s_ci[kVdmChunk];
  const long long row = blockIdx.x / l_tiles;
  const int l = (blockIdx.x - row * l_tiles) * kVdmThreads + threadIdx.x;
  const bool live = l < L;
  const float fl = static_cast<float>(l);
  const long long base = row * n;
  float sum_re = 0.f, sum_im = 0.f;
  for (int n0 = 0; n0 < n; n0 += kVdmChunk) {
    const int cn = min(kVdmChunk, n - n0);
    for (int j = threadIdx.x; j < cn; j += blockDim.x) {
      s_ar[j] = ar[base + n0 + j];
      s_ai[j] = ai[base + n0 + j];
      s_cr[j] = cr[base + n0 + j];
      s_ci[j] = ci[base + n0 + j];
    }
    __syncthreads();
    if (live) {
      for (int j = 0; j < cn; ++j) {
        const float e = expf(s_ar[j] * fl);
        float s, c;
        sincosf(s_ai[j] * fl, &s, &c);
        sum_re += s_cr[j] * (e * c);
        sum_im += s_ci[j] * (e * s);
      }
    }
    __syncthreads();
  }
  if (live) out[row * L + l] = 2.0f * (sum_re - sum_im);
}

}  // namespace
}  // namespace rpde

// ar, ai, cr, ci: (rows, n) f32 row-major; out: (rows, L) f32.
// Returns a cudaError_t.
extern "C" int rpde_vandermonde(const void* ar, const void* ai,
                                const void* cr, const void* ci, void* out,
                                int rows, int n, int L, void* stream) {
  using namespace rpde;
  if (rows < 1 || n < 1 || L < 1) return cudaErrorInvalidValue;
  const int l_tiles = (L + kVdmThreads - 1) / kVdmThreads;
  const long long blocks = static_cast<long long>(rows) * l_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  vandermonde_kernel<<<static_cast<unsigned>(blocks), kVdmThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ar), static_cast<const float*>(ai),
      static_cast<const float*>(cr), static_cast<const float*>(ci),
      static_cast<float*>(out), n, L, l_tiles);
  return cudaGetLastError();
}
