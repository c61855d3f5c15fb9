// S4D kernel materialization, the log-Vandermonde reduction, forward only.
//
// Replaces the TPU kernel resolution_pde_tpu/ops/pallas/vandermonde.py
// `s4d_kernel_pallas` (its `_kernel` and the operand preparation that XLA
// fuses around it). For row r (a kernel channel folded with a feature) and
// position l:
//     K[r, l] = 2 * sum_n Re(C'[r, n] e^{dtA[r, n] l})
// with dtA = A dt, dt = e^{log_dt} and C' = C (e^{dtA} - 1) / A.
//
// Two entries share one kernel body and differ in where a state's (dtA, C')
// comes from:
//  - rpde_s4d_kernel (the model's route) takes the JAX wrapper's inputs, C
//    (rows, n) and A (H, n) as interleaved complex64, log_dt (H,) f32, and
//    forms dtA and C' per state in the prologue, with torch's rounding
//    points (ops/kernels/vandermonde.py `s4d_operands`): dt = expf(log_dt),
//    dtA = A dt, e^{dtA} as e^a (cos b + i sin b) with each product
//    rounded, minus 1, the complex product and c10::complex's division
//    (Smith's algorithm, complex_mul / complex_div below). Row r reads A and
//    log_dt at r mod H, so nothing is tiled or copied before the launch.
//  - rpde_vandermonde takes the f32 planes (ar, ai, cr, ci), (rows, n).
//
// What bounds it on an H100: at the S4D serving shape (128 rows = 2
// channels x 64 features, N/2 = 32 states, L = 512) the function is 2.1 M
// terms e^{dtA l}; evaluated term by term (the TPU kernel's way: expf and
// sincosf a term, about 45 instructions) that is about 3 us of the card's
// issue slots even with every SM full. So the powers are
// factored: l = l0 + 32 m + j, and
//     C' e^{dtA l} = (C' e^{dtA (l0 + 32 m)}) e^{dtA j},
// a table T[n][j] of 32 powers and 16 anchors B[m][n] (C' folded in) per
// state of a block's 512 positions, 48 complex exponentials a state instead
// of 512. A position's sum is then 2 FMAs a state, from shared memory, like
// a small real GEMM [Br, -Bi] @ [Tr; Ti]. A block takes one row's 512
// positions, a thread one position (the 32 lanes of a warp the 32 table
// columns, one anchor a warp), states in chunks of 32 staged in shared
// memory: at the serving shape 128 blocks of 16 warps, one an SM.
//
// Rounding: the TPU kernel and the plain version round the phase as
// fl(Im(dtA) l), which at dt = 0.1 and l = 511 is thousands of radians
// off by up to 3e-4. The table and the anchors instead take each power's
// exponent exactly, as the rounded product plus its remainder
// (fma(x, l, -fl(x l))), and correct the exponential and the sine and
// cosine by it to first order. So the kernel is closer to a float64
// evaluation than the plain version is (chip_smoke.py's slow-decay case,
// Re A = -1e-4, dt = 0.1, L = 512, checks it); against the plain version it
// differs by the plain version's own phase error (relative L2 about 2e-6 at
// the serving shape).
//
// No fast-math intrinsics: the library is built without --use_fast_math,
// and the code calls the accurate expf and sincosf, never __expf or
// __sinf, whose error is bounded only on [-pi, pi] and grows with the
// argument outside it; sincosf reduces the argument exactly.

#include <cuda_runtime.h>

namespace rpde {
namespace {

constexpr int kVdmThreads = 512;                   // positions of a block, one a thread
constexpr int kVdmPowers = 32;                     // table columns: j of l = l0 + 32 m + j
constexpr int kVdmAnchors = kVdmThreads / kVdmPowers;  // 16 anchors a block
constexpr int kVdmChunk = 32;                      // states staged in shared memory at once

// c10::complex's operator* and operator/ (torch/headeronly/util/complex.h),
// which the plain version's complex tensors run on the card.
__device__ __forceinline__ float2 complex_mul(float2 x, float2 y) {
  return make_float2(x.x * y.x - x.y * y.y, x.x * y.y + x.y * y.x);
}

__device__ __forceinline__ float2 complex_div(float2 x, float2 y) {
  const float a = x.x, b = x.y, c = y.x, d = y.y;
  const float abs_c = c < 0 ? -c : c, abs_d = d < 0 ? -d : d;
  if (abs_c >= abs_d) {
    if (abs_c == 0.f && abs_d == 0.f) return make_float2(a / abs_c, b / abs_d);
    const float rat = d / c;
    const float scl = 1.0f / (c + d * rat);
    return make_float2((a + b * rat) * scl, (b - a * rat) * scl);
  }
  const float rat = c / d;
  const float scl = 1.0f / (d + c * rat);
  return make_float2((a * rat + b) * scl, (b * rat - a) * scl);
}

// e^{z k} for an integer k, its exponent z k taken exactly: the rounded
// product plus the remainder the FMA gives, which corrects e^a and the
// sine and cosine to first order.
__device__ __forceinline__ float2 power(float2 z, int k) {
  const float fk = static_cast<float>(k);
  const float a = __fmul_rn(z.x, fk), b = __fmul_rn(z.y, fk);
  const float a_lo = fmaf(z.x, fk, -a), b_lo = fmaf(z.y, fk, -b);
  float s, c;
  sincosf(b, &s, &c);
  const float e = expf(a) * (1.0f + a_lo);
  return make_float2(e * fmaf(-s, b_lo, c), e * fmaf(c, b_lo, s));
}

// A state's (dtA, C') from the f32 planes.
struct VdmPlanes {
  const float *ar, *ai, *cr, *ci;
  int n;
  __device__ void state(long long row, int k, float2& dta, float2& cp) const {
    const long long at = row * n + k;
    dta = make_float2(ar[at], ai[at]);
    cp = make_float2(cr[at], ci[at]);
  }
};

// A state's (dtA, C') from the JAX wrapper's inputs, as s4d_operands forms
// them: C (rows, n) and A (H, n) interleaved complex64, log_dt (H,).
struct VdmFused {
  const float2 *c, *a;
  const float* log_dt;
  int h, n;
  __device__ void state(long long row, int k, float2& dta, float2& cp) const {
    const int hh = static_cast<int>(row % h);
    const float dt = expf(log_dt[hh]);
    const float2 ak = a[static_cast<long long>(hh) * n + k];
    dta = make_float2(__fmul_rn(ak.x, dt), __fmul_rn(ak.y, dt));
    const float e = expf(dta.x);
    float s, co;
    sincosf(dta.y, &s, &co);
    const float2 em1 = make_float2(__fsub_rn(__fmul_rn(e, co), 1.0f), __fmul_rn(e, s));
    cp = complex_div(complex_mul(c[row * n + k], em1), ak);
  }
};

template <typename States>
__global__ void __launch_bounds__(kVdmThreads)
vandermonde_kernel(States states, float* __restrict__ out, int n, int L, int l_tiles) {
  __shared__ float2 s_dta[kVdmChunk], s_cp[kVdmChunk];
  __shared__ float2 s_pow[kVdmChunk][kVdmPowers];  // T[n][j] = e^{dtA j}
  __shared__ float2 s_anc[kVdmAnchors][kVdmChunk];  // B[m][n] = C' e^{dtA (l0 + 32 m)}
  const long long row = blockIdx.x / l_tiles;
  const int l0 = static_cast<int>(blockIdx.x - row * l_tiles) * kVdmThreads;
  const int t = threadIdx.x;
  const int j = t % kVdmPowers, m = t / kVdmPowers;
  const bool live = l0 + t < L;
  const int anchors = min(kVdmAnchors, (L - l0 + kVdmPowers - 1) / kVdmPowers);
  float sum_re = 0.f, sum_im = 0.f;
  for (int n0 = 0; n0 < n; n0 += kVdmChunk) {
    const int cn = min(kVdmChunk, n - n0);
    if (n0 > 0) __syncthreads();  // every warp is done with the last chunk
    if (t < cn) states.state(row, n0 + t, s_dta[t], s_cp[t]);
    __syncthreads();
    for (int i = t; i < cn * kVdmPowers; i += kVdmThreads) {
      const int s = i / kVdmPowers, jj = i - s * kVdmPowers;
      s_pow[s][jj] = power(s_dta[s], jj);
    }
    for (int i = t; i < anchors * cn; i += kVdmThreads) {
      const int mm = i / cn, s = i - mm * cn;
      s_anc[mm][s] = complex_mul(s_cp[s], power(s_dta[s], l0 + kVdmPowers * mm));
    }
    __syncthreads();
    if (live) {
#pragma unroll 8
      for (int s = 0; s < cn; ++s) {
        const float2 b = s_anc[m][s], p = s_pow[s][j];
        sum_re = fmaf(b.x, p.x, sum_re);
        sum_im = fmaf(b.y, p.y, sum_im);
      }
    }
  }
  if (live) out[row * L + l0 + t] = 2.0f * (sum_re - sum_im);
}

template <typename States>
int launch(const States& states, void* out, int rows, int n, int L, void* stream) {
  const int l_tiles = (L + kVdmThreads - 1) / kVdmThreads;
  const long long blocks = static_cast<long long>(rows) * l_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  vandermonde_kernel<<<static_cast<unsigned>(blocks), kVdmThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(states, static_cast<float*>(out), n,
                                                            L, l_tiles);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rpde

// ar, ai, cr, ci: (rows, n) f32 row-major; out: (rows, L) f32.
// Returns a cudaError_t.
extern "C" int rpde_vandermonde(const void* ar, const void* ai, const void* cr,
                                const void* ci, void* out, int rows, int n, int L,
                                void* stream) {
  using namespace rpde;
  if (rows < 1 || n < 1 || L < 1) return cudaErrorInvalidValue;
  const VdmPlanes planes{static_cast<const float*>(ar), static_cast<const float*>(ai),
                         static_cast<const float*>(cr), static_cast<const float*>(ci), n};
  return launch(planes, out, rows, n, L, stream);
}

// c: (rows, n) complex64 (interleaved, rows = channels x h); a: (h, n)
// complex64; log_dt: (h,) f32; out: (rows, L) f32. Row r reads a and
// log_dt at r mod h. Returns a cudaError_t.
extern "C" int rpde_s4d_kernel(const void* c, const void* a, const void* log_dt, void* out,
                               int rows, int h, int n, int L, void* stream) {
  using namespace rpde;
  if (rows < 1 || h < 1 || rows % h != 0 || n < 1 || L < 1) return cudaErrorInvalidValue;
  const VdmFused fused{static_cast<const float2*>(c), static_cast<const float2*>(a),
                       static_cast<const float*>(log_dt), h, n};
  return launch(fused, out, rows, n, L, stream);
}
