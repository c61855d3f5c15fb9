// The four Cauchy sums of the S4 DPLR kernel, forward only.
//
// Replaces the TPU kernel resolution_pde_tpu/ops/pallas/cauchy.py
// `cauchy_pallas` (its `_kernel`), and with it the work XLA fuses around it
// in `dplr_kernel_pallas` up to the inverse FFT. For row r (a kernel
// channel folded with a feature), position l and t = 0..3:
//     k_t[r, l] = sum_n v_t[r, n] / (g[r, l] - Lambda[r, n])
// with the TPU kernel's arithmetic:
//     d = g - Lambda, inv = 1 / (dr^2 + di^2), dr *= inv, di *= inv,
//     Re k_t += vr dr + vi di,  Im k_t += vi dr - vr di.
//
// Two entries share one kernel body and differ in the prologue, which
// stages a chunk of states (v, Lambda) and the block's positions (g) in
// shared memory, and in the epilogue:
//  - rpde_dplr_at_roots (the model's route) takes Lambda, P, B (H, N) and
//    C~ (rows, N) as interleaved complex64 and log_dt (H,), row r reading
//    Lambda, P, B and log_dt at r mod H. The prologue forms the products v
//    of {conj C~, conj P} with {B, P} per state, and per position the root
//    omega from the f32 angle fl(fl(l fl(-2 pi)) / L) (as
//    ops/ssm.py `roots_of_unity` forms it, so 1 + omega stays i 8.7e-8 at
//    l = L/2), g = (2/dt)(1 - omega)/(1 + omega) and c = 2/(1 + omega),
//    with torch's rounding points and c10::complex's division. The epilogue
//    is the Woodbury combination c (k00 - k01 k10 / (1 + k11)), stored as
//    one interleaved complex64 (rows, L) array for torch.fft.ifft.
//  - rpde_cauchy takes the f32 planes v (4, rows, N), Lambda (rows, N) and
//    g (rows, L) and stores the four sums as planes (4, rows, L).
//
// What bounds it on an H100: at the S4 serving shape (128 rows = 2
// channels x 64 features, N = 64 states, L = 512) there are 4.2 M (row, n,
// l) terms, 16 FMAs each (four complex multiply-adds) beside the
// difference, |d|^2 and its reciprocal. The rows of one feature's channels
// (a bidirectional layer's two) share Lambda, g and so d and its
// reciprocal, and v2 = conj(P) B and v3 = conj(P) P, hence k10 and k11:
// the fused entry gives a block both channels of a feature, which computes
// those once, about 37 instructions for the two rows' terms instead of 66,
// bit for bit what each row alone would give. So the function needs 24
// flops per (feature, n, l) and 16 per (row, n, l), about 121 MFLOP with
// the prologue and epilogue, 1.8 us at 67 TFLOP/s f32; it moves about
// 0.7 MB (0.2 us). It is the terms' instructions that bound it. A
// position's states are split over 4 neighbouring lanes (state k to lane
// k mod 4, so a warp's shared loads fall in distinct banks and are
// broadcast to the 8 lanes of each), each thread takes 2 positions, so one
// load of a state serves both, and the lanes' sums meet through shuffles,
// the last step leaving each of the 4 lanes one row's sums at one
// position, for the Woodbury epilogue. A block of 256 threads takes 128
// positions; its positions' g and c, and its first chunk of states, are
// formed by different threads at once, so that their latencies overlap.
// The plane entry takes one row a block, its four products from the
// planes.
//
// No fast-math intrinsics: the library is built without --use_fast_math,
// and the reciprocal is the correctly rounded __frcp_rn (the same bits as
// 1.0f / x), never __fdividef, which is approximate and returns 0 for
// |x| > 2^126. At the root l = L/2 the bilinear point g is about 4.6e7 / dt,
// so |g|^2 reaches 2e21 at dt = 1e-3 and grows as a trained dt shrinks;
// the correctly rounded reciprocal stays right at every magnitude, as the
// plain version's does.

#include <cuda_runtime.h>

namespace rpde {
namespace {

constexpr int kCauchyThreads = 256;
constexpr int kCauchyLanes = 4;  // lanes that split a position's states
constexpr int kCauchyPos = 2;    // positions a thread
constexpr int kCauchyTile = kCauchyThreads / kCauchyLanes * kCauchyPos;  // positions a block
constexpr int kCauchyChunk = 128;  // states staged in shared memory at once
static_assert(kCauchyTile <= kCauchyThreads - kCauchyChunk,
              "the positions' and the first chunk's threads overlap");
// the f32 -2 pi, as roots_of_unity rounds it
constexpr float kNegTwoPi = -6.28318530717958647692f;

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

// A block's rows: kCh rows that share Lambda, g and the products v2, v3
// (the channels of one feature in the fused entry; one row in the plane
// entry), group `grp` of rows / kCh.
//
// The f32 planes: v (4, rows, n), Lambda (rows, n), g (rows, L) in; the
// sums out as (4, rows, L) planes. One row a group.
struct CauchyPlanes {
  static constexpr int kCh = 1;
  const float *vr, *vi, *lr, *li, *gr, *gi;
  float *outr, *outi;
  int rows, n, L;
  // state k of the group: a[c] = (v0, v1) of its row c, b = (v2, v3)
  __device__ void state(int grp, int k, float4 (&a)[1], float4& b, float2& lam) const {
    const long long at = static_cast<long long>(grp) * n + k,
                    plane = static_cast<long long>(rows) * n;
    a[0] = make_float4(vr[at], vi[at], vr[plane + at], vi[plane + at]);
    b = make_float4(vr[2 * plane + at], vi[2 * plane + at], vr[3 * plane + at],
                    vi[3 * plane + at]);
    lam = make_float2(lr[at], li[at]);
  }
  __device__ void position(int grp, int l, float2& g, float2&) const {
    const long long at = static_cast<long long>(grp) * L + l;
    g = make_float2(gr[at], gi[at]);
  }
  // k: the four sums (re, im) of row c of the group at position l
  __device__ void store(int grp, int, int l, const float (&k)[8], float2) const {
    const long long at = static_cast<long long>(grp) * L + l,
                    plane = static_cast<long long>(rows) * L;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      outr[t * plane + at] = k[2 * t];
      outi[t * plane + at] = k[2 * t + 1];
    }
  }
};

// The DPLR kernel's operands from its parameters, and the Woodbury
// combination at the roots, as ops/kernels/cauchy.py `dplr_operands` and
// `dplr_at_roots_reference` form them. Group grp is feature h = grp mod H
// of channels KCh (grp / H) .. KCh (grp / H) + KCh - 1, rows c H + h: they
// share Lambda, P, B, dt, so g and v2 = conj(P) B, v3 = conj(P) P.
template <int KCh>
struct DplrFused {
  static constexpr int kCh = KCh;
  const float2 *lam, *p, *b, *c_tilde;
  const float* log_dt;
  float2* out;
  int h, n, L;
  __device__ int row(int grp, int c) const { return (grp / h * kCh + c) * h + grp % h; }
  __device__ void state(int grp, int k, float4 (&a)[kCh], float4& v23, float2& lam_k) const {
    const long long at = static_cast<long long>(grp % h) * n + k;
    const float2 pk = p[at], bk = b[at];
    const float2 a1 = make_float2(pk.x, -pk.y);
    const float2 v2 = complex_mul(a1, bk), v3 = complex_mul(a1, pk);
    v23 = make_float4(v2.x, v2.y, v3.x, v3.y);
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      const float2 ct = c_tilde[static_cast<long long>(row(grp, c)) * n + k];
      const float2 a0 = make_float2(ct.x, -ct.y);
      const float2 v0 = complex_mul(a0, bk), v1 = complex_mul(a0, pk);
      a[c] = make_float4(v0.x, v0.y, v1.x, v1.y);
    }
    lam_k = lam[at];
  }
  __device__ void position(int grp, int l, float2& g, float2& c) const {
    const float two_dt = __fdiv_rn(2.0f, expf(log_dt[grp % h]));
    const float ang = __fdiv_rn(__fmul_rn(static_cast<float>(l), kNegTwoPi),
                                static_cast<float>(L));
    float s, co;
    sincosf(ang, &s, &co);
    const float2 den = make_float2(__fadd_rn(co, 1.0f), s);
    const float2 q = complex_div(make_float2(__fsub_rn(1.0f, co), -s), den);
    g = make_float2(__fmul_rn(two_dt, q.x), __fmul_rn(two_dt, q.y));
    const float2 r = complex_div(make_float2(1.0f, 0.0f), den);
    c = make_float2(2.0f * r.x, 2.0f * r.y);
  }
  __device__ void store(int grp, int ch, int l, const float (&k)[8], float2 c) const {
    const float2 k00 = make_float2(k[0], k[1]), k01 = make_float2(k[2], k[3]);
    const float2 k10 = make_float2(k[4], k[5]), k11 = make_float2(k[6], k[7]);
    const float2 r =
        complex_div(make_float2(1.0f, 0.0f), make_float2(__fadd_rn(k11.x, 1.0f), k11.y));
    const float2 w = complex_mul(complex_mul(k01, r), k10);
    out[static_cast<long long>(row(grp, ch)) * L + l] =
        complex_mul(c, make_float2(__fsub_rn(k00.x, w.x), __fsub_rn(k00.y, w.y)));
  }
};

// acc += (vr + i vi) (dr - i di) for the two complex values of v, into
// four sums (re, im, re, im)
__device__ __forceinline__ void cauchy_macs(const float4& v, float dr, float di, float* acc) {
  acc[0] = fmaf(v.x, dr, fmaf(v.y, di, acc[0]));
  acc[1] = fmaf(v.y, dr, fmaf(-v.x, di, acc[1]));
  acc[2] = fmaf(v.z, dr, fmaf(v.w, di, acc[2]));
  acc[3] = fmaf(v.w, dr, fmaf(-v.z, di, acc[3]));
}

// A block takes kCauchyTile positions of one group of kCh rows. Its
// kCauchyThreads threads: kCauchyLanes neighbouring lanes split a
// position's states (state k to lane k mod kCauchyLanes), each thread two
// positions. A thread's sums: per position, (k00, k01) of each row and
// the shared (k10, k11).
template <typename Ops>
__global__ void __launch_bounds__(kCauchyThreads)
cauchy_kernel(Ops ops, int n, int L, int l_tiles) {
  constexpr int kCh = Ops::kCh;
  constexpr int kSums = 4 * kCh + 4;
  __shared__ float4 s_a[kCh][kCauchyChunk], s_b[kCauchyChunk];
  __shared__ float2 s_lam[kCauchyChunk];
  __shared__ float2 s_g[kCauchyTile], s_c[kCauchyTile];
  const int grp = blockIdx.x / l_tiles;
  const int l0 = (blockIdx.x - grp * l_tiles) * kCauchyTile;
  const int t = threadIdx.x;
  const int lane = t % kCauchyLanes;  // this thread's states: lane, lane + kCauchyLanes, ..
  const int q = t / kCauchyLanes;     // this thread's positions: 2q, 2q + 1
  // the positions' g and c, and the first chunk's states, by other threads
  // at once, so that their latencies overlap
  const int st = t - (kCauchyThreads - kCauchyChunk);
  if (t < kCauchyTile) {
    float2 g = make_float2(0.f, 0.f), c = g;
    if (l0 + t < L) ops.position(grp, l0 + t, g, c);
    s_g[t] = g;
    s_c[t] = c;
  } else if (st >= 0 && st < min(kCauchyChunk, n)) {
    float4 a[kCh];
    ops.state(grp, st, a, s_b[st], s_lam[st]);
#pragma unroll
    for (int c = 0; c < kCh; ++c) s_a[c][st] = a[c];
  }
  float acc[kCauchyPos][kSums] = {};
  for (int n0 = 0; n0 < n; n0 += kCauchyChunk) {
    const int cn = min(kCauchyChunk, n - n0);
    if (n0 > 0) {
      __syncthreads();  // every warp is done with the last chunk
      if (st >= 0 && st < cn) {
        float4 a[kCh];
        ops.state(grp, n0 + st, a, s_b[st], s_lam[st]);
#pragma unroll
        for (int c = 0; c < kCh; ++c) s_a[c][st] = a[c];
      }
    }
    __syncthreads();
    const float2 g0 = s_g[kCauchyPos * q], g1 = s_g[kCauchyPos * q + 1];
#pragma unroll 2
    for (int k = lane; k < cn; k += kCauchyLanes) {
      const float2 lam = s_lam[k];
      const float4 vb = s_b[k];
      float4 va[kCh];
#pragma unroll
      for (int c = 0; c < kCh; ++c) va[c] = s_a[c][k];
#pragma unroll
      for (int pp = 0; pp < kCauchyPos; ++pp) {
        const float2 g = pp == 0 ? g0 : g1;
        float dr = g.x - lam.x, di = g.y - lam.y;
        const float inv = __frcp_rn(fmaf(dr, dr, di * di));
        dr *= inv;
        di *= inv;
#pragma unroll
        for (int c = 0; c < kCh; ++c) cauchy_macs(va[c], dr, di, &acc[pp][4 * c]);
        cauchy_macs(vb, dr, di, &acc[pp][4 * kCh]);
      }
    }
  }
  // the lanes' sums meet: lanes 2i and 2i + 1 swap halves, the even one
  // keeping position 2q's sums, the odd one 2q + 1's; with two rows, lanes
  // s and s ^ 2 then split them, each keeping one row's (k00, k01) and
  // both the shared (k10, k11); the rest add all they hold
  const unsigned full = 0xffffffffu;
  const bool odd = lane & 1;
  float m[kSums];
#pragma unroll
  for (int i = 0; i < kSums; ++i) {
    const float keep = odd ? acc[1][i] : acc[0][i];
    const float give = odd ? acc[0][i] : acc[1][i];
    m[i] = keep + __shfl_xor_sync(full, give, 1);
  }
  // k: this lane's row's (k00, k01) and the shared (k10, k11)
  float k[8];
  int ch = 0;
  if constexpr (kCh == 2) {
    ch = (lane >> 1) & 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float keep = ch ? m[4 + i] : m[i];
      const float give = ch ? m[i] : m[4 + i];
      k[i] = keep + __shfl_xor_sync(full, give, 2);
      k[4 + i] = m[8 + i] + __shfl_xor_sync(full, m[8 + i], 2);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) k[i] = m[i] + __shfl_xor_sync(full, m[i], 2);
  }
#pragma unroll
  for (int off = 4; off < kCauchyLanes; off *= 2)
#pragma unroll
    for (int i = 0; i < 8; ++i) k[i] += __shfl_xor_sync(full, k[i], off);
  const int pos = kCauchyPos * q + (lane & 1);
  if (lane < 2 * kCh && l0 + pos < L) ops.store(grp, ch, l0 + pos, k, s_c[pos]);
}

template <typename Ops>
int launch(const Ops& ops, int groups, int n, int L, void* stream) {
  const int l_tiles = (L + kCauchyTile - 1) / kCauchyTile;
  const long long blocks = static_cast<long long>(groups) * l_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cauchy_kernel<<<static_cast<unsigned>(blocks), kCauchyThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(ops, n, L, l_tiles);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rpde

// vr, vi: (4, rows, n); lr, li: (rows, n); gr, gi: (rows, L); outr, outi:
// (4, rows, L); all f32 row-major. Returns a cudaError_t.
extern "C" int rpde_cauchy(const void* vr, const void* vi, const void* lr, const void* li,
                           const void* gr, const void* gi, void* outr, void* outi, int rows,
                           int n, int L, void* stream) {
  using namespace rpde;
  if (rows < 1 || n < 1 || L < 1) return cudaErrorInvalidValue;
  const CauchyPlanes planes{static_cast<const float*>(vr), static_cast<const float*>(vi),
                            static_cast<const float*>(lr), static_cast<const float*>(li),
                            static_cast<const float*>(gr), static_cast<const float*>(gi),
                            static_cast<float*>(outr),     static_cast<float*>(outi),
                            rows,
                            n,
                            L};
  return launch(planes, rows, n, L, stream);
}

// lam, p, b: (h, n) complex64; c_tilde: (rows, n) complex64 (rows =
// channels x h); log_dt: (h,) f32; out: (rows, L) complex64, the DPLR
// kernel's generating function at the roots of unity. Row r reads lam, p,
// b and log_dt at r mod h; all interleaved row-major. Returns a cudaError_t.
extern "C" int rpde_dplr_at_roots(const void* lam, const void* p, const void* b,
                                  const void* c_tilde, const void* log_dt, void* out, int rows,
                                  int h, int n, int L, void* stream) {
  using namespace rpde;
  if (rows < 1 || h < 1 || rows % h != 0 || n < 1 || L < 1) return cudaErrorInvalidValue;
  const auto* lp = static_cast<const float2*>(lam);
  const auto* pp = static_cast<const float2*>(p);
  const auto* bp = static_cast<const float2*>(b);
  const auto* cp = static_cast<const float2*>(c_tilde);
  const auto* dp = static_cast<const float*>(log_dt);
  auto* op = static_cast<float2*>(out);
  // the channels in pairs where their count is even (a bidirectional
  // layer's two), so that each pair shares the work of its feature
  if ((rows / h) % 2 == 0)
    return launch(DplrFused<2>{lp, pp, bp, cp, dp, op, h, n, L}, rows / 2, n, L, stream);
  return launch(DplrFused<1>{lp, pp, bp, cp, dp, op, h, n, L}, rows, n, L, stream);
}
