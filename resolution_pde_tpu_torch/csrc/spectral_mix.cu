// One FFNO axis pass in f32: truncated forward DFT -> per-mode complex
// channel mix -> zero-padded inverse DFT, fused, forward only.
//
// Replaces the TPU kernel resolution_pde_tpu/ops/pallas/spectral_mix.py
// `_mix_pallas` (the f32-exact pass; entry `truncated_spectral_mix_1d`) and
// its adjoint. Per row of the axis (n points, C channels):
//     z  = x^T (C, n) @ f2 (n, 2m)              spectrum, re | im lanes
//     mk = per mode k: z_k (2C) @ wpk[k] (2C, 2O) complex mix, packed
//     y  = mk (O, 2m) @ i2 (2m, n)              Hermitian-weighted inverse
// with every product an IEEE f32 FMA on the CUDA cores, never TF32; out is
// in x's type (bf16 x and out round once, at the end). The adjoint is the
// same pass with transposed factors and each mode's weight transposed. The
// bf16 pass (spectral_mix2.py `_pass_pallas`) runs on spectral_staged.cu.
//
// Strides: rows are r = r_hi * rows_lo + r_lo, and element (r, t, c) of x
// lies at r_hi * x_hi + r_lo * x_lo + t * x_ax + c. The W-axis pass of a
// channels-last (B, H, W, C) tensor and its H-axis pass both read the tensor
// in place, with no transposed copy. With `accumulate`, the pass adds its
// result (rounded to x's type) into out, rounding the sum to x's type, which
// is the TPU path's `yy + xx` of the two axis passes.
//
// The design (held to 1e-4 of the plain version): the TPU kernel keeps a
// 16-row tile and both factors and the weight in VMEM. The kernel computes
// the two DFTs as dense products, as the TPU kernel does: 21.5 GFLOP at the
// train shape, 80 % of them in the DFTs (with FFTs the function needs 5.6,
// about its bytes' time on an H100), so the design keeps the FMA pipes fed
// from shared memory: a block takes a tile of TR rows whose spectra stay in
// shared memory, (2m padded to 128, 256) f32, 128 KB, one block of 16 warps
// an SM (224 KB at the train shape). TR is 4 up to 64 channels in and out
// (the train shape), 2 up to 128 and 1 up to 256, so that a tile's TR x C8
// channels fill its 256 columns.
//   1. forward DFT, a block product z^T (2m x TR C) = f2^T (2m x n) @ x
//      (n x TR C) on slices of 32 points (f2's rows and the tile's x rows as
//      they lie) staged by cp.async through a ring of two stages, the next
//      slice's copy in flight during this one's products; each thread
//      holds 8 x 8 sums in registers and reads its operands with 16-byte
//      loads (rows and columns in two runs of 4: no bank conflict); the
//      sums go to the spectra mode-major, channel c's TR rows one chunk,
//      chunks XOR-swizzled by channel and mode;
//   2. the mix, a warp per mode with no block barrier: each warp sums its
//      modes over all C channels itself, a lane holding 256 / (32 TR)
//      output channels of both parts for all TR rows, so each weight
//      element serves 2 TR products; the weight's blocks a | b (half the
//      packed [[a, b], [-b, a]]; -b is a sign flip, exact) come from L2
//      into registers, one slice of channels ahead; the mixed spectrum
//      overwrites the mode's own z_k;
//   3. inverse DFT, y (n x TR O) = i2^T (n x 2m) @ mk (2m x TR O), the same
//      block product on slices of 32 packed modes of i2 (mk read in place
//      from the spectra; the first slices copied during the mix), stored
//      16 bytes a lane (acc loaded first).
// The launcher zero-pads each contraction and the factors' other axis to
// whole tiles, so the inner loops carry no bounds checks. Every sum runs in
// an order fixed by the shapes, so two calls give the same bits. A launch
// takes channels up to 256 and m up to 64; the launcher runs wider passes
// as launches over chunks of modes and channels (its chunk plan), the later
// chunks added through `accumulate`.

#include <algorithm>
#include <type_traits>

#include "async_copy.cuh"
#include "common.cuh"

// The dynamic shared memory of the kernel: the tile's spectra, (2m padded
// to 128) x 256 f32, then the kF32Stages stages of its cp.async ring.
extern __shared__ __align__(16) unsigned char k3_smem[];

namespace rpde {
namespace {

using bf16 = __nv_bfloat16;

// the most shared memory a block may take
constexpr int kMaxSmem = 232448;

__host__ __device__ inline int round_up(int v, int to) { return (v + to - 1) / to * to; }

// f32 (CUDA cores): K3, the f32-exact pass, and its adjoint

constexpr int kF32Threads = 512;
constexpr int kF32Warps = kF32Threads / 32;
// the DFT products' block tile: kF32TileM rows (packed modes, or points) by
// kF32Cols columns (row of the tile, channel), threads as 16 rows by
// kF32Tx columns; a thread holds 8 rows (two runs of 4, 64 apart) by
// kF32Quads runs of 4 columns, kF32Run apart, so that its operands are
// 16-byte loads and a warp's loads meet no bank conflict
constexpr int kF32TileM = 128;
constexpr int kF32Cols = 256;
constexpr int kF32Tx = kF32Threads / 16;
constexpr int kF32Run = 4 * kF32Tx;
constexpr int kF32Quads = kF32Cols / kF32Run;
// A tile of TR rows: their spectra stay in shared memory, a spectrum's
// channel is one chunk of TR floats (the tile's rows), and each weight
// element the mix loads serves all of them. The columns hold TR x C8
// channels: 4 rows up to 64 channels (the train shape), 2 up to 128, 1 up
// to 256. A mix lane holds kLaneOut output channels of every row, and a
// slice of the mix's weight stream kMixC input channels, so that the mix's
// registers are the same for every TR.
template <int TR>
struct F32Tile {
  static constexpr int kMaxChannels = kF32Cols / TR;
  static constexpr int kLaneOut = kMaxChannels / 32;
  static constexpr int kMixC = 16 / kLaneOut;
  static_assert(8 % kMixC == 0, "a mix slice lies in one group of the spectra's swizzle");
};
// stages of the DFTs' ring: kF32Stages - 1 slices in flight while the
// threads work on one
constexpr int kF32Stages = 2;
// contraction steps a stage holds: points of the forward DFT, packed modes
// of the inverse
constexpr int kF32K1 = 32;
constexpr int kF32K3 = 32;
// the most channels (padded to 8) a tile of one row holds
constexpr int kF32MaxChannels = F32Tile<1>::kMaxChannels;

struct F32Params {
  int n, m, c, o;
  int c8, o8;        // channels padded to 8
  int sr;            // spectra rows: 2m packed modes padded to kF32TileM
  int n1;            // points padded to kF32K1 (the forward's contraction)
  int n3;            // points padded to kF32TileM (the inverse's rows)
  int stage_floats;  // floats of a ring stage
  int x_async;       // x is copied by cp.async
  int vec_out;       // out takes 4 channels a store
  int accumulate;
  long long rows, rows_lo;
  long long x_hi, x_lo, x_ax;
  long long y_hi, y_lo, y_ax;
};

#ifdef RPDE_K3_PHASES
// Clock cycles of thread 0 of every block in each phase of the f32 kernel,
// summed over blocks (scripts/torch_k2_phases.py builds the kernel with
// RPDE_K3_PHASES; the library never does): 0 waiting for a DFT slice and
// starting the next one's copy, 1 the forward DFT's products, 2 its stores
// into the spectra, 3 the mix (warp 0's, and waiting for the other warps),
// 4 the inverse DFT's products, 5 its stores.
constexpr int kK3Phases = 6;
__device__ unsigned long long k3_phase_cycles[kK3Phases];
struct K3Phases {
  unsigned long long cycles[kK3Phases];
  long long t;
  __device__ void start() {
    for (int i = 0; i < kK3Phases; ++i) cycles[i] = 0;
    t = clock64();
  }
  __device__ void mark(int phase) {
    const long long now = clock64();
    cycles[phase] += static_cast<unsigned long long>(now - t);
    t = now;
  }
  __device__ void flush() {
    if (threadIdx.x == 0)
      for (int i = 0; i < kK3Phases; ++i) atomicAdd(&k3_phase_cycles[i], cycles[i]);
  }
};
#else
struct K3Phases {
  __device__ void start() {}
  __device__ void mark(int) {}
  __device__ void flush() {}
};
#endif

// Row i (0..7) of thread row ty in a block tile: two runs of 4, 64 apart.
__device__ __forceinline__ int f32_row(int ty, int i) { return ty * 4 + (i & 3) + (i >> 2) * 64; }

// The chunk (TR floats, the tile's rows) that holds channel c of
// spectrum row j: XOR-swizzled inside its group of 8 by (c / 8) and (j / 4),
// so that the forward DFT's stores spread over the banks; the mix reads one
// chunk a warp.
__device__ __forceinline__ int spec_chunk(int j, int c) {
  return c ^ (((c >> 3) ^ (j >> 2)) & 7);
}

__device__ __forceinline__ void load4(float (&v)[4], const float* p) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
}

// v = p[0..N - 1] from shared memory, N in {1, 2, 4}, in one load; p
// aligned to it
template <int N>
__device__ __forceinline__ void load_vec(float (&v)[N], const float* p) {
  if constexpr (N == 4) {
    load4(v, p);
  } else if constexpr (N == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    v[0] = u.x, v[1] = u.y;
  } else {
    v[0] = *p;
  }
}

// v = p[0..N - 1] by read-only loads from global memory, N in {2, 4, 8},
// 8 or 16 bytes a load; p aligned to them
template <int N>
__device__ __forceinline__ void ldg_vec(float (&v)[N], const float* __restrict__ p) {
  if constexpr (N == 2) {
    const float2 u = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = u.x, v[1] = u.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(p + i));
      v[i] = u.x, v[i + 1] = u.y, v[i + 2] = u.z, v[i + 3] = u.w;
    }
  }
}

// p[0..N - 1] = v in shared memory, N in {2, 4, 8}, 8 or 16 bytes a store
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[N]) {
  if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

__device__ __forceinline__ float4 load_quad(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load_quad(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store_quad(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store_quad(bf16* p, float4 v) {
  uint2 u;
  *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(v.x, v.y);
  *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = u;
}

using F32Acc = float[8][4 * kF32Quads];

// acc[i][4h + q] += sum over kK steps k of a[k][row i] *
// b[k][h kF32Run + 4tx + q], a's rows kF32TileM floats, b's kF32Cols; k in
// order, so a sum's order is fixed by the shapes.
template <int kK>
__device__ __forceinline__ void tile_fma(F32Acc& acc, const float* a, const float* b) {
  const int tx = threadIdx.x % kF32Tx, ty = threadIdx.x / kF32Tx;
  const float* ap = a + ty * 4;
  const float* bp = b + tx * 4;
#pragma unroll 4
  for (int k = 0; k < kK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(ap + k * kF32TileM);
    const float4 a1 = *reinterpret_cast<const float4*>(ap + k * kF32TileM + 64);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float bv[kF32Quads][4];
#pragma unroll
    for (int h = 0; h < kF32Quads; ++h) load4(bv[h], bp + k * kF32Cols + h * kF32Run);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < kF32Quads; ++h)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][4 * h + q] = fmaf(av[i], bv[h][q], acc[i][4 * h + q]);
  }
}

__device__ __forceinline__ void zero_f32(F32Acc& acc) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * kF32Quads; ++j) acc[i][j] = 0.f;
}

// Starts the copy of forward slice (mt, w0) into stage st: f2's rows w0..
// w0 + kF32K1 - 1, columns mt * kF32TileM.. (kF32K1 x kF32TileM), then the
// tile's x at those points, (kF32K1, kF32Cols) with column t * C8 + c; zeros
// past the tile's rows, past n and in the channels from C.
template <int TR, typename IO>
__device__ __forceinline__ void stage_forward(const F32Params& p, const IO* __restrict__ x,
                                              const float* __restrict__ f2p, float* st, int mt,
                                              int w0, int rows, const long long* xrow) {
  constexpr int kq = kF32TileM / 4;
  for (int i = threadIdx.x; i < kF32K1 * kq; i += kF32Threads) {
    const int kk = i / kq, q = i - kk * kq;
    cp_async_16(st + kk * kF32TileM + q * 4,
                f2p + static_cast<long long>(w0 + kk) * p.sr + mt * kF32TileM + q * 4);
  }
  float* bs = st + kF32K1 * kF32TileM;
  const int cq = p.c8 / 4, per_k = TR * cq;
  for (int i = threadIdx.x; i < kF32K1 * per_k; i += kF32Threads) {
    const int kk = i / per_k, rem = i - kk * per_k;
    const int t = rem / cq, c0 = (rem - t * cq) * 4, w = w0 + kk;
    float* dst = bs + kk * kF32Cols + t * p.c8 + c0;
    const bool in = t < rows && w < p.n && c0 < p.c;
    if constexpr (std::is_same<IO, float>::value) {
      if (p.x_async) {
        if (in)
          cp_async_16(dst, x + xrow[t] + w * p.x_ax + c0);
        else
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
        continue;
      }
    }
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (in) {
      const IO* src = x + xrow[t] + w * p.x_ax + c0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c0 + e < p.c) v[e] = to_f(src[e]);
    }
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Starts the copy of inverse slice (mt, j0) into stage st: i2's rows j0..
// j0 + kF32K3 - 1, columns mt * kF32TileM.. (kF32K3 x kF32TileM).
__device__ __forceinline__ void stage_inverse(const F32Params& p, const float* __restrict__ i2p,
                                              float* st, int mt, int j0) {
  constexpr int kq = kF32TileM / 4;
  for (int i = threadIdx.x; i < kF32K3 * kq; i += kF32Threads) {
    const int kk = i / kq, q = i - kk * kq;
    cp_async_16(st + kk * kF32TileM + q * 4,
                i2p + static_cast<long long>(j0 + kk) * p.n3 + mt * kF32TileM + q * 4);
  }
}

// The forward DFT's sums of block tile mt into the spectra: packed mode j
// (row), column t * C8 + c -> chunk spec_chunk(j, c) of row j, element t.
template <int TR>
__device__ __forceinline__ void store_spectra(const F32Params& p, float* spec, const F32Acc& acc,
                                              int mt) {
  const int tx = threadIdx.x % kF32Tx, ty = threadIdx.x / kF32Tx;
#pragma unroll
  for (int h = 0; h < kF32Quads; ++h) {
    const int n0 = h * kF32Run + tx * 4, t = n0 / p.c8, c0 = n0 - t * p.c8;
    if (t >= TR) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int j = mt * kF32TileM + f32_row(ty, i);
      float* row = spec + j * kF32Cols + t;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        row[spec_chunk(j, c0 + q) * TR] = acc[i][4 * h + q];
    }
  }
}

// The mix, a warp per mode: warp g takes modes g, g + 16, .. and sums each
// over all C8 channels in order by itself, so the mix has no block barrier
// and no sum across warps. Lane l holds output channels kLaneOut l.. of
// both parts for every row of the tile, re += zr a - zi b and
// im += zr b + zi a (the packed [[a, b], [-b, a]]; -b by a sign flip,
// exact); each weight element loaded serves 2 TR products. The weights
// come from L2 into registers (read-only loads, 256 contiguous bytes a warp
// a row at TR = 4), kMixC channels a slice, the next slice's loads issued
// before this slice's products into the other of two register buffers. A
// mode's sums overwrite its own z_k (only this warp reads it): part s of
// row t, channel o at row s * m + k, column t * O8 + o.
template <int TR>
__device__ __forceinline__ void mix_warp(const F32Params& p, float* spec,
                                         const float* __restrict__ wk) {
  constexpr int kE = F32Tile<TR>::kLaneOut, kC = F32Tile<TR>::kMixC;
  const int warp = threadIdx.x / 32, o = kE * (threadIdx.x % 32);
  const bool on = o < p.o8;  // the lane holds channels of the output
  const int per_mode = p.c8 / kC;
  float re[TR][kE] = {}, im[TR][kE] = {};
  // weight rows a and b of channels q * kC.. of mode k
  auto load = [&](int k, int q, float (&w)[2][kC][kE]) {
    if (!on || k >= p.m) return;
    const float* src = wk + (static_cast<long long>(k) * 2 * p.c8 + q * kC) * p.o8 + o;
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int u = 0; u < kC; ++u) ldg_vec(w[s][u], src + (s * p.c8 + u) * p.o8);
  };
  // the products of slice (k, q); channel c = q * kC + u of spectrum row j
  // is chunk c ^ key(j), the slice lying in one group of 8 (spec_chunk)
  auto mix = [&](int k, int q, const float (&w)[2][kC][kE]) {
    const int g = (q * kC) >> 3;
    const int kr = (g ^ (k >> 2)) & 7, ki = (g ^ ((p.m + k) >> 2)) & 7;
    const float* zr_row = spec + k * kF32Cols;
    const float* zi_row = spec + (p.m + k) * kF32Cols;
#pragma unroll
    for (int u = 0; u < kC; ++u) {
      const int c = q * kC + u;
      float zr[TR], zi[TR];
      load_vec(zr, zr_row + (c ^ kr) * TR);
      load_vec(zi, zi_row + (c ^ ki) * TR);
#pragma unroll
      for (int t = 0; t < TR; ++t)
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          re[t][e] = fmaf(zr[t], w[0][u][e], re[t][e]);
          re[t][e] = fmaf(-zi[t], w[1][u][e], re[t][e]);
          im[t][e] = fmaf(zr[t], w[1][u][e], im[t][e]);
          im[t][e] = fmaf(zi[t], w[0][u][e], im[t][e]);
        }
    }
  };
  // after a mode's last slice: its sums over its z_k
  auto finish = [&](int k) {
    __syncwarp();  // every lane has read z_k before any overwrites it
#pragma unroll
    for (int t = 0; t < TR; ++t) {
      if (on) {
        store_vec(spec + k * kF32Cols + t * p.o8 + o, re[t]);
        store_vec(spec + (p.m + k) * kF32Cols + t * p.o8 + o, im[t]);
      }
#pragma unroll
      for (int e = 0; e < kE; ++e) re[t][e] = im[t][e] = 0.f;
    }
  };
  // the slice after (k, q) in the warp's stream
  auto advance = [&](int& k, int& q) {
    if (++q == per_mode) {
      q = 0;
      k += kF32Warps;
    }
  };
  float wa[2][kC][kE] = {}, wb[2][kC][kE] = {};
  int k = warp, q = 0;
  load(k, q, wa);
  while (k < p.m) {
    int kn = k, qn = q;
    advance(kn, qn);
    load(kn, qn, wb);
    mix(k, q, wa);
    if (qn == 0) finish(k);
    k = kn, q = qn;
    if (k >= p.m) break;
    advance(kn, qn);
    load(kn, qn, wa);
    mix(k, q, wb);
    if (qn == 0) finish(k);
    k = kn, q = qn;
  }
}

// The inverse DFT's sums of block tile mt (points) into out: column
// t * O8 + o is channel o of the tile's row t. Each rounded to IO, added to
// out's old value (loaded first) with `accumulate`, the sum rounded to IO;
// four channels a store where vec_out.
template <typename IO>
__device__ __forceinline__ void store_out(const F32Params& p, IO* __restrict__ out,
                                          const long long* yrow, int rows, const F32Acc& acc,
                                          int mt) {
  const int tx = threadIdx.x % kF32Tx, ty = threadIdx.x / kF32Tx;
  const bool add = p.accumulate != 0;
#pragma unroll
  for (int h = 0; h < kF32Quads; ++h) {
    const int n0 = h * kF32Run + tx * 4, t = n0 / p.o8, o = n0 - t * p.o8;
    if (t >= rows || o >= p.o) continue;
    IO* base = out + yrow[t] + o;
    float old[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) old[i][q] = 0.f;
      const int w = mt * kF32TileM + f32_row(ty, i);
      if (!add || w >= p.n) continue;
      const IO* src = base + w * p.y_ax;
      if (p.vec_out) {
        const float4 v = load_quad(src);
        old[i][0] = v.x;
        old[i][1] = v.y;
        old[i][2] = v.z;
        old[i][3] = v.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (o + q < p.o) old[i][q] = to_f(src[q]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int w = mt * kF32TileM + f32_row(ty, i);
      if (w >= p.n) continue;
      IO* dst = base + w * p.y_ax;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = round_to<IO>(acc[i][4 * h + q]);
        if (add) v[q] += old[i][q];
      }
      if (p.vec_out) {
        store_quad(dst, make_float4(v[0], v[1], v[2], v[3]));
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (o + q < p.o) dst[q] = from_f<IO>(v[q]);
      }
    }
  }
}

// One block, one tile of TR rows; the spectra stay in shared
// memory. The DFTs' slices (f2 and the tile's x at kF32K1 points, then i2
// at kF32K3 packed modes) come by cp.async through a ring of kF32Stages
// stages, the next kF32Stages - 1 slices' copies in flight while the
// threads work on one; between the DFTs, the mix (mix_warp).
template <typename IO, int TR>
__global__ void __launch_bounds__(kF32Threads, 1)
spectral_pass_kernel(const IO* __restrict__ x, const float* __restrict__ f2p,
                     const float* __restrict__ i2p, const float* __restrict__ wk,
                     IO* __restrict__ out, F32Params p) {
  __shared__ long long row_x[TR], row_y[TR];
  const long long* xrow = row_x;
  const long long* yrow = row_y;
  K3Phases ph;
  ph.start();
  float* spec = reinterpret_cast<float*>(k3_smem);
  float* stages = spec + p.sr * kF32Cols;
  const long long r0 = static_cast<long long>(blockIdx.x) * TR;
  const int rows = static_cast<int>(min(static_cast<long long>(TR), p.rows - r0));
  if (threadIdx.x < rows) {
    const long long r = r0 + threadIdx.x, hi = r / p.rows_lo, lo = r - hi * p.rows_lo;
    row_x[threadIdx.x] = hi * p.x_hi + lo * p.x_lo;
    row_y[threadIdx.x] = hi * p.y_hi + lo * p.y_lo;
  }
  // the spectra's rows from 2m hold zeros, as do the inverse factor's rows
  // there (no uninitialised value reaches a stored sum)
  float4* pad = reinterpret_cast<float4*>(spec + 2 * p.m * kF32Cols);
  for (int i = threadIdx.x; i < (p.sr - 2 * p.m) * (kF32Cols / 4); i += kF32Threads)
    pad[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const int k1 = p.n1 / kF32K1, m1 = p.sr / kF32TileM, s1 = m1 * k1;
  const int k3 = p.sr / kF32K3, m3 = p.n3 / kF32TileM, s3 = m3 * k3;
  auto stage = [&](int i) { return stages + (i % kF32Stages) * p.stage_floats; };
  // slice i of the forward (of the inverse) into its stage, after
  // land(i - kF32Stages + 1): every thread is done with the slice that was
  // there; one group of cp.async copies, empty past the last slice
  auto start_forward = [&](int i) {
    if (i < s1)
      stage_forward<TR>(p, x, f2p, stage(i), i / k1, (i % k1) * kF32K1, rows, xrow);
    cp_async_commit();
  };
  auto start_inverse = [&](int i) {
    if (i < s3) stage_inverse(p, i2p, stage(i), i / k3, (i % k3) * kF32K3);
    cp_async_commit();
  };
  // waits for slice i (this thread's copies, then everyone's)
  auto land = [&]() {
    cp_async_wait<kF32Stages - 2>();
    __syncthreads();
  };

  for (int i = 0; i < kF32Stages - 1; ++i) start_forward(i);
  F32Acc acc;
  for (int mt = 0, i = 0; mt < m1; ++mt) {
    zero_f32(acc);
    for (int kc = 0; kc < k1; ++kc, ++i) {
      land();
      start_forward(i + kF32Stages - 1);
      ph.mark(0);
      tile_fma<kF32K1>(acc, stage(i), stage(i) + kF32K1 * kF32TileM);
      ph.mark(1);
    }
    store_spectra<TR>(p, spec, acc, mt);
    ph.mark(2);
  }
  // every spectrum is in place, and the stages are free: the inverse's
  // first slices are copied during the mix
  __syncthreads();
  for (int i = 0; i < kF32Stages - 1; ++i) start_inverse(i);
  mix_warp<TR>(p, spec, wk);
  ph.mark(3);
  for (int mt = 0, i = 0; mt < m3; ++mt) {
    zero_f32(acc);
    for (int kc = 0; kc < k3; ++kc, ++i) {
      land();
      start_inverse(i + kF32Stages - 1);
      ph.mark(0);
      tile_fma<kF32K3>(acc, stage(i), spec + kc * kF32K3 * kF32Cols);
      ph.mark(4);
    }
    store_out(p, out, yrow, rows, acc, mt);
    ph.mark(5);
  }
  ph.flush();
}

// Fills the f32 kernel's layout from n, m, c, o, and the shared memory in
// smem; returns the tile's rows (4, 2 or 1, the most whose channels fit its
// columns), or 0 if the shape does not fit: channels above
// kF32MaxChannels, or spectra and ring above the block's shared memory (m
// above 64).
int plan_f32(F32Params& p, size_t& smem) {
  p.c8 = round_up(p.c, 8);
  p.o8 = round_up(p.o, 8);
  const int widest = std::max(p.c8, p.o8);
  if (widest > kF32MaxChannels) return 0;
  p.sr = round_up(2 * p.m, kF32TileM);
  p.n1 = round_up(p.n, kF32K1);
  p.n3 = round_up(p.n, kF32TileM);
  p.stage_floats = std::max(kF32K1 * (kF32TileM + kF32Cols), kF32K3 * kF32TileM);
  smem = (static_cast<size_t>(p.sr) * kF32Cols + kF32Stages * static_cast<size_t>(p.stage_floats)) *
         sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmem)) return 0;
  return widest <= F32Tile<4>::kMaxChannels ? 4 : widest <= F32Tile<2>::kMaxChannels ? 2 : 1;
}

template <typename IO, int TR>
cudaError_t launch_f32_tile(const void* x, const void* f2p, const void* i2p, const void* wk,
                            void* out, const F32Params& p, size_t smem, cudaStream_t stream) {
  auto kernel = spectral_pass_kernel<IO, TR>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = (p.rows + TR - 1) / TR;
  kernel<<<static_cast<unsigned>(blocks), kF32Threads, smem, stream>>>(
      static_cast<const IO*>(x), static_cast<const float*>(f2p), static_cast<const float*>(i2p),
      static_cast<const float*>(wk), static_cast<IO*>(out), p);
  return cudaGetLastError();
}

template <typename IO>
cudaError_t launch_f32(const void* x, const void* f2p, const void* i2p, const void* wk, void* out,
                       F32Params& p, cudaStream_t stream) {
  size_t smem = 0;
  const int tr = plan_f32(p, smem);
  if (tr == 0) return cudaErrorInvalidValue;
  const auto aligned = [](const void* q, uintptr_t to) {
    return (reinterpret_cast<uintptr_t>(q) & (to - 1)) == 0;
  };
  if (!aligned(f2p, 16) || !aligned(i2p, 16) || !aligned(wk, 16)) return cudaErrorMisalignedAddress;
  p.x_async = std::is_same<IO, float>::value && p.c % 4 == 0 &&
              p.x_ax % 4 == 0 && p.x_hi % 4 == 0 && p.x_lo % 4 == 0 && aligned(x, 16);
  p.vec_out = p.o % 4 == 0 && p.y_ax % 4 == 0 && p.y_hi % 4 == 0 && p.y_lo % 4 == 0 &&
              aligned(out, 4 * sizeof(IO));
  if (tr == 4) return launch_f32_tile<IO, 4>(x, f2p, i2p, wk, out, p, smem, stream);
  if (tr == 2) return launch_f32_tile<IO, 2>(x, f2p, i2p, wk, out, p, smem, stream);
  return launch_f32_tile<IO, 1>(x, f2p, i2p, wk, out, p, smem, stream);
}

}  // namespace
}  // namespace rpde

// x: rows of an axis of length n with c channels (strides above), io type;
// out: rows of o channels (strides above), io type. f2 (n, 2m) zero-padded
// to (n rounded up to 32, 2m rounded up to 128), i2 (2m, n) zero-padded to
// (2m rounded up to 128, n rounded up to 128), both f32 row-major; wpk is,
// per mode, the blocks a | b of the packed weight [[a, b], [-b, a]] as (2,
// c8, o8) f32, zeros in the padding (the kernel makes -b); all three
// 16-byte aligned. Returns a cudaError_t.
extern "C" int rpde_spectral_pass(int io_bf16, const void* x, const void* f2, const void* i2,
                                  const void* wpk, void* out, int n, int m, int c, int o,
                                  long long rows, long long rows_lo, long long x_hi,
                                  long long x_lo, long long x_ax, long long y_hi,
                                  long long y_lo, long long y_ax, int accumulate,
                                  void* stream) {
  using namespace rpde;
  if (n < 1 || m < 1 || c < 1 || o < 1 || rows < 1 || rows_lo < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  F32Params p{};
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
  if (io_bf16) return launch_f32<__nv_bfloat16>(x, f2, i2, wpk, out, p, s);
  return launch_f32<float>(x, f2, i2, wpk, out, p, s);
}

#ifdef RPDE_K3_PHASES
// The phase counters of the f32 kernel: copied to out (kK3Phases values),
// or zeroed when reset is set. Returns a cudaError_t.
extern "C" int rpde_k3_phase_cycles(unsigned long long* out, int reset) {
  unsigned long long zero[rpde::kK3Phases] = {};
  if (reset) return cudaMemcpyToSymbol(rpde::k3_phase_cycles, zero, sizeof(zero));
  return cudaMemcpyFromSymbol(out, rpde::k3_phase_cycles, sizeof(zero));
}
#endif
