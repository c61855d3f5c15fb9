// One FFNO axis pass: truncated forward DFT -> per-mode complex channel mix
// -> zero-padded inverse DFT, fused, forward only.
//
// Replaces two TPU kernels: resolution_pde_tpu/ops/pallas/spectral_mix2.py
// `_pass_pallas` (packed re/im, bf16 or f32; entry `packed_spectral_mix_1d`)
// and, as this file's f32 kernel, ops/pallas/spectral_mix.py `_mix_pallas`
// (the f32-exact pass; entry `truncated_spectral_mix_1d`). Per row of the
// axis (n points, C channels):
//     z  = x^T (C, n) @ f2 (n, 2m)              spectrum, re | im lanes
//     mk = per mode k: z_k (2C) @ wpk[k] (2C, 2O) complex mix, packed
//     y  = mk (O, 2m) @ i2 (2m, n)              Hermitian-weighted inverse
// with every product in the compute type (bf16 or f32, never TF32)
// accumulated in f32, and each intermediate rounded to the compute type, as
// the TPU kernel does; out is in x's type. The adjoint is the same pass with
// transposed factors and each mode's weight transposed.
//
// Strides: rows are r = r_hi * rows_lo + r_lo, and element (r, t, c) of x
// lies at r_hi * x_hi + r_lo * x_lo + t * x_ax + c. The W-axis pass of a
// channels-last (B, H, W, C) tensor and its H-axis pass both read the tensor
// in place, with no transposed copy. With `accumulate`, the pass adds its
// result (rounded to x's type) into out, rounding the sum to x's type, which
// is the TPU path's `yy + xx` of the two axis passes.
//
// bf16 compute (every pass of the bf16 train step and predict): the three
// products run on the tensor cores (mma.cuh, mma.sync.m16n8k16). The TPU
// kernel takes 256-row tiles and the whole packed weight (2 MB at m = 64,
// C = O = 64) into VMEM; a block's 227 KB holds neither, so every block
// reads all of the weight from L2. The pass's bound is its bytes (x and
// out, 0.04 ms on an H100 at the train shape); what holds the kernel is
// the latency of its products, with the 2 warps a scheduler that one
// block of 8 warps an SM leaves, and the weight's L2 traffic, which the
// design hides behind them. A block takes a tile of 8 rows, and the mix is
// written transposed, mixed_k^T (2O x 8) = wpk_k^T (2O x 2C) @ z_k^T
// (2C x 8): the tile's 8 rows are exactly one n8 fragment, and each mode's
// weight is read from L2 once for 8 rows. And the packed weight is
// [[a, b], [-b, a]] (the complex product; the launcher's entry points take
// only the blocks a | b), so only its first block row [a | b] is streamed,
// 16 KB a mode, half the packed bytes; the mix flips the sign bits of the
// A fragments that come from -b (exact).
// One stream of slices runs through a ring of two shared-memory stages,
// one slice ahead (async_copy.cuh): the tile's 8 x rows (n, C), as they
// lie in memory, by 16-byte cp.async copies, then the weight modes, two a
// slice, each slice one bulk copy (TMA) that completes on the stage's
// mbarrier; the copy of the next slice is in flight while the warps
// multiply on this one. A mode is only 8 products a warp, so a slice of two
// halves the barriers and gives each warp two chains of products.
//   1. forward DFT, a row at a time: z^T (2m x C) = f2^T (2m x n) @ x_t
//      (n x C), x read from its stage with ldmatrix.trans, a warp's f2^T
//      fragments held in registers across the tile's rows;
//   2. the mix, a slice of two modes at a time, over the tile's spectra,
//      which stay in shared memory mode-major, (m, 8 rows, 2 max(C, O));
//      each mode's result overwrites its own z_k one slice later, once
//      every warp has read z_k;
//   3. inverse DFT: y_t (n x O) = i2^T (n x 2m) @ mk_t (2m x O), a warp
//      holding its 16 points' A fragments across the tile's 8 rows, its
//      results rounded into a buffer of its own in the free stages and
//      stored (added) 16 bytes a lane, whole lines a warp.
// The DFT factors come from L2 as A fragments, packed once by the launcher
// in fragment order (16 bytes a lane, 512 contiguous bytes a warp). Each
// contraction is zero-padded (to 64 in the factors, to 16 in the weight)
// and each channel count to 8, so every n, m, C and O that fit work; k-steps
// run in branch-free groups of four. The spectra's rows are 128-byte
// multiples whose 16-byte chunks are XOR-swizzled by (mode + row) mod 8,
// so the mix's reads of 8 rows of one mode and the inverse's reads of 8
// modes of one row hit 8 different banks; stage rows are swizzled by their
// index (padded where they are too narrow), so that ldmatrix meets no bank
// conflict and a stage holds an x row in 32 KB. At the train shape a block
// takes 192 KB (one block an SM, 256 blocks).
//
// f32 compute (the f32-exact mode K3 and its adjoint, held to 1e-4 of the
// plain version): every product is an IEEE f32 FMA on the CUDA cores, never
// TF32. The TPU kernel keeps a 16-row tile and both factors and the weight
// in VMEM. The kernel computes the two DFTs as dense products, as the TPU
// kernel does: 21.5 GFLOP at the train shape, 80 % of them in the DFTs
// (with FFTs the function needs 5.6, about its bytes' time on an H100), so
// the design keeps the FMA pipes fed from shared memory: a block takes a
// tile of TR rows whose spectra stay in shared memory, (2m padded to 128,
// 256) f32, 128 KB, one block of 16 warps an SM (224 KB at the train
// shape). TR is 4 up to 64 channels in and out (the train shape), 2 up to
// 128 and 1 up to 256, so that a tile's TR x C8 channels fill its 256
// columns.
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
// an order fixed by the shapes, so two calls give the same bits. Channels
// up to 256 and m up to 64 fit; a shape that does not fit is refused.
//
// The wide shapes of the bf16 pass: the tensor-core kernel needs two ring
// stages of two weight modes each beside the tile's spectra, and at most
// 128 output channels, which at n = 256 and m = 64 stops at C = O = 104
// (rpde_spectral_mma_fits; FFNO2D at width 128 needs more). Where it does
// not fit, the bf16 pass runs on the f32 kernel above with the bf16 mode's
// rounding points (kBf16: x, the spectra and the mixed spectra rounded to
// bf16; the factors and the weight rounded by the launcher), whose limits
// it then has. The route is picked from the shape alone.

#include <algorithm>
#include <type_traits>

#include "async_copy.cuh"
#include "common.cuh"
#include "mma.cuh"

// The dynamic shared memory of the bf16 kernel: the tile's spectra, then
// the ring's stages. Functions inlined into the kernel address it from this
// symbol, so that no pointer to it stays in a register.
extern __shared__ __align__(16) unsigned char k2_smem[];
// The dynamic shared memory of the f32 kernel: the tile's spectra, (2m
// padded to 128) x 256 f32, then the kF32Stages stages of its cp.async ring.
extern __shared__ __align__(16) unsigned char k3_smem[];

namespace rpde {
namespace {

// bf16 (tensor cores)

using bf16 = __nv_bfloat16;

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
// rows of a tile: one n8 fragment of the mix
constexpr int kTileRows = 8;
// stages of the ring (x rows, then weight slices): one slice in flight
// while the warps work on another
constexpr int kStages = 2;
// n-tiles of sums a warp keeps in the DFTs: 64 channels
constexpr int kNChunk = 8;
// the DFTs' k-steps run in groups of 4 with no branch inside a group (the
// launcher pads each factor's contraction to whole groups with zeros)
constexpr int kGroup = 4;
// k-steps of a factor's A fragments a warp holds in registers: a
// contraction up to 256 (points n, or 2m packed modes) is loaded once and
// kept for every row of the tile
constexpr int kHeldK = 16;
// mix: m-tiles of sums a warp keeps (2 O8 up to 16 x 8 x 2 = 256)
constexpr int kMixTiles = 2;
// weight modes a slice of the stream holds (at C = O = 64, 32 KB, as an x
// row): the mix of a slice has two chains of products and one barrier
constexpr int kSliceModes = 2;
// the most shared memory a block may take
constexpr int kMaxSmem = 232448;

struct MmaParams {
  int n, m, c, o;
  int c8, o8;          // channels padded to 8
  int kt1, mt1;        // forward DFT: k-steps (points / 16), m-tiles (2m / 16)
  int kt3, mt3;        // inverse DFT: k-steps (2m / 16), m-tiles (points / 16)
  int kt_mix, mt_mix;  // mix: 2 C8 / 16 and 2 O8 / 16
  int tile_rows;
  int spec_ld;         // elements of one row's spectrum of one mode, a multiple of 64
  int spec_elems;      // elements of the spectra
  int x_ld, w_ld;      // row strides of an x row and a weight mode in a stage
  int x_swz, w_swz;    // 7 where those rows are XOR-swizzled, else 0
  int stage_elems;
  int bar_off;         // byte offset of the stages' mbarriers
  int x_async;         // x rows are copied by cp.async
  int pair_out;        // out takes two neighbouring channels a store
  int vec_out;         // out goes through shared memory, 16 bytes a store
  int out_swz;         // 7 where store_out_vec's rows are swizzled, else 0
  int accumulate;
  long long rows, rows_lo;
  long long x_hi, x_lo, x_ax;
  long long y_hi, y_lo, y_ax;
};

#ifdef RPDE_K2_PHASES
// Clock cycles of thread 0 of every block in each phase of the bf16 kernel,
// summed over blocks (scripts/torch_k2_phases.py builds the kernel with
// RPDE_K2_PHASES; the library never does): 0 staging x (waiting for an x
// row and starting the next copy), 1 the forward DFT, 2 waiting for a
// weight slice, 3 starting the next slice's copy, 4 the mix (the previous
// slice's stores and the products), 5 the inverse DFT's products, 6 its
// stores.
constexpr int kPhases = 7;
__device__ unsigned long long k2_phase_cycles[kPhases];
struct Phases {
  unsigned long long cycles[kPhases];
  long long t;
  __device__ void start() {
    for (int i = 0; i < kPhases; ++i) cycles[i] = 0;
    t = clock64();
  }
  __device__ void mark(int phase) {
    const long long now = clock64();
    cycles[phase] += static_cast<unsigned long long>(now - t);
    t = now;
  }
  __device__ void flush() {
    if (threadIdx.x == 0)
      for (int i = 0; i < kPhases; ++i) atomicAdd(&k2_phase_cycles[i], cycles[i]);
  }
};
#else
struct Phases {
  __device__ void start() {}
  __device__ void mark(int) {}
  __device__ void flush() {}
};
#endif

__device__ __forceinline__ bf16* spec_buf() { return reinterpret_cast<bf16*>(k2_smem); }

__device__ __forceinline__ bf16* stage_buf(const MmaParams& p, int s) {
  return spec_buf() + p.spec_elems + s * p.stage_elems;
}

// Offset of element e of row t's spectrum of mode k: slot k * tile_rows + t,
// its 16-byte chunks XOR-swizzled by (k + t) mod 8.
__device__ __forceinline__ int spec_at(const MmaParams& p, int k, int t, int e) {
  return (k * p.tile_rows + t) * p.spec_ld + (((e >> 3) ^ ((k + t) & 7)) << 3) + (e & 7);
}

// Offset of element (r, e) of a stage holding rows of ld elements: the
// 16-byte chunks XOR-swizzled by r mod 8 where swz is 7 (rows of a multiple
// of 64 elements), plain where it is 0 (rows padded instead), so that the 8
// rows an ldmatrix reads fall in 8 different bank groups either way.
__device__ __forceinline__ int stage_at(int r, int e, int ld, int swz) {
  return r * ld + (((e >> 3) ^ (r & swz)) << 3) + (e & 7);
}

// Stages x row t of the tile, (n, C) into (n, x_ld): by cp.async where
// x_async, else converted through registers with zeros in the channels up
// to C8; a row past the last holds zeros.
template <typename IO>
__device__ __forceinline__ void stage_x_row(const MmaParams& p, const IO* __restrict__ x, bf16* st,
                                            long long r0, int rows, int t) {
  const int n = p.n, C = p.c, c8 = p.c8, ld = p.x_ld;
  if (t >= rows) {
    for (int i = threadIdx.x; i < n * c8; i += blockDim.x) {
      const int w = i / c8;
      st[w * ld + i - w * c8] = __float2bfloat16_rn(0.f);
    }
    return;
  }
  const long long r = r0 + t;
  const long long hi = r / p.rows_lo;
  const IO* src = x + hi * p.x_hi + (r - hi * p.rows_lo) * p.x_lo;
  const long long ax = p.x_ax;
  if constexpr (std::is_same<IO, bf16>::value) {
    if (p.x_async) {
      const int cq = C / 8;  // 16-byte pieces of a point
      if (blockDim.x % cq == 0) {
        const int q = threadIdx.x % cq, step = blockDim.x / cq;
        for (int w = threadIdx.x / cq; w < n; w += step)
          cp_async_16(st + stage_at(w, q * 8, ld, p.x_swz), src + w * ax + q * 8);
      } else {
        for (int i = threadIdx.x; i < n * cq; i += blockDim.x) {
          const int w = i / cq, q = i - w * cq;
          cp_async_16(st + stage_at(w, q * 8, ld, p.x_swz), src + w * ax + q * 8);
        }
      }
      return;
    }
  }
#pragma unroll 4
  for (int i = threadIdx.x; i < n * c8; i += blockDim.x) {
    const int w = i / c8, c = i - w * c8;
    st[stage_at(w, c, ld, p.x_swz)] = __float2bfloat16_rn(c < C ? to_f(src[w * ax + c]) : 0.f);
  }
}

__device__ __forceinline__ uint64_t* stage_bar(const MmaParams& p, int s) {
  return reinterpret_cast<uint64_t*>(k2_smem + p.bar_off) + s;
}

// Starts the copy of weight modes k0.. (kSliceModes, or to m), each its
// blocks a and b as (2 C8, O8) rows already in the stage's order (the
// launcher swizzles them), into stage s: one bulk copy, issued by thread 0,
// completing on the stage's mbarrier.
__device__ __forceinline__ void copy_weight_modes(const MmaParams& p,
                                                  const bf16* __restrict__ wk, int s, int k0) {
  if (threadIdx.x != 0) return;
  const uint32_t bytes = min(kSliceModes, p.m - k0) * 2u * p.c8 * p.o8 * sizeof(bf16);
  fence_proxy_async();
  mbarrier_arrive_expect_tx(stage_bar(p, s), bytes);
  bulk_copy_to_shared(stage_buf(p, s), wk + static_cast<long long>(k0) * 2 * p.c8 * p.o8, bytes,
                      stage_bar(p, s));
}

// Starts slice i of the stream into its stage: x rows 0..tile_rows - 1, then
// the weight modes, kSliceModes a slice; commits one group of cp.async
// copies, empty for a weight slice and past the last slice.
template <typename IO>
__device__ __forceinline__ void start_slice(const MmaParams& p, const IO* __restrict__ x,
                                            const bf16* __restrict__ wk, long long r0, int rows,
                                            int i) {
  const int tr = p.tile_rows;
  if (i < tr)
    stage_x_row(p, x, stage_buf(p, i % kStages), r0, rows, i);
  else if ((i - tr) * kSliceModes < p.m)
    copy_weight_modes(p, wk, i % kStages, (i - tr) * kSliceModes);
  cp_async_commit();
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
}

// One k-step of a warp tile's n-tiles (all kNChunk, or the first nt_n when
// !kFull): every B fragment of the step is loaded first, two n-tiles an
// ldmatrix.x4.trans from the rows whose lane address b_addr(j) gives
// (lanes 16..31 the second n-tile's), then the products.
template <bool kFull, typename BAddr>
__device__ __forceinline__ void mma_step(float (&acc)[kNChunk][4], const uint32_t (&a)[4],
                                         int nt_n, BAddr b_addr) {
  uint32_t b[kNChunk / 2][4];
#pragma unroll
  for (int j = 0; j < kNChunk; j += 2) {
    if (kFull || j + 1 < nt_n)
      ldsm_x4_trans(b[j / 2], b_addr(j));
    else if (j < nt_n)
      ldsm_x2_trans(*reinterpret_cast<uint32_t(*)[2]>(&b[j / 2][0]), b_addr(j));
  }
#pragma unroll
  for (int j = 0; j < kNChunk; ++j) {
    if (!kFull && j >= nt_n) break;
    const uint32_t bj[2] = {b[j / 2][2 * (j % 2)], b[j / 2][2 * (j % 2) + 1]};
    mma_bf16_16816(acc[j], a, bj);
  }
}

// acc = the sums of one warp tile over the whole contraction: m-tile rows
// of A, packed in fragment order at `at` (kt_n k-steps, a multiple of
// kGroup), times the B fragments b_addr(kt, j) gives. a holds A's
// fragments: loaded here unless `held`, then kept (held = keep) when the
// caller knows that the contraction fits them and its next tile has the
// same rows.
template <bool kFull, typename BAddr>
__device__ __forceinline__ void warp_tile(float (&acc)[kNChunk][4], uint32_t (&a)[kHeldK][4],
                                          bool& held, bool keep, const uint4* __restrict__ at,
                                          int kt_n, int nt_n, BAddr b_addr) {
  zero_acc(acc);
  for (int k0 = 0; k0 < kt_n; k0 += kHeldK) {
    if (!held) {
#pragma unroll
      for (int s = 0; s < kHeldK; ++s)
        if (k0 + s < kt_n) frag_a_packed(a[s], at, k0 + s);
      held = keep;
    }
#pragma unroll
    for (int s0 = 0; s0 < kHeldK; s0 += kGroup) {
      if (k0 + s0 >= kt_n) break;
#pragma unroll
      for (int s = s0; s < s0 + kGroup; ++s)
        mma_step<kFull>(acc, a[s], nt_n, [&](int j) { return b_addr(k0 + s, j); });
    }
  }
}

// Forward DFT of row t, x in stage st: z^T (2m x C8) = f2^T @ x_t, each
// warp m-tiles of 16 packed modes j = s * m + k, their sums rounded to bf16
// into row t's spectrum of mode k at s * C8 + c. With one m-tile a warp,
// one chunk of channels and n up to 256, a warp's f2^T fragments are
// loaded for the tile's first row and held for the others (a, held).
template <bool kFull>
__device__ __forceinline__ void forward_dft(const MmaParams& p, const uint4* __restrict__ a1,
                                            const bf16* st, int t, uint32_t (&a)[kHeldK][4],
                                            bool& held) {
  const int lane = threadIdx.x % 32;
  const int ld = p.x_ld, c8 = p.c8, m = p.m;
  const bool keep = p.mt1 <= kMmaWarps && c8 <= 8 * kNChunk && p.kt1 <= kHeldK;
  bf16* spec = spec_buf();
  for (int mt = threadIdx.x / 32; mt < p.mt1; mt += kMmaWarps) {
    const uint4* at = a1 + static_cast<long long>(mt) * p.kt1 * 32;
    for (int nc = 0; nc < c8; nc += 8 * kNChunk) {
      const int nt_n = min(kNChunk, (c8 - nc) / 8);
      float acc[kNChunk][4];
      // the lane's x row in a k-step, and its first chunk (k-steps move by
      // 16 rows, which keeps the row's swizzle)
      const int w0 = (lane % 8) + ((lane / 8) % 2) * 8;
      const bf16* base = st + w0 * ld;
      const int q0 = nc / 8 + lane / 16, key = w0 & p.x_swz;
      warp_tile<kFull>(acc, a, held, keep, at, p.kt1, nt_n, [base, ld, q0, key](int kt, int j) {
        return base + kt * 16 * ld + (((q0 + j) ^ key) << 3);
      });
      const int g = lane / 4, tq = lane % 4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = mt * 16 + g + 8 * h;
        if (j >= 2 * m) continue;
        const int s = j >= m, k = j - s * m;
#pragma unroll
        for (int jn = 0; jn < kNChunk; ++jn) {
          if (!kFull && jn >= nt_n) break;
          const int c = nc + jn * 8 + 2 * tq;
          *reinterpret_cast<__nv_bfloat162*>(spec + spec_at(p, k, t, s * c8 + c)) =
              __floats2bfloat162_rn(acc[jn][2 * h], acc[jn][2 * h + 1]);
        }
      }
    }
  }
}

// The mix of a slice's modes k0 and k0 + 1 (where it is below m), their
// weights one after the other in stage st: mixed_k^T (2 O8 x 8) = wpk_k^T @
// z_k^T, each warp m-tiles warp, warp + 8 of 16 packed channels t * O8 + o,
// the two modes' products in two independent chains. The packed weight is
// [[a, b], [-b, a]] (rows (s, c), columns (t, o)) and the stage holds a and
// b: an A fragment's four 8 x 8 matrices each come from a or b, and the one
// of -b has its sign bits flipped (exact). Rows of the n8 fragment past the
// tile read row 0 and are never stored.
__device__ __forceinline__ void mix_modes(const MmaParams& p, const bf16* st, int k0,
                                          float (&acc)[kSliceModes][kMixTiles][4]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int t = (lane % 8) % p.tile_rows;
  const int c8 = p.c8, o8 = p.o8, nk = min(kSliceModes, p.m - k0);
  const int mode_elems = 2 * c8 * o8;
  // the lane's row address of its matrix: output row +8 for lanes 8..15 and
  // 24..31, input row +8 for lanes 16..31
  const int dm = ((lane / 8) % 2) * 8, dk = (lane / 16) * 8 + lane % 8;
  // the lane's spectrum row of each mode, and its swizzle
  const bf16* spec = spec_buf();
  int slot[kSliceModes], key[kSliceModes];
#pragma unroll
  for (int h = 0; h < kSliceModes; ++h) {
    slot[h] = ((k0 + h) * p.tile_rows + t) * p.spec_ld;
    key[h] = (k0 + h + t) & 7;
  }
#pragma unroll
  for (int i = 0; i < kMixTiles; ++i) {
#pragma unroll
    for (int h = 0; h < kSliceModes; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[h][i][c] = 0.f;
    const int mt = warp + i * kMmaWarps;
    if (mt >= p.mt_mix) continue;
    const int mo = mt * 16 + dm;  // the lane's output (t, o)
    const int tp = mo >= o8, o = mo - tp * o8;
    // output part of the fragment's rows 0..7 and 8..15
    const bool t0 = mt * 16 >= o8, t1 = mt * 16 + 8 >= o8;
#pragma unroll 4
    for (int kt = 0; kt < p.kt_mix; ++kt) {
      // A[(t, o)][(s, c)] = the stage's (a if t == s else b)[c][o], read
      // transposed; negated where t = 0 and s = 1
      const int q = kt * 16 + dk;
      const int sp = q >= c8, c = q - sp * c8;
      const int a_off = stage_at((tp == sp ? 0 : c8) + c, o, o8, p.w_swz);
      const bool s0 = kt * 16 >= c8, s1 = kt * 16 + 8 >= c8;
      const uint32_t neg[4] = {!t0 && s0 ? 0x80008000u : 0u, !t1 && s0 ? 0x80008000u : 0u,
                               !t0 && s1 ? 0x80008000u : 0u, !t1 && s1 ? 0x80008000u : 0u};
      const int chunk = 2 * kt + (lane / 8) % 2;  // the lane's B chunk
#pragma unroll
      for (int h = 0; h < kSliceModes; ++h) {
        if (h >= nk) break;
        uint32_t a[4], b[2];
        ldsm_x4_trans(a, st + h * mode_elems + a_off);
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] ^= neg[r];
        ldsm_x2(b, spec + slot[h] + ((chunk ^ key[h]) << 3));
        mma_bf16_16816(acc[h][i], a, b);
      }
    }
  }
}

// mix_modes at C8 = O8 = 64 (every FFNO width of the repo): one m-tile a
// warp, each m-tile and k-step inside one block of the packed weight, the
// 8 k-steps unrolled, the B fragments of both modes loaded first, and each
// mode's products in two chains (even and odd k-steps), so that four
// chains of products a warp are in flight: a mode is only 8 products a
// warp, and their latency, not their rate, is what a slice waits for.
__device__ __forceinline__ void mix_modes_full(const MmaParams& p, const bf16* st, int k0,
                                               float (&acc)[kSliceModes][kMixTiles][4]) {
  constexpr int kKt = 8, kW = 64, kModeElems = 2 * kW * kW;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int t = (lane % 8) % p.tile_rows;
  const int nk = min(kSliceModes, p.m - k0);
  const bf16* spec = spec_buf();
  uint32_t b[kSliceModes][kKt][2];
#pragma unroll
  for (int h = 0; h < kSliceModes; ++h) {
    const int slot = ((k0 + h) * p.tile_rows + t) * p.spec_ld, key = (k0 + h + t) & 7;
#pragma unroll
    for (int kt = 0; kt < kKt; ++kt)
      if (h < nk) ldsm_x2(b[h][kt], spec + slot + (((2 * kt + (lane / 8) % 2) ^ key) << 3));
  }
  // the warp's m-tile: output part tp, channels (warp % 4) * 16..; the
  // lane's A row: input row dk of a 16-row step (its swizzle key dk mod 8),
  // output chunk ochunk
  const int tp = warp >= 4;
  const int dk = (lane / 16) * 8 + lane % 8;
  const int ochunk = ((warp % 4) * 16 + ((lane / 8) % 2) * 8) / 8;
  const bf16* a_lane = st + dk * kW + ((ochunk ^ (dk & 7)) << 3);
  float odd[kSliceModes][4];
#pragma unroll
  for (int h = 0; h < kSliceModes; ++h)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[h][0][c] = odd[h][c] = 0.f;
#pragma unroll
  for (int kt = 0; kt < kKt; ++kt) {
    const int sp = kt >= kKt / 2;  // the input part of the k-step
    const bf16* arow = a_lane + ((tp == sp ? 0 : kW) + (kt % 4) * 16) * kW;
    const uint32_t neg = !tp && sp ? 0x80008000u : 0u;
#pragma unroll
    for (int h = 0; h < kSliceModes; ++h) {
      if (h >= nk) break;
      uint32_t a[4];
      ldsm_x4_trans(a, arow + h * kModeElems);
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] ^= neg;
      if (kt % 2)
        mma_bf16_16816(odd[h], a, b[h][kt]);
      else
        mma_bf16_16816(acc[h][0], a, b[h][kt]);
    }
  }
#pragma unroll
  for (int h = 0; h < kSliceModes; ++h)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[h][0][c] += odd[h][c];
}

// Rounds the mixed sums of a slice's modes k0, k0 + 1 (below m) to bf16
// over their spectra (their z is dead by now).
__device__ __forceinline__ void store_mixed(const MmaParams& p, int k0,
                                            const float (&acc)[kSliceModes][kMixTiles][4]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tq = lane % 4;
  bf16* spec = spec_buf();
#pragma unroll
  for (int h = 0; h < kSliceModes; ++h) {
    if (k0 + h >= p.m) break;
#pragma unroll
    for (int i = 0; i < kMixTiles; ++i) {
      const int mt = warp + i * kMmaWarps;
      if (mt >= p.mt_mix) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int t = 2 * tq + c % 2;
        if (t < p.tile_rows)
          spec[spec_at(p, k0 + h, t, mt * 16 + g + (c / 2) * 8)] =
              __float2bfloat16_rn(acc[h][i][c]);
      }
    }
  }
}

template <typename IO>
__device__ __forceinline__ void store_pair(IO* p, float a, float b);
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store_pair<bf16>(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Stores the inverse DFT's sums of row r, points mt * 16.., channels nc..:
// each rounded to IO, added to out's old value (loaded first, all of a
// warp's together) with `accumulate`, the sum rounded to IO.
template <bool kFull, typename IO>
__device__ __forceinline__ void store_out(const MmaParams& p, IO* __restrict__ out, long long r,
                                          int mt, int nc, int nt_n,
                                          const float (&acc)[kNChunk][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const long long hi = r / p.rows_lo;
  IO* row = out + hi * p.y_hi + (r - hi * p.rows_lo) * p.y_lo;
  const bool add = p.accumulate != 0;
  const long long ax = p.y_ax;
  if (p.pair_out) {
    float2 old[kNChunk][2];
#pragma unroll
    for (int j = 0; j < kNChunk; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int w = mt * 16 + g + 8 * h, o = nc + j * 8 + 2 * tq;
        old[j][h] = add && (kFull || j < nt_n) && w < p.n && o < p.o
                        ? load_pair(row + w * ax + o)
                        : make_float2(0.f, 0.f);
      }
#pragma unroll
    for (int j = 0; j < kNChunk; ++j) {
      if (!kFull && j >= nt_n) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int w = mt * 16 + g + 8 * h, o = nc + j * 8 + 2 * tq;
        if (w < p.n && o < p.o)
          store_pair(row + w * ax + o, round_to<IO>(acc[j][2 * h]) + old[j][h].x,
                     round_to<IO>(acc[j][2 * h + 1]) + old[j][h].y);
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kNChunk; ++j) {
    if (!kFull && j >= nt_n) break;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int w = mt * 16 + g + (c / 2) * 8, o = nc + j * 8 + 2 * tq + c % 2;
      if (w >= p.n || o >= p.o) continue;
      IO* dst = row + w * ax + o;
      float v = round_to<IO>(acc[j][c]);
      if (add) v += to_f(*dst);
      *dst = from_f<IO>(v);
    }
  }
}

template <typename IO>
__device__ __forceinline__ uint4 add_chunk(uint4 a, uint4 b);
template <>
__device__ __forceinline__ uint4 add_chunk<bf16>(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  uint4 r;
  __nv_bfloat162* z = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 u = __bfloat1622float2(x[q]), v = __bfloat1622float2(y[q]);
    z[q] = __floats2bfloat162_rn(u.x + v.x, u.y + v.y);
  }
  return r;
}
template <>
__device__ __forceinline__ uint4 add_chunk<float>(uint4 a, uint4 b) {
  const float4 x = *reinterpret_cast<const float4*>(&a), y = *reinterpret_cast<const float4*>(&b);
  const float4 z = make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
  return *reinterpret_cast<const uint4*>(&z);
}

// store_out for outputs of at most 128 bytes a point in whole 16-byte
// chunks (vec_out): the sums, rounded to IO, go to the warp's own 16 rows
// of O8 in shared memory (the ring's stages, free by now; chunks swizzled
// by row where a row is 128 bytes), then each point's O channels go out 16
// bytes a lane, a warp's stores covering whole lines, added to out's old
// values (all loaded first) with `accumulate`.
template <typename IO>
__device__ __forceinline__ void store_out_vec(const MmaParams& p, IO* __restrict__ out,
                                              long long r, int mt,
                                              const float (&acc)[kNChunk][4]) {
  constexpr int kPer = 16 / sizeof(IO);  // elements of a chunk
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int o8 = p.o8, swz = p.out_swz;
  IO* wb = reinterpret_cast<IO*>(stage_buf(p, 0)) + (threadIdx.x / 32) * 16 * o8;
#pragma unroll
  for (int j = 0; j < kNChunk; ++j) {
    if (8 * j >= o8) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = g + 8 * h, e = j * 8 + 2 * tq;
      store_pair(wb + rr * o8 + (((e / kPer) ^ (rr & swz)) * kPer) + e % kPer, acc[j][2 * h],
                 acc[j][2 * h + 1]);
    }
  }
  __syncwarp();
  const int cpr = p.o / kPer;  // chunks of a point
  const long long hi = r / p.rows_lo;
  IO* row = out + hi * p.y_hi + (r - hi * p.rows_lo) * p.y_lo;
  const bool add = p.accumulate != 0;
  uint4 v[4], old[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = lane + 32 * u, rr = i / cpr, c = i - rr * cpr;
    if (rr < 16 && mt * 16 + rr < p.n) {
      v[u] = *reinterpret_cast<const uint4*>(wb + rr * o8 + ((c ^ (rr & swz)) * kPer));
      if (add)
        old[u] = *reinterpret_cast<const uint4*>(row + (mt * 16 + rr) * p.y_ax + c * kPer);
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = lane + 32 * u, rr = i / cpr, c = i - rr * cpr;
    if (rr < 16 && mt * 16 + rr < p.n)
      *reinterpret_cast<uint4*>(row + (mt * 16 + rr) * p.y_ax + c * kPer) =
          add ? add_chunk<IO>(v[u], old[u]) : v[u];
  }
  __syncwarp();
}

// Inverse DFT of the tile's rows: y_t (n x O8) = i2^T (n x 2m) @ mk_t, each
// warp m-tiles of 16 points, its A fragments loaded once for all rows when
// 2m fits kHeldK k-steps. B row j of row t is the spectrum of mode j mod m,
// part j / m; rows past 2m read mode 0 against zero factors.
template <bool kFull, typename IO>
__device__ __forceinline__ void inverse_dft(const MmaParams& p, const uint4* __restrict__ a3,
                                            IO* __restrict__ out, long long r0, int rows,
                                            Phases& ph) {
  const int lane = threadIdx.x % 32;
  const int kt_n = p.kt3, m = p.m, o8 = p.o8, tr = p.tile_rows, ld = p.spec_ld;
  const int jr = (lane % 8) + ((lane / 8) % 2) * 8;  // the lane's B row in a k-step
  const bf16* spec = spec_buf();
  uint32_t a[kHeldK][4];
  for (int mt = threadIdx.x / 32; mt < p.mt3; mt += kMmaWarps) {
    const uint4* at = a3 + static_cast<long long>(mt) * kt_n * 32;
    bool held = false;
    for (int nc = 0; nc < o8; nc += 8 * kNChunk) {
      const int nt_n = min(kNChunk, (o8 - nc) / 8);
      for (int t = 0; t < rows; ++t) {
        float acc[kNChunk][4];
        warp_tile<kFull>(acc, a, held, kt_n <= kHeldK, at, kt_n, nt_n, [&](int kt, int jn) {
          const int j = kt * 16 + jr;
          const bool in = j < 2 * m;
          const int part = in && j >= m, k = in ? j - part * m : 0;
          const int e = part * o8 + nc + (lane / 16) * 8 + jn * 8;
          return spec + (k * tr + t) * ld + (((e >> 3) ^ ((k + t) & 7)) << 3);
        });
        ph.mark(5);
        if (p.vec_out)
          store_out_vec(p, out, r0 + t, mt, acc);
        else
          store_out<kFull>(p, out, r0 + t, mt, nc, nt_n, acc);
        ph.mark(6);
      }
    }
  }
}

template <typename IO>
__global__ void __launch_bounds__(kMmaThreads, 1)
spectral_pass_mma_kernel(const IO* __restrict__ x, const uint4* __restrict__ a1,
                         const uint4* __restrict__ a3, const bf16* __restrict__ wk,
                         IO* __restrict__ out, MmaParams p) {
  Phases ph;
  ph.start();
  const int tr = p.tile_rows;
  const long long r0 = static_cast<long long>(blockIdx.x) * tr;
  const int rows = static_cast<int>(min(static_cast<long long>(tr), p.rows - r0));
  // the x stages' rows from n to the last k-step's end hold zeros (the
  // factors there are zero too); x copies never reach them
  const int pad = (p.kt1 * 16 - p.n) * p.x_ld;
  for (int s = 0; s < kStages; ++s) {
    bf16* st = stage_buf(p, s) + p.n * p.x_ld;
    for (int i = threadIdx.x; i < pad; i += blockDim.x) st[i] = __float2bfloat16_rn(0.f);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbarrier_init(stage_bar(p, s), 1);
    fence_mbarrier_init();
  }
  __syncthreads();
  for (int s = 0; s < kStages - 1; ++s) start_slice(p, x, wk, r0, rows, s);
  const int slices = tr + (p.m + kSliceModes - 1) / kSliceModes;
  uint32_t parity = 0;  // bit s: the phase of stage s's mbarrier to wait for
  // Waits for slice i: it has landed (this thread's copies, then
  // everyone's), and every warp is done with the stage the next slice
  // overwrites and with the previous modes' z.
  auto land = [&](int i) {
    cp_async_wait<kStages - 2>();
    if (i >= tr) {
      const int s = i % kStages;
      mbarrier_wait(stage_bar(p, s), (parity >> s) & 1u);
      parity ^= 1u << s;
    }
    __syncthreads();
  };
  {
    const bool full = p.c8 % (8 * kNChunk) == 0;
    uint32_t a[kHeldK][4];  // a warp's factor fragments, held across rows
    bool held = false;
    for (int i = 0; i < tr; ++i) {
      land(i);
      start_slice(p, x, wk, r0, rows, i + kStages - 1);
      ph.mark(0);
      if (full)
        forward_dft<true>(p, a1, stage_buf(p, i % kStages), i, a, held);
      else
        forward_dft<false>(p, a1, stage_buf(p, i % kStages), i, a, held);
      ph.mark(1);
    }
  }
  const bool full_mix = p.c8 == 64 && p.o8 == 64;
  float macc[kSliceModes][kMixTiles][4];
  for (int i = tr; i < slices; ++i) {
    land(i);
    ph.mark(2);
    start_slice(p, x, wk, r0, rows, i + kStages - 1);
    ph.mark(3);
    if (i > tr) store_mixed(p, (i - tr - 1) * kSliceModes, macc);
    if (full_mix)
      mix_modes_full(p, stage_buf(p, i % kStages), (i - tr) * kSliceModes, macc);
    else
      mix_modes(p, stage_buf(p, i % kStages), (i - tr) * kSliceModes, macc);
    ph.mark(4);
  }
  __syncthreads();
  store_mixed(p, (slices - tr - 1) * kSliceModes, macc);
  __syncthreads();
  ph.mark(4);
  if (p.o8 % (8 * kNChunk) == 0)
    inverse_dft<true>(p, a3, out, r0, rows, ph);
  else
    inverse_dft<false>(p, a3, out, r0, rows, ph);
  ph.flush();
}

__host__ __device__ inline int round_up(int v, int to) { return (v + to - 1) / to * to; }

// The row stride of stage rows of w elements (a multiple of 8), and in swz
// whether they are swizzled (stage_at): rows of a multiple of 64 elements
// are, and take no padding; other rows are padded by 8 where their 16-byte
// chunks are even in number.
inline int stage_ld(int w, int& swz) {
  swz = w % 64 == 0 ? 7 : 0;
  return swz || (w / 8) % 2 ? w : w + 8;
}

// Fills the bf16 kernel's layout from n, m, c, o: the tile of rows (the
// most, up to kTileRows, whose spectra and ring fit), the paddings and the
// shared memory in smem. False if no tile fits.
bool plan_mma(MmaParams& p, size_t& smem) {
  p.c8 = round_up(p.c, 8);
  p.o8 = round_up(p.o, 8);
  if (2 * p.o8 > 16 * kMmaWarps * kMixTiles) return false;
  p.kt1 = round_up((p.n + 15) / 16, kGroup);
  p.mt1 = (2 * p.m + 15) / 16;
  p.kt3 = round_up(p.mt1, kGroup);
  p.mt3 = (p.n + 15) / 16;
  p.kt_mix = 2 * p.c8 / 16;
  p.mt_mix = 2 * p.o8 / 16;
  p.spec_ld = round_up(std::max(2 * p.c8, 2 * p.o8), 64);
  p.x_ld = stage_ld(p.c8, p.x_swz);
  // weight rows: never padded, so that a mode is one contiguous copy
  p.w_ld = p.o8;
  p.w_swz = p.o8 % 64 == 0 ? 7 : 0;
  p.stage_elems = round_up(std::max(p.kt1 * 16 * p.x_ld, kSliceModes * 2 * p.c8 * p.w_ld), 8);
  for (int tr = kTileRows; tr >= 1; tr /= 2) {
    p.spec_elems = p.m * tr * p.spec_ld;
    p.bar_off = static_cast<int>(
        (static_cast<size_t>(p.spec_elems) + kStages * static_cast<size_t>(p.stage_elems)) *
        sizeof(bf16));
    smem = p.bar_off + kStages * sizeof(uint64_t);
    if (smem <= static_cast<size_t>(kMaxSmem)) {
      p.tile_rows = tr;
      return true;
    }
  }
  return false;
}

template <typename IO>
cudaError_t launch_mma(const void* x, const void* a1, const void* a3, const void* wk, void* out,
                       MmaParams& p, cudaStream_t stream) {
  size_t smem = 0;
  if (!plan_mma(p, smem)) return cudaErrorInvalidValue;
  const auto aligned = [](const void* q, uintptr_t to) {
    return (reinterpret_cast<uintptr_t>(q) & (to - 1)) == 0;
  };
  if (!aligned(a1, 16) || !aligned(a3, 16) || !aligned(wk, 16)) return cudaErrorMisalignedAddress;
  p.x_async = std::is_same<IO, bf16>::value && p.c % 8 == 0 && p.x_ax % 8 == 0 &&
              p.x_hi % 8 == 0 && p.x_lo % 8 == 0 && aligned(x, 16);
  p.pair_out = p.o % 2 == 0 && p.y_ax % 2 == 0 && p.y_hi % 2 == 0 && p.y_lo % 2 == 0 &&
               aligned(out, 2 * sizeof(IO));
  constexpr int kPer = 16 / sizeof(IO);
  p.vec_out = p.o % kPer == 0 && p.o * sizeof(IO) <= 128 && p.y_ax % kPer == 0 &&
              p.y_hi % kPer == 0 && p.y_lo % kPer == 0 && aligned(out, 16) &&
              kMmaWarps * 16 * p.o8 * sizeof(IO) <= kStages * p.stage_elems * sizeof(bf16);
  p.out_swz = p.o8 * sizeof(IO) == 128 ? 7 : 0;
  auto kernel = spectral_pass_mma_kernel<IO>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = (p.rows + p.tile_rows - 1) / p.tile_rows;
  kernel<<<static_cast<unsigned>(blocks), kMmaThreads, smem, stream>>>(
      static_cast<const IO*>(x), static_cast<const uint4*>(a1), static_cast<const uint4*>(a3),
      static_cast<const bf16*>(wk), static_cast<IO*>(out), p);
  return cudaGetLastError();
}

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
// summed over blocks (scripts/torch_k3_phases.py builds the kernel with
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
// past the tile's rows, past n and in the channels from C. With kBf16 each
// x value is rounded to bf16 (x_async is then off for f32 x).
template <int TR, bool kBf16, typename IO>
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
        if (c0 + e < p.c) v[e] = kBf16 ? round_to<bf16>(to_f(src[e])) : to_f(src[e]);
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
// (row), column t * C8 + c -> chunk spec_chunk(j, c) of row j, element t;
// with kBf16 each rounded to bf16.
template <int TR, bool kBf16>
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
        row[spec_chunk(j, c0 + q) * TR] =
            kBf16 ? round_to<bf16>(acc[i][4 * h + q]) : acc[i][4 * h + q];
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
// row t, channel o at row s * m + k, column t * O8 + o; with kBf16 each
// rounded to bf16.
template <int TR, bool kBf16>
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
      if (kBf16)
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          re[t][e] = round_to<bf16>(re[t][e]);
          im[t][e] = round_to<bf16>(im[t][e]);
        }
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
// threads work on one; between the DFTs, the mix (mix_warp). kBf16: the
// bf16 mode's rounding points (the wide shapes of the bf16 pass, which the
// tensor-core kernel does not fit): x, the spectra and the mixed spectra
// rounded to bf16, the factors and the weight given already rounded;
// products of bf16 values are exact in f32, so only the order of the f32
// sums differs from the tensor-core kernel.
template <typename IO, int TR, bool kBf16>
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
      stage_forward<TR, kBf16>(p, x, f2p, stage(i), i / k1, (i % k1) * kF32K1, rows, xrow);
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
    store_spectra<TR, kBf16>(p, spec, acc, mt);
    ph.mark(2);
  }
  // every spectrum is in place, and the stages are free: the inverse's
  // first slices are copied during the mix
  __syncthreads();
  for (int i = 0; i < kF32Stages - 1; ++i) start_inverse(i);
  mix_warp<TR, kBf16>(p, spec, wk);
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
                            void* out, const F32Params& p, size_t smem, bool round_bf16,
                            cudaStream_t stream) {
  auto kernel =
      round_bf16 ? spectral_pass_kernel<IO, TR, true> : spectral_pass_kernel<IO, TR, false>;
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
                       F32Params& p, bool round_bf16, cudaStream_t stream) {
  size_t smem = 0;
  const int tr = plan_f32(p, smem);
  if (tr == 0) return cudaErrorInvalidValue;
  const auto aligned = [](const void* q, uintptr_t to) {
    return (reinterpret_cast<uintptr_t>(q) & (to - 1)) == 0;
  };
  if (!aligned(f2p, 16) || !aligned(i2p, 16) || !aligned(wk, 16)) return cudaErrorMisalignedAddress;
  p.x_async = std::is_same<IO, float>::value && !round_bf16 && p.c % 4 == 0 &&
              p.x_ax % 4 == 0 && p.x_hi % 4 == 0 && p.x_lo % 4 == 0 && aligned(x, 16);
  p.vec_out = p.o % 4 == 0 && p.y_ax % 4 == 0 && p.y_hi % 4 == 0 && p.y_lo % 4 == 0 &&
              aligned(out, 4 * sizeof(IO));
  if (tr == 4) return launch_f32_tile<IO, 4>(x, f2p, i2p, wk, out, p, smem, round_bf16, stream);
  if (tr == 2) return launch_f32_tile<IO, 2>(x, f2p, i2p, wk, out, p, smem, round_bf16, stream);
  return launch_f32_tile<IO, 1>(x, f2p, i2p, wk, out, p, smem, round_bf16, stream);
}

}  // namespace
}  // namespace rpde

// x: rows of an axis of length n with c channels (strides above), io type;
// out: rows of o channels (strides above), io type. Returns a cudaError_t.
// mode 0: f32 compute (the CUDA-core kernel); 1: bf16 compute on the
// tensor cores; 2: bf16 compute on the CUDA-core kernel, with the bf16
// mode's rounding points (shapes the tensor-core kernel does not fit:
// rpde_spectral_mma_fits), its operands those of mode 0 with the factors
// and the weight rounded to bf16.
// Modes 0 and 2: f2 (n, 2m) zero-padded to (n rounded up to 32, 2m rounded
// up to 128), i2 (2m, n) zero-padded to (2m rounded up to 128, n rounded up
// to 128), both f32 row-major; wpk is, per mode, the blocks a | b of the
// packed weight [[a, b], [-b, a]] as (2, c8, o8) f32, zeros in the padding
// (the kernel makes -b); all three 16-byte aligned.
// Mode 1: f2 is f2^T (2m, n) and i2 is i2^T (n, 2m), each zero-padded
// to whole 16 x 16 tiles, its columns (the contraction) to a multiple of
// 64, and packed in fragment order (mma.cuh frag_a_packed; tile (i, j) at
// (i * tiles_per_row + j) * 256 elements);
// wpk is, per mode, the first block row [a | b] of the packed weight
// [[a, b], [-b, a]] (rows (s, c), columns (t, o); the mix makes -b)
// as (2 c8, o8) rows, c8 and o8 being c and o rounded up to 8, zeros in the
// padding, and where o8 is a multiple of 64 each row's 16-byte chunks
// swizzled (chunk q of row r at q ^ (r mod 8)); all three bf16 and 16-byte
// aligned.
extern "C" int rpde_spectral_pass(int mode, int io_bf16, const void* x,
                                  const void* f2, const void* i2, const void* wpk,
                                  void* out, int n, int m, int c, int o,
                                  long long rows, long long rows_lo, long long x_hi,
                                  long long x_lo, long long x_ax, long long y_hi,
                                  long long y_lo, long long y_ax, int accumulate,
                                  void* stream) {
  using namespace rpde;
  if (n < 1 || m < 1 || c < 1 || o < 1 || rows < 1 || rows_lo < 1 || mode < 0 || mode > 2)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (mode == 1) {
    MmaParams p{};
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
    if (io_bf16) return launch_mma<__nv_bfloat16>(x, f2, i2, wpk, out, p, s);
    return launch_mma<float>(x, f2, i2, wpk, out, p, s);
  }
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
  if (io_bf16) return launch_f32<__nv_bfloat16>(x, f2, i2, wpk, out, p, mode == 2, s);
  return launch_f32<float>(x, f2, i2, wpk, out, p, mode == 2, s);
}

// 1 if the tensor-core kernel (mode 1) fits a pass of n points, m modes, c
// channels in and o out, else 0: the launcher's Python mirror of plan_mma
// picks the bf16 route from the shape and is checked against it.
extern "C" int rpde_spectral_mma_fits(int n, int m, int c, int o) {
  if (n < 1 || m < 1 || c < 1 || o < 1) return 0;
  rpde::MmaParams p{};
  p.n = n;
  p.m = m;
  p.c = c;
  p.o = o;
  size_t smem = 0;
  return rpde::plan_mma(p, smem) ? 1 : 0;
}

#ifdef RPDE_K2_PHASES
// The phase counters of the bf16 kernel: copied to out (kPhases values), or
// zeroed when reset is set. Returns a cudaError_t.
extern "C" int rpde_k2_phase_cycles(unsigned long long* out, int reset) {
  unsigned long long zero[rpde::kPhases] = {};
  if (reset) return cudaMemcpyToSymbol(rpde::k2_phase_cycles, zero, sizeof(zero));
  return cudaMemcpyFromSymbol(out, rpde::k2_phase_cycles, sizeof(zero));
}
#endif

#ifdef RPDE_K3_PHASES
// The phase counters of the f32 kernel: copied to out (kK3Phases values),
// or zeroed when reset is set. Returns a cudaError_t.
extern "C" int rpde_k3_phase_cycles(unsigned long long* out, int reset) {
  unsigned long long zero[rpde::kK3Phases] = {};
  if (reset) return cudaMemcpyToSymbol(rpde::k3_phase_cycles, zero, sizeof(zero));
  return cudaMemcpyFromSymbol(out, rpde::k3_phase_cycles, sizeof(zero));
}
#endif
