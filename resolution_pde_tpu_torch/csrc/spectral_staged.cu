// The bf16 FFNO axis pass staged through device memory: three tensor-core
// products.
//
// Replaces the TPU kernel resolution_pde_tpu/ops/pallas/spectral_mix2.py
// `_pass_pallas` (entry `packed_spectral_mix_1d`, bf16 compute) and its
// adjoint. The TPU kernel holds a tile's spectra and the whole weight in
// many MB of VMEM; a fused pass that keeps them in a block's 227 KB stops
// at C = O = 104 for n = 256, m = 64. Here the pass is split at its own
// rounding points (spectral_mix2.py:52-73: z cast to the compute type
// before the mix, the mixed spectra before the inverse) into three GEMMs,
// the two intermediates written to device memory in bf16, so no shape is
// too wide:
//   1. forward DFT: Z (2m x R C8) = f2^T (2m x n) @ x (n x R C8), A shared by
//      every row, B the rows of x read in place through their strides; Z is
//      stored mode-major, (m, R, 2 C8), the re | im lanes of mode k side by
//      side (each row's channels padded to 8 with zeros);
//   2. the mix, batched over the m modes: M_k (R x 2 O8) = Z_k (R x 2 C8) @
//      W_k (2 C8 x 2 O8), W_k the packed complex weight [[a, b], [-b, a]]:
//      only the blocks a | b are read (half the packed bytes, and the
//      launcher's packing one copy), the -b block by flipping the sign
//      bits of the B fragments that come from it (exact); M (m, R, 2 O8);
//   3. inverse DFT: y (n x R O8) = i2^T (n x 2m) @ M (2m x R O8), M read
//      mode-major in place; the epilogue rounds to x's type and stores (with
//      `accumulate`, adds into out and rounds the sum, as the other kernels
//      do, the H pass added into the W pass).
// Every product is bf16 x bf16 on the tensor cores (mma.sync.m16n8k16, f32
// sums); the adjoint is the same three stages on the adjoint's factors and
// weight.
//
// What bounds it on an H100: its bytes. At C = O = 128, n = 256, m = 64 over
// 2048 rows it does 3 x 17.2 GFLOP (0.052 ms at 989 TFLOP/s) and moves x and
// out (134 MB each), Z and M (67 MB each, written once and read once) and the
// weight: about 0.16 ms at 3.35 TB/s. So the design keeps the tensor cores
// fed with few instructions and lets the copies run ahead: one GEMM template
// (gemm_tile) for the three stages, each with its own operand loaders and
// epilogue: block tiles of kBM x kBN (2m = 128 is one tile), kBK-deep slices
// of A and B copied by cp.async (16 bytes a copy, zero-filled past the
// operands' ends) through a ring of kRing stages, kRing - 1 slices in flight
// while the warps multiply on one; 8 warps, each a kWM x kWN warp tile of
// f32 sums in registers, its fragments read by ldmatrix from rows padded by
// 16 bytes so that no ldmatrix meets a bank conflict. Each stage's loader
// maps a 16-byte piece of a tile to its place in memory once per thread (a
// thread copies the same columns of every slice), so the loop carries no
// division. The epilogue writes the block tile, rounded to bf16, into
// shared memory and out 16 bytes a thread (stores from the fragments, 4
// bytes a lane scattered over modes, took 0.44 ms a pass against 0.27 at
// 128 channels on an H100, PERF.md), except for f32 out or channel counts
// no multiple of 8.
// The launcher zero-pads the factors to whole tiles and each mode's blocks
// to 8 channels; the sums over each contraction run in an order fixed by
// the shapes, so two calls give the same bits.
//
// The gradient of the pass's weight (rpde_spectral_wgrad) reuses stage 1 for
// the spectra of x and of the output's gradient and gemm_tile for their
// per-mode product; its note is with its kernels below.

#include <algorithm>
#include <initializer_list>
#include <type_traits>

#include "async_copy.cuh"
#include "common.cuh"
#include "mma.cuh"

extern __shared__ __align__(16) unsigned char staged_smem[];

namespace rpde {
namespace {

using bf16 = __nv_bfloat16;

// The block tile and ring (scripts/torch_k2_phases.py --wide builds copies
// with other values to compare; the launcher pads the factors for tiles up
// to 128 x 128 x 64).
constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;
constexpr int kRing = 3;
constexpr int kSgWarps = 8;
constexpr int kSgThreads = 32 * kSgWarps;
// warps as 2 (rows) x 4 (columns); a warp tile of kWM x kWN sums
constexpr int kWarpsN = 4;
constexpr int kWM = kBM / (kSgWarps / kWarpsN);
constexpr int kWN = kBN / kWarpsN;
constexpr int kMT = kWM / 16;
constexpr int kNT = kWN / 8;
static_assert(kNT % 2 == 0, "B fragments are read two n8 tiles at a time");
// shared-memory rows padded by 8 elements (16 bytes): the 8 rows an
// ldmatrix reads fall in 8 different 16-byte bank groups
constexpr int kALd = kBK + 8;
constexpr int kBLd = kBN + 8;
constexpr int kAStage = kBM * kALd;
constexpr int kBStage = kBK * kBLd;
constexpr size_t kSgSmem = static_cast<size_t>(kRing) * (kAStage + kBStage) * sizeof(bf16);
// 16-byte pieces of a tile's slice, and of them a thread's
constexpr int kAPieces = kBM * kBK / 8;
constexpr int kBPieces = kBK * kBN / 8;
constexpr int kBPerRow = kBN / 8;  // pieces of a B slice row
static_assert(kAPieces % kSgThreads == 0 && kBPieces % kSgThreads == 0,
              "every thread copies whole pieces of each slice");
constexpr int kAPer = kAPieces / kSgThreads;
constexpr int kBPer = kBPieces / kSgThreads;
static_assert(kSgThreads % kBPerRow == 0, "a thread copies one column piece of B");
constexpr int kBRowStep = kSgThreads / kBPerRow;
// the most modes a launch takes (the mix's grid.y)
constexpr int kMaxModes = 65535;

struct StagedParams {
  int n, m, c, o;
  int c8, o8;
  int a1_ld, a3_ld;      // row strides of the padded factors
  long long rows;
  long long rows_lo;
  long long x_hi, x_lo, x_ax;
  long long y_hi, y_lo, y_ax;
  int x_async;           // x pieces by cp.async (bf16 x, 8 | C, strides and x 16-byte aligned)
  int pair_out;          // out takes two neighbouring channels a store
  int vec_out;           // and 8 a store (8 | O, strides and out 16-byte aligned)
  int accumulate;
};

// the offset of row r (r = r_hi rows_lo + r_lo) in x or out; rows fit 32
// bits (staged_fits), so the division is a 32-bit one
__device__ __forceinline__ long long row_offset(long long r, long long rows_lo, long long hi,
                                                long long lo) {
  const unsigned rr = static_cast<unsigned>(r), rl = static_cast<unsigned>(rows_lo);
  const unsigned h = rr / rl;
  return h * hi + static_cast<long long>(rr - h * rl) * lo;
}

// a 16-byte cp.async that copies `bytes` (16 or 0) and zero-fills the rest
__device__ __forceinline__ void cp_async_16_zfill(void* smem_dst, const void* gmem_src,
                                                  bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_u32(smem_dst)), "l"(gmem_src), "r"(full ? 16 : 0)
               : "memory");
}

// the B fragments of two neighbouring n8 tiles, B[k][n] = s[k * ld + n]
__device__ __forceinline__ void frag_b2_trans(uint32_t (&b0)[2], uint32_t (&b1)[2],
                                              const bf16* s, int ld, int k0, int n0) {
  const int l = threadIdx.x % 32;
  uint32_t r[4];
  ldsm_x4_trans(r, s + (k0 + (l % 8) + ((l / 8) % 2) * 8) * ld + n0 + (l / 16) * 8);
  b0[0] = r[0];
  b0[1] = r[1];
  b1[0] = r[2];
  b1[1] = r[3];
}

using StagedAcc = float[kMT][kNT][4];

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The block's tile of sums over a contraction of K: slice s of A (rows
// m0.., columns s kBK..) and of B (rows s kBK.., columns n0..) copied into
// ring stage s mod kRing by op.load_a / op.load_b (cp.async copies, or
// plain stores, of this thread's pieces), kRing - 1 slices ahead. With
// kATrans, op.load_a stores A's slice transposed, as B's is stored: row
// k of the slice holds A's columns m0.. (kBK x kATLd), and its fragments
// are read with ldmatrix.trans.
constexpr int kATLd = kBM + 8;
static_assert(kBK * kATLd <= kAStage, "a transposed A slice fits its ring stage");
template <bool kATrans = false, typename Op>
__device__ __forceinline__ void gemm_tile(Op& op, int K, StagedAcc& acc) {
  bf16* sa = reinterpret_cast<bf16*>(staged_smem);
  bf16* sb = sa + kRing * kAStage;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / kWarpsN) * kWM, wn = (warp % kWarpsN) * kWN;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
  const int slices = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    if (s < slices) {
      op.load_a(sa + s * kAStage, s * kBK);
      op.load_b(sb + s * kBStage, s * kBK);
    }
    cp_async_commit();
  }
  for (int s = 0; s < slices; ++s) {
    // slice s has landed (this thread's copies, then everyone's), and every
    // warp is done with the stage that slice s + kRing - 1 overwrites
    cp_async_wait<kRing - 2>();
    __syncthreads();
    const int next = s + kRing - 1;
    if (next < slices) {
      op.load_a(sa + (next % kRing) * kAStage, next * kBK);
      op.load_b(sb + (next % kRing) * kBStage, next * kBK);
    }
    cp_async_commit();
    const bf16* a = sa + (s % kRing) * kAStage;
    const bf16* b = sb + (s % kRing) * kBStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[kMT][4], bfr[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        if constexpr (kATrans)
          frag_a_trans(af[i], a, kATLd, wm + 16 * i, kk);
        else
          frag_a(af[i], a, kALd, wm + 16 * i, kk);
      }
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        frag_b2_trans(bfr[j], bfr[j + 1], b, kBLd, kk, wn + 8 * j);
        op.fix_b(bfr[j], s * kBK + kk, wn + 8 * j);
        op.fix_b(bfr[j + 1], s * kBK + kk, wn + 8 * j + 8);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_bf16_16816(acc[i][j], af[i], bfr[j]);
    }
  }
  cp_async_wait<0>();
}

// shared-memory rows of the block tile in bf16 for its 16-byte stores,
// padded by 16 bytes: a warp's fragment writes meet no bank conflict
constexpr int kCLd = kBN + 8;
static_assert(static_cast<size_t>(kBM) * kCLd * sizeof(bf16) <= kSgSmem,
              "the block tile in bf16 fits the ring's shared memory");

// The block's tile (m0, n0) of the stage's product. Where op.pieces(), its
// sums rounded to bf16 go through shared memory (over the ring, once every
// warp is done with it) and out to op.store8(row, 8 values) 16 bytes a
// thread, 16 threads a 256-byte run of a row; a thread's column piece is
// told to op.group first. Otherwise each fragment row's two neighbouring
// sums (the column even) go to op.store(row, column, v, v'), rows
// ascending within a fragment, each 8-column group told to op.group first.
template <typename Op>
__device__ __forceinline__ void run_tile(Op& op, int K, int m0, int n0) {
  StagedAcc acc;
  gemm_tile(op, K, acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (op.pieces()) {
    bf16* ct = reinterpret_cast<bf16*>(staged_smem);
    const int tm = (warp / kWarpsN) * kWM, tn = (warp % kWarpsN) * kWN;
    __syncthreads();  // every warp is done with the ring
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(ct + (tm + 16 * i + lane / 4 + 8 * h) * kCLd + tn + 8 * j +
                                       2 * (lane % 4)) =
              pack_bf16x2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    __syncthreads();
    const int q = threadIdx.x % kBPerRow;
    if (!op.group(n0 + 8 * q)) return;
#pragma unroll 4
    for (int row = threadIdx.x / kBPerRow; row < kBM; row += kBRowStep)
      op.store8(m0 + row, *reinterpret_cast<const uint4*>(ct + row * kCLd + q * 8));
    return;
  }
  const int wm = m0 + (warp / kWarpsN) * kWM, wn = n0 + (warp % kWarpsN) * kWN;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int col = wn + 8 * j + 2 * (lane % 4);
    if (!op.group(wn + 8 * j)) continue;
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        op.store(wm + 16 * i + lane / 4 + 8 * h, col, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  }
}

// 8 values of x from (r, t, c..c+7), c < C, rounded to bf16, as one piece
template <typename IO>
__device__ __forceinline__ uint4 x_piece(const IO* __restrict__ src, int valid) {
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = e < valid ? to_f(src[e]) : 0.f;
  return make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]), pack_bf16x2(v[4], v[5]),
                    pack_bf16x2(v[6], v[7]));
}

// Stage 1, the forward DFT: Z (2m x R C8) = f2^T (2m x n) @ x (n x R C8).
// A: a1, f2^T zero-padded to (2m rounded up to 128, n rounded up to 64),
// row stride a1_ld. B column (r, c) of point t: x at row r, point t,
// channel c; a thread's piece of a B slice row is channels c..c+7 of one
// row r, the same for every slice.
template <typename IO>
struct ForwardOp {
  const StagedParams& p;
  const bf16* __restrict__ a1;
  bf16* __restrict__ z;
  int m0;
  const IO* xb;   // the thread's piece at point 0, or null past the rows
  int valid;      // its channels inside C
  long long zrow; // the thread's epilogue group: (r, c) -> r * 2 C8 + c
  __device__ ForwardOp(const StagedParams& p_, const IO* __restrict__ x, const bf16* a1_,
                       bf16* z_, int m0_, int n0)
      : p(p_), a1(a1_), z(z_), m0(m0_) {
    const int col = n0 + 8 * (threadIdx.x % kBPerRow);
    const int r = col / p.c8;
    const int c = col - r * p.c8;
    xb = nullptr;
    valid = 0;
    if (r < p.rows) {
      xb = x + row_offset(r, p.rows_lo, p.x_hi, p.x_lo) + c;
      valid = min(8, p.c - c);
    }
  }
  __device__ void load_a(bf16* st, int k0) const {
#pragma unroll
    for (int u = 0; u < kAPer; ++u) {
      const int i = threadIdx.x + u * kSgThreads;
      const int r = i / (kBK / 8), q = i % (kBK / 8);
      cp_async_16(st + r * kALd + q * 8,
                  a1 + static_cast<long long>(m0 + r) * p.a1_ld + k0 + q * 8);
    }
  }
  __device__ void load_b(bf16* st, int k0) const {
    const int q = threadIdx.x % kBPerRow;
#pragma unroll
    for (int u = 0; u < kBPer; ++u) {
      const int kr = threadIdx.x / kBPerRow + u * kBRowStep;
      const int t = k0 + kr;
      bf16* dst = st + kr * kBLd + q * 8;
      const bool in = xb != nullptr && t < p.n;
      if constexpr (std::is_same<IO, bf16>::value) {
        if (p.x_async) {
          cp_async_16_zfill(dst, in ? xb + t * p.x_ax : a1, in);
          continue;
        }
      }
      *reinterpret_cast<uint4*>(dst) =
          in ? x_piece(xb + t * p.x_ax, valid) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __device__ void fix_b(uint32_t (&)[2], int, int) const {}
  __device__ bool group(int col) {
    const int r = col / p.c8;
    zrow = static_cast<long long>(r) * 2 * p.c8 + (col - r * p.c8);
    return r < p.rows;
  }
  __device__ bool pieces() const { return true; }
  // packed mode j = s m + k -> Z[k, r, s C8 + c..c+7]
  __device__ void store8(int j, uint4 v) const {
    if (j >= 2 * p.m) return;
    const int s = j >= p.m, k = j - s * p.m;
    *reinterpret_cast<uint4*>(z + static_cast<long long>(k) * p.rows * 2 * p.c8 + zrow +
                              s * p.c8) = v;
  }
  // packed mode j = s m + k -> Z[k, r, s C8 + c], rounded to bf16
  __device__ void store(int j, int col, float v0, float v1) const {
    if (j >= 2 * p.m) return;
    const int s = j >= p.m, k = j - s * p.m;
    const long long at =
        static_cast<long long>(k) * p.rows * 2 * p.c8 + zrow + (col & 7) + s * p.c8;
    *reinterpret_cast<uint32_t*>(z + at) = pack_bf16x2(v0, v1);
  }
};

// Stage 2, the mix of mode k: M_k (R x 2 O8) = Z_k (R x 2 C8) @ W_k (2 C8 x
// 2 O8). A rows are Z's rows of mode k (zero-filled past R and past 2 C8).
// B row (s, c), column (t, o) of the packed [[a, b], [-b, a]] is read from
// mode k's blocks (2, C8, O8): block a where s = t, else b (zero-filled
// past 2 C8 rows and 2 O8 columns); fix_b makes the -b block's fragments
// (s = 1, t = 0) negative. A thread's piece of a B slice row is columns
// (t, o..o+7), the same for every slice.
struct MixOp {
  const StagedParams& p;
  const bf16* __restrict__ zk;
  bf16* __restrict__ mk;
  int m0, n0;
  const bf16* wb;  // the thread's B piece: mode k's blocks at channel o
  int wt;          // its column part t
  bool win;        // its columns inside 2 O8
  __device__ MixOp(const StagedParams& p_, const bf16* zk_, const bf16* wk, bf16* mk_, int m0_,
                   int n0_)
      : p(p_), zk(zk_), mk(mk_), m0(m0_), n0(n0_) {
    const int col = n0 + 8 * (threadIdx.x % kBPerRow);
    wt = col >= p.o8;
    win = col < 2 * p.o8;
    wb = wk + (col - wt * p.o8);
  }
  __device__ void load_a(bf16* st, int k0) const {
    const int kz = 2 * p.c8;
#pragma unroll
    for (int u = 0; u < kAPer; ++u) {
      const int i = threadIdx.x + u * kSgThreads;
      const int r = i / (kBK / 8), q = i % (kBK / 8);
      const int kc = k0 + q * 8;
      const bool in = m0 + r < p.rows && kc < kz;
      cp_async_16_zfill(st + r * kALd + q * 8,
                        in ? zk + static_cast<long long>(m0 + r) * kz + kc : zk, in);
    }
  }
  __device__ void load_b(bf16* st, int k0) const {
    const int q = threadIdx.x % kBPerRow;
#pragma unroll
    for (int u = 0; u < kBPer; ++u) {
      const int kr = threadIdx.x / kBPerRow + u * kBRowStep;
      const int k = k0 + kr, s = k >= p.c8, c = k - s * p.c8;
      const bool in = win && k < 2 * p.c8;
      cp_async_16_zfill(st + kr * kBLd + q * 8,
                        in ? wb + static_cast<long long>((s != wt) * p.c8 + c) * p.o8 : wb,
                        in);
    }
  }
  // the B fragment of rows k.., columns n.. (tile-local): its two k-row
  // pairs (2t, 2t + 1 and 2t + 8, 2t + 9) at column g negated where they
  // come from the -b block (row part 1, column part 0)
  __device__ void fix_b(uint32_t (&b)[2], int k, int n) const {
    const int lane = threadIdx.x % 32;
    if (n0 + n + lane / 4 >= p.o8) return;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (k + 2 * (lane % 4) + 8 * h >= p.c8) b[h] ^= 0x80008000u;
  }
  __device__ bool group(int col) {
    mcol = col;
    return col < 2 * p.o8;
  }
  int mcol;  // the thread's column piece
  __device__ bool pieces() const { return true; }
  __device__ void store8(int r, uint4 v) const {
    if (r >= p.rows) return;
    *reinterpret_cast<uint4*>(mk + static_cast<long long>(r) * 2 * p.o8 + mcol) = v;
  }
  __device__ void store(int r, int col, float v0, float v1) const {
    if (r >= p.rows) return;
    *reinterpret_cast<uint32_t*>(mk + static_cast<long long>(r) * 2 * p.o8 + col) =
        pack_bf16x2(v0, v1);
  }
};

// Stage 3, the inverse DFT: y (n x R O8) = i2^T (n x 2m) @ M (2m x R O8).
// A: a3, i2^T zero-padded to (n rounded up to 128, 2m rounded up to 64),
// row stride a3_ld. B row j = s m + k, column (r, o): M[k, r, s O8 + o]; a
// thread's piece is channels o..o+7 of one row r. The epilogue writes out
// in x's type at point t of row r, or adds into it with `accumulate`.
template <typename IO>
struct InverseOp {
  const StagedParams& p;
  const bf16* __restrict__ a3;
  const bf16* __restrict__ mz;
  IO* __restrict__ out;
  int m0;
  const bf16* mb;      // the thread's B piece at mode 0, part 0, or null
  IO* yb;              // the epilogue group's row of out at point 0
  int o0;              // and its first channel
  __device__ InverseOp(const StagedParams& p_, const bf16* a3_, const bf16* mz_, IO* out_,
                       int m0_, int n0)
      : p(p_), a3(a3_), mz(mz_), out(out_), m0(m0_) {
    const int col = n0 + 8 * (threadIdx.x % kBPerRow);
    const int r = col / p.o8;
    mb = r < p.rows ? mz + static_cast<long long>(r) * 2 * p.o8 + (col - r * p.o8) : nullptr;
  }
  __device__ void load_a(bf16* st, int k0) const {
#pragma unroll
    for (int u = 0; u < kAPer; ++u) {
      const int i = threadIdx.x + u * kSgThreads;
      const int r = i / (kBK / 8), q = i % (kBK / 8);
      cp_async_16(st + r * kALd + q * 8,
                  a3 + static_cast<long long>(m0 + r) * p.a3_ld + k0 + q * 8);
    }
  }
  __device__ void load_b(bf16* st, int k0) const {
    const int q = threadIdx.x % kBPerRow;
#pragma unroll
    for (int u = 0; u < kBPer; ++u) {
      const int kr = threadIdx.x / kBPerRow + u * kBRowStep;
      const int j = k0 + kr;
      const bool in = mb != nullptr && j < 2 * p.m;
      const int s = j >= p.m, k = j - s * p.m;
      cp_async_16_zfill(st + kr * kBLd + q * 8,
                        in ? mb + static_cast<long long>(k) * p.rows * 2 * p.o8 + s * p.o8 : mz,
                        in);
    }
  }
  __device__ void fix_b(uint32_t (&)[2], int, int) const {}
  __device__ bool group(int col) {
    const int r = col / p.o8;
    o0 = col - r * p.o8;
    if (r >= p.rows || o0 >= p.o) return false;
    yb = out + row_offset(r, p.rows_lo, p.y_hi, p.y_lo);
    return true;
  }
  // bf16 out with 8 | O and out's strides: 16-byte pieces
  __device__ bool pieces() const { return std::is_same<IO, bf16>::value && p.vec_out; }
  __device__ void store8(int t, uint4 v) const {
    if (t >= p.n) return;
    uint4* dst = reinterpret_cast<uint4*>(yb + t * p.y_ax + o0);
    if (p.accumulate) {
      const uint4 old = *dst;
      const uint32_t* a = reinterpret_cast<const uint32_t*>(&v);
      const uint32_t* b = reinterpret_cast<const uint32_t*>(&old);
      uint32_t sum[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a + e));
        const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b + e));
        sum[e] = pack_bf16x2(x.x + y.x, x.y + y.y);
      }
      v = make_uint4(sum[0], sum[1], sum[2], sum[3]);
    }
    *dst = v;
  }
  __device__ void store(int t, int col, float v0, float v1) const {
    if (t >= p.n) return;
    const int o = o0 + (col & 7);
    IO* dst = yb + t * p.y_ax + o;
    float v[2] = {round_to<IO>(v0), round_to<IO>(v1)};
    const bool both = o + 1 < p.o;
    if (both && p.pair_out) {
      if constexpr (std::is_same<IO, bf16>::value) {
        __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst);
        if (p.accumulate) {
          const float2 old = __bfloat1622float2(*d);
          v[0] += old.x;
          v[1] += old.y;
        }
        *d = __floats2bfloat162_rn(v[0], v[1]);
      } else {
        float2* d = reinterpret_cast<float2*>(dst);
        if (p.accumulate) {
          const float2 old = *d;
          v[0] += old.x;
          v[1] += old.y;
        }
        *d = make_float2(v[0], v[1]);
      }
      return;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (o + e >= p.o) break;
      if (p.accumulate) v[e] += to_f(dst[e]);
      dst[e] = from_f<IO>(v[e]);
    }
  }
};

// Tiles of an (M x N) product: its blocks take them m-tile fastest, so the
// blocks that share a B tile run side by side.
__device__ __forceinline__ void tile_of(int m_tiles, int& m0, int& n0) {
  m0 = static_cast<int>(blockIdx.x % m_tiles) * kBM;
  n0 = static_cast<int>(blockIdx.x / m_tiles) * kBN;
}

template <typename IO>
__global__ void __launch_bounds__(kSgThreads, 2)
staged_forward_kernel(const IO* __restrict__ x, const bf16* __restrict__ a1,
                      bf16* __restrict__ z, StagedParams p) {
  int m0, n0;
  tile_of((2 * p.m + kBM - 1) / kBM, m0, n0);
  ForwardOp<IO> op(p, x, a1, z, m0, n0);
  run_tile(op, p.n, m0, n0);
}

__global__ void __launch_bounds__(kSgThreads, 2)
staged_mix_kernel(const bf16* __restrict__ z, const bf16* __restrict__ w,
                  bf16* __restrict__ mz, StagedParams p) {
  int m0, n0;
  tile_of(static_cast<int>((p.rows + kBM - 1) / kBM), m0, n0);
  const int k = blockIdx.y;
  MixOp op(p, z + static_cast<long long>(k) * p.rows * 2 * p.c8,
           w + static_cast<long long>(k) * 2 * p.c8 * p.o8,
           mz + static_cast<long long>(k) * p.rows * 2 * p.o8, m0, n0);
  run_tile(op, 2 * p.c8, m0, n0);
}

template <typename IO>
__global__ void __launch_bounds__(kSgThreads, 2)
staged_inverse_kernel(const bf16* __restrict__ a3, const bf16* __restrict__ mz,
                      IO* __restrict__ out, StagedParams p) {
  int m0, n0;
  tile_of((p.n + kBM - 1) / kBM, m0, n0);
  InverseOp<IO> op(p, a3, mz, out, m0, n0);
  run_tile(op, 2 * p.m, m0, n0);
}

inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

template <typename IO>
cudaError_t launch_staged(const void* x, const void* a1, const void* a3, const void* w, void* z,
                          void* mz, void* out, StagedParams& p, cudaStream_t stream) {
  const auto aligned = [](const void* q, uintptr_t to) {
    return (reinterpret_cast<uintptr_t>(q) & (to - 1)) == 0;
  };
  if (!aligned(a1, 16) || !aligned(a3, 16) || !aligned(w, 16) || !aligned(z, 16) ||
      !aligned(mz, 16))
    return cudaErrorMisalignedAddress;
  p.x_async = std::is_same<IO, bf16>::value && p.c % 8 == 0 && p.x_ax % 8 == 0 &&
              p.x_hi % 8 == 0 && p.x_lo % 8 == 0 && aligned(x, 16);
  p.pair_out = p.y_ax % 2 == 0 && p.y_hi % 2 == 0 && p.y_lo % 2 == 0 &&
               aligned(out, 2 * sizeof(IO));
  p.vec_out = p.o % 8 == 0 && p.y_ax % 8 == 0 && p.y_hi % 8 == 0 && p.y_lo % 8 == 0 &&
              aligned(out, 16);
  auto fwd = staged_forward_kernel<IO>;
  auto inv = staged_inverse_kernel<IO>;
  cudaError_t err;
  for (const void* k : {reinterpret_cast<const void*>(fwd), reinterpret_cast<const void*>(inv),
                        reinterpret_cast<const void*>(staged_mix_kernel)})
    if ((err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(kSgSmem))) != cudaSuccess)
      return err;
  const long long fwd_blocks = ceil_div(2 * p.m, kBM) * ceil_div(p.rows * p.c8, kBN);
  const long long mix_blocks = ceil_div(p.rows, kBM) * ceil_div(2 * p.o8, kBN);
  const long long inv_blocks = ceil_div(p.n, kBM) * ceil_div(p.rows * p.o8, kBN);
  fwd<<<static_cast<unsigned>(fwd_blocks), kSgThreads, kSgSmem, stream>>>(
      static_cast<const IO*>(x), static_cast<const bf16*>(a1), static_cast<bf16*>(z), p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  staged_mix_kernel<<<dim3(static_cast<unsigned>(mix_blocks), p.m), kSgThreads, kSgSmem,
                      stream>>>(static_cast<const bf16*>(z), static_cast<const bf16*>(w),
                                static_cast<bf16*>(mz), p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  inv<<<static_cast<unsigned>(inv_blocks), kSgThreads, kSgSmem, stream>>>(
      static_cast<const bf16*>(a3), static_cast<const bf16*>(mz), static_cast<IO*>(out), p);
  return cudaGetLastError();
}

// whether a pass of n points, m modes, c channels in and o out fits the
// staged route: its grids, and every element offset inside a padded factor
// or a mode of the weight's blocks, fit their types
bool staged_fits(int n, int m, int c, int o) {
  if (n < 1 || m < 1 || c < 1 || o < 1 || m > kMaxModes) return false;
  const long long n_pad = ceil_div(n, 128) * 128, m2_pad = ceil_div(2LL * m, 128) * 128;
  const long long c8 = ceil_div(c, 8) * 8, o8 = ceil_div(o, 8) * 8;
  const long long limit = 1LL << 31;
  return n_pad * m2_pad < limit && 2 * c8 * o8 < limit;
}

// ---------------------------------------------------------------------------
// The packed weight's gradient of a bf16 pass: dwpk_k (2 C8 x 2 O8) = Z_k^T @
// GS_k over the rows, Z = f2^T x and GS = i2 g the spectra of the pass's
// input and of its output's gradient, each rounded to bf16, and the gradient
// of the blocks a | b taken from it (a = d[:C, :O] + d[C8:, O8:], b =
// d[:C, O8:] - d[C8:, :O]).
//
// Replaces no TPU kernel: the JAX package leaves this product to XLA inside
// its VJP (ops/pallas/spectral_mix2.py `op_bwd`), and the port had it as
// torch transposes, casts and IEEE-f32 GEMMs (spectral_mix.py
// `weight_grad_plain`), 9.6 ms a call at 32 x 256^2 x 64, m = 64 on an
// H100. Its bound is bytes: it reads x and g once (268 MB each there),
// writes and reads the two bf16 spectra once (134 MB each), 1.07 GB, or
// 0.32 ms at 3.35 TB/s, against 86 GFLOP (0.087 ms at 989 TFLOP/s).
// Three launches:
//   1. wgrad_spectra_kernel: both spectra, Z (m, R, 2 C8) and GS (m, R, 2 O8),
//      by stage 1 of the pass (ForwardOp, run_tile) on x with the pass's a1
//      and on g with the adjoint's a1 (= i2), both read in place through
//      their strides; one launch, x's tiles first;
//   2. wgrad_product_kernel: per mode and tile of (2 C8 x 2 O8), Z_k^T @ GS_k
//      over one chunk of rows, on gemm_tile's ring with A read transposed
//      (Z_k's rows are the contraction), f32 sums of bf16 products stored
//      per chunk. One tile a mode at C = O = 64 makes 64 blocks for 132 SMs,
//      so the rows are split into chunks (wgrad_chunk_rows) until the blocks
//      fill about two a SM;
//   3. wgrad_reduce_kernel: the chunks' sums added in chunk order, a thread
//      an output element, and the blocks' gradient (m, 2, C, O) in f32.
// No atomics: the chunks follow from the shapes alone, so two calls give the
// same bits.

// the blocks of the product that a launch aims at: 132 SMs of an H100, two
// blocks of gemm_tile's shared memory each
constexpr long long kWgSlots = 264;

struct WgradParams {
  int m, c, o, c8, o8;
  int m_tiles, n_tiles;  // tiles of a mode's 2 C8 rows and 2 O8 columns
  int chunks;
  long long rows, chunk;  // rows, and rows a chunk (a multiple of kBK)
};

// rows a chunk of the product: the rows split so that the blocks (each
// mode's tiles times the chunks) reach kWgSlots, a chunk a whole number of
// slices
long long wgrad_chunk_rows(long long rows, int m, int c, int o) {
  const long long c8 = ceil_div(c, 8) * 8, o8 = ceil_div(o, 8) * 8;
  const long long tiles = m * ceil_div(2 * c8, kBM) * ceil_div(2 * o8, kBN);
  const long long want = std::max(1LL, kWgSlots / tiles);
  return ceil_div(ceil_div(rows, want), kBK) * kBK;
}

// the product's chunks for a pass of n points, m modes, c channels in and o
// out over `rows` rows, or 0 where the kernels do not take the shape (the
// staged route's fit; rows, and stage 1's columns rows x C8 or O8, 32-bit)
int wgrad_chunks(int n, int m, int c, int o, long long rows) {
  if (!staged_fits(n, m, c, o) || rows < 1 || rows >= (1LL << 31) ||
      rows * ((std::max(c, o) + 7) / 8 * 8) >= (1LL << 31))
    return 0;
  return static_cast<int>(ceil_div(rows, wgrad_chunk_rows(rows, m, c, o)));
}

// Stage 1 of the pass on one tile: the spectrum of x (or g) with the factor
// a1, tile b of its (2m x R C8) product.
__device__ __forceinline__ void spectra_tile(const StagedParams& p, const bf16* x, const bf16* a1,
                                             bf16* z, unsigned b) {
  const int m_tiles = (2 * p.m + kBM - 1) / kBM;
  const int m0 = static_cast<int>(b % m_tiles) * kBM, n0 = static_cast<int>(b / m_tiles) * kBN;
  ForwardOp<bf16> op(p, x, a1, z, m0, n0);
  run_tile(op, p.n, m0, n0);
}

__global__ void __launch_bounds__(kSgThreads, 2)
wgrad_spectra_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                     const bf16* __restrict__ a1x, const bf16* __restrict__ a1g,
                     bf16* __restrict__ zx, bf16* __restrict__ zg, StagedParams px,
                     StagedParams pg, unsigned x_blocks) {
  if (blockIdx.x < x_blocks)
    spectra_tile(px, x, a1x, zx, blockIdx.x);
  else
    spectra_tile(pg, g, a1g, zg, blockIdx.x - x_blocks);
}

// The product of mode k over rows r0 .. r1 - 1: A = Z_k^T, whose slice s is
// rows r0 + s kBK.. of Z_k's (R x 2 C8) slab, copied as they lie, columns
// m0.. (gemm_tile<true> reads it transposed); B = GS_k's rows, columns n0...
// Both zero-filled past r1 and past their widths. A thread copies the same
// column piece of every slice row it copies.
struct WgradOp {
  const bf16* __restrict__ zk;
  const bf16* __restrict__ gk;
  long long r0, r1;
  int ldz, ldg;  // 2 C8, 2 O8
  int za, ga;    // the thread's column piece of A and of B, or -1 past the width
  __device__ WgradOp(const WgradParams& p, const bf16* zk_, const bf16* gk_, long long r0_,
                     int m0, int n0)
      : zk(zk_), gk(gk_), r0(r0_), r1(min(r0_ + p.chunk, p.rows)), ldz(2 * p.c8),
        ldg(2 * p.o8) {
    const int q = 8 * (threadIdx.x % kBPerRow);
    za = m0 + q < ldz ? m0 + q : -1;
    ga = n0 + q < ldg ? n0 + q : -1;
  }
  __device__ void load(bf16* st, int ld, const bf16* src, int lds, int col, int k0) const {
    const int q = threadIdx.x % kBPerRow;
#pragma unroll
    for (int u = 0; u < kBPer; ++u) {
      const int kr = threadIdx.x / kBPerRow + u * kBRowStep;
      const long long r = r0 + k0 + kr;
      const bool in = col >= 0 && r < r1;
      cp_async_16_zfill(st + kr * ld + q * 8, in ? src + r * lds + col : src, in);
    }
  }
  __device__ void load_a(bf16* st, int k0) const { load(st, kATLd, zk, ldz, za, k0); }
  __device__ void load_b(bf16* st, int k0) const { load(st, kBLd, gk, ldg, ga, k0); }
  __device__ void fix_b(uint32_t (&)[2], int, int) const {}
};
static_assert(kBM == kBN, "A's and B's slices of the product share one piece map");

__global__ void __launch_bounds__(kSgThreads, 2)
wgrad_product_kernel(const bf16* __restrict__ z, const bf16* __restrict__ gs,
                     float* __restrict__ part, WgradParams p) {
  const int k = blockIdx.y;
  const int tiles = p.m_tiles * p.n_tiles;
  const int q = static_cast<int>(blockIdx.x) / tiles, t = static_cast<int>(blockIdx.x) % tiles;
  const int m0 = (t % p.m_tiles) * kBM, n0 = (t / p.m_tiles) * kBN;
  WgradOp op(p, z + static_cast<long long>(k) * p.rows * 2 * p.c8,
             gs + static_cast<long long>(k) * p.rows * 2 * p.o8, q * p.chunk, m0, n0);
  StagedAcc acc;
  gemm_tile<true>(op, static_cast<int>(op.r1 - op.r0), acc);
  // the tile's f32 sums into chunk q's (2 C8 x 2 O8) of mode k
  const int ldd = 2 * p.o8;
  float* d = part + (static_cast<long long>(q) * p.m + k) * (2LL * p.c8) * ldd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = m0 + (warp / kWarpsN) * kWM, wn = n0 + (warp % kWarpsN) * kWN;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int col = wn + 8 * j + 2 * (lane % 4);
    if (col >= ldd) continue;
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm + 16 * i + lane / 4 + 8 * h;
        if (row < 2 * p.c8)
          *reinterpret_cast<float2*>(d + static_cast<long long>(row) * ldd + col) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
  }
}

// dW (m, 2, C, O): a thread an element (k, c, o) of both blocks, each of the
// four sums over the chunks in chunk order, then a = d[c][o] + d[C8 + c][O8
// + o] and b = d[c][O8 + o] - d[C8 + c][o].
constexpr int kWgReduceThreads = 256;

__global__ void __launch_bounds__(kWgReduceThreads)
wgrad_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw, WgradParams p) {
  const long long i = static_cast<long long>(blockIdx.x) * kWgReduceThreads + threadIdx.x;
  if (i >= static_cast<long long>(p.m) * p.c * p.o) return;
  const int o = static_cast<int>(i % p.o);
  const long long kc = i / p.o;
  const int c = static_cast<int>(kc % p.c), k = static_cast<int>(kc / p.c);
  const long long ld = 2 * p.o8, mode = 2LL * p.c8 * ld;
  const float* d = part + k * mode;
  const long long lo = c * ld + o, hi = (p.c8 + c) * ld + o;
  float s00 = 0.f, s11 = 0.f, s01 = 0.f, s10 = 0.f;
  for (int q = 0; q < p.chunks; ++q, d += p.m * mode) {
    s00 += d[lo];
    s11 += d[hi + p.o8];
    s01 += d[lo + p.o8];
    s10 += d[hi];
  }
  dw[(2LL * k * p.c + c) * p.o + o] = s00 + s11;
  dw[((2LL * k + 1) * p.c + c) * p.o + o] = s01 - s10;
}

cudaError_t launch_wgrad(const bf16* x, const bf16* g, const bf16* a1x, const bf16* a1g, bf16* zx,
                         bf16* zg, float* part, float* dw, StagedParams& px, StagedParams& pg,
                         const WgradParams& w, cudaStream_t stream) {
  const auto aligned = [](const void* q, uintptr_t to) {
    return (reinterpret_cast<uintptr_t>(q) & (to - 1)) == 0;
  };
  if (!aligned(a1x, 16) || !aligned(a1g, 16) || !aligned(zx, 16) || !aligned(zg, 16) ||
      !aligned(part, 8) || !aligned(dw, 4))
    return cudaErrorMisalignedAddress;
  for (auto* pp : {&px, &pg}) {
    const void* src = pp == &px ? static_cast<const void*>(x) : static_cast<const void*>(g);
    pp->x_async = pp->c % 8 == 0 && pp->x_ax % 8 == 0 && pp->x_hi % 8 == 0 &&
                  pp->x_lo % 8 == 0 && aligned(src, 16);
  }
  cudaError_t err;
  for (const void* k : {reinterpret_cast<const void*>(wgrad_spectra_kernel),
                        reinterpret_cast<const void*>(wgrad_product_kernel)})
    if ((err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(kSgSmem))) != cudaSuccess)
      return err;
  const long long x_blocks = ceil_div(2 * px.m, kBM) * ceil_div(px.rows * px.c8, kBN);
  const long long g_blocks = ceil_div(2 * pg.m, kBM) * ceil_div(pg.rows * pg.c8, kBN);
  const long long reduce_blocks = ceil_div(static_cast<long long>(w.m) * w.c * w.o,
                                           kWgReduceThreads);
  if (x_blocks + g_blocks >= (1LL << 31) || reduce_blocks >= (1LL << 31))
    return cudaErrorInvalidValue;
  wgrad_spectra_kernel<<<static_cast<unsigned>(x_blocks + g_blocks), kSgThreads, kSgSmem,
                         stream>>>(x, g, a1x, a1g, zx, zg, px, pg,
                                   static_cast<unsigned>(x_blocks));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wgrad_product_kernel<<<dim3(static_cast<unsigned>(w.m_tiles * w.n_tiles * w.chunks), w.m),
                         kSgThreads, kSgSmem, stream>>>(zx, zg, part, w);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wgrad_reduce_kernel<<<static_cast<unsigned>(reduce_blocks), kWgReduceThreads, 0, stream>>>(
      part, dw, w);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rpde

// One bf16 axis pass (or adjoint) on the staged route. x: rows of an axis of
// n points with c channels (r = r_hi * rows_lo + r_lo; element (r, t, c) at
// r_hi * x_hi + r_lo * x_lo + t * x_ax + c), io type; out: rows of o
// channels, strides likewise (y_*), io type; with `accumulate` the pass is
// added into out.
//   a1: f2^T (2m x n) in bf16, zero-padded to (2m rounded up to 128, n
//       rounded up to 64), row-major; a3: i2^T (n x 2m) in bf16, zero-padded
//       to (n rounded up to 128, 2m rounded up to 64), row-major;
//   w:  per mode the blocks a | b of the packed weight [[a, b], [-b, a]]
//       (rows (s, c), columns (t, o); the mix makes -b) as (2, c8, o8) bf16,
//       c8 and o8 being c and o rounded up to 8, zeros in the padding;
//   z, mz: bf16 scratch of m * rows * 2 c8 and m * rows * 2 o8 elements
//       (c8, o8: c and o rounded up to 8);
// all 16-byte aligned. Each stage is one launch over all rows (faster on an
// H100 than chunks of rows whose scratch stays in L2, PERF.md). Returns a
// cudaError_t.
extern "C" int rpde_spectral_staged(int io_bf16, const void* x, const void* a1, const void* a3,
                                    const void* w, void* z, void* mz, void* out, int n, int m,
                                    int c, int o, long long rows, long long rows_lo,
                                    long long x_hi, long long x_lo, long long x_ax,
                                    long long y_hi, long long y_lo, long long y_ax,
                                    int accumulate, void* stream) {
  using namespace rpde;
  // rows and the columns of stages 1 and 3 (rows x C8 or O8) are 32-bit in
  // the kernels
  if (!staged_fits(n, m, c, o) || rows < 1 || rows_lo < 1 || rows >= (1LL << 31) ||
      rows * ((std::max(c, o) + 7) / 8 * 8) >= (1LL << 31))
    return cudaErrorInvalidValue;
  StagedParams p{};
  p.n = n;
  p.m = m;
  p.c = c;
  p.o = o;
  p.c8 = (c + 7) / 8 * 8;
  p.o8 = (o + 7) / 8 * 8;
  p.a1_ld = static_cast<int>(ceil_div(n, 64) * 64);
  p.a3_ld = static_cast<int>(ceil_div(2LL * m, 64) * 64);
  p.rows = rows;
  p.rows_lo = rows_lo;
  p.x_hi = x_hi;
  p.x_lo = x_lo;
  p.x_ax = x_ax;
  p.y_hi = y_hi;
  p.y_lo = y_lo;
  p.y_ax = y_ax;
  p.accumulate = accumulate;
  auto s = static_cast<cudaStream_t>(stream);
  if (io_bf16) return launch_staged<__nv_bfloat16>(x, a1, a3, w, z, mz, out, p, s);
  return launch_staged<float>(x, a1, a3, w, z, mz, out, p, s);
}

// 1 if the staged route takes a pass of n points, m modes, c channels in
// and o out, else 0: the launcher's Python mirror (spectral_route) is
// checked against it.
extern "C" int rpde_spectral_staged_fits(int n, int m, int c, int o) {
  return rpde::staged_fits(n, m, c, o) ? 1 : 0;
}

// The gradient of a bf16 pass's weight blocks a | b: x (rows of n points,
// c channels, strides x_*, as rpde_spectral_staged takes them) and g (the
// gradient of the pass's output, o channels, strides g_*), both bf16 ->
// dw (m, 2, c, o) f32, contiguous.
//   a1x: the pass's a1 (f2^T), a1g: its adjoint's a1 (i2), each (2m
//       rounded up to 128, n rounded up to 64) bf16, row-major, zeros in the
//       padding (rpde_spectral_staged's a1);
//   zx, zg: bf16 scratch of m * rows * 2 c8 and m * rows * 2 o8 elements;
//   part: f32 scratch of chunks * m * 2 c8 * 2 o8 elements, chunks as
//       rpde_spectral_wgrad_chunks gives them (a call with another count
//       is refused);
// all 16-byte aligned. Returns a cudaError_t.
extern "C" int rpde_spectral_wgrad(const void* x, const void* g, const void* a1x, const void* a1g,
                                   void* zx, void* zg, void* part, void* dw, int n, int m, int c,
                                   int o, long long rows, long long rows_lo, long long x_hi,
                                   long long x_lo, long long x_ax, long long g_hi, long long g_lo,
                                   long long g_ax, int chunks, void* stream) {
  using namespace rpde;
  if (rows_lo < 1 || chunks < 1 || chunks != wgrad_chunks(n, m, c, o, rows))
    return cudaErrorInvalidValue;
  StagedParams px{};
  px.n = n;
  px.m = m;
  px.c = c;
  px.c8 = (c + 7) / 8 * 8;
  px.a1_ld = static_cast<int>(ceil_div(n, 64) * 64);
  px.rows = rows;
  px.rows_lo = rows_lo;
  px.x_hi = x_hi;
  px.x_lo = x_lo;
  px.x_ax = x_ax;
  StagedParams pg = px;
  pg.c = o;
  pg.c8 = (o + 7) / 8 * 8;
  pg.x_hi = g_hi;
  pg.x_lo = g_lo;
  pg.x_ax = g_ax;
  WgradParams w{};
  w.m = m;
  w.c = c;
  w.o = o;
  w.c8 = px.c8;
  w.o8 = pg.c8;
  w.m_tiles = static_cast<int>(ceil_div(2 * w.c8, kBM));
  w.n_tiles = static_cast<int>(ceil_div(2 * w.o8, kBN));
  w.chunks = chunks;
  w.rows = rows;
  w.chunk = wgrad_chunk_rows(rows, m, c, o);
  return launch_wgrad(static_cast<const bf16*>(x), static_cast<const bf16*>(g),
                      static_cast<const bf16*>(a1x), static_cast<const bf16*>(a1g),
                      static_cast<bf16*>(zx), static_cast<bf16*>(zg), static_cast<float*>(part),
                      static_cast<float*>(dw), px, pg, w, static_cast<cudaStream_t>(stream));
}

// The weight gradient's row chunks for a pass of n points, m modes, c
// channels in and o out over `rows` rows, or 0 where its kernels do not take
// the shape: the launcher asks for them before each call of
// rpde_spectral_wgrad and refuses a shape that has none.
extern "C" int rpde_spectral_wgrad_chunks(int n, int m, int c, int o, long long rows) {
  return rpde::wgrad_chunks(n, m, c, o, rows);
}
