// Fused FFNO FeedForward, forward.
//
// Replaces the TPU kernel resolution_pde_tpu/ops/pallas/fused_ff.py
// `_fwd_pallas` (entry `fused_feedforward`): per tile of rows it runs
//     x @ W1 + b1 -> GELU -> @ W2 + b2 -> ... -> @ WL + bL [-> LayerNorm]
//     [+ residual]
// with products in the compute type (bf16 or f32) accumulated in f32, the
// bias, GELU, LayerNorm and residual in f32, each hidden activation rounded
// to the compute type before the next product, and the output in x's type.
// With `zs` given (the TPU kernel's save_zs), it also stores the first
// n_save pre-activations in the compute type, packed per row, for the
// backward (fused_ff_bwd.cu) to read instead of recomputing them.
//
// Rows are independent in the forward pass, so a block takes one tile of
// up to 64 rows and needs no reduction with other blocks: a result depends
// only on the shapes. Unfused, the (rows, hidden) activations would make
// several round trips through device memory; here the tile's hidden
// activations stay in shared memory, in two ping-pong buffers in the
// compute type (the TPU kernel's 8192-row VMEM tiles do not fit the 227 KB
// a block has), and only x, the residual and the output move.
//
// What bounds it on an H100: the products (103 GFLOP at the train shape of
// 524,288 rows, 64 -> 256 -> 256 -> 64, 0.104 ms at the tensor cores'
// 989 TFLOP/s; x, the residual and the output are 201 MB, 0.060 ms).
//
// bf16 (every FeedForward of the bf16 train step and predict): the
// products run on the tensor cores (mma.cuh, mma.sync.m16n8k16 on
// ldmatrix fragments). Every tile needs every weight (192 KB at bench
// dims), so the weights stream from L2 through a ring of shared-memory
// stages, kSliceRows rows of the contraction each, filled by 16-byte
// cp.async copies (async_copy.cuh) kRingStages - 1 slices ahead: the copy
// of the next slice, or of the next layer's first one, is in flight while
// the warps multiply the current slice, and no warp waits on L2 inside its
// products. The weights are zero-padded to whole fragments, (K, N)
// row-major (the packing K1b's dh products read), so a slice row is
// contiguous and the copies read whole 128-byte lines; B is read from the
// stage with ldmatrix.trans. A warp owns one warp tile of a layer's output
// (64 x 32 for the wide layers, 32 x 16 for narrow ones, 16 x 16 in the
// 16-row tiles of chains too wide for 32 rows of the buffers; a layer wider
// than a pass of the block's tiles takes several passes) and keeps its
// f32 sums in registers across the slices (warp_tile_accumulate). The
// epilogue adds the bias, applies the tanh GELU inline in its sigmoid form
// (the exact one as a call) and rounds into the other activation buffer,
// two columns a store; the last layer's f32 sums go to shared memory,
// where one warp a row does the LayerNorm and adds the residual tile,
// which cp.async brought in while the last layer ran. Activation rows and
// stage rows are padded by 8 columns, so ldmatrix meets no bank conflict.
// At bench dims a block takes 99 KB of shared memory and 128 registers a
// thread, so two blocks of 8 warps share an SM: one block's epilogues,
// barriers and LayerNorm overlap the other's products. Only the sums, the
// fragments and the stream's position stay live across the products (no
// spills).
//
// f32 (the f32-exact mode, held to 1e-5 of the plain version): the
// products stay IEEE f32 FMAs on the CUDA cores, no TF32: the train
// shape's 103 GFLOP are 1.54 ms at the card's 67 TFLOP/s, which bounds
// the kernel. To run near that rate the operands must come from shared
// memory in wide loads, each loaded value used many times from registers,
// so fused_ff_fwd_f32_kernel runs every layer on f32_tile_gemm
// (fused_ff.cuh), the backward's f32 products: each layer's weight (zero-
// padded to multiples of 4) streams through a ring of two shared-memory
// stages of 32 contraction rows by 16-byte cp.async copies, the next
// layer's first slice copied while this layer's epilogue runs; a thread
// keeps 8 x 4 sums whose operands are 16-byte shared loads, a warp's lanes
// 4 row groups x 8 column groups. A block takes a tile of 64 rows with 512
// threads (one register tile each of a 64 x 256 output; the threads a
// narrower layer leaves idle take part of its contraction), one block an
// SM: two f32 activation buffers of 64 rows padded to 4 mod 32 floats (so
// that the rows a warp's A loads read fall in other banks), 2 x 66.5 KB,
// and the ring, 64 KB at bench dims. The epilogue adds the bias and
// applies GELU (the JAX kernel's f32 form, gelu in fused_ff.cuh) into the
// other buffer; the last layer's sums go there in f32, the residual tile
// comes by cp.async into the freed input buffer, and one warp a row does
// the LayerNorm (two-pass) and adds it. Layers wider than 256 run in
// column chunks, which the ring is sized to, so chains up to 64 rows of
// both buffers take this kernel down to 8-row tiles; a chain too wide for
// that (widths above about 2,600) runs fused_ff_fwd_kernel instead
// (block_gemm, weights read from L2). The planner picks from the shapes.

#include <algorithm>
#include <type_traits>

#include "async_copy.cuh"
#include "fused_ff.cuh"
#include "mma.cuh"

// The dynamic shared memory of the bf16 kernel: two activation buffers
// (buf_bytes each; the last layer's f32 sums and the residual tile go into
// one of them), then the ring of weight stages. Functions
// inlined into the kernel address it from this symbol, so that no pointer
// to it stays in a register.
extern __shared__ __align__(16) unsigned char k1f_smem[];

namespace rpde {
namespace {

constexpr int kMaxTileRows = 64;
// the bf16 weight ring: stages, and rows of the contraction a stage holds
constexpr int kRingStages = 2;
constexpr int kSliceRows = 32;
// warps of a bf16 block (two blocks an SM)
constexpr int kFwdWarps = 8;
constexpr int kFwdThreads = 32 * kFwdWarps;
// warp tiles of the bf16 products: wide ones (64 x 32) for the wide
// layers, narrow ones (32 x 16) that give the 8 warps a tile each of a
// 64 x 64 output, and thin ones (16 x 16) for the least tile, 16 rows:
// the tile of chains whose two 32-row activation buffers do not fit
// beside the ring (the factor-4 chain at width 512 needs 16 rows)
constexpr int kWideM = 4, kWideN = 4, kNarrowM = 2, kNarrowN = 2, kThinM = 1;
constexpr int kMinTileRows = 16 * kThinM;
// the most shared memory a block may take
constexpr int kMaxSmem = 232448;

struct FFParams {
  int n_layers;
  int max_dim;
  int tile_rows;
  int approx_gelu;
  int dims[kMaxLayers + 1];
  long long w_off[kMaxLayers];  // element offset of layer l in the packed weights
  int b_off[kMaxLayers];        // element offset of layer l in the packed biases
  int n_save;                   // pre-activations stored to zs (0 without zs)
  int zs_ld;                    // per-row elements of zs
  int zs_off[kMaxLayers];       // per-row offset of layer l's pre-activation in zs
  int h_ld;                     // row stride of the activation buffers (bf16, f32 tiles)
  // bf16 (tensor cores) only
  int z_ld;                     // row stride of the last layer's f32 sums
  int buf_bytes;                // bytes of one activation buffer, a multiple of 16
  int w_ld;                     // row stride of a ring stage
  int stage_elems;              // elements of a ring stage
  int res_off;                  // byte offset of the residual tile in shared memory (past
                                // the last layer's f32 sums)
  int wide[kMaxLayers];         // layer l's warp tiles are the wide ones
  int pass_cols[kMaxLayers];    // output columns of one pass of layer l
};

__host__ __device__ inline int pad16(int d) { return (d + 15) / 16 * 16; }

// The kernel a chain runs on, as plan picks it from the shapes.
enum FwdRoute { kNoRoute = 0, kRouteMma = 1, kRouteF32Tiles = 2, kRouteF32Wide = 3 };

#ifdef RPDE_K1F_PHASES
// Clock cycles of thread 0 of every block in each phase of the bf16 kernel,
// summed over blocks (scripts/torch_k1f_phases.py builds the kernel with
// RPDE_K1F_PHASES; the library never does): 0 the first slices' copies
// started and the x tile, 1 waiting for a slice (its copies, then the
// barrier) and the last barrier, 2 starting a slice's copies, 3 the
// products, 4 the epilogues, 5 the LayerNorm and the stores.
constexpr int kPhases = 6;
__device__ unsigned long long k1f_phase_cycles[kPhases];
struct Phases {
  unsigned long long cycles[kPhases] = {};
  long long t;
  __device__ Phases() { t = clock64(); }
  __device__ void mark(int phase) {
    const long long now = clock64();
    cycles[phase] += static_cast<unsigned long long>(now - t);
    t = now;
  }
  __device__ void flush() {
    if (threadIdx.x == 0)
      for (int i = 0; i < kPhases; ++i) atomicAdd(&k1f_phase_cycles[i], cycles[i]);
  }
};
#else
struct Phases {
  __device__ void mark(int) {}
  __device__ void flush() {}
};
#endif

#ifdef RPDE_K1F_PHASES
// The same for the f32 kernel (fused_ff_fwd_f32_kernel): 0 the x tile and
// the first slice's copies started, 1 the first layer (its products and
// epilogue, and the waits in it), 2 the layers between, 3 the last layer,
// 4 the LayerNorm and the stores.
constexpr int kF32Phases = 5;
__device__ unsigned long long k1f_f32_phase_cycles[kF32Phases];
struct F32Phases {
  unsigned long long cycles[kF32Phases] = {};
  long long t;
  __device__ F32Phases() { t = clock64(); }
  __device__ void mark(int phase) {
    const long long now = clock64();
    cycles[phase] += static_cast<unsigned long long>(now - t);
    t = now;
  }
  __device__ void flush() {
    if (threadIdx.x == 0)
      for (int i = 0; i < kF32Phases; ++i) atomicAdd(&k1f_f32_phase_cycles[i], cycles[i]);
  }
};
#else
struct F32Phases {
  __device__ void mark(int) {}
  __device__ void flush() {}
};
#endif

// f32 (CUDA cores), chains too wide for fused_ff_fwd_f32_kernel:
// block_gemm on the weights (row-major, padded to multiples of 4) read
// from L2
//
// kSave: also store the first n_save pre-activations to zs (a separate
// instantiation, so the forward without it compiles as if zs did not exist)
template <typename IO, bool kSave>
__global__ void __launch_bounds__(kThreads)
fused_ff_fwd_kernel(const IO* __restrict__ x, const IO* __restrict__ residual,
                    IO* __restrict__ out, float* __restrict__ zs, const float* __restrict__ w,
                    const float* __restrict__ b, const float* __restrict__ ln_s,
                    const float* __restrict__ ln_b, long long n_rows, FFParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tr = p.tile_rows;
  float* buf_a = reinterpret_cast<float*>(smem);
  float* buf_b = buf_a + tr * p.max_dim;
  float* zf = buf_b + tr * p.max_dim;

  const long long row0 = static_cast<long long>(blockIdx.x) * tr;
  const int rows = static_cast<int>(min(static_cast<long long>(tr), n_rows - row0));
  const int c_in = p.dims[0];
  const int n_layers = p.n_layers;
  const int c_out = p.dims[n_layers];

  // x tile -> f32; rows past the end read as zero and are never stored
  for (int idx = threadIdx.x; idx < tr * c_in; idx += blockDim.x) {
    const int r = idx / c_in;
    buf_a[idx] = r < rows ? to_f(x[row0 * c_in + idx]) : 0.f;
  }
  __syncthreads();

  float* hin = buf_a;
  float* hout = buf_b;
  const bool approx = p.approx_gelu != 0;
  for (int l = 0; l < n_layers; ++l) {
    const int K = p.dims[l];
    const int N = p.dims[l + 1];
    const float* wl = w + p.w_off[l];
    const float* bl = b + p.b_off[l];
    const float* h = hin;
    const int ldw = pad4(N);
    auto a = [h, K](int i, int k) { return h[i * K + k]; };
    auto bm = [wl, ldw](int k, int j) { return wl[k * ldw + j]; };
    // the saved pre-activation of layer l, for rows of the tile, or null
    float* zl = kSave && l < p.n_save ? zs + row0 * p.zs_ld + p.zs_off[l] : nullptr;
    const int zs_ld = p.zs_ld;
    if (l < n_layers - 1) {
      float* ho = hout;
      gemm(tr, N, K, a, bm, [=](int i, int j, float acc) {
        const float z = acc + bl[j];
        if (kSave && zl != nullptr && i < rows) zl[i * zs_ld + j] = z;
        ho[i * N + j] = gelu(z, approx);
      });
      __syncthreads();
      float* t = hin;
      hin = hout;
      hout = t;
    } else {
      gemm(tr, N, K, a, bm, [=](int i, int j, float acc) {
        const float z = acc + bl[j];
        if (kSave && zl != nullptr && i < rows) zl[i * zs_ld + j] = z;
        zf[i * N + j] = z;
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

// bf16 (tensor cores)

using bf16 = __nv_bfloat16;

// tanh GELU as z * sigmoid(2u), u = sqrt(2/pi) (z + 0.044715 z^3): the
// same function as 0.5 z (1 + tanh(u)), in a few instructions (ex2 and a
// reciprocal on the special-function units, a few ulp in f32), so that the
// epilogue's 64 a thread stay inline. Far below zero the denominator
// overflows and the quotient is 0, GELU's limit.
__device__ __forceinline__ float gelu_tanh_fast(float z) {
  const float u2 = 1.5957691216057308f * fmaf(0.044715f * z, z * z, z);
  return __fdividef(z, 1.0f + __expf(-u2));
}

// The epilogue of layer l: z = the sum plus the bias; z to zs and, but for
// the last layer, GELU(z) rounded to bf16 into the next activation buffer,
// two neighbouring columns a store; the last layer's z in f32 into the
// same buffer, rows of z_ld.
// Columns from N up to the fragments' edge get zeros, which the next
// layer's padded contraction reads.
template <bool kSave>
struct Epilogue {
  const float* bl;
  bf16* zl;  // the saved pre-activation's rows, or null
  int zs_ld;
  int rows, N;
  bool last, approx;
  bf16* hout;  // the next activation buffer; the last layer's f32 sums go there too
  int h_ld;
  int z_ld;

  template <int MT, int NT>
  __device__ __forceinline__ void operator()(const float (&acc)[MT][NT][4], int m0, int n0,
                                             int np) const {
    if (approx)
      apply<true>(acc, m0, n0, np);
    else
      apply<false>(acc, m0, n0, np);
  }

  // kTanh: the tanh GELU inline; else the exact one, as a call
  template <bool kTanh, int MT, int NT>
  __device__ __forceinline__ void apply(const float (&acc)[MT][NT][4], int m0, int n0,
                                        int np) const {
    auto act = [](float z) { return kTanh ? gelu_tanh_fast(z) : gelu_call(z, false); };
    float* zf = reinterpret_cast<float*>(hout);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = frag_col(n0, j, 0);  // even; the lane's pair is col, col + 1
      if (n0 + 8 * j >= np) continue;
      const bool in0 = col < N, in1 = col + 1 < N;
      const float b0 = in0 ? __ldg(bl + col) : 0.f, b1 = in1 ? __ldg(bl + col + 1) : 0.f;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = frag_row(m0, i, 2 * h);
          const float z0 = acc[i][j][2 * h] + b0, z1 = acc[i][j][2 * h + 1] + b1;
          if (kSave && zl != nullptr && r < rows) {
            bf16* zr = zl + static_cast<long long>(r) * zs_ld + col;
            if (in0) zr[0] = __float2bfloat16_rn(z0);
            if (in1) zr[1] = __float2bfloat16_rn(z1);
          }
          if (!last) {
            *reinterpret_cast<__nv_bfloat162*>(hout + r * h_ld + col) =
                __floats2bfloat162_rn(in0 ? act(z0) : 0.f, in1 ? act(z1) : 0.f);
          } else if (in1) {
            *reinterpret_cast<float2*>(zf + r * z_ld + col) = make_float2(z0, z1);
          } else if (in0) {
            zf[r * z_ld + col] = z0;
          }
        }
    }
  }
};

__device__ __forceinline__ bf16* act_buf(const FFParams& p, int i) {
  return reinterpret_cast<bf16*>(k1f_smem + i * p.buf_bytes);
}

// The weight stream: the slices of every layer's padded (K, N) weight in
// the order the products read them (layer, pass, contraction slice): rows
// k0.. k0 + kSliceRows of the contraction, columns n_base.. n_base +
// pass_cols of the pass, each slice into the next stage of the ring, a row
// of w_ld elements a row of the slice. A slice row is contiguous in global
// memory, so the copies read whole 128-byte lines. Only the stream's
// position stays in registers.
struct WeightStream {
  int l = 0, n_base = 0, k0 = 0, stage = 0;

  static __device__ __forceinline__ const bf16* stage_ptr(const FFParams& p, int i) {
    return reinterpret_cast<const bf16*>(k1f_smem + 2 * p.buf_bytes) + i * p.stage_elems;
  }

  // start the copies of the next slice (none past the last layer) and
  // commit them as one group, so that every call commits one group
  __device__ __forceinline__ void start_next_slice(const FFParams& p,
                                                   const bf16* __restrict__ w) {
    if (l < p.n_layers) {
      const int kp = pad16(p.dims[l]), np = pad16(p.dims[l + 1]);
      const int k_rows = min(kSliceRows, kp - k0);
      const int pieces = min(p.pass_cols[l], np - n_base) / 8;  // 16 bytes each, a row
      const bf16* src = w + p.w_off[l] + static_cast<long long>(k0) * np + n_base;
      bf16* dst = const_cast<bf16*>(stage_ptr(p, stage));
      const int w_ld = p.w_ld;
      if (blockDim.x % pieces == 0) {
        // a thread copies the same piece of every (blockDim / pieces)-th
        // row: no division per piece
        const int q = threadIdx.x % pieces;
        for (int r = threadIdx.x / pieces; r < k_rows; r += blockDim.x / pieces)
          cp_async_16(dst + r * w_ld + q * 8, src + r * np + q * 8);
      } else {
        for (int i = threadIdx.x; i < k_rows * pieces; i += blockDim.x) {
          const int r = i / pieces, q = i - r * pieces;
          cp_async_16(dst + r * w_ld + q * 8, src + r * np + q * 8);
        }
      }
      stage = stage + 1 == kRingStages ? 0 : stage + 1;
      k0 += kSliceRows;
      if (k0 >= kp) {
        k0 = 0;
        n_base += p.pass_cols[l];
        if (n_base >= np) {
          n_base = 0;
          ++l;
        }
      }
    }
    cp_async_commit();
  }
};

// The residual tile's rows in global memory, and whether they are copied
// into shared memory with the first slice (16-byte aligned, a whole number
// of 16-byte pieces).
template <typename IO>
__device__ __forceinline__ bool residual_async(const IO* res_g, int n) {
  return res_g != nullptr && (reinterpret_cast<uintptr_t>(res_g) & 15u) == 0 &&
         (n * sizeof(IO)) % 16 == 0;
}

// Starts the copy of the tile's residual rows, where residual_async, into
// the buffer that receives the last layer's f32 sums, past them. Called as
// the last layer starts: the earlier layers are done with that buffer.
template <typename IO>
__device__ __forceinline__ void start_residual(const FFParams& p, const IO* __restrict__ residual,
                                               long long n_rows) {
  const int tr = p.tile_rows, c_out = p.dims[p.n_layers];
  const long long row0 = static_cast<long long>(blockIdx.x) * tr;
  const int rows = static_cast<int>(min(static_cast<long long>(tr), n_rows - row0));
  const IO* res_g = residual != nullptr ? residual + row0 * c_out : nullptr;
  if (!residual_async(res_g, rows * c_out)) return;
  const int pieces = rows * c_out * static_cast<int>(sizeof(IO)) / 16;
  for (int i = threadIdx.x; i < pieces; i += blockDim.x)
    cp_async_16(k1f_smem + p.res_off + 16 * i, reinterpret_cast<const char*>(res_g) + 16 * i);
}

// One pass of layer l: output columns n_base.. n_base + pass_cols over the
// whole contraction, each warp one warp tile of (16 MT) x (8 NT) outputs
// whose sums stay in registers. The weights arrive in the ring, slice by
// slice; `slice` counts the slices the block has consumed, and each one
// consumed lets the stream start one more; the last layer's first slice
// also starts the residual tile's copy. The epilogue is set up only after
// the contraction, from p: nothing else stays live across it.
template <int MT, int NT, bool kSave, typename IO>
__device__ __forceinline__ void layer_pass(const FFParams& p, int l, int n_base,
                                           const bf16* __restrict__ w,
                                           const float* __restrict__ b, bf16* __restrict__ zs,
                                           const IO* __restrict__ residual, long long n_rows,
                                           WeightStream& ws, int& slice, Phases& ph) {
  const int tr = p.tile_rows;
  const int kp = pad16(p.dims[l]), np = pad16(p.dims[l + 1]);
  const int tiles_m = tr / (16 * MT);
  const int warp = threadIdx.x / 32;
  const int m0 = (warp % tiles_m) * 16 * MT;
  const int tn = warp / tiles_m;
  const int n0 = n_base + tn * 8 * NT;
  const bool active = tn * 8 * NT < p.pass_cols[l] && n0 < np;
  const bf16* hin = act_buf(p, l % 2);
  const int h_ld = p.h_ld;
  auto load_a = [hin, h_ld](uint32_t (&a)[4], int m, int k) { frag_a(a, hin, h_ld, m, k); };
  float acc[MT][NT][4];
  zero_sums(acc);
  const bool first_of_last = l == p.n_layers - 1 && n_base == 0;
  for (int k0 = 0; k0 < kp; k0 += kSliceRows, ++slice) {
    // this slice has landed (this thread's copies, then everyone's), and
    // every warp is done with the stage the next copies overwrite
    ph.mark(3);
    cp_async_wait<kRingStages - 2>();
    __syncthreads();
    ph.mark(1);
    if (first_of_last && k0 == 0) start_residual(p, residual, n_rows);
    ws.start_next_slice(p, w);
    ph.mark(2);
    const bf16* st = WeightStream::stage_ptr(p, slice % kRingStages);
    const int w_ld = p.w_ld;
    auto load_b = [st, w_ld, k0, n_base](uint32_t (&bf)[2], int k, int n) {
      frag_b_trans(bf, st, w_ld, k - k0, n - n_base);
    };
    if (active)
      warp_tile_accumulate<MT, NT, 1>(acc, m0, n0, tr, np, k0, min(k0 + kSliceRows, kp), load_a,
                                      load_b);
  }
  ph.mark(3);
  if (active) {
    const long long row0 = static_cast<long long>(blockIdx.x) * tr;
    bf16* hout = act_buf(p, (l + 1) % 2);
    const Epilogue<kSave> store{
        b + p.b_off[l],
        kSave && l < p.n_save ? zs + row0 * p.zs_ld + p.zs_off[l] : nullptr,
        p.zs_ld,
        static_cast<int>(min(static_cast<long long>(tr), n_rows - row0)),
        p.dims[l + 1],
        l == p.n_layers - 1,
        p.approx_gelu != 0,
        hout,
        h_ld,
        p.z_ld};
    store(acc, m0, n0, np);
  }
  ph.mark(4);
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

// Starts the copies of the x tile (when bf16 and 16-byte aligned, into the
// first activation buffer) and of the first slices of the weights;
// converts x otherwise; zeroes the columns up to the first fragment edge
// and the rows past the end of the last tile (finite, and never stored).
template <typename IO>
__device__ __forceinline__ void start_tile(const FFParams& p, const IO* __restrict__ x,
                                           const bf16* __restrict__ w, long long n_rows,
                                           WeightStream& ws) {
  const int tr = p.tile_rows;
  const int c_in = p.dims[0];
  const long long row0 = static_cast<long long>(blockIdx.x) * tr;
  const int rows = static_cast<int>(min(static_cast<long long>(tr), n_rows - row0));
  bf16* h0 = act_buf(p, 0);
  const IO* xg = x + row0 * c_in;
  bool x_async = false;
  if constexpr (std::is_same<IO, bf16>::value) {
    x_async = c_in % 8 == 0 && (reinterpret_cast<uintptr_t>(xg) & 15u) == 0;
    if (x_async) {
      const int per_row = c_in / 8;
      for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
        const int r = i / per_row, q = i - r * per_row;
        cp_async_16(h0 + r * p.h_ld + q * 8, xg + r * c_in + q * 8);
      }
    }
  }
  for (int s = 0; s < kRingStages - 1; ++s) ws.start_next_slice(p, w);
  if (!x_async) load_rows(h0, p.h_ld, xg, rows, c_in);
  const int kp0 = pad16(c_in);
  if (rows < tr || c_in < kp0) {
    for (int idx = threadIdx.x; idx < tr * kp0; idx += blockDim.x) {
      const int r = idx / kp0, c = idx - r * kp0;
      if (r >= rows || c >= c_in) h0[r * p.h_ld + c] = __float2bfloat16_rn(0.f);
    }
  }
}

// LayerNorm (two-pass mean and variance in f32) of the last layer's sums
// and the residual, one warp a row, two neighbouring columns a lane where
// the types' alignment allows; the residual from shared memory where it
// was copied there.
template <typename IO>
__device__ __forceinline__ void finish_tile(const FFParams& p, const IO* __restrict__ residual,
                                            IO* __restrict__ out, const float* __restrict__ ln_s,
                                            const float* __restrict__ ln_b, long long n_rows) {
  const int tr = p.tile_rows;
  const int c_out = p.dims[p.n_layers];
  const long long row0 = static_cast<long long>(blockIdx.x) * tr;
  const int rows = static_cast<int>(min(static_cast<long long>(tr), n_rows - row0));
  const float* zf = reinterpret_cast<const float*>(act_buf(p, p.n_layers % 2));
  const bool res_async =
      residual_async(residual != nullptr ? residual + row0 * c_out : nullptr, rows * c_out);
  const IO* res_s = reinterpret_cast<const IO*>(k1f_smem + p.res_off);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  const bool pairs = c_out % 2 == 0 &&
                     (residual == nullptr ||
                      (reinterpret_cast<uintptr_t>(residual) & (2 * sizeof(IO) - 1)) == 0);
  if (pairs && c_out <= 64) {
    // a lane's one pair of columns (c, c + 1), its LayerNorm parameters
    // loaded once for all of the warp's rows
    const int c = 2 * lane;
    const bool on = c < c_out;
    float2 ls = make_float2(1.f, 1.f), lb = make_float2(0.f, 0.f);
    if (ln_s != nullptr && on) {
      ls = make_float2(__ldg(ln_s + c), __ldg(ln_s + c + 1));
      lb = make_float2(__ldg(ln_b + c), __ldg(ln_b + c + 1));
    }
#pragma unroll 2
    for (int r = warp; r < rows; r += n_warps) {
      const float2 zz = on ? load_pair(zf + r * p.z_ld + c) : make_float2(0.f, 0.f);
      float y0 = zz.x, y1 = zz.y;
      if (ln_s != nullptr) {
        const float mu = warp_sum(y0 + y1) / c_out;
        const float d0 = on ? y0 - mu : 0.f, d1 = on ? y1 - mu : 0.f;
        const float rstd = rsqrtf(warp_sum(d0 * d0 + d1 * d1) / c_out + kLnEps);
        y0 = d0 * rstd * ls.x + lb.x;
        y1 = d1 * rstd * ls.y + lb.y;
      }
      const long long base = (row0 + r) * c_out;
      if (on) {
        if (residual != nullptr) {
          const float2 rr =
              res_async ? load_pair(res_s + r * c_out + c) : load_pair(residual + base + c);
          y0 += rr.x;
          y1 += rr.y;
        }
        store_pair(out + base + c, y0, y1);
      }
    }
    return;
  }
  for (int r = warp; r < rows; r += n_warps) {
    const float* z = zf + r * p.z_ld;
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
    auto finish = [&](int c, float y) {
      if (ln_s != nullptr) y = (y - mu) * rstd * __ldg(ln_s + c) + __ldg(ln_b + c);
      return y;
    };
    if (pairs) {
      for (int c = 2 * lane; c < c_out; c += 64) {
        const float2 zz = load_pair(z + c);
        float y0 = finish(c, zz.x), y1 = finish(c + 1, zz.y);
        if (residual != nullptr) {
          const float2 rr =
              res_async ? load_pair(res_s + r * c_out + c) : load_pair(residual + base + c);
          y0 += rr.x;
          y1 += rr.y;
        }
        store_pair(out + base + c, y0, y1);
      }
    } else {
      for (int c = lane; c < c_out; c += 32) {
        float y = finish(c, z[c]);
        if (residual != nullptr)
          y += to_f(res_async ? res_s[r * c_out + c] : residual[base + c]);
        out[base + c] = from_f<IO>(y);
      }
    }
  }
}

// kSave as for the f32 kernel; kThin: a 16-row tile, whose narrow layers
// take the thin warp tiles, compiled in only for the chains that need it,
// so that every other chain's kernel is the one without it. Two blocks an
// SM where the shared memory allows (128 registers a thread).
template <typename IO, bool kSave, bool kThin>
__global__ void __launch_bounds__(kFwdThreads, 2)
fused_ff_fwd_mma_kernel(const IO* __restrict__ x, const IO* __restrict__ residual,
                        IO* __restrict__ out, bf16* __restrict__ zs, const bf16* __restrict__ w,
                        const float* __restrict__ b, const float* __restrict__ ln_s,
                        const float* __restrict__ ln_b, long long n_rows, FFParams p) {
  Phases ph;
  WeightStream ws;
  start_tile(p, x, w, n_rows, ws);
  ph.mark(0);
  int slice = 0;
  for (int l = 0; l < p.n_layers; ++l) {
    for (int n_base = 0; n_base < pad16(p.dims[l + 1]); n_base += p.pass_cols[l]) {
      if (p.wide[l])
        layer_pass<kWideM, kWideN, kSave>(p, l, n_base, w, b, zs, residual, n_rows, ws, slice,
                                          ph);
      else
        layer_pass<kThin ? kThinM : kNarrowM, kNarrowN, kSave>(p, l, n_base, w, b, zs, residual,
                                                               n_rows, ws, slice, ph);
    }
  }
  // the residual's copies too (empty groups are all that may be left)
  cp_async_wait<0>();
  __syncthreads();
  ph.mark(1);
  finish_tile(p, residual, out, ln_s, ln_b, n_rows);
  ph.mark(5);
  ph.flush();
}

// f32 (CUDA cores): every layer on f32_tile_gemm (fused_ff.cuh)

constexpr int kF32FwdThreads = 512;  // f32_tile_gemm_threads(64, 256)
constexpr int kF32MinTileRows = 8;   // f32_tile_gemm's register tiles read 8 rows

// kSave as for fused_ff_fwd_kernel; kChunks: f32_tile_gemm's column
// chunks, compiled in only for chains wider than kF32ChunkCols. The dynamic
// shared memory: activation buffers 0 and 1, (tile_rows, h_ld) f32 each,
// then f32_tile_gemm's ring. Layer l reads buffer l % 2 and writes the
// other: GELU(z) of the hidden layers, z of the last one.
template <typename IO, bool kSave, bool kChunks>
__global__ void __launch_bounds__(kF32FwdThreads, 1)
fused_ff_fwd_f32_kernel(const IO* __restrict__ x, const IO* __restrict__ residual,
                        IO* __restrict__ out, float* __restrict__ zs, const float* __restrict__ w,
                        const float* __restrict__ b, const float* __restrict__ ln_s,
                        const float* __restrict__ ln_b, long long n_rows, FFParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  F32Phases ph;
  const int tr = p.tile_rows;  // a multiple of 8, so every buffer is 16-byte aligned
  const int ld = p.h_ld;
  float* buf0 = reinterpret_cast<float*>(smem);
  float* buf1 = buf0 + tr * ld;
  float* ring = buf1 + tr * ld;
  const long long row0 = static_cast<long long>(blockIdx.x) * tr;
  const int rows = static_cast<int>(min(static_cast<long long>(tr), n_rows - row0));
  const int L = p.n_layers;
  const int c_in = p.dims[0];
  const int c_out = p.dims[L];
  const bool approx = p.approx_gelu != 0;

  // the rows past the end of the last tile, which the products read up to
  // the next multiple of 8 and never store, and x's columns up to the next
  // multiple of 4: zero
  if (rows < tr)
    for (int i = threadIdx.x; i < (tr - rows) * ld; i += blockDim.x)
      buf0[rows * ld + i] = buf1[rows * ld + i] = 0.f;
  const int kp0 = pad4(c_in);
  if (kp0 > c_in)
    for (int i = threadIdx.x; i < rows * (kp0 - c_in); i += blockDim.x) {
      const int r = i / (kp0 - c_in);
      buf0[r * ld + c_in + i - r * (kp0 - c_in)] = 0.f;
    }
  // the x tile (by 16-byte copies where f32 and aligned, else converted
  // through registers) and layer 0's first weight slice, one group
  const IO* xg = x + row0 * c_in;
  bool x_async = false;
  if constexpr (std::is_same<IO, float>::value) {
    x_async = c_in % 4 == 0 && (reinterpret_cast<uintptr_t>(xg) & 15u) == 0;
    if (x_async) {
      const int per_row = c_in / 4;
      for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
        const int r = i / per_row, q = i - r * per_row;
        cp_async_16(buf0 + r * ld + 4 * q, xg + r * c_in + 4 * q);
      }
    }
  }
  if (!x_async) load_rows(buf0, ld, xg, rows, c_in);
  f32_start_first_slice<kChunks>(ring, w, kp0, pad4(p.dims[1]));
  ph.mark(0);

  const IO* res_g = residual != nullptr ? residual + row0 * c_out : nullptr;
  const bool res_async = residual_async(res_g, rows * c_out);
  for (int l = 0; l < L; ++l) {
    const int N = p.dims[l + 1];
    const int np = pad4(N);
    const bool last = l == L - 1;
    float* hin = l % 2 ? buf1 : buf0;
    float* hout = l % 2 ? buf0 : buf1;
    const float* bl = b + p.b_off[l];
    float* zl = kSave && l < p.n_save ? zs + row0 * p.zs_ld + p.zs_off[l] : nullptr;
    const int zs_ld = p.zs_ld;
    // once every thread is done with the ring and this layer's input: the
    // next layer's first slice, or after the last layer the residual tile
    // into the input buffer, copied while the epilogue runs
    const float* w_next = last ? nullptr : w + p.w_off[l + 1];
    const int np_next = last ? 0 : pad4(p.dims[l + 2]);
    auto then = [=]() {
      if (!last) {
        f32_start_first_slice<kChunks>(ring, w_next, np, np_next);
      } else if (res_async) {
        const int pieces = rows * c_out * static_cast<int>(sizeof(IO)) / 16;
        for (int i = threadIdx.x; i < pieces; i += blockDim.x)
          cp_async_16(reinterpret_cast<char*>(hin) + 16 * i,
                      reinterpret_cast<const char*>(res_g) + 16 * i);
        cp_async_commit();
      }
    };
    // z = the sum plus the bias (to zs where saved); GELU(z), or the last
    // layer's z, into the other buffer, 16 bytes a store, zeros in the
    // columns from N to the next multiple of 4 (the next layer's padded
    // contraction reads them)
    f32_tile_gemm<kChunks>(rows, pad4(p.dims[l]), np, hin, ld, w + p.w_off[l], ring, true,
                  [=](int r, int j0, const float (&v)[4]) {
                    float h[4];
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                      const int j = j0 + q;
                      h[q] = 0.f;
                      if (j < N) {
                        const float z = v[q] + __ldg(bl + j);
                        if (kSave && zl != nullptr) zl[r * zs_ld + j] = z;
                        h[q] = last ? z : gelu_call(z, approx);
                      }
                    }
                    *reinterpret_cast<float4*>(hout + r * ld + j0) =
                        make_float4(h[0], h[1], h[2], h[3]);
                  },
                  then);
    ph.mark(l == 0 ? 1 : last ? 3 : 2);
  }
  // the residual's copies (every other group is done), and the last
  // layer's sums
  cp_async_wait<0>();
  __syncthreads();

  // LayerNorm (two-pass mean and variance in f32) and the residual, one
  // warp a row
  const float* zf = L % 2 ? buf1 : buf0;
  const IO* res_s = reinterpret_cast<const IO*>((L - 1) % 2 ? buf1 : buf0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  for (int r = warp; r < rows; r += n_warps) {
    const float* z = zf + r * ld;
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
      if (ln_s != nullptr) y = (y - mu) * rstd * __ldg(ln_s + c) + __ldg(ln_b + c);
      if (residual != nullptr) y += to_f(res_async ? res_s[r * c_out + c] : residual[base + c]);
      out[base + c] = from_f<IO>(y);
    }
  }
  ph.mark(4);
  ph.flush();
}

template <typename CD, typename IO>
cudaError_t launch(const void* x, const void* residual, void* out, void* zs, const void* w,
                   const float* b, const float* ln_s, const float* ln_b, long long n_rows,
                   const FFParams& p, size_t smem, int route, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<CD, bf16>::value;
  const bool chunks = pad4(p.max_dim) > kF32ChunkCols;
  auto kernel = [&]() {
    if constexpr (kBf16) {
      if (p.tile_rows < 16 * kNarrowM)
        return zs != nullptr ? fused_ff_fwd_mma_kernel<IO, true, true>
                             : fused_ff_fwd_mma_kernel<IO, false, true>;
      return zs != nullptr ? fused_ff_fwd_mma_kernel<IO, true, false>
                           : fused_ff_fwd_mma_kernel<IO, false, false>;
    }
    else if (route == kRouteF32Tiles && chunks)
      return zs != nullptr ? fused_ff_fwd_f32_kernel<IO, true, true>
                           : fused_ff_fwd_f32_kernel<IO, false, true>;
    else if (route == kRouteF32Tiles)
      return zs != nullptr ? fused_ff_fwd_f32_kernel<IO, true, false>
                           : fused_ff_fwd_f32_kernel<IO, false, false>;
    else
      return zs != nullptr ? fused_ff_fwd_kernel<IO, true> : fused_ff_fwd_kernel<IO, false>;
  }();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = (n_rows + p.tile_rows - 1) / p.tile_rows;
  const int threads = kBf16 ? kFwdThreads : route == kRouteF32Tiles ? kF32FwdThreads : kThreads;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      static_cast<const IO*>(x), static_cast<const IO*>(residual), static_cast<IO*>(out),
      static_cast<CD*>(zs), static_cast<const CD*>(w), b, ln_s, ln_b, n_rows, p);
  return cudaGetLastError();
}

// Fills the layout of p from its widths: offsets, the tile of rows and, in
// bf16, the buffers, the ring, the residual tile (io_size bytes an
// element) and each layer's warp tiles; the dynamic shared memory in smem.
// Returns the route (FwdRoute): in bf16 the tensor-core kernel with the
// tallest tile of 64, 32 or 16 rows that fits; in f32 the f32_tile_gemm
// kernel wherever 8 rows of both its buffers fit beside the ring, else
// fused_ff_fwd_kernel; kNoRoute if no tile fits. The launcher's Python
// mirror (forward_tile_rows, ops/kernels/fused_ff.py) refuses such a chain
// before any launch.
int plan(FFParams& p, bool bf16_cd, size_t io_size, bool has_residual, size_t& smem) {
  const int L = p.n_layers;
  long long w_off = 0;
  int b_off = 0;
  for (int l = 0; l <= L; ++l) {
    p.max_dim = std::max(p.max_dim, p.dims[l]);
    if (l < L) {
      p.w_off[l] = w_off;
      p.b_off[l] = b_off;
      w_off += bf16_cd ? static_cast<long long>(pad16(p.dims[l])) * pad16(p.dims[l + 1])
                       : static_cast<long long>(pad4(p.dims[l])) * pad4(p.dims[l + 1]);
      b_off += p.dims[l + 1];
    }
  }
  const int c_out = p.dims[L];
  if (!bf16_cd) {
    // f32_tile_gemm: rows of 4 mod 32 floats, so that the rows a warp's A
    // loads read (one apart) fall in other banks; the ring as wide as the
    // widest layer's first column chunk; the tallest tile that fits
    const int widest = pad4(p.max_dim);
    p.h_ld = (widest + 27) / 32 * 32 + 4;
    const size_t ring =
        static_cast<size_t>(f32_ring_floats(widest, kF32FwdThreads)) * sizeof(float);
    for (int tr = kMaxTileRows; tr >= kF32MinTileRows; tr /= 2) {
      smem = 2 * static_cast<size_t>(tr) * p.h_ld * sizeof(float) + ring;
      if (smem <= static_cast<size_t>(kMaxSmem) &&
          f32_tile_gemm_threads(tr, f32_chunk_cols(widest)) <= kF32FwdThreads) {
        p.tile_rows = tr;
        return kRouteF32Tiles;
      }
    }
    // too wide for that: fused_ff_fwd_kernel, the largest tile of rows whose
    // buffers fit its shared-memory budget
    for (int tr = kMaxTileRows; tr >= 1; tr /= 2) {
      smem = (2 * static_cast<size_t>(tr) * p.max_dim + static_cast<size_t>(tr) * c_out) *
             sizeof(float);
      if (smem <= static_cast<size_t>(kSmemBudget)) {
        p.tile_rows = tr;
        return kRouteF32Wide;
      }
    }
    return kNoRoute;
  }
  // bf16 rows padded to whole fragments plus 8 columns, so that the 8 rows
  // an ldmatrix reads fall in 8 different 16-byte bank groups; the f32
  // rows of the last layer's sums by 8 (mod 32 banks: 8 or 24), against
  // conflicts in the epilogue's stores
  p.h_ld = pad16(p.max_dim) + 8;
  p.z_ld = pad16(c_out) + 8;
  for (int tr = kMaxTileRows; tr >= kMinTileRows; tr /= 2) {
    int stage_rows = 0;  // columns of the widest pass
    // the narrow tiles' height: 32 rows, or 16 in a 16-row tile
    const int mt = tr >= 16 * kNarrowM ? kNarrowM : kThinM;
    for (int l = 0; l < L; ++l) {
      const int np = pad16(p.dims[l + 1]);
      // wide tiles for a layer that fills a pass of them (a warp a tile
      // across the columns), else narrow (or thin) ones, tr / (16 mt) down
      p.wide[l] = tr == 64 && np >= kFwdWarps * 8 * kWideN;
      p.pass_cols[l] = p.wide[l] ? kFwdWarps * 8 * kWideN
                                 : kFwdWarps / (tr / (16 * mt)) * 8 * kNarrowN;
      stage_rows = std::max(stage_rows, std::min(p.pass_cols[l], np));
    }
    // a buffer holds a tile of bf16 activations, or the last layer's f32
    // sums followed by the residual tile
    const size_t z_bytes = static_cast<size_t>(tr) * p.z_ld * sizeof(float);
    const size_t res = has_residual ? static_cast<size_t>(tr) * c_out * io_size : 0;
    const size_t buf =
        (std::max(static_cast<size_t>(tr) * p.h_ld * sizeof(bf16), z_bytes + res) + 15) / 16 * 16;
    // a stage row: the widest pass, plus 8 columns against bank conflicts
    // in ldmatrix.trans
    p.w_ld = stage_rows + 8;
    p.stage_elems = kSliceRows * p.w_ld;
    const size_t ring = static_cast<size_t>(kRingStages) * p.stage_elems * sizeof(bf16);
    p.res_off = static_cast<int>((L % 2) * buf + z_bytes);
    smem = 2 * buf + ring;
    if (smem <= static_cast<size_t>(kMaxSmem)) {
      p.tile_rows = tr;
      p.buf_bytes = static_cast<int>(buf);
      return kRouteMma;
    }
  }
  return kNoRoute;
}

}  // namespace
}  // namespace rpde

// x, residual, out: (n_rows, dims[0]) and (n_rows, dims[n_layers]) row-major
// in the io type; b: the biases packed in f32; ln_s, ln_b: (dims[n_layers],)
// f32, both null for no LayerNorm; residual may be null. w: every layer's
// (dims[l], dims[l+1]) kernel row-major, packed one after another, each
// zero-padded to multiples of 16 (bf16) or 4 (f32) in both dimensions, and
// w 16-byte aligned. zs, if not null: (n_rows, dims[1] + ... + dims[n_save])
// in the compute type, receiving the pre-activations of the first n_save layers
// (n_save = n_layers with LayerNorm, n_layers - 1 without). Returns a
// cudaError_t.
extern "C" int rpde_fused_ff_forward(int cd_bf16, int io_bf16, const void* x,
                                     const void* residual, void* out, void* zs,
                                     const void* w,
                                     const float* b, const float* ln_s,
                                     const float* ln_b, const int* dims, int n_layers,
                                     long long n_rows, int approx_gelu, void* stream) {
  using namespace rpde;
  if (n_layers < 1 || n_layers > kMaxLayers || n_rows < 1 || (ln_s == nullptr) != (ln_b == nullptr))
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(w) & 15u) != 0) return cudaErrorMisalignedAddress;
  FFParams p{};
  p.n_layers = n_layers;
  p.approx_gelu = approx_gelu;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1) return cudaErrorInvalidValue;
    p.dims[l] = dims[l];
  }
  size_t smem = 0;
  const int route =
      plan(p, cd_bf16 != 0, io_bf16 ? sizeof(bf16) : sizeof(float), residual != nullptr, smem);
  if (route == kNoRoute) return cudaErrorInvalidValue;
  if (zs != nullptr) {
    p.n_save = ln_s != nullptr ? n_layers : n_layers - 1;
    for (int l = 0; l < p.n_save; ++l) {
      p.zs_off[l] = p.zs_ld;
      p.zs_ld += dims[l + 1];
    }
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (cd_bf16 && io_bf16)
    return launch<bf16, bf16>(x, residual, out, zs, w, b, ln_s, ln_b, n_rows, p, smem, route, s);
  if (cd_bf16)
    return launch<bf16, float>(x, residual, out, zs, w, b, ln_s, ln_b, n_rows, p, smem, route, s);
  if (io_bf16)
    return launch<float, bf16>(x, residual, out, zs, w, b, ln_s, ln_b, n_rows, p, smem, route, s);
  return launch<float, float>(x, residual, out, zs, w, b, ln_s, ln_b, n_rows, p, smem, route, s);
}

// The kernel the forward runs a chain on (its arguments as
// rpde_fused_ff_forward's): 1 the tensor-core kernel (bf16), 2 the f32
// kernel on f32_tile_gemm, 3 fused_ff_fwd_kernel (chains too wide for 2), 0
// none; its tile of rows in tile_rows.
extern "C" int rpde_fused_ff_forward_route(int cd_bf16, int io_bf16, int has_residual,
                                           const int* dims, int n_layers, int* tile_rows) {
  using namespace rpde;
  *tile_rows = 0;
  if (n_layers < 1 || n_layers > kMaxLayers) return kNoRoute;
  FFParams p{};
  p.n_layers = n_layers;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1) return kNoRoute;
    p.dims[l] = dims[l];
  }
  size_t smem = 0;
  const int route = plan(p, cd_bf16 != 0, io_bf16 ? sizeof(bf16) : sizeof(float),
                         has_residual != 0, smem);
  *tile_rows = route == kNoRoute ? 0 : p.tile_rows;
  return route;
}

#ifdef RPDE_K1F_PHASES
// Copies the phase counters into out (kPhases of them), or with reset sets
// them to 0. Returns a cudaError_t.
extern "C" int rpde_k1f_phase_cycles(unsigned long long* out, int reset) {
  unsigned long long zero[rpde::kPhases] = {};
  if (reset) return cudaMemcpyToSymbol(rpde::k1f_phase_cycles, zero, sizeof(zero));
  return cudaMemcpyFromSymbol(out, rpde::k1f_phase_cycles, sizeof(zero));
}

// The same for the f32 kernel (kF32Phases counters).
extern "C" int rpde_k1f_f32_phase_cycles(unsigned long long* out, int reset) {
  unsigned long long zero[rpde::kF32Phases] = {};
  if (reset) return cudaMemcpyToSymbol(rpde::k1f_f32_phase_cycles, zero, sizeof(zero));
  return cudaMemcpyFromSymbol(out, rpde::k1f_f32_phase_cycles, sizeof(zero));
}
#endif
