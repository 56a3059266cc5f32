// The whole-encoder kernel pair B10 for Hopper (sm_90a): N pre-norm blocks
// (the attention sublayer B1, then the FFN sublayer B2) and the final
// unbiased-std LayerNorm, forward in one cooperative launch and backward in
// one. This header holds what the two dtypes share: the arguments, the
// phase skeleton of both kernels, the final LayerNorm, the split
// reductions, B1's SIMT phases for heads wider than 128, and the launch.
// Each dtype's route (encoder_block_bf16.cuh, encoder_block_f32.cuh) gives
// the tensor-core phases of its chained kernels; one source a dtype and
// head class (encoder_block_{bf16,f32}_{dk32,dk64,dk128,simt}.cu)
// instantiates the kernels, so that nvcc builds the eight in parallel.
//
// Replaces the TPU kernel `encoder_forward` of the JAX package's
// ops/encoder_block.py: forward pallas_call at line 302 (_fwd_kernel, lines
// 88-101), backward pallas_call at line 333 (_bwd_kernel, lines 121-197).
//
// What bounds it: the products. At the flagship shape (B=64, L=240, d=128,
// h=4, d_ff=512, N=4) the forward does about 31.7 GFLOP and the backward
// about 79 GFLOP (each product of the function counted once), against some
// 8 MB of activations and 4 MB of weights in and out: bound by operations,
// 0.19 / 0.48 ms at a third of the card's 495 TFLOP/s TF32 rate (3xTF32,
// fp32) and 0.032 / 0.080 ms at its 989 TFLOP/s bf16 rate.
//
// What the design does about it:
//  * Each direction is one cooperative persistent kernel of 8-warp blocks:
//    a grid as large as can be co-resident walks the tiles of one of the
//    chained kernels per phase, `for (t = blockIdx.x; t < tiles; t +=
//    gridDim.x)`, and grid.sync() separates each pair of kernels that the
//    chained route launches in turn. The tile bodies are the chained
//    kernels' own (b1_*_tiles.cuh, b2_*_tiles.cuh): the tensor cores in
//    bf16 (mma.sync) and in fp32 (3xTF32), B1's SIMT bodies
//    (sublayer_tiles.cuh) where a head is wider than 128, as B1's route.
//    With the same bodies, split counts and dropout keys (dropout.cuh:
//    masks keyed on the global element index) B10 gives the chained
//    kernels' bits up to the final LayerNorm.
//  * One block shape: 256 threads, the shared memory of the largest phase
//    (B2's fp32 backward rows, some 206 KB at d = 128, one block an SM).
//    Bodies written for fewer warps run at 8 where they fit (bf16 dQ: 128
//    queries a tile; the A^T B products: 64 x 128 tiles), else on the
//    first warps with a named barrier (the fp32 attention at d_k > 32),
//    the other warps waiting at the phase's end.
//  * The phases are __noinline__ functions (each sublayer's phases of one
//    direction one function): each body is compiled once a source, not
//    once for each kernel that runs it. Inside a phase the arguments are
//    made opaque at each tile (fresh), so that nothing derived from them is
//    hoisted out of the tile loop (to stay live through every tile body)
//    or splits it into copies. Heads of whole 16-byte rows only (the
//    chained kernels' element-wise staging is not instantiated): the build
//    stays within the smoke run's budget.
//  * The forward under autograd parks the 2N sublayer inputs, each block's
//    qkv and its softmax row statistics, which the chained route keeps in
//    device memory too; the backward then starts at the final LayerNorm's
//    backward. Called without them (the JAX signature) it replays the
//    forward's own phase loop into the same buffers first, as the TPU
//    kernel does. Without autograd the forward parks nothing (two
//    ping-pong stream buffers and one qkv).
//  * Backward, per block in reverse: the FFN's rows (beside the reductions
//    of the block above's attention gradients), its split weight-gradient
//    products, their fixed-order reductions beside the attention's rows,
//    dQ, dK/dV, then dn + the LN backward beside the attention's products.
//    Every gradient slot is written once by a fixed-order sum: no atomics,
//    two backwards give the same bits.
#pragma once

#include <cooperative_groups.h>

#include <algorithm>

#include "attention_mma.cuh"
#include "backward.cuh"
#include "common.cuh"
#include "dropout.cuh"
#include "sublayer_tiles.cuh"

namespace allrank {
namespace {

namespace cg = cooperative_groups;

// the 12 stacked per-block parameters, in the JAX package's
// STACKED_PER_BLOCK order (ops/encoder_block.py:64-67 there)
enum Stacked {
  kLn1S, kLn1B, kWqkv, kBqkv, kWout, kBout,
  kLn2S, kLn2B, kW1, kB1, kW2, kB2, kStacked
};

// the most blocks a launch takes: their dropout keys ride in the launch's
// parameters (no copy to the device, which would stall the host)
constexpr int kMaxBlocks = 16;
// B10's block: 8 warps, the LN backward's kThreads
constexpr int kEncThreads = 256;
static_assert(kEncThreads == kThreads, "the LN backward's block");

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// elements of one block's slot of stacked parameter i
__device__ inline size_t stacked_size(int i, int d, int d_ff) {
  switch (i) {
    case kWqkv: return (size_t)d * 3 * d;
    case kBqkv: return (size_t)3 * d;
    case kWout: return (size_t)d * d;
    case kW1: return (size_t)d * d_ff;
    case kB1: return (size_t)d_ff;
    case kW2: return (size_t)d_ff * d;
    default: return (size_t)d;
  }
}

struct EncoderArgs {
  const void* x;                  // [B, L, d]
  const unsigned char* key_mask;  // [B, L], non-zero at padded documents
  const float* w[kStacked];       // [N, ...] fp32
  const float *fs, *fb;           // final LN [d]
  unsigned keys[kMaxBlocks * 4 * 3];  // {k0, k1, threshold} per stream
  int drop_on;
  float denom, inv;
  int park;    // the forward keeps the sublayer inputs, qkv and stats
  int replay;  // the backward replays the forward first (nothing parked)
  int aligned;  // every buffer starts on a 16-byte boundary
  void* y;      // forward output [B, L, d]
  void* xs;     // parked [2N, M, d] sublayer inputs; else [2, M, d]
  void* qkv;    // parked [N, M, 3d]; else [M, 3d]
  float* stats;  // parked [N, B, h, L, 2]; else null
  void* ctx;     // [M, d]: the fp32 forward's attention core, the dQ pass
  void *w1b, *w2b;  // bf16 [N, dpad, ffp], [N, ffp, dpad]: rounded W1, W2
  const void* dy;
  void* dx;
  float* g[kStacked];  // gradients of w, [N, ...] fp32
  float *dfs, *dfb;
  void *gz0, *gz1;  // [M, d] gradients along the residual stream
  void *da, *dO, *n_act_a, *dqkv;
  float* D;
  void *n_act_f, *dout, *hidden, *dh;
  float *part_qkv, *part_out, *part_ln_a, *part_1, *part_2, *part_ln_f,
      *part_fln;
  int batch, L, d, h, d_ff, n_blocks;
  int s_qkv, s_out, s_1, s_2;
  float scale;
};

// the parameters (or, for `g`, the gradients) of block n
struct BlockPtrs {
  float* p[kStacked];
};

__device__ inline BlockPtrs block_ptrs(const float* const* base, int n,
                                       int d, int d_ff) {
  BlockPtrs b;
  for (int i = 0; i < kStacked; ++i)
    b.p[i] = const_cast<float*>(base[i]) + (size_t)n * stacked_size(i, d, d_ff);
  return b;
}

__device__ inline DropStream drop_at(const EncoderArgs& a, int i) {
  DropStream s;
  s.k0 = a.keys[3 * i];
  s.k1 = a.keys[3 * i + 1];
  s.threshold = a.keys[3 * i + 2];
  s.on = a.drop_on;
  s.denom = a.denom;
  s.inv = a.inv;
  return s;
}

// This block's first tile of a job whose tiles follow `first` others of
// its phase, in the phase's order t = blockIdx.x, + gridDim.x, ...: the
// jobs of one phase share the grid as one range of tiles.
__device__ inline int first_tile(int first) {
  int t = blockIdx.x;
  if (t < first) t += (first - t + gridDim.x - 1) / gridDim.x * gridDim.x;
  return t - first;
}

// The arguments as one tile sees them: opaque to the compiler, so that
// nothing derived from them is hoisted out of a phase's tile loop (where it
// would stay live through every tile body, whose products need every
// register) and no flag among them splits the loop into copies.
__device__ __forceinline__ const EncoderArgs& fresh(const EncoderArgs& a) {
  const EncoderArgs* p = &a;
  asm volatile("" : "+l"(p));
  return *p;
}

// the tiles i < n of a job after `first` others
#define FOR_TILES(i, first, n) \
  for (int i = first_tile(first); i < (n); i += gridDim.x)

// the same, each tile seeing the arguments `args` as `a`, fresh
#define FOR_TILES_OF(i, first, n, args, a)                  \
  for (int i = first_tile(first); i < (n); i += gridDim.x) \
    if (const EncoderArgs& a = fresh(args); true)

// the phases' dynamic shared memory
__device__ inline unsigned char* enc_smem() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return smem_raw;
}

// The buffers of block n, from the arguments alone: a phase computes its
// pointers itself, so that the kernel keeps no state live across the
// phases' calls (what it keeps, the calls' convention spills).

// S(k): the input of sublayer k (2n block n's attention, 2n + 1 its FFN),
// S(2N) the final LayerNorm's. Parked, xs holds S(1) .. S(2N); else two
// buffers take the attention's outputs and the FFN's in turn.
template <class T>
__device__ __forceinline__ T* sublayer_in(const EncoderArgs& a, int k) {
  const size_t md = (size_t)a.batch * a.L * a.d;
  if (k == 0) return const_cast<T*>(static_cast<const T*>(a.x));
  return static_cast<T*>(a.xs) + (a.park ? k - 1 : (k - 1) % 2) * md;
}

template <class T>
__device__ __forceinline__ T* qkv_at(const EncoderArgs& a, int n) {
  return static_cast<T*>(a.qkv) +
         (a.park ? (size_t)n * a.batch * a.L * 3 * a.d : 0);
}

__device__ __forceinline__ float* stats_at(const EncoderArgs& a, int n) {
  return a.park ? a.stats + (size_t)n * a.batch * a.h * a.L * 2 : nullptr;
}

// the gradients along the residual stream: gz0 at block n's output
// S(2n + 2), gz1 at its FFN's input S(2n + 1); the attention backward
// writes the gradient at S(2n) into gz0 (block 0: dx)
template <class T>
__device__ __forceinline__ T* grad_out(const EncoderArgs& a) {
  return static_cast<T*>(a.gz0);
}
template <class T>
__device__ __forceinline__ T* grad_mid(const EncoderArgs& a) {
  return static_cast<T*>(a.gz1);
}
template <class T>
__device__ __forceinline__ T* grad_in(const EncoderArgs& a, int n) {
  return static_cast<T*>(n == 0 ? a.dx : a.gz0);
}

// ---------------------------------------------------------------------------
// the final LayerNorm

// y = round(LN(z)) for the rows of m_tile, one warp per row.
template <class T>
__device__ void final_ln_tile(const T* z, const float* __restrict__ fs,
                              const float* __restrict__ fb, T* y, int M, int d,
                              int m_tile) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = m_tile * kTile, rows = min(kTile, M - m0);
  for (int r = warp; r < rows; r += kThreads / 32) {
    const T* zr = z + (size_t)(m0 + r) * d;
    float mu, var;
    row_moments(zr, d, mu, var);
    const float denom = sqrtf(fmaxf(var, kVarFloor)) + kLnEps;
    for (int k = lane; k < d; k += 32)
      y[(size_t)(m0 + r) * d + k] =
          from_float<T>(fs[k] * ((to_float(zr[k]) - mu) / denom) + fb[k]);
  }
}

__host__ __device__ constexpr int final_ln_bwd_smem_floats(int d) {
  return 2 * kTile + kTile * (d + 1);
}

// The final LayerNorm's backward (the JAX package's _final_ln_bwd) for the
// rows of m_tile: dz = round(dc - mean(dc)) with no residual, and the
// tile's partial sums of its scale and bias gradients (part row m_tile).
template <class T>
__device__ void final_ln_bwd_tile(float* smem, const T* z, const T* dy,
                                  const float* __restrict__ fs, T* dz,
                                  float* part, int M, int d, int m_tile) {
  float* rmean = smem;         // [kTile]
  float* rden = rmean + kTile;  // [kTile]
  float* Ns = rden + kTile;     // [kTile][d + 1] dy
  const int ldn = d + 1;
  const int m0 = m_tile * kTile, rows = min(kTile, M - m0);
  const size_t o = (size_t)m0 * d;
  for (int e = threadIdx.x; e < rows * d; e += kThreads)
    Ns[(e / d) * ldn + e % d] = to_float(dy[o + e]);
  __syncthreads();
  ln_backward_tile(z + o, static_cast<const T*>(nullptr), dz + o, Ns, ldn,
                   rows, d, fs, part + (size_t)m_tile * 2 * d, rmean, rden);
}

template <class T>
__device__ __noinline__ void final_ln_phase(const EncoderArgs& a) {
  const int M = a.batch * a.L;
  FOR_TILES(t, 0, cdiv(M, kTile))
    final_ln_tile(sublayer_in<T>(a, 2 * a.n_blocks), a.fs, a.fb,
                  static_cast<T*>(a.y), M, a.d, t);
}

template <class T>
__device__ __noinline__ void final_ln_bwd_phase(const EncoderArgs& a) {
  const int M = a.batch * a.L;
  FOR_TILES(t, 0, cdiv(M, kTile)) {
    __syncthreads();
    final_ln_bwd_tile(reinterpret_cast<float*>(enc_smem()),
                      sublayer_in<T>(a, 2 * a.n_blocks),
                      static_cast<const T*>(a.dy), a.fs, grad_out<T>(a),
                      a.part_fln, M, a.d, t);
  }
}

// ---------------------------------------------------------------------------
// the split reductions

// One fixed-order reduction of partial sums (backward.cuh) as tiles.
struct Reduction {
  const float* part;
  int splits;
  float* out0;
  int n0;
  float* out1;
  int n1;
  __device__ int tiles() const { return cdiv(n0 + n1, kThreads); }
};

// The tiles of `count` reductions, after `first` tiles of their phase.
__device__ __forceinline__ void run_reductions(const Reduction* r, int count,
                                               int first) {
  int total = 0;
  for (int i = 0; i < count; ++i) total += r[i].tiles();
  FOR_TILES(t, first, total) {
    int i = 0, u = t;
    while (u >= r[i].tiles()) u -= r[i++].tiles();
    reduce_partials_tile(r[i].part, r[i].splits, r[i].out0, r[i].n0,
                         r[i].out1, r[i].n1, u);
  }
}

// The reductions of block n's attention-sublayer gradients (its LN's
// partial sums one a 64-row tile), after `first` tiles of their phase.
__device__ __noinline__ void attn_reduction_phase(const EncoderArgs& a, int n,
                                                  int first) {
  const int d = a.d, M = a.batch * a.L;
  const BlockPtrs g = block_ptrs(a.g, n, d, a.d_ff);
  const Reduction r[3] = {
      {a.part_qkv, a.s_qkv, g.p[kWqkv], d * 3 * d, g.p[kBqkv], 3 * d},
      {a.part_out, a.s_out, g.p[kWout], d * d, g.p[kBout], d},
      {a.part_ln_a, cdiv(M, kTile), g.p[kLn1S], d, g.p[kLn1B], d}};
  run_reductions(r, 3, first);
}

// The reductions of block n's FFN gradients (its LN's partial sums one a
// tile of ffn_rows rows) and, for the last block, the final LayerNorm's,
// after `first` tiles of their phase.
__device__ __noinline__ void ffn_reduction_phase(const EncoderArgs& a, int n,
                                                 int ffn_rows, int first) {
  const int d = a.d, d_ff = a.d_ff, M = a.batch * a.L;
  const BlockPtrs g = block_ptrs(a.g, n, d, d_ff);
  const Reduction r[4] = {
      {a.part_1, a.s_1, g.p[kW1], d * d_ff, g.p[kB1], d_ff},
      {a.part_2, a.s_2, g.p[kW2], d_ff * d, g.p[kB2], d},
      {a.part_ln_f, cdiv(M, ffn_rows), g.p[kLn2S], d, g.p[kLn2B], d},
      {a.part_fln, cdiv(M, kTile), a.dfs, d, a.dfb, d}};
  run_reductions(r, n == a.n_blocks - 1 ? 4 : 3, first);
}

// ---------------------------------------------------------------------------
// B1's SIMT phases (sublayer_tiles.cuh), for heads wider than 128: B1's
// route there in both dtypes

template <class T>
__device__ __forceinline__ void simt_ln_qkv(const EncoderArgs& args, int n) {
  const int row_tiles = cdiv(args.batch * args.L, kTile);
  FOR_TILES_OF(t, 0, row_tiles * cdiv(3 * args.d, kTile), args, a) {
    const BlockPtrs w = block_ptrs(a.w, n, a.d, a.d_ff);
    __syncthreads();
    ln_qkv_tile(reinterpret_cast<float*>(enc_smem()), sublayer_in<T>(a, 2 * n),
                w.p[kLn1S], w.p[kLn1B], w.p[kWqkv], w.p[kBqkv], qkv_at<T>(a, n),
                a.batch * a.L, a.d, t % row_tiles, t / row_tiles);
  }
}

template <class T>
__device__ __forceinline__ void simt_attn_out(const EncoderArgs& args, int n) {
  const int q_tiles = cdiv(args.L, kTile);
  FOR_TILES_OF(t, 0, q_tiles * args.batch, args, a) {
    const BlockPtrs w = block_ptrs(a.w, n, a.d, a.d_ff);
    __syncthreads();
    attn_out_tile(reinterpret_cast<float*>(enc_smem()), qkv_at<T>(a, n),
                  a.key_mask, sublayer_in<T>(a, 2 * n), w.p[kWout], w.p[kBout],
                  sublayer_in<T>(a, 2 * n + 1), stats_at(a, n), a.L, a.d, a.h,
                  a.scale, drop_at(a, 4 * n), drop_at(a, 4 * n + 1),
                  t % q_tiles, t / q_tiles);
  }
}

template <class T>
__device__ __noinline__ void simt_attn_fwd(const EncoderArgs& a, int phase,
                                           int n) {
  if (phase == 0)
    simt_ln_qkv<T>(a, n);
  else
    simt_attn_out<T>(a, n);
}

// the backward's rows: da, dO and LN1(x)
template <class T>
__device__ __forceinline__ void simt_bwd_rows(const EncoderArgs& args, int n) {
  const int row_tiles = cdiv(args.batch * args.L, kTile);
  FOR_TILES_OF(t, 0, row_tiles * cdiv(args.d, kTile), args, a) {
    const BlockPtrs w = block_ptrs(a.w, n, a.d, a.d_ff);
    __syncthreads();
    bwd_rows_tile(reinterpret_cast<float*>(enc_smem()), sublayer_in<T>(a, 2 * n),
                  grad_mid<T>(a), w.p[kLn1S], w.p[kLn1B], w.p[kWout],
                  static_cast<T*>(a.da), static_cast<T*>(a.dO),
                  static_cast<T*>(a.n_act_a), a.batch * a.L, a.d,
                  drop_at(a, 4 * n + 1), t % row_tiles, t / row_tiles);
  }
}

// dQ, ctx and D (kDq), or dK and dV
template <class T, bool kDq>
__device__ __forceinline__ void simt_bwd_attn(const EncoderArgs& args, int n) {
  const int q_tiles = cdiv(args.L, kTile), heads = args.batch * args.h;
  FOR_TILES_OF(t, 0, q_tiles * heads * cdiv(args.d / args.h, kTile), args, a) {
    float* smem = reinterpret_cast<float*>(enc_smem());
    __syncthreads();
    if constexpr (kDq)
      bwd_dq_tile(smem, qkv_at<T>(a, n), a.key_mask, stats_at(a, n),
                  static_cast<T*>(a.dO), static_cast<T*>(a.ctx), a.D,
                  static_cast<T*>(a.dqkv), a.L, a.d, a.h, a.scale,
                  drop_at(a, 4 * n), t % q_tiles, (t / q_tiles) % heads,
                  t / (q_tiles * heads));
    else
      bwd_dkv_tile(smem, qkv_at<T>(a, n), a.key_mask, stats_at(a, n), a.D,
                   static_cast<T*>(a.dO), static_cast<T*>(a.dqkv), a.L, a.d,
                   a.h, a.scale, drop_at(a, 4 * n), t % q_tiles,
                   (t / q_tiles) % heads, t / (q_tiles * heads));
  }
}

// One split weight-gradient product dW = A^T . B (backward.cuh) as tiles,
// after `first` tiles of its phase.
template <class T>
__device__ void simt_products(const T* A, const T* B, float* part, int M,
                              int K, int N, int splits, int first) {
  const int kt = cdiv(K, kTile), nt = cdiv(N, kTile);
  FOR_TILES(t, first, kt * nt * splits) {
    __syncthreads();
    atb_partial_tile(reinterpret_cast<float*>(enc_smem()), A, B, part, M, K,
                     N, split_rows(M, splits), t % kt, (t / kt) % nt,
                     t / (kt * nt));
  }
}

// dn + the LN1 backward (the gradient at S(2n)), beside the attention's
// two weight-gradient products
template <class T>
__device__ __forceinline__ void simt_bwd_ln_qkv(const EncoderArgs& args,
                                                int n) {
  const int row_tiles = cdiv(args.batch * args.L, kTile), d = args.d;
  FOR_TILES_OF(t, 0, row_tiles, args, a) {
    const BlockPtrs w = block_ptrs(a.w, n, a.d, a.d_ff);
    __syncthreads();
    bwd_ln_qkv_tile(reinterpret_cast<float*>(enc_smem()),
                    sublayer_in<T>(a, 2 * n), grad_mid<T>(a),
                    static_cast<const T*>(a.dqkv), w.p[kLn1S], w.p[kWqkv],
                    grad_in<T>(a, n), a.part_ln_a, a.batch * a.L, a.d, t);
  }
  const int M = args.batch * args.L;
  simt_products(static_cast<const T*>(args.n_act_a),
                static_cast<const T*>(args.dqkv), args.part_qkv, M, d, 3 * d,
                args.s_qkv, row_tiles);
  simt_products(static_cast<const T*>(args.ctx),
                static_cast<const T*>(args.da), args.part_out, M, d, d,
                args.s_out,
                row_tiles + cdiv(d, kTile) * cdiv(3 * d, kTile) * args.s_qkv);
}

template <class T>
__device__ __noinline__ void simt_attn_bwd(const EncoderArgs& a, int phase,
                                              int n) {
  switch (phase) {
    case 0: simt_bwd_rows<T>(a, n); break;
    case 1: simt_bwd_attn<T, true>(a, n); break;
    case 2: simt_bwd_attn<T, false>(a, n); break;
    default: simt_bwd_ln_qkv<T>(a, n);
  }
}

__host__ inline size_t simt_smem(int d) {
  return sizeof(float) *
         std::max({ln_qkv_smem_floats(), attn_out_smem_floats(d),
                   bwd_rows_smem_floats(), bwd_attn_smem_floats(),
                   bwd_ln_qkv_smem_floats(d), atb_smem_floats()});
}

// ---------------------------------------------------------------------------
// the kernels' skeleton, over a route R: R::T the activations' type, and
// its phases (the dtype's source), each a function of the arguments and
// the block index alone
//   R::round_weights(a)                     (kRounds: bf16's weights)
//   R::attn_fwd<kDk>(a, phase, n), R::attn_fwd_phases(kDk)
//   R::ffn_fwd<kCs>(a, n), R::ffn_bwd_rows<kCs>(a, n), R::ffn_rows(kCs)
//   R::ffn_products(a)
//   R::attn_bwd<kDk>(a, phase, n), four phases (rows; dQ;
//       dK/dV; dn + LN backward and the products), R::attn_rows_tiles
// kDk 0 takes B1's SIMT phases above.

template <class R, int kDk, int kCs>
__device__ __forceinline__ void forward_blocks(const EncoderArgs& a,
                                               cg::grid_group& grid) {
  for (int n = 0; n < a.n_blocks; ++n) {
    const int phases = kDk == 0 ? 2 : R::attn_fwd_phases(kDk);
    for (int ph = 0; ph < phases; ++ph) {
      if constexpr (kDk == 0)
        simt_attn_fwd<typename R::T>(a, ph, n);
      else
        R::template attn_fwd<kDk>(a, ph, n);
      grid.sync();
    }
    R::template ffn_fwd<kCs>(a, n);
    grid.sync();
  }
}

template <class R, int kDk, int kCs>
__global__ void __launch_bounds__(kEncThreads, 1)
    encoder_fwd_kernel(const __grid_constant__ EncoderArgs a) {
  cg::grid_group grid = cg::this_grid();
  if constexpr (R::kRounds) {
    R::round_weights(a);
    grid.sync();
  }
  forward_blocks<R, kDk, kCs>(a, grid);
  final_ln_phase<typename R::T>(a);
}

template <class R, int kDk, int kCs>
__global__ void __launch_bounds__(kEncThreads, 1)
    encoder_bwd_kernel(const __grid_constant__ EncoderArgs a) {
  cg::grid_group grid = cg::this_grid();
  if constexpr (R::kRounds) {
    R::round_weights(a);
    grid.sync();
  }
  if (a.replay) forward_blocks<R, kDk, kCs>(a, grid);
  final_ln_bwd_phase<typename R::T>(a);
  grid.sync();
  for (int n = a.n_blocks - 1; n >= 0; --n) {
    const int M = a.batch * a.L;
    // the FFN's rows, beside the reductions of block n + 1's attention
    // gradients
    R::template ffn_bwd_rows<kCs>(a, n);
    if (n < a.n_blocks - 1)
      attn_reduction_phase(a, n + 1, cdiv(M, R::ffn_rows(kCs)));
    grid.sync();
    R::ffn_products(a);
    grid.sync();
    // the attention's phases; beside its rows the FFN's reductions (and,
    // for the last block, the final LN's)
    for (int ph = 0; ph < 4; ++ph) {
      if constexpr (kDk == 0)
        simt_attn_bwd<typename R::T>(a, ph, n);
      else
        R::template attn_bwd<kDk>(a, ph, n);
      if (ph == 0)
        ffn_reduction_phase(a, n, R::ffn_rows(kCs),
                            kDk == 0 ? cdiv(M, kTile) * cdiv(a.d, kTile)
                                     : R::attn_rows_tiles(M, a.d));
      grid.sync();
    }
  }
  // block 0's attention-gradient reductions
  attn_reduction_phase(a, 0, 0);
}

// ---------------------------------------------------------------------------
// launches

// The cooperative grid of `kernel` with `smem` bytes of dynamic shared
// memory: {grid, blocks per SM, SMs, smem}. A grid no larger than what the
// card holds at once is what cudaLaunchCooperativeKernel requires; a card
// without cooperative launch is refused, not worked around.
inline cudaError_t cooperative_grid(const void* kernel, size_t smem,
                                    int out[4]) {
  int dev, coop, sms, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                    dev)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           static_cast<int>(smem))) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kEncThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  out[0] = per_sm * sms;
  out[1] = per_sm;
  out[2] = sms;
  out[3] = static_cast<int>(smem);
  return cudaSuccess;
}

inline cudaError_t launch_cooperative(const void* kernel, size_t smem,
                                      const EncoderArgs& a,
                                      cudaStream_t stream) {
  int g[4];
  cudaError_t err = cooperative_grid(kernel, smem, g);
  if (err != cudaSuccess) return err;
  void* args[] = {const_cast<EncoderArgs*>(&a)};
  err = cudaLaunchCooperativeKernel(kernel, dim3(g[0]), dim3(kEncThreads),
                                    args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The arguments every launch shares: bufs[0:16] = x, key_mask, the 12
// stacked parameters, fs and fb; dims[0:6] = B, L, d, h, d_ff, N; the 4N
// streams' keys.
inline EncoderArgs common_args(void* const* bufs, const int* dims,
                               const unsigned* keys, double p) {
  EncoderArgs a = {};
  a.x = bufs[0];
  a.key_mask = static_cast<const unsigned char*>(bufs[1]);
  for (int i = 0; i < kStacked; ++i)
    a.w[i] = static_cast<const float*>(bufs[2 + i]);
  a.fs = static_cast<const float*>(bufs[14]);
  a.fb = static_cast<const float*>(bufs[15]);
  a.drop_on = p > 0.0;
  a.denom = static_cast<float>(1.0 - p);
  a.inv = static_cast<float>(1.0 / (1.0 - p));
  a.batch = dims[0];
  a.L = dims[1];
  a.d = dims[2];
  a.h = dims[3];
  a.d_ff = dims[4];
  a.n_blocks = dims[5];
  for (int i = 0; i < 12 * std::min(a.n_blocks, kMaxBlocks); ++i)
    a.keys[i] = keys[i];
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(a.d / a.h)));
  return a;
}

// The forward's buffers after the 16 common ones: y, xs, qkv, stats (null
// unless parked), ctx, w1b, w2b; dims[6] = park.
inline EncoderArgs fwd_args(void* const* bufs, const int* dims,
                            const unsigned* keys, double p) {
  EncoderArgs a = common_args(bufs, dims, keys, p);
  a.y = bufs[16];
  a.xs = bufs[17];
  a.qkv = bufs[18];
  a.stats = static_cast<float*>(bufs[19]);
  a.ctx = bufs[20];
  a.w1b = bufs[21];
  a.w2b = bufs[22];
  a.park = dims[6];
  return a;
}

// The backward's buffers after the 16 common ones: dy, dx, the 12 stacked
// gradients, dfs, dfb; xs, qkv, stats, gz0, gz1, da, dO, n_act_a, ctx,
// dqkv, D, n_act_f, dout, hidden, dh, part_qkv, part_out, part_ln_a,
// part_1, part_2, part_ln_f, part_fln, w1b, w2b. dims[6:11] = s_qkv,
// s_out, s_1, s_2, replay.
inline EncoderArgs bwd_args(void* const* bufs, const int* dims,
                            const unsigned* keys, double p) {
  EncoderArgs a = common_args(bufs, dims, keys, p);
  int i = 16;
  a.dy = bufs[i++];
  a.dx = bufs[i++];
  for (int k = 0; k < kStacked; ++k) a.g[k] = static_cast<float*>(bufs[i++]);
  a.dfs = static_cast<float*>(bufs[i++]);
  a.dfb = static_cast<float*>(bufs[i++]);
  a.xs = bufs[i++];
  a.qkv = bufs[i++];
  a.stats = static_cast<float*>(bufs[i++]);
  a.gz0 = bufs[i++];
  a.gz1 = bufs[i++];
  a.da = bufs[i++];
  a.dO = bufs[i++];
  a.n_act_a = bufs[i++];
  a.ctx = bufs[i++];
  a.dqkv = bufs[i++];
  a.D = static_cast<float*>(bufs[i++]);
  a.n_act_f = bufs[i++];
  a.dout = bufs[i++];
  a.hidden = bufs[i++];
  a.dh = bufs[i++];
  a.part_qkv = static_cast<float*>(bufs[i++]);
  a.part_out = static_cast<float*>(bufs[i++]);
  a.part_ln_a = static_cast<float*>(bufs[i++]);
  a.part_1 = static_cast<float*>(bufs[i++]);
  a.part_2 = static_cast<float*>(bufs[i++]);
  a.part_ln_f = static_cast<float*>(bufs[i++]);
  a.part_fln = static_cast<float*>(bufs[i++]);
  a.w1b = bufs[i++];
  a.w2b = bufs[i++];
  a.s_qkv = dims[6];
  a.s_out = dims[7];
  a.s_1 = dims[8];
  a.s_2 = dims[9];
  a.replay = dims[10];
  a.park = 1;
  return a;
}

// The kernel of a launch on route R and its shared memory: kDk the padded
// head class of the source (0: B1's SIMT phases, for d_k > 128), kCs B2's
// column split (2 at d > 128). Heads of 128 or fewer columns take whole
// 16-byte rows (ops/encoder_block.check_envelope), staged by 16-byte
// copies; a head of another class than the source's is refused.
template <class R, int kDk>
cudaError_t select(bool backward, int d, int h, const void** kernel,
                   size_t* smem) {
  const int dk = d / h, pad = mma_head_pad(dk);
  const int head_class = dk > 128 ? 0 : pad <= 32 ? 32 : pad <= 64 ? 64 : 128;
  if (head_class != kDk || (kDk != 0 && dk * sizeof(typename R::T) % 16 != 0))
    return cudaErrorInvalidValue;
  const bool cs2 = (d + 15) / 16 * 16 > 128;
  *kernel = backward ? (cs2 ? (const void*)encoder_bwd_kernel<R, kDk, 2>
                            : (const void*)encoder_bwd_kernel<R, kDk, 1>)
                     : (cs2 ? (const void*)encoder_fwd_kernel<R, kDk, 2>
                            : (const void*)encoder_fwd_kernel<R, kDk, 1>);
  *smem = cs2 ? R::template smem<kDk, 2>(d, h, backward)
              : R::template smem<kDk, 1>(d, h, backward);
  return cudaSuccess;
}

template <class R, int kDk>
cudaError_t run(const EncoderArgs& a, bool backward, cudaStream_t stream) {
  if (a.n_blocks < 1 || a.n_blocks > kMaxBlocks || a.d > 256)
    return cudaErrorInvalidValue;
  const void* kernel;
  size_t smem;
  cudaError_t err = select<R, kDk>(backward, a.d, a.h, &kernel, &smem);
  if (err != cudaSuccess) return err;
  return launch_cooperative(kernel, smem, a, stream);
}

// whether every non-null buffer of the first n starts on 16 bytes
inline bool buffers_aligned(void* const* bufs, int n) {
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(bufs[i]) % 16 != 0) return false;
  return true;
}

}  // namespace
}  // namespace allrank

// The C entry points of a source of B10: its route R and head class kDk
// (a source a class, so that nvcc builds the classes in parallel).
//   encoder_block_fwd(bufs, dims, keys, p, stream): one cooperative launch
//     of the forward; bufs: x, key_mask, the 12 stacked fp32 parameters
//     [N, ...], fs, fb; y [B, L, d]; scratch xs ([2N, B*L, d] parked, else
//     [2, B*L, d]), qkv ([N, B*L, 3d] parked, else [B*L, 3d]), stats ([N, B,
//     h, L, 2] fp32 parked, else null), ctx [B*L, d] (fp32's attention core;
//     else null), w1b [N, round16(d), round64(d_ff)] and w2b [N,
//     round64(d_ff), round16(d)] (bf16's rounded weights; else null). dims:
//     B, L, d, h, d_ff, N (1 <= N <= 16), park. keys: the host array of 4N
//     {k0, k1, threshold} (ops/dropout.py; per block the attention-
//     probability, attention-output, FFN-hidden and FFN-output streams); p
//     the rate of every stream (0: none).
//   encoder_block_bwd(bufs, dims, keys, p, stream): one cooperative launch
//     of the backward; bufs as bwd_args, activations and their scratch in
//     x's dtype (bf16's n_act_f and dout [B*L, round16(d)], hidden and dh
//     [B*L, round64(d_ff)]; fp32's unpadded), gradients and partial sums
//     fp32 (part_qkv [s_qkv, 3d*d + 3d], part_out [s_out, d*d + d],
//     part_ln_a and part_fln [ceil(B*L/64), 2d], part_1 [s_1, d*d_ff +
//     d_ff], part_2 [s_2, d_ff*d + d], part_ln_f [ceil(B*L/rows), 2d]).
//     dims: B, L, d, h, d_ff, N, s_qkv, s_out, s_1, s_2, replay: 1 replays
//     the forward into xs, qkv and stats first; 0 reads them as the parked
//     forward left them.
//   encoder_block_grid(backward, d, h, out): out = {grid, blocks per SM,
//     SMs, dynamic shared memory bytes} of that launch.
// Each returns 0 or the CUDA error code.
#define ENCODER_ENTRY_POINTS(R, kDk)                                        \
  extern "C" int encoder_block_fwd(void* const* bufs, const int* dims,     \
                                   const unsigned* keys, double p,          \
                                   void* stream) {                          \
    allrank::EncoderArgs a = allrank::fwd_args(bufs, dims, keys, p);       \
    a.aligned = allrank::buffers_aligned(bufs, 23);                        \
    return allrank::run<allrank::R, kDk>(                                  \
        a, false, static_cast<cudaStream_t>(stream));                      \
  }                                                                         \
  extern "C" int encoder_block_bwd(void* const* bufs, const int* dims,     \
                                   const unsigned* keys, double p,          \
                                   void* stream) {                          \
    allrank::EncoderArgs a = allrank::bwd_args(bufs, dims, keys, p);       \
    a.aligned = allrank::buffers_aligned(bufs, 56);                        \
    return allrank::run<allrank::R, kDk>(                                  \
        a, true, static_cast<cudaStream_t>(stream));                       \
  }                                                                         \
  extern "C" int encoder_block_grid(int backward, int d, int h, int* out) { \
    const void* kernel;                                                     \
    size_t smem;                                                            \
    cudaError_t err =                                                       \
        allrank::select<allrank::R, kDk>(backward, d, h, &kernel, &smem);  \
    if (err != cudaSuccess) return err;                                     \
    return allrank::cooperative_grid(kernel, smem, out);                    \
  }
