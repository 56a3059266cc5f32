// Whole-encoder kernel B10 for Hopper (sm_90a), fp32 or bf16 activations:
// N pre-norm blocks (the attention sublayer B1, then the FFN sublayer B2)
// and the final unbiased-std LayerNorm, forward in one launch and backward
// in one launch.
//
// Replaces the TPU kernel `encoder_forward` of the JAX package's
// ops/encoder_block.py: forward pallas_call at line 302 (_fwd_kernel, lines
// 88-101), backward pallas_call at line 333 (_bwd_kernel, lines 121-197).
//
// What bounds it: the products. At the flagship shape (B=64, L=240, d=128,
// h=4, d_ff=512, N=4) the forward does about 31.7 GFLOP and the backward
// about 79 GFLOP (each product of the function counted once), against some
// 8 MB of activations and 4 MB of weights in and out: bound by operations.
//
// What the design does about the TPU kernel's assumptions:
//  * The TPU kernel runs one program per slate block and keeps the residual
//    stream in VMEM across the blocks' fori_loop. A slate here is bigger
//    than a block's 227 KB of shared memory, and one block per slate would
//    leave half of the 132 SMs idle at B=64. So each direction is one
//    cooperative persistent kernel: a grid as large as can be co-resident
//    (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM count) walks
//    the tiles of one stage of the chained B1/B2 kernels per phase,
//    `for (t = blockIdx.x; t < tiles; t += gridDim.x)`, and the phases are
//    separated by grid.sync(). The residual stream, qkv and the scratch
//    live in device memory; at the flagship size they fit the 50 MB L2,
//    which is this card's counterpart of the TPU kernel's VMEM.
//  * The tile bodies are those of the chained kernels (sublayer_tiles.cuh,
//    backward.cuh), so B10 computes the chained kernels' products in the
//    same order and, with the same dropout keys (dropout.cuh: masks keyed
//    on the global element index), gives their bits.
//  * Forward, per block: LN1 + QKV tiles; attention + out-projection +
//    residual per (slate, 64-query tile) into a second stream buffer; the
//    FFN per 64-row tile back into the first; after the last block the
//    final LayerNorm.
//  * Backward, as the TPU kernel: replay the forward, parking the 2N
//    sublayer inputs and each block's qkv and softmax row statistics (the
//    chained forward's saved state); the final-LN backward; then the reverse
//    sweep, per block: the FFN backward tiles, its split weight-gradient
//    products, their fixed-order reduction beside the attention's
//    bwd_rows tiles, bwd_dq, bwd_dkv, bwd_ln_qkv beside the attention's
//    split products, whose reduction runs beside the next block's FFN
//    backward. Every gradient slot is written once by a fixed-order sum over
//    all B * L rows: no atomics, the gradients are deterministic.
//  * Products are fp32 FMAs on 64 x 64 register tiles; wgmma, TMA and
//    clusters are later work.
#include <cooperative_groups.h>

#include <algorithm>

#include "backward.cuh"
#include "common.cuh"
#include "dropout.cuh"
#include "sublayer_tiles.cuh"

namespace cg = cooperative_groups;

namespace allrank {
namespace {

// the 12 stacked per-block parameters, in the JAX package's
// STACKED_PER_BLOCK order (ops/encoder_block.py:64-67 there)
enum Stacked {
  kLn1S, kLn1B, kWqkv, kBqkv, kWout, kBout,
  kLn2S, kLn2B, kW1, kB1, kW2, kB2, kStacked
};

// the most blocks a launch takes: their dropout keys ride in the launch's
// parameters (no copy to the device, which would stall the host)
constexpr int kMaxBlocks = 16;

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
  void* y;     // forward output [B, L, d]
  void* xs;    // forward [2, M, d]; backward [2N, M, d] parked inputs
  void* qkv;   // forward [M, 3d]; backward [N, M, 3d]
  float* stats;  // backward [N, B, h, L, 2]
  const void* dy;
  void* dx;
  float* g[kStacked];  // gradients of w, [N, ...] fp32
  float *dfs, *dfb;
  void *gz0, *gz1;  // [M, d] gradients along the residual stream
  void *da, *dO, *n_act_a, *ctx, *dqkv;
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

__device__ inline DropStream stream_at(const EncoderArgs& a, int i) {
  DropStream s;
  s.k0 = a.keys[3 * i];
  s.k1 = a.keys[3 * i + 1];
  s.threshold = a.keys[3 * i + 2];
  s.on = a.drop_on;
  s.denom = a.denom;
  s.inv = a.inv;
  return s;
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

// ---------------------------------------------------------------------------
// the phases' jobs

// One split weight-gradient product dW = A^T . B (backward.cuh) as tiles.
template <class T>
struct Product {
  const T* A;
  const T* B;
  float* part;
  int K, N, splits;
  __device__ int tiles() const { return cdiv(K, kTile) * cdiv(N, kTile) * splits; }
  __device__ void run(float* smem, int M, int t) const {
    const int kt = cdiv(K, kTile), nt = cdiv(N, kTile);
    atb_partial_tile(smem, A, B, part, M, K, N, split_rows(M, splits), t % kt,
                     (t / kt) % nt, t / (kt * nt));
  }
};

// One fixed-order reduction of partial sums (backward.cuh) as tiles.
struct Reduction {
  const float* part;
  int splits;
  float* out0;
  int n0;
  float* out1;
  int n1;
  __device__ int tiles() const { return cdiv(n0 + n1, kThreads); }
  __device__ void run(int t) const {
    reduce_partials_tile(part, splits, out0, n0, out1, n1, t);
  }
};

// The three reductions of block n's attention-sublayer gradients.
__device__ inline void attn_reductions(const EncoderArgs& a, int n, int M,
                                       Reduction* r) {
  const int d = a.d, row_tiles = cdiv(M, kTile);
  const BlockPtrs g = block_ptrs(a.g, n, d, a.d_ff);
  r[0] = {a.part_qkv, a.s_qkv, g.p[kWqkv], d * 3 * d, g.p[kBqkv], 3 * d};
  r[1] = {a.part_out, a.s_out, g.p[kWout], d * d, g.p[kBout], d};
  r[2] = {a.part_ln_a, row_tiles, g.p[kLn1S], d, g.p[kLn1B], d};
}

// Runs tile t of the concatenated tile ranges of `count` reductions.
__device__ inline void run_reductions(const Reduction* r, int count, int t) {
  for (int i = 0; i < count; ++i) {
    const int n = r[i].tiles();
    if (t < n) {
      r[i].run(t);
      return;
    }
    t -= n;
  }
}

__device__ inline int reduction_tiles(const Reduction* r, int count) {
  int n = 0;
  for (int i = 0; i < count; ++i) n += r[i].tiles();
  return n;
}

// ---------------------------------------------------------------------------
// the kernels

template <class T>
__global__ void __launch_bounds__(kThreads, 1)
    encoder_fwd_kernel(const __grid_constant__ EncoderArgs a) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int M = a.batch * a.L, d = a.d;
  const int row_tiles = cdiv(M, kTile), qkv_tiles = row_tiles * cdiv(3 * d, kTile);
  const int attn_tiles = cdiv(a.L, kTile) * a.batch, q_tiles = cdiv(a.L, kTile);
  T* mid = static_cast<T*>(a.xs);
  T* next = mid + (size_t)M * d;
  T* qkv = static_cast<T*>(a.qkv);
  const T* cur = static_cast<const T*>(a.x);

  for (int n = 0; n < a.n_blocks; ++n) {
    const BlockPtrs w = block_ptrs(a.w, n, d, a.d_ff);
    for (int t = blockIdx.x; t < qkv_tiles; t += gridDim.x) {
      __syncthreads();
      ln_qkv_tile(smem, cur, w.p[kLn1S], w.p[kLn1B], w.p[kWqkv], w.p[kBqkv],
                  qkv, M, d, t % row_tiles, t / row_tiles);
    }
    grid.sync();
    const DropStream drop_a = stream_at(a, 4 * n);
    const DropStream drop_ar = stream_at(a, 4 * n + 1);
    for (int t = blockIdx.x; t < attn_tiles; t += gridDim.x) {
      __syncthreads();
      attn_out_tile(smem, qkv, a.key_mask, cur, w.p[kWout], w.p[kBout], mid,
                    nullptr, a.L, d, a.h, a.scale, drop_a, drop_ar,
                    t % q_tiles, t / q_tiles);
    }
    grid.sync();
    const DropStream drop_h = stream_at(a, 4 * n + 2);
    const DropStream drop_fr = stream_at(a, 4 * n + 3);
    for (int t = blockIdx.x; t < row_tiles; t += gridDim.x) {
      __syncthreads();
      ffn_fwd_tile(smem, mid, w.p[kLn2S], w.p[kLn2B], w.p[kW1], w.p[kB1],
                   w.p[kW2], w.p[kB2], next, M, d, a.d_ff, drop_h, drop_fr, t);
    }
    grid.sync();
    cur = next;
  }
  for (int t = blockIdx.x; t < row_tiles; t += gridDim.x)
    final_ln_tile(cur, a.fs, a.fb, static_cast<T*>(a.y), M, d, t);
}

template <class T>
__global__ void __launch_bounds__(kThreads, 1)
    encoder_bwd_kernel(const __grid_constant__ EncoderArgs a) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int N = a.n_blocks, M = a.batch * a.L, d = a.d, d_ff = a.d_ff;
  const size_t md = (size_t)M * d;
  const int row_tiles = cdiv(M, kTile), q_tiles = cdiv(a.L, kTile);
  const int qkv_tiles = row_tiles * cdiv(3 * d, kTile);
  const int attn_tiles = q_tiles * a.batch;
  const int rows_tiles = row_tiles * cdiv(d, kTile);
  const int head_tiles = q_tiles * a.batch * a.h * cdiv(d / a.h, kTile);
  const int heads = a.batch * a.h;
  const size_t stats_size = (size_t)heads * a.L * 2;
  T* const xs = static_cast<T*>(a.xs);
  // S(k): the input of sublayer k (2n: block n's attention, 2n + 1 its
  // FFN), S(2N) the final LayerNorm's input
  auto S = [&](int k) -> T* {
    return k == 0 ? const_cast<T*>(static_cast<const T*>(a.x))
                  : xs + (size_t)(k - 1) * md;
  };
  T* n_act_a = static_cast<T*>(a.n_act_a);
  T* da = static_cast<T*>(a.da);
  T* dO = static_cast<T*>(a.dO);
  T* ctx = static_cast<T*>(a.ctx);
  T* dqkv = static_cast<T*>(a.dqkv);
  T* n_act_f = static_cast<T*>(a.n_act_f);
  T* dout = static_cast<T*>(a.dout);
  T* hidden = static_cast<T*>(a.hidden);
  T* dh = static_cast<T*>(a.dh);

  // ---- replay the forward, parking the sublayer inputs, qkv and stats ----
  for (int n = 0; n < N; ++n) {
    const BlockPtrs w = block_ptrs(a.w, n, d, d_ff);
    T* qkv = static_cast<T*>(a.qkv) + (size_t)n * M * 3 * d;
    float* stats = a.stats + (size_t)n * stats_size;
    for (int t = blockIdx.x; t < qkv_tiles; t += gridDim.x) {
      __syncthreads();
      ln_qkv_tile(smem, S(2 * n), w.p[kLn1S], w.p[kLn1B], w.p[kWqkv],
                  w.p[kBqkv], qkv, M, d, t % row_tiles, t / row_tiles);
    }
    grid.sync();
    const DropStream drop_a = stream_at(a, 4 * n);
    const DropStream drop_ar = stream_at(a, 4 * n + 1);
    for (int t = blockIdx.x; t < attn_tiles; t += gridDim.x) {
      __syncthreads();
      attn_out_tile(smem, qkv, a.key_mask, S(2 * n), w.p[kWout], w.p[kBout],
                    S(2 * n + 1), stats, a.L, d, a.h, a.scale, drop_a, drop_ar,
                    t % q_tiles, t / q_tiles);
    }
    grid.sync();
    const DropStream drop_h = stream_at(a, 4 * n + 2);
    const DropStream drop_fr = stream_at(a, 4 * n + 3);
    for (int t = blockIdx.x; t < row_tiles; t += gridDim.x) {
      __syncthreads();
      ffn_fwd_tile(smem, S(2 * n + 1), w.p[kLn2S], w.p[kLn2B], w.p[kW1],
                   w.p[kB1], w.p[kW2], w.p[kB2], S(2 * n + 2), M, d, d_ff,
                   drop_h, drop_fr, t);
    }
    grid.sync();
  }

  // ---- the final LayerNorm's backward ------------------------------------
  T* gcur = static_cast<T*>(a.gz0);  // gradient at S(2n + 2)
  T* gmid = static_cast<T*>(a.gz1);  // gradient at S(2n + 1)
  for (int t = blockIdx.x; t < row_tiles; t += gridDim.x) {
    __syncthreads();
    final_ln_bwd_tile(smem, S(2 * N), static_cast<const T*>(a.dy), a.fs, gcur,
                      a.part_fln, M, d, t);
  }
  grid.sync();

  // ---- the reverse sweep -------------------------------------------------
  for (int n = N - 1; n >= 0; --n) {
    const BlockPtrs w = block_ptrs(a.w, n, d, d_ff);
    const BlockPtrs g = block_ptrs(a.g, n, d, d_ff);
    const T* qkv = static_cast<const T*>(a.qkv) + (size_t)n * M * 3 * d;
    const float* stats = a.stats + (size_t)n * stats_size;
    const DropStream drop_a = stream_at(a, 4 * n);
    const DropStream drop_ar = stream_at(a, 4 * n + 1);
    const DropStream drop_h = stream_at(a, 4 * n + 2);
    const DropStream drop_fr = stream_at(a, 4 * n + 3);

    // FFN backward tiles, beside the reduction of block n + 1's attention
    // gradients
    Reduction red[4];
    int n_red = 0;
    if (n < N - 1) {
      attn_reductions(a, n + 1, M, red);
      n_red = 3;
    }
    int tiles = row_tiles + reduction_tiles(red, n_red);
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      __syncthreads();
      if (t < row_tiles)
        ffn_bwd_tile(smem, S(2 * n + 1), w.p[kLn2S], w.p[kLn2B], w.p[kW1],
                     w.p[kB1], w.p[kW2], gcur, gmid, n_act_f, dout, hidden, dh,
                     a.part_ln_f, M, d, d_ff, drop_h, drop_fr, t);
      else
        run_reductions(red, n_red, t - row_tiles);
    }
    grid.sync();

    // the FFN's weight-gradient partial sums
    const Product<T> p1{n_act_f, dh, a.part_1, d, d_ff, a.s_1};
    const Product<T> p2{hidden, dout, a.part_2, d_ff, d, a.s_2};
    tiles = p1.tiles() + p2.tiles();
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      __syncthreads();
      if (t < p1.tiles())
        p1.run(smem, M, t);
      else
        p2.run(smem, M, t - p1.tiles());
    }
    grid.sync();

    // their reductions (and, for the last block, the final LN's), beside
    // the attention backward's rows: da, dO and LN1(x)
    red[0] = {a.part_1, a.s_1, g.p[kW1], d * d_ff, g.p[kB1], d_ff};
    red[1] = {a.part_2, a.s_2, g.p[kW2], d_ff * d, g.p[kB2], d};
    red[2] = {a.part_ln_f, row_tiles, g.p[kLn2S], d, g.p[kLn2B], d};
    red[3] = {a.part_fln, row_tiles, a.dfs, d, a.dfb, d};
    n_red = n == N - 1 ? 4 : 3;
    tiles = rows_tiles + reduction_tiles(red, n_red);
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      __syncthreads();
      if (t < rows_tiles)
        bwd_rows_tile(smem, S(2 * n), gmid, w.p[kLn1S], w.p[kLn1B],
                      w.p[kWout], da, dO, n_act_a, M, d, drop_ar,
                      t % row_tiles, t / row_tiles);
      else
        run_reductions(red, n_red, t - rows_tiles);
    }
    grid.sync();

    // dQ, ctx and D; then dK and dV
    for (int t = blockIdx.x; t < head_tiles; t += gridDim.x) {
      __syncthreads();
      bwd_dq_tile(smem, qkv, a.key_mask, stats, dO, ctx, a.D, dqkv, a.L, d,
                  a.h, a.scale, drop_a, t % q_tiles, (t / q_tiles) % heads,
                  t / (q_tiles * heads));
    }
    grid.sync();
    for (int t = blockIdx.x; t < head_tiles; t += gridDim.x) {
      __syncthreads();
      bwd_dkv_tile(smem, qkv, a.key_mask, stats, a.D, dO, dqkv, a.L, d, a.h,
                   a.scale, drop_a, t % q_tiles, (t / q_tiles) % heads,
                   t / (q_tiles * heads));
    }
    grid.sync();

    // the LN1 backward (the gradient at S(2n)), beside the attention's
    // weight-gradient partial sums
    T* gout = n == 0 ? static_cast<T*>(a.dx) : gcur;
    const Product<T> pq{n_act_a, dqkv, a.part_qkv, d, 3 * d, a.s_qkv};
    const Product<T> po{ctx, da, a.part_out, d, d, a.s_out};
    tiles = row_tiles + pq.tiles() + po.tiles();
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      __syncthreads();
      if (t < row_tiles)
        bwd_ln_qkv_tile(smem, S(2 * n), gmid, dqkv, w.p[kLn1S], w.p[kWqkv],
                        gout, a.part_ln_a, M, d, t);
      else if (t < row_tiles + pq.tiles())
        pq.run(smem, M, t - row_tiles);
      else
        po.run(smem, M, t - row_tiles - pq.tiles());
    }
    grid.sync();
  }

  // block 0's attention-gradient reductions
  Reduction red[3];
  attn_reductions(a, 0, M, red);
  const int tiles = reduction_tiles(red, 3);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) run_reductions(red, 3, t);
}

// ---------------------------------------------------------------------------
// launches

int fwd_smem_floats(int d) {
  return std::max({ln_qkv_smem_floats(), attn_out_smem_floats(d),
                   ffn_fwd_smem_floats(d)});
}

int bwd_smem_floats(int d) {
  return std::max({fwd_smem_floats(d), final_ln_bwd_smem_floats(d),
                   ffn_bwd_smem_floats(d), atb_smem_floats(),
                   bwd_rows_smem_floats(), bwd_attn_smem_floats(),
                   bwd_ln_qkv_smem_floats(d)});
}

const void* kernel_of(int backward, int is_bf16) {
  if (backward)
    return is_bf16 ? (const void*)encoder_bwd_kernel<__nv_bfloat16>
                   : (const void*)encoder_bwd_kernel<float>;
  return is_bf16 ? (const void*)encoder_fwd_kernel<__nv_bfloat16>
                 : (const void*)encoder_fwd_kernel<float>;
}

// The cooperative grid of a kernel: {grid, blocks per SM, SMs, dynamic
// shared memory in bytes}. A grid no larger than what the card holds at
// once is what cudaLaunchCooperativeKernel requires.
cudaError_t cooperative_grid(int backward, int d, int is_bf16, int out[4]) {
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
  const void* fn = kernel_of(backward, is_bf16);
  const int smem =
      (backward ? bwd_smem_floats(d) : fwd_smem_floats(d)) * sizeof(float);
  if ((err = cudaFuncSetAttribute(
           fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fn, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  out[0] = per_sm * sms;
  out[1] = per_sm;
  out[2] = sms;
  out[3] = smem;
  return cudaSuccess;
}

int launch(const EncoderArgs& a, int backward, int is_bf16,
           cudaStream_t stream) {
  if (a.n_blocks < 1 || a.n_blocks > kMaxBlocks) return cudaErrorInvalidValue;
  int g[4];
  cudaError_t err = cooperative_grid(backward, a.d, is_bf16, g);
  if (err != cudaSuccess) return err;
  void* args[] = {const_cast<EncoderArgs*>(&a)};
  err = cudaLaunchCooperativeKernel(kernel_of(backward, is_bf16), dim3(g[0]),
                                    dim3(kThreads), args, g[3], stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The arguments every launch shares: bufs[0:16] = x, key_mask, the 12
// stacked parameters, fs and fb; dims[0:6] = B, L, d, h, d_ff, N; the 4N
// streams' keys.
EncoderArgs common_args(void* const* bufs, const int* dims,
                        const unsigned* keys, double p) {
  EncoderArgs a = {};
  a.x = bufs[0];
  a.key_mask = static_cast<const unsigned char*>(bufs[1]);
  for (int i = 0; i < kStacked; ++i) a.w[i] = static_cast<const float*>(bufs[2 + i]);
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

}  // namespace
}  // namespace allrank

// Launches the forward on `stream`; returns 0 or the CUDA error code.
// bufs: the 16 common buffers (common_args), then y [B, L, d] and the
// scratch xs [2, B*L, d] and qkv [B*L, 3d], all activations in x's dtype
// (bf16 if is_bf16, else fp32), parameters fp32. dims: B, L, d, h, d_ff, N
// (1 <= N <= 16). keys: the host array of 4N {k0, k1, threshold}
// (ops/dropout.py; per block the attention-probability, attention-output,
// FFN-hidden and FFN-output streams); p the rate of every stream (0: none).
extern "C" int encoder_block_fwd(void* const* bufs, const int* dims,
                                 const unsigned* keys, double p, int is_bf16,
                                 void* stream) {
  allrank::EncoderArgs a = allrank::common_args(bufs, dims, keys, p);
  a.y = bufs[16];
  a.xs = bufs[17];
  a.qkv = bufs[18];
  return allrank::launch(a, 0, is_bf16, static_cast<cudaStream_t>(stream));
}

// Launches the backward on `stream`; returns 0 or the CUDA error code.
// bufs: the 16 common buffers, then dy and dx [B, L, d]; the 12 stacked
// fp32 gradients and the final LN's two [d]; scratch: xs [2N, B*L, d], qkv
// [N, B*L, 3d], fp32 stats [N, B, h, L, 2], gz0 and gz1 [B*L, d], da, dO,
// n_act_a, ctx [B*L, d], dqkv [B*L, 3d], fp32 D [B, h, L], n_act_f, dout
// [B*L, d], hidden, dh [B*L, d_ff], and the fp32 partial sums part_qkv
// [s_qkv, 3d*d + 3d], part_out [s_out, d*d + d], part_ln_a [ceil(B*L/64),
// 2d], part_1 [s_1, d*d_ff + d_ff], part_2 [s_2, d_ff*d + d], part_ln_f and
// part_fln [ceil(B*L/64), 2d]. dims: B, L, d, h, d_ff, N, s_qkv, s_out,
// s_1, s_2. keys and p as the forward's.
extern "C" int encoder_block_bwd(void* const* bufs, const int* dims,
                                 const unsigned* keys, double p, int is_bf16,
                                 void* stream) {
  allrank::EncoderArgs a = allrank::common_args(bufs, dims, keys, p);
  int i = 16;
  a.dy = bufs[i++];
  a.dx = bufs[i++];
  for (int k = 0; k < allrank::kStacked; ++k)
    a.g[k] = static_cast<float*>(bufs[i++]);
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
  a.s_qkv = dims[6];
  a.s_out = dims[7];
  a.s_1 = dims[8];
  a.s_2 = dims[9];
  return allrank::launch(a, 1, is_bf16, static_cast<cudaStream_t>(stream));
}

// out = {grid, blocks per SM, SMs, dynamic shared memory bytes} of the
// forward (backward = 0) or backward kernel's cooperative launch at width
// d; returns 0 or the CUDA error code.
extern "C" int encoder_block_grid(int backward, int d, int is_bf16, int* out) {
  return allrank::cooperative_grid(backward, d, is_bf16, out);
}
