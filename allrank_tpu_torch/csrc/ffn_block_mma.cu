// B2, the FFN sublayer, forward and backward in bf16 on Hopper's tensor
// cores (sm_90a):
//   y = x + drop_r(drop_h(relu(LN(x) . W1 + b1)) . W2 + b2)
// with the unbiased-std LayerNorm (eps added to the std, the variance
// floored at 1e-24), dropout on the hidden activation (index row * d_ff +
// col) and on the sublayer output (row * d + col) from csrc/dropout.cuh,
// and the residual added in fp32. The bf16 rounding points are the TPU
// kernel's: the LN output and the dropped hidden activation forward; dout =
// drop_r(dy) and the gated dh backward. Weights are rounded to bf16 as the
// TPU kernel casts them, by one small launch a call.
//
// Replaces the TPU kernel `ffn_sublayer` of the JAX package's
// ops/ffn_block.py for bf16 activations: forward pallas_call at line 204
// (ffn_sublayer_fwd_vmem, lines 40-63), backward at line 233
// (ffn_sublayer_bwd_vmem, lines 76-132). fp32 takes ffn_block_tf32x3.cu
// (3xTF32 on the tensor cores); the route is chosen in ops/ffn_block.py
// from dtype, d and d_ff alone.
//
// What bounds it: operations. At the flagship shape (B=64, L=240, d=128,
// d_ff=512) the forward does 4.0 GFLOP (LN(x) . W1, hidden . W2) and the
// backward 10.1 GFLOP (pre and dh recomputed, dn, dW1, dW2) on some 8 and
// 12 MB of bf16 activations: 0.004 and 0.010 ms at the tensor cores' 989
// TFLOP/s. The SIMT kernels ran every product as fp32 FMAs at 1-2 % of
// that bound.
//
// What the design does about it:
//  * Every product is an mma.sync.m16n8k16 bf16 x bf16 -> fp32 on the
//    product tile of mma_tile.cuh. Nothing goes to a library.
//  * Weights: b2_round_weights_kernel rounds W1 and W2 to bf16 once a call
//    into scratch padded with zeros to whole 16-row and 64-column steps
//    (the same round-to-nearest as a load-time rounding, so the same bits),
//    and the row kernels stream each 64-unit chunk pair, W1[:, c] and
//    W2[c, :], through a two-slot cp.async ring while the tensor cores work
//    on the last one. In bf16 at the flagship W1 and W2 take 256 KB: they
//    do not fit in shared memory together, a chunk pair does. (Rounding
//    each chunk as it is staged, stage_weight's way, took 1.7x the device
//    time forward and 1.35x backward in an A/B at the flagship: PERF.md.)
//  * Forward: one kernel, a block of eight warps: 128 rows, 16 a warp, at
//    d <= 128; 64 at d > 128, where two warps share a row group and split
//    the output columns so that a warp's accumulator stays at 16 x 128
//    (128 rows took 3-4 % less device time than 64 at the flagship). The
//    block takes the rows' statistics in fp32 and stages the bf16 LN output
//    as the A operand; per chunk H_c = LN(x) . W1[:, c] + b1, relu, the hidden
//    dropout (keep bit hashed once an element) and the bf16 rounding happen
//    in registers, and acc_to_a turns H_c into the A fragments of acc +=
//    H_c . W2[c, :], as B4 keeps P for P . V: the hidden state never
//    touches shared or device memory. Epilogue: + b2, the output dropout,
//    + x in fp32, rounded.
//  * Backward: a row kernel, in the forward's blocks, recomputes LN (the
//    bf16 n written once as [M, d] for dW1) and dout = round(drop_r(dy))
//    (written for dW2), then per half chunk of 32 hidden units pre = n .
//    W1c + b1, the gate and the hidden mask, hidden =
//    round(drop(relu(pre))) and dh = round((dout . W2c^T) keep / (1 - p)
//    gate) (both written as bf16 [M, d_ff]: the TPU kernel's rounding
//    points, so storing them is exact), and dn += dh . W1c^T through
//    acc_to_a again; backward.cuh's fp32 LN backward gives dx and the
//    tile's dg / db partials. dW1 = n^T . dh and dW2 = hidden^T .
//    dout, with db1 and db2 as column sums, are split A^T . B products on
//    the tensor cores (A read transposed by ldmatrix .trans, a two-slot
//    cp.async ring), their partials reduced in split order. No atomics: two
//    backwards give the same bits.
//  * Ragged shapes: d padded with zeros to whole 16-column steps, d_ff to
//    whole 64-unit chunks (the scratch weights' zeros make the padded units
//    weigh nothing), any number of rows; x and dy are read element by
//    element, so they may start anywhere; every scratch row the kernels
//    stage with 16-byte copies is padded to a multiple of 16 bytes.
#include "attention_mma_tiles.cuh"
#include "backward.cuh"
#include "dropout.cuh"
#include "mma_tile.cuh"

namespace allrank {
namespace {

// a row kernel's block: eight warps, common.cuh's kThreads (which
// backward.cuh's ln_backward_tile takes)
constexpr int kWarps = 8, kBlockThreads = 32 * kWarps;
static_assert(kBlockThreads == kThreads, "the LN backward's block");
constexpr int kChunkF = 64;             // hidden units a chunk
constexpr int kStepF = 32;              // hidden units a backward step
constexpr int kStepTiles = kStepF / 8;  // its C tiles
constexpr int kColsWarp = 128;          // output columns a warp accumulates
constexpr int kW1Pitch = kChunkF + 8;   // staged W1 chunk [dpad][kW1Pitch]
constexpr int kAtbThreads = 128, kAtbRows = 64, kAtbPitch = 64 + 8;

// Rows of a row kernel's block: 16 a warp, 128 at d <= 128; above, two
// warps share each row group (kCs = 2), 64. 128 rows took 3-4 % less device
// time than 64 at the flagship, forward and backward (PERF.md).
__host__ __device__ constexpr int block_rows(int cs) {
  return 16 * kWarps / cs;
}

__host__ __device__ __forceinline__ int ff_pad(int d_ff) {
  return (d_ff + kChunkF - 1) / kChunkF * kChunkF;
}

// bf16 elements of one ring slot: a W1 chunk [dpad][kW1Pitch] and a W2
// chunk [64][tile_pitch(d)]
__host__ __device__ __forceinline__ int slot_elems(int dpad) {
  return dpad * kW1Pitch + kChunkF * (dpad + 8);
}

// Shared memory of a row kernel: `tiles` activation tiles [rows][lda],
// the two ring slots and two [rows] float row statistics.
__host__ __forceinline__ size_t row_smem(int dpad, int tiles, int rows) {
  return (size_t)(tiles * rows * (dpad + 8) + 2 * slot_elems(dpad)) *
             sizeof(bf16) +
         2 * rows * sizeof(float);
}

// w1b [dpad][ffp] = bf16(w1 [d][d_ff]) and w2b [ffp][dpad] = bf16(w2
// [d_ff][d]), zero in the padding.
__global__ void __launch_bounds__(256)
    b2_round_weights_kernel(const float* __restrict__ w1,
                            const float* __restrict__ w2,
                            bf16* __restrict__ w1b,
                            bf16* __restrict__ w2b, int d, int d_ff, int dpad,
                            int ffp) {
  const size_t n = (size_t)dpad * ffp;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < 2 * n;
       i += (size_t)gridDim.x * blockDim.x) {
    if (i < n) {
      const int r = static_cast<int>(i / ffp), c = static_cast<int>(i % ffp);
      w1b[i] = __float2bfloat16_rn(r < d && c < d_ff ? w1[(size_t)r * d_ff + c]
                                                     : 0.f);
    } else {
      const size_t j = i - n;
      const int r = static_cast<int>(j / dpad), c = static_cast<int>(j % dpad);
      w2b[j] = __float2bfloat16_rn(r < d_ff && c < d ? w2[(size_t)r * d + c]
                                                     : 0.f);
    }
  }
}

// Chunk f0 of the rounded weights into one ring slot with 16-byte cp.async:
// W1s [dpad][kW1Pitch] = w1b[:, f0:f0+64], W2s [64][lda] = w2b[f0:f0+64, :].
__device__ __forceinline__ void stage_chunk(bf16* W1s, bf16* W2s,
                                            const bf16* __restrict__ w1b,
                                            const bf16* __restrict__ w2b,
                                            int f0, int dpad, int ffp,
                                            int lda) {
  constexpr int per1 = kChunkF / 8;
  for (int c = threadIdx.x; c < dpad * per1; c += kBlockThreads) {
    const int r = c / per1, col = (c % per1) * 8;
    cp_async_16(W1s + r * kW1Pitch + col, w1b + (size_t)r * ffp + f0 + col,
                16);
  }
  const int per2 = dpad / 8;
  for (int c = threadIdx.x; c < kChunkF * per2; c += kBlockThreads) {
    const int r = c / per2, col = (c % per2) * 8;
    cp_async_16(W2s + r * lda + col, w2b + (size_t)(f0 + r) * dpad + col, 16);
  }
}

// Mean and 1 / (unbiased std + eps) of the block's rows [0, rows) of x
// (pitch d), one warp a row; rows past `rows` up to kRows get zeros.
template <int kRows>
__device__ __forceinline__ void block_row_stats(const bf16* x, int rows, int d,
                                                float* mean, float* rdenom) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kWarps) {
    float mu = 0.f, rd = 0.f;
    if (r < rows) {
      float var;
      row_moments(x + (size_t)r * d, d, mu, var);
      rd = 1.f / (sqrtf(fmaxf(var, kVarFloor)) + kLnEps);
    }
    if (lane == 0) {
      mean[r] = mu;
      rdenom[r] = rd;
    }
  }
}

// acc[n] (C tiles n < n_tiles, even, at most kN) += A . B over kK 16-deep
// steps with A's fragments in registers (af[kc], from acc_to_a); B as
// warp_product's: kBT false [k][ldb] at the first column, kBT true stored
// transposed [n][ldb] at the first column's row.
template <int kN, int kK, bool kBT>
__device__ __forceinline__ void regs_product(float (*acc)[4],
                                             const uint32_t (*af)[4],
                                             const bf16* Bs, int ldb,
                                             int n_tiles) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kc = 0; kc < kK; ++kc) {
#pragma unroll
    for (int n = 0; n < kN; n += 2) {
      if (n >= n_tiles) break;
      uint32_t b[4];
      if constexpr (kBT)
        ldmatrix_x4(b, Bs + (8 * n + lane % 8 + (lane / 16) * 8) * ldb +
                           kc * 16 + ((lane / 8) % 2) * 8);
      else
        ldmatrix_x4_trans(b, Bs + (kc * 16 + lane % 8 + ((lane / 8) % 2) * 8) *
                                      ldb + 8 * n + (lane / 16) * 8);
      mma_bf16(acc[n], af[kc], b[0], b[1]);
      mma_bf16(acc[n + 1], af[kc], b[2], b[3]);
    }
  }
}

// Copies rows [0, rows) of the staged tile S [rows][lda] (dpad columns) to
// dst [M, dpad] at row m0 with 16-byte stores.
__device__ __forceinline__ void store_tile(bf16* __restrict__ dst,
                                           const bf16* S, int lda, int m0,
                                           int rows, int dpad) {
  const int per_row = dpad / 8;
  for (int c = threadIdx.x; c < rows * per_row; c += kBlockThreads) {
    const int r = c / per_row, col = (c % per_row) * 8;
    *reinterpret_cast<uint4*>(dst + (size_t)(m0 + r) * dpad + col) =
        *reinterpret_cast<const uint4*>(S + r * lda + col);
  }
}

// ---------------------------------------------------------------------------
// forward

// y for the block_rows(kCs) rows of blockIdx.x. kCs warps share a row
// group, each accumulating 128 of the output columns (kCs = 2 for d > 128).
template <int kCs>
__global__ void __launch_bounds__(kBlockThreads)
    b2_fwd_mma_kernel(const bf16* __restrict__ x,
                      const float* __restrict__ ln_scale,
                      const float* __restrict__ ln_bias,
                      const bf16* __restrict__ w1b,
                      const float* __restrict__ b1,
                      const bf16* __restrict__ w2b,
                      const float* __restrict__ b2, bf16* __restrict__ y, int M,
                      int d, int d_ff, DropStream drop_h, DropStream drop_r) {
  constexpr int kRows = block_rows(kCs), kGroups = kWarps / kCs;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dpad = round16(d), lda = tile_pitch(d), ffp = ff_pad(d_ff);
  const int slot = slot_elems(dpad);
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // [kRows][lda] LN(x)
  bf16* ring = As + kRows * lda;                 // 2 x (W1 chunk, W2 chunk)
  float* mean = reinterpret_cast<float*>(ring + 2 * slot);  // [kRows]
  float* rdenom = mean + kRows;                             // [kRows]
  const int m0 = blockIdx.x * kRows, rows = min(kRows, M - m0);
  const bf16* xt = x + (size_t)m0 * d;
  const int nch = ffp / kChunkF;

  stage_chunk(ring, ring + dpad * kW1Pitch, w1b, w2b, 0, dpad, ffp, lda);
  cp_async_commit();
  block_row_stats<kRows>(xt, rows, d, mean, rdenom);
  __syncthreads();
#pragma unroll 4
  for (int e = threadIdx.x; e < kRows * dpad; e += kBlockThreads) {
    const int r = e / dpad, k = e % dpad;
    float v = 0.f;
    if (r < rows && k < d)
      v = (to_float(xt[(size_t)r * d + k]) - mean[r]) * rdenom[r] *
              ln_scale[k] +
          ln_bias[k];
    As[r * lda + k] = __float2bfloat16_rn(v);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % kGroups, c0 = (warp / kGroups) * kColsWarp;
  const int ont = c_tiles(min(kColsWarp, d - c0));
  const bf16* Aw = As + rg * 16 * lda;
  const size_t row_g = (size_t)m0 + rg * 16 + lane / 4;  // row of c[0], c[1]
  float acc[16][4] = {};
  for (int c = 0; c < nch; ++c) {
    const int f0 = c * kChunkF;
    bf16* W1s = ring + (c & 1) * slot;
    if (c + 1 < nch) {
      bf16* next = ring + ((c + 1) & 1) * slot;
      stage_chunk(next, next + dpad * kW1Pitch, w1b, w2b, f0 + kChunkF, dpad,
                  ffp, lda);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // chunk c (and, at c = 0, the LN tile) in place
    float h[8][4] = {};
    warp_product<8, false, false>(h, Aw, lda, W1s, kW1Pitch, dpad / 16, 8);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = f0 + 8 * n + 2 * (lane % 4) + (e & 1);
        float v = 0.f;
        if (f < d_ff) {
          v = fmaxf(h[n][e] + b1[f], 0.f);
          if (drop_h.on)
            v = drop_keep(drop_h, (row_g + 8 * (e >> 1)) * d_ff + f)
                    ? v / drop_h.denom
                    : 0.f;
        }
        h[n][e] = v;
      }
    uint32_t ha[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) acc_to_a(ha[kc], h[2 * kc], h[2 * kc + 1]);
    regs_product<16, 4, false>(acc, ha, W1s + dpad * kW1Pitch + c0, lda, ont);
    __syncthreads();  // the ring slot is read before it is staged again
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t row = row_g + 8 * r;
    if (row >= (size_t)M) continue;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      if (n >= ont) break;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * n + 2 * (lane % 4) + e;
        if (col >= d) continue;
        const size_t i = row * d + col;
        float a = acc[n][2 * r + e] + b2[col];
        if (drop_r.on) a = drop_keep(drop_r, i) ? a / drop_r.denom : 0.f;
        y[i] = __float2bfloat16_rn(to_float(x[i]) + a);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward

// The row kernel for the block_rows(kCs) rows of blockIdx.x (kCs as the
// forward's): writes n_act = round(LN(x)) and dout = round(drop_r(dy))
// [M, dpad], hidden and the gated dh [M, ffp] (zero in the padding), dx and
// the tile's LN partial sums (part_ln row blockIdx.x).
template <int kCs>
__global__ void __launch_bounds__(kBlockThreads)
    b2_bwd_rows_mma_kernel(const bf16* __restrict__ x,
                           const float* __restrict__ ln_scale,
                           const float* __restrict__ ln_bias,
                           const bf16* __restrict__ w1b,
                           const float* __restrict__ b1,
                           const bf16* __restrict__ w2b,
                           const bf16* __restrict__ dy, bf16* __restrict__ dx,
                           bf16* __restrict__ n_act, bf16* __restrict__ dout,
                           bf16* __restrict__ hidden, bf16* __restrict__ dh,
                           float* __restrict__ part_ln, int M, int d, int d_ff,
                           DropStream drop_h, DropStream drop_r) {
  constexpr int kRows = block_rows(kCs), kGroups = kWarps / kCs;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dpad = round16(d), lda = tile_pitch(d), ffp = ff_pad(d_ff);
  const int slot = slot_elems(dpad);
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // [kRows][lda] n
  bf16* Ds = As + kRows * lda;                   // [kRows][lda] dout
  bf16* ring = Ds + kRows * lda;                 // 2 x (W1 chunk, W2 chunk)
  float* mean = reinterpret_cast<float*>(ring + 2 * slot);  // [kRows]
  float* rdenom = mean + kRows;                             // [kRows]
  float* Ns = reinterpret_cast<float*>(ring);  // after the chunks: dn
  const int ldn = d + 1;
  const int m0 = blockIdx.x * kRows, rows = min(kRows, M - m0);
  const size_t o0 = (size_t)m0 * d;
  const bf16* xt = x + o0;
  const int nch = ffp / kChunkF;

  stage_chunk(ring, ring + dpad * kW1Pitch, w1b, w2b, 0, dpad, ffp, lda);
  cp_async_commit();
  block_row_stats<kRows>(xt, rows, d, mean, rdenom);
  __syncthreads();
#pragma unroll 4
  for (int e = threadIdx.x; e < kRows * dpad; e += kBlockThreads) {
    const int r = e / dpad, k = e % dpad;
    float n = 0.f, g = 0.f;
    if (r < rows && k < d) {
      const size_t i = o0 + (size_t)r * d + k;
      n = (to_float(x[i]) - mean[r]) * rdenom[r] * ln_scale[k] + ln_bias[k];
      g = to_float(dy[i]);
      if (drop_r.on) g = drop_keep(drop_r, i) ? g * drop_r.inv : 0.f;
    }
    As[r * lda + k] = __float2bfloat16_rn(n);
    Ds[r * lda + k] = __float2bfloat16_rn(g);
  }
  __syncthreads();
  store_tile(n_act, As, lda, m0, rows, dpad);
  store_tile(dout, Ds, lda, m0, rows, dpad);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % kGroups, c0 = (warp / kGroups) * kColsWarp;
  const bool writer = c0 == 0;  // the first column half writes hidden, dh
  const int ont = c_tiles(min(kColsWarp, d - c0));
  const bf16* Aw = As + rg * 16 * lda;
  const bf16* Dw = Ds + rg * 16 * lda;
  const size_t row_g = (size_t)m0 + rg * 16 + lane / 4;
  float dn[16][4] = {};
  for (int c = 0; c < nch; ++c) {
    const int f0 = c * kChunkF;
    const bf16* W1s = ring + (c & 1) * slot;
    const bf16* W2s = W1s + dpad * kW1Pitch;
    if (c + 1 < nch) {
      bf16* next = ring + ((c + 1) & 1) * slot;
      stage_chunk(next, next + dpad * kW1Pitch, w1b, w2b, f0 + kChunkF, dpad,
                  ffp, lda);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll 1
    for (int step = 0; step < kChunkF / kStepF; ++step) {
      const int fh = f0 + kStepF * step;
      float pre[kStepTiles][4] = {}, g[kStepTiles][4] = {};
      warp_product<kStepTiles, false, false>(pre, Aw, lda, W1s + kStepF * step,
                                             kW1Pitch, dpad / 16, kStepTiles);
      warp_product<kStepTiles, false, true>(g, Dw, lda,
                                            W2s + kStepF * step * lda, lda,
                                            dpad / 16, kStepTiles);
#pragma unroll
      for (int n = 0; n < kStepTiles; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const size_t row = row_g + 8 * r;
          float hv[2], gv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int f = fh + 8 * n + 2 * (lane % 4) + e;
            hv[e] = gv[e] = 0.f;
            if (f < d_ff) {
              const float p = pre[n][2 * r + e] + b1[f];
              hv[e] = fmaxf(p, 0.f);
              gv[e] = g[n][2 * r + e];
              if (drop_h.on) {
                const bool keep = drop_keep(drop_h, row * d_ff + f);
                hv[e] = keep ? hv[e] * drop_h.inv : 0.f;
                gv[e] = keep ? gv[e] * drop_h.inv : 0.f;
              }
              gv[e] = round_to<bf16>(gv[e] * (p > 0.f ? 1.f : 0.f));
            }
            g[n][2 * r + e] = gv[e];
          }
          if (writer && row < (size_t)M) {
            const size_t o = row * ffp + fh + 8 * n + 2 * (lane % 4);
            *reinterpret_cast<__nv_bfloat162*>(hidden + o) =
                __floats2bfloat162_rn(hv[0], hv[1]);
            *reinterpret_cast<__nv_bfloat162*>(dh + o) =
                __floats2bfloat162_rn(gv[0], gv[1]);
          }
        }
      uint32_t ga[kStepTiles / 2][4];
#pragma unroll
      for (int kc = 0; kc < kStepTiles / 2; ++kc)
        acc_to_a(ga[kc], g[2 * kc], g[2 * kc + 1]);
      regs_product<16, kStepTiles / 2, true>(
          dn, ga, W1s + c0 * kW1Pitch + kStepF * step, kW1Pitch, ont);
    }
    __syncthreads();
  }

  // dn to shared memory (over the ring, whose reads are done), then the LN
  // backward in fp32
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = c0 + 8 * n + 2 * (lane % 4) + (e & 1);
      if (n < ont && col < d)
        Ns[(rg * 16 + lane / 4 + 8 * (e >> 1)) * ldn + col] = dn[n][e];
    }
  __syncthreads();
  // backward.cuh's LN backward, whose block is kThreads = kBlockThreads
  ln_backward_tile(xt, dy + o0, dx + o0, Ns, ldn, rows, d, ln_scale,
                   part_ln + (size_t)blockIdx.x * 2 * d, mean, rdenom);
}

// Split blockIdx.z of C = A^T . B and colsum(B) for A [M, lda] (K columns
// used) and B [M, ldb] (N used) bf16, every row a multiple of 16 bytes,
// output tile (blockIdx.x, blockIdx.y) of 64 x 64: part[split] holds C's
// partial [K, N] and then colsum's [N] over rows [split * rows_per_split,
// (split + 1) * rows_per_split), summed 64 rows a step in order through a
// two-slot cp.async ring; only the first row of tiles adds the column sums
// (fp32, of the staged bf16 B).
__global__ void __launch_bounds__(kAtbThreads)
    b2_atb_mma_kernel(const bf16* __restrict__ A, int lda,
                      const bf16* __restrict__ Bm, int ldb,
                      float* __restrict__ part, int M, int K, int N,
                      int rows_per_split) {
  constexpr int kTileElems = kAtbRows * kAtbPitch;
  __shared__ __align__(16) unsigned char smem_raw[2 * 2 * kTileElems * 2];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int k0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const int split = blockIdx.z;
  const int m_begin = split * rows_per_split;
  const int m_end = min(M, m_begin + rows_per_split);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool col_sums = blockIdx.x == 0;
  const int nt = c_tiles(min(kTile, N - n0));
  auto stage = [&](int m, int s) {
    bf16* As = smem + 2 * s * kTileElems;
    stage_tile<kAtbRows, kAtbThreads>(As, kAtbPitch, A + k0, lda, m, m_end,
                                      kTile, lda - k0, true);
    stage_tile<kAtbRows, kAtbThreads>(As + kTileElems, kAtbPitch, Bm + n0, ldb,
                                      m, m_end, kTile, ldb - n0, true);
  };
  float acc[8][4] = {};
  float csum = 0.f;
  if (m_begin < m_end) stage(m_begin, 0);
  cp_async_commit();
  for (int m = m_begin, s = 0; m < m_end; m += kAtbRows, s ^= 1) {
    if (m + kAtbRows < m_end) stage(m + kAtbRows, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* As = smem + 2 * s * kTileElems;
    const bf16* Bs = As + kTileElems;
    warp_product<8, true, false>(acc, As + 16 * warp, kAtbPitch, Bs, kAtbPitch,
                                 kAtbRows / 16, nt);
    if (col_sums && threadIdx.x < kTile)
      for (int mm = 0; mm < kAtbRows; ++mm)
        csum += to_float(Bs[mm * kAtbPitch + threadIdx.x]);
    __syncthreads();  // the slot is read before it is staged again
  }
  float* out = part + (size_t)split * ((size_t)K * N + N);
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = k0 + 16 * warp + lane / 4 + 8 * (e >> 1);
      const int col = n0 + 8 * n + 2 * (lane % 4) + (e & 1);
      if (n < nt && i < K && col < N) out[(size_t)i * N + col] = acc[n][e];
    }
  if (col_sums && threadIdx.x < kTile && n0 + threadIdx.x < N)
    out[(size_t)K * N + n0 + threadIdx.x] = csum;
}

// ---------------------------------------------------------------------------
// launches

cudaError_t round_weights(const void* w1, const void* w2, bf16* w1b, bf16* w2b,
                          int d, int d_ff, cudaStream_t stream) {
  const int dpad = round16(d), ffp = ff_pad(d_ff);
  const size_t n = 2 * (size_t)dpad * ffp;
  const size_t blocks = (n + 255) / 256;
  const int grid = static_cast<int>(blocks < 1024 ? blocks : 1024);
  b2_round_weights_kernel<<<grid, 256, 0, stream>>>(
      static_cast<const float*>(w1), static_cast<const float*>(w2), w1b, w2b,
      d, d_ff, dpad, ffp);
  return cudaGetLastError();
}

// dW = A^T . B [K, N] and db = colsum(B) [N] through `splits` partial sums
// in `part` ([splits, K * N + N] fp32 scratch), reduced in split order.
cudaError_t weight_grad(const bf16* A, int lda, const bf16* B, int ldb,
                        float* part, float* dw, float* db, int M, int K, int N,
                        int splits, cudaStream_t stream) {
  const dim3 grid((K + kTile - 1) / kTile, (N + kTile - 1) / kTile, splits);
  b2_atb_mma_kernel<<<grid, kAtbThreads, 0, stream>>>(
      A, lda, B, ldb, part, M, K, N, split_rows(M, splits));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(part, splits, dw, K * N, db, N, stream);
}

template <int kCs>
cudaError_t launch_fwd(const void* x, const void* ln_scale, const void* ln_bias,
                       const void* b1, const void* b2, void* y, const bf16* w1b,
                       const bf16* w2b, int M, int d, int d_ff,
                       DropStream drop_h, DropStream drop_r,
                       cudaStream_t stream) {
  auto kernel = b2_fwd_mma_kernel<kCs>;
  constexpr int rows = block_rows(kCs);
  const size_t smem = row_smem(round16(d), 1, rows);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(M + rows - 1) / rows, kBlockThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), w1b, static_cast<const float*>(b1),
      w2b, static_cast<const float*>(b2), static_cast<bf16*>(y), M, d, d_ff,
      drop_h, drop_r);
  return cudaGetLastError();
}

struct BwdArgs {
  const void *x, *ln_scale, *ln_bias, *w1, *b1, *w2, *dy;
  void *dx, *dg, *db, *dw1, *db1, *dw2, *db2;
  void *n_act, *dout, *hidden, *dh, *part_1, *part_2, *part_ln, *w1b, *w2b;
  int M, d, d_ff, splits_1, splits_2;
};

template <int kCs>
cudaError_t launch_bwd(const BwdArgs& a, DropStream drop_h, DropStream drop_r,
                       cudaStream_t stream) {
  constexpr int rows = block_rows(kCs);
  const int dpad = round16(a.d), ffp = ff_pad(a.d_ff);
  const int tiles = (a.M + rows - 1) / rows;
  auto* w1b = static_cast<bf16*>(a.w1b);
  auto* w2b = static_cast<bf16*>(a.w2b);
  auto* n_act = static_cast<bf16*>(a.n_act);
  auto* dout = static_cast<bf16*>(a.dout);
  auto* hidden = static_cast<bf16*>(a.hidden);
  auto* dh = static_cast<bf16*>(a.dh);
  auto* part_ln = static_cast<float*>(a.part_ln);
  cudaError_t err = round_weights(a.w1, a.w2, w1b, w2b, a.d, a.d_ff, stream);
  if (err != cudaSuccess) return err;
  auto kernel = b2_bwd_rows_mma_kernel<kCs>;
  const size_t smem = row_smem(dpad, 2, rows);
  if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
  kernel<<<tiles, kBlockThreads, smem, stream>>>(
      static_cast<const bf16*>(a.x), static_cast<const float*>(a.ln_scale),
      static_cast<const float*>(a.ln_bias), w1b,
      static_cast<const float*>(a.b1), w2b, static_cast<const bf16*>(a.dy),
      static_cast<bf16*>(a.dx), n_act, dout, hidden, dh, part_ln, a.M, a.d,
      a.d_ff, drop_h, drop_r);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = weight_grad(n_act, dpad, dh, ffp, static_cast<float*>(a.part_1),
                    static_cast<float*>(a.dw1), static_cast<float*>(a.db1),
                    a.M, a.d, a.d_ff, a.splits_1, stream);
  if (err != cudaSuccess) return err;
  err = weight_grad(hidden, ffp, dout, dpad, static_cast<float*>(a.part_2),
                    static_cast<float*>(a.dw2), static_cast<float*>(a.db2),
                    a.M, a.d_ff, a.d, a.splits_2, stream);
  if (err != cudaSuccess) return err;
  return launch_reduce(part_ln, tiles, static_cast<float*>(a.dg), a.d,
                       static_cast<float*>(a.db), a.d, stream);
}

}  // namespace
}  // namespace allrank

// Launches the forward's two kernels (the weights' rounding, then the row
// kernel) on `stream`; returns 0 or the CUDA error code. x and y are bf16
// [M, d], M = B * L, d <= 256; parameters are fp32, w1 [d, d_ff], w2
// [d_ff, d], d_ff <= 1024; scratch w1b [round16(d), round64(d_ff)] and w2b
// [round64(d_ff), round16(d)] bf16. drop_keys holds {k0, k1, threshold} of
// the hidden stream, then of the output stream (ops/dropout.py); p_hidden /
// p_resid are their rates (0: no dropout).
extern "C" int ffn_sublayer_fwd_mma(const void* x, const void* ln_scale,
                                    const void* ln_bias, const void* w1,
                                    const void* b1, const void* w2,
                                    const void* b2, void* y, void* w1b,
                                    void* w2b, int M, int d, int d_ff,
                                    const unsigned* drop_keys, double p_hidden,
                                    double p_resid, void* stream) {
  using namespace allrank;
  auto s = static_cast<cudaStream_t>(stream);
  if (d < 1 || d > 2 * kColsWarp) return cudaErrorInvalidValue;
  auto* w1r = static_cast<bf16*>(w1b);
  auto* w2r = static_cast<bf16*>(w2b);
  cudaError_t err = round_weights(w1, w2, w1r, w2r, d, d_ff, s);
  if (err != cudaSuccess) return err;
  const auto dh = make_stream(drop_keys, p_hidden);
  const auto dr = make_stream(drop_keys + 3, p_resid);
  if (round16(d) > kColsWarp)
    return launch_fwd<2>(x, ln_scale, ln_bias, b1, b2, y, w1r, w2r, M, d, d_ff,
                         dh, dr, s);
  return launch_fwd<1>(x, ln_scale, ln_bias, b1, b2, y, w1r, w2r, M, d, d_ff,
                       dh, dr, s);
}

// Launches the backward's six kernels and three reductions on `stream`;
// returns 0 or the CUDA error code. Inputs x, parameters and dy (bf16
// [M, d]); outputs dx and the fp32 gradients dg, db [d], dw1 [d, d_ff], db1
// [d_ff], dw2 [d_ff, d], db2 [d]. Scratch from the caller, with dpad =
// round16(d) and ffp = round64(d_ff): n_act and dout [M, dpad], hidden and
// dh [M, ffp], w1b [dpad, ffp] and w2b [ffp, dpad] bf16; fp32 part_1
// [splits_1, d*d_ff + d_ff], part_2 [splits_2, d_ff*d + d], part_ln
// [ceil(M / 64), 2d].
extern "C" int ffn_sublayer_bwd_mma(
    const void* x, const void* ln_scale, const void* ln_bias, const void* w1,
    const void* b1, const void* w2, const void* dy, void* dx, void* dg,
    void* db, void* dw1, void* db1, void* dw2, void* db2, void* n_act,
    void* dout, void* hidden, void* dh, void* part_1, void* part_2,
    void* part_ln, void* w1b, void* w2b, int M, int d, int d_ff,
    int splits_1, int splits_2, const unsigned* drop_keys, double p_hidden,
    double p_resid, void* stream) {
  using namespace allrank;
  if (d < 1 || d > 2 * kColsWarp) return cudaErrorInvalidValue;
  const BwdArgs a{x,      ln_scale, ln_bias, w1,     b1,      w2,     dy,
                  dx,     dg,       db,      dw1,    db1,     dw2,    db2,
                  n_act,  dout,     hidden,  dh,     part_1,  part_2, part_ln,
                  w1b,    w2b,      M,       d,      d_ff,    splits_1,
                  splits_2};
  auto s = static_cast<cudaStream_t>(stream);
  const auto drop_h = make_stream(drop_keys, p_hidden);
  const auto drop_r = make_stream(drop_keys + 3, p_resid);
  if (round16(d) > kColsWarp) return launch_bwd<2>(a, drop_h, drop_r, s);
  return launch_bwd<1>(a, drop_h, drop_r, s);
}
