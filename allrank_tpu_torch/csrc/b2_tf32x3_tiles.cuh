// B2's fp32 tile bodies on the tensor cores as 3xTF32 split products
// (ffn_block_tf32x3.cu): each of the chained kernels' __global__ bodies as
// a function of its tile index and its shared memory, so that the chained
// kernels (one-line wrappers that pass blockIdx) and the whole-encoder
// kernel B10 (encoder_block_f32.cuh, which walks the tiles of each phase in
// a cooperative grid) run the same code and give the same bits.
#pragma once

#include "backward.cuh"
#include "dropout.cuh"
#include "mma_tile_f32.cuh"

namespace allrank {
namespace {

// a row kernel's block: eight warps, common.cuh's kThreads (which
// backward.cuh's ln_backward_tile takes)
constexpr int kWarps = 8, kBlockThreads = 32 * kWarps;
static_assert(kBlockThreads == kThreads, "the LN backward's block");
constexpr int kColsWarp = 128;  // output columns a warp accumulates

// Rows of a row kernel's block: 16 a warp, 128 at d <= 128; above, two
// warps share each row group (kCs = 2), 64.
__host__ __device__ constexpr int block_rows(int cs) {
  return 16 * kWarps / cs;
}

// floats of one ring slot: a W1 chunk [w1_rows][f32_kn_pitch(kUnits)] and
// a W2 chunk [kUnits][f32_row_pitch(d)]
__host__ __device__ __forceinline__ int slot_floats(int w1_rows, int chunk,
                                                    int d) {
  return w1_rows * f32_kn_pitch(chunk) + chunk * f32_row_pitch(d);
}

// floats of the ring: its two slots, and at least the backward's dn
// [rows][d + 1], which takes the ring's place after the last chunk
__host__ __device__ __forceinline__ int ring_floats(int w1_rows, int chunk,
                                                    int d, int rows) {
  const int slots = 2 * slot_floats(w1_rows, chunk, d);
  return slots > rows * (d + 1) ? slots : rows * (d + 1);
}

// Shared memory of a row kernel: `tiles` activation tiles [rows][lda], the
// ring and two [rows] float row statistics.
__host__ __forceinline__ size_t row_smem(int d, int tiles, int rows,
                                         int w1_rows, int chunk) {
  return ((size_t)tiles * rows * f32_row_pitch(d) +
          ring_floats(w1_rows, chunk, d, rows) + 2 * rows) *
         sizeof(float);
}

// Chunk f0 of the weights into one ring slot: W1s [w1_rows][w1p] =
// w1[:, f0:f0 + kUnits] and W2s [kUnits][lda] = w2[f0:f0 + kUnits, :],
// zero past d, d_ff and in the padding.
template <int kUnits>
__device__ __forceinline__ void stage_chunk(float* W1s, float* W2s,
                                            const float* __restrict__ w1,
                                            const float* __restrict__ w2,
                                            int f0, int w1_rows, int d,
                                            int d_ff, bool vec1, bool vec2) {
  const int dpad16 = (d + 15) / 16 * 16;
  stage_f32<kBlockThreads>(W1s, f32_kn_pitch(kUnits), w1, d_ff, 0, w1_rows,
                           d, f0, kUnits, d_ff, vec1);
  stage_f32<kBlockThreads>(W2s, f32_row_pitch(d), w2, d, f0, kUnits, d_ff, 0,
                           dpad16, d, vec2);
}

// ---------------------------------------------------------------------------
// forward

// y for the block_rows(kCs) rows of bx. kCs warps share a row
// group, each accumulating 128 of the output columns (kCs = 2 for d > 128);
// kUnits hidden units a chunk.
template <int kCs, int kUnits>
__device__ __forceinline__ void b2_fwd_tf32x3_tile(
    unsigned char* smem_raw, const float* x, const float* __restrict__ ln_scale,
    const float* __restrict__ ln_bias, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, float* y, int M, int d, int d_ff, bool vec1,
    bool vec2, DropStream drop_h, DropStream drop_r, unsigned bx) {
  constexpr int kRows = block_rows(kCs), kGroups = kWarps / kCs;
  constexpr int kSteps = kUnits / 8;
  const int dpad = round8(d), lda = f32_row_pitch(d);
  const int w1p = f32_kn_pitch(kUnits), slot = slot_floats(dpad, kUnits, d);
  float* As = reinterpret_cast<float*>(smem_raw);  // [kRows][lda] LN(x)
  float* ring = As + kRows * lda;  // 2 x (W1 chunk, W2 chunk)
  float* mean = ring + ring_floats(dpad, kUnits, d, kRows);  // [kRows]
  float* rdenom = mean + kRows;    // [kRows]
  const int m0 = bx * kRows, rows = min(kRows, M - m0);
  const float* xt = x + (size_t)m0 * d;
  const int nch = (d_ff + kUnits - 1) / kUnits;

  stage_chunk<kUnits>(ring, ring + dpad * w1p, w1, w2, 0, dpad, d, d_ff,
                      vec1, vec2);
  cp_async_commit();
  f32_ln_stats<kRows, kWarps>(xt, rows, d, mean, rdenom);
  __syncthreads();
  f32_stage_ln<kRows, kBlockThreads>(As, lda, xt, rows, d, dpad, ln_scale,
                                     ln_bias, mean, rdenom);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % kGroups, c0 = (warp / kGroups) * kColsWarp;
  const int ont = c_tiles_f32(min(kColsWarp, d - c0));
  const float* Aw = As + rg * 16 * lda;
  const size_t row_g = (size_t)m0 + rg * 16 + lane / 4;  // row of c[0], c[1]
  float acc[16][4] = {};
  for (int c = 0; c < nch; ++c) {
    const int f0 = c * kUnits;
    const float* W1s = ring + (c & 1) * slot;
    if (c + 1 < nch) {
      float* next = ring + ((c + 1) & 1) * slot;
      stage_chunk<kUnits>(next, next + dpad * w1p, w1, w2, f0 + kUnits, dpad,
                          d, d_ff, vec1, vec2);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // chunk c (and, at c = 0, the LN tile) in place
    float h[kSteps][4] = {};
    f32_product<kSteps, false>(h, Aw, lda, W1s, w1p, dpad / 8, kSteps);
#pragma unroll
    for (int n = 0; n < kSteps; ++n)
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
    f32_regs_product<16, kSteps, false>(acc, h, W1s + dpad * w1p + c0, lda,
                                        ont);
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
        y[i] = x[i] + a;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward

// The row kernel for the block_rows(kCs) rows of bx (kCs as the
// forward's, kUnits hidden units a step): writes n_act = LN(x) and dout =
// drop_r(dy) [M, d], hidden and the gated dh [M, d_ff], dx and the tile's
// LN partial sums (part_ln row bx).
template <int kCs, int kUnits>
__device__ __forceinline__ void b2_bwd_rows_tf32x3_tile(
    unsigned char* smem_raw, const float* x, const float* __restrict__ ln_scale,
    const float* __restrict__ ln_bias, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2, const float* dy,
    float* dx, float* n_act, float* dout, float* hidden, float* dh,
    float* part_ln, int M, int d, int d_ff, bool vec1, bool vec2,
    DropStream drop_h, DropStream drop_r, unsigned bx) {
  constexpr int kRows = block_rows(kCs), kGroups = kWarps / kCs;
  constexpr int kSteps = kUnits / 8;
  const int dpad = round8(d), dpad16 = (d + 15) / 16 * 16;
  const int lda = f32_row_pitch(d), w1p = f32_kn_pitch(kUnits);
  const int slot = slot_floats(dpad16, kUnits, d);
  float* As = reinterpret_cast<float*>(smem_raw);  // [kRows][lda] n
  float* Ds = As + kRows * lda;                    // [kRows][lda] dout
  float* ring = Ds + kRows * lda;  // 2 x (W1 chunk, W2 chunk)
  float* mean = ring + ring_floats(dpad16, kUnits, d, kRows);  // [kRows]
  float* rdenom = mean + kRows;    // [kRows]
  float* Ns = ring;                // after the chunks: dn [kRows][d + 1]
  const int ldn = d + 1;
  const int m0 = bx * kRows, rows = min(kRows, M - m0);
  const size_t o0 = (size_t)m0 * d;
  const float* xt = x + o0;
  const int nch = (d_ff + kUnits - 1) / kUnits;

  stage_chunk<kUnits>(ring, ring + dpad16 * w1p, w1, w2, 0, dpad16, d, d_ff,
                      vec1, vec2);
  cp_async_commit();
  f32_ln_stats<kRows, kWarps>(xt, rows, d, mean, rdenom);
  __syncthreads();
  for (int e = threadIdx.x; e < kRows * dpad; e += kBlockThreads) {
    const int r = e / dpad, k = e % dpad;
    float n = 0.f, g = 0.f;
    if (r < rows && k < d) {
      const size_t i = o0 + (size_t)r * d + k;
      n = (x[i] - mean[r]) * rdenom[r] * ln_scale[k] + ln_bias[k];
      g = dy[i];
      if (drop_r.on) g = drop_keep(drop_r, i) ? g * drop_r.inv : 0.f;
      n_act[i] = n;
      dout[i] = g;
    }
    As[r * lda + k] = n;
    Ds[r * lda + k] = g;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % kGroups, c0 = (warp / kGroups) * kColsWarp;
  const bool writer = c0 == 0;  // the first column half writes hidden, dh
  const int ont = c_tiles_f32(min(kColsWarp, d - c0));
  const float* Aw = As + rg * 16 * lda;
  const float* Dw = Ds + rg * 16 * lda;
  const size_t row_g = (size_t)m0 + rg * 16 + lane / 4;
  float dn[16][4] = {};
  for (int c = 0; c < nch; ++c) {
    const int f0 = c * kUnits;
    const float* W1s = ring + (c & 1) * slot;
    const float* W2s = W1s + dpad16 * w1p;
    if (c + 1 < nch) {
      float* next = ring + ((c + 1) & 1) * slot;
      stage_chunk<kUnits>(next, next + dpad16 * w1p, w1, w2, f0 + kUnits,
                          dpad16, d, d_ff, vec1, vec2);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // chunk c (and, at c = 0, the n and dout tiles)
    float pre[kSteps][4] = {}, g[kSteps][4] = {};
    f32_product<kSteps, false>(pre, Aw, lda, W1s, w1p, dpad / 8, kSteps);
    f32_product<kSteps, true>(g, Dw, lda, W2s, lda, dpad / 8, kSteps);
#pragma unroll
    for (int n = 0; n < kSteps; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const size_t row = row_g + 8 * (e >> 1);
        const int f = f0 + 8 * n + 2 * (lane % 4) + (e & 1);
        float hv = 0.f, gv = 0.f;
        if (f < d_ff) {
          const float p = pre[n][e] + b1[f];
          hv = fmaxf(p, 0.f);
          gv = g[n][e];
          if (drop_h.on) {
            const bool keep = drop_keep(drop_h, row * d_ff + f);
            hv = keep ? hv * drop_h.inv : 0.f;
            gv = keep ? gv * drop_h.inv : 0.f;
          }
          gv = p > 0.f ? gv : 0.f;
          if (writer && row < (size_t)M) {
            hidden[row * d_ff + f] = hv;
            dh[row * d_ff + f] = gv;
          }
        }
        g[n][e] = gv;
      }
    f32_regs_product<16, kSteps, true>(dn, g, W1s + c0 * w1p, w1p, ont);
    __syncthreads();  // the ring slot is read before it is staged again
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
                   part_ln + (size_t)bx * 2 * d, mean, rdenom);
}

}  // namespace
}  // namespace allrank
