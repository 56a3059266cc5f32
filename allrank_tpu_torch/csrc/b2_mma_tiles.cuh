// B2's bf16 tensor-core tile bodies (ffn_block_mma.cu): each of the chained
// kernels' __global__ bodies as a function of its tile index and its shared
// memory, so that the chained kernels (one-line wrappers that pass
// blockIdx) and the whole-encoder kernel B10 (encoder_block_bf16.cuh, which
// walks the tiles of each phase in a cooperative grid) run the same code
// and give the same bits. The weights' rounding takes its range of
// elements; the A^T B body its warps (4: a 64 x 64 tile; 8: 64 x 128).
#pragma once

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
// [d_ff][d]), zero in the padding: elements start, start + step, ... of
// the two arrays in a row.
__device__ __forceinline__ void b2_round_weights_range(
    const float* __restrict__ w1, const float* __restrict__ w2,
    bf16* w1b, bf16* w2b, int d, int d_ff, int dpad,
    int ffp, size_t start, size_t step) {
  const size_t n = (size_t)dpad * ffp;
  for (size_t i = start; i < 2 * n; i += step) {
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

// y for the block_rows(kCs) rows of bx. kCs warps share a row
// group, each accumulating 128 of the output columns (kCs = 2 for d > 128).
template <int kCs>
__device__ __forceinline__ void b2_fwd_mma_tile(
    unsigned char* smem_raw, const bf16* x, const float* __restrict__ ln_scale,
    const float* __restrict__ ln_bias, const bf16* w1b,
    const float* __restrict__ b1, const bf16* w2b, const float* __restrict__ b2,
    bf16* y, int M, int d, int d_ff, DropStream drop_h, DropStream drop_r,
    unsigned bx) {
  constexpr int kRows = block_rows(kCs), kGroups = kWarps / kCs;
  const int dpad = round16(d), lda = tile_pitch(d), ffp = ff_pad(d_ff);
  const int slot = slot_elems(dpad);
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // [kRows][lda] LN(x)
  bf16* ring = As + kRows * lda;                 // 2 x (W1 chunk, W2 chunk)
  float* mean = reinterpret_cast<float*>(ring + 2 * slot);  // [kRows]
  float* rdenom = mean + kRows;                             // [kRows]
  const int m0 = bx * kRows, rows = min(kRows, M - m0);
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

// The row kernel for the block_rows(kCs) rows of bx (kCs as the
// forward's): writes n_act = round(LN(x)) and dout = round(drop_r(dy))
// [M, dpad], hidden and the gated dh [M, ffp] (zero in the padding), dx and
// the tile's LN partial sums (part_ln row bx).
template <int kCs>
__device__ __forceinline__ void b2_bwd_rows_mma_tile(
    unsigned char* smem_raw, const bf16* x, const float* __restrict__ ln_scale,
    const float* __restrict__ ln_bias, const bf16* w1b,
    const float* __restrict__ b1, const bf16* w2b, const bf16* dy, bf16* dx,
    bf16* n_act, bf16* dout, bf16* hidden, bf16* dh, float* part_ln, int M,
    int d, int d_ff, DropStream drop_h, DropStream drop_r, unsigned bx) {
  constexpr int kRows = block_rows(kCs), kGroups = kWarps / kCs;
  const int dpad = round16(d), lda = tile_pitch(d), ffp = ff_pad(d_ff);
  const int slot = slot_elems(dpad);
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // [kRows][lda] n
  bf16* Ds = As + kRows * lda;                   // [kRows][lda] dout
  bf16* ring = Ds + kRows * lda;                 // 2 x (W1 chunk, W2 chunk)
  float* mean = reinterpret_cast<float*>(ring + 2 * slot);  // [kRows]
  float* rdenom = mean + kRows;                             // [kRows]
  float* Ns = reinterpret_cast<float*>(ring);  // after the chunks: dn
  const int ldn = d + 1;
  const int m0 = bx * kRows, rows = min(kRows, M - m0);
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
                   part_ln + (size_t)bx * 2 * d, mean, rdenom);
}

// Split `split` of C = A^T . B and colsum(B) for A [M, lda] (K columns
// used) and B [M, ldb] (N used) bf16, every row a multiple of 16 bytes,
// output tile (k_tile, n_tile) of 64 x 16 kWarps: part[split] holds C's
// partial [K, N] and then colsum's [N] over rows [split * rows_per_split,
// (split + 1) * rows_per_split), summed 64 rows a step in order through a
// two-slot cp.async ring; only the first row of tiles adds the column sums
// (fp32, of the staged bf16 B). Four warps (the chained kernel's block)
// take a 64 x 64 tile, each 16 rows of C; eight (a whole-encoder block) a
// 64 x 128 tile, warps 4-7 the second 64 columns. smem_raw holds
// b2_atb_smem(kWarps) bytes.
__host__ __device__ constexpr int b2_atb_smem(int warps) {
  return 2 * (kAtbRows * kAtbPitch + kAtbRows * (16 * warps + 8)) * 2;
}

template <int kWarps = 4>
__device__ __forceinline__ void b2_atb_mma_tile(
    unsigned char* smem_raw, const bf16* A, int lda, const bf16* Bm, int ldb,
    float* part, int M, int K, int N, int rows_per_split, unsigned bx,
    unsigned by, unsigned bz) {
  constexpr int kThreads = 32 * kWarps, kCols = 16 * kWarps;
  constexpr int kPitchB = kCols + 8;
  constexpr int kTileElems = kAtbRows * kAtbPitch;
  constexpr int kSlot = kTileElems + kAtbRows * kPitchB;
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int k0 = bx * kTile, n0 = by * kCols;
  const int split = bz;
  const int m_begin = split * rows_per_split;
  const int m_end = min(M, m_begin + rows_per_split);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wk = kWarps == 4 ? 16 * warp : 16 * (warp % 4);
  const int wn = kWarps == 4 ? 0 : 64 * (warp / 4);
  const bool col_sums = bx == 0;
  const int nt = c_tiles(min(kTile, N - n0 - wn));
  auto stage = [&](int m, int s) {
    bf16* As = smem + s * kSlot;
    stage_tile<kAtbRows, kThreads>(As, kAtbPitch, A + k0, lda, m, m_end,
                                   kTile, lda - k0, true);
    stage_tile<kAtbRows, kThreads>(As + kTileElems, kPitchB, Bm + n0, ldb, m,
                                   m_end, kCols, ldb - n0, true);
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
    const bf16* As = smem + s * kSlot;
    const bf16* Bs = As + kTileElems;
    warp_product<8, true, false>(acc, As + wk, kAtbPitch, Bs + wn, kPitchB,
                                 kAtbRows / 16, nt);
    if (col_sums && threadIdx.x < kCols)
      for (int mm = 0; mm < kAtbRows; ++mm)
        csum += to_float(Bs[mm * kPitchB + threadIdx.x]);
    __syncthreads();  // the slot is read before it is staged again
  }
  float* out = part + (size_t)split * ((size_t)K * N + N);
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = k0 + wk + lane / 4 + 8 * (e >> 1);
      const int col = n0 + wn + 8 * n + 2 * (lane % 4) + (e & 1);
      if (n < nt && i < K && col < N) out[(size_t)i * N + col] = acc[n][e];
    }
  if (col_sums && threadIdx.x < kCols && n0 + threadIdx.x < N)
    out[(size_t)K * N + n0 + threadIdx.x] = csum;
}

}  // namespace
}  // namespace allrank
