// B1's bf16 tensor-core tile bodies (attention_block_mma.cu): each of the
// chained kernels' __global__ bodies as a function of its tile index and
// its shared memory, so that the chained kernels (one-line wrappers that
// pass blockIdx) and the whole-encoder kernel B10 (encoder_block_bf16.cuh,
// which walks the tiles of each phase in a cooperative grid) run the same
// code and give the same bits. The dQ body takes its warp count (the
// chained kernel 4, B10 8: each warp's 16 queries are its own), the A^T B
// body its warps too (4: a 64 x 64 tile; 8: 64 x 128).
#pragma once

#include "attention_mma_tiles.cuh"
#include "backward.cuh"
#include "dropout.cuh"
#include "mma_tile.cuh"

namespace allrank {
namespace {

constexpr int kKeyTile = 64;    // keys a staged tile (stage_key_bits')
constexpr int kQueryTile = 64;  // queries a tile of the dK/dV kernel
// the projections: blocks of 8 warps over 64 rows x 128 output columns,
// each warp 16 x 64
constexpr int kGemmThreads = 256, kGemmRows = 64, kGemmCols = 128;
// the weight gradients: blocks of 4 warps over a 64 x 64 output tile, each
// warp 16 x 64, summing 64 rows a step
constexpr int kWgThreads = 128, kWgRows = 64, kWgPitch = kTile + 8;
constexpr int kOutCols = 64;  // Wout columns staged a step of the forward
// warps of the attention + out-projection kernel, 16 queries each (8 kept
// over 4 by an A/B of device time, PERF.md)
constexpr int kOutWarps = 8;
// B4's register caps for the dQ kernel (PERF.md)
constexpr int b1_dq_min_blocks(int dk_max) { return dk_max <= 32 ? 4 : 1; }

// ---------------------------------------------------------------------------
// forward

// qkv[m, :] = round(round(LN(x[m, :])) . round(Wqkv) + bqkv) for the 64-row
// by 128-column tile (bx, by) of the [M, 3d] output.
__device__ __forceinline__ void b1_ln_qkv_mma_tile(
    unsigned char* smem_raw, const bf16* x, const float* __restrict__ ln_scale,
    const float* __restrict__ ln_bias, const float* __restrict__ wqkv,
    const float* __restrict__ bqkv, bf16* qkv, int M, int d, unsigned bx,
    unsigned by) {
  const int dpad = round16(d), lda = tile_pitch(d);
  const int ldb = tile_pitch(kGemmCols), n3 = 3 * d;
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // [64][lda] LN(x)
  bf16* Bs = As + kGemmRows * lda;               // [dpad][ldb] Wqkv columns
  float* mean = reinterpret_cast<float*>(Bs + dpad * ldb);  // [kTile]
  float* rdenom = mean + kTile;                             // [kTile]
  const int m0 = bx * kGemmRows, n0 = by * kGemmCols;
  const int rows = min(kGemmRows, M - m0);
  const bf16* xt = x + (size_t)m0 * d;

  stage_weight<kGemmThreads>(Bs, ldb, wqkv, n3, 0, dpad, d, n0, kGemmCols,
                             n3);
  ln_row_stats(xt, rows, d, mean, rdenom);
  __syncthreads();
#pragma unroll 4
  for (int e = threadIdx.x; e < kGemmRows * dpad; e += kGemmThreads) {
    const int r = e / dpad, k = e % dpad;
    float v = 0.f;
    if (r < rows && k < d)
      v = (to_float(xt[(size_t)r * d + k]) - mean[r]) * rdenom[r] *
              ln_scale[k] +
          ln_bias[k];
    As[r * lda + k] = __float2bfloat16_rn(v);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, wr = 16 * (warp % 4);
  const int c0 = 64 * (warp / 4), cols = min(kGemmCols, n3 - n0) - c0;
  const int nt = c_tiles(cols);
  if (nt <= 0) return;
  float acc[8][4] = {};
  warp_product<8, false, false>(acc, As + wr * lda, lda, Bs + c0, ldb,
                                dpad / 16, nt);
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = wr + lane / 4 + 8 * (e >> 1);
      const int col = c0 + 8 * n + 2 * (lane % 4) + (e & 1);
      if (r < rows && col < cols + c0 && n < nt)
        qkv[(size_t)(m0 + r) * n3 + n0 + col] =
            __float2bfloat16_rn(acc[n][e] + bqkv[n0 + col]);
    }
}

// X3's no_softmax probabilities (b1_attn_out_mma_tile): s (a 64-key
// tile's q . k^T for the warp's 16 rows) leaves as masked(s . scale) .
// 0.001, padded keys NEG_INF_FILL . 0.001, keys past L weight 0; P . v
// rounds it to bf16.
__device__ __forceinline__ void b1_scaled_scores(float (*s)[4],
                                                 const uint32_t* kb,
                                                 float scale) {
  const int lane = threadIdx.x % 32, col = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int bit = 8 * (j & 3) + (e & 1);
      const bool pad = (kb[j >> 2] >> (col + bit)) & 1u;
      const bool past = (kb[2 + (j >> 2)] >> (col + bit)) & 1u;
      s[j][e] = past ? 0.f : (pad ? kNegInfFill : s[j][e] * scale) * 0.001f;
    }
}

// X3's no_pv context (b1_attn_out_mma_tile): for the warp's 16 rows (row0
// in the slate, wrow in the block) and the keys k0.. of a tile of
// normalised P, ctx[row, key] = round(v[row, key] + round(round(P) .
// 0.001)) for key < d_k, written to the head's columns of Cs; rows past L
// get 0.
__device__ __forceinline__ void b1_no_pv_rows(bf16* Cs, int cpitch,
                                              const float (*p)[4],
                                              const bf16* vh, int ld,
                                              int row0, int wrow, int L,
                                              int dk, int k0) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = lane / 4 + 8 * (e >> 1);
      const int key = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
      if (key >= dk) continue;
      float c = 0.f;
      if (row0 + r < L)
        c = to_float(vh[(size_t)(row0 + r) * ld + key]) +
            to_float(__float2bfloat16_rn(
                to_float(__float2bfloat16_rn(p[j][e])) * 0.001f));
      Cs[(wrow + r) * cpitch + key] = __float2bfloat16_rn(c);
    }
}

// y for the 16 kOutWarps queries from bx * 16 kOutWarps of slate
// by: per head B4's two passes over the key tiles on q, k, v read
// in place from qkv, ctx kept for all heads in shared memory, then ctx .
// Wout, bout, the output dropout and x. With `stats` non-null also each
// row's softmax max and sum per head. kMode (common.cuh's AttnMode) is
// kAttnFull for B1 and B10; X3 (attention_variants_mma.cuh) changes one
// stage of the core, at dropout 0 and with `stats` null:
//   kAttnNoSoftmax    one pass: P = round(masked(s . scale) . 0.001)
//   kAttnNormAfterPv  pass 2 rounds exp2(x) unnormalised into P . v and
//                     scales the row by 1 / sum as ctx is stored
//   kAttnNoPv         pass 2 over the key tiles of keys [0, d_k) alone:
//                     ctx = round(v + round(round(P) . 0.001)) at key = col
//   kAttnFrame        no core: ctx = round(round(q + k) + v)
// (kAttnExp2 takes kAttnFull: its exponent is exp2 already, b4_exponent.)
template <int kDk, bool kAligned, int kMode = kAttnFull>
__device__ __forceinline__ void b1_attn_out_mma_tile(
    unsigned char* smem_raw, const bf16* qkv,
    const unsigned char* __restrict__ key_mask, const bf16* x,
    const float* __restrict__ wout, const float* __restrict__ bout, bf16* y,
    float* stats, int L, int d, int h, float scale, DropStream drop_a,
    DropStream drop_r, unsigned bx, unsigned by) {
  static_assert(kMode != kAttnExp2, "exp2 runs kAttnFull's instantiation");
  constexpr int kThreads = 32 * kOutWarps, kRows = 16 * kOutWarps;
  const int dk = d / h, dkp = mma_head_pad(dk), pitch = mma_pitch(dkp);
  const int nkc = dkp / 16, tile = kKeyTile * pitch;
  const int dpad = round16(d), cpitch = tile_pitch(d), ld = 3 * d;
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw);  // [kRows][cpitch] ctx
  bf16* Qs = Cs + kRows * cpitch;   // [kRows][pitch] the head's queries
  bf16* Ks = Qs + kRows * pitch;    // [kStages][64][pitch] key tiles
  bf16* Vs = Ks + kStages * tile;   // [kStages][64][pitch] value tiles
  uint32_t* bits = reinterpret_cast<uint32_t*>(Vs + kStages * tile);
  bf16* Ws = Qs;  // after the heads: [dpad][72] columns of Wout
  const int slate = by, q0 = bx * kRows;
  const bf16* slate_rows = qkv + (size_t)slate * L * ld;
  const unsigned char* padded = key_mask + (size_t)slate * L;
  const int lane = threadIdx.x % 32, wrow = (threadIdx.x / 32) * 16;
  const int n_tiles = (L + kKeyTile - 1) / kKeyTile;
  // steps [0, n_stats) are pass 1 (row statistics), the rest pass 2
  const int n_stats = kMode == kAttnNoSoftmax ? 0 : n_tiles;
  const int n_steps =
      n_stats +
      (kMode == kAttnNoPv ? (dk + kKeyTile - 1) / kKeyTile : n_tiles);
  const float sl = scale * kLog2e;

  // ctx's columns d..dpad are the out-projection's zero padding
  for (int e = threadIdx.x; e < kRows * (dpad - d); e += kThreads)
    Cs[(e / (dpad - d)) * cpitch + d + e % (dpad - d)] =
        __float2bfloat16_rn(0.f);

  if constexpr (kMode == kAttnFrame) {
    for (int e = threadIdx.x; e < kRows * d; e += kThreads) {
      const int r = e / d, c = e % d, q = q0 + r;
      float v = 0.f;
      if (q < L) {
        const bf16* row = slate_rows + (size_t)q * ld;
        v = to_float(__float2bfloat16_rn(to_float(row[c]) +
                                         to_float(row[d + c]))) +
            to_float(row[2 * d + c]);
      }
      Cs[r * cpitch + c] = __float2bfloat16_rn(v);
    }
  }
  for (int head = 0; head < (kMode == kAttnFrame ? 0 : h); ++head) {
    const bf16* qh = slate_rows + head * dk;
    const bf16* kh = qh + d;
    const bf16* vh = qh + 2 * d;
    const size_t g = (size_t)slate * h + head;
    // step i into ring slot b: key tile i mod n, its keys' bits and, in
    // pass 2, its values
    auto stage = [&](int i, int b) {
      const int k0 = (i < n_stats ? i : i - n_stats) * kKeyTile;
      stage_tile<kKeyTile, kThreads>(Ks + b * tile, pitch, kh, ld, k0, L,
                                     dkp, dk, kAligned);
      if (kMode != kAttnNoPv && i >= n_stats)
        stage_tile<kKeyTile, kThreads>(Vs + b * tile, pitch, vh, ld, k0, L,
                                       dkp, dk, kAligned);
      stage_key_bits(bits + 4 * b, padded, k0, L);
    };
    __syncthreads();  // the last head's reads of Qs, the ring and the bits
    stage_tile<kRows, kThreads>(Qs, pitch, qh, ld, q0, L, dkp, dk, kAligned);
    stage(0, 0);
    cp_async_commit();
    // (no_softmax at L <= 64 has one step: nothing is staged that no step
    // waits for)
    if (kMode != kAttnNoSoftmax || n_steps > 1) stage(1, 1);
    cp_async_commit();

    uint32_t qa[kDk / 16][4];
    float o[kDk / 8][4] = {};
    float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f}, ml[2], rinv[2];
    for (int it = 0, buf = 0; it < n_steps;
         ++it, buf = buf == kStages - 1 ? 0 : buf + 1) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      if (it + 2 < n_steps) stage(it + 2, buf == 0 ? kStages - 1 : buf - 1);
      cp_async_commit();
      if (it == 0) {
#pragma unroll
        for (int kc = 0; kc < kDk / 16; ++kc)
          if (kc < nkc)
            ldmatrix_x4(qa[kc], Qs + (wrow + lane % 16) * pitch + kc * 16 +
                                    (lane / 16) * 8);
      }
      const uint32_t* kb = bits + 4 * buf;
      const bool live = (kb[0] | kb[1] | kb[2] | kb[3]) == 0;
      float s[8][4] = {};
      rows_by_rows<kDk, 8, true, false>(s, qa, nullptr, Ks + buf * tile,
                                        pitch, nkc);
      if (it < n_stats) {
        if (live)
          b4_row_stats<true>(s, m, l, kb, scale);
        else
          b4_row_stats<false>(s, m, l, kb, scale);
        continue;
      }
      if (kMode != kAttnNoSoftmax && it == n_stats) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          ml[r] = m[r] * kLog2e;
          rinv[r] = 1.f / l[r];
        }
      }
      const size_t rows_at = (g * L + q0 + wrow) * L +
                             (size_t)(it - n_stats) * kKeyTile;
      if constexpr (kMode == kAttnNoSoftmax) {
        b1_scaled_scores(s, kb, scale);
      } else if constexpr (kMode == kAttnNormAfterPv) {
        const float one[2] = {1.f, 1.f};  // 1 / sum scales ctx instead
        if (live)
          b4_probs<true>(s, ml, one, kb, sl, drop_a, rows_at, L);
        else
          b4_probs<false>(s, ml, one, kb, sl, drop_a, rows_at, L);
      } else {
        if (live)
          b4_probs<true>(s, ml, rinv, kb, sl, drop_a, rows_at, L);
        else
          b4_probs<false>(s, ml, rinv, kb, sl, drop_a, rows_at, L);
      }
      if constexpr (kMode == kAttnNoPv)
        b1_no_pv_rows(Cs + head * dk, cpitch, s, vh, ld, q0 + wrow, wrow, L,
                      dk, (it - n_stats) * kKeyTile);
      else
        weigh_rows<kDk, 4>(o, s, Vs + buf * tile, pitch, nkc);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + wrow + lane / 4 + 8 * r;
      if (stats != nullptr && lane % 4 == 0 && row < L) {
        stats[2 * (g * L + row)] = m[r];
        stats[2 * (g * L + row) + 1] = l[r];
      }
    }
    const float one[2] = {1.f, 1.f};
    if constexpr (kMode == kAttnNormAfterPv)
      store_acc_rows<kDk / 8>(Cs + head * dk, cpitch, o, rinv, wrow, kRows,
                              dk, 2 * nkc);
    else if constexpr (kMode != kAttnNoPv)
      store_acc_rows<kDk / 8>(Cs + head * dk, cpitch, o, one, wrow, kRows,
                              dk, 2 * nkc);
  }

  // the out-projection, 64 columns of Wout at a time
  const int wpitch = tile_pitch(kOutCols);
  for (int n0 = 0; n0 < d; n0 += kOutCols) {
    __syncthreads();  // ctx is complete; the last slice's reads of Ws done
    stage_weight<kThreads>(Ws, wpitch, wout, d, 0, dpad, d, n0, kOutCols, d);
    __syncthreads();
    float acc[kOutCols / 8][4] = {};
    const int nt = c_tiles(min(kOutCols, d - n0));
    warp_product<kOutCols / 8, false, false>(acc, Cs + wrow * cpitch, cpitch,
                                             Ws, wpitch, dpad / 16, nt);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = q0 + wrow + lane / 4 + 8 * r;
      if (q >= L) continue;
#pragma unroll
      for (int n = 0; n < kOutCols / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 8 * n + 2 * (lane % 4) + e;
          if (col >= d) continue;
          const size_t i = ((size_t)slate * L + q) * d + col;
          float a = acc[n][2 * r + e] + bout[col];
          if (drop_r.on) a = drop_keep(drop_r, i) ? a / drop_r.denom : 0.f;
          y[i] = __float2bfloat16_rn(to_float(x[i]) + a);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// backward

// da = round(drop_r(dy)) and dO = round(da . round(Wout)^T) for the 64-row
// by 128-column tile (bx, by) of dO; the tiles of the first
// column tile also write da and n = round(LN(x)) (dWqkv's A operand).
__device__ __forceinline__ void b1_bwd_rows_mma_tile(
    unsigned char* smem_raw, const bf16* x, const bf16* dy,
    const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
    const float* __restrict__ wout, bf16* da, bf16* dO, bf16* n_act, int M,
    int d, DropStream drop_r, unsigned bx, unsigned by) {
  const int dpad = round16(d), lda = tile_pitch(d);
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // [64][lda] da
  bf16* Bs = As + kGemmRows * lda;  // [128][lda] rows n0.. of Wout
  float* mean = reinterpret_cast<float*>(Bs + kGemmCols * lda);  // [kTile]
  float* rdenom = mean + kTile;                                  // [kTile]
  const int m0 = bx * kGemmRows, n0 = by * kGemmCols;
  const int rows = min(kGemmRows, M - m0);
  const bool lead = by == 0;

  stage_weight<kGemmThreads>(Bs, lda, wout, d, n0, kGemmCols, d, 0, dpad, d);
#pragma unroll 4
  for (int e = threadIdx.x; e < kGemmRows * dpad; e += kGemmThreads) {
    const int r = e / dpad, k = e % dpad;
    bf16 v = __float2bfloat16_rn(0.f);
    if (r < rows && k < d) {
      const size_t i = (size_t)(m0 + r) * d + k;
      float f = to_float(dy[i]);
      if (drop_r.on) f = drop_keep(drop_r, i) ? f * drop_r.inv : 0.f;
      v = __float2bfloat16_rn(f);
      if (lead) da[i] = v;
    }
    As[r * lda + k] = v;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, wr = 16 * (warp % 4);
  const int c0 = 64 * (warp / 4), cols = min(kGemmCols, d - n0) - c0;
  const int nt = c_tiles(cols);
  if (nt > 0) {
    float acc[8][4] = {};
    warp_product<8, false, true>(acc, As + wr * lda, lda, Bs + c0 * lda, lda,
                                 dpad / 16, nt);
    const float one[2] = {1.f, 1.f};
    store_acc_rows<8>(dO + (size_t)m0 * d + n0 + c0, d, acc, one, wr, rows,
                      cols, nt);
  }
  if (!lead) return;
  const bf16* xt = x + (size_t)m0 * d;
  ln_row_stats(xt, rows, d, mean, rdenom);
  __syncthreads();
#pragma unroll 4
  for (int e = threadIdx.x; e < rows * d; e += kGemmThreads) {
    const int r = e / d, k = e % d;
    n_act[(size_t)m0 * d + e] = __float2bfloat16_rn(
        (to_float(xt[e]) - mean[r]) * rdenom[r] * ln_scale[k] + ln_bias[k]);
  }
}

// One 32-key half of a key tile in the dQ kernel, the warp's 16 rows: s and
// dp hold S = q . k^T and dP = dO . v^T. Pass 0 (kD) adds dPd * P to each
// row's partial D and leaves P_d = P * keep / (1 - p_drop) in s, for
// ctx += round(P_d) . v; pass 1 leaves dS = P (dPd - D) in s, zero at
// padded keys, past L and at rows past L. P is B4's (b4_exponent); pad and
// past are the half's key bits shifted to this thread's first column;
// rows_at the probability index of (the warp's first row, the half's first
// key).
template <bool kLive, bool kD>
__device__ __forceinline__ void b1_dq_half(float (*s)[4], const float (*dp)[4],
                                           uint32_t pad, uint32_t past,
                                           const bool ok[2], const float ml[2],
                                           const float rinv[2], float D[2],
                                           float sl, const DropStream& drop,
                                           size_t rows_at, int L) {
  const int lane = threadIdx.x % 32, col = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, bit = 8 * j + (e & 1);
      const bool kpad = !kLive && ((pad >> bit) & 1u);
      const bool kpast = !kLive && ((past >> bit) & 1u);
      const float x = kLive ? fmaf(s[j][e], sl, -ml[r])
                            : b4_exponent(s[j][e], sl, ml[r], kpad, kpast);
      const float p = exp2_approx(x) * rinv[r];
      float f = 1.f;
      if (drop.on)
        f = drop_keep(drop, rows_at + (size_t)(lane / 4 + 8 * r) * L + 8 * j +
                                col + (e & 1))
                ? drop.inv
                : 0.f;
      const float dpd = dp[j][e] * f;
      if (kD) {
        D[r] += dpd * p;
        s[j][e] = p * f;
      } else {
        s[j][e] = ok[r] && !kpad && !kpast ? p * (dpd - D[r]) : 0.f;
      }
    }
}

// dQ of one slate-head (by) for 16 kDqWarps queries: B4's dQ
// kernel on q, k, v read in place from qkv and dO from [B*L, d]. Pass 0
// walks the key tiles for D = rowsum(dPd * P), written to Dg, and ctx =
// round(P_d) . v, written to ctx; pass 1 for dS = P (dPd - D), rounded,
// and dQ += dS k, scaled once and written into dqkv's q columns.
template <int kDk, bool kAligned, int kWarps = kDqWarps>
__device__ __forceinline__ void b1_bwd_dq_mma_tile(
    unsigned char* smem_raw, const bf16* qkv,
    const unsigned char* __restrict__ key_mask, const float* stats,
    const bf16* dO, bf16* ctx, float* Dg, bf16* dqkv, int L, int d, int h,
    float scale, DropStream drop, unsigned bx, unsigned by) {
  constexpr int kThreads = 32 * kWarps, kRows = 16 * kWarps;
  const int dk = d / h, dkp = mma_head_pad(dk), pitch = mma_pitch(dkp);
  const int nkc = dkp / 16, tile = kKeyTile * pitch, ld = 3 * d;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kRows][pitch] queries
  bf16* Os = Qs + kRows * pitch;                 // [kRows][pitch] dO rows
  bf16* Ks = Os + kRows * pitch;   // [kStages][64][pitch] key tiles
  bf16* Vs = Ks + kStages * tile;  // [kStages][64][pitch] value tiles
  uint32_t* bits = reinterpret_cast<uint32_t*>(Vs + kStages * tile);
  const int g = by, slate = g / h, head = g % h;
  const int q0 = bx * kRows;
  const size_t srow = (size_t)slate * L;
  const bf16* qh = qkv + srow * ld + head * dk;
  const bf16* kh = qh + d;
  const bf16* vh = qh + 2 * d;
  const bf16* oh = dO + srow * d + head * dk;
  const unsigned char* padded = key_mask + srow;
  const int lane = threadIdx.x % 32, col = 2 * (lane % 4);
  const int row0 = q0 + (threadIdx.x / 32) * 16;
  const int n_tiles = (L + kKeyTile - 1) / kKeyTile, n_steps = 2 * n_tiles;
  const float sl = scale * kLog2e;

  // step i into ring slot b: key tile i mod n, its values and keys' bits
  auto stage = [&](int i, int b) {
    const int k0 = (i < n_tiles ? i : i - n_tiles) * kKeyTile;
    stage_tile<kKeyTile, kThreads>(Ks + b * tile, pitch, kh, ld, k0, L, dkp,
                                   dk, kAligned);
    stage_tile<kKeyTile, kThreads>(Vs + b * tile, pitch, vh, ld, k0, L, dkp,
                                   dk, kAligned);
    stage_key_bits(bits + 4 * b, padded, k0, L);
  };
  stage_tile<kRows, kThreads>(Qs, pitch, qh, ld, q0, L, dkp, dk, kAligned);
  stage_tile<kRows, kThreads>(Os, pitch, oh, d, q0, L, dkp, dk, kAligned);
  stage(0, 0);
  cp_async_commit();
  stage(1, 1);
  cp_async_commit();

  // the rows' statistics as the forward stored them; rows past L take no
  // part
  bool ok[2];
  float ml[2], rinv[2], D[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t row = (size_t)g * L + row0 + lane / 4 + 8 * r;
    ok[r] = row0 + lane / 4 + 8 * r < L;
    ml[r] = ok[r] ? stats[2 * row] * kLog2e : 0.f;
    rinv[r] = ok[r] ? 1.f / stats[2 * row + 1] : 0.f;
  }
  // ctx in pass 0, dQ in pass 1
  float acc[kDk / 8][4] = {};
  for (int it = 0, buf = 0; it < n_steps;
       ++it, buf = buf == kStages - 1 ? 0 : buf + 1) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + 2 < n_steps) stage(it + 2, buf == 0 ? kStages - 1 : buf - 1);
    cp_async_commit();
    const bool pass0 = it < n_tiles;
    if (it == n_tiles) {
      // D is complete: sum the quad's partials, in a fixed order; ctx too
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        D[r] = quad_sum(D[r]);
        if (lane % 4 == 0 && ok[r])
          Dg[(size_t)g * L + row0 + lane / 4 + 8 * r] = D[r];
      }
      const float one[2] = {1.f, 1.f};
      store_acc_rows<kDk / 8>(ctx + srow * d + head * dk, d, acc, one, row0,
                              L, dk, 2 * nkc);
#pragma unroll
      for (int n = 0; n < kDk / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    }
    const int k0 = (pass0 ? it : it - n_tiles) * kKeyTile;
    const uint32_t* kb = bits + 4 * buf;
    const bool live = (kb[0] | kb[1] | kb[2] | kb[3]) == 0;
    // the tile in two halves of 32 keys, half the registers for S and dP
#pragma unroll 1
    for (int hk = 0; hk < 2; ++hk) {
      const bf16* Kh = Ks + buf * tile + 32 * hk * pitch;
      const bf16* Vh = Vs + buf * tile + 32 * hk * pitch;
      const uint32_t pad = kb[hk] >> col, past = kb[2 + hk] >> col;
      const size_t rows_at = ((size_t)g * L + row0) * L + k0 + 32 * hk;
      float s[4][4] = {}, dp[4][4] = {};
      rows_by_rows<kDk, 4, false, false>(s, nullptr, Qs, Kh, pitch, nkc);
      rows_by_rows<kDk, 4, false, true>(dp, nullptr, Os, Vh, pitch, nkc);
      if (pass0) {
        if (live)
          b1_dq_half<true, true>(s, dp, pad, past, ok, ml, rinv, D, sl, drop,
                                 rows_at, L);
        else
          b1_dq_half<false, true>(s, dp, pad, past, ok, ml, rinv, D, sl, drop,
                                  rows_at, L);
        weigh_rows<kDk, 2>(acc, s, Vh, pitch, nkc);
        continue;
      }
      if (live)
        b1_dq_half<true, false>(s, dp, pad, past, ok, ml, rinv, D, sl, drop,
                                rows_at, L);
      else
        b1_dq_half<false, false>(s, dp, pad, past, ok, ml, rinv, D, sl, drop,
                                 rows_at, L);
      weigh_rows<kDk, 2>(acc, s, Kh, pitch, nkc);
    }
  }
  const float f[2] = {scale, scale};
  store_acc_rows<kDk / 8>(dqkv + srow * ld + head * dk, ld, acc, f, row0, L,
                          dk, 2 * nkc);
}

// dK and dV of one slate-head (by) for 16 kDkvWarps keys: B4's
// dK/dV kernel on qkv and dO in place, with q, dO and each query's max,
// 1 / sum and D streamed through the ring; dV += round(P_d)^T dO and dK +=
// round(dS)^T q, scaled at the end, written into dqkv's k and v columns.
template <int kDk, bool kAligned>
__device__ __forceinline__ void b1_bwd_dkv_mma_tile(
    unsigned char* smem_raw, const bf16* qkv,
    const unsigned char* __restrict__ key_mask, const float* stats,
    const float* Dg, const bf16* dO, bf16* dqkv, int L, int d, int h,
    float scale, DropStream drop, unsigned bx, unsigned by) {
  constexpr int kThreads = 32 * kDkvWarps, kRows = 16 * kDkvWarps;
  constexpr int kQ = kQueryTile;
  const int dk = d / h, dkp = mma_head_pad(dk), pitch = mma_pitch(dkp);
  const int nkc = dkp / 16, tile = kQ * pitch, ld = 3 * d;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [kRows][pitch] the keys
  bf16* Vs = Ks + kRows * pitch;                 // [kRows][pitch] the values
  bf16* Qs = Vs + kRows * pitch;   // [kStages][64][pitch] query tiles
  bf16* Os = Qs + kStages * tile;  // [kStages][64][pitch] dO tiles
  // [kStages][3][64]: each query's max in base 2, 1 / sum and D, zero past L
  float* St = reinterpret_cast<float*>(Os + kStages * tile);
  const int g = by, slate = g / h, head = g % h;
  const int kt0 = bx * kRows;
  const size_t srow = (size_t)slate * L;
  const bf16* qh = qkv + srow * ld + head * dk;
  const bf16* kh = qh + d;
  const bf16* vh = qh + 2 * d;
  const bf16* oh = dO + srow * d + head * dk;
  const unsigned char* padded = key_mask + srow;
  const int lane = threadIdx.x % 32, col = 2 * (lane % 4);
  const int key0 = kt0 + (threadIdx.x / 32) * 16;
  const int n_tiles = (L + kQ - 1) / kQ;
  const float sl = scale * kLog2e;

  // query tile t into ring slot b: q, dO and the rows' statistics
  auto stage = [&](int t, int b) {
    const int row0 = t * kQ;
    stage_tile<kQ, kThreads>(Qs + b * tile, pitch, qh, ld, row0, L, dkp, dk,
                             kAligned);
    stage_tile<kQ, kThreads>(Os + b * tile, pitch, oh, d, row0, L, dkp, dk,
                             kAligned);
    float* dst = St + b * 3 * kQ;
    for (int c = threadIdx.x; c < kQ; c += kThreads) {
      const bool in = row0 + c < L;
      const size_t row = (size_t)g * L + row0 + c;
      dst[c] = in ? stats[2 * row] * kLog2e : 0.f;
      dst[kQ + c] = in ? 1.f / stats[2 * row + 1] : 0.f;
      dst[2 * kQ + c] = in ? Dg[row] : 0.f;
    }
  };
  stage_tile<kRows, kThreads>(Ks, pitch, kh, ld, kt0, L, dkp, dk, kAligned);
  stage_tile<kRows, kThreads>(Vs, pitch, vh, ld, kt0, L, dkp, dk, kAligned);
  stage(0, 0);
  cp_async_commit();
  if (n_tiles > 1) stage(1, 1);
  cp_async_commit();

  // this thread's two keys: padded, past L (no part), or live
  bool pad[2], past[2], all_live = true;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + lane / 4 + 8 * r;
    past[r] = key >= L;
    pad[r] = !past[r] && padded[key];
    all_live &= !past[r] && !pad[r];
  }
  // a block of live keys only takes, at query tiles below L, no mask
  all_live = __syncthreads_and(all_live);
  float dk_acc[kDk / 8][4] = {}, dv_acc[kDk / 8][4] = {};
  for (int it = 0, buf = 0; it < n_tiles;
       ++it, buf = buf == kStages - 1 ? 0 : buf + 1) {
    const int q0 = it * kQ;
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + 2 < n_tiles) stage(it + 2, buf == 0 ? kStages - 1 : buf - 1);
    cp_async_commit();
    const float* ml_t = St + buf * 3 * kQ;
    const float* ri_t = ml_t + kQ;
    const float* D_t = ri_t + kQ;
    const bool live = all_live && q0 + kQ <= L;
    // the tile in two halves of 32 queries, half the registers for S^T and
    // dP^T
#pragma unroll 1
    for (int hq = 0; hq < 2; ++hq) {
      const bf16* Qh = Qs + buf * tile + 32 * hq * pitch;
      const bf16* Oh = Os + buf * tile + 32 * hq * pitch;
      float s[4][4] = {}, dp[4][4] = {};
      rows_by_rows<kDk, 4, false, false>(s, nullptr, Ks, Qh, pitch, nkc);
      rows_by_rows<kDk, 4, false, true>(dp, nullptr, Vs, Oh, pitch, nkc);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c0 = 32 * hq + 8 * j + col;
        const float2 ml2 = *reinterpret_cast<const float2*>(ml_t + c0);
        const float2 ri2 = *reinterpret_cast<const float2*>(ri_t + c0);
        const float2 D2 = *reinterpret_cast<const float2*>(D_t + c0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = c0 + (e & 1);
          float pd = 0.f, ds = 0.f;
          if (live || (q0 + c < L && !past[r])) {
            const float x = b4_exponent(s[j][e], sl, e & 1 ? ml2.y : ml2.x,
                                        pad[r], false);
            const float p = exp2_approx(x) * (e & 1 ? ri2.y : ri2.x);
            float f = 1.f;
            if (drop.on) {
              const size_t index =
                  ((size_t)g * L + q0 + c) * L + key0 + lane / 4 + 8 * r;
              f = drop_keep(drop, index) ? drop.inv : 0.f;
            }
            pd = p * f;
            if (live || !pad[r])
              ds = p * (dp[j][e] * f - (e & 1 ? D2.y : D2.x));
          }
          s[j][e] = pd;
          dp[j][e] = ds;
        }
      }
      weigh_rows<kDk, 2>(dv_acc, s, Oh, pitch, nkc);
      weigh_rows<kDk, 2>(dk_acc, dp, Qh, pitch, nkc);
    }
  }
  const float f_k[2] = {scale, scale}, f_v[2] = {1.f, 1.f};
  store_acc_rows<kDk / 8>(dqkv + srow * ld + d + head * dk, ld, dk_acc, f_k,
                          key0, L, dk, 2 * nkc);
  store_acc_rows<kDk / 8>(dqkv + srow * ld + 2 * d + head * dk, ld, dv_acc,
                          f_v, key0, L, dk, 2 * nkc);
}

// dn = dqkv . round(Wqkv)^T for the 64 rows of bx, 64 columns of
// dqkv a step, then the LN backward in fp32 (ln_backward_tile): dx and the
// tile's partial sums of dg and db (part_ln row bx).
__device__ __forceinline__ void b1_bwd_ln_qkv_mma_tile(
    unsigned char* smem_raw, const bf16* x, const bf16* dy, const bf16* dqkv,
    const float* __restrict__ ln_scale, const float* __restrict__ wqkv,
    bf16* dx, float* part_ln, int M, int d, bool vec, unsigned bx) {
  constexpr int kK = 64;
  const int dpad = round16(d), kp = tile_pitch(kK), n3 = 3 * d, ldn = d + 1;
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // [64][kp] dqkv columns
  bf16* Bs = As + kGemmRows * kp;  // [dpad][kp] the same columns of Wqkv
  float* Ns = reinterpret_cast<float*>(Bs + dpad * kp);  // [64][ldn] dn
  float* rmean = Ns + kGemmRows * ldn;                   // [kTile]
  float* rden = rmean + kTile;                           // [kTile]
  const int m0 = bx * kGemmRows, rows = min(kGemmRows, M - m0);
  // the eight warps as 4 x 2 of 16 rows by half of d's columns
  const int warp = threadIdx.x / 32, wr = 16 * (warp % 4);
  const int half = round16(dpad / 2), c0 = warp < 4 ? 0 : half;
  const int nt = c_tiles(warp < 4 ? half : dpad - half);

  float acc[16][4] = {};
  for (int k0 = 0; k0 < n3; k0 += kK) {
    __syncthreads();  // the last step's reads of As and Bs
    stage_tile<kGemmRows, kGemmThreads>(As, kp, dqkv + k0, n3, m0, M, kK,
                                        n3 - k0, vec);
    stage_weight<kGemmThreads>(Bs, kp, wqkv, n3, 0, dpad, d, k0, kK, n3);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (nt > 0)
      warp_product<16, false, true>(acc, As + wr * kp, kp, Bs + c0 * kp, kp,
                                    kK / 16, nt);
  }
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = c0 + 8 * n + 2 * (lane % 4) + (e & 1);
      if (n < nt && col < d)
        Ns[(wr + lane / 4 + 8 * (e >> 1)) * ldn + col] = acc[n][e];
    }
  __syncthreads();
  const size_t o = (size_t)m0 * d;
  ln_backward_tile(x + o, dy + o, dx + o, Ns, ldn, rows, d, ln_scale,
                   part_ln + (size_t)bx * 2 * d, rmean, rden);
}

// Split `split` of C = A^T . B and colsum(B) for A [M, K] and B [M, N]
// bf16, output tile (k_tile, n_tile) of 64 x 16 kWarps: part[split] holds
// C's partial [K, N] and then colsum's [N] over rows [split *
// rows_per_split, (split + 1) * rows_per_split), summed 64 rows a step in
// order; only the first row of tiles adds the column sums (fp32, of the
// staged bf16 B), as backward.cuh's atb_partial_tile does. Four warps (the
// chained kernel's block) take a 64 x 64 tile, each 16 rows of C; eight (a
// whole-encoder block) a 64 x 128 tile, warps 4-7 the second 64 columns.
// smem_raw holds b1_atb_smem(kWarps) bytes.
__host__ __device__ constexpr int b1_atb_smem(int warps) {
  return (kWgRows * kWgPitch + kWgRows * (16 * warps + 8)) * 2;
}

template <int kWarps = 4>
__device__ __forceinline__ void b1_atb_mma_tile(
    unsigned char* smem_raw, const bf16* A, const bf16* Bm, float* part, int M,
    int K, int N, int rows_per_split, bool vec, unsigned bx, unsigned by,
    unsigned bz) {
  constexpr int kThreads = 32 * kWarps, kCols = 16 * kWarps;
  constexpr int kPitch = kWgPitch, kPitchB = kCols + 8;
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // [m][k] A rows
  bf16* Bs = As + kWgRows * kPitch;               // [m][n] B rows
  const int k0 = bx * kTile, n0 = by * kCols;
  const int split = bz;
  const int m_begin = split * rows_per_split;
  const int m_end = min(M, m_begin + rows_per_split);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wk = kWarps == 4 ? 16 * warp : 16 * (warp % 4);
  const int wn = kWarps == 4 ? 0 : 64 * (warp / 4);
  const bool col_sums = bx == 0;
  const int nt = c_tiles(min(kTile, N - n0 - wn));
  float acc[8][4] = {};
  float csum = 0.f;
  for (int m = m_begin; m < m_end; m += kWgRows) {
    __syncthreads();  // the last step's reads
    stage_tile<kWgRows, kThreads>(As, kPitch, A + k0, K, m, m_end, kTile,
                                  K - k0, vec);
    stage_tile<kWgRows, kThreads>(Bs, kPitchB, Bm + n0, N, m, m_end, kCols,
                                  N - n0, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    warp_product<8, true, false>(acc, As + wk, kPitch, Bs + wn, kPitchB,
                                 kWgRows / 16, nt);
    if (col_sums && threadIdx.x < kCols)
      for (int mm = 0; mm < kWgRows; ++mm)
        csum += to_float(Bs[mm * kPitchB + threadIdx.x]);
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
