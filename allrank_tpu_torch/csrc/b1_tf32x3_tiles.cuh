// B1's fp32 tile bodies on the tensor cores as 3xTF32 split products
// (attention_block_tf32x3.cu): each of the chained kernels' __global__
// bodies as a function of its tile index and its shared memory, so that
// the chained kernels (one-line wrappers that pass blockIdx) and the
// whole-encoder kernel B10 (encoder_block_f32.cuh, which walks the tiles of
// each phase in a cooperative grid) run the same code and give the same
// bits. The attention bodies take the block they run in (kBlock threads):
// where it holds more warps than the body's own, as B10's 8-warp block
// does at d_k > 32, the body runs on the first warps, its barriers named
// for them alone (tile_sync), and the others wait at the phase's end.
#pragma once

#include "backward.cuh"
#include "dropout.cuh"
#include "mma_tile_f32.cuh"

namespace allrank {
namespace {

constexpr int kKeyTile = 64;  // keys a staged tile (stage_key_bits')
// the projections: blocks of 8 warps over 64 rows x 128 output columns,
// each warp 16 x 64
constexpr int kGemmThreads = 256, kGemmRows = 64, kGemmCols = 128;
constexpr int kLnK = 64;  // dqkv columns a step of the dn kernel

// Stages rows [row0, row0 + kRows) of a [L, dk] head whose rows lie `ld`
// floats apart from src into S [kRows][f32_pitch(dkp)], zero past L and in
// the columns dk..dkp: kAligned by 16-byte cp.async copies, otherwise
// element by element. (stage_f32's general staging, which decides per
// four columns at run time, took 11 % more of B1's backward device time
// in the attention kernels' rings: PERF.md.)
template <int kRows, int kThreads, bool kAligned>
__device__ __forceinline__ void stage_head_rows(float* S,
                                                const float* __restrict__ src,
                                                size_t ld, int row0, int L,
                                                int dk, int dkp) {
  const int pitch = f32_pitch(dkp);
  if (kAligned) {
    const int per_row = dkp / 4;
    for (int c = threadIdx.x; c < kRows * per_row; c += kThreads) {
      const int r = c / per_row, col = (c % per_row) * 4;
      const bool in = row0 + r < L && col < dk;
      const float* from = in ? src + (size_t)(row0 + r) * ld + col : src;
      cp_async_16(S + r * pitch + col, from, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kRows * dkp; e += kThreads) {
      const int r = e / dkp, col = e % dkp;
      S[r * pitch + col] = (row0 + r < L && col < dk)
                               ? src[(size_t)(row0 + r) * ld + col]
                               : 0.f;
    }
  }
}

// Writes the warp's 16 rows acc * f (rows row0 + g + 8 r) to dst, rows
// `ld` floats apart, below L and columns below dk.
template <int kDk>
__device__ __forceinline__ void store_head_rows(float* __restrict__ dst,
                                                size_t ld,
                                                const float (*acc)[4],
                                                const float f[2], int row0,
                                                int L, int dk, int nk) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + lane / 4 + 8 * r;
    if (row >= L) continue;
#pragma unroll
    for (int n = 0; n < kDk / 8; ++n) {
      if (n >= nk) break;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * (lane % 4) + e;
        if (col < dk) dst[(size_t)row * ld + col] = acc[n][2 * r + e] * f[r];
      }
    }
  }
}

// the warp's part of a 64 x 128 output tile of 8 warps: rows wr.., columns
// c0.. of the tile, nt C tiles (0 where the tile's `cols` end before c0)
struct WarpTile {
  int wr, c0, nt;
};

__device__ __forceinline__ WarpTile gemm_warp_tile(int cols) {
  const int warp = threadIdx.x / 32;
  const int c0 = 64 * (warp / 4);
  return {16 * (warp % 4), c0, c_tiles_f32(min(kGemmCols, cols) - c0)};
}

// ---------------------------------------------------------------------------
// forward

// qkv[m, :] = LN(x[m, :]) . Wqkv + bqkv for the 64-row by 128-column tile
// (bx, by) of the [M, 3d] output.
__device__ __forceinline__ void b1_ln_qkv_tf32x3_tile(
    unsigned char* smem_raw, const float* x, const float* __restrict__ ln_scale,
    const float* __restrict__ ln_bias, const float* __restrict__ wqkv,
    const float* __restrict__ bqkv, float* qkv, int M, int d, bool vec_w,
    unsigned bx, unsigned by) {
  const int dpad = round8(d), lda = f32_row_pitch(d);
  const int ldb = f32_kn_pitch(kGemmCols), n3 = 3 * d;
  float* As = reinterpret_cast<float*>(smem_raw);  // [64][lda] LN(x)
  float* Bs = As + kGemmRows * lda;                // [dpad][ldb] Wqkv columns
  float* mean = Bs + dpad * ldb;                   // [64]
  float* rdenom = mean + kGemmRows;                // [64]
  const int m0 = bx * kGemmRows, n0 = by * kGemmCols;
  const int rows = min(kGemmRows, M - m0);
  const float* xt = x + (size_t)m0 * d;

  stage_f32<kGemmThreads>(Bs, ldb, wqkv, n3, 0, dpad, d, n0, kGemmCols, n3,
                          vec_w);
  cp_async_commit();
  f32_ln_stats<kGemmRows, kGemmThreads / 32>(xt, rows, d, mean, rdenom);
  __syncthreads();
  f32_stage_ln<kGemmRows, kGemmThreads>(As, lda, xt, rows, d, dpad, ln_scale,
                                        ln_bias, mean, rdenom);
  cp_async_wait<0>();
  __syncthreads();

  const WarpTile w = gemm_warp_tile(n3 - n0);
  if (w.nt <= 0) return;
  float acc[8][4] = {};
  f32_product<8, false>(acc, As + w.wr * lda, lda, Bs + w.c0, ldb, dpad / 8,
                        w.nt);
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = w.wr + lane / 4 + 8 * (e >> 1);
      const int col = n0 + w.c0 + 8 * n + 2 * (lane % 4) + (e & 1);
      if (n < w.nt && r < rows && col < n3)
        qkv[(size_t)(m0 + r) * n3 + col] = acc[n][e] + bqkv[col];
    }
}

// The masked, scaled scores of one 64-key tile for the warp's 16 rows, in
// place: padded keys NEG_INF_FILL, keys past L -inf (weight 0); kLive (no
// key of the tile padded or past L) only scales.
template <bool kLive>
__device__ __forceinline__ void b1_scores_f32(float (*s)[4],
                                              const uint32_t* kb,
                                              float scale) {
  const int col = 2 * (threadIdx.x % 4);
  const uint32_t pad[2] = {kb[0] >> col, kb[1] >> col};
  const uint32_t past[2] = {kb[2] >> col, kb[3] >> col};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int bit = 8 * (j & 3) + (e & 1);
      const bool pad_key = !kLive && ((pad[j >> 2] >> bit) & 1u);
      const bool past_key = !kLive && ((past[j >> 2] >> bit) & 1u);
      s[j][e] = past_key  ? -INFINITY
                : pad_key ? kNegInfFill
                          : __fmul_rn(s[j][e], scale);
    }
}

// ctx of one (slate, head) (by = slate * h + head) for the 16
// f32_fwd_warps(kDk) queries of bx: B4's fp32 forward on q, k and v
// read in place from qkv. Pass 1 stages keys only and takes each row's max
// and sum (online, rescaled per tile), pass 2 keys and values for P =
// exp2((sc - max) log2(e)) * (1 / sum) (f32_prob), dropped, and P . v, each
// tile's sum from zero added in fp32. With `stats` non-null also each row's
// max and sum [B, h, L, 2].
template <int kDk, bool kAligned, int kBlock = 32 * f32_fwd_warps(kDk)>
__device__ __forceinline__ void b1_attn_tf32x3_tile(
    unsigned char* smem_raw, const float* qkv,
    const unsigned char* __restrict__ key_mask, float* ctx, float* stats, int L,
    int d, int h, float scale, DropStream drop, unsigned bx, unsigned by) {
  constexpr int kSt = f32_fwd_stages(kDk);
  constexpr int kThreads = 32 * f32_fwd_warps(kDk);
  constexpr int kRows = 16 * f32_fwd_warps(kDk);
  const int dk = d / h, dkp = f32_head_pad(dk), pitch = f32_pitch(dkp);
  const int nk = dkp / 8, tile = kKeyTile * pitch;
  float* Qh = reinterpret_cast<float*>(smem_raw);  // [kRows][pitch] q, hi
  float* Ql = Qh + kRows * pitch;                  // q, lo
  float* Ks = Ql + kRows * pitch;   // [kSt][64][pitch] key tiles
  float* Vs = Ks + kSt * tile;      // [kSt][64][pitch] value tiles
  uint32_t* bits = reinterpret_cast<uint32_t*>(Vs + kSt * tile);
  const int g = by, slate = g / h, head = g % h;
  const int q0 = bx * kRows;
  const size_t ld = 3 * (size_t)d, srow = (size_t)slate * L;
  const float* q = qkv + srow * ld + head * dk;
  const float* k = q + d;
  const float* v = q + 2 * d;
  const unsigned char* padded = key_mask + srow;
  const int lane = threadIdx.x % 32, col = 2 * (lane % 4);
  const int wrow = (threadIdx.x / 32) * 16;
  const int n_tiles = (L + kKeyTile - 1) / kKeyTile, n_steps = 2 * n_tiles;

  // step i into ring slot b: key tile i mod n, its keys' bits and, in pass
  // 2, its values
  auto stage = [&](int i, int b) {
    const int k0 = (i < n_tiles ? i : i - n_tiles) * kKeyTile;
    stage_head_rows<kKeyTile, kThreads, kAligned>(Ks + b * tile, k, ld, k0, L,
                                                  dk, dkp);
    if (i >= n_tiles)
      stage_head_rows<kKeyTile, kThreads, kAligned>(Vs + b * tile, v, ld, k0,
                                                    L, dk, dkp);
    stage_key_bits(bits + 4 * b, padded, k0, L);
  };
  stage_head_rows<kRows, kThreads, kAligned>(Qh, q, ld, q0, L, dk, dkp);
#pragma unroll
  for (int i = 0; i < kSt - 1; ++i) {
    stage(i, i);  // n_steps >= 2
    cp_async_commit();
  }
  cp_async_wait<kSt - 2>();
  tile_sync<kThreads, kBlock>();
  split_planes<kRows, kThreads>(Qh, Ql, pitch, dkp);

  float o[kDk / 8][4] = {};
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f}, rinv[2];
  for (int it = 0, buf = 0; it < n_steps;
       ++it, buf = buf == kSt - 1 ? 0 : buf + 1) {
    // step it has landed; after the barrier every warp is done with the
    // slot that step it + kSt - 1 takes
    cp_async_wait<kSt - 2>();
    tile_sync<kThreads, kBlock>();
    if (it + kSt - 1 < n_steps)
      stage(it + kSt - 1, buf == 0 ? kSt - 1 : buf - 1);
    cp_async_commit();
    const uint32_t* kb = bits + 4 * buf;
    float s[8][4] = {};
    rows_by_rows_f32<kDk, 8, true>(s, Qh, Ql, wrow, Ks + buf * tile, pitch,
                                   nk);
    if ((kb[0] | kb[1] | kb[2] | kb[3]) == 0)
      b1_scores_f32<true>(s, kb, scale);
    else
      b1_scores_f32<false>(s, kb, scale);
    if (it < n_tiles) {
      // pass 1: the rows' running max and sum
      float mx[2][8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          mx[r][j] = fmaxf(s[j][2 * r], s[j][2 * r + 1]);
      float m_new[2], psum[2][8];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        m_new[r] = fmaxf(m[r], quad_max(tree_max8(mx[r])));
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = f32_prob(s[j][e], m_new[e >> 1], 1.f);
          psum[e >> 1][j] = e & 1 ? psum[e >> 1][j] + p : p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = l[r] * f32_prob(m[r], m_new[r], 1.f) +
               quad_sum(tree_sum8(psum[r]));
        m[r] = m_new[r];
      }
      continue;
    }
    if (it == n_tiles) {
#pragma unroll
      for (int r = 0; r < 2; ++r) rinv[r] = 1.f / l[r];
    }
    // pass 2: P, dropped, and P . v
    const size_t rows_at = ((size_t)g * L + q0 + wrow) * L +
                           (size_t)(it - n_tiles) * kKeyTile;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = f32_prob(s[j][e], m[r], rinv[r]);
        if (drop.on)
          p = drop_keep(drop, rows_at + (size_t)(lane / 4 + 8 * r) * L +
                                  8 * j + col + (e & 1))
                  ? p / drop.denom
                  : 0.f;
        s[j][e] = p;
      }
    float t[kDk / 8][4] = {};
    weigh_rows_f32<kDk, 8>(t, s, Vs + buf * tile, pitch, nk);
    add_tiles<kDk>(o, t);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wrow + lane / 4 + 8 * r;
    if (stats != nullptr && lane % 4 == 0 && row < L) {
      stats[2 * ((size_t)g * L + row)] = m[r];
      stats[2 * ((size_t)g * L + row) + 1] = l[r];
    }
  }
  const float one[2] = {1.f, 1.f};
  store_head_rows<kDk>(ctx + srow * d + head * dk, d, o, one, q0 + wrow, L,
                       dk, nk);
}

// y = x + drop_r(ctx . Wout + bout) for the 64-row by 128-column tile
// (bx, by) of the [M, d] output.
__device__ __forceinline__ void b1_out_tf32x3_tile(
    unsigned char* smem_raw, const float* ctx, const float* x,
    const float* __restrict__ wout, const float* __restrict__ bout, float* y,
    int M, int d, bool vec_a, bool vec_w, DropStream drop_r, unsigned bx,
    unsigned by) {
  const int dpad = round8(d), lda = f32_row_pitch(d);
  const int ldb = f32_kn_pitch(kGemmCols);
  float* As = reinterpret_cast<float*>(smem_raw);  // [64][lda] ctx
  float* Bs = As + kGemmRows * lda;                // [dpad][ldb] Wout columns
  const int m0 = bx * kGemmRows, n0 = by * kGemmCols;
  const int rows = min(kGemmRows, M - m0);

  stage_f32<kGemmThreads>(As, lda, ctx, d, m0, kGemmRows, M, 0, dpad, d,
                          vec_a);
  stage_f32<kGemmThreads>(Bs, ldb, wout, d, 0, dpad, d, n0, kGemmCols, d,
                          vec_w);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const WarpTile w = gemm_warp_tile(d - n0);
  if (w.nt <= 0) return;
  float acc[8][4] = {};
  f32_product<8, false>(acc, As + w.wr * lda, lda, Bs + w.c0, ldb, dpad / 8,
                        w.nt);
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = w.wr + lane / 4 + 8 * (e >> 1);
      const int col = n0 + w.c0 + 8 * n + 2 * (lane % 4) + (e & 1);
      if (n >= w.nt || r >= rows || col >= d) continue;
      const size_t i = (size_t)(m0 + r) * d + col;
      float a = acc[n][e] + bout[col];
      if (drop_r.on) a = drop_keep(drop_r, i) ? a / drop_r.denom : 0.f;
      y[i] = x[i] + a;
    }
}

// ---------------------------------------------------------------------------
// backward

// da = drop_r(dy) and dO = da . Wout^T for the 64-row by 128-column tile
// (bx, by) of dO; the tiles of the first column tile also
// write da and n = LN(x) (dWqkv's A operand).
__device__ __forceinline__ void b1_bwd_rows_tf32x3_tile(
    unsigned char* smem_raw, const float* x, const float* dy,
    const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
    const float* __restrict__ wout, float* da, float* dO, float* n_act, int M,
    int d, bool vec_w, DropStream drop_r, unsigned bx, unsigned by) {
  const int dpad = round8(d), lda = f32_row_pitch(d);
  float* As = reinterpret_cast<float*>(smem_raw);  // [64][lda] da
  float* Bs = As + kGemmRows * lda;  // [128][lda] rows n0.. of Wout
  float* mean = Bs + kGemmCols * lda;  // [64]
  float* rdenom = mean + kGemmRows;    // [64]
  const int m0 = bx * kGemmRows, n0 = by * kGemmCols;
  const int rows = min(kGemmRows, M - m0);
  const bool lead = by == 0;

  stage_f32<kGemmThreads>(Bs, lda, wout, d, n0, kGemmCols, d, 0, dpad, d,
                          vec_w);
  cp_async_commit();
  for (int e = threadIdx.x; e < kGemmRows * dpad; e += kGemmThreads) {
    const int r = e / dpad, k = e % dpad;
    float f = 0.f;
    if (r < rows && k < d) {
      const size_t i = (size_t)(m0 + r) * d + k;
      f = dy[i];
      if (drop_r.on) f = drop_keep(drop_r, i) ? f * drop_r.inv : 0.f;
      if (lead) da[i] = f;
    }
    As[r * lda + k] = f;
  }
  cp_async_wait<0>();
  __syncthreads();

  const WarpTile w = gemm_warp_tile(d - n0);
  if (w.nt > 0) {
    float acc[8][4] = {};
    f32_product<8, true>(acc, As + w.wr * lda, lda, Bs + w.c0 * lda, lda,
                         dpad / 8, w.nt);
    const float one[2] = {1.f, 1.f};
    store_head_rows<64>(dO + (size_t)(m0 + w.wr) * d + n0 + w.c0, d, acc, one,
                        0, rows - w.wr, min(kGemmCols, d - n0) - w.c0,
                        w.nt);
  }
  if (!lead) return;
  const float* xt = x + (size_t)m0 * d;
  f32_ln_stats<kGemmRows, kGemmThreads / 32>(xt, rows, d, mean, rdenom);
  __syncthreads();
  for (int e = threadIdx.x; e < rows * d; e += kGemmThreads) {
    const int r = e / d, k = e % d;
    n_act[(size_t)m0 * d + e] =
        (xt[e] - mean[r]) * rdenom[r] * ln_scale[k] + ln_bias[k];
  }
}

// dQ of one (slate, head) (by) for 16 f32_dq_warps(kDk) queries:
// B4's fp32 dQ body (attention_tf32x3.cuh's bwd_dq_tf32x3) on q, k and v
// read in place from qkv and dO from [B*L, d]. Pass 0 walks the key tiles
// for D = rowsum(dPd * P), written to Dg, and ctx = P_d . v, written to
// ctx; pass 1 for dS = P (dPd - D) and dQ += dS k, scaled once and written
// into dqkv's q columns.
template <int kDk, bool kAligned, int kBlock = 32 * f32_dq_warps(kDk)>
__device__ __forceinline__ void b1_bwd_dq_tf32x3_tile(
    unsigned char* smem_raw, const float* qkv,
    const unsigned char* __restrict__ key_mask, const float* stats,
    const float* dO, float* ctx, float* Dg, float* dqkv, int L, int d, int h,
    float scale, DropStream drop, unsigned bx, unsigned by) {
  constexpr int kWarps = f32_dq_warps(kDk), kSt = f32_bwd_stages(kDk);
  constexpr int kThreads = 32 * kWarps, kRows = 16 * kWarps;
  const int dk = d / h, dkp = f32_head_pad(dk), pitch = f32_pitch(dkp);
  const int nk = dkp / 8, tile = kKeyTile * pitch;
  float* Qh = reinterpret_cast<float*>(smem_raw);  // [kRows][pitch] q, hi
  float* Ql = Qh + kRows * pitch;                  // q, lo
  float* Oh = Ql + kRows * pitch;                  // dO, hi
  float* Ol = Oh + kRows * pitch;                  // dO, lo
  float* Ks = Ol + kRows * pitch;   // [kSt][64][pitch] key tiles
  float* Vs = Ks + kSt * tile;      // [kSt][64][pitch] value tiles
  uint32_t* bits = reinterpret_cast<uint32_t*>(Vs + kSt * tile);
  const int g = by, slate = g / h, head = g % h;
  const int q0 = bx * kRows;
  const size_t ld = 3 * (size_t)d, srow = (size_t)slate * L;
  const float* q = qkv + srow * ld + head * dk;
  const float* k = q + d;
  const float* v = q + 2 * d;
  const float* oh = dO + srow * d + head * dk;
  const unsigned char* padded = key_mask + srow;
  const int lane = threadIdx.x % 32, col = 2 * (lane % 4);
  const int wrow = (threadIdx.x / 32) * 16, row0 = q0 + wrow;
  const int n_tiles = (L + kKeyTile - 1) / kKeyTile, n_steps = 2 * n_tiles;

  // step i into ring slot b: key tile i mod n, its values and keys' bits
  auto stage = [&](int i, int b) {
    const int k0 = (i < n_tiles ? i : i - n_tiles) * kKeyTile;
    stage_head_rows<kKeyTile, kThreads, kAligned>(Ks + b * tile, k, ld, k0, L,
                                                  dk, dkp);
    stage_head_rows<kKeyTile, kThreads, kAligned>(Vs + b * tile, v, ld, k0, L,
                                                  dk, dkp);
    stage_key_bits(bits + 4 * b, padded, k0, L);
  };
  stage_head_rows<kRows, kThreads, kAligned>(Qh, q, ld, q0, L, dk, dkp);
  stage_head_rows<kRows, kThreads, kAligned>(Oh, oh, d, q0, L, dk, dkp);
#pragma unroll
  for (int i = 0; i < kSt - 1; ++i) {
    stage(i, i);  // n_steps >= 2
    cp_async_commit();
  }
  cp_async_wait<kSt - 2>();
  tile_sync<kThreads, kBlock>();
  split_planes<kRows, kThreads>(Qh, Ql, pitch, dkp);
  split_planes<kRows, kThreads>(Oh, Ol, pitch, dkp);
  tile_sync<kThreads, kBlock>();

  // the rows' statistics as the forward left them; rows past L take no part
  bool ok[2];
  float sub[2], mul[2], D[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + lane / 4 + 8 * r;
    ok[r] = row < L;
    f32_row_stats<false>(stats, (size_t)g * L + row, ok[r], sub[r], mul[r]);
  }

  // ctx in pass 0, dQ in pass 1
  float acc[kDk / 8][4] = {};
  for (int it = 0, buf = 0; it < n_steps;
       ++it, buf = buf == kSt - 1 ? 0 : buf + 1) {
    cp_async_wait<kSt - 2>();
    tile_sync<kThreads, kBlock>();
    if (it + kSt - 1 < n_steps)
      stage(it + kSt - 1, buf == 0 ? kSt - 1 : buf - 1);
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
      store_head_rows<kDk>(ctx + srow * d + head * dk, d, acc, one, row0, L,
                           dk, nk);
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
      const float* Kh = Ks + buf * tile + 32 * hk * pitch;
      const float* Vh = Vs + buf * tile + 32 * hk * pitch;
      const uint32_t pad = kb[hk] >> col, past = kb[2 + hk] >> col;
      float s[4][4] = {}, dp[4][4] = {};
      rows_by_rows_f32<kDk, 4, true>(s, Qh, Ql, wrow, Kh, pitch, nk);
      rows_by_rows_f32<kDk, 4, true>(dp, Oh, Ol, wrow, Vh, pitch, nk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, bit = 8 * j + (e & 1);
          const bool kpad = !live && ((pad >> bit) & 1u);
          const bool kpast = !live && ((past >> bit) & 1u);
          // past L: no part (P 0); dS is zero there and at padded keys
          const float sc = kpad ? kNegInfFill : __fmul_rn(s[j][e], scale);
          const float p = kpast ? 0.f : f32_prob(sc, sub[r], mul[r]);
          float f = 1.f;
          if (drop.on) {
            const size_t index =
                ((size_t)g * L + row0 + lane / 4 + 8 * r) * L + k0 + 32 * hk +
                8 * j + col + (e & 1);
            f = drop_keep(drop, index) ? drop.inv : 0.f;
          }
          const float dpd = drop.on ? __fmul_rn(dp[j][e], f) : dp[j][e];
          if (pass0) {
            D[r] += dpd * p;
            s[j][e] = p * f;
          } else {
            s[j][e] = ok[r] && !kpad && !kpast ? p * (dpd - D[r]) : 0.f;
          }
        }
      float t[kDk / 8][4] = {};
      weigh_rows_f32<kDk, 4>(t, s, pass0 ? Vh : Kh, pitch, nk);
      add_tiles<kDk>(acc, t);
    }
  }
  const float f[2] = {scale, scale};
  store_head_rows<kDk>(dqkv + srow * ld + head * dk, ld, acc, f, row0, L, dk,
                       nk);
}

// dK and dV of one (slate, head) (by) for 16 f32_dkv_warps(kDk)
// keys: B4's fp32 dK/dV body (attention_tf32x3.cuh's bwd_dkv_tf32x3) on
// qkv and dO in place, q, dO and each query's statistics and D streamed
// through the ring; per 32 queries S^T = K Q^T and dP^T = V dO^T, P^T
// rebuilt as the forward formed P, then dV += P_d^T dO and dK += dS^T q,
// scaled at the end, written into dqkv's k and v columns.
template <int kDk, bool kAligned, int kBlock = 32 * f32_dkv_warps(kDk)>
__device__ __forceinline__ void b1_bwd_dkv_tf32x3_tile(
    unsigned char* smem_raw, const float* qkv,
    const unsigned char* __restrict__ key_mask, const float* stats,
    const float* Dg, const float* dO, float* dqkv, int L, int d, int h,
    float scale, DropStream drop, unsigned bx, unsigned by) {
  constexpr int kWarps = f32_dkv_warps(kDk), kSt = f32_bwd_stages(kDk);
  constexpr int kThreads = 32 * kWarps, kRows = 16 * kWarps, kQ = 64;
  const int dk = d / h, dkp = f32_head_pad(dk), pitch = f32_pitch(dkp);
  const int nk = dkp / 8, tile = kQ * pitch;
  float* Kh = reinterpret_cast<float*>(smem_raw);  // [kRows][pitch] k, hi
  float* Kl = Kh + kRows * pitch;                  // k, lo
  float* Vh = Kl + kRows * pitch;                  // v, hi
  float* Vl = Vh + kRows * pitch;                  // v, lo
  float* Qs = Vl + kRows * pitch;   // [kSt][64][pitch] query tiles
  float* Os = Qs + kSt * tile;      // [kSt][64][pitch] dO tiles
  // [kSt][3][64]: each query's sub and mul (f32_prob) and D, zero past L
  float* St = Os + kSt * tile;
  const int g = by, slate = g / h, head = g % h;
  const int kt0 = bx * kRows;
  const size_t ld = 3 * (size_t)d, srow = (size_t)slate * L;
  const float* q = qkv + srow * ld + head * dk;
  const float* k = q + d;
  const float* v = q + 2 * d;
  const float* oh = dO + srow * d + head * dk;
  const unsigned char* padded = key_mask + srow;
  const int lane = threadIdx.x % 32, col = 2 * (lane % 4);
  const int wrow = (threadIdx.x / 32) * 16, key0 = kt0 + wrow;
  const int n_tiles = (L + kQ - 1) / kQ;

  // query tile t into ring slot b: q, dO and the rows' statistics
  auto stage = [&](int t, int b) {
    const int r0 = t * kQ;
    stage_head_rows<kQ, kThreads, kAligned>(Qs + b * tile, q, ld, r0, L, dk,
                                            dkp);
    stage_head_rows<kQ, kThreads, kAligned>(Os + b * tile, oh, d, r0, L, dk,
                                            dkp);
    float* dst = St + b * 3 * kQ;
    for (int c = threadIdx.x; c < kQ; c += kThreads) {
      const bool in = r0 + c < L;
      const size_t row = (size_t)g * L + r0 + c;
      f32_row_stats<false>(stats, row, in, dst[c], dst[kQ + c]);
      dst[2 * kQ + c] = in ? Dg[row] : 0.f;
    }
  };
  stage_head_rows<kRows, kThreads, kAligned>(Kh, k, ld, kt0, L, dk, dkp);
  stage_head_rows<kRows, kThreads, kAligned>(Vh, v, ld, kt0, L, dk, dkp);
#pragma unroll
  for (int i = 0; i < kSt - 1; ++i) {
    if (i < n_tiles) stage(i, i);
    cp_async_commit();
  }
  cp_async_wait<kSt - 2>();
  tile_sync<kThreads, kBlock>();
  split_planes<kRows, kThreads>(Kh, Kl, pitch, dkp);
  split_planes<kRows, kThreads>(Vh, Vl, pitch, dkp);

  // this thread's two keys: padded, past L (no part), or live
  bool pad[2], past[2], all_live = true;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + lane / 4 + 8 * r;
    past[r] = key >= L;
    pad[r] = !past[r] && padded[key];
    all_live &= !past[r] && !pad[r];
  }
  // a block of live keys only takes, at query tiles below L, no mask; the
  // barrier also completes the split planes
  all_live = tile_sync_and<kThreads, kBlock>(all_live);
  float dk_acc[kDk / 8][4] = {}, dv_acc[kDk / 8][4] = {};
  for (int it = 0, buf = 0; it < n_tiles;
       ++it, buf = buf == kSt - 1 ? 0 : buf + 1) {
    const int q0 = it * kQ;
    cp_async_wait<kSt - 2>();
    tile_sync<kThreads, kBlock>();
    if (it + kSt - 1 < n_tiles)
      stage(it + kSt - 1, buf == 0 ? kSt - 1 : buf - 1);
    cp_async_commit();
    const float* sub_t = St + buf * 3 * kQ;
    const float* mul_t = sub_t + kQ;
    const float* D_t = mul_t + kQ;
    const bool live = all_live && q0 + kQ <= L;
    // the tile in two halves of 32 queries, half the registers for S^T and
    // dP^T
#pragma unroll 1
    for (int hq = 0; hq < 2; ++hq) {
      const float* Qh_ = Qs + buf * tile + 32 * hq * pitch;
      const float* Oh_ = Os + buf * tile + 32 * hq * pitch;
      float s[4][4] = {}, dp[4][4] = {};
      rows_by_rows_f32<kDk, 4, false>(s, Kh, Kl, wrow, Qh_, pitch, nk);
      rows_by_rows_f32<kDk, 4, false>(dp, Vh, Vl, wrow, Oh_, pitch, nk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = 32 * hq + 8 * j + col + (e & 1);
          float pd = 0.f, ds = 0.f;
          if (live || (q0 + c < L && !past[r])) {
            // a padded key scores NEG_INF_FILL; on a fully padded slate
            // its row's max is NEG_INF_FILL too, so P reads the forward's
            // 1 / L, as in the plain version
            const float sc = !live && pad[r] ? kNegInfFill
                                             : __fmul_rn(s[j][e], scale);
            const float p = f32_prob(sc, sub_t[c], mul_t[c]);
            float f = 1.f;
            if (drop.on) {
              const size_t index =
                  ((size_t)g * L + q0 + c) * L + key0 + lane / 4 + 8 * r;
              f = drop_keep(drop, index) ? drop.inv : 0.f;
            }
            pd = p * f;
            if (live || !pad[r])
              ds = p * (__fmul_rn(dp[j][e], f) - D_t[c]);
          }
          s[j][e] = pd;
          dp[j][e] = ds;
        }
      float t[kDk / 8][4] = {};
      weigh_rows_f32<kDk, 4>(t, s, Oh_, pitch, nk);
      add_tiles<kDk>(dv_acc, t);
#pragma unroll
      for (int n = 0; n < kDk / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) t[n][e] = 0.f;
      weigh_rows_f32<kDk, 4>(t, dp, Qh_, pitch, nk);
      add_tiles<kDk>(dk_acc, t);
    }
  }
  const float f_k[2] = {scale, scale}, f_v[2] = {1.f, 1.f};
  store_head_rows<kDk>(dqkv + srow * ld + d + head * dk, ld, dk_acc, f_k,
                       key0, L, dk, nk);
  store_head_rows<kDk>(dqkv + srow * ld + 2 * d + head * dk, ld, dv_acc, f_v,
                       key0, L, dk, nk);
}

// dn = dqkv . Wqkv^T for the 64 rows of bx, 64 columns of dqkv a
// step, then the LN backward in fp32 (ln_backward_tile): dx and the tile's
// partial sums of dg and db (part_ln row bx).
__device__ __forceinline__ void b1_bwd_ln_qkv_tf32x3_tile(
    unsigned char* smem_raw, const float* x, const float* dy, const float* dqkv,
    const float* __restrict__ ln_scale, const float* __restrict__ wqkv,
    float* dx, float* part_ln, int M, int d, bool vec_a, bool vec_w,
    unsigned bx) {
  const int dpad16 = (d + 15) / 16 * 16, kp = f32_row_pitch(kLnK);
  const int n3 = 3 * d, ldn = d + 1;
  float* As = reinterpret_cast<float*>(smem_raw);  // [64][kp] dqkv columns
  float* Bs = As + kGemmRows * kp;   // [dpad16][kp] the same columns of Wqkv
  float* Ns = Bs + dpad16 * kp;      // [64][ldn] dn
  float* rmean = Ns + kGemmRows * ldn;  // [kTile]
  float* rden = rmean + kTile;          // [kTile]
  const int m0 = bx * kGemmRows, rows = min(kGemmRows, M - m0);
  // the eight warps as 4 x 2 of 16 rows by half of d's columns
  const int warp = threadIdx.x / 32, wr = 16 * (warp % 4);
  const int half = (dpad16 / 2 + 15) / 16 * 16, c0 = warp < 4 ? 0 : half;
  const int nt = c_tiles_f32(warp < 4 ? half : dpad16 - half);

  float acc[16][4] = {};
  for (int k0 = 0; k0 < n3; k0 += kLnK) {
    __syncthreads();  // the last step's reads of As and Bs
    stage_f32<kGemmThreads>(As, kp, dqkv, n3, m0, kGemmRows, M, k0, kLnK, n3,
                            vec_a);
    stage_f32<kGemmThreads>(Bs, kp, wqkv, n3, 0, dpad16, d, k0, kLnK, n3,
                            vec_w);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (nt > 0)
      f32_product<16, true>(acc, As + wr * kp, kp, Bs + c0 * kp, kp, kLnK / 8,
                            nt);
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

}  // namespace
}  // namespace allrank
