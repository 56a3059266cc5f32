// The tensor-core tile pieces of the bare bf16 slate-attention kernels, B4
// (attention_fused.cu) and B5 (attention_tiled.cu), on attention_mma.cuh's
// warp-level primitives: the padded and past-L keys of a staged key tile as
// bits, the row-by-row products S = Q K^T and dP = dO V^T (and their
// transposes), the probability-weighted sums O += P V, dQ += dS K,
// dV += P_d^T dO and dK += dS^T Q with P or dS repacked into A fragments in
// registers, the row store, B4's exact-softmax exponent, row statistics and
// probabilities (which B1's tensor-core kernels, attention_block_mma.cu,
// share), the block shapes and the launch plumbing
// (shared-memory sizes, the row-alignment check, the dispatch over the
// padded head widths 32, 64 and 128). Each kernel is one warp per 16 rows
// of its own tile; see attention_mma.cuh for the fragment layouts.
#pragma once

#include "attention_mma.cuh"
#include "common.cuh"
#include "dropout.cuh"

#include <cstdint>
#include <initializer_list>

namespace allrank {

using bf16 = __nv_bfloat16;

constexpr int kStages = 3;      // tiles of the cp.async ring
constexpr float kNegInfFillL2 = kNegInfFill * kLog2e;

// The keys of a 64-key tile as bits, for a block of at least two warps:
// words[h] has bit i set where key k0 + 32 h + i is padded, words[2 + h]
// where it lies past L (weight 0).
__device__ __forceinline__ void stage_key_bits(uint32_t* words,
                                               const unsigned char* padded,
                                               int k0, int L) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp < 2) {
    const int key = k0 + 32 * warp + lane;
    const bool past = key >= L;
    const uint32_t pad = __ballot_sync(0xffffffffu, !past && padded[key]);
    const uint32_t out = __ballot_sync(0xffffffffu, past);
    if (lane == 0) {
      words[warp] = pad;
      words[2 + warp] = out;
    }
  }
}

// max and sum of eight values as a tree (three dependent steps, not seven)
__device__ __forceinline__ float tree_max8(const float v[8]) {
  const float a = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
  const float b = fmaxf(fmaxf(v[4], v[5]), fmaxf(v[6], v[7]));
  return fmaxf(a, b);
}

__device__ __forceinline__ float tree_sum8(const float v[8]) {
  return ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
}

// Accumulates acc[j] += A . B^T over the head: A the warp's 16 rows of As
// (rows 16 warp.., or with kRegA their A fragments a), B the 8 kN rows of
// Bs (C tiles j < kN), both [rows][pitch]: S = Q K^T, dP = dO V^T and their
// transposes. With kSplit each 16-deep step sums into zeros and is added in
// fp32 after: the tensor cores' own fp32 sums truncate, and dP - D cancels
// (to 0 where a row has a single key), so dP takes the IEEE additions.
template <int kDk, int kN, bool kRegA, bool kSplit>
__device__ __forceinline__ void rows_by_rows(float (*acc)[4],
                                             const uint32_t (*a)[4],
                                             const bf16* As, const bf16* Bs,
                                             int pitch, int nkc) {
  const int lane = threadIdx.x % 32, arow = (threadIdx.x / 32) * 16;
#pragma unroll
  for (int kc = 0; kc < kDk / 16; ++kc) {
    if (kc >= nkc) break;
    uint32_t af[4];
    if constexpr (kRegA) {
#pragma unroll
      for (int i = 0; i < 4; ++i) af[i] = a[kc][i];
    } else {
      ldmatrix_x4(af, As + (arow + lane % 16) * pitch + kc * 16 +
                          (lane / 16) * 8);
    }
#pragma unroll
    for (int j = 0; j < kN; j += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, Bs + (8 * j + lane % 8 + (lane / 16) * 8) * pitch +
                         kc * 16 + ((lane / 8) % 2) * 8);
      if (kSplit && kc > 0) {
        float t0[4] = {}, t1[4] = {};
        mma_bf16(t0, af, b[0], b[1]);
        mma_bf16(t1, af, b[2], b[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[j][e] += t0[e];
          acc[j + 1][e] += t1[e];
        }
      } else {
        mma_bf16(acc[j], af, b[0], b[1]);
        mma_bf16(acc[j + 1], af, b[2], b[3]);
      }
    }
  }
}

// acc[n] (C tiles n < dkp / 8) += P . Bs: P the warp's 16 x 16 kKc tile as
// fp32 C tiles p[2 kKc], rounded to bf16 into A fragments, and Bs
// [16 kKc][pitch] the rows it weighs: O += P V, dQ += dS K, dV += P_d^T dO,
// dK += dS^T Q.
template <int kDk, int kKc>
__device__ __forceinline__ void weigh_rows(float (*acc)[4],
                                           const float (*p)[4],
                                           const bf16* Bs, int pitch,
                                           int nkc) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kc = 0; kc < kKc; ++kc) {
    uint32_t pa[4];
    acc_to_a(pa, p[2 * kc], p[2 * kc + 1]);
#pragma unroll
    for (int n = 0; n < kDk / 8; n += 2) {
      if (n >= 2 * nkc) break;
      uint32_t b[4];
      ldmatrix_x4_trans(b, Bs + (16 * kc + lane % 8 + ((lane / 8) % 2) * 8) *
                                    pitch + 8 * n + (lane / 16) * 8);
      mma_bf16(acc[n], pa, b[0], b[1]);
      mma_bf16(acc[n + 1], pa, b[2], b[3]);
    }
  }
}

// Writes the warp's 16 rows acc * f (rows row0 + g + 8 r, factor f[r]) to
// dst [L, dk] in bf16, rows below L.
template <int kDk>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst,
                                           const float (*acc)[4],
                                           const float f[2], int row0, int L,
                                           int dk, int nkc) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + lane / 4 + 8 * r;
    if (row >= L) continue;
#pragma unroll
    for (int n = 0; n < kDk / 8; ++n) {
      if (n >= 2 * nkc) break;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * (lane % 4) + e;
        if (col < dk)
          dst[(size_t)row * dk + col] =
              __float2bfloat16_rn(acc[n][2 * r + e] * f[r]);
      }
    }
  }
}

// The base-2 exponent x of a pair's probability P = exp2(x) * (1 / sum),
// from its row's max in base 2, ml = max * log2(e): at a live key the score
// s = q . k times sl = scale * log2(e), less ml, in one FMA; at a padded key
// NEG_INF_FILL in base 2 less ml (0 on a fully padded slate, whose max is
// NEG_INF_FILL); past L -inf, weight 0. Every bf16 kernel of B4 forms P
// from it, pass 1 of the forward with its running max.
__device__ __forceinline__ float b4_exponent(float s, float sl, float ml,
                                             bool pad, bool past) {
  return past ? -INFINITY : pad ? kNegInfFillL2 - ml : fmaf(s, sl, -ml);
}

// Pass 1 of the forward on one 64-key tile for the warp's 16 rows: s holds
// the tile's q . k^T; each row's running max m (of the scaled, masked
// scores) and sum l of exp2(x) are updated, l rescaled. kLive (no key of
// the tile padded or past L) takes no mask.
template <bool kLive>
__device__ __forceinline__ void b4_row_stats(const float (*s)[4], float m[2],
                                             float l[2], const uint32_t* kb,
                                             float scale) {
  const int lane = threadIdx.x % 32, col = 2 * (lane % 4);
  const uint32_t pad[2] = {kb[0] >> col, kb[1] >> col};
  const uint32_t past[2] = {kb[2] >> col, kb[3] >> col};
  float mx[2][8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float a = s[j][2 * r], b = s[j][2 * r + 1];
      if (!kLive) {
        const int bit = 8 * (j & 3);
        const uint32_t pw = pad[j >> 2] >> bit, qw = past[j >> 2] >> bit;
        a = qw & 1u ? -INFINITY : pw & 1u ? kNegInfFill : a * scale;
        b = (qw >> 1) & 1u ? -INFINITY : (pw >> 1) & 1u ? kNegInfFill
                                                        : b * scale;
      }
      mx[r][j] = fmaxf(a, b);
    }
  const float sl = scale * kLog2e;
  float ml[2], alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // scale > 0: the largest score scaled is the largest scaled score
    const float tmax = quad_max(tree_max8(mx[r]));
    const float m_new = fmaxf(m[r], kLive ? tmax * scale : tmax);
    alpha[r] = exp2_approx((m[r] - m_new) * kLog2e);
    ml[r] = m_new * kLog2e;
    m[r] = m_new;
  }
  float psum[2][8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, bit = 8 * (j & 3) + (e & 1);
      const float x =
          kLive ? fmaf(s[j][e], sl, -ml[r])
                : b4_exponent(s[j][e], sl, ml[r], (pad[j >> 2] >> bit) & 1u,
                              (past[j >> 2] >> bit) & 1u);
      const float p = exp2_approx(x);
      psum[r][j] = e & 1 ? psum[r][j] + p : p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * alpha[r] + quad_sum(tree_sum8(psum[r]));
}

// Pass 2 of the forward on one 64-key tile: s (the tile's q . k^T) leaves
// as the normalised, dropped P, drop(exp2(x) * (1 / sum)) with the keep
// mask's p / (1 - p_drop), for P . v. rows_at is the probability index of
// (the warp's first row, the tile's first key).
template <bool kLive>
__device__ __forceinline__ void b4_probs(float (*s)[4], const float ml[2],
                                         const float rinv[2],
                                         const uint32_t* kb, float sl,
                                         const DropStream& drop,
                                         size_t rows_at, int L) {
  const int lane = threadIdx.x % 32, col = 2 * (lane % 4);
  const uint32_t pad[2] = {kb[0] >> col, kb[1] >> col};
  const uint32_t past[2] = {kb[2] >> col, kb[3] >> col};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, bit = 8 * (j & 3) + (e & 1);
      const float x =
          kLive ? fmaf(s[j][e], sl, -ml[r])
                : b4_exponent(s[j][e], sl, ml[r], (pad[j >> 2] >> bit) & 1u,
                              (past[j >> 2] >> bit) & 1u);
      float p = exp2_approx(x) * rinv[r];
      if (drop.on)
        p = drop_keep(drop, rows_at + (size_t)(lane / 4 + 8 * r) * L + 8 * j +
                                col + (e & 1))
                ? p / drop.denom
                : 0.f;
      s[j][e] = p;
    }
}

// The block shapes, measured at d_k = 32 on the H100 (PERF.md, B5 rows): the
// forward 8 warps (128 queries a block); the dK/dV kernel 8 warps (128
// keys), held to 128 registers so that two blocks fit an SM; the dQ kernel
// 4 warps, held to 102 registers (five blocks). Wider heads need their
// registers for the accumulators and take one block of each.
constexpr int kFwdWarps = 8, kDkvWarps = 8, kDqWarps = 4;
constexpr int dkv_min_blocks(int dk_max) { return dk_max <= 32 ? 2 : 1; }
constexpr int dq_min_blocks(int dk_max) { return dk_max <= 32 ? 5 : 1; }

// Shared memory of the tensor-core kernels in bytes: `rows` bf16 rows of
// the padded head and `extra` bytes after them.
__host__ __forceinline__ size_t mma_smem(int dk, int rows, size_t extra) {
  return (size_t)rows * mma_pitch(mma_head_pad(dk)) * sizeof(bf16) + extra;
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// True when every row of each [L, dk] array in `rows`, of elements of
// elem_bytes (bf16 by default), starts on a 16-byte boundary: dk elements a
// whole number of 16-byte units and each base pointer 16-byte aligned (a
// contiguous view may start anywhere in its storage).
inline bool rows_aligned(int dk, std::initializer_list<const void*> rows,
                         int elem_bytes = 2) {
  if (dk * elem_bytes % 16 != 0) return false;
  for (const void* p : rows)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// Calls launch<kDk, kAligned>(args...) for d_k's padded width class (32, 64
// or 128) and whether the staged rows are 16-byte aligned.
#define MMA_DK_DISPATCH(launch, dk, aligned, ...)                          \
  do {                                                                     \
    const int dkp_ = mma_head_pad(dk);                                     \
    const bool aligned_ = (aligned);                                       \
    if (dkp_ <= 32)                                                        \
      return aligned_ ? launch<32, true>(__VA_ARGS__)                      \
                      : launch<32, false>(__VA_ARGS__);                    \
    if (dkp_ <= 64)                                                        \
      return aligned_ ? launch<64, true>(__VA_ARGS__)                      \
                      : launch<64, false>(__VA_ARGS__);                    \
    return aligned_ ? launch<128, true>(__VA_ARGS__)                       \
                    : launch<128, false>(__VA_ARGS__);                     \
  } while (0)

}  // namespace allrank
