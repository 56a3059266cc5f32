// B4: masked slate attention with the exact, normalised probabilities,
// forward and backward, for Hopper (sm_90a), fp32 or bf16 q, k, v:
//   out = drop(P) . v,  P = softmax(q . k^T / sqrt(d_k), padded keys -1e9)
// with P formed as exp(s - max) * (1 / sum) and dropout on P from the keyed
// hash of csrc/dropout.cuh (stream ATTN_PROBS, index
// ((b * h + head) * L + i) * L + j).
//
// Replaces the TPU kernel `fused_slate_attention` of the JAX package's
// ops/attention_pallas.py: forward pallas_call at line 179 (math in
// _fwd_kernel, lines 82-92), backward at line 206 (_bwd_kernel, 95-117).
//
// What bounds it: the L x L products, 4 * L^2 * d_k operations per
// slate-head forward and 10 * L^2 * d_k backward, against O(L * d_k) bytes,
// so operations; and beside them the exponentials on the special-function
// unit (16 a clock per SM), at least one a (query, key) pair forward and two
// backward. At d_k = 32 in bf16 the exps, not the tensor cores, set the
// floor; this design takes two a pair forward and three backward.
//
// What the design does about it, and about the TPU kernel's assumptions:
//  * The TPU kernel holds whole [L, L] probability tiles in VMEM (its cap of
//    1224 is a VMEM fact). A block here has 227 KB: one slate-head's
//    [1200, 1200] fp32 tile is 5.8 MB. So a block walks the key tiles twice:
//    a first pass takes each row's max and sum (online, rescaled per tile),
//    a second recomputes the scores, forms P exactly as the TPU kernel's
//    _probs does, drops it, rounds it to v's dtype and accumulates P . v.
//    In training the row max and sum [G, L, 2] are kept.
//  * bf16 runs on the tensor cores, on B5's pieces (attention_mma_tiles.cuh):
//    every product is an mma.sync.m16n8k16 bf16 x bf16 -> fp32, the TPU
//    kernel's _dot. The forward is one block of eight warps per (slate-head,
//    128 queries), each warp 16 query rows with their q as A fragments in
//    registers; 64-key tiles stream through a three-slot cp.async ring,
//    pass 1's keys and then pass 2's keys and values as one sequence. P goes
//    from the fp32 accumulator to the A fragment of P . v in registers,
//    rounded to bf16 where the TPU kernel rounds it: the normalised, dropped
//    P (p.astype(v.dtype), line 92), not B5's unnormalised p_acc. Exps are
//    base 2 on the special-function unit, every kernel's exponent from one
//    function (b4_exponent), so the backward rebuilds the forward's P bit for
//    bit. A tile of live keys only takes no mask.
//  * The bf16 backward is two kernels with no atomics and sums in a fixed
//    order, the dQ kernel first. It walks the key tiles twice per 64
//    queries: first D = rowsum(dPd * P), the TPU kernel's own row term
//    (where a row has one key it cancels dP exactly), written for the
//    second kernel; then dS = P (dPd - D), zero at padded keys, rounded to
//    bf16, and dQ += dS K. The dK/dV kernel per 128 keys walks 64-query
//    tiles in B5's transposed layout, S^T = K Q^T and dP^T = V dO^T, so that
//    P^T and dS^T come out as the A fragments of dV += round(P_d)^T dO and
//    dK += round(dS)^T Q. Both take S and dP over 32-wide halves of a tile;
//    dP sums each 16-deep step from zero and adds the steps in fp32.
//  * fp32 runs on the tensor cores as 3xTF32 split products
//    (attention_tf32x3.cuh: three TF32 products an fp32 one, some 2^-21 of
//    it, the parity fp32 promises), in the bf16 kernels' flow: the forward's
//    two passes (fused_fwd_tf32x3_kernel), then a dQ kernel whose first walk
//    takes D = rowsum(dPd * P) and a dK/dV kernel, both shared with B5. Its
//    bound is the operations at a third of the card's 495 TFLOP/s TF32
//    rate: 0.036 / 0.089 ms at (8, 4, 1200, 32), 0.42 / 1.04 ms at
//    (8, 4, 4096, 32), where the SIMT fp32 FMAs it replaces were bound at
//    0.088 / 0.22 and 1.03 / 2.56 ms. Every fp32 kernel forms P
//    from the scaled score less the row's max (f32_prob), so where a row
//    has a single key P is exactly 1 and dP - D exactly 0.
//  * Keys past L have weight 0 and padded keys score -1e9, so a fully padded
//    slate averages v over its L keys, never NaN: its max is NEG_INF_FILL,
//    and each exponent NEG_INF_FILL in base 2 less that max in base 2, both
//    rounded alike, exactly 0.
//  * At B = 8, h = 4, L = 8192 the probability index reaches 2.1e9: it is a
//    64-bit size_t throughout.
#include "attention_mma_tiles.cuh"
#include "attention_tf32x3.cuh"

namespace allrank {
namespace {

constexpr int kFusedKeyTile = 64;    // keys a staged tile (stage_key_bits')
constexpr int kFusedQueryTile = 64;  // queries a tile of the dK/dV kernel
// The dQ kernel takes B5's block of four warps, but at d_k <= 32 is held to
// 128 registers (four blocks an SM), not B5's 102 (five): with its D pass
// it spilled there, and took more device time at four of five shapes
// timed, the (16, 1200) step's among them (PERF.md section 6, B4's
// redesign).
constexpr int fused_dq_min_blocks(int dk_max) { return dk_max <= 32 ? 4 : 1; }

// The forward on the tensor cores, bf16: one block of kFwdWarps warps per
// (16 kFwdWarps queries, slate-head), each warp 16 query rows with their q
// as A fragments in registers; 2 n steps through the ring, n the key tiles:
// pass 1 stages keys only, pass 2 keys and values.
template <int kDk, bool kAligned>
__global__ void __launch_bounds__(32 * kFwdWarps)
    fused_fwd_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const unsigned char* __restrict__ key_mask,
                         bf16* __restrict__ out, float* __restrict__ stats,
                         int L, int dk, int h, float scale, DropStream drop) {
  constexpr int kThreads = 32 * kFwdWarps, kRows = 16 * kFwdWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dkp = mma_head_pad(dk), pitch = mma_pitch(dkp), nkc = dkp / 16;
  const int tile = kFusedKeyTile * pitch;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kRows][pitch] queries
  bf16* Ks = Qs + kRows * pitch;   // [kStages][64][pitch] key tiles
  bf16* Vs = Ks + kStages * tile;  // [kStages][64][pitch] value tiles
  uint32_t* bits = reinterpret_cast<uint32_t*>(Vs + kStages * tile);
  const int g = blockIdx.y, q0 = blockIdx.x * kRows;
  const size_t base = (size_t)g * L * dk;
  const unsigned char* padded = key_mask + (size_t)(g / h) * L;
  const int lane = threadIdx.x % 32, wrow = (threadIdx.x / 32) * 16;
  const int n_tiles = (L + kFusedKeyTile - 1) / kFusedKeyTile;
  const int n_steps = 2 * n_tiles;
  const float sl = scale * kLog2e;

  // step i into ring slot b: key tile i mod n, its keys' bits and, in pass
  // 2, its values
  auto stage = [&](int i, int b) {
    const int k0 = (i < n_tiles ? i : i - n_tiles) * kFusedKeyTile;
    stage_bf16_rows<kFusedKeyTile, kThreads, kAligned>(Ks + b * tile,
                                                       k + base, k0, L, dk,
                                                       dkp);
    if (i >= n_tiles)
      stage_bf16_rows<kFusedKeyTile, kThreads, kAligned>(Vs + b * tile,
                                                         v + base, k0, L, dk,
                                                         dkp);
    stage_key_bits(bits + 4 * b, padded, k0, L);
  };
  stage_bf16_rows<kRows, kThreads, kAligned>(Qs, q + base, q0, L, dk, dkp);
  stage(0, 0);
  cp_async_commit();
  stage(1, 1);
  cp_async_commit();

  uint32_t qa[kDk / 16][4];
  float o[kDk / 8][4] = {};
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f}, ml[2], rinv[2];
  for (int it = 0, buf = 0; it < n_steps;
       ++it, buf = buf == kStages - 1 ? 0 : buf + 1) {
    // step it has landed; after the barrier every warp is done with the
    // slot that step it + 2 takes
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
    rows_by_rows<kDk, 8, true, false>(s, qa, nullptr, Ks + buf * tile, pitch,
                                      nkc);
    if (it < n_tiles) {
      if (live)
        b4_row_stats<true>(s, m, l, kb, scale);
      else
        b4_row_stats<false>(s, m, l, kb, scale);
      continue;
    }
    if (it == n_tiles) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ml[r] = m[r] * kLog2e;
        rinv[r] = 1.f / l[r];
      }
    }
    const size_t rows_at = ((size_t)g * L + q0 + wrow) * L +
                           (size_t)(it - n_tiles) * kFusedKeyTile;
    if (live)
      b4_probs<true>(s, ml, rinv, kb, sl, drop, rows_at, L);
    else
      b4_probs<false>(s, ml, rinv, kb, sl, drop, rows_at, L);
    weigh_rows<kDk, 4>(o, s, Vs + buf * tile, pitch, nkc);
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
  store_rows<kDk>(out + base, o, one, q0 + wrow, L, dk, nkc);
}

// One 32-key half of a key tile in the dQ kernel, the warp's 16 rows: s
// and dp hold S = q . k^T and dP = dO . v^T. Pass 0 (kD) adds dPd * P to
// each row's partial D; pass 1 leaves dS = P (dPd - D) in s, zero at
// padded keys, past L and at rows past L. pad and past are the half's key
// bits shifted to this thread's first column; rows_at the probability
// index of (the warp's first row, the half's first key).
template <bool kLive, bool kD>
__device__ __forceinline__ void b4_dq_half(float (*s)[4], const float (*dp)[4],
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
      float dpd = dp[j][e];
      if (drop.on)
        dpd = drop_keep(drop, rows_at + (size_t)(lane / 4 + 8 * r) * L +
                                  8 * j + col + (e & 1))
                  ? dpd * drop.inv
                  : 0.f;
      if (kD)
        D[r] += dpd * p;
      else
        s[j][e] = ok[r] && !kpad && !kpast ? p * (dpd - D[r]) : 0.f;
    }
}

// dQ on the tensor cores, bf16: one block per (16 kDqWarps queries,
// slate-head) walking the key tiles twice, per 32 keys S = Q K^T and
// dP = dO V^T; pass 0 takes D = rowsum(dPd * P) and writes it to Dg, pass 1
// dS = P (dPd - D), rounded to bf16, and dQ += dS K, scaled once at the end.
template <int kDk, bool kAligned>
__global__ void __launch_bounds__(32 * kDqWarps, fused_dq_min_blocks(kDk))
    fused_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const unsigned char* __restrict__ key_mask,
                            const float* __restrict__ stats,
                            const bf16* __restrict__ dO,
                            float* __restrict__ Dg, bf16* __restrict__ dq,
                            int L, int dk, int h, float scale,
                            DropStream drop) {
  constexpr int kThreads = 32 * kDqWarps, kRows = 16 * kDqWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dkp = mma_head_pad(dk), pitch = mma_pitch(dkp), nkc = dkp / 16;
  const int tile = kFusedKeyTile * pitch;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kRows][pitch] queries
  bf16* Os = Qs + kRows * pitch;                 // [kRows][pitch] dO rows
  bf16* Ks = Os + kRows * pitch;   // [kStages][64][pitch] key tiles
  bf16* Vs = Ks + kStages * tile;  // [kStages][64][pitch] value tiles
  uint32_t* bits = reinterpret_cast<uint32_t*>(Vs + kStages * tile);
  const int g = blockIdx.y, q0 = blockIdx.x * kRows;
  const size_t base = (size_t)g * L * dk;
  const unsigned char* padded = key_mask + (size_t)(g / h) * L;
  const int lane = threadIdx.x % 32, col = 2 * (lane % 4);
  const int row0 = q0 + (threadIdx.x / 32) * 16;
  const int n_tiles = (L + kFusedKeyTile - 1) / kFusedKeyTile;
  const int n_steps = 2 * n_tiles;
  const float sl = scale * kLog2e;

  // step i into ring slot b: key tile i mod n, its values and keys' bits
  auto stage = [&](int i, int b) {
    const int k0 = (i < n_tiles ? i : i - n_tiles) * kFusedKeyTile;
    stage_bf16_rows<kFusedKeyTile, kThreads, kAligned>(Ks + b * tile,
                                                       k + base, k0, L, dk,
                                                       dkp);
    stage_bf16_rows<kFusedKeyTile, kThreads, kAligned>(Vs + b * tile,
                                                       v + base, k0, L, dk,
                                                       dkp);
    stage_key_bits(bits + 4 * b, padded, k0, L);
  };
  stage_bf16_rows<kRows, kThreads, kAligned>(Qs, q + base, q0, L, dk, dkp);
  stage_bf16_rows<kRows, kThreads, kAligned>(Os, dO + base, q0, L, dk, dkp);
  stage(0, 0);
  cp_async_commit();
  stage(1, 1);
  cp_async_commit();

  // the rows' statistics as the forward used them; rows past L take no part
  bool ok[2];
  float ml[2], rinv[2], D[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t row = (size_t)g * L + row0 + lane / 4 + 8 * r;
    ok[r] = row0 + lane / 4 + 8 * r < L;
    ml[r] = ok[r] ? stats[2 * row] * kLog2e : 0.f;
    rinv[r] = ok[r] ? 1.f / stats[2 * row + 1] : 0.f;
  }
  float acc[kDk / 8][4] = {};
  for (int it = 0, buf = 0; it < n_steps;
       ++it, buf = buf == kStages - 1 ? 0 : buf + 1) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + 2 < n_steps) stage(it + 2, buf == 0 ? kStages - 1 : buf - 1);
    cp_async_commit();
    const bool pass0 = it < n_tiles;
    if (it == n_tiles) {
      // D is complete: sum the quad's partials, in a fixed order
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        D[r] = quad_sum(D[r]);
        if (lane % 4 == 0 && ok[r])
          Dg[(size_t)g * L + row0 + lane / 4 + 8 * r] = D[r];
      }
    }
    const int k0 = (pass0 ? it : it - n_tiles) * kFusedKeyTile;
    const uint32_t* kb = bits + 4 * buf;
    const bool live = (kb[0] | kb[1] | kb[2] | kb[3]) == 0;
    // the tile in two halves of 32 keys, half the registers for S and dP
#pragma unroll 1
    for (int hk = 0; hk < 2; ++hk) {
      const bf16* Kh = Ks + buf * tile + 32 * hk * pitch;
      const uint32_t pad = kb[hk] >> col, past = kb[2 + hk] >> col;
      const size_t rows_at = ((size_t)g * L + row0) * L + k0 + 32 * hk;
      float s[4][4] = {}, dp[4][4] = {};
      rows_by_rows<kDk, 4, false, false>(s, nullptr, Qs, Kh, pitch, nkc);
      rows_by_rows<kDk, 4, false, true>(
          dp, nullptr, Os, Vs + buf * tile + 32 * hk * pitch, pitch, nkc);
      if (pass0) {
        if (live)
          b4_dq_half<true, true>(s, dp, pad, past, ok, ml, rinv, D, sl, drop,
                                 rows_at, L);
        else
          b4_dq_half<false, true>(s, dp, pad, past, ok, ml, rinv, D, sl,
                                  drop, rows_at, L);
        continue;
      }
      if (live)
        b4_dq_half<true, false>(s, dp, pad, past, ok, ml, rinv, D, sl, drop,
                                rows_at, L);
      else
        b4_dq_half<false, false>(s, dp, pad, past, ok, ml, rinv, D, sl, drop,
                                 rows_at, L);
      weigh_rows<kDk, 2>(acc, s, Kh, pitch, nkc);
    }
  }
  const float f[2] = {scale, scale};
  store_rows<kDk>(dq + base, acc, f, row0, L, dk, nkc);
}

// dK and dV on the tensor cores, bf16: one block per (16 kDkvWarps keys,
// slate-head) walking 64-query tiles, with q, dO and each query's max,
// 1 / sum and D streamed through the ring. Per 32 queries S^T = K Q^T and
// dP^T = V dO^T (each warp 16 keys), P^T as the forward formed P, then
// dV += round(P_dropped)^T dO and dK += round(dS)^T Q, scaled at the end.
template <int kDk, bool kAligned>
__global__ void __launch_bounds__(32 * kDkvWarps, dkv_min_blocks(kDk))
    fused_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const unsigned char* __restrict__ key_mask,
                             const float* __restrict__ stats,
                             const float* __restrict__ Dg,
                             const bf16* __restrict__ dO,
                             bf16* __restrict__ dk_out,
                             bf16* __restrict__ dv_out, int L, int dk, int h,
                             float scale, DropStream drop) {
  constexpr int kThreads = 32 * kDkvWarps, kRows = 16 * kDkvWarps;
  constexpr int kQ = kFusedQueryTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dkp = mma_head_pad(dk), pitch = mma_pitch(dkp), nkc = dkp / 16;
  const int tile = kQ * pitch;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [kRows][pitch] the keys
  bf16* Vs = Ks + kRows * pitch;                 // [kRows][pitch] the values
  bf16* Qs = Vs + kRows * pitch;   // [kStages][64][pitch] query tiles
  bf16* Os = Qs + kStages * tile;  // [kStages][64][pitch] dO tiles
  // [kStages][3][64]: each query's max in base 2, 1 / sum and D, zero past L
  float* St = reinterpret_cast<float*>(Os + kStages * tile);
  const int g = blockIdx.y, kt0 = blockIdx.x * kRows;
  const size_t base = (size_t)g * L * dk;
  const unsigned char* padded = key_mask + (size_t)(g / h) * L;
  const int lane = threadIdx.x % 32, col = 2 * (lane % 4);
  const int key0 = kt0 + (threadIdx.x / 32) * 16;
  const int n_tiles = (L + kQ - 1) / kQ;
  const float sl = scale * kLog2e;

  // query tile t into ring slot b: q, dO and the rows' statistics
  auto stage = [&](int t, int b) {
    const int row0 = t * kQ;
    stage_bf16_rows<kQ, kThreads, kAligned>(Qs + b * tile, q + base, row0, L,
                                            dk, dkp);
    stage_bf16_rows<kQ, kThreads, kAligned>(Os + b * tile, dO + base, row0,
                                            L, dk, dkp);
    float* dst = St + b * 3 * kQ;
    for (int c = threadIdx.x; c < kQ; c += kThreads) {
      const bool in = row0 + c < L;
      const size_t row = (size_t)g * L + row0 + c;
      dst[c] = in ? stats[2 * row] * kLog2e : 0.f;
      dst[kQ + c] = in ? 1.f / stats[2 * row + 1] : 0.f;
      dst[2 * kQ + c] = in ? Dg[row] : 0.f;
    }
  };
  stage_bf16_rows<kRows, kThreads, kAligned>(Ks, k + base, kt0, L, dk, dkp);
  stage_bf16_rows<kRows, kThreads, kAligned>(Vs, v + base, kt0, L, dk, dkp);
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
  store_rows<kDk>(dk_out + base, dk_acc, f_k, key0, L, dk, nkc);
  store_rows<kDk>(dv_out + base, dv_acc, f_v, key0, L, dk, nkc);
}

// The bf16 forward for head widths padded to at most kDk.
template <int kDk, bool kAligned>
cudaError_t launch_fused_fwd_mma(const void* q, const void* k, const void* v,
                                 const void* key_mask, void* out, void* stats,
                                 int G, int L, int dk, int h, float scale,
                                 DropStream drop, cudaStream_t stream) {
  constexpr int kRows = 16 * kFwdWarps;
  auto kernel = fused_fwd_mma_kernel<kDk, kAligned>;
  const size_t smem = mma_smem(dk, kRows + 2 * kStages * kFusedKeyTile,
                               4 * kStages * sizeof(uint32_t));
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((L + kRows - 1) / kRows, G), 32 * kFwdWarps, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const unsigned char*>(key_mask),
      static_cast<bf16*>(out), static_cast<float*>(stats), L, dk, h, scale,
      drop);
  return cudaGetLastError();
}

// The bf16 backward's two kernels, dQ (which writes D) then dK/dV.
template <int kDk, bool kAligned>
cudaError_t launch_fused_bwd_mma(const void* q, const void* k, const void* v,
                                 const void* key_mask, const void* stats,
                                 const void* dO, void* D, void* dq,
                                 void* dk_out, void* dv_out, int G, int L,
                                 int dk, int h, float scale, DropStream drop,
                                 cudaStream_t stream) {
  constexpr int kRowsKv = 16 * kDkvWarps, kRowsQ = 16 * kDqWarps;
  auto dqk = fused_bwd_dq_mma_kernel<kDk, kAligned>;
  auto dkv = fused_bwd_dkv_mma_kernel<kDk, kAligned>;
  const size_t smem_q = mma_smem(dk, 2 * kRowsQ + 2 * kStages * kFusedKeyTile,
                                 4 * kStages * sizeof(uint32_t));
  const size_t smem_kv =
      mma_smem(dk, 2 * kRowsKv + 2 * kStages * kFusedQueryTile,
               3 * kStages * kFusedQueryTile * sizeof(float));
  cudaError_t err = allow_smem(dqk, smem_q);
  if (err != cudaSuccess) return err;
  if ((err = allow_smem(dkv, smem_kv)) != cudaSuccess) return err;
  const auto* qt = static_cast<const bf16*>(q);
  const auto* kt = static_cast<const bf16*>(k);
  const auto* vt = static_cast<const bf16*>(v);
  const auto* mask = static_cast<const unsigned char*>(key_mask);
  const auto* st = static_cast<const float*>(stats);
  const auto* dot = static_cast<const bf16*>(dO);
  float* Dg = static_cast<float*>(D);
  dqk<<<dim3((L + kRowsQ - 1) / kRowsQ, G), 32 * kDqWarps, smem_q, stream>>>(
      qt, kt, vt, mask, st, dot, Dg, static_cast<bf16*>(dq), L, dk, h, scale,
      drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkv<<<dim3((L + kRowsKv - 1) / kRowsKv, G), 32 * kDkvWarps, smem_kv,
        stream>>>(qt, kt, vt, mask, st, Dg, dot, static_cast<bf16*>(dk_out),
                  static_cast<bf16*>(dv_out), L, dk, h, scale, drop);
  return cudaGetLastError();
}

cudaError_t fused_fwd_bf16(const void* q, const void* k, const void* v,
                           const void* key_mask, void* out, void* stats,
                           int G, int L, int dk, int h, float scale,
                           DropStream drop, cudaStream_t stream) {
  MMA_DK_DISPATCH(launch_fused_fwd_mma, dk, rows_aligned(dk, {q, k, v}), q, k,
                  v, key_mask, out, stats, G, L, dk, h, scale, drop, stream);
}

cudaError_t fused_bwd_bf16(const void* q, const void* k, const void* v,
                           const void* key_mask, const void* stats,
                           const void* dO, void* D, void* dq, void* dk_out,
                           void* dv_out, int G, int L, int dk, int h,
                           float scale, DropStream drop,
                           cudaStream_t stream) {
  MMA_DK_DISPATCH(launch_fused_bwd_mma, dk, rows_aligned(dk, {q, k, v, dO}),
                  q, k, v, key_mask, stats, dO, D, dq, dk_out, dv_out, G, L,
                  dk, h, scale, drop, stream);
}


// ---- fp32: 3xTF32 on the tensor cores (attention_tf32x3.cuh) ----

// The masked, scaled scores of one 64-key tile for the warp's 16 rows, in
// place: padded keys NEG_INF_FILL, keys past L -inf (weight 0); kLive (no
// key of the tile padded or past L) only scales.
template <bool kLive>
__device__ __forceinline__ void b4_scores_f32(float (*s)[4],
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

// The fp32 forward: one block of f32_fwd_warps(kDk) warps per (16 warps
// queries, slate-head), each warp 16 query rows, their q split once into
// hi and lo planes; 2 n steps through the ring, n the key tiles: pass 1
// stages keys only and takes each row's max and sum (online, rescaled per
// tile), pass 2 keys and values for P = exp2((sc - max) log2(e)) * (1 /
// sum), dropped, and P . v, each tile's summed from zero and added in fp32.
template <int kDk, bool kAligned>
__global__ void __launch_bounds__(32 * f32_fwd_warps(kDk))
    fused_fwd_tf32x3_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const unsigned char* __restrict__ key_mask,
                            float* __restrict__ out,
                            float* __restrict__ stats, int L, int dk, int h,
                            float scale, DropStream drop) {
  constexpr int kSt = f32_fwd_stages(kDk);
  constexpr int kThreads = 32 * f32_fwd_warps(kDk);
  constexpr int kRows = 16 * f32_fwd_warps(kDk);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dkp = f32_head_pad(dk), pitch = f32_pitch(dkp), nk = dkp / 8;
  const int tile = kFusedKeyTile * pitch;
  float* Qh = reinterpret_cast<float*>(smem_raw);  // [kRows][pitch] q, hi
  float* Ql = Qh + kRows * pitch;                  // q, lo
  float* Ks = Ql + kRows * pitch;   // [kSt][64][pitch] key tiles
  float* Vs = Ks + kSt * tile;      // [kSt][64][pitch] value tiles
  uint32_t* bits = reinterpret_cast<uint32_t*>(Vs + kSt * tile);
  const int g = blockIdx.y, q0 = blockIdx.x * kRows;
  const size_t base = (size_t)g * L * dk;
  const unsigned char* padded = key_mask + (size_t)(g / h) * L;
  const int lane = threadIdx.x % 32, col = 2 * (lane % 4);
  const int wrow = (threadIdx.x / 32) * 16;
  const int n_tiles = (L + kFusedKeyTile - 1) / kFusedKeyTile;
  const int n_steps = 2 * n_tiles;

  // step i into ring slot b: key tile i mod n, its keys' bits and, in pass
  // 2, its values
  auto stage = [&](int i, int b) {
    const int k0 = (i < n_tiles ? i : i - n_tiles) * kFusedKeyTile;
    stage_f32_rows<kFusedKeyTile, kThreads, kAligned>(Ks + b * tile, k + base,
                                                      k0, L, dk, dkp);
    if (i >= n_tiles)
      stage_f32_rows<kFusedKeyTile, kThreads, kAligned>(Vs + b * tile,
                                                        v + base, k0, L, dk,
                                                        dkp);
    stage_key_bits(bits + 4 * b, padded, k0, L);
  };
  stage_f32_rows<kRows, kThreads, kAligned>(Qh, q + base, q0, L, dk, dkp);
#pragma unroll
  for (int i = 0; i < kSt - 1; ++i) {
    stage(i, i);  // n_steps >= 2
    cp_async_commit();
  }
  cp_async_wait<kSt - 2>();
  __syncthreads();
  split_planes<kRows, kThreads>(Qh, Ql, pitch, dkp);

  float o[kDk / 8][4] = {};
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f}, rinv[2];
  for (int it = 0, buf = 0; it < n_steps;
       ++it, buf = buf == kSt - 1 ? 0 : buf + 1) {
    // step it has landed; after the barrier every warp is done with the
    // slot that step it + kSt - 1 takes
    cp_async_wait<kSt - 2>();
    __syncthreads();
    if (it + kSt - 1 < n_steps)
      stage(it + kSt - 1, buf == 0 ? kSt - 1 : buf - 1);
    cp_async_commit();
    const uint32_t* kb = bits + 4 * buf;
    float s[8][4] = {};
    rows_by_rows_f32<kDk, 8, true>(s, Qh, Ql, wrow, Ks + buf * tile, pitch,
                                   nk);
    if ((kb[0] | kb[1] | kb[2] | kb[3]) == 0)
      b4_scores_f32<true>(s, kb, scale);
    else
      b4_scores_f32<false>(s, kb, scale);
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
                           (size_t)(it - n_tiles) * kFusedKeyTile;
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
  store_rows_f32<kDk>(out + base, o, one, q0 + wrow, L, dk, nk);
}

// The fp32 backward (attention_tf32x3.cuh): dQ, whose first walk takes
// D = rowsum(dPd P), then dK/dV, each from the rows' max and sum.
template <int kDk, bool kAligned>
__global__ void __launch_bounds__(32 * f32_dq_warps(kDk))
    fused_bwd_dq_tf32x3_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const unsigned char* __restrict__ key_mask,
                               const float* __restrict__ stats,
                               const float* __restrict__ dO,
                               const float* __restrict__ O,
                               float* __restrict__ Dg, float* __restrict__ dq,
                               int L, int dk, int h, float scale,
                               DropStream drop) {
  bwd_dq_tf32x3<false, kDk, kAligned>(q, k, v, key_mask, stats, dO, O, Dg,
                                      dq, L, dk, h, scale, drop);
}

template <int kDk, bool kAligned>
__global__ void __launch_bounds__(32 * f32_dkv_warps(kDk))
    fused_bwd_dkv_tf32x3_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const unsigned char* __restrict__ key_mask,
                                const float* __restrict__ stats,
                                const float* __restrict__ Dg,
                                const float* __restrict__ dO,
                                float* __restrict__ dk_out,
                                float* __restrict__ dv_out, int L, int dk,
                                int h, float scale, DropStream drop) {
  bwd_dkv_tf32x3<false, kDk, kAligned>(q, k, v, key_mask, stats, Dg, dO,
                                       dk_out, dv_out, L, dk, h, scale, drop);
}

// The fp32 forward for head widths padded to at most kDk.
template <int kDk, bool kAligned>
cudaError_t launch_fused_fwd_tf32x3(const void* q, const void* k,
                                    const void* v, const void* key_mask,
                                    void* out, void* stats, int G, int L,
                                    int dk, int h, float scale,
                                    DropStream drop, cudaStream_t stream) {
  constexpr int kSt = f32_fwd_stages(kDk);
  constexpr int kRows = 16 * f32_fwd_warps(kDk);
  auto kernel = fused_fwd_tf32x3_kernel<kDk, kAligned>;
  const size_t smem = f32_smem(dk, 2 * kRows + 2 * kSt * kFusedKeyTile,
                               4 * kSt * sizeof(uint32_t));
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((L + kRows - 1) / kRows, G), 32 * f32_fwd_warps(kDk), smem,
           stream>>>(static_cast<const float*>(q),
                     static_cast<const float*>(k),
                     static_cast<const float*>(v),
                     static_cast<const unsigned char*>(key_mask),
                     static_cast<float*>(out), static_cast<float*>(stats), L,
                     dk, h, scale, drop);
  return cudaGetLastError();
}

// The fp32 backward's two kernels, dQ (which writes D) then dK/dV.
template <int kDk, bool kAligned>
cudaError_t launch_fused_bwd_tf32x3(const void* q, const void* k,
                                    const void* v, const void* key_mask,
                                    const void* stats, const void* dO,
                                    void* D, void* dq, void* dk_out,
                                    void* dv_out, int G, int L, int dk, int h,
                                    float scale, DropStream drop,
                                    cudaStream_t stream) {
  return launch_bwd_tf32x3<kDk>(fused_bwd_dq_tf32x3_kernel<kDk, kAligned>,
                                fused_bwd_dkv_tf32x3_kernel<kDk, kAligned>, q,
                                k, v, key_mask, stats, dO, nullptr, D, dq,
                                dk_out, dv_out, G, L, dk, h, scale, drop,
                                stream);
}

cudaError_t fused_fwd_f32(const void* q, const void* k, const void* v,
                          const void* key_mask, void* out, void* stats, int G,
                          int L, int dk, int h, float scale, DropStream drop,
                          cudaStream_t stream) {
  MMA_DK_DISPATCH(launch_fused_fwd_tf32x3, dk,
                  rows_aligned(dk, {q, k, v}, 4), q, k, v, key_mask, out,
                  stats, G, L, dk, h, scale, drop, stream);
}

cudaError_t fused_bwd_f32(const void* q, const void* k, const void* v,
                          const void* key_mask, const void* stats,
                          const void* dO, void* D, void* dq, void* dk_out,
                          void* dv_out, int G, int L, int dk, int h,
                          float scale, DropStream drop, cudaStream_t stream) {
  MMA_DK_DISPATCH(launch_fused_bwd_tf32x3, dk,
                  rows_aligned(dk, {q, k, v, dO}, 4), q, k, v, key_mask,
                  stats, dO, D, dq, dk_out, dv_out, G, L, dk, h, scale, drop,
                  stream);
}

}  // namespace
}  // namespace allrank

// Launches the forward on `stream`; returns 0 or the CUDA error code. q, k,
// v and out are [G, L, d_k] (G = B * h, d_k <= 128) in bf16 if is_bf16,
// else fp32 (3xTF32), both on the tensor cores; key_mask is [B, L] bytes,
// non-zero at padded documents. stats ([G, L, 2] fp32: each row's max
// and sum) may be null. drop_keys holds {k0, k1, threshold} of the
// probability stream (ops/dropout.py), p_drop its rate (0: no dropout).
extern "C" int attention_fused_fwd(const void* q, const void* k,
                                   const void* v, const void* key_mask,
                                   void* out, void* stats, int G, int L,
                                   int dk, int h, float scale, int is_bf16,
                                   const unsigned* drop_keys, double p_drop,
                                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto drop = allrank::make_stream(drop_keys, p_drop);
  if (is_bf16)
    return allrank::fused_fwd_bf16(q, k, v, key_mask, out, stats, G, L, dk, h,
                                   scale, drop, s);
  return allrank::fused_fwd_f32(q, k, v, key_mask, out, stats, G, L, dk, h,
                                scale, drop, s);
}

// Launches the backward's two kernels on `stream`; returns 0 or the CUDA
// error code. Inputs q, k, v, key_mask, stats from the forward and dO
// ([G, L, d_k], q's dtype); outputs dq, dk, dv in q's dtype; D ([G, L] fp32)
// is scratch from the caller, where the dQ kernel leaves rowsum(dPd * P).
extern "C" int attention_fused_bwd(const void* q, const void* k,
                                   const void* v, const void* key_mask,
                                   const void* stats, const void* dO, void* D,
                                   void* dq, void* dk_out, void* dv_out, int G,
                                   int L, int dk, int h, float scale,
                                   int is_bf16, const unsigned* drop_keys,
                                   double p_drop, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto drop = allrank::make_stream(drop_keys, p_drop);
  if (is_bf16)
    return allrank::fused_bwd_bf16(q, k, v, key_mask, stats, dO, D, dq, dk_out,
                                   dv_out, G, L, dk, h, scale, drop, s);
  return allrank::fused_bwd_f32(q, k, v, key_mask, stats, dO, D, dq, dk_out,
                                dv_out, G, L, dk, h, scale, drop, s);
}
