// B5: masked slate attention for long slates with the K-streamed online
// softmax, forward and backward, for Hopper (sm_90a), fp32 or bf16 q, k, v:
// the same function as B4 (attention_fused.cu), plus each row's logsumexp.
//
// Replaces the TPU kernel `tiled_slate_attention` of the JAX package's
// ops/attention_tiled.py: forward pallas_call at line 228 (math in
// _fwd_kernel, lines 62-101), backward at line 265 (_bwd_kernel, 104-143).
//
// What bounds it: the L x L products, 4 * L^2 * d_k operations per
// slate-head forward and 10 * L^2 * d_k backward (S and dP rebuilt, dV, dQ,
// dK) against O(L * d_k) bytes, so operations; and beside them one exp per
// (query, key) pair forward and two backward on the special-function unit
// (16 a clock per SM). At d_k = 32 in bf16 the exps alone take about twice
// the tensor cores' time: the softmax's elementwise work, not the products,
// sets the floor.
//
// What the design does about it, and about the TPU kernel's assumptions:
//  * bf16 runs on the tensor cores (attention_mma.cuh): every product is an
//    mma.sync.m16n8k16 bf16 x bf16 -> fp32, the TPU kernel's own arithmetic
//    (_dot with preferred_element_type=F32), and the bf16 rounding points
//    sit where an A operand is rounded: the unnormalised p_acc before P . v
//    (line 92), P dropped before dV (134), dS before dK and dQ (137). P and
//    dS go from the fp32 accumulator to the next product's A fragment in
//    registers, never through shared memory.
//  * The TPU kernel keeps a slate-head's whole query block [Lp, d_k] in VMEM
//    and steps over key tiles in the grid's sequential axis, carrying m, l
//    and the accumulator in scratch. A GPU grid has no order, so the key
//    loop is inside the block, as FlashAttention-2 has it: one block of
//    eight warps per (slate-head, 128 queries), each warp 16 query rows,
//    their q as A fragments in registers for the whole loop; 64-key tiles of
//    k and v stream through a three-slot cp.async ring (two tiles in flight,
//    one barrier a tile). m and l live in registers, a row's four threads
//    are one quad. The recurrence is lines 78-101's: m from -1e30, the
//    denominator sums the undropped p, the keep mask on the accumulator
//    only, O = acc * (inv / max(l, 1e-30)), lse = m + log(max(l, 1e-30)).
//    Exponentials are base 2 on the special-function unit; a tile of live
//    keys only (all but a slate's padded tail) takes no mask and one FMA for
//    each exponent.
//  * Key tiles are kKeyTile = 64 wide, as the plain version's TILE_K in
//    ops/attention_tiled.py: the bf16 rounding of p_acc depends on the
//    running max, so the two must walk the same tiles.
//  * Keys past L are skipped with weight 0, not NEG_INF_FILL: a fully
//    padded slate therefore averages v over its L keys, as B4 and the XLA
//    path do. The JAX kernel pads keys to a multiple of its tile with the
//    mask set and averages over the padded length instead (ROADMAP Queue C).
//  * The backward rebuilds P = exp(s - lse) per tile, takes D = rowsum(dO *
//    O) from the wrapper, and runs two kernels with no atomics and sums in a
//    fixed order: dK/dV per 128 keys, which computes S^T = K Q^T and dP^T =
//    V dO^T so that P^T and dS^T come out in the A layout of dV += P_d^T dO
//    and dK += dS^T Q, and dQ per 64 queries (dQ += dS K), both over 32-wide
//    halves of each 64-wide tile to halve the registers S and dP take. dP
//    sums each 16-deep step apart and adds them in fp32: dP - D cancels,
//    and the tensor cores' truncating sums would show there. Query rows
//    past L have no lse or D and are zeroed explicitly. The dropout masks
//    replay from their keys.
//  * d_k is padded with zeros to whole 16-column steps in shared memory (72
//    to 80); the kernels are built for padded widths 32, 64 and 128. Rows
//    are copied in 16-byte pieces when d_k % 8 == 0 and q, k, v (and dO)
//    start on 16-byte boundaries, and element by element otherwise, a
//    template flag of the same kernels.
//  * fp32 runs on the tensor cores too, each product as three TF32
//    products (3xTF32, attention_tf32x3.cuh), some 2^-21 of a product where
//    bf16 would lose the parity fp32 promises. Its bound: 4 (forward) or 10
//    (backward) B h L^2 d_k operations at a third of the card's 495 TFLOP/s
//    TF32 rate, 0.42 / 1.04 ms at (8, 4, 4096, 32), where the SIMT fp32 FMAs
//    it replaces were bound at 1.03 / 2.56 ms and took 6.05 / 22.43 ms of
//    device time on an H100 SXM (PERF.md, B5's rows).
//    The design is the bf16 one in fp32 tiles: q split once into hi and lo
//    planes, k and v split as each warp reads its fragments, P kept in
//    registers by permuting the keys of each k8 step (no shared-memory
//    trip), every tile's P . v summed from zero because the tensor cores
//    truncate their sums; block shapes fp32's shared memory allows
//    (f32_fwd_warps, f32_dq_warps, f32_dkv_warps, their stages). The dQ
//    kernel takes D = rowsum(dO * O) itself, through the split product that
//    gives dP, so that dP - D cancels exactly where a row has one key
//    (ROADMAP C3); under dropout, where O carries 1 / (1 - p), B4's
//    D = rowsum(dPd * P) from a first walk over the keys.
//  * At B = 8, h = 4, L = 8192 the probability index reaches 2.1e9: it is a
//    64-bit size_t throughout.
#include "attention_mma_tiles.cuh"
#include "attention_tf32x3.cuh"

namespace allrank {
namespace {

constexpr int kKeyTile = 64;    // key tile width: ops/attention_tiled.TILE_K
constexpr int kQueryTile = 64;  // query tile the dK/dV kernel streams

// One key tile of the forward's recurrence (JAX attention_tiled.py:78-101)
// for the warp's 16 rows: s holds the tile's scores q . k^T and leaves with
// p, the keep mask applied, for P . v; m, l and o are rescaled. kLive (a tile
// of live keys only: every tile but a slate's padded tail) takes no mask
// and one FMA for each exponent; otherwise padded keys score NEG_INF_FILL
// and keys past L weight 0. rows_at is the probability index of (the
// warp's first row, the tile's first key).
template <bool kLive, int kDk>
__device__ __forceinline__ void online_softmax(float (*s)[4], float m[2],
                                               float l[2], float (*o)[4],
                                               const uint32_t* kb,
                                               float scale,
                                               const DropStream& drop,
                                               size_t rows_at, int L) {
  const int lane = threadIdx.x % 32, col = 2 * (lane % 4);
  if (!kLive) {
    const uint32_t pad[2] = {kb[0] >> col, kb[1] >> col};
    const uint32_t past[2] = {kb[2] >> col, kb[3] >> col};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int bit = 8 * (j & 3) + (e & 1);
        s[j][e] = (past[j >> 2] >> bit) & 1u  ? -INFINITY
                  : (pad[j >> 2] >> bit) & 1u ? kNegInfFill
                                              : s[j][e] * scale;
      }
  }
  float mx[2][8], m_new[2], alpha[2], ml[2];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r][j] = fmaxf(s[j][2 * r], s[j][2 * r + 1]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // scale > 0: the largest score scaled is the largest scaled score
    const float tmax = quad_max(tree_max8(mx[r]));
    m_new[r] = fmaxf(m[r], kLive ? tmax * scale : tmax);
    alpha[r] = exp2_approx((m[r] - m_new[r]) * kLog2e);
    ml[r] = m_new[r] * kLog2e;
  }
  const float sl = scale * kLog2e;
  float psum[2][8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float p = kLive ? exp2_approx(fmaf(s[j][e], sl, -ml[r]))
                      : exp2_approx((s[j][e] - m_new[r]) * kLog2e);
      psum[r][j] = e & 1 ? psum[r][j] + p : p;
      if (drop.on &&
          !drop_keep(drop, rows_at + (size_t)(lane / 4 + 8 * r) * L + 8 * j +
                               col + (e & 1)))
        p = 0.f;
      s[j][e] = p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = l[r] * alpha[r] + quad_sum(tree_sum8(psum[r]));
    m[r] = m_new[r];
  }
#pragma unroll
  for (int n = 0; n < kDk / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
}

// The forward on the tensor cores, bf16: one block of kFwdWarps warps per
// (16 kFwdWarps queries, slate-head), each warp 16 query rows with their q
// as A fragments in registers, the 64-key tiles streamed through the ring.
template <int kDk, bool kAligned>
__global__ void __launch_bounds__(32 * kFwdWarps)
    tiled_fwd_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const unsigned char* __restrict__ key_mask,
                         bf16* __restrict__ out, float* __restrict__ lse,
                         int L, int dk, int h, float scale, DropStream drop) {
  constexpr int kThreads = 32 * kFwdWarps, kRows = 16 * kFwdWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dkp = mma_head_pad(dk), pitch = mma_pitch(dkp), nkc = dkp / 16;
  const int tile = kKeyTile * pitch;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kRows][pitch] queries
  bf16* Ks = Qs + kRows * pitch;   // [kStages][64][pitch] key tiles
  bf16* Vs = Ks + kStages * tile;  // [kStages][64][pitch] value tiles
  uint32_t* bits = reinterpret_cast<uint32_t*>(Vs + kStages * tile);
  const int g = blockIdx.y, q0 = blockIdx.x * kRows;
  const size_t base = (size_t)g * L * dk;
  const unsigned char* padded = key_mask + (size_t)(g / h) * L;
  const int lane = threadIdx.x % 32, wrow = (threadIdx.x / 32) * 16;
  const int n_tiles = (L + kKeyTile - 1) / kKeyTile;

  // key tile t into ring slot b: k, v and the keys' bits (bits[4 b..])
  auto stage = [&](int t, int b) {
    stage_bf16_rows<kKeyTile, kThreads, kAligned>(
        Ks + b * tile, k + base, t * kKeyTile, L, dk, dkp);
    stage_bf16_rows<kKeyTile, kThreads, kAligned>(
        Vs + b * tile, v + base, t * kKeyTile, L, dk, dkp);
    stage_key_bits(bits + 4 * b, padded, t * kKeyTile, L);
  };
  stage_bf16_rows<kRows, kThreads, kAligned>(Qs, q + base, q0, L, dk, dkp);
  stage(0, 0);
  cp_async_commit();
  if (n_tiles > 1) stage(1, 1);
  cp_async_commit();

  uint32_t qa[kDk / 16][4];
  float o[kDk / 8][4] = {};
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  for (int it = 0, buf = 0; it < n_tiles;
       ++it, buf = buf == kStages - 1 ? 0 : buf + 1) {
    // tile it has landed; after the barrier every warp is done with the
    // slot that tile it + 2 takes
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + 2 < n_tiles) stage(it + 2, buf == 0 ? kStages - 1 : buf - 1);
    cp_async_commit();
    if (it == 0) {
#pragma unroll
      for (int kc = 0; kc < kDk / 16; ++kc)
        if (kc < nkc)
          ldmatrix_x4(qa[kc], Qs + (wrow + lane % 16) * pitch + kc * 16 +
                                  (lane / 16) * 8);
    }
    const uint32_t* kb = bits + 4 * buf;
    float s[8][4] = {};
    rows_by_rows<kDk, 8, true, false>(s, qa, nullptr, Ks + buf * tile, pitch,
                                      nkc);
    const size_t rows_at = ((size_t)g * L + q0 + wrow) * L + it * kKeyTile;
    if ((kb[0] | kb[1] | kb[2] | kb[3]) == 0)
      online_softmax<true, kDk>(s, m, l, o, kb, scale, drop, rows_at, L);
    else
      online_softmax<false, kDk>(s, m, l, o, kb, scale, drop, rows_at, L);
    weigh_rows<kDk, 4>(o, s, Vs + buf * tile, pitch, nkc);
  }
  const float inv = drop.on ? drop.inv : 1.f;
  float f[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float denom = fmaxf(l[r], 1e-30f);
    f[r] = inv / denom;
    const int row = q0 + wrow + lane / 4 + 8 * r;
    if (lse != nullptr && lane % 4 == 0 && row < L)
      lse[(size_t)g * L + row] = m[r] + logf(denom);
  }
  store_rows<kDk>(out + base, o, f, q0 + wrow, L, dk, nkc);
}

// dQ on the tensor cores, bf16: one block per (16 kDqWarps queries,
// slate-head) walking the key tiles; per 32 keys S = Q K^T and dP = dO V^T,
// then dS = P (dP_dropped - D) at live keys and query rows below L (zero
// elsewhere), rounded to bf16, and dQ += dS K, scaled once at the end.
template <int kDk, bool kAligned>
__global__ void __launch_bounds__(32 * kDqWarps, dq_min_blocks(kDk))
    tiled_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const unsigned char* __restrict__ key_mask,
                            const float* __restrict__ lse,
                            const float* __restrict__ Dg,
                            const bf16* __restrict__ dO,
                            bf16* __restrict__ dq, int L, int dk, int h,
                            float scale, DropStream drop) {
  constexpr int kThreads = 32 * kDqWarps, kRows = 16 * kDqWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dkp = mma_head_pad(dk), pitch = mma_pitch(dkp), nkc = dkp / 16;
  const int tile = kKeyTile * pitch;
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
  const int n_tiles = (L + kKeyTile - 1) / kKeyTile;
  const float sl = scale * kLog2e;

  auto stage = [&](int t, int b) {
    stage_bf16_rows<kKeyTile, kThreads, kAligned>(
        Ks + b * tile, k + base, t * kKeyTile, L, dk, dkp);
    stage_bf16_rows<kKeyTile, kThreads, kAligned>(
        Vs + b * tile, v + base, t * kKeyTile, L, dk, dkp);
    stage_key_bits(bits + 4 * b, padded, t * kKeyTile, L);
  };
  stage_bf16_rows<kRows, kThreads, kAligned>(Qs, q + base, q0, L, dk, dkp);
  stage_bf16_rows<kRows, kThreads, kAligned>(Os, dO + base, q0, L, dk, dkp);
  stage(0, 0);
  cp_async_commit();
  if (n_tiles > 1) stage(1, 1);
  cp_async_commit();

  // the rows' statistics, lse in base 2; rows past L take no part
  bool ok[2];
  float rl[2], rd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + lane / 4 + 8 * r;
    ok[r] = row < L;
    rl[r] = ok[r] ? lse[(size_t)g * L + row] * kLog2e : 0.f;
    rd[r] = ok[r] ? Dg[(size_t)g * L + row] : 0.f;
  }
  float acc[kDk / 8][4] = {};
  for (int it = 0, buf = 0; it < n_tiles;
       ++it, buf = buf == kStages - 1 ? 0 : buf + 1) {
    const int k0 = it * kKeyTile;
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + 2 < n_tiles) stage(it + 2, buf == 0 ? kStages - 1 : buf - 1);
    cp_async_commit();
    const uint32_t* kb = bits + 4 * buf;
    // the tile in two halves of 32 keys, half the registers for S and dP
#pragma unroll 1
    for (int hk = 0; hk < 2; ++hk) {
      const bf16* Kh = Ks + buf * tile + 32 * hk * pitch;
      // keys that are padded or past L take no dS
      const uint32_t dead = (kb[hk] | kb[2 + hk]) >> col;
      float s[4][4] = {}, dp[4][4] = {};
      rows_by_rows<kDk, 4, false, false>(s, nullptr, Qs, Kh, pitch, nkc);
      rows_by_rows<kDk, 4, false, true>(
          dp, nullptr, Os, Vs + buf * tile + 32 * hk * pitch, pitch, nkc);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float ds = 0.f;
          if (ok[r] && !((dead >> (8 * j + (e & 1))) & 1u)) {
            const float p = exp2_approx(fmaf(s[j][e], sl, -rl[r]));
            float dpd = dp[j][e];
            if (drop.on) {
              const size_t index = ((size_t)g * L + row0 + lane / 4 + 8 * r) *
                                       L + k0 + 32 * hk + 8 * j + col +
                                   (e & 1);
              dpd = drop_keep(drop, index) ? dpd * drop.inv : 0.f;
            }
            ds = p * (dpd - rd[r]);
          }
          s[j][e] = ds;
        }
      weigh_rows<kDk, 2>(acc, s, Kh, pitch, nkc);
    }
  }
  const float f[2] = {scale, scale};
  store_rows<kDk>(dq + base, acc, f, row0, L, dk, nkc);
}

// dK and dV on the tensor cores, bf16: one block per (16 kDkvWarps keys,
// slate-head) walking 64-query tiles, with q, dO, lse and D streamed
// through the ring. Per 32 queries S^T = K Q^T and dP^T = V dO^T (each warp
// 16 keys), P^T = exp(S^T - lse), then dV += round(P_dropped)^T dO and
// dK += round(dS)^T Q, scaled once at the end.
template <int kDk, bool kAligned>
__global__ void __launch_bounds__(32 * kDkvWarps, dkv_min_blocks(kDk))
    tiled_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const unsigned char* __restrict__ key_mask,
                             const float* __restrict__ lse,
                             const float* __restrict__ Dg,
                             const bf16* __restrict__ dO,
                             bf16* __restrict__ dk_out,
                             bf16* __restrict__ dv_out, int L, int dk, int h,
                             float scale, DropStream drop) {
  constexpr int kThreads = 32 * kDkvWarps, kRows = 16 * kDkvWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dkp = mma_head_pad(dk), pitch = mma_pitch(dkp), nkc = dkp / 16;
  const int tile = kQueryTile * pitch;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [kRows][pitch] the keys
  bf16* Vs = Ks + kRows * pitch;                 // [kRows][pitch] the values
  bf16* Qs = Vs + kRows * pitch;   // [kStages][64][pitch] query tiles
  bf16* Os = Qs + kStages * tile;  // [kStages][64][pitch] dO tiles
  // [kStages][2][64]: each query's lse in base 2 and D, zero past L
  float* St = reinterpret_cast<float*>(Os + kStages * tile);
  const int g = blockIdx.y, kt0 = blockIdx.x * kRows;
  const size_t base = (size_t)g * L * dk;
  const unsigned char* padded = key_mask + (size_t)(g / h) * L;
  const int lane = threadIdx.x % 32, col = 2 * (lane % 4);
  const int key0 = kt0 + (threadIdx.x / 32) * 16;
  const int n_tiles = (L + kQueryTile - 1) / kQueryTile;
  const float sl = scale * kLog2e;

  // query tile t into ring slot b: q, dO, lse and D
  auto stage = [&](int t, int b) {
    const int row0 = t * kQueryTile;
    stage_bf16_rows<kQueryTile, kThreads, kAligned>(Qs + b * tile, q + base,
                                                    row0, L, dk, dkp);
    stage_bf16_rows<kQueryTile, kThreads, kAligned>(Os + b * tile, dO + base,
                                                    row0, L, dk, dkp);
    float* dst = St + b * 2 * kQueryTile;
    for (int c = threadIdx.x; c < kQueryTile; c += kThreads) {
      const bool in = row0 + c < L;
      dst[c] = in ? lse[(size_t)g * L + row0 + c] * kLog2e : 0.f;
      dst[kQueryTile + c] = in ? Dg[(size_t)g * L + row0 + c] : 0.f;
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
  // a block of live keys only takes, at query tiles below L, no mask and
  // one FMA for each exponent
  all_live = __syncthreads_and(all_live);
  float dk_acc[kDk / 8][4] = {}, dv_acc[kDk / 8][4] = {};
  for (int it = 0, buf = 0; it < n_tiles;
       ++it, buf = buf == kStages - 1 ? 0 : buf + 1) {
    const int q0 = it * kQueryTile;
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + 2 < n_tiles) stage(it + 2, buf == 0 ? kStages - 1 : buf - 1);
    cp_async_commit();
    const float* lse_t = St + buf * 2 * kQueryTile;
    const float* D_t = lse_t + kQueryTile;
    const bool live = all_live && q0 + kQueryTile <= L;
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
        const float2 lse2 = *reinterpret_cast<const float2*>(lse_t + c0);
        const float2 D2 = *reinterpret_cast<const float2*>(D_t + c0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = c0 + (e & 1);
          float pd = 0.f, ds = 0.f;
          if (live || (q0 + c < L && !past[r])) {
            // a padded key scores NEG_INF_FILL; on a fully padded slate
            // lse rounds to NEG_INF_FILL, so P reads 1 there, as in the
            // plain version
            const float x = !live && pad[r] ? kNegInfFillL2 : s[j][e] * sl;
            const float p = exp2_approx(x - (e & 1 ? lse2.y : lse2.x));
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
cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v,
                           const void* key_mask, void* out, void* lse, int G,
                           int L, int dk, int h, float scale, DropStream drop,
                           cudaStream_t stream) {
  constexpr int kRows = 16 * kFwdWarps;
  auto kernel = tiled_fwd_mma_kernel<kDk, kAligned>;
  const size_t smem = mma_smem(dk, kRows + 2 * kStages * kKeyTile,
                               4 * kStages * sizeof(uint32_t));
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((L + kRows - 1) / kRows, G), 32 * kFwdWarps, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const unsigned char*>(key_mask),
      static_cast<bf16*>(out), static_cast<float*>(lse), L, dk, h, scale,
      drop);
  return cudaGetLastError();
}

// The bf16 backward's two kernels, dK/dV then dQ.
template <int kDk, bool kAligned>
cudaError_t launch_bwd_mma(const void* q, const void* k, const void* v,
                           const void* key_mask, const void* lse,
                           const void* D, const void* dO, void* dq,
                           void* dk_out, void* dv_out, int G, int L, int dk,
                           int h, float scale, DropStream drop,
                           cudaStream_t stream) {
  constexpr int kRowsKv = 16 * kDkvWarps, kRowsQ = 16 * kDqWarps;
  auto dkv = tiled_bwd_dkv_mma_kernel<kDk, kAligned>;
  auto dqk = tiled_bwd_dq_mma_kernel<kDk, kAligned>;
  const size_t smem_kv = mma_smem(dk, 2 * kRowsKv + 2 * kStages * kQueryTile,
                                  2 * kStages * kQueryTile * sizeof(float));
  const size_t smem_q = mma_smem(dk, 2 * kRowsQ + 2 * kStages * kKeyTile,
                                 4 * kStages * sizeof(uint32_t));
  cudaError_t err = allow_smem(dkv, smem_kv);
  if (err != cudaSuccess) return err;
  if ((err = allow_smem(dqk, smem_q)) != cudaSuccess) return err;
  const auto* qt = static_cast<const bf16*>(q);
  const auto* kt = static_cast<const bf16*>(k);
  const auto* vt = static_cast<const bf16*>(v);
  const auto* mask = static_cast<const unsigned char*>(key_mask);
  const auto* st = static_cast<const float*>(lse);
  const auto* Dg = static_cast<const float*>(D);
  const auto* dot = static_cast<const bf16*>(dO);
  dkv<<<dim3((L + kRowsKv - 1) / kRowsKv, G), 32 * kDkvWarps, smem_kv,
        stream>>>(qt, kt, vt, mask, st, Dg, dot, static_cast<bf16*>(dk_out),
                  static_cast<bf16*>(dv_out), L, dk, h, scale, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dqk<<<dim3((L + kRowsQ - 1) / kRowsQ, G), 32 * kDqWarps, smem_q, stream>>>(
      qt, kt, vt, mask, st, Dg, dot, static_cast<bf16*>(dq), L, dk, h, scale,
      drop);
  return cudaGetLastError();
}

cudaError_t tiled_fwd_bf16(const void* q, const void* k, const void* v,
                           const void* key_mask, void* out, void* lse, int G,
                           int L, int dk, int h, float scale, DropStream drop,
                           cudaStream_t stream) {
  MMA_DK_DISPATCH(launch_fwd_mma, dk, rows_aligned(dk, {q, k, v}), q, k,
                     v, key_mask, out, lse, G, L, dk, h, scale, drop, stream);
}

cudaError_t tiled_bwd_bf16(const void* q, const void* k, const void* v,
                           const void* key_mask, const void* lse,
                           const void* D, const void* dO, void* dq,
                           void* dk_out, void* dv_out, int G, int L, int dk,
                           int h, float scale, DropStream drop,
                           cudaStream_t stream) {
  MMA_DK_DISPATCH(launch_bwd_mma, dk, rows_aligned(dk, {q, k, v, dO}), q,
                     k, v, key_mask, lse, D, dO, dq, dk_out, dv_out, G, L, dk,
                     h, scale, drop, stream);
}


// ---- fp32: 3xTF32 on the tensor cores (attention_tf32x3.cuh) ----

// One key tile of the fp32 forward's recurrence (JAX attention_tiled.py:
// 78-101) for the warp's 16 rows: s holds the tile's q . k^T and leaves with
// p, the keep mask applied, for P . v; m and l are updated and alpha, the
// rescaling of the rows' running sums, returned. Scores are scaled first,
// so a row's max is in the units of f32_prob and where the row has one key
// its exponent is exactly 0. kLive (a tile of live keys only) takes no
// mask; otherwise padded keys score NEG_INF_FILL and keys past L weigh 0.
template <bool kLive>
__device__ __forceinline__ void online_softmax_f32(float (*s)[4], float m[2],
                                                   float l[2], float alpha[2],
                                                   const uint32_t* kb,
                                                   float scale,
                                                   const DropStream& drop,
                                                   size_t rows_at, int L) {
  const int lane = threadIdx.x % 32, col = 2 * (lane % 4);
  const uint32_t pad[2] = {kb[0] >> col, kb[1] >> col};
  const uint32_t past[2] = {kb[2] >> col, kb[3] >> col};
  float mx[2][8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int bit = 8 * (j & 3) + (e & 1);
      const bool pad_key = !kLive && ((pad[j >> 2] >> bit) & 1u);
      const bool past_key = !kLive && ((past[j >> 2] >> bit) & 1u);
      s[j][e] = past_key  ? -INFINITY
                : pad_key ? kNegInfFill
                          : __fmul_rn(s[j][e], scale);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r][j] = fmaxf(s[j][2 * r], s[j][2 * r + 1]);
  }
  float m_new[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_new[r] = fmaxf(m[r], quad_max(tree_max8(mx[r])));
    alpha[r] = exp2_approx((m[r] - m_new[r]) * kLog2e);
  }
  float psum[2][8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float p = f32_prob(s[j][e], m_new[r], 1.f);
      psum[r][j] = e & 1 ? psum[r][j] + p : p;
      if (drop.on &&
          !drop_keep(drop, rows_at + (size_t)(lane / 4 + 8 * r) * L + 8 * j +
                               col + (e & 1)))
        p = 0.f;
      s[j][e] = p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = l[r] * alpha[r] + quad_sum(tree_sum8(psum[r]));
    m[r] = m_new[r];
  }
}

// The fp32 forward: one block of f32_fwd_warps(kDk) warps per (16 warps
// queries, slate-head), each warp 16 query rows, their q split once into
// hi and lo planes; the 64-key tiles of k and v streamed through the ring.
// Each tile's P . v sums from zero (the tensor cores truncate their sums)
// and joins the rescaled running sum in fp32.
template <int kDk, bool kAligned>
__global__ void __launch_bounds__(32 * f32_fwd_warps(kDk))
    tiled_fwd_tf32x3_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const unsigned char* __restrict__ key_mask,
                            float* __restrict__ out, float* __restrict__ lse,
                            int L, int dk, int h, float scale,
                            DropStream drop) {
  constexpr int kSt = f32_fwd_stages(kDk);
  constexpr int kThreads = 32 * f32_fwd_warps(kDk);
  constexpr int kRows = 16 * f32_fwd_warps(kDk);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dkp = f32_head_pad(dk), pitch = f32_pitch(dkp), nk = dkp / 8;
  const int tile = kKeyTile * pitch;
  float* Qh = reinterpret_cast<float*>(smem_raw);  // [kRows][pitch] q, hi
  float* Ql = Qh + kRows * pitch;                  // q, lo
  float* Ks = Ql + kRows * pitch;   // [kSt][64][pitch] key tiles
  float* Vs = Ks + kSt * tile;      // [kSt][64][pitch] value tiles
  uint32_t* bits = reinterpret_cast<uint32_t*>(Vs + kSt * tile);
  const int g = blockIdx.y, q0 = blockIdx.x * kRows;
  const size_t base = (size_t)g * L * dk;
  const unsigned char* padded = key_mask + (size_t)(g / h) * L;
  const int lane = threadIdx.x % 32, wrow = (threadIdx.x / 32) * 16;
  const int n_tiles = (L + kKeyTile - 1) / kKeyTile;

  // key tile t into ring slot b: k, v and the keys' bits (bits[4 b..])
  auto stage = [&](int t, int b) {
    stage_f32_rows<kKeyTile, kThreads, kAligned>(Ks + b * tile, k + base,
                                                 t * kKeyTile, L, dk, dkp);
    stage_f32_rows<kKeyTile, kThreads, kAligned>(Vs + b * tile, v + base,
                                                 t * kKeyTile, L, dk, dkp);
    stage_key_bits(bits + 4 * b, padded, t * kKeyTile, L);
  };
  stage_f32_rows<kRows, kThreads, kAligned>(Qh, q + base, q0, L, dk, dkp);
#pragma unroll
  for (int i = 0; i < kSt - 1; ++i) {
    if (i < n_tiles) stage(i, i);
    cp_async_commit();
  }
  cp_async_wait<kSt - 2>();
  __syncthreads();
  split_planes<kRows, kThreads>(Qh, Ql, pitch, dkp);

  float o[kDk / 8][4] = {};
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  for (int it = 0, buf = 0; it < n_tiles;
       ++it, buf = buf == kSt - 1 ? 0 : buf + 1) {
    // tile it has landed; after the barrier every warp is done with the
    // slot that tile it + kSt - 1 takes
    cp_async_wait<kSt - 2>();
    __syncthreads();
    if (it + kSt - 1 < n_tiles)
      stage(it + kSt - 1, buf == 0 ? kSt - 1 : buf - 1);
    cp_async_commit();
    const uint32_t* kb = bits + 4 * buf;
    float s[8][4] = {};
    rows_by_rows_f32<kDk, 8, true>(s, Qh, Ql, wrow, Ks + buf * tile, pitch,
                                   nk);
    const size_t rows_at = ((size_t)g * L + q0 + wrow) * L + it * kKeyTile;
    float alpha[2];
    if ((kb[0] | kb[1] | kb[2] | kb[3]) == 0)
      online_softmax_f32<true>(s, m, l, alpha, kb, scale, drop, rows_at, L);
    else
      online_softmax_f32<false>(s, m, l, alpha, kb, scale, drop, rows_at, L);
    float t[kDk / 8][4] = {};
    weigh_rows_f32<kDk, 8>(t, s, Vs + buf * tile, pitch, nk);
#pragma unroll
    for (int n = 0; n < kDk / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[n][e] = fmaf(o[n][e], alpha[e >> 1], t[n][e]);
  }
  const float inv = drop.on ? drop.inv : 1.f;
  float f[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float denom = fmaxf(l[r], 1e-30f);
    f[r] = inv / denom;
    const int row = q0 + wrow + lane / 4 + 8 * r;
    if (lse != nullptr && lane % 4 == 0 && row < L)
      lse[(size_t)g * L + row] = m[r] + logf(denom);
  }
  store_rows_f32<kDk>(out + base, o, f, q0 + wrow, L, dk, nk);
}

// The fp32 backward (attention_tf32x3.cuh): dQ, which takes D from the
// forward's output, then dK/dV, each from the row logsumexp.
template <int kDk, bool kAligned>
__global__ void __launch_bounds__(32 * f32_dq_warps(kDk))
    tiled_bwd_dq_tf32x3_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const unsigned char* __restrict__ key_mask,
                               const float* __restrict__ lse,
                               const float* __restrict__ dO,
                               const float* __restrict__ O,
                               float* __restrict__ Dg, float* __restrict__ dq,
                               int L, int dk, int h, float scale,
                               DropStream drop) {
  bwd_dq_tf32x3<true, kDk, kAligned>(q, k, v, key_mask, lse, dO, O, Dg, dq, L,
                                     dk, h, scale, drop);
}

template <int kDk, bool kAligned>
__global__ void __launch_bounds__(32 * f32_dkv_warps(kDk))
    tiled_bwd_dkv_tf32x3_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const unsigned char* __restrict__ key_mask,
                                const float* __restrict__ lse,
                                const float* __restrict__ Dg,
                                const float* __restrict__ dO,
                                float* __restrict__ dk_out,
                                float* __restrict__ dv_out, int L, int dk,
                                int h, float scale, DropStream drop) {
  bwd_dkv_tf32x3<true, kDk, kAligned>(q, k, v, key_mask, lse, Dg, dO, dk_out,
                                      dv_out, L, dk, h, scale, drop);
}

// The fp32 forward for head widths padded to at most kDk.
template <int kDk, bool kAligned>
cudaError_t launch_fwd_tf32x3(const void* q, const void* k, const void* v,
                              const void* key_mask, void* out, void* lse,
                              int G, int L, int dk, int h, float scale,
                              DropStream drop, cudaStream_t stream) {
  constexpr int kSt = f32_fwd_stages(kDk);
  constexpr int kRows = 16 * f32_fwd_warps(kDk);
  auto kernel = tiled_fwd_tf32x3_kernel<kDk, kAligned>;
  const size_t smem = f32_smem(dk, 2 * kRows + 2 * kSt * kKeyTile,
                               4 * kSt * sizeof(uint32_t));
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((L + kRows - 1) / kRows, G), 32 * f32_fwd_warps(kDk), smem,
           stream>>>(static_cast<const float*>(q),
                     static_cast<const float*>(k),
                     static_cast<const float*>(v),
                     static_cast<const unsigned char*>(key_mask),
                     static_cast<float*>(out), static_cast<float*>(lse), L,
                     dk, h, scale, drop);
  return cudaGetLastError();
}

// The fp32 backward's two kernels, dQ (which writes D) then dK/dV.
template <int kDk, bool kAligned>
cudaError_t launch_bwd_tf32x3_lse(const void* q, const void* k, const void* v,
                                  const void* key_mask, const void* lse,
                                  const void* dO, const void* O, void* D,
                                  void* dq, void* dk_out, void* dv_out, int G,
                                  int L, int dk, int h, float scale,
                                  DropStream drop, cudaStream_t stream) {
  return launch_bwd_tf32x3<kDk>(tiled_bwd_dq_tf32x3_kernel<kDk, kAligned>,
                                tiled_bwd_dkv_tf32x3_kernel<kDk, kAligned>, q,
                                k, v, key_mask, lse, dO, O, D, dq, dk_out,
                                dv_out, G, L, dk, h, scale, drop, stream);
}

cudaError_t tiled_fwd_f32(const void* q, const void* k, const void* v,
                          const void* key_mask, void* out, void* lse, int G,
                          int L, int dk, int h, float scale, DropStream drop,
                          cudaStream_t stream) {
  MMA_DK_DISPATCH(launch_fwd_tf32x3, dk, rows_aligned(dk, {q, k, v}, 4), q,
                  k, v, key_mask, out, lse, G, L, dk, h, scale, drop, stream);
}

cudaError_t tiled_bwd_f32(const void* q, const void* k, const void* v,
                          const void* key_mask, const void* out,
                          const void* lse, void* D, const void* dO, void* dq,
                          void* dk_out, void* dv_out, int G, int L, int dk,
                          int h, float scale, DropStream drop,
                          cudaStream_t stream) {
  MMA_DK_DISPATCH(launch_bwd_tf32x3_lse, dk,
                  rows_aligned(dk, {q, k, v, dO}, 4), q, k, v, key_mask, lse,
                  dO, out, D, dq, dk_out, dv_out, G, L, dk, h, scale, drop,
                  stream);
}

}  // namespace
}  // namespace allrank

// Launches the forward on `stream`; returns 0 or the CUDA error code. q, k,
// v and out are [G, L, d_k] (G = B * h, d_k <= 128) in bf16 if is_bf16,
// else fp32 (3xTF32), both on the tensor cores; key_mask is [B, L] bytes,
// non-zero at padded documents. lse ([G, L] fp32, each row's
// logsumexp) may be null. drop_keys holds {k0, k1, threshold} of the
// probability stream (ops/dropout.py), p_drop its rate.
extern "C" int tiled_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* key_mask,
                                   void* out, void* lse, int G, int L, int dk,
                                   int h, float scale, int is_bf16,
                                   const unsigned* drop_keys, double p_drop,
                                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto drop = allrank::make_stream(drop_keys, p_drop);
  if (is_bf16)
    return allrank::tiled_fwd_bf16(q, k, v, key_mask, out, lse, G, L, dk, h,
                                   scale, drop, s);
  return allrank::tiled_fwd_f32(q, k, v, key_mask, out, lse, G, L, dk, h,
                                scale, drop, s);
}

// Launches the backward's two kernels on `stream`; returns 0 or the CUDA
// error code. Inputs q, k, v, key_mask, out and lse from the forward and dO
// ([G, L, d_k], q's dtype); outputs dq, dk, dv in q's dtype. D ([G, L]
// fp32, rowsum(dO * O)) is an input in bf16; in fp32 the dQ kernel takes it
// from out and dO and writes it there (attention_tf32x3.cuh).
extern "C" int tiled_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* key_mask,
                                   const void* out, const void* lse, void* D,
                                   const void* dO, void* dq, void* dk_out,
                                   void* dv_out, int G, int L, int dk, int h,
                                   float scale, int is_bf16,
                                   const unsigned* drop_keys, double p_drop,
                                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto drop = allrank::make_stream(drop_keys, p_drop);
  if (is_bf16)
    return allrank::tiled_bwd_bf16(q, k, v, key_mask, lse, D, dO, dq, dk_out,
                                   dv_out, G, L, dk, h, scale, drop, s);
  return allrank::tiled_bwd_f32(q, k, v, key_mask, out, lse, D, dO, dq,
                                dk_out, dv_out, G, L, dk, h, scale, drop, s);
}
