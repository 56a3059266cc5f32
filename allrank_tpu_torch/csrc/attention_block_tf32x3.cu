// B1, the attention sublayer, forward and backward in fp32 on Hopper's
// tensor cores (sm_90a), every product a 3xTF32 split product:
//   y = x + drop_r(Wout . MHA_drop_a(LN(x) . Wqkv + bqkv) + bout)
// with the unbiased-std LayerNorm (eps added to the std, the variance
// floored at 1e-24), scores scaled by 1/sqrt(d_k), padded keys filled with
// -1e9 before an exact, max-subtracted softmax, dropout on the attention
// probabilities (index ((b h + head) L + q) L + k) and on the sublayer output
// (csrc/dropout.cuh), and the residual added in fp32.
//
// Replaces the TPU kernel `attention_sublayer` of the JAX package's
// ops/attention_block.py for fp32 activations with d_k <= 128: forward
// pallas_call at line 343 (attn_sublayer_fwd_vmem, lines 122-144),
// backward at line 375 (attn_sublayer_bwd_vmem, lines 159-254). bf16 takes
// attention_block_mma.cu, and heads wider than 128 the SIMT kernels of
// attention_block.cu; the route is chosen in ops/attention_block.py from
// dtype, d and h alone.
//
// What bounds it: operations. At the flagship shape (B=64, L=240, d=128,
// h=4) the forward does about 3.9 GFLOP (qkv, S, P.V, the out-projection)
// and the backward about 9.7 GFLOP (dO, S and dP recomputed, ctx, dQ, dK,
// dV, dn, dWqkv, dWout), each product counted once: 0.024 and 0.059 ms at a
// third of the card's 495 TFLOP/s TF32 rate, three TF32 products an fp32
// one. The SIMT kernels ran every product as fp32 FMAs at a seventh or less
// of the card's 67 TFLOP/s fp32 rate.
//
// What the design does about it:
//  * Every product is three TF32 mma.sync.m16n8k8 products, lo.hi + hi.lo
//    + hi.hi, small terms first (attention_tf32x3.cuh): some 2^-21 of each
//    product, fp32's parity. The projections and weight gradients run on
//    mma_tile_f32.cuh's product tile, weights split as they are read; the
//    attention core on B4's fp32 pieces (attention_tf32x3.cuh), P and dS
//    kept in registers. Each 64-deep step of a product, each key or query
//    tile, sums from zero and joins its running sum in fp32, since the
//    tensor cores truncate their sums. LN, the softmax statistics and the
//    residual stay in fp32 on the SIMT units. Nothing goes to a library.
//  * The forward is three kernels: LN + QKV over 64 x 128 output tiles
//    (the rows' statistics in fp32, the LN output staged as A, Wqkv
//    streamed in column tiles, bqkv added); the attention core per (slate,
//    head, 128 queries), B4's fp32 forward on q, k and v read in place from
//    qkv [B, L, 3d] (rows 3d apart, the head at column head * d_k), writing
//    ctx [B, L, d] (512 blocks at the flagship); then ctx . Wout + bout,
//    the output dropout and x over 64 x 128 tiles. The bf16 kernel's one
//    block per (slate, 128 queries), looping over the heads with ctx of all
//    of them in shared memory, gives 128 blocks at the flagship and does not
//    fit in fp32 beside the key ring at d = 256 and d_k = 128 (PERF.md, the
//    A/B of the two layouts). In training each row's (max, sum) [B, h, L,
//    2] is kept for the backward.
//  * The backward is seven kernels and three reductions, no atomics, every
//    sum in a fixed order (two backwards give the same bits): rows (da =
//    drop_r(dy), dO = da . Wout^T, and the LN output); dQ per (slate, head,
//    rows) on B4's fp32 dQ body adapted to qkv's strided layout, whose D
//    pass, rowsum(dPd * P), also sums ctx = P_d . v for dWout; dK/dV per
//    (slate, head, keys) likewise; dn = dqkv . Wqkv^T with backward.cuh's
//    fp32 LN backward; dWqkv = LN(x)^T . dqkv and dWout = ctx^T . da as
//    split A^T . B products (A read with 32-bit loads: ldmatrix .trans moves
//    16-bit elements only), their partials and the bias gradients' column
//    sums reduced in split order. P is rebuilt bit for bit from the
//    forward's row statistics with the same exponent function (f32_prob).
//  * Ragged shapes: L of any length (keys past L weigh 0, padded keys score
//    -1e9, so a fully padded slate averages v and never gives NaN; dS is
//    zero at padded keys), d_k padded with zeros to whole 8-column steps
//    and dispatched to 32, 64 or 128 (MMA_DK_DISPATCH), d to whole 8 (K) or
//    16 (N) columns; rows off a 16-byte boundary (d_k % 4 != 0 or a base
//    pointer off 16 bytes) are staged element by element.
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
// (blockIdx.x, blockIdx.y) of the [M, 3d] output.
__global__ void __launch_bounds__(kGemmThreads)
    b1_ln_qkv_tf32x3_kernel(const float* __restrict__ x,
                            const float* __restrict__ ln_scale,
                            const float* __restrict__ ln_bias,
                            const float* __restrict__ wqkv,
                            const float* __restrict__ bqkv,
                            float* __restrict__ qkv, int M, int d,
                            bool vec_w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dpad = round8(d), lda = f32_row_pitch(d);
  const int ldb = f32_kn_pitch(kGemmCols), n3 = 3 * d;
  float* As = reinterpret_cast<float*>(smem_raw);  // [64][lda] LN(x)
  float* Bs = As + kGemmRows * lda;                // [dpad][ldb] Wqkv columns
  float* mean = Bs + dpad * ldb;                   // [64]
  float* rdenom = mean + kGemmRows;                // [64]
  const int m0 = blockIdx.x * kGemmRows, n0 = blockIdx.y * kGemmCols;
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

// ctx of one (slate, head) (blockIdx.y = slate * h + head) for the 16
// f32_fwd_warps(kDk) queries of blockIdx.x: B4's fp32 forward on q, k and v
// read in place from qkv. Pass 1 stages keys only and takes each row's max
// and sum (online, rescaled per tile), pass 2 keys and values for P =
// exp2((sc - max) log2(e)) * (1 / sum) (f32_prob), dropped, and P . v, each
// tile's sum from zero added in fp32. With `stats` non-null also each row's
// max and sum [B, h, L, 2].
template <int kDk, bool kAligned>
__global__ void __launch_bounds__(32 * f32_fwd_warps(kDk))
    b1_attn_tf32x3_kernel(const float* __restrict__ qkv,
                          const unsigned char* __restrict__ key_mask,
                          float* __restrict__ ctx, float* __restrict__ stats,
                          int L, int d, int h, float scale, DropStream drop) {
  constexpr int kSt = f32_fwd_stages(kDk);
  constexpr int kThreads = 32 * f32_fwd_warps(kDk);
  constexpr int kRows = 16 * f32_fwd_warps(kDk);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dk = d / h, dkp = f32_head_pad(dk), pitch = f32_pitch(dkp);
  const int nk = dkp / 8, tile = kKeyTile * pitch;
  float* Qh = reinterpret_cast<float*>(smem_raw);  // [kRows][pitch] q, hi
  float* Ql = Qh + kRows * pitch;                  // q, lo
  float* Ks = Ql + kRows * pitch;   // [kSt][64][pitch] key tiles
  float* Vs = Ks + kSt * tile;      // [kSt][64][pitch] value tiles
  uint32_t* bits = reinterpret_cast<uint32_t*>(Vs + kSt * tile);
  const int g = blockIdx.y, slate = g / h, head = g % h;
  const int q0 = blockIdx.x * kRows;
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
// (blockIdx.x, blockIdx.y) of the [M, d] output.
__global__ void __launch_bounds__(kGemmThreads)
    b1_out_tf32x3_kernel(const float* __restrict__ ctx,
                         const float* __restrict__ x,
                         const float* __restrict__ wout,
                         const float* __restrict__ bout,
                         float* __restrict__ y, int M, int d, bool vec_a,
                         bool vec_w, DropStream drop_r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dpad = round8(d), lda = f32_row_pitch(d);
  const int ldb = f32_kn_pitch(kGemmCols);
  float* As = reinterpret_cast<float*>(smem_raw);  // [64][lda] ctx
  float* Bs = As + kGemmRows * lda;                // [dpad][ldb] Wout columns
  const int m0 = blockIdx.x * kGemmRows, n0 = blockIdx.y * kGemmCols;
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
// (blockIdx.x, blockIdx.y) of dO; the tiles of the first column tile also
// write da and n = LN(x) (dWqkv's A operand).
__global__ void __launch_bounds__(kGemmThreads)
    b1_bwd_rows_tf32x3_kernel(const float* __restrict__ x,
                              const float* __restrict__ dy,
                              const float* __restrict__ ln_scale,
                              const float* __restrict__ ln_bias,
                              const float* __restrict__ wout,
                              float* __restrict__ da, float* __restrict__ dO,
                              float* __restrict__ n_act, int M, int d,
                              bool vec_w, DropStream drop_r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dpad = round8(d), lda = f32_row_pitch(d);
  float* As = reinterpret_cast<float*>(smem_raw);  // [64][lda] da
  float* Bs = As + kGemmRows * lda;  // [128][lda] rows n0.. of Wout
  float* mean = Bs + kGemmCols * lda;  // [64]
  float* rdenom = mean + kGemmRows;    // [64]
  const int m0 = blockIdx.x * kGemmRows, n0 = blockIdx.y * kGemmCols;
  const int rows = min(kGemmRows, M - m0);
  const bool lead = blockIdx.y == 0;

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

// dQ of one (slate, head) (blockIdx.y) for 16 f32_dq_warps(kDk) queries:
// B4's fp32 dQ body (attention_tf32x3.cuh's bwd_dq_tf32x3) on q, k and v
// read in place from qkv and dO from [B*L, d]. Pass 0 walks the key tiles
// for D = rowsum(dPd * P), written to Dg, and ctx = P_d . v, written to
// ctx; pass 1 for dS = P (dPd - D) and dQ += dS k, scaled once and written
// into dqkv's q columns.
template <int kDk, bool kAligned>
__global__ void __launch_bounds__(32 * f32_dq_warps(kDk))
    b1_bwd_dq_tf32x3_kernel(const float* __restrict__ qkv,
                            const unsigned char* __restrict__ key_mask,
                            const float* __restrict__ stats,
                            const float* __restrict__ dO,
                            float* __restrict__ ctx, float* __restrict__ Dg,
                            float* __restrict__ dqkv, int L, int d, int h,
                            float scale, DropStream drop) {
  constexpr int kWarps = f32_dq_warps(kDk), kSt = f32_bwd_stages(kDk);
  constexpr int kThreads = 32 * kWarps, kRows = 16 * kWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dk = d / h, dkp = f32_head_pad(dk), pitch = f32_pitch(dkp);
  const int nk = dkp / 8, tile = kKeyTile * pitch;
  float* Qh = reinterpret_cast<float*>(smem_raw);  // [kRows][pitch] q, hi
  float* Ql = Qh + kRows * pitch;                  // q, lo
  float* Oh = Ql + kRows * pitch;                  // dO, hi
  float* Ol = Oh + kRows * pitch;                  // dO, lo
  float* Ks = Ol + kRows * pitch;   // [kSt][64][pitch] key tiles
  float* Vs = Ks + kSt * tile;      // [kSt][64][pitch] value tiles
  uint32_t* bits = reinterpret_cast<uint32_t*>(Vs + kSt * tile);
  const int g = blockIdx.y, slate = g / h, head = g % h;
  const int q0 = blockIdx.x * kRows;
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
  __syncthreads();
  split_planes<kRows, kThreads>(Qh, Ql, pitch, dkp);
  split_planes<kRows, kThreads>(Oh, Ol, pitch, dkp);
  __syncthreads();

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
    __syncthreads();
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

// dK and dV of one (slate, head) (blockIdx.y) for 16 f32_dkv_warps(kDk)
// keys: B4's fp32 dK/dV body (attention_tf32x3.cuh's bwd_dkv_tf32x3) on
// qkv and dO in place, q, dO and each query's statistics and D streamed
// through the ring; per 32 queries S^T = K Q^T and dP^T = V dO^T, P^T
// rebuilt as the forward formed P, then dV += P_d^T dO and dK += dS^T q,
// scaled at the end, written into dqkv's k and v columns.
template <int kDk, bool kAligned>
__global__ void __launch_bounds__(32 * f32_dkv_warps(kDk))
    b1_bwd_dkv_tf32x3_kernel(const float* __restrict__ qkv,
                             const unsigned char* __restrict__ key_mask,
                             const float* __restrict__ stats,
                             const float* __restrict__ Dg,
                             const float* __restrict__ dO,
                             float* __restrict__ dqkv, int L, int d, int h,
                             float scale, DropStream drop) {
  constexpr int kWarps = f32_dkv_warps(kDk), kSt = f32_bwd_stages(kDk);
  constexpr int kThreads = 32 * kWarps, kRows = 16 * kWarps, kQ = 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
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
  const int g = blockIdx.y, slate = g / h, head = g % h;
  const int kt0 = blockIdx.x * kRows;
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
  __syncthreads();
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
  all_live = __syncthreads_and(all_live);
  float dk_acc[kDk / 8][4] = {}, dv_acc[kDk / 8][4] = {};
  for (int it = 0, buf = 0; it < n_tiles;
       ++it, buf = buf == kSt - 1 ? 0 : buf + 1) {
    const int q0 = it * kQ;
    cp_async_wait<kSt - 2>();
    __syncthreads();
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

// dn = dqkv . Wqkv^T for the 64 rows of blockIdx.x, 64 columns of dqkv a
// step, then the LN backward in fp32 (ln_backward_tile): dx and the tile's
// partial sums of dg and db (part_ln row blockIdx.x).
__global__ void __launch_bounds__(kGemmThreads)
    b1_bwd_ln_qkv_tf32x3_kernel(const float* __restrict__ x,
                                const float* __restrict__ dy,
                                const float* __restrict__ dqkv,
                                const float* __restrict__ ln_scale,
                                const float* __restrict__ wqkv,
                                float* __restrict__ dx,
                                float* __restrict__ part_ln, int M, int d,
                                bool vec_a, bool vec_w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dpad16 = (d + 15) / 16 * 16, kp = f32_row_pitch(kLnK);
  const int n3 = 3 * d, ldn = d + 1;
  float* As = reinterpret_cast<float*>(smem_raw);  // [64][kp] dqkv columns
  float* Bs = As + kGemmRows * kp;   // [dpad16][kp] the same columns of Wqkv
  float* Ns = Bs + dpad16 * kp;      // [64][ldn] dn
  float* rmean = Ns + kGemmRows * ldn;  // [kTile]
  float* rden = rmean + kTile;          // [kTile]
  const int m0 = blockIdx.x * kGemmRows, rows = min(kGemmRows, M - m0);
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
                   part_ln + (size_t)blockIdx.x * 2 * d, rmean, rden);
}

// split blockIdx.z of C = A^T . B and colsum(B) (mma_tile_f32.cuh's
// f32_atb_tile)
__global__ void __launch_bounds__(kF32AtbThreads)
    b1_atb_tf32x3_kernel(const float* __restrict__ A,
                         const float* __restrict__ Bm,
                         float* __restrict__ part, int M, int K, int N,
                         int rows_per_split, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  f32_atb_tile(reinterpret_cast<float*>(smem_raw), A, K, Bm, N, part, M, K,
               N, rows_per_split, vec);
}

// ---------------------------------------------------------------------------
// launches

// shared memory of a 64 x 128 projection tile: A [64][lda], B [b_rows][ldb]
// and `extra` floats
size_t gemm_smem(int lda, int b_rows, int ldb, int extra) {
  return ((size_t)kGemmRows * lda + (size_t)b_rows * ldb + extra) *
         sizeof(float);
}

template <int kDk, bool kAligned>
cudaError_t launch_attn(const float* qkv, const unsigned char* mask,
                        float* ctx, float* stats, int batch, int L, int d,
                        int h, float scale, DropStream drop,
                        cudaStream_t stream) {
  constexpr int kSt = f32_fwd_stages(kDk);
  constexpr int kRows = 16 * f32_fwd_warps(kDk);
  auto kernel = b1_attn_tf32x3_kernel<kDk, kAligned>;
  const size_t smem = f32_smem(d / h, 2 * kRows + 2 * kSt * kKeyTile,
                               4 * kSt * sizeof(uint32_t));
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((L + kRows - 1) / kRows, batch * h), 32 * f32_fwd_warps(kDk),
           smem, stream>>>(qkv, mask, ctx, stats, L, d, h, scale, drop);
  return cudaGetLastError();
}

cudaError_t fwd_f32(const float* x, const unsigned char* mask,
                    const float* ln_scale, const float* ln_bias,
                    const float* wqkv, const float* bqkv, const float* wout,
                    const float* bout, float* qkv, float* y, float* stats,
                    float* ctx, int batch, int L, int d, int h, float scale,
                    DropStream drop_a, DropStream drop_r,
                    cudaStream_t stream) {
  const int M = batch * L, dk = d / h, dpad = round8(d);
  if (dk > 128) return cudaErrorInvalidValue;
  const int row_tiles = (M + kGemmRows - 1) / kGemmRows;
  const int ldb = f32_kn_pitch(kGemmCols), lda = f32_row_pitch(d);
  const size_t smem1 = gemm_smem(lda, dpad, ldb, 2 * kGemmRows);
  cudaError_t err = allow_smem(b1_ln_qkv_tf32x3_kernel, smem1);
  if (err != cudaSuccess) return err;
  b1_ln_qkv_tf32x3_kernel<<<dim3(row_tiles, (3 * d + kGemmCols - 1) /
                                                kGemmCols),
                            kGemmThreads, smem1, stream>>>(
      x, ln_scale, ln_bias, wqkv, bqkv, qkv, M, d,
      d % 4 == 0 && aligned16({wqkv}));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const auto launch = [&]() -> cudaError_t {
    MMA_DK_DISPATCH(launch_attn, dk, rows_aligned(dk, {qkv, ctx}, 4), qkv,
                    mask, ctx, stats, batch, L, d, h, scale, drop_a, stream);
  };
  if ((err = launch()) != cudaSuccess) return err;

  const size_t smem3 = gemm_smem(lda, dpad, ldb, 0);
  if ((err = allow_smem(b1_out_tf32x3_kernel, smem3)) != cudaSuccess)
    return err;
  b1_out_tf32x3_kernel<<<dim3(row_tiles, (d + kGemmCols - 1) / kGemmCols),
                         kGemmThreads, smem3, stream>>>(
      ctx, x, wout, bout, y, M, d, d % 4 == 0 && aligned16({ctx}),
      d % 4 == 0 && aligned16({wout}), drop_r);
  return cudaGetLastError();
}

struct BwdArgs {
  const float *x, *ln_scale, *ln_bias, *wqkv, *wout, *qkv, *stats, *dy;
  const unsigned char* key_mask;
  float *dx, *dg, *db, *dwqkv, *dbqkv, *dwout, *dbout;
  float *da, *dO, *n_act, *ctx, *dqkv, *D, *part_qkv, *part_out, *part_ln;
  int batch, L, d, h, splits_qkv, splits_out;
  float scale;
};

template <int kDk, bool kAligned>
cudaError_t launch_attn_bwd(const BwdArgs& a, DropStream drop,
                            cudaStream_t stream) {
  constexpr int kSt = f32_bwd_stages(kDk);
  constexpr int kRowsQ = 16 * f32_dq_warps(kDk);
  constexpr int kRowsKv = 16 * f32_dkv_warps(kDk);
  const int dk = a.d / a.h, G = a.batch * a.h;
  auto dq_kernel = b1_bwd_dq_tf32x3_kernel<kDk, kAligned>;
  auto dkv_kernel = b1_bwd_dkv_tf32x3_kernel<kDk, kAligned>;
  const size_t smem_q = f32_smem(dk, 4 * kRowsQ + 2 * kSt * kKeyTile,
                                 4 * kSt * sizeof(uint32_t));
  const size_t smem_kv = f32_smem(dk, 4 * kRowsKv + 2 * kSt * 64,
                                  3 * kSt * 64 * sizeof(float));
  cudaError_t err = allow_smem(dq_kernel, smem_q);
  if (err != cudaSuccess) return err;
  if ((err = allow_smem(dkv_kernel, smem_kv)) != cudaSuccess) return err;
  dq_kernel<<<dim3((a.L + kRowsQ - 1) / kRowsQ, G), 32 * f32_dq_warps(kDk),
              smem_q, stream>>>(a.qkv, a.key_mask, a.stats, a.dO, a.ctx, a.D,
                                a.dqkv, a.L, a.d, a.h, a.scale, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkv_kernel<<<dim3((a.L + kRowsKv - 1) / kRowsKv, G),
               32 * f32_dkv_warps(kDk), smem_kv, stream>>>(
      a.qkv, a.key_mask, a.stats, a.D, a.dO, a.dqkv, a.L, a.d, a.h, a.scale,
      drop);
  return cudaGetLastError();
}

cudaError_t bwd_f32(const BwdArgs& a, DropStream drop_a, DropStream drop_r,
                    cudaStream_t stream) {
  const int M = a.batch * a.L, d = a.d, dk = d / a.h;
  if (dk > 128) return cudaErrorInvalidValue;
  const int row_tiles = (M + kGemmRows - 1) / kGemmRows;
  const int lda = f32_row_pitch(d);
  const bool d4 = d % 4 == 0;

  const size_t smem_rows = gemm_smem(lda, kGemmCols, lda, 2 * kGemmRows);
  cudaError_t err = allow_smem(b1_bwd_rows_tf32x3_kernel, smem_rows);
  if (err != cudaSuccess) return err;
  b1_bwd_rows_tf32x3_kernel<<<dim3(row_tiles,
                                   (d + kGemmCols - 1) / kGemmCols),
                              kGemmThreads, smem_rows, stream>>>(
      a.x, a.dy, a.ln_scale, a.ln_bias, a.wout, a.da, a.dO, a.n_act, M, d,
      d4 && aligned16({a.wout}), drop_r);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const auto launch = [&]() -> cudaError_t {
    MMA_DK_DISPATCH(launch_attn_bwd, dk,
                    rows_aligned(dk, {a.qkv, a.dO, a.ctx, a.dqkv}, 4), a,
                    drop_a, stream);
  };
  if ((err = launch()) != cudaSuccess) return err;

  const int dpad16 = (d + 15) / 16 * 16, kp = f32_row_pitch(kLnK);
  const size_t smem_ln =
      ((size_t)(kGemmRows + dpad16) * kp + (size_t)kGemmRows * (d + 1) +
       2 * kTile) * sizeof(float);
  if ((err = allow_smem(b1_bwd_ln_qkv_tf32x3_kernel, smem_ln)) != cudaSuccess)
    return err;
  b1_bwd_ln_qkv_tf32x3_kernel<<<row_tiles, kGemmThreads, smem_ln, stream>>>(
      a.x, a.dy, a.dqkv, a.ln_scale, a.wqkv, a.dx, a.part_ln, M, d,
      d4 && aligned16({a.dqkv}), d4 && aligned16({a.wqkv}));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  err = f32_weight_grad(b1_atb_tf32x3_kernel, a.n_act, a.dqkv, a.part_qkv,
                        a.dwqkv, a.dbqkv, M, d, 3 * d, a.splits_qkv, stream);
  if (err != cudaSuccess) return err;
  err = f32_weight_grad(b1_atb_tf32x3_kernel, a.ctx, a.da, a.part_out,
                        a.dwout, a.dbout, M, d, d, a.splits_out, stream);
  if (err != cudaSuccess) return err;
  return launch_reduce(a.part_ln, row_tiles, a.dg, d, a.db, d, stream);
}

}  // namespace
}  // namespace allrank

// Launches the forward's three kernels on `stream`; returns 0 or the CUDA
// error code. x, qkv ([B, L, 3d], kept for the backward), y and the scratch
// ctx [B, L, d] are fp32, d_k = d / h <= 128; key_mask is [B, L] bytes,
// non-zero at padded documents; parameters are fp32. stats ([B, h, L, 2]
// fp32: each row's softmax max and sum) may be null. drop_keys holds {k0,
// k1, threshold} of the probability stream, then of the output stream
// (ops/dropout.py); p_attn / p_resid are their rates (0: no dropout).
extern "C" int attention_sublayer_fwd_tf32x3(
    const void* x, const void* key_mask, const void* ln_scale,
    const void* ln_bias, const void* wqkv, const void* bqkv, const void* wout,
    const void* bout, void* qkv, void* y, void* stats, void* ctx, int batch,
    int L, int d, int h, float scale, const unsigned* drop_keys,
    double p_attn, double p_resid, void* stream) {
  using F = const float*;
  return allrank::fwd_f32(
      static_cast<F>(x), static_cast<const unsigned char*>(key_mask),
      static_cast<F>(ln_scale), static_cast<F>(ln_bias), static_cast<F>(wqkv),
      static_cast<F>(bqkv), static_cast<F>(wout), static_cast<F>(bout),
      static_cast<float*>(qkv), static_cast<float*>(y),
      static_cast<float*>(stats), static_cast<float*>(ctx), batch, L, d, h,
      scale, allrank::make_stream(drop_keys, p_attn),
      allrank::make_stream(drop_keys + 3, p_resid),
      static_cast<cudaStream_t>(stream));
}

// Launches the backward's seven kernels and three reductions on `stream`;
// returns 0 or the CUDA error code. Arguments as attention_block.cu's
// attention_sublayer_bwd, every activation and scratch row in fp32: inputs
// x, key_mask, ln_scale, ln_bias, wqkv, wout, and qkv and stats from the
// forward, dy; outputs dx and the gradients dg, db [d], dwqkv [d, 3d],
// dbqkv [3d], dwout [d, d], dbout [d]; scratch da, dO, n_act, ctx [B*L, d],
// dqkv [B*L, 3d], D [B, h, L], part_qkv [splits_qkv, 3d*d + 3d], part_out
// [splits_out, d*d + d] and part_ln [ceil(B*L / 64), 2d].
extern "C" int attention_sublayer_bwd_tf32x3(
    const void* x, const void* key_mask, const void* ln_scale,
    const void* ln_bias, const void* wqkv, const void* wout, const void* qkv,
    const void* stats, const void* dy, void* dx, void* dg, void* db,
    void* dwqkv, void* dbqkv, void* dwout, void* dbout, void* da, void* dO,
    void* n_act, void* ctx, void* dqkv, void* D, void* part_qkv,
    void* part_out, void* part_ln, int batch, int L, int d, int h,
    int splits_qkv, int splits_out, float scale, const unsigned* drop_keys,
    double p_attn, double p_resid, void* stream) {
  using F = const float*;
  auto f = [](void* p) { return static_cast<float*>(p); };
  const allrank::BwdArgs a{
      static_cast<F>(x),      static_cast<F>(ln_scale), static_cast<F>(ln_bias),
      static_cast<F>(wqkv),   static_cast<F>(wout),     static_cast<F>(qkv),
      static_cast<F>(stats),  static_cast<F>(dy),
      static_cast<const unsigned char*>(key_mask),
      f(dx),  f(dg),  f(db),  f(dwqkv), f(dbqkv), f(dwout), f(dbout),
      f(da),  f(dO),  f(n_act), f(ctx), f(dqkv),  f(D),     f(part_qkv),
      f(part_out), f(part_ln), batch, L, d, h, splits_qkv, splits_out, scale};
  return allrank::bwd_f32(a, allrank::make_stream(drop_keys, p_attn),
                          allrank::make_stream(drop_keys + 3, p_resid),
                          static_cast<cudaStream_t>(stream));
}
