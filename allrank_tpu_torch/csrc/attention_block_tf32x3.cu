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
#include "b1_tf32x3_tiles.cuh"

namespace allrank {
namespace {

__global__ void __launch_bounds__(kGemmThreads)
    b1_ln_qkv_tf32x3_kernel(const float* __restrict__ x,
                            const float* __restrict__ ln_scale,
                            const float* __restrict__ ln_bias,
                            const float* __restrict__ wqkv,
                            const float* __restrict__ bqkv,
                            float* __restrict__ qkv, int M, int d,
                            bool vec_w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  b1_ln_qkv_tf32x3_tile(smem_raw, x, ln_scale, ln_bias, wqkv, bqkv, qkv, M, d,
                        vec_w, blockIdx.x, blockIdx.y);
}

template <int kDk, bool kAligned>
__global__ void __launch_bounds__(32 * f32_fwd_warps(kDk))
    b1_attn_tf32x3_kernel(const float* __restrict__ qkv,
                          const unsigned char* __restrict__ key_mask,
                          float* __restrict__ ctx, float* __restrict__ stats,
                          int L, int d, int h, float scale, DropStream drop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  b1_attn_tf32x3_tile<kDk, kAligned>(smem_raw, qkv, key_mask, ctx, stats, L, d,
                                     h, scale, drop, blockIdx.x, blockIdx.y);
}

__global__ void __launch_bounds__(kGemmThreads)
    b1_out_tf32x3_kernel(const float* __restrict__ ctx,
                         const float* __restrict__ x,
                         const float* __restrict__ wout,
                         const float* __restrict__ bout,
                         float* __restrict__ y, int M, int d, bool vec_a,
                         bool vec_w, DropStream drop_r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  b1_out_tf32x3_tile(smem_raw, ctx, x, wout, bout, y, M, d, vec_a, vec_w,
                     drop_r, blockIdx.x, blockIdx.y);
}

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
  b1_bwd_rows_tf32x3_tile(smem_raw, x, dy, ln_scale, ln_bias, wout, da, dO,
                          n_act, M, d, vec_w, drop_r, blockIdx.x, blockIdx.y);
}

template <int kDk, bool kAligned>
__global__ void __launch_bounds__(32 * f32_dq_warps(kDk))
    b1_bwd_dq_tf32x3_kernel(const float* __restrict__ qkv,
                            const unsigned char* __restrict__ key_mask,
                            const float* __restrict__ stats,
                            const float* __restrict__ dO,
                            float* __restrict__ ctx, float* __restrict__ Dg,
                            float* __restrict__ dqkv, int L, int d, int h,
                            float scale, DropStream drop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  b1_bwd_dq_tf32x3_tile<kDk, kAligned>(smem_raw, qkv, key_mask, stats, dO, ctx,
                                       Dg, dqkv, L, d, h, scale, drop,
                                       blockIdx.x, blockIdx.y);
}

template <int kDk, bool kAligned>
__global__ void __launch_bounds__(32 * f32_dkv_warps(kDk))
    b1_bwd_dkv_tf32x3_kernel(const float* __restrict__ qkv,
                             const unsigned char* __restrict__ key_mask,
                             const float* __restrict__ stats,
                             const float* __restrict__ Dg,
                             const float* __restrict__ dO,
                             float* __restrict__ dqkv, int L, int d, int h,
                             float scale, DropStream drop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  b1_bwd_dkv_tf32x3_tile<kDk, kAligned>(smem_raw, qkv, key_mask, stats, Dg, dO,
                                        dqkv, L, d, h, scale, drop, blockIdx.x,
                                        blockIdx.y);
}

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
  b1_bwd_ln_qkv_tf32x3_tile(smem_raw, x, dy, dqkv, ln_scale, wqkv, dx, part_ln,
                            M, d, vec_a, vec_w, blockIdx.x);
}

__global__ void __launch_bounds__(kF32AtbThreads)
    b1_atb_tf32x3_kernel(const float* __restrict__ A,
                         const float* __restrict__ Bm,
                         float* __restrict__ part, int M, int K, int N,
                         int rows_per_split, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  f32_atb_tile(reinterpret_cast<float*>(smem_raw), A, K, Bm, N, part, M, K,
               N, rows_per_split, vec, blockIdx.x, blockIdx.y, blockIdx.z);
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
