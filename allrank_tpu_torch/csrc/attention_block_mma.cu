// B1, the attention sublayer, forward and backward in bf16 on Hopper's
// tensor cores (sm_90a):
//   y = x + drop_r(Wout . MHA_drop_a(LN(x) . Wqkv + bqkv) + bout)
// with the unbiased-std LayerNorm (eps added to the std, the variance
// floored at 1e-24), scores scaled by 1/sqrt(d_k), padded keys filled with
// -1e9 before an exact, max-subtracted softmax, dropout on the attention
// probabilities and on the sublayer output (csrc/dropout.cuh), and the
// residual added in fp32. The bf16 rounding points are the TPU kernel's:
// the LN output, qkv, the dropped normalised P and ctx forward; da, dO, dS
// and dqkv backward. Weights are rounded to bf16 as they are loaded.
//
// Replaces the TPU kernel `attention_sublayer` of the JAX package's
// ops/attention_block.py for bf16 activations with d_k <= 128: forward
// pallas_call at line 343 (attn_sublayer_fwd_vmem, lines 122-144),
// backward at line 375 (attn_sublayer_bwd_vmem, lines 159-254). fp32 with
// d_k <= 128 takes attention_block_tf32x3.cu (3xTF32 on the tensor cores),
// and d_k > 128 in either dtype the SIMT kernels of attention_block.cu; the
// route is chosen in ops/attention_block.py from dtype, d and h alone.
//
// What bounds it: operations. At the flagship shape (B=64, L=240, d=128,
// h=4) the forward does about 3.9 GFLOP (qkv, S, P.V, the out-projection)
// and the backward about 9.7 GFLOP (dO, S and dP recomputed, ctx, dQ, dK,
// dV, dn, dWqkv, dWout), each product counted once, on a few MB of bf16
// activations: some 0.004 and 0.010 ms at the tensor cores' 989 TFLOP/s.
// The SIMT kernels ran every product as fp32 FMAs at 1-2 % of that bound.
//
// What the design does about it:
//  * Every product is an mma.sync.m16n8k16 bf16 x bf16 -> fp32, the TPU
//    kernel's _mm and _dot: the projections and weight gradients on the
//    product tile of mma_tile.cuh, the attention core on B4's tensor-core
//    pieces (attention_mma_tiles.cuh). Nothing goes to a library.
//  * The attention core is B4's two-pass exact softmax (csrc/
//    attention_fused.cu): pass 1 takes each row's max and sum of
//    exp2, pass 2 forms P = exp2(x) * (1 / sum) exactly as B4 does
//    (b4_exponent, b4_probs), drops it at the index ((b h + head) L + q) L +
//    k and rounds it into the A fragment of P . v. It reads each head's q,
//    k and v in place from qkv [B, L, 3d] (rows 3d apart, the head at column
//    head * d_k) through a three-slot cp.async ring (stage_tile).
//  * The forward is two kernels, as the SIMT split: LN + QKV (row
//    statistics in fp32, the bf16 LN output staged as A, Wqkv rounded as it
//    is staged, bqkv added, qkv rounded) over 64 x 128 output tiles; then
//    one block of eight warps per (slate, 128 queries) that runs the core
//    head by head (eight warps, 128 blocks at the flagship's B = 64, took
//    3 % less device time than four warps and 256 blocks in one call:
//    PERF.md), keeps ctx of all heads in shared memory in bf16, and
//    multiplies it by Wout 64 columns at a time, adding bout, the output
//    dropout and x in fp32. In training it stores each row's (max, sum)
//    [B, h, L, 2] for the backward.
//  * The backward is seven kernels and three reductions, no atomics, every
//    sum in a fixed order (two backwards give the same bits): rows (da =
//    drop_r(dy), dO = da . Wout^T, and the LN output); dQ per (slate, head,
//    64 queries) in B4's design, whose D pass, rowsum(dPd * P), also sums
//    ctx = round(P_d) . v for dWout; dK/dV per (slate, head, 128 keys) in
//    B4's transposed design; dn = dqkv . Wqkv^T with the LN backward in
//    fp32 (ln_backward_tile); dWqkv = LN(x)^T . dqkv and dWout = ctx^T . da
//    as split A^T . B products, A read transposed by ldmatrix .trans, their
//    partials (and the bias gradients' column sums) reduced in split order.
//  * Ragged shapes: L of any length (keys past L weigh 0, padded keys score
//    -1e9, so a fully padded slate averages v and never gives NaN), d_k
//    padded with zeros to 32, 64 or 128 (MMA_DK_DISPATCH), d to whole
//    16-column steps; rows off a 16-byte boundary (d_k % 8 != 0 or a base
//    pointer off 16 bytes) are staged element by element.
#include "b1_mma_tiles.cuh"

namespace allrank {
namespace {

__global__ void __launch_bounds__(kGemmThreads)
    b1_ln_qkv_mma_kernel(const bf16* __restrict__ x,
                         const float* __restrict__ ln_scale,
                         const float* __restrict__ ln_bias,
                         const float* __restrict__ wqkv,
                         const float* __restrict__ bqkv, bf16* __restrict__ qkv,
                         int M, int d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  b1_ln_qkv_mma_tile(smem_raw, x, ln_scale, ln_bias, wqkv, bqkv, qkv, M, d,
                     blockIdx.x, blockIdx.y);
}

template <int kDk, bool kAligned>
__global__ void __launch_bounds__(32 * kOutWarps)
    b1_attn_out_mma_kernel(const bf16* __restrict__ qkv,
                           const unsigned char* __restrict__ key_mask,
                           const bf16* __restrict__ x,
                           const float* __restrict__ wout,
                           const float* __restrict__ bout,
                           bf16* __restrict__ y, float* __restrict__ stats,
                           int L, int d, int h, float scale,
                           DropStream drop_a, DropStream drop_r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  b1_attn_out_mma_tile<kDk, kAligned>(smem_raw, qkv, key_mask, x, wout, bout, y,
                                      stats, L, d, h, scale, drop_a, drop_r,
                                      blockIdx.x, blockIdx.y);
}

__global__ void __launch_bounds__(kGemmThreads)
    b1_bwd_rows_mma_kernel(const bf16* __restrict__ x,
                           const bf16* __restrict__ dy,
                           const float* __restrict__ ln_scale,
                           const float* __restrict__ ln_bias,
                           const float* __restrict__ wout,
                           bf16* __restrict__ da, bf16* __restrict__ dO,
                           bf16* __restrict__ n_act, int M, int d,
                           DropStream drop_r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  b1_bwd_rows_mma_tile(smem_raw, x, dy, ln_scale, ln_bias, wout, da, dO, n_act,
                       M, d, drop_r, blockIdx.x, blockIdx.y);
}

template <int kDk, bool kAligned>
__global__ void __launch_bounds__(32 * kDqWarps, b1_dq_min_blocks(kDk))
    b1_bwd_dq_mma_kernel(const bf16* __restrict__ qkv,
                         const unsigned char* __restrict__ key_mask,
                         const float* __restrict__ stats,
                         const bf16* __restrict__ dO, bf16* __restrict__ ctx,
                         float* __restrict__ Dg, bf16* __restrict__ dqkv,
                         int L, int d, int h, float scale, DropStream drop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  b1_bwd_dq_mma_tile<kDk, kAligned>(smem_raw, qkv, key_mask, stats, dO, ctx, Dg,
                                    dqkv, L, d, h, scale, drop, blockIdx.x,
                                    blockIdx.y);
}

template <int kDk, bool kAligned>
__global__ void __launch_bounds__(32 * kDkvWarps, dkv_min_blocks(kDk))
    b1_bwd_dkv_mma_kernel(const bf16* __restrict__ qkv,
                          const unsigned char* __restrict__ key_mask,
                          const float* __restrict__ stats,
                          const float* __restrict__ Dg,
                          const bf16* __restrict__ dO,
                          bf16* __restrict__ dqkv, int L, int d, int h,
                          float scale, DropStream drop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  b1_bwd_dkv_mma_tile<kDk, kAligned>(smem_raw, qkv, key_mask, stats, Dg, dO,
                                     dqkv, L, d, h, scale, drop, blockIdx.x,
                                     blockIdx.y);
}

__global__ void __launch_bounds__(kGemmThreads)
    b1_bwd_ln_qkv_mma_kernel(const bf16* __restrict__ x,
                             const bf16* __restrict__ dy,
                             const bf16* __restrict__ dqkv,
                             const float* __restrict__ ln_scale,
                             const float* __restrict__ wqkv,
                             bf16* __restrict__ dx,
                             float* __restrict__ part_ln, int M, int d,
                             bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  b1_bwd_ln_qkv_mma_tile(smem_raw, x, dy, dqkv, ln_scale, wqkv, dx, part_ln, M,
                         d, vec, blockIdx.x);
}

__global__ void __launch_bounds__(kWgThreads)
    b1_atb_mma_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Bm,
                      float* __restrict__ part, int M, int K, int N,
                      int rows_per_split, bool vec) {
  __shared__ __align__(16) unsigned char smem_raw[b1_atb_smem(4)];
  b1_atb_mma_tile(smem_raw, A, Bm, part, M, K, N, rows_per_split, vec,
                  blockIdx.x, blockIdx.y, blockIdx.z);
}

// ---------------------------------------------------------------------------
// launches

// dW = A^T . B [K, N] and db = colsum(B) [N] through `splits` partial sums
// in `part` ([splits, K * N + N] fp32 scratch), reduced in split order.
cudaError_t weight_grad_mma(const bf16* A, const bf16* B, float* part,
                            float* dw, float* db, int M, int K, int N,
                            int splits, cudaStream_t stream) {
  const bool vec = rows_aligned(K, {A}) && rows_aligned(N, {B});
  const dim3 grid((K + kTile - 1) / kTile, (N + kTile - 1) / kTile, splits);
  b1_atb_mma_kernel<<<grid, kWgThreads, 0, stream>>>(
      A, B, part, M, K, N, split_rows(M, splits), vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(part, splits, dw, K * N, db, N, stream);
}

template <int kDk, bool kAligned>
cudaError_t launch_fwd(const void* x, const void* key_mask,
                       const void* ln_scale, const void* ln_bias,
                       const void* wqkv, const void* bqkv, const void* wout,
                       const void* bout, void* qkv, void* y, void* stats,
                       int batch, int L, int d, int h, float scale,
                       DropStream drop_a, DropStream drop_r,
                       cudaStream_t stream) {
  constexpr int kRows = 16 * kOutWarps;
  const int M = batch * L, dpad = round16(d);
  const size_t smem1 = (size_t)(kGemmRows * tile_pitch(d) +
                                dpad * tile_pitch(kGemmCols)) *
                           sizeof(bf16) +
                       2 * kTile * sizeof(float);
  cudaError_t err = allow_smem(b1_ln_qkv_mma_kernel, smem1);
  if (err != cudaSuccess) return err;
  b1_ln_qkv_mma_kernel<<<dim3((M + kGemmRows - 1) / kGemmRows,
                              (3 * d + kGemmCols - 1) / kGemmCols),
                         kGemmThreads, smem1, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const float*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<bf16*>(qkv), M, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  auto kernel = b1_attn_out_mma_kernel<kDk, kAligned>;
  const size_t attn = mma_smem(d / h, kRows + 2 * kStages * kKeyTile,
                               4 * kStages * sizeof(uint32_t));
  const size_t w_slice = (size_t)dpad * tile_pitch(kOutCols) * sizeof(bf16);
  const size_t smem2 = (size_t)kRows * tile_pitch(d) * sizeof(bf16) +
                       (attn > w_slice ? attn : w_slice);
  if ((err = allow_smem(kernel, smem2)) != cudaSuccess) return err;
  kernel<<<dim3((L + kRows - 1) / kRows, batch), 32 * kOutWarps, smem2,
           stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const unsigned char*>(key_mask),
      static_cast<const bf16*>(x), static_cast<const float*>(wout),
      static_cast<const float*>(bout), static_cast<bf16*>(y),
      static_cast<float*>(stats), L, d, h, scale, drop_a, drop_r);
  return cudaGetLastError();
}

struct BwdArgs {
  const void *x, *key_mask, *ln_scale, *ln_bias, *wqkv, *wout, *qkv, *stats,
      *dy;
  void *dx, *dg, *db, *dwqkv, *dbqkv, *dwout, *dbout;
  void *da, *dO, *n_act, *ctx, *dqkv, *D, *part_qkv, *part_out, *part_ln;
  int batch, L, d, h, splits_qkv, splits_out;
  float scale;
};

template <int kDk, bool kAligned>
cudaError_t launch_bwd(const BwdArgs& a, DropStream drop_a, DropStream drop_r,
                       cudaStream_t stream) {
  constexpr int kRowsKv = 16 * kDkvWarps, kRowsQ = 16 * kDqWarps;
  const int M = a.batch * a.L, d = a.d, dk = d / a.h, G = a.batch * a.h;
  const int row_tiles = (M + kGemmRows - 1) / kGemmRows, dpad = round16(d);
  const auto* x = static_cast<const bf16*>(a.x);
  const auto* dy = static_cast<const bf16*>(a.dy);
  const auto* qkv = static_cast<const bf16*>(a.qkv);
  const auto* mask = static_cast<const unsigned char*>(a.key_mask);
  const auto* stats = static_cast<const float*>(a.stats);
  const auto* ln_scale = static_cast<const float*>(a.ln_scale);
  auto* da = static_cast<bf16*>(a.da);
  auto* dO = static_cast<bf16*>(a.dO);
  auto* n_act = static_cast<bf16*>(a.n_act);
  auto* ctx = static_cast<bf16*>(a.ctx);
  auto* dqkv = static_cast<bf16*>(a.dqkv);
  auto* D = static_cast<float*>(a.D);
  auto* part_ln = static_cast<float*>(a.part_ln);

  const size_t smem_rows =
      (size_t)(kGemmRows + kGemmCols) * tile_pitch(d) * sizeof(bf16) +
      2 * kTile * sizeof(float);
  cudaError_t err = allow_smem(b1_bwd_rows_mma_kernel, smem_rows);
  if (err != cudaSuccess) return err;
  b1_bwd_rows_mma_kernel<<<dim3(row_tiles, (d + kGemmCols - 1) / kGemmCols),
                           kGemmThreads, smem_rows, stream>>>(
      x, dy, ln_scale, static_cast<const float*>(a.ln_bias),
      static_cast<const float*>(a.wout), da, dO, n_act, M, d, drop_r);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  auto dq_kernel = b1_bwd_dq_mma_kernel<kDk, kAligned>;
  auto dkv_kernel = b1_bwd_dkv_mma_kernel<kDk, kAligned>;
  const size_t smem_q = mma_smem(dk, 2 * kRowsQ + 2 * kStages * kKeyTile,
                                 4 * kStages * sizeof(uint32_t));
  const size_t smem_kv = mma_smem(dk, 2 * kRowsKv + 2 * kStages * kQueryTile,
                                  3 * kStages * kQueryTile * sizeof(float));
  if ((err = allow_smem(dq_kernel, smem_q)) != cudaSuccess) return err;
  if ((err = allow_smem(dkv_kernel, smem_kv)) != cudaSuccess) return err;
  dq_kernel<<<dim3((a.L + kRowsQ - 1) / kRowsQ, G), 32 * kDqWarps, smem_q,
              stream>>>(qkv, mask, stats, dO, ctx, D, dqkv, a.L, d, a.h,
                        a.scale, drop_a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkv_kernel<<<dim3((a.L + kRowsKv - 1) / kRowsKv, G), 32 * kDkvWarps,
               smem_kv, stream>>>(qkv, mask, stats, D, dO, dqkv, a.L, d, a.h,
                                  a.scale, drop_a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem_ln =
      (size_t)(kGemmRows + dpad) * tile_pitch(64) * sizeof(bf16) +
      ((size_t)kGemmRows * (d + 1) + 2 * kTile) * sizeof(float);
  if ((err = allow_smem(b1_bwd_ln_qkv_mma_kernel, smem_ln)) != cudaSuccess)
    return err;
  b1_bwd_ln_qkv_mma_kernel<<<row_tiles, kGemmThreads, smem_ln, stream>>>(
      x, dy, dqkv, ln_scale, static_cast<const float*>(a.wqkv),
      static_cast<bf16*>(a.dx), part_ln, M, d, rows_aligned(3 * d, {dqkv}));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  err = weight_grad_mma(n_act, dqkv, static_cast<float*>(a.part_qkv),
                        static_cast<float*>(a.dwqkv),
                        static_cast<float*>(a.dbqkv), M, d, 3 * d,
                        a.splits_qkv, stream);
  if (err != cudaSuccess) return err;
  err = weight_grad_mma(ctx, da, static_cast<float*>(a.part_out),
                        static_cast<float*>(a.dwout),
                        static_cast<float*>(a.dbout), M, d, d, a.splits_out,
                        stream);
  if (err != cudaSuccess) return err;
  return launch_reduce(part_ln, row_tiles, static_cast<float*>(a.dg), d,
                       static_cast<float*>(a.db), d, stream);
}

cudaError_t fwd_bf16(const void* x, const void* key_mask,
                     const void* ln_scale, const void* ln_bias,
                     const void* wqkv, const void* bqkv, const void* wout,
                     const void* bout, void* qkv, void* y, void* stats,
                     int batch, int L, int d, int h, float scale,
                     DropStream drop_a, DropStream drop_r,
                     cudaStream_t stream) {
  const int dk = d / h;
  if (dk > 128) return cudaErrorInvalidValue;
  MMA_DK_DISPATCH(launch_fwd, dk, rows_aligned(dk, {qkv}), x, key_mask,
                  ln_scale, ln_bias, wqkv, bqkv, wout, bout, qkv, y, stats,
                  batch, L, d, h, scale, drop_a, drop_r, stream);
}

cudaError_t bwd_bf16(const BwdArgs& a, DropStream drop_a, DropStream drop_r,
                     cudaStream_t stream) {
  const int dk = a.d / a.h;
  if (dk > 128) return cudaErrorInvalidValue;
  MMA_DK_DISPATCH(launch_bwd, dk, rows_aligned(dk, {a.qkv, a.dO}), a, drop_a,
                  drop_r, stream);
}

}  // namespace
}  // namespace allrank

// Launches the forward's two kernels on `stream`; returns 0 or the CUDA
// error code. x, qkv ([B, L, 3d], kept for the backward) and y are bf16,
// d_k = d / h <= 128; key_mask is [B, L] bytes, non-zero at padded
// documents; parameters are fp32. stats ([B, h, L, 2] fp32: each row's
// softmax max and sum) may be null. drop_keys holds {k0, k1, threshold} of
// the probability stream, then of the output stream (ops/dropout.py);
// p_attn / p_resid are their rates (0: no dropout).
extern "C" int attention_sublayer_fwd_mma(
    const void* x, const void* key_mask, const void* ln_scale,
    const void* ln_bias, const void* wqkv, const void* bqkv, const void* wout,
    const void* bout, void* qkv, void* y, void* stats, int batch, int L, int d,
    int h, float scale, const unsigned* drop_keys, double p_attn,
    double p_resid, void* stream) {
  return allrank::fwd_bf16(x, key_mask, ln_scale, ln_bias, wqkv, bqkv, wout,
                           bout, qkv, y, stats, batch, L, d, h, scale,
                           allrank::make_stream(drop_keys, p_attn),
                           allrank::make_stream(drop_keys + 3, p_resid),
                           static_cast<cudaStream_t>(stream));
}

// Launches the backward's seven kernels and three reductions on `stream`;
// returns 0 or the CUDA error code. Arguments as attention_block.cu's
// attention_sublayer_bwd, every activation and scratch row in bf16: inputs
// x, key_mask, ln_scale, ln_bias, wqkv, wout, and qkv and stats from the
// forward, dy; outputs dx and the fp32 gradients dg, db [d], dwqkv [d, 3d],
// dbqkv [3d], dwout [d, d], dbout [d]; scratch da, dO, n_act, ctx [B*L, d],
// dqkv [B*L, 3d], fp32 D [B, h, L], part_qkv [splits_qkv, 3d*d + 3d],
// part_out [splits_out, d*d + d] and part_ln [ceil(B*L / 64), 2d].
extern "C" int attention_sublayer_bwd_mma(
    const void* x, const void* key_mask, const void* ln_scale,
    const void* ln_bias, const void* wqkv, const void* wout, const void* qkv,
    const void* stats, const void* dy, void* dx, void* dg, void* db,
    void* dwqkv, void* dbqkv, void* dwout, void* dbout, void* da, void* dO,
    void* n_act, void* ctx, void* dqkv, void* D, void* part_qkv,
    void* part_out, void* part_ln, int batch, int L, int d, int h,
    int splits_qkv, int splits_out, float scale, const unsigned* drop_keys,
    double p_attn, double p_resid, void* stream) {
  const allrank::BwdArgs a{x,     key_mask, ln_scale, ln_bias, wqkv,  wout,
                           qkv,   stats,    dy,       dx,      dg,    db,
                           dwqkv, dbqkv,    dwout,    dbout,   da,    dO,
                           n_act, ctx,      dqkv,     D,       part_qkv,
                           part_out, part_ln, batch,  L,       d,     h,
                           splits_qkv, splits_out, scale};
  return allrank::bwd_bf16(a, allrank::make_stream(drop_keys, p_attn),
                           allrank::make_stream(drop_keys + 3, p_resid),
                           static_cast<cudaStream_t>(stream));
}
