// Attention sublayer forward and backward for Hopper (sm_90a), fp32 or bf16
// activations:
//   y = x + drop_r(Wout . MHA_drop_a(LN(x) . Wqkv + bqkv) + bout)
// with the unbiased-std LayerNorm, scores scaled by 1/sqrt(d_k), padded keys
// filled with -1e9 before a max-subtracted softmax, dropout on the attention
// probabilities and on the sublayer output (csrc/dropout.cuh), and the
// residual added in fp32.
//
// Replaces the TPU kernel `attention_sublayer` of the JAX package's
// ops/attention_block.py: forward pallas_call at line 343 (math in
// attn_sublayer_fwd_vmem, lines 122-144), backward pallas_call at line 375
// (math in attn_sublayer_bwd_vmem, lines 159-254).
//
// What bounds it: the products. At the flagship shape (B=64, L=240, d=128,
// h=4) the forward does about 3.9 GFLOP and the backward about 9.7 GFLOP
// (each product counted once) on some 16 MB (forward) and 48 MB (backward)
// of fp32 tensors in and out, 200 or more FLOP per byte, so on this card
// both are bound by operations, not by memory.
//
// What the design does about it, and about the TPU kernel's assumptions:
//  * The TPU kernel keeps whole slates in many MB of VMEM. A block here has
//    227 KB, less than one head's [240, 240] fp32 probability tile. So the
//    forward is two kernels: ln_qkv (LN + QKV projection over 64-row tiles,
//    writing qkv [B, L, 3d] in x's dtype, the one intermediate in device
//    memory) and attn_out (one block per slate and 64-query tile). attn_out
//    walks the keys in tiles of 64 and never holds more than a 64 x 64 score
//    tile: a first pass takes the running row max and sum, a second
//    recomputes the scores, forms the probabilities exactly as the TPU kernel
//    does (exp(s - max) / sum, dropped, rounded to x's dtype) and accumulates
//    P.V. In training the forward also stores each row's max and sum
//    [B, h, L, 2], and qkv is kept for the backward.
//  * The out-projection sums over heads. attn_out loops over the heads and
//    keeps ctx for all of them in shared memory, then multiplies by Wout in
//    the same block: no atomics, no second pass over device memory.
//  * The backward never holds [L, L] either. It recomputes P tile by tile
//    from the saved qkv and row statistics (bitwise the forward's P: the
//    same products in the same order) and replays both dropout masks from
//    their (seed, stream, index) keys. Seven kernels: bwd_rows (da = drop_r(dy)
//    and dO = da . Wout^T per 64-row tile, and LN(x)); bwd_dq (per slate,
//    head and 64-query tile: ctx for dWout, D = sum_j dPd * P as the TPU
//    kernel takes it, then dQ); bwd_dkv (per slate, head and 64-key tile,
//    looping over query tiles: dK and dV); bwd_ln_qkv (dn = dqkv . Wqkv^T and
//    the LN backward per 64-row tile); the weight gradients dWqkv, dWout and
//    their biases as split A^T . B products, and the LN parameter gradients,
//    each summed over the B * L rows in a fixed order (backward.cuh).
//  * L = 240 is not a multiple of 64, and d_k of 72 or 96 not a power of two:
//    every staged load masks its edge with zeros, keys past L get -inf
//    (weight 0) and padded keys -1e9, so a fully padded slate gets a uniform
//    softmax, never NaN; its dS is zero at every padded key.
//  * Products run as fp32 FMAs on 64 x 64 register tiles (common.cuh); the
//    bf16 rounding points are the TPU kernel's: LN output, qkv,
//    probabilities, ctx, and in the backward da, dO, dS and dqkv. The
//    tensor-core routes (attention_block_mma.cu in bf16,
//    attention_block_tf32x3.cu in fp32) take heads up to 128 wide; these
//    kernels take wider heads, where B10 (encoder_block.cuh) runs their
//    tile bodies too.
#include "backward.cuh"
#include "common.cuh"
#include "dropout.cuh"
#include "sublayer_tiles.cuh"

namespace allrank {
namespace {

// The kernels are thin wrappers over the tile bodies of sublayer_tiles.cuh,
// which the whole-encoder kernel (encoder_block.cuh) shares at d_k > 128.

template <class T>
__global__ void __launch_bounds__(kThreads)
    ln_qkv_kernel(const T* __restrict__ x, const float* __restrict__ ln_scale,
                  const float* __restrict__ ln_bias,
                  const float* __restrict__ wqkv,
                  const float* __restrict__ bqkv, T* __restrict__ qkv, int M,
                  int d) {
  extern __shared__ float smem[];
  ln_qkv_tile(smem, x, ln_scale, ln_bias, wqkv, bqkv, qkv, M, d, blockIdx.x,
              blockIdx.y);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
    attn_out_kernel(const T* __restrict__ qkv,
                    const unsigned char* __restrict__ key_mask,
                    const T* __restrict__ x, const float* __restrict__ wout,
                    const float* __restrict__ bout, T* __restrict__ y,
                    float* __restrict__ stats, int L, int d, int h,
                    float scale, DropStream drop_a, DropStream drop_r) {
  extern __shared__ float smem[];
  attn_out_tile(smem, qkv, key_mask, x, wout, bout, y, stats, L, d, h, scale,
                drop_a, drop_r, blockIdx.x, blockIdx.y);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
    bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                    const float* __restrict__ ln_scale,
                    const float* __restrict__ ln_bias,
                    const float* __restrict__ wout, T* __restrict__ da,
                    T* __restrict__ dO, T* __restrict__ n_act, int M, int d,
                    DropStream drop_r) {
  __shared__ float smem[bwd_rows_smem_floats()];
  bwd_rows_tile(smem, x, dy, ln_scale, ln_bias, wout, da, dO, n_act, M, d,
                drop_r, blockIdx.x, blockIdx.y);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
    bwd_dq_kernel(const T* __restrict__ qkv,
                  const unsigned char* __restrict__ key_mask,
                  const float* __restrict__ stats, const T* __restrict__ dO,
                  T* __restrict__ ctx, float* __restrict__ Dg,
                  T* __restrict__ dqkv, int L, int d, int h, float scale,
                  DropStream drop_a) {
  __shared__ float smem[bwd_attn_smem_floats()];
  bwd_dq_tile(smem, qkv, key_mask, stats, dO, ctx, Dg, dqkv, L, d, h, scale,
              drop_a, blockIdx.x, blockIdx.y, blockIdx.z);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
    bwd_dkv_kernel(const T* __restrict__ qkv,
                   const unsigned char* __restrict__ key_mask,
                   const float* __restrict__ stats, const float* __restrict__ Dg,
                   const T* __restrict__ dO, T* __restrict__ dqkv, int L, int d,
                   int h, float scale, DropStream drop_a) {
  __shared__ float smem[bwd_attn_smem_floats()];
  bwd_dkv_tile(smem, qkv, key_mask, stats, Dg, dO, dqkv, L, d, h, scale,
               drop_a, blockIdx.x, blockIdx.y, blockIdx.z);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
    bwd_ln_qkv_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const T* __restrict__ dqkv,
                      const float* __restrict__ ln_scale,
                      const float* __restrict__ wqkv, T* __restrict__ dx,
                      float* __restrict__ part_ln, int M, int d) {
  extern __shared__ float smem[];
  bwd_ln_qkv_tile(smem, x, dy, dqkv, ln_scale, wqkv, dx, part_ln, M, d,
                  blockIdx.x);
}

// ---------------------------------------------------------------------------
// launches

template <class T>
int launch_fwd(const void* x, const void* key_mask, const void* ln_scale,
               const void* ln_bias, const void* wqkv, const void* bqkv,
               const void* wout, const void* bout, void* qkv, void* y,
               void* stats, int batch, int L, int d, int h, float scale,
               DropStream drop_a, DropStream drop_r, cudaStream_t stream) {
  const int M = batch * L;
  const size_t smem1 = ln_qkv_smem_floats() * sizeof(float);
  const dim3 grid1((M + kTile - 1) / kTile, (3 * d + kTile - 1) / kTile);
  ln_qkv_kernel<T><<<grid1, kThreads, smem1, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const float*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<T*>(qkv), M, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem2 = attn_out_smem_floats(d) * sizeof(float);
  err = cudaFuncSetAttribute(attn_out_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return err;
  const dim3 grid2((L + kTile - 1) / kTile, batch);
  attn_out_kernel<T><<<grid2, kThreads, smem2, stream>>>(
      static_cast<const T*>(qkv), static_cast<const unsigned char*>(key_mask),
      static_cast<const T*>(x), static_cast<const float*>(wout),
      static_cast<const float*>(bout), static_cast<T*>(y),
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

template <class T>
int launch_bwd(const BwdArgs& a, DropStream drop_a, DropStream drop_r,
               cudaStream_t stream) {
  const int M = a.batch * a.L, d = a.d, dk = d / a.h;
  const int row_tiles = (M + kTile - 1) / kTile;
  const T* x = static_cast<const T*>(a.x);
  const T* qkv = static_cast<const T*>(a.qkv);
  const auto* mask = static_cast<const unsigned char*>(a.key_mask);
  const auto* stats = static_cast<const float*>(a.stats);
  T* da = static_cast<T*>(a.da);
  T* dO = static_cast<T*>(a.dO);
  T* n_act = static_cast<T*>(a.n_act);
  T* ctx = static_cast<T*>(a.ctx);
  T* dqkv = static_cast<T*>(a.dqkv);
  float* D = static_cast<float*>(a.D);

  bwd_rows_kernel<T><<<dim3(row_tiles, (d + kTile - 1) / kTile), kThreads, 0,
                       stream>>>(
      x, static_cast<const T*>(a.dy), static_cast<const float*>(a.ln_scale),
      static_cast<const float*>(a.ln_bias), static_cast<const float*>(a.wout),
      da, dO, n_act, M, d, drop_r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid_h((a.L + kTile - 1) / kTile, a.batch * a.h,
                    (dk + kTile - 1) / kTile);
  bwd_dq_kernel<T><<<grid_h, kThreads, 0, stream>>>(
      qkv, mask, stats, dO, ctx, D, dqkv, a.L, d, a.h, a.scale, drop_a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_dkv_kernel<T><<<grid_h, kThreads, 0, stream>>>(
      qkv, mask, stats, D, dO, dqkv, a.L, d, a.h, a.scale, drop_a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem4 = bwd_ln_qkv_smem_floats(d) * sizeof(float);
  err = cudaFuncSetAttribute(bwd_ln_qkv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem4));
  if (err != cudaSuccess) return err;
  float* part_ln = static_cast<float*>(a.part_ln);
  bwd_ln_qkv_kernel<T><<<row_tiles, kThreads, smem4, stream>>>(
      x, static_cast<const T*>(a.dy), dqkv,
      static_cast<const float*>(a.ln_scale), static_cast<const float*>(a.wqkv),
      static_cast<T*>(a.dx), part_ln, M, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  err = launch_weight_grad<T>(n_act, dqkv, static_cast<float*>(a.part_qkv),
                              static_cast<float*>(a.dwqkv),
                              static_cast<float*>(a.dbqkv), M, d, 3 * d,
                              a.splits_qkv, stream);
  if (err != cudaSuccess) return err;
  err = launch_weight_grad<T>(ctx, da, static_cast<float*>(a.part_out),
                              static_cast<float*>(a.dwout),
                              static_cast<float*>(a.dbout), M, d, d,
                              a.splits_out, stream);
  if (err != cudaSuccess) return err;
  return launch_reduce(part_ln, row_tiles, static_cast<float*>(a.dg), d,
                       static_cast<float*>(a.db), d, stream);
}

}  // namespace
}  // namespace allrank

// Launches the forward's two kernels on `stream`; returns 0 or the CUDA
// error code. x, qkv ([B, L, 3d], kept for the backward) and y are in x's
// dtype (bf16 if is_bf16, else fp32); key_mask is [B, L] bytes, non-zero at
// padded documents; parameters are fp32. stats ([B, h, L, 2] fp32: each
// row's softmax max and sum) may be null. drop_keys holds {k0, k1,
// threshold} of the probability stream, then of the output stream
// (ops/dropout.py); p_attn / p_resid are their rates (0: no dropout).
extern "C" int attention_sublayer_fwd(const void* x, const void* key_mask,
                                      const void* ln_scale, const void* ln_bias,
                                      const void* wqkv, const void* bqkv,
                                      const void* wout, const void* bout,
                                      void* qkv, void* y, void* stats,
                                      int batch, int L, int d, int h,
                                      float scale, int is_bf16,
                                      const unsigned* drop_keys, double p_attn,
                                      double p_resid, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto da = allrank::make_stream(drop_keys, p_attn);
  const auto dr = allrank::make_stream(drop_keys + 3, p_resid);
  if (is_bf16)
    return allrank::launch_fwd<__nv_bfloat16>(x, key_mask, ln_scale, ln_bias,
                                              wqkv, bqkv, wout, bout, qkv, y,
                                              stats, batch, L, d, h, scale, da,
                                              dr, s);
  return allrank::launch_fwd<float>(x, key_mask, ln_scale, ln_bias, wqkv, bqkv,
                                    wout, bout, qkv, y, stats, batch, L, d, h,
                                    scale, da, dr, s);
}

// Launches the backward's nine kernels on `stream`; returns 0 or the CUDA
// error code. Inputs: x, key_mask, ln_scale, ln_bias, wqkv, wout, and qkv
// and stats from the forward, dy in x's dtype. Outputs: dx (x's dtype) and
// the fp32 gradients dg, db [d], dwqkv [d, 3d], dbqkv [3d], dwout [d, d],
// dbout [d]. Scratch, all from the caller: da, dO, n_act, ctx [B*L, d] and
// dqkv [B*L, 3d] in x's dtype; fp32 D [B, h, L], part_qkv
// [splits_qkv, 3d*d + 3d], part_out [splits_out, d*d + d] and part_ln
// [ceil(B*L / 64), 2d].
extern "C" int attention_sublayer_bwd(
    const void* x, const void* key_mask, const void* ln_scale,
    const void* ln_bias, const void* wqkv, const void* wout, const void* qkv,
    const void* stats, const void* dy, void* dx, void* dg, void* db,
    void* dwqkv, void* dbqkv, void* dwout, void* dbout, void* da, void* dO,
    void* n_act, void* ctx, void* dqkv, void* D, void* part_qkv,
    void* part_out, void* part_ln, int batch, int L, int d, int h,
    int splits_qkv, int splits_out, float scale, int is_bf16,
    const unsigned* drop_keys, double p_attn, double p_resid, void* stream) {
  const allrank::BwdArgs a{x,     key_mask, ln_scale, ln_bias, wqkv,  wout,
                           qkv,   stats,    dy,       dx,      dg,    db,
                           dwqkv, dbqkv,    dwout,    dbout,   da,    dO,
                           n_act, ctx,      dqkv,     D,       part_qkv,
                           part_out, part_ln, batch,  L,       d,     h,
                           splits_qkv, splits_out, scale};
  auto s = static_cast<cudaStream_t>(stream);
  const auto drop_a = allrank::make_stream(drop_keys, p_attn);
  const auto drop_r = allrank::make_stream(drop_keys + 3, p_resid);
  if (is_bf16)
    return allrank::launch_bwd<__nv_bfloat16>(a, drop_a, drop_r, s);
  return allrank::launch_bwd<float>(a, drop_a, drop_r, s);
}
