// B2, the FFN sublayer, forward and backward in bf16 on Hopper's tensor
// cores (sm_90a):
//   y = x + drop_r(drop_h(relu(LN(x) . W1 + b1)) . W2 + b2)
// with the unbiased-std LayerNorm (eps added to the std, the variance
// floored at 1e-24), dropout on the hidden activation (index row * d_ff +
// col) and on the sublayer output (row * d + col) from csrc/dropout.cuh,
// and the residual added in fp32. The bf16 rounding points are the TPU
// kernel's: the LN output and the dropped hidden activation forward; dout =
// drop_r(dy) and the gated dh backward. Weights are rounded to bf16 as the
// TPU kernel casts them, by one small launch a call.
//
// Replaces the TPU kernel `ffn_sublayer` of the JAX package's
// ops/ffn_block.py for bf16 activations: forward pallas_call at line 204
// (ffn_sublayer_fwd_vmem, lines 40-63), backward at line 233
// (ffn_sublayer_bwd_vmem, lines 76-132). fp32 takes ffn_block_tf32x3.cu
// (3xTF32 on the tensor cores); the route is chosen in ops/ffn_block.py
// from dtype, d and d_ff alone.
//
// What bounds it: operations. At the flagship shape (B=64, L=240, d=128,
// d_ff=512) the forward does 4.0 GFLOP (LN(x) . W1, hidden . W2) and the
// backward 10.1 GFLOP (pre and dh recomputed, dn, dW1, dW2) on some 8 and
// 12 MB of bf16 activations: 0.004 and 0.010 ms at the tensor cores' 989
// TFLOP/s. The SIMT kernels ran every product as fp32 FMAs at 1-2 % of
// that bound.
//
// What the design does about it:
//  * Every product is an mma.sync.m16n8k16 bf16 x bf16 -> fp32 on the
//    product tile of mma_tile.cuh. Nothing goes to a library.
//  * Weights: b2_round_weights_kernel rounds W1 and W2 to bf16 once a call
//    into scratch padded with zeros to whole 16-row and 64-column steps
//    (the same round-to-nearest as a load-time rounding, so the same bits),
//    and the row kernels stream each 64-unit chunk pair, W1[:, c] and
//    W2[c, :], through a two-slot cp.async ring while the tensor cores work
//    on the last one. In bf16 at the flagship W1 and W2 take 256 KB: they
//    do not fit in shared memory together, a chunk pair does. (Rounding
//    each chunk as it is staged, stage_weight's way, took 1.7x the device
//    time forward and 1.35x backward in an A/B at the flagship: PERF.md.)
//  * Forward: one kernel, a block of eight warps: 128 rows, 16 a warp, at
//    d <= 128; 64 at d > 128, where two warps share a row group and split
//    the output columns so that a warp's accumulator stays at 16 x 128
//    (128 rows took 3-4 % less device time than 64 at the flagship). The
//    block takes the rows' statistics in fp32 and stages the bf16 LN output
//    as the A operand; per chunk H_c = LN(x) . W1[:, c] + b1, relu, the hidden
//    dropout (keep bit hashed once an element) and the bf16 rounding happen
//    in registers, and acc_to_a turns H_c into the A fragments of acc +=
//    H_c . W2[c, :], as B4 keeps P for P . V: the hidden state never
//    touches shared or device memory. Epilogue: + b2, the output dropout,
//    + x in fp32, rounded.
//  * Backward: a row kernel, in the forward's blocks, recomputes LN (the
//    bf16 n written once as [M, d] for dW1) and dout = round(drop_r(dy))
//    (written for dW2), then per half chunk of 32 hidden units pre = n .
//    W1c + b1, the gate and the hidden mask, hidden =
//    round(drop(relu(pre))) and dh = round((dout . W2c^T) keep / (1 - p)
//    gate) (both written as bf16 [M, d_ff]: the TPU kernel's rounding
//    points, so storing them is exact), and dn += dh . W1c^T through
//    acc_to_a again; backward.cuh's fp32 LN backward gives dx and the
//    tile's dg / db partials. dW1 = n^T . dh and dW2 = hidden^T .
//    dout, with db1 and db2 as column sums, are split A^T . B products on
//    the tensor cores (A read transposed by ldmatrix .trans, a two-slot
//    cp.async ring), their partials reduced in split order. No atomics: two
//    backwards give the same bits.
//  * Ragged shapes: d padded with zeros to whole 16-column steps, d_ff to
//    whole 64-unit chunks (the scratch weights' zeros make the padded units
//    weigh nothing), any number of rows; x and dy are read element by
//    element, so they may start anywhere; every scratch row the kernels
//    stage with 16-byte copies is padded to a multiple of 16 bytes.
#include "b2_mma_tiles.cuh"

namespace allrank {
namespace {

__global__ void __launch_bounds__(256)
    b2_round_weights_kernel(const float* __restrict__ w1,
                            const float* __restrict__ w2,
                            bf16* __restrict__ w1b,
                            bf16* __restrict__ w2b, int d, int d_ff, int dpad,
                            int ffp) {
  b2_round_weights_range(w1, w2, w1b, w2b, d, d_ff, dpad, ffp,
                         (size_t)blockIdx.x * blockDim.x + threadIdx.x,
                         (size_t)gridDim.x * blockDim.x);
}

template <int kCs>
__global__ void __launch_bounds__(kBlockThreads)
    b2_fwd_mma_kernel(const bf16* __restrict__ x,
                      const float* __restrict__ ln_scale,
                      const float* __restrict__ ln_bias,
                      const bf16* __restrict__ w1b,
                      const float* __restrict__ b1,
                      const bf16* __restrict__ w2b,
                      const float* __restrict__ b2, bf16* __restrict__ y, int M,
                      int d, int d_ff, DropStream drop_h, DropStream drop_r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  b2_fwd_mma_tile<kCs>(smem_raw, x, ln_scale, ln_bias, w1b, b1, w2b, b2, y, M,
                       d, d_ff, drop_h, drop_r, blockIdx.x);
}

template <int kCs>
__global__ void __launch_bounds__(kBlockThreads)
    b2_bwd_rows_mma_kernel(const bf16* __restrict__ x,
                           const float* __restrict__ ln_scale,
                           const float* __restrict__ ln_bias,
                           const bf16* __restrict__ w1b,
                           const float* __restrict__ b1,
                           const bf16* __restrict__ w2b,
                           const bf16* __restrict__ dy, bf16* __restrict__ dx,
                           bf16* __restrict__ n_act, bf16* __restrict__ dout,
                           bf16* __restrict__ hidden, bf16* __restrict__ dh,
                           float* __restrict__ part_ln, int M, int d, int d_ff,
                           DropStream drop_h, DropStream drop_r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  b2_bwd_rows_mma_tile<kCs>(smem_raw, x, ln_scale, ln_bias, w1b, b1, w2b, dy,
                            dx, n_act, dout, hidden, dh, part_ln, M, d, d_ff,
                            drop_h, drop_r, blockIdx.x);
}

__global__ void __launch_bounds__(kAtbThreads)
    b2_atb_mma_kernel(const bf16* __restrict__ A, int lda,
                      const bf16* __restrict__ Bm, int ldb,
                      float* __restrict__ part, int M, int K, int N,
                      int rows_per_split) {
  __shared__ __align__(16) unsigned char smem_raw[b2_atb_smem(4)];
  b2_atb_mma_tile(smem_raw, A, lda, Bm, ldb, part, M, K, N, rows_per_split,
                  blockIdx.x, blockIdx.y, blockIdx.z);
}

// ---------------------------------------------------------------------------
// launches

cudaError_t round_weights(const void* w1, const void* w2, bf16* w1b, bf16* w2b,
                          int d, int d_ff, cudaStream_t stream) {
  const int dpad = round16(d), ffp = ff_pad(d_ff);
  const size_t n = 2 * (size_t)dpad * ffp;
  const size_t blocks = (n + 255) / 256;
  const int grid = static_cast<int>(blocks < 1024 ? blocks : 1024);
  b2_round_weights_kernel<<<grid, 256, 0, stream>>>(
      static_cast<const float*>(w1), static_cast<const float*>(w2), w1b, w2b,
      d, d_ff, dpad, ffp);
  return cudaGetLastError();
}

// dW = A^T . B [K, N] and db = colsum(B) [N] through `splits` partial sums
// in `part` ([splits, K * N + N] fp32 scratch), reduced in split order.
cudaError_t weight_grad(const bf16* A, int lda, const bf16* B, int ldb,
                        float* part, float* dw, float* db, int M, int K, int N,
                        int splits, cudaStream_t stream) {
  const dim3 grid((K + kTile - 1) / kTile, (N + kTile - 1) / kTile, splits);
  b2_atb_mma_kernel<<<grid, kAtbThreads, 0, stream>>>(
      A, lda, B, ldb, part, M, K, N, split_rows(M, splits));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(part, splits, dw, K * N, db, N, stream);
}

template <int kCs>
cudaError_t launch_fwd(const void* x, const void* ln_scale, const void* ln_bias,
                       const void* b1, const void* b2, void* y, const bf16* w1b,
                       const bf16* w2b, int M, int d, int d_ff,
                       DropStream drop_h, DropStream drop_r,
                       cudaStream_t stream) {
  auto kernel = b2_fwd_mma_kernel<kCs>;
  constexpr int rows = block_rows(kCs);
  const size_t smem = row_smem(round16(d), 1, rows);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(M + rows - 1) / rows, kBlockThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), w1b, static_cast<const float*>(b1),
      w2b, static_cast<const float*>(b2), static_cast<bf16*>(y), M, d, d_ff,
      drop_h, drop_r);
  return cudaGetLastError();
}

struct BwdArgs {
  const void *x, *ln_scale, *ln_bias, *w1, *b1, *w2, *dy;
  void *dx, *dg, *db, *dw1, *db1, *dw2, *db2;
  void *n_act, *dout, *hidden, *dh, *part_1, *part_2, *part_ln, *w1b, *w2b;
  int M, d, d_ff, splits_1, splits_2;
};

template <int kCs>
cudaError_t launch_bwd(const BwdArgs& a, DropStream drop_h, DropStream drop_r,
                       cudaStream_t stream) {
  constexpr int rows = block_rows(kCs);
  const int dpad = round16(a.d), ffp = ff_pad(a.d_ff);
  const int tiles = (a.M + rows - 1) / rows;
  auto* w1b = static_cast<bf16*>(a.w1b);
  auto* w2b = static_cast<bf16*>(a.w2b);
  auto* n_act = static_cast<bf16*>(a.n_act);
  auto* dout = static_cast<bf16*>(a.dout);
  auto* hidden = static_cast<bf16*>(a.hidden);
  auto* dh = static_cast<bf16*>(a.dh);
  auto* part_ln = static_cast<float*>(a.part_ln);
  cudaError_t err = round_weights(a.w1, a.w2, w1b, w2b, a.d, a.d_ff, stream);
  if (err != cudaSuccess) return err;
  auto kernel = b2_bwd_rows_mma_kernel<kCs>;
  const size_t smem = row_smem(dpad, 2, rows);
  if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
  kernel<<<tiles, kBlockThreads, smem, stream>>>(
      static_cast<const bf16*>(a.x), static_cast<const float*>(a.ln_scale),
      static_cast<const float*>(a.ln_bias), w1b,
      static_cast<const float*>(a.b1), w2b, static_cast<const bf16*>(a.dy),
      static_cast<bf16*>(a.dx), n_act, dout, hidden, dh, part_ln, a.M, a.d,
      a.d_ff, drop_h, drop_r);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = weight_grad(n_act, dpad, dh, ffp, static_cast<float*>(a.part_1),
                    static_cast<float*>(a.dw1), static_cast<float*>(a.db1),
                    a.M, a.d, a.d_ff, a.splits_1, stream);
  if (err != cudaSuccess) return err;
  err = weight_grad(hidden, ffp, dout, dpad, static_cast<float*>(a.part_2),
                    static_cast<float*>(a.dw2), static_cast<float*>(a.db2),
                    a.M, a.d_ff, a.d, a.splits_2, stream);
  if (err != cudaSuccess) return err;
  return launch_reduce(part_ln, tiles, static_cast<float*>(a.dg), a.d,
                       static_cast<float*>(a.db), a.d, stream);
}

}  // namespace
}  // namespace allrank

// Launches the forward's two kernels (the weights' rounding, then the row
// kernel) on `stream`; returns 0 or the CUDA error code. x and y are bf16
// [M, d], M = B * L, d <= 256; parameters are fp32, w1 [d, d_ff], w2
// [d_ff, d], d_ff <= 1024; scratch w1b [round16(d), round64(d_ff)] and w2b
// [round64(d_ff), round16(d)] bf16. drop_keys holds {k0, k1, threshold} of
// the hidden stream, then of the output stream (ops/dropout.py); p_hidden /
// p_resid are their rates (0: no dropout).
extern "C" int ffn_sublayer_fwd_mma(const void* x, const void* ln_scale,
                                    const void* ln_bias, const void* w1,
                                    const void* b1, const void* w2,
                                    const void* b2, void* y, void* w1b,
                                    void* w2b, int M, int d, int d_ff,
                                    const unsigned* drop_keys, double p_hidden,
                                    double p_resid, void* stream) {
  using namespace allrank;
  auto s = static_cast<cudaStream_t>(stream);
  if (d < 1 || d > 2 * kColsWarp) return cudaErrorInvalidValue;
  auto* w1r = static_cast<bf16*>(w1b);
  auto* w2r = static_cast<bf16*>(w2b);
  cudaError_t err = round_weights(w1, w2, w1r, w2r, d, d_ff, s);
  if (err != cudaSuccess) return err;
  const auto dh = make_stream(drop_keys, p_hidden);
  const auto dr = make_stream(drop_keys + 3, p_resid);
  if (round16(d) > kColsWarp)
    return launch_fwd<2>(x, ln_scale, ln_bias, b1, b2, y, w1r, w2r, M, d, d_ff,
                         dh, dr, s);
  return launch_fwd<1>(x, ln_scale, ln_bias, b1, b2, y, w1r, w2r, M, d, d_ff,
                       dh, dr, s);
}

// Launches the backward's six kernels and three reductions on `stream`;
// returns 0 or the CUDA error code. Inputs x, parameters and dy (bf16
// [M, d]); outputs dx and the fp32 gradients dg, db [d], dw1 [d, d_ff], db1
// [d_ff], dw2 [d_ff, d], db2 [d]. Scratch from the caller, with dpad =
// round16(d) and ffp = round64(d_ff): n_act and dout [M, dpad], hidden and
// dh [M, ffp], w1b [dpad, ffp] and w2b [ffp, dpad] bf16; fp32 part_1
// [splits_1, d*d_ff + d_ff], part_2 [splits_2, d_ff*d + d], part_ln
// [ceil(M / 64), 2d].
extern "C" int ffn_sublayer_bwd_mma(
    const void* x, const void* ln_scale, const void* ln_bias, const void* w1,
    const void* b1, const void* w2, const void* dy, void* dx, void* dg,
    void* db, void* dw1, void* db1, void* dw2, void* db2, void* n_act,
    void* dout, void* hidden, void* dh, void* part_1, void* part_2,
    void* part_ln, void* w1b, void* w2b, int M, int d, int d_ff,
    int splits_1, int splits_2, const unsigned* drop_keys, double p_hidden,
    double p_resid, void* stream) {
  using namespace allrank;
  if (d < 1 || d > 2 * kColsWarp) return cudaErrorInvalidValue;
  const BwdArgs a{x,      ln_scale, ln_bias, w1,     b1,      w2,     dy,
                  dx,     dg,       db,      dw1,    db1,     dw2,    db2,
                  n_act,  dout,     hidden,  dh,     part_1,  part_2, part_ln,
                  w1b,    w2b,      M,       d,      d_ff,    splits_1,
                  splits_2};
  auto s = static_cast<cudaStream_t>(stream);
  const auto drop_h = make_stream(drop_keys, p_hidden);
  const auto drop_r = make_stream(drop_keys + 3, p_resid);
  if (round16(d) > kColsWarp) return launch_bwd<2>(a, drop_h, drop_r, s);
  return launch_bwd<1>(a, drop_h, drop_r, s);
}
