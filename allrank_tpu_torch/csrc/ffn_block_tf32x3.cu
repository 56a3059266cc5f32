// B2, the FFN sublayer, forward and backward in fp32 on Hopper's tensor
// cores (sm_90a), every product a 3xTF32 split product:
//   y = x + drop_r(drop_h(relu(LN(x) . W1 + b1)) . W2 + b2)
// with the unbiased-std LayerNorm (eps added to the std, the variance
// floored at 1e-24), dropout on the hidden activation (index row * d_ff +
// col) and on the sublayer output (row * d + col) from csrc/dropout.cuh,
// and the residual added in fp32.
//
// Replaces the TPU kernel `ffn_sublayer` of the JAX package's
// ops/ffn_block.py for fp32 activations: forward pallas_call at line 204
// (ffn_sublayer_fwd_vmem, lines 40-63), backward at line 233
// (ffn_sublayer_bwd_vmem, lines 76-132). bf16 takes ffn_block_mma.cu; the
// route is chosen in ops/ffn_block.py from dtype, d and d_ff alone.
//
// What bounds it: operations. At the flagship shape (B=64, L=240, d=128,
// d_ff=512) the forward does 4.0 GFLOP (LN(x) . W1, hidden . W2) and the
// backward 10.1 GFLOP (pre and dh recomputed, dn, dW1, dW2): 0.024 and
// 0.061 ms at a third of the card's 495 TFLOP/s TF32 rate, three TF32
// products an fp32 one. The SIMT kernels ran every product as fp32 FMAs.
//
// What the design does about it:
//  * Every product is three TF32 mma.sync.m16n8k8 products, lo.hi + hi.lo
//    + hi.hi, small terms first, on mma_tile_f32.cuh's product tile;
//    weights are split as they are read (no rounding launch), and every
//    64-deep step, every hidden chunk, sums from zero and joins its running
//    sum in fp32. LN and the residual stay in fp32. Nothing goes to a
//    library.
//  * Forward: one kernel, a block of eight warps; at d <= 128 128 rows, 16
//    a warp, and 64-unit hidden chunks; at d > 128 64 rows, two warps
//    sharing a row group and splitting the output columns (a warp's
//    accumulator stays at 16 x 128), and 32-unit chunks, so that fp32's
//    operands fit in shared memory. The block takes the rows' statistics in
//    fp32 and stages the LN output as the A operand; each chunk pair,
//    W1[:, c] and W2[c, :], streams through a two-slot cp.async ring while
//    the tensor cores work on the last one. Per chunk H_c = LN(x) . W1[:, c]
//    + b1, relu and the hidden dropout happen in registers, and H_c's C
//    tiles become the A fragments of H_c . W2[c, :] through B4's
//    permutation (slot t is unit 2t, slot t + 4 unit 2t + 1, W2's rows read
//    in that order), split into hi and lo there: the hidden state never
//    touches shared or device memory. Epilogue: + b2, the output dropout, +
//    x in fp32.
//  * Backward: a row kernel (128 rows and 32-unit chunks at d <= 128, 64
//    rows and 16-unit chunks above) writes n = LN(x) and dout =
//    drop_r(dy) [M, d], then per chunk pre = n . W1c + b1, the gate and the
//    hidden mask, hidden = drop(relu(pre)) and dh = (dout . W2c^T) keep /
//    (1 - p) gate (both written [M, d_ff] for the weight gradients), and dn
//    += dh . W1c^T through the same permutation, W1c's units read in pairs;
//    backward.cuh's fp32 LN backward gives dx and the tile's dg / db
//    partials. dW1 = n^T . dh and dW2 = hidden^T . dout, with db1 and db2
//    as column sums, are split A^T . B products (A read with 32-bit loads),
//    their partials reduced in split order. No atomics: two backwards give
//    the same bits.
//  * Ragged shapes: d padded with zeros to whole 8 (K) or 16 (N) columns,
//    d_ff to whole chunks (zero weights make the padded units weigh
//    nothing), any number of rows; rows off a 16-byte boundary are staged
//    element by element.
#include "b2_tf32x3_tiles.cuh"

namespace allrank {
namespace {

template <int kCs, int kUnits>
__global__ void __launch_bounds__(kBlockThreads)
    b2_fwd_tf32x3_kernel(const float* __restrict__ x,
                         const float* __restrict__ ln_scale,
                         const float* __restrict__ ln_bias,
                         const float* __restrict__ w1,
                         const float* __restrict__ b1,
                         const float* __restrict__ w2,
                         const float* __restrict__ b2, float* __restrict__ y,
                         int M, int d, int d_ff, bool vec1, bool vec2,
                         DropStream drop_h, DropStream drop_r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  b2_fwd_tf32x3_tile<kCs, kUnits>(smem_raw, x, ln_scale, ln_bias, w1, b1, w2,
                                  b2, y, M, d, d_ff, vec1, vec2, drop_h, drop_r,
                                  blockIdx.x);
}

template <int kCs, int kUnits>
__global__ void __launch_bounds__(kBlockThreads)
    b2_bwd_rows_tf32x3_kernel(const float* __restrict__ x,
                              const float* __restrict__ ln_scale,
                              const float* __restrict__ ln_bias,
                              const float* __restrict__ w1,
                              const float* __restrict__ b1,
                              const float* __restrict__ w2,
                              const float* __restrict__ dy,
                              float* __restrict__ dx,
                              float* __restrict__ n_act,
                              float* __restrict__ dout,
                              float* __restrict__ hidden,
                              float* __restrict__ dh,
                              float* __restrict__ part_ln, int M, int d,
                              int d_ff, bool vec1, bool vec2,
                              DropStream drop_h, DropStream drop_r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  b2_bwd_rows_tf32x3_tile<kCs, kUnits>(smem_raw, x, ln_scale, ln_bias, w1, b1,
                                       w2, dy, dx, n_act, dout, hidden, dh,
                                       part_ln, M, d, d_ff, vec1, vec2, drop_h,
                                       drop_r, blockIdx.x);
}

__global__ void __launch_bounds__(kF32AtbThreads)
    b2_atb_tf32x3_kernel(const float* __restrict__ A,
                         const float* __restrict__ Bm,
                         float* __restrict__ part, int M, int K, int N,
                         int rows_per_split, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  f32_atb_tile(reinterpret_cast<float*>(smem_raw), A, K, Bm, N, part, M, K,
               N, rows_per_split, vec, blockIdx.x, blockIdx.y, blockIdx.z);
}

// ---------------------------------------------------------------------------
// launches

template <int kCs, int kUnits>
cudaError_t launch_fwd(const float* x, const float* ln_scale,
                       const float* ln_bias, const float* w1, const float* b1,
                       const float* w2, const float* b2, float* y, int M,
                       int d, int d_ff, DropStream drop_h, DropStream drop_r,
                       cudaStream_t stream) {
  auto kernel = b2_fwd_tf32x3_kernel<kCs, kUnits>;
  constexpr int rows = block_rows(kCs);
  const size_t smem = row_smem(d, 1, rows, round8(d), kUnits);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(M + rows - 1) / rows, kBlockThreads, smem, stream>>>(
      x, ln_scale, ln_bias, w1, b1, w2, b2, y, M, d, d_ff,
      d_ff % 4 == 0 && aligned16({w1}), d % 4 == 0 && aligned16({w2}),
      drop_h, drop_r);
  return cudaGetLastError();
}

struct BwdArgs {
  const float *x, *ln_scale, *ln_bias, *w1, *b1, *w2, *dy;
  float *dx, *dg, *db, *dw1, *db1, *dw2, *db2;
  float *n_act, *dout, *hidden, *dh, *part_1, *part_2, *part_ln;
  int M, d, d_ff, splits_1, splits_2;
};

template <int kCs, int kUnits>
cudaError_t launch_bwd(const BwdArgs& a, DropStream drop_h, DropStream drop_r,
                       cudaStream_t stream) {
  constexpr int rows = block_rows(kCs);
  const int tiles = (a.M + rows - 1) / rows;
  auto kernel = b2_bwd_rows_tf32x3_kernel<kCs, kUnits>;
  const size_t smem = row_smem(a.d, 2, rows, (a.d + 15) / 16 * 16, kUnits);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<tiles, kBlockThreads, smem, stream>>>(
      a.x, a.ln_scale, a.ln_bias, a.w1, a.b1, a.w2, a.dy, a.dx, a.n_act,
      a.dout, a.hidden, a.dh, a.part_ln, a.M, a.d, a.d_ff,
      a.d_ff % 4 == 0 && aligned16({a.w1}), a.d % 4 == 0 && aligned16({a.w2}),
      drop_h, drop_r);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = f32_weight_grad(b2_atb_tf32x3_kernel, a.n_act, a.dh, a.part_1, a.dw1,
                        a.db1, a.M, a.d, a.d_ff, a.splits_1, stream);
  if (err != cudaSuccess) return err;
  err = f32_weight_grad(b2_atb_tf32x3_kernel, a.hidden, a.dout, a.part_2,
                        a.dw2, a.db2, a.M, a.d_ff, a.d, a.splits_2, stream);
  if (err != cudaSuccess) return err;
  return launch_reduce(a.part_ln, tiles, a.dg, a.d, a.db, a.d, stream);
}

}  // namespace
}  // namespace allrank

// Launches the forward's kernel on `stream`; returns 0 or the CUDA error
// code. x and y are fp32 [M, d], M = B * L, d <= 256; parameters are fp32,
// w1 [d, d_ff], w2 [d_ff, d], d_ff <= 1024. drop_keys holds {k0, k1,
// threshold} of the hidden stream, then of the output stream
// (ops/dropout.py); p_hidden / p_resid are their rates (0: no dropout).
extern "C" int ffn_sublayer_fwd_tf32x3(const void* x, const void* ln_scale,
                                       const void* ln_bias, const void* w1,
                                       const void* b1, const void* w2,
                                       const void* b2, void* y, int M, int d,
                                       int d_ff, const unsigned* drop_keys,
                                       double p_hidden, double p_resid,
                                       void* stream) {
  using namespace allrank;
  using F = const float*;
  if (d < 1 || d > 2 * kColsWarp) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const auto dh = make_stream(drop_keys, p_hidden);
  const auto dr = make_stream(drop_keys + 3, p_resid);
  const auto args = [&](auto launch) {
    return launch(static_cast<F>(x), static_cast<F>(ln_scale),
                  static_cast<F>(ln_bias), static_cast<F>(w1),
                  static_cast<F>(b1), static_cast<F>(w2), static_cast<F>(b2),
                  static_cast<float*>(y), M, d, d_ff, dh, dr, s);
  };
  if ((d + 15) / 16 * 16 > kColsWarp) return args(launch_fwd<2, 32>);
  return args(launch_fwd<1, 64>);
}

// Launches the backward's three kernels and three reductions on `stream`;
// returns 0 or the CUDA error code. Inputs x, parameters and dy (fp32
// [M, d]); outputs dx and the gradients dg, db [d], dw1 [d, d_ff], db1
// [d_ff], dw2 [d_ff, d], db2 [d]. Scratch from the caller: n_act and dout
// [M, d], hidden and dh [M, d_ff]; part_1 [splits_1, d*d_ff + d_ff], part_2
// [splits_2, d_ff*d + d], part_ln [ceil(M / 64), 2d].
extern "C" int ffn_sublayer_bwd_tf32x3(
    const void* x, const void* ln_scale, const void* ln_bias, const void* w1,
    const void* b1, const void* w2, const void* dy, void* dx, void* dg,
    void* db, void* dw1, void* db1, void* dw2, void* db2, void* n_act,
    void* dout, void* hidden, void* dh, void* part_1, void* part_2,
    void* part_ln, int M, int d, int d_ff, int splits_1, int splits_2,
    const unsigned* drop_keys, double p_hidden, double p_resid,
    void* stream) {
  using namespace allrank;
  using F = const float*;
  if (d < 1 || d > 2 * kColsWarp) return cudaErrorInvalidValue;
  auto f = [](void* p) { return static_cast<float*>(p); };
  const BwdArgs a{static_cast<F>(x),  static_cast<F>(ln_scale),
                  static_cast<F>(ln_bias), static_cast<F>(w1),
                  static_cast<F>(b1), static_cast<F>(w2),
                  static_cast<F>(dy), f(dx), f(dg), f(db), f(dw1), f(db1),
                  f(dw2), f(db2), f(n_act), f(dout), f(hidden), f(dh),
                  f(part_1), f(part_2), f(part_ln), M, d, d_ff, splits_1,
                  splits_2};
  auto s = static_cast<cudaStream_t>(stream);
  const auto drop_h = make_stream(drop_keys, p_hidden);
  const auto drop_r = make_stream(drop_keys + 3, p_resid);
  if ((d + 15) / 16 * 16 > kColsWarp)
    return launch_bwd<2, 16>(a, drop_h, drop_r, s);
  return launch_bwd<1, 32>(a, drop_h, drop_r, s);
}
