// FFN sublayer forward and backward for Hopper (sm_90a), fp32 or bf16
// activations:
//   y = x + drop_r(drop_h(relu(LN(x) . W1 + b1)) . W2 + b2)
// with the unbiased-std LayerNorm, dropout on the hidden activation and on
// the sublayer output (csrc/dropout.cuh), and the residual added in fp32.
//
// Replaces the TPU kernel `ffn_sublayer` of the JAX package's
// ops/ffn_block.py: forward pallas_call at line 204 (math in
// ffn_sublayer_fwd_vmem, lines 40-63), backward pallas_call at line 233
// (math in ffn_sublayer_bwd_vmem, lines 76-132).
//
// What bounds it: the products. At the flagship shape (B=64, L=240, d=128,
// d_ff=512) the forward does about 4.0 GFLOP on 7.9 MB of fp32 activations
// in and out, the backward about 10.1 GFLOP, so both are bound by operations.
//
// Forward: one block per 64 rows. The block normalises its rows once into
// shared memory, then walks d_ff in chunks of 64: h_c = drop(relu(LN(x) .
// W1[:, c] + b1[c])) goes to shared memory and acc += h_c . W2[c, :] stays
// in registers (up to 64 x 256 outputs per block), so the [rows, d_ff]
// hidden state never reaches device memory. W1 and W2 (128 KB each in bf16
// at the flagship width, 256 KB each in fp32) do not fit beside each other
// in shared memory; they are streamed in 32 x 64 chunks.
//
// Backward: one block per 64 rows keeps LN(x) and dout = drop_r(dy) in
// shared memory and walks d_ff in chunks of 64, recomputing the
// pre-activation, the ReLU gate and the hidden mask, forming
// dh = (dout . W2^T) * mask * gate, and accumulating dn += dh . W1^T in
// registers; then the LN backward. The weight gradients sum over all B * L
// rows: the block writes the hidden activation and dh ([B*L, d_ff] each,
// 31 MB in fp32 at the flagship shape) and dW1 = LN(x)^T . dh,
// dW2 = hidden^T . dout and their biases are split A^T . B products summed
// in a fixed order (backward.cuh), no atomics.
//
// bf16 rounds where the TPU kernel does: the LN output, the hidden
// activation, dout and dh; products are fp32 FMAs (common.cuh).
#include "backward.cuh"
#include "common.cuh"
#include "dropout.cuh"
#include "sublayer_tiles.cuh"

namespace allrank {
namespace {

// The kernels are thin wrappers over the tile bodies of sublayer_tiles.cuh.

template <class T>
__global__ void __launch_bounds__(kThreads)
    ffn_kernel(const T* __restrict__ x, const float* __restrict__ ln_scale,
               const float* __restrict__ ln_bias, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, T* __restrict__ y, int M, int d,
               int d_ff, DropStream drop_h, DropStream drop_r) {
  extern __shared__ float smem[];
  ffn_fwd_tile(smem, x, ln_scale, ln_bias, w1, b1, w2, b2, y, M, d, d_ff,
               drop_h, drop_r, blockIdx.x);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
    ffn_bwd_kernel(const T* __restrict__ x, const float* __restrict__ ln_scale,
                   const float* __restrict__ ln_bias,
                   const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ w2, const T* __restrict__ dy,
                   T* __restrict__ dx, T* __restrict__ n_act,
                   T* __restrict__ dout, T* __restrict__ hidden,
                   T* __restrict__ dh, float* __restrict__ part_ln, int M,
                   int d, int d_ff, DropStream drop_h, DropStream drop_r) {
  extern __shared__ float smem[];
  ffn_bwd_tile(smem, x, ln_scale, ln_bias, w1, b1, w2, dy, dx, n_act, dout,
               hidden, dh, part_ln, M, d, d_ff, drop_h, drop_r, blockIdx.x);
}

template <class T>
int launch_fwd(const void* x, const void* ln_scale, const void* ln_bias,
               const void* w1, const void* b1, const void* w2, const void* b2,
               void* y, int M, int d, int d_ff, DropStream drop_h,
               DropStream drop_r, cudaStream_t stream) {
  const size_t smem = ffn_fwd_smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kTile - 1) / kTile);
  ffn_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<T*>(y), M, d, d_ff, drop_h,
      drop_r);
  return cudaGetLastError();
}

struct BwdArgs {
  const void *x, *ln_scale, *ln_bias, *w1, *b1, *w2, *dy;
  void *dx, *dg, *db, *dw1, *db1, *dw2, *db2;
  void *n_act, *dout, *hidden, *dh, *part_1, *part_2, *part_ln;
  int M, d, d_ff, splits_1, splits_2;
};

template <class T>
int launch_bwd(const BwdArgs& a, DropStream drop_h, DropStream drop_r,
               cudaStream_t stream) {
  const int tiles = (a.M + kTile - 1) / kTile;
  const size_t smem = ffn_bwd_smem_floats(a.d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  T* n_act = static_cast<T*>(a.n_act);
  T* dout = static_cast<T*>(a.dout);
  T* hidden = static_cast<T*>(a.hidden);
  T* dh = static_cast<T*>(a.dh);
  float* part_ln = static_cast<float*>(a.part_ln);
  ffn_bwd_kernel<T><<<tiles, kThreads, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const float*>(a.ln_scale),
      static_cast<const float*>(a.ln_bias), static_cast<const float*>(a.w1),
      static_cast<const float*>(a.b1), static_cast<const float*>(a.w2),
      static_cast<const T*>(a.dy), static_cast<T*>(a.dx), n_act, dout, hidden,
      dh, part_ln, a.M, a.d, a.d_ff, drop_h, drop_r);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = launch_weight_grad<T>(n_act, dh, static_cast<float*>(a.part_1),
                              static_cast<float*>(a.dw1),
                              static_cast<float*>(a.db1), a.M, a.d, a.d_ff,
                              a.splits_1, stream);
  if (err != cudaSuccess) return err;
  err = launch_weight_grad<T>(hidden, dout, static_cast<float*>(a.part_2),
                              static_cast<float*>(a.dw2),
                              static_cast<float*>(a.db2), a.M, a.d_ff, a.d,
                              a.splits_2, stream);
  if (err != cudaSuccess) return err;
  return launch_reduce(part_ln, tiles, static_cast<float*>(a.dg), a.d,
                       static_cast<float*>(a.db), a.d, stream);
}

}  // namespace
}  // namespace allrank

// Launches the forward kernel on `stream`; returns 0 or the CUDA error code.
// x and y are [M, d] in x's dtype (bf16 if is_bf16, else fp32), M = B * L;
// parameters are fp32, w1 [d, d_ff], w2 [d_ff, d]; d <= 256. drop_keys holds
// {k0, k1, threshold} of the hidden stream, then of the output stream
// (ops/dropout.py); p_hidden / p_resid are their rates (0: no dropout).
extern "C" int ffn_sublayer_fwd(const void* x, const void* ln_scale,
                                const void* ln_bias, const void* w1,
                                const void* b1, const void* w2, const void* b2,
                                void* y, int M, int d, int d_ff, int is_bf16,
                                const unsigned* drop_keys, double p_hidden,
                                double p_resid, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto dh = allrank::make_stream(drop_keys, p_hidden);
  const auto dr = allrank::make_stream(drop_keys + 3, p_resid);
  if (is_bf16)
    return allrank::launch_fwd<__nv_bfloat16>(x, ln_scale, ln_bias, w1, b1, w2,
                                              b2, y, M, d, d_ff, dh, dr, s);
  return allrank::launch_fwd<float>(x, ln_scale, ln_bias, w1, b1, w2, b2, y, M,
                                    d, d_ff, dh, dr, s);
}

// Launches the backward's six kernels on `stream`; returns 0 or the CUDA
// error code. Inputs x, parameters and dy (x's dtype, [M, d]); outputs dx
// and the fp32 gradients dg, db [d], dw1 [d, d_ff], db1 [d_ff], dw2
// [d_ff, d], db2 [d]. Scratch from the caller: n_act and dout [M, d],
// hidden and dh [M, d_ff] in x's dtype; fp32 part_1 [splits_1, d*d_ff +
// d_ff], part_2 [splits_2, d_ff*d + d], part_ln [ceil(M / 64), 2d].
extern "C" int ffn_sublayer_bwd(
    const void* x, const void* ln_scale, const void* ln_bias, const void* w1,
    const void* b1, const void* w2, const void* dy, void* dx, void* dg,
    void* db, void* dw1, void* db1, void* dw2, void* db2, void* n_act,
    void* dout, void* hidden, void* dh, void* part_1, void* part_2,
    void* part_ln, int M, int d, int d_ff, int splits_1, int splits_2,
    int is_bf16, const unsigned* drop_keys, double p_hidden, double p_resid,
    void* stream) {
  const allrank::BwdArgs a{x,      ln_scale, ln_bias, w1,     b1,     w2,
                           dy,     dx,       dg,      db,     dw1,    db1,
                           dw2,    db2,      n_act,   dout,   hidden, dh,
                           part_1, part_2,   part_ln, M,      d,      d_ff,
                           splits_1, splits_2};
  auto s = static_cast<cudaStream_t>(stream);
  const auto drop_h = allrank::make_stream(drop_keys, p_hidden);
  const auto drop_r = allrank::make_stream(drop_keys + 3, p_resid);
  if (is_bf16)
    return allrank::launch_bwd<__nv_bfloat16>(a, drop_h, drop_r, s);
  return allrank::launch_bwd<float>(a, drop_h, drop_r, s);
}
