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
#include "backward.cuh"
#include "dropout.cuh"
#include "mma_tile_f32.cuh"

namespace allrank {
namespace {

// a row kernel's block: eight warps, common.cuh's kThreads (which
// backward.cuh's ln_backward_tile takes)
constexpr int kWarps = 8, kBlockThreads = 32 * kWarps;
static_assert(kBlockThreads == kThreads, "the LN backward's block");
constexpr int kColsWarp = 128;  // output columns a warp accumulates

// Rows of a row kernel's block: 16 a warp, 128 at d <= 128; above, two
// warps share each row group (kCs = 2), 64.
__host__ __device__ constexpr int block_rows(int cs) {
  return 16 * kWarps / cs;
}

// floats of one ring slot: a W1 chunk [w1_rows][f32_kn_pitch(kUnits)] and
// a W2 chunk [kUnits][f32_row_pitch(d)]
__host__ __device__ __forceinline__ int slot_floats(int w1_rows, int chunk,
                                                    int d) {
  return w1_rows * f32_kn_pitch(chunk) + chunk * f32_row_pitch(d);
}

// floats of the ring: its two slots, and at least the backward's dn
// [rows][d + 1], which takes the ring's place after the last chunk
__host__ __device__ __forceinline__ int ring_floats(int w1_rows, int chunk,
                                                    int d, int rows) {
  const int slots = 2 * slot_floats(w1_rows, chunk, d);
  return slots > rows * (d + 1) ? slots : rows * (d + 1);
}

// Shared memory of a row kernel: `tiles` activation tiles [rows][lda], the
// ring and two [rows] float row statistics.
__host__ __forceinline__ size_t row_smem(int d, int tiles, int rows,
                                         int w1_rows, int chunk) {
  return ((size_t)tiles * rows * f32_row_pitch(d) +
          ring_floats(w1_rows, chunk, d, rows) + 2 * rows) *
         sizeof(float);
}

// Chunk f0 of the weights into one ring slot: W1s [w1_rows][w1p] =
// w1[:, f0:f0 + kUnits] and W2s [kUnits][lda] = w2[f0:f0 + kUnits, :],
// zero past d, d_ff and in the padding.
template <int kUnits>
__device__ __forceinline__ void stage_chunk(float* W1s, float* W2s,
                                            const float* __restrict__ w1,
                                            const float* __restrict__ w2,
                                            int f0, int w1_rows, int d,
                                            int d_ff, bool vec1, bool vec2) {
  const int dpad16 = (d + 15) / 16 * 16;
  stage_f32<kBlockThreads>(W1s, f32_kn_pitch(kUnits), w1, d_ff, 0, w1_rows,
                           d, f0, kUnits, d_ff, vec1);
  stage_f32<kBlockThreads>(W2s, f32_row_pitch(d), w2, d, f0, kUnits, d_ff, 0,
                           dpad16, d, vec2);
}

// ---------------------------------------------------------------------------
// forward

// y for the block_rows(kCs) rows of blockIdx.x. kCs warps share a row
// group, each accumulating 128 of the output columns (kCs = 2 for d > 128);
// kUnits hidden units a chunk.
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
  constexpr int kRows = block_rows(kCs), kGroups = kWarps / kCs;
  constexpr int kSteps = kUnits / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dpad = round8(d), lda = f32_row_pitch(d);
  const int w1p = f32_kn_pitch(kUnits), slot = slot_floats(dpad, kUnits, d);
  float* As = reinterpret_cast<float*>(smem_raw);  // [kRows][lda] LN(x)
  float* ring = As + kRows * lda;  // 2 x (W1 chunk, W2 chunk)
  float* mean = ring + ring_floats(dpad, kUnits, d, kRows);  // [kRows]
  float* rdenom = mean + kRows;    // [kRows]
  const int m0 = blockIdx.x * kRows, rows = min(kRows, M - m0);
  const float* xt = x + (size_t)m0 * d;
  const int nch = (d_ff + kUnits - 1) / kUnits;

  stage_chunk<kUnits>(ring, ring + dpad * w1p, w1, w2, 0, dpad, d, d_ff,
                      vec1, vec2);
  cp_async_commit();
  f32_ln_stats<kRows, kWarps>(xt, rows, d, mean, rdenom);
  __syncthreads();
  f32_stage_ln<kRows, kBlockThreads>(As, lda, xt, rows, d, dpad, ln_scale,
                                     ln_bias, mean, rdenom);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % kGroups, c0 = (warp / kGroups) * kColsWarp;
  const int ont = c_tiles_f32(min(kColsWarp, d - c0));
  const float* Aw = As + rg * 16 * lda;
  const size_t row_g = (size_t)m0 + rg * 16 + lane / 4;  // row of c[0], c[1]
  float acc[16][4] = {};
  for (int c = 0; c < nch; ++c) {
    const int f0 = c * kUnits;
    const float* W1s = ring + (c & 1) * slot;
    if (c + 1 < nch) {
      float* next = ring + ((c + 1) & 1) * slot;
      stage_chunk<kUnits>(next, next + dpad * w1p, w1, w2, f0 + kUnits, dpad,
                          d, d_ff, vec1, vec2);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // chunk c (and, at c = 0, the LN tile) in place
    float h[kSteps][4] = {};
    f32_product<kSteps, false>(h, Aw, lda, W1s, w1p, dpad / 8, kSteps);
#pragma unroll
    for (int n = 0; n < kSteps; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = f0 + 8 * n + 2 * (lane % 4) + (e & 1);
        float v = 0.f;
        if (f < d_ff) {
          v = fmaxf(h[n][e] + b1[f], 0.f);
          if (drop_h.on)
            v = drop_keep(drop_h, (row_g + 8 * (e >> 1)) * d_ff + f)
                    ? v / drop_h.denom
                    : 0.f;
        }
        h[n][e] = v;
      }
    f32_regs_product<16, kSteps, false>(acc, h, W1s + dpad * w1p + c0, lda,
                                        ont);
    __syncthreads();  // the ring slot is read before it is staged again
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t row = row_g + 8 * r;
    if (row >= (size_t)M) continue;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      if (n >= ont) break;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * n + 2 * (lane % 4) + e;
        if (col >= d) continue;
        const size_t i = row * d + col;
        float a = acc[n][2 * r + e] + b2[col];
        if (drop_r.on) a = drop_keep(drop_r, i) ? a / drop_r.denom : 0.f;
        y[i] = x[i] + a;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward

// The row kernel for the block_rows(kCs) rows of blockIdx.x (kCs as the
// forward's, kUnits hidden units a step): writes n_act = LN(x) and dout =
// drop_r(dy) [M, d], hidden and the gated dh [M, d_ff], dx and the tile's
// LN partial sums (part_ln row blockIdx.x).
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
  constexpr int kRows = block_rows(kCs), kGroups = kWarps / kCs;
  constexpr int kSteps = kUnits / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dpad = round8(d), dpad16 = (d + 15) / 16 * 16;
  const int lda = f32_row_pitch(d), w1p = f32_kn_pitch(kUnits);
  const int slot = slot_floats(dpad16, kUnits, d);
  float* As = reinterpret_cast<float*>(smem_raw);  // [kRows][lda] n
  float* Ds = As + kRows * lda;                    // [kRows][lda] dout
  float* ring = Ds + kRows * lda;  // 2 x (W1 chunk, W2 chunk)
  float* mean = ring + ring_floats(dpad16, kUnits, d, kRows);  // [kRows]
  float* rdenom = mean + kRows;    // [kRows]
  float* Ns = ring;                // after the chunks: dn [kRows][d + 1]
  const int ldn = d + 1;
  const int m0 = blockIdx.x * kRows, rows = min(kRows, M - m0);
  const size_t o0 = (size_t)m0 * d;
  const float* xt = x + o0;
  const int nch = (d_ff + kUnits - 1) / kUnits;

  stage_chunk<kUnits>(ring, ring + dpad16 * w1p, w1, w2, 0, dpad16, d, d_ff,
                      vec1, vec2);
  cp_async_commit();
  f32_ln_stats<kRows, kWarps>(xt, rows, d, mean, rdenom);
  __syncthreads();
  for (int e = threadIdx.x; e < kRows * dpad; e += kBlockThreads) {
    const int r = e / dpad, k = e % dpad;
    float n = 0.f, g = 0.f;
    if (r < rows && k < d) {
      const size_t i = o0 + (size_t)r * d + k;
      n = (x[i] - mean[r]) * rdenom[r] * ln_scale[k] + ln_bias[k];
      g = dy[i];
      if (drop_r.on) g = drop_keep(drop_r, i) ? g * drop_r.inv : 0.f;
      n_act[i] = n;
      dout[i] = g;
    }
    As[r * lda + k] = n;
    Ds[r * lda + k] = g;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % kGroups, c0 = (warp / kGroups) * kColsWarp;
  const bool writer = c0 == 0;  // the first column half writes hidden, dh
  const int ont = c_tiles_f32(min(kColsWarp, d - c0));
  const float* Aw = As + rg * 16 * lda;
  const float* Dw = Ds + rg * 16 * lda;
  const size_t row_g = (size_t)m0 + rg * 16 + lane / 4;
  float dn[16][4] = {};
  for (int c = 0; c < nch; ++c) {
    const int f0 = c * kUnits;
    const float* W1s = ring + (c & 1) * slot;
    const float* W2s = W1s + dpad16 * w1p;
    if (c + 1 < nch) {
      float* next = ring + ((c + 1) & 1) * slot;
      stage_chunk<kUnits>(next, next + dpad16 * w1p, w1, w2, f0 + kUnits,
                          dpad16, d, d_ff, vec1, vec2);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // chunk c (and, at c = 0, the n and dout tiles)
    float pre[kSteps][4] = {}, g[kSteps][4] = {};
    f32_product<kSteps, false>(pre, Aw, lda, W1s, w1p, dpad / 8, kSteps);
    f32_product<kSteps, true>(g, Dw, lda, W2s, lda, dpad / 8, kSteps);
#pragma unroll
    for (int n = 0; n < kSteps; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const size_t row = row_g + 8 * (e >> 1);
        const int f = f0 + 8 * n + 2 * (lane % 4) + (e & 1);
        float hv = 0.f, gv = 0.f;
        if (f < d_ff) {
          const float p = pre[n][e] + b1[f];
          hv = fmaxf(p, 0.f);
          gv = g[n][e];
          if (drop_h.on) {
            const bool keep = drop_keep(drop_h, row * d_ff + f);
            hv = keep ? hv * drop_h.inv : 0.f;
            gv = keep ? gv * drop_h.inv : 0.f;
          }
          gv = p > 0.f ? gv : 0.f;
          if (writer && row < (size_t)M) {
            hidden[row * d_ff + f] = hv;
            dh[row * d_ff + f] = gv;
          }
        }
        g[n][e] = gv;
      }
    f32_regs_product<16, kSteps, true>(dn, g, W1s + c0 * w1p, w1p, ont);
    __syncthreads();  // the ring slot is read before it is staged again
  }

  // dn to shared memory (over the ring, whose reads are done), then the LN
  // backward in fp32
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = c0 + 8 * n + 2 * (lane % 4) + (e & 1);
      if (n < ont && col < d)
        Ns[(rg * 16 + lane / 4 + 8 * (e >> 1)) * ldn + col] = dn[n][e];
    }
  __syncthreads();
  // backward.cuh's LN backward, whose block is kThreads = kBlockThreads
  ln_backward_tile(xt, dy + o0, dx + o0, Ns, ldn, rows, d, ln_scale,
                   part_ln + (size_t)blockIdx.x * 2 * d, mean, rdenom);
}

// split blockIdx.z of C = A^T . B and colsum(B) (mma_tile_f32.cuh's
// f32_atb_tile)
__global__ void __launch_bounds__(kF32AtbThreads)
    b2_atb_tf32x3_kernel(const float* __restrict__ A,
                         const float* __restrict__ Bm,
                         float* __restrict__ part, int M, int K, int N,
                         int rows_per_split, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  f32_atb_tile(reinterpret_cast<float*>(smem_raw), A, K, Bm, N, part, M, K,
               N, rows_per_split, vec);
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
