// The two synthetic kernels of the boundary-shift probe (X2) on Hopper's
// tensor cores (sm_90a), bf16 activations and weights, fp32 accumulation:
//   plain:   y = x + relu(LN(x) . W1) . W2
//   shifted: out = x + relu(pre) . W2,  pre_out = LN(out) . W1'
// with the unbiased-std LayerNorm without gain or bias,
// LN(v) = (v - mean) / (sqrt(max(var, 1e-24)) + 1e-6), rounded to bf16
// before its product, as is the ReLU output; the residual is added in fp32
// and the shifted kernel normalises that fp32 sum, not its bf16 copy.
//
// Replaces the TPU kernel `make_calls` of the JAX package's
// tools/exp_boundary_shift.py:87 (pallas_calls at lines 95 and 102, math in
// _plain_kernel and _shift_kernel, lines 66-84). The probe chains N of them
// with distinct weights and asks whether a kernel boundary that ends in a
// fresh product for the next kernel (shifted) costs less than one that
// ends in a bare residual (plain).
//
// What bounds them, at the probe's shape (M = B L = 15,360 rows, d = 128,
// d3 = 384): each does two products of 2 M d d3 = 1.51 GFLOP, 3.05 us at
// the card's bf16 tensor-core rate; plain moves x and y (and the weights),
// 8.06 MB, 2.41 us at 3.35 TB/s, so it is bound by operations; shifted
// also reads pre and writes pre_out [M, d3], 31.7 MB, 9.45 us, so it is
// bound by bytes.
//
// Design, on B2's tensor-core pieces (b2_mma_tiles.cuh, mma_tile.cuh):
//  * plain is B2's bf16 forward at unit LN gain, zero LN bias, zero b1 and
//    b2 and dropout 0: b2_fwd_mma_tile unchanged, so it gives
//    ffn_sublayer_fwd's bits on the same values. X2's bf16 W1 [d, d3] and
//    W2 [d3, d] are B2's rounded-weight scratch already where d % 16 == 0
//    and d3 % 64 == 0 (the wrapper pads them with zeros otherwise, to whole
//    16-row and 64-column steps); B2 multiplies by 1 / (std + eps) where
//    the plain version divides, a rounding-edge difference.
//  * shifted, x2_shift_mma_tile: a block of eight warps over 128 rows (64
//    at d > 128, two warps a row group, as B2's forward), 16 rows and up
//    to 128 output columns a warp, its [16, d] fp32 sum in registers. Two
//    phases stream through one two-slot cp.async ring: first W2's 64-row
//    chunks with the block's 64-column chunks of pre (ReLU on the bf16 A
//    fragments as ldmatrix forms them; acc += relu(pre_c) . W2_c); then the
//    epilogue, out32 = x + acc in fp32, out stored, each row's mean and
//    variance of out32 in fp32 (across the quad's lanes, through shared
//    memory where two warps share a row group), LN(out32) rounded to bf16
//    as the A tile in shared memory; then W1''s 64-column chunks, each
//    pre_out chunk = round(LN . W1'_c) written as its warp finishes it.
//    pre and pre_out never wait on each other: the ring's next chunk lands
//    while the tensor cores work on the last one.
//  * Ragged shapes: any d <= 256, any d3 >= 1, any number of rows: rows
//    past M and columns past d or d3 are zeros in shared memory and never
//    stored; pre is staged with 16-byte cp.async where d3 % 8 == 0 and its
//    base is aligned, element by element otherwise.
#include "b2_mma_tiles.cuh"

namespace allrank {
namespace {

// bf16 elements of a ring slot of the shifted kernel: phase 1's W2 chunk
// [64][lda] and pre chunk [rows][kW1Pitch], or phase 2's W1' chunk
// [dpad][kW1Pitch]
__host__ __device__ __forceinline__ int shift_slot_elems(int dpad, int rows) {
  const int a = kChunkF * (dpad + 8) + rows * kW1Pitch;
  const int b = dpad * kW1Pitch;
  return a > b ? a : b;
}

// Shared memory of the shifted kernel: the LN tile [rows][lda], two ring
// slots and the two column halves' row partials [2][rows] fp32.
__host__ __forceinline__ size_t shift_smem(int dpad, int rows) {
  return (size_t)(rows * (dpad + 8) + 2 * shift_slot_elems(dpad, rows)) *
             sizeof(bf16) +
         2 * rows * sizeof(float);
}

// ReLU of the two bf16 of a packed A-fragment register: a half with its
// sign bit set becomes +0
__device__ __forceinline__ uint32_t relu_bf16x2(uint32_t v) {
  const uint32_t neg = (v >> 15) & 0x00010001u;
  return v & ~(neg * 0xFFFFu);
}

// dst[i], dst[i + 1] = a, b rounded to bf16 (the second only where
// `second`): one 4-byte store where `pair` (i even, dst 4-byte aligned)
__device__ __forceinline__ void store_bf16_pair(bf16* __restrict__ dst,
                                                size_t i, float a, float b,
                                                bool second, bool pair) {
  if (second && pair) {
    *reinterpret_cast<__nv_bfloat162*>(dst + i) = __floats2bfloat162_rn(a, b);
  } else {
    dst[i] = __float2bfloat16_rn(a);
    if (second) dst[i + 1] = __float2bfloat16_rn(b);
  }
}

// out and pre_out for the block_rows(kCs) rows of bx (kCs as B2's
// forward). w2b [ffp][dpad] and w1b [dpad][ffp] (ffp = ff_pad(d3)) are
// zero-padded bf16 with 16-byte aligned rows; pre_vec: pre's rows may be
// staged with 16-byte copies.
template <int kCs>
__device__ __forceinline__ void x2_shift_mma_tile(
    unsigned char* smem_raw, const bf16* __restrict__ x,
    const bf16* __restrict__ pre, const bf16* __restrict__ w2b,
    const bf16* __restrict__ w1b, bf16* __restrict__ out,
    bf16* __restrict__ pre_out, int M, int d, int d3, bool pre_vec,
    unsigned bx) {
  constexpr int kRows = block_rows(kCs), kGroups = kWarps / kCs;
  constexpr int kCols2 = kChunkF / kCs;  // phase-2 columns a warp takes
  const int dpad = round16(d), lda = tile_pitch(d), ffp = ff_pad(d3);
  const int slot = shift_slot_elems(dpad, kRows);
  bf16* Ns = reinterpret_cast<bf16*>(smem_raw);  // [kRows][lda] LN(out32)
  bf16* ring = Ns + kRows * lda;                 // two slots
  float* part = reinterpret_cast<float*>(ring + 2 * slot);  // [2][kRows]
  const int m0 = bx * kRows, nch = ffp / kChunkF, n_steps = 2 * nch;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % kGroups, half = warp / kGroups;
  const int r0 = rg * 16, c0 = half * kColsWarp;
  const int ont = c_tiles(min(kColsWarp, d - c0));
  const bool pairs_d = d % 2 == 0, pairs_d3 = d3 % 2 == 0;

  // step i into ring slot b: phase 1 (i < nch) W2's rows and pre's
  // columns of chunk i, phase 2 W1''s columns of chunk i - nch
  auto stage = [&](int i, int b) {
    bf16* S = ring + b * slot;
    if (i < nch) {
      const int f0 = i * kChunkF, per = dpad / 8;
      for (int c = threadIdx.x; c < kChunkF * per; c += kBlockThreads) {
        const int r = c / per, col = (c % per) * 8;
        cp_async_16(S + r * lda + col, w2b + (size_t)(f0 + r) * dpad + col,
                    16);
      }
      stage_tile<kRows, kBlockThreads>(S + kChunkF * lda, kW1Pitch, pre + f0,
                                       d3, m0, M, kChunkF, d3 - f0, pre_vec);
    } else {
      const int f0 = (i - nch) * kChunkF;
      constexpr int per = kChunkF / 8;
      for (int c = threadIdx.x; c < dpad * per; c += kBlockThreads) {
        const int r = c / per, col = (c % per) * 8;
        cp_async_16(S + r * kW1Pitch + col, w1b + (size_t)r * ffp + f0 + col,
                    16);
      }
    }
  };
  // v[r] summed over its row (rows r0 + g + 8 r of the block): over the
  // quad, then over the row group's two warps where kCs = 2 (every thread
  // of the block calls it)
  auto row_sum = [&](float v[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) v[r] = quad_sum(v[r]);
    if constexpr (kCs == 2) {
      const int row = r0 + lane / 4;
      if (lane % 4 == 0) {
        part[half * kRows + row] = v[0];
        part[half * kRows + row + 8] = v[1];
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 2; ++r)
        v[r] = part[row + 8 * r] + part[kRows + row + 8 * r];
      __syncthreads();
    }
  };

  float acc[16][4] = {};
  stage(0, 0);
  cp_async_commit();
  for (int it = 0; it < n_steps; ++it) {
    if (it + 1 < n_steps) stage(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // step it's slot in place
    const bf16* S = ring + (it & 1) * slot;
    if (it < nch) {
      // acc += relu(pre_c) . W2_c
      uint32_t pa[4][4];
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        ldmatrix_x4(pa[kc], S + kChunkF * lda + (r0 + lane % 16) * kW1Pitch +
                                kc * 16 + (lane / 16) * 8);
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[kc][i] = relu_bf16x2(pa[kc][i]);
      }
      regs_product<16, 4, false>(acc, pa, S + c0, lda, ont);
    } else {
      // pre_out_c = round(LN(out32) . W1'_c), kCols2 columns a warp
      const int f0 = (it - nch) * kChunkF + half * kCols2;
      float h[8][4] = {};
      warp_product<8, false, false>(h, Ns + r0 * lda, lda,
                                    S + half * kCols2, kW1Pitch, dpad / 16,
                                    kCols2 / 8);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + r0 + lane / 4 + 8 * r;
        if (row >= M) continue;
#pragma unroll
        for (int n = 0; n < kCols2 / 8; ++n) {
          const int f = f0 + 8 * n + 2 * (lane % 4);
          if (f < d3)
            store_bf16_pair(pre_out, (size_t)row * d3 + f, h[n][2 * r],
                            h[n][2 * r + 1], f + 1 < d3, pairs_d3);
        }
      }
    }
    if (it == nch - 1) {
      // out32 = x + acc, out stored; LN(out32) into Ns
      float s[2] = {0.f, 0.f}, ss[2] = {0.f, 0.f}, mean[2], denom[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + r0 + lane / 4 + 8 * r;
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          if (n >= ont) break;
          const int col = c0 + 8 * n + 2 * (lane % 4);
          float v[2] = {0.f, 0.f};
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (row < M && col + e < d)
              v[e] = to_float(x[(size_t)row * d + col + e]) +
                     acc[n][2 * r + e];
          if (row < M && col < d)
            store_bf16_pair(out, (size_t)row * d + col, v[0], v[1],
                            col + 1 < d, pairs_d);
          acc[n][2 * r] = v[0];
          acc[n][2 * r + 1] = v[1];
          s[r] += v[0] + v[1];
        }
      }
      row_sum(s);
#pragma unroll
      for (int r = 0; r < 2; ++r) mean[r] = s[r] / (float)d;
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          if (n >= ont) break;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = c0 + 8 * n + 2 * (lane % 4) + e;
            const float c = acc[n][2 * r + e] - mean[r];
            if (col < d) ss[r] = fmaf(c, c, ss[r]);
          }
        }
      row_sum(ss);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        denom[r] = sqrtf(fmaxf(ss[r] / (float)max(d - 1, 1), kVarFloor)) +
                   kLnEps;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + lane / 4 + 8 * r;
        const bool in = m0 + row < M;
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          if (n >= ont) break;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = c0 + 8 * n + 2 * (lane % 4) + e;
            Ns[row * lda + col] = __float2bfloat16_rn(
                in && col < d ? (acc[n][2 * r + e] - mean[r]) / denom[r]
                              : 0.f);
          }
        }
      }
    }
    __syncthreads();  // the slot (and, at the last phase-1 step, Ns) read
  }
}

template <int kCs>
__global__ void __launch_bounds__(kBlockThreads)
    x2_plain_mma_kernel(const bf16* __restrict__ x,
                        const float* __restrict__ ones,
                        const float* __restrict__ zeros,
                        const bf16* __restrict__ w1b,
                        const bf16* __restrict__ w2b, bf16* __restrict__ y,
                        int M, int d, int d3) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const DropStream off{0u, 0u, 0u, 0, 1.f, 1.f};
  b2_fwd_mma_tile<kCs>(smem_raw, x, ones, zeros, w1b, zeros, w2b, zeros, y, M,
                       d, d3, off, off, blockIdx.x);
}

template <int kCs>
__global__ void __launch_bounds__(kBlockThreads)
    x2_shift_mma_kernel(const bf16* __restrict__ x,
                        const bf16* __restrict__ pre,
                        const bf16* __restrict__ w2b,
                        const bf16* __restrict__ w1b, bf16* __restrict__ out,
                        bf16* __restrict__ pre_out, int M, int d, int d3,
                        bool pre_vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  x2_shift_mma_tile<kCs>(smem_raw, x, pre, w2b, w1b, out, pre_out, M, d, d3,
                         pre_vec, blockIdx.x);
}

template <int kCs>
cudaError_t launch_x2(const bf16* x, const bf16* pre, const bf16* w1b,
                      const bf16* w2b, const float* ones, const float* zeros,
                      bf16* y, bf16* pre_out, int M, int d, int d3,
                      cudaStream_t stream) {
  constexpr int rows = block_rows(kCs);
  const int blocks = (M + rows - 1) / rows, dpad = round16(d);
  cudaError_t err;
  if (pre == nullptr) {
    auto kernel = x2_plain_mma_kernel<kCs>;
    const size_t smem = row_smem(dpad, 1, rows);
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    kernel<<<blocks, kBlockThreads, smem, stream>>>(x, ones, zeros, w1b, w2b,
                                                    y, M, d, d3);
  } else {
    auto kernel = x2_shift_mma_kernel<kCs>;
    const size_t smem = shift_smem(dpad, rows);
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    const bool pre_vec = d3 % 8 == 0 && rows_aligned(8, {pre});
    kernel<<<blocks, kBlockThreads, smem, stream>>>(x, pre, w2b, w1b, y,
                                                    pre_out, M, d, d3,
                                                    pre_vec);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace allrank

// Launches one kernel on `stream`: plain (pre null) y = x + relu(LN(x) W1)
// W2, or shifted (y = out, pre_out) from x and pre [M, d3]; returns 0 or
// the CUDA error code. x, y [M, d] and pre, pre_out [M, d3] bf16, 1 <= d
// <= 256, d3 >= 1; w1b [round16(d)][round64(d3)] (W1, or W1' shifted) and
// w2b [round64(d3)][round16(d)] (W2) bf16, zero-padded, 16-byte aligned;
// plain also takes ones [d] and zeros [max(d, d3)] fp32 (B2's LN gain,
// LN bias and biases).
extern "C" int boundary_fwd_mma(const void* x, const void* pre,
                                const void* w1b, const void* w2b,
                                const void* ones, const void* zeros, void* y,
                                void* pre_out, int M, int d, int d3,
                                void* stream) {
  using namespace allrank;
  using bf16 = __nv_bfloat16;
  if (M < 1 || d < 1 || d > 2 * kColsWarp || d3 < 1)
    return cudaErrorInvalidValue;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* pb = static_cast<const bf16*>(pre);
  const auto* w1 = static_cast<const bf16*>(w1b);
  const auto* w2 = static_cast<const bf16*>(w2b);
  const auto* o = static_cast<const float*>(ones);
  const auto* z = static_cast<const float*>(zeros);
  auto* yb = static_cast<bf16*>(y);
  auto* po = static_cast<bf16*>(pre_out);
  auto s = static_cast<cudaStream_t>(stream);
  if (round16(d) > kColsWarp)
    return launch_x2<2>(xb, pb, w1, w2, o, z, yb, po, M, d, d3, s);
  return launch_x2<1>(xb, pb, w1, w2, o, z, yb, po, M, d, d3, s);
}
