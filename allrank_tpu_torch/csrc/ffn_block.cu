// FFN sublayer forward for Hopper (sm_90a), fp32 or bf16 activations:
//   y = x + (relu(LN(x) . W1 + b1) . W2 + b2)
// with the unbiased-std LayerNorm and the residual added in fp32.
//
// Replaces the TPU kernel `ffn_sublayer` of the JAX package's
// ops/ffn_block.py (forward pallas_call at line 204, math in
// ffn_sublayer_fwd_vmem, lines 40-63), at dropout rate 0.
//
// What bounds it: the two products. At the flagship serving shape (B=64,
// L=240, d=128, d_ff=512) one call does about 4.0 GFLOP on 7.9 MB of fp32
// activations in and out, so it is bound by operations.
//
// Design: one block per 64 rows. The block normalises its rows once into
// shared memory, then walks d_ff in chunks of 64: h_c = relu(LN(x) . W1[:, c]
// + b1[c]) goes to shared memory and acc += h_c . W2[c, :] stays in registers
// (up to 64 x 256 outputs per block), so the [rows, d_ff] hidden state never
// reaches device memory. W1 and W2 (128 KB each in bf16 at the flagship
// width, 256 KB each in fp32) do not fit beside each other in shared memory;
// they are streamed in 32 x 64 chunks. bf16 rounds where the TPU kernel does:
// the LN output and the hidden activation; products are fp32 FMAs
// (common.cuh).
#include "common.cuh"

namespace allrank {
namespace {

template <class T>
__global__ void __launch_bounds__(kThreads)
    ffn_kernel(const T* __restrict__ x, const float* __restrict__ ln_scale,
               const float* __restrict__ ln_bias, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, T* __restrict__ y, int M, int d,
               int d_ff) {
  extern __shared__ float smem[];
  float* Bs = smem;                  // [kChunk][kLdB] W1 or W2 chunk
  float* Hs = Bs + kChunk * kLdB;    // [kTile][kLdB]  hidden chunk
  float* mean = Hs + kTile * kLdB;   // [kTile]
  float* rdenom = mean + kTile;      // [kTile]
  float* Ns = rdenom + kTile;        // [kTile][d + 1] LN(x) rows
  const int ldn = d + 1;
  const int m0 = blockIdx.x * kTile;
  const int rows = min(kTile, M - m0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* xt = x + (size_t)m0 * d;
  T* yt = y + (size_t)m0 * d;

  ln_row_stats(xt, rows, d, mean, rdenom);
  __syncthreads();
  for (int e = tid; e < kTile * d; e += kThreads) {
    const int r = e / d, k = e % d;
    Ns[r * ldn + k] =
        r < rows ? round_to<T>((to_float(xt[(size_t)r * d + k]) - mean[r]) *
                                   rdenom[r] * ln_scale[k] +
                               ln_bias[k])
                 : 0.f;
  }
  __syncthreads();

  float out[4][4][4] = {};  // [64-column tile of d][i][j]
  for (int f0 = 0; f0 < d_ff; f0 += kTile) {
    float hacc[4][4] = {};
    for (int k0 = 0; k0 < d; k0 += kChunk) {
      const int depth = min(kChunk, d - k0);
      for (int e = tid; e < kChunk * kTile; e += kThreads) {
        const int kk = e / kTile, n = e % kTile;
        Bs[kk * kLdB + n] =
            (kk < depth && f0 + n < d_ff)
                ? round_to<T>(w1[(size_t)(k0 + kk) * d_ff + f0 + n])
                : 0.f;
      }
      __syncthreads();
      mma_tile(hacc, Ns + k0, ldn, Bs, kLdB, depth);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, f = f0 + c;
        Hs[(ty + 16 * i) * kLdB + c] =
            f < d_ff ? round_to<T>(fmaxf(hacc[i][j] + b1[f], 0.f)) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (t * kTile < d) {
        for (int kk0 = 0; kk0 < kTile; kk0 += kChunk) {
          for (int e = tid; e < kChunk * kTile; e += kThreads) {
            const int kk = e / kTile, n = e % kTile;
            const int f = f0 + kk0 + kk, c = t * kTile + n;
            Bs[kk * kLdB + n] =
                (f < d_ff && c < d) ? round_to<T>(w2[(size_t)f * d + c]) : 0.f;
          }
          __syncthreads();
          mma_tile(out[t], Hs + kk0, kLdB, Bs, kLdB, kChunk);
          __syncthreads();
        }
      }
    }
  }

#pragma unroll
  for (int t = 0; t < 4; ++t) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, n = t * kTile + tx + 16 * j;
        if (r < rows && n < d)
          yt[(size_t)r * d + n] = from_float<T>(
              to_float(xt[(size_t)r * d + n]) + (out[t][i][j] + b2[n]));
      }
    }
  }
}

template <class T>
int launch(const void* x, const void* ln_scale, const void* ln_bias,
           const void* w1, const void* b1, const void* w2, const void* b2,
           void* y, int M, int d, int d_ff, cudaStream_t stream) {
  const size_t smem =
      (kChunk * kLdB + kTile * kLdB + 2 * kTile + kTile * (d + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kTile - 1) / kTile);
  ffn_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<T*>(y), M, d, d_ff);
  return cudaGetLastError();
}

}  // namespace
}  // namespace allrank

// Launches the kernel on `stream`; returns 0 or the CUDA error code. x and y
// are [M, d] in x's dtype (bf16 if is_bf16, else fp32), M = B * L;
// parameters are fp32, w1 [d, d_ff], w2 [d_ff, d]; d <= 256.
extern "C" int ffn_sublayer_fwd(const void* x, const void* ln_scale,
                                const void* ln_bias, const void* w1,
                                const void* b1, const void* w2, const void* b2,
                                void* y, int M, int d, int d_ff, int is_bf16,
                                void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return allrank::launch<__nv_bfloat16>(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                          y, M, d, d_ff, s);
  return allrank::launch<float>(x, ln_scale, ln_bias, w1, b1, w2, b2, y, M, d,
                                d_ff, s);
}
