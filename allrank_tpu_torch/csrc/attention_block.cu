// Attention sublayer forward for Hopper (sm_90a), fp32 or bf16 activations:
//   y = x + (MHA(LN(x) . Wqkv + bqkv) . Wout + bout)
// with the unbiased-std LayerNorm, scores scaled by 1/sqrt(d_k), padded keys
// filled with -1e9 before a max-subtracted softmax, and the residual added
// in fp32.
//
// Replaces the TPU kernel `attention_sublayer` of the JAX package's
// ops/attention_block.py (forward pallas_call at line 343, math in
// attn_sublayer_fwd_vmem, lines 122-144), at dropout rate 0.
//
// What bounds it: the products. At the flagship serving shape (B=64, L=240,
// d=128, h=4) one call does about 3.9 GFLOP on 7.9 MB of fp32 activations in
// and out, some 500 FLOP per byte, so on this card it is bound by operations,
// not by memory.
//
// What the design does about it, and about the TPU kernel's assumptions:
//  * The TPU kernel keeps whole slates in many MB of VMEM. A block here has
//    227 KB, less than one head's [240, 240] fp32 probability tile. So the
//    sublayer is two kernels: ln_qkv (LN + QKV projection over 64-row tiles,
//    writing qkv [B, L, 3d] in x's dtype, the one intermediate in device
//    memory) and attn_out (one block per slate and 64-query tile). attn_out
//    walks the keys in tiles of 64 and never holds more than a 64 x 64 score
//    tile: a first pass takes the running row max and sum, a second
//    recomputes the scores, forms the probabilities exactly as the TPU kernel
//    does (exp(s - max) / sum, rounded to x's dtype) and accumulates P.V.
//  * The out-projection sums over heads. attn_out loops over the heads and
//    keeps ctx for all of them in shared memory, then multiplies by Wout in
//    the same block: no atomics, no second pass over device memory.
//  * L = 240 is not a multiple of 64, and d_k of 72 or 96 not a power of two:
//    every staged load masks its edge with zeros, keys past L get -inf
//    (weight 0) and padded keys -1e9, so a fully padded slate gets a uniform
//    softmax, never NaN.
//  * Products run as fp32 FMAs on 64 x 64 register tiles (common.cuh); the
//    bf16 rounding points are the TPU kernel's: LN output, qkv,
//    probabilities, ctx. Tensor cores (wgmma) are later work.
#include "common.cuh"

namespace allrank {
namespace {

// qkv[m, :] = round(round(LN(x[m, :])) . round(Wqkv) + bqkv) for a 64-row by
// 64-column tile of the [M, 3d] output.
template <class T>
__global__ void __launch_bounds__(kThreads)
    ln_qkv_kernel(const T* __restrict__ x, const float* __restrict__ ln_scale,
                  const float* __restrict__ ln_bias,
                  const float* __restrict__ wqkv,
                  const float* __restrict__ bqkv, T* __restrict__ qkv, int M,
                  int d) {
  extern __shared__ float smem[];
  float* As = smem;                  // [kTile][kLdA]  LN(x) chunk
  float* Bs = As + kTile * kLdA;     // [kChunk][kLdB] Wqkv chunk
  float* mean = Bs + kChunk * kLdB;  // [kTile]
  float* rdenom = mean + kTile;      // [kTile]
  const int n_out = 3 * d;
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const int rows = min(kTile, M - m0);
  const T* xt = x + (size_t)m0 * d;

  ln_row_stats(xt, rows, d, mean, rdenom);
  __syncthreads();

  float acc[4][4] = {};
  for (int k0 = 0; k0 < d; k0 += kChunk) {
    for (int e = threadIdx.x; e < kTile * kChunk; e += kThreads) {
      const int r = e / kChunk, kk = e % kChunk, k = k0 + kk;
      float v = 0.f;
      if (r < rows && k < d)
        v = round_to<T>((to_float(xt[(size_t)r * d + k]) - mean[r]) *
                            rdenom[r] * ln_scale[k] +
                        ln_bias[k]);
      As[r * kLdA + kk] = v;
    }
    for (int e = threadIdx.x; e < kChunk * kTile; e += kThreads) {
      const int kk = e / kTile, n = e % kTile, k = k0 + kk;
      Bs[kk * kLdB + n] = (k < d && n0 + n < n_out)
                              ? round_to<T>(wqkv[(size_t)k * n_out + n0 + n])
                              : 0.f;
    }
    __syncthreads();
    mma_tile(acc, As, kLdA, Bs, kLdB, kChunk);
    __syncthreads();
  }

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i, n = n0 + tx + 16 * j;
      if (r < rows && n < n_out)
        qkv[(size_t)(m0 + r) * n_out + n] = from_float<T>(acc[i][j] + bqkv[n]);
    }
  }
}

// y[q0:q0+64] of one slate: attention over all heads, then the
// out-projection, its bias and the residual.
template <class T>
__global__ void __launch_bounds__(kThreads)
    attn_out_kernel(const T* __restrict__ qkv,
                    const unsigned char* __restrict__ key_mask,
                    const T* __restrict__ x, const float* __restrict__ wout,
                    const float* __restrict__ bout, T* __restrict__ y, int L,
                    int d, int h, float scale) {
  extern __shared__ float smem[];
  float* As = smem;                    // [kTile][kLdA]  query chunk
  float* Bs = As + kTile * kLdA;       // [kChunk][kLdB] key, value or Wout chunk
  float* Ps = Bs + kChunk * kLdB;      // [kTile][kLdB]  scores, then probabilities
  float* row_max = Ps + kTile * kLdB;  // [kTile]
  float* row_sum = row_max + kTile;    // [kTile]
  float* Cs = row_sum + kTile;         // [kTile][d + 1] ctx of all heads
  const int ldc = d + 1;
  const int dk = d / h, ld = 3 * d;
  const int slate = blockIdx.y, q0 = blockIdx.x * kTile;
  const int rows = min(kTile, L - q0);
  const T* base = qkv + (size_t)slate * L * ld;
  const unsigned char* padded = key_mask + (size_t)slate * L;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  for (int e = tid; e < kTile * ldc; e += kThreads) Cs[e] = 0.f;

  for (int head = 0; head < h; ++head) {
    const int qoff = head * dk, koff = d + head * dk, voff = 2 * d + head * dk;
    if (tid < kTile) {
      row_max[tid] = -INFINITY;
      row_sum[tid] = 0.f;
    }
    __syncthreads();
    // pass 0: row max and sum of exp; pass 1: probabilities and P.V
    for (int pass = 0; pass < 2; ++pass) {
      for (int k0 = 0; k0 < L; k0 += kTile) {
        float acc[4][4] = {};
        for (int c0 = 0; c0 < dk; c0 += kChunk) {
          for (int e = tid; e < kTile * kChunk; e += kThreads) {
            const int r = e / kChunk, kk = e % kChunk, c = c0 + kk;
            As[r * kLdA + kk] =
                (r < rows && c < dk)
                    ? to_float(base[(size_t)(q0 + r) * ld + qoff + c])
                    : 0.f;
          }
          // keys go along the tile's columns: read along d_k, store
          // transposed (the padded pitch keeps the stores conflict-free)
          for (int e = tid; e < kTile * kChunk; e += kThreads) {
            const int n = e / kChunk, kk = e % kChunk, c = c0 + kk;
            Bs[kk * kLdB + n] =
                (k0 + n < L && c < dk)
                    ? to_float(base[(size_t)(k0 + n) * ld + koff + c])
                    : 0.f;
          }
          __syncthreads();
          mma_tile(acc, As, kLdA, Bs, kLdB, kChunk);
          __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = tx + 16 * j, key = k0 + c;
            float s = acc[i][j] * scale;
            if (key >= L)
              s = -INFINITY;
            else if (padded[key])
              s = kNegInfFill;
            Ps[(ty + 16 * i) * kLdB + c] = s;
          }
        }
        __syncthreads();
        if (pass == 0) {
          // four neighbouring lanes per row, 16 keys each
          const int r = tid / 4, part = tid % 4;
          const float* prow = Ps + r * kLdB + part * 16;
          float tmax = -INFINITY;
          for (int c = 0; c < 16; ++c) tmax = fmaxf(tmax, prow[c]);
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
          const float old_max = row_max[r];
          const float new_max = fmaxf(old_max, tmax);
          float tsum = 0.f;
          for (int c = 0; c < 16; ++c) tsum += expf(prow[c] - new_max);
          tsum += __shfl_xor_sync(0xffffffffu, tsum, 1);
          tsum += __shfl_xor_sync(0xffffffffu, tsum, 2);
          __syncwarp();  // the row's four lanes have read row_max[r]
          if (part == 0) {
            row_sum[r] = row_sum[r] * expf(old_max - new_max) + tsum;
            row_max[r] = new_max;
          }
        } else {
          for (int e = tid; e < kTile * kTile; e += kThreads) {
            const int r = e / kTile, c = e % kTile;
            Ps[r * kLdB + c] = round_to<T>(expf(Ps[r * kLdB + c] - row_max[r]) *
                                           (1.f / row_sum[r]));
          }
          __syncthreads();
          for (int t0 = 0; t0 < dk; t0 += kTile) {
            float cacc[4][4] = {};
            for (int kk0 = 0; kk0 < kTile; kk0 += kChunk) {
              for (int e = tid; e < kChunk * kTile; e += kThreads) {
                const int kk = e / kTile, n = e % kTile;
                const int key = k0 + kk0 + kk, c = t0 + n;
                Bs[kk * kLdB + n] =
                    (key < L && c < dk)
                        ? to_float(base[(size_t)key * ld + voff + c])
                        : 0.f;
              }
              __syncthreads();
              mma_tile(cacc, Ps + kk0, kLdB, Bs, kLdB, kChunk);
              __syncthreads();
            }
            // each (row, column) of ctx belongs to one thread throughout
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int c = t0 + tx + 16 * j;
                if (c < dk) Cs[(ty + 16 * i) * ldc + qoff + c] += cacc[i][j];
              }
            }
          }
        }
        __syncthreads();
      }
    }
  }

  for (int e = tid; e < kTile * d; e += kThreads) {
    const int r = e / d, c = e % d;
    Cs[r * ldc + c] = round_to<T>(Cs[r * ldc + c]);
  }
  __syncthreads();

  const size_t row0 = (size_t)slate * L + q0;
  const T* xt = x + row0 * d;
  T* yt = y + row0 * d;
  for (int n0 = 0; n0 < d; n0 += kTile) {
    float acc[4][4] = {};
    for (int k0 = 0; k0 < d; k0 += kChunk) {
      const int depth = min(kChunk, d - k0);
      for (int e = tid; e < kChunk * kTile; e += kThreads) {
        const int kk = e / kTile, n = e % kTile;
        Bs[kk * kLdB + n] =
            (kk < depth && n0 + n < d)
                ? round_to<T>(wout[(size_t)(k0 + kk) * d + n0 + n])
                : 0.f;
      }
      __syncthreads();
      mma_tile(acc, Cs + k0, ldc, Bs, kLdB, depth);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, n = n0 + tx + 16 * j;
        if (r < rows && n < d)
          yt[(size_t)r * d + n] = from_float<T>(
              to_float(xt[(size_t)r * d + n]) + (acc[i][j] + bout[n]));
      }
    }
  }
}

template <class T>
int launch(const void* x, const void* key_mask, const void* ln_scale,
           const void* ln_bias, const void* wqkv, const void* bqkv,
           const void* wout, const void* bout, void* qkv, void* y, int batch,
           int L, int d, int h, float scale, cudaStream_t stream) {
  const int M = batch * L;
  const size_t smem1 = (kTile * kLdA + kChunk * kLdB + 2 * kTile) * sizeof(float);
  const dim3 grid1((M + kTile - 1) / kTile, (3 * d + kTile - 1) / kTile);
  ln_qkv_kernel<T><<<grid1, kThreads, smem1, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const float*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<T*>(qkv), M, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem2 =
      (kTile * kLdA + kChunk * kLdB + kTile * kLdB + 2 * kTile + kTile * (d + 1)) *
      sizeof(float);
  err = cudaFuncSetAttribute(attn_out_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return err;
  const dim3 grid2((L + kTile - 1) / kTile, batch);
  attn_out_kernel<T><<<grid2, kThreads, smem2, stream>>>(
      static_cast<const T*>(qkv), static_cast<const unsigned char*>(key_mask),
      static_cast<const T*>(x), static_cast<const float*>(wout),
      static_cast<const float*>(bout), static_cast<T*>(y), L, d, h, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace allrank

// Launches both kernels on `stream`; returns 0 or the CUDA error code.
// x, qkv (scratch [B, L, 3d]) and y are in x's dtype (bf16 if is_bf16, else
// fp32); key_mask is [B, L] bytes, non-zero at padded documents; parameters
// are fp32.
extern "C" int attention_sublayer_fwd(const void* x, const void* key_mask,
                                      const void* ln_scale, const void* ln_bias,
                                      const void* wqkv, const void* bqkv,
                                      const void* wout, const void* bout,
                                      void* qkv, void* y, int batch, int L,
                                      int d, int h, float scale, int is_bf16,
                                      void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return allrank::launch<__nv_bfloat16>(x, key_mask, ln_scale, ln_bias, wqkv,
                                          bqkv, wout, bout, qkv, y, batch, L, d,
                                          h, scale, s);
  return allrank::launch<float>(x, key_mask, ln_scale, ln_bias, wqkv, bqkv,
                                wout, bout, qkv, y, batch, L, d, h, scale, s);
}
