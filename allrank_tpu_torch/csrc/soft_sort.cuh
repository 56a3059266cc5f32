// The fused NeuralNDCG soft-sort kernels of B8's route "l2", forward and
// backward, instantiated by neuralsort.cu, whose header describes the math
// and the design. The records live in device memory. The template parameter
// kOnChip is a leftover of a records-on-chip variant (now neuralsort_layout.cu
// on B8's route "cluster"); only kOnChip = false is instantiated, and the
// parameter stays because it is part of the kernels' names.
#pragma once

#include <cuda_runtime.h>

#include "sinkhorn.cuh"

namespace allrank {
namespace {

constexpr float kNegFill = -1e8f;

struct Chain {  // the slate's O(L) vectors in shared memory
  float *s_f, *s_z, *valid, *rs, *scaling, *vec;
};
constexpr int kChainVectors = 6;

__device__ __forceinline__ float pair_valid(const Chain& c, int i, int j) {
  return c.valid[i] * c.valid[j];
}

// Fills the chain's vectors and writes M0 [L, L] to device memory.
__device__ inline Chain neural_sort_chain(const float* s, const float* pad,
                                          const float* vec, int L, float tau,
                                          float*& smem, float* M) {
  Chain c;
  c.s_f = take(smem, L);
  c.s_z = take(smem, L);
  c.valid = take(smem, L);
  c.rs = take(smem, L);
  c.scaling = take(smem, L);
  c.vec = take(smem, L);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j = threadIdx.x; j < L; j += kSinkThreads) {
    const bool padded = pad[j] > 0.5f;
    const float valid = 1.f - pad[j];
    c.valid[j] = valid;
    c.s_f[j] = padded ? kNegFill : s[j];
    c.s_z[j] = s[j] * valid;
    c.vec[j] = vec[j];
  }
  __syncthreads();
  float valid_n = 0.f;  // every warp takes the same sum in the same order
  for (int j = lane; j < L; j += 32) valid_n += c.valid[j];
  valid_n = warp_sum(valid_n);
  for (int j = threadIdx.x; j < L; j += kSinkThreads) {
    const float rank = (float)(j + 1);
    c.scaling[j] = rank <= valid_n ? valid_n + 1.f - 2.f * rank : 0.f;
  }
  row_reduce(L, [&](int j, int k) {
    return fabsf(c.s_f[j] - c.s_f[k]) * pair_valid(c, j, k);
  }, c.rs);
  __syncthreads();
  // row i of M0: the softmax over the valid columns, or the pad fills
  for (int i = warp; i < L; i += kSinkWarps) {
    float* row = M + (size_t)i * L;
    if (c.valid[i] < 0.5f) {
      for (int j = lane; j < L; j += 32)
        row[j] = c.valid[j] < 0.5f ? 1.f : 0.f;
      continue;
    }
    const float sc = c.scaling[i];
    float z_max = -INFINITY;
    for (int j = lane; j < L; j += 32)
      if (c.valid[j] > 0.5f)
        z_max = fmaxf(z_max, (sc * c.s_z[j] - c.rs[j]) / tau);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      z_max = fmaxf(z_max, __shfl_xor_sync(0xffffffffu, z_max, o));
    float sum = 0.f;
    for (int j = lane; j < L; j += 32)
      if (c.valid[j] > 0.5f)
        sum += expf((sc * c.s_z[j] - c.rs[j]) / tau - z_max);
    sum = warp_sum(sum);
    for (int j = lane; j < L; j += 32)
      row[j] = c.valid[j] > 0.5f
                   ? expf((sc * c.s_z[j] - c.rs[j]) / tau - z_max) / sum
                   : 0.f;
  }
  __syncthreads();
  return c;
}

// The loop writes each record row straight to the outputs. The launch
// bounds give no minBlocks (0).
template <bool kOnChip>
__global__ void __launch_bounds__(kSinkThreads, kOnChip ? 1 : 0)
    soft_sort_fwd_kernel(const float* __restrict__ s,
                         const float* __restrict__ pad,
                         const float* __restrict__ vec, float* m_scratch,
                         float* __restrict__ out, float* __restrict__ a_hist,
                         float* __restrict__ b_hist, int n, int L, int T,
                         float tau, int transpose) {
  extern __shared__ float smem_base[];
  float* M = m_scratch + (size_t)blockIdx.x * L * L;
  for (int slate = blockIdx.x; slate < n; slate += gridDim.x) {
    const size_t o = (size_t)slate * L;
    float* smem = smem_base;
    const Chain c = neural_sort_chain(s + o, pad + o, vec + o, L, tau, smem,
                                      M);
    float* a_rec = a_hist + o * (T + 1);
    float* b_rec = b_hist + o * (T + 1);
    float *a, *b;
    sinkhorn_forward(M, L, T, smem, a, b, a_rec, b_rec);
    // p = a (.) M0 (.) b masked to the valid pairs, contracted with vec
    if (transpose) {
      float* partial = take(smem, kSinkGroups * L);
      col_reduce(L, [&](int i, int j) {
        return a[i] * M[(size_t)i * L + j] * b[j] * pair_valid(c, i, j) *
               c.vec[i];
      }, out + o, partial);
    } else {
      row_reduce(L, [&](int i, int j) {
        return a[i] * M[(size_t)i * L + j] * b[j] * pair_valid(c, i, j) *
               c.vec[j];
      }, out + o);
    }
    __syncthreads();
  }
}
constexpr int kSoftSortFwdVectors =
    kChainVectors + kSinkFwdVectors + kSinkGroups;

__device__ __forceinline__ float sign_of(float d) {
  return (float)((d > 0.f) - (d < 0.f));
}

// The reverse pass reads the records from the inputs and keeps its U and V
// stacks in `uv`.
template <bool kOnChip>
__global__ void __launch_bounds__(kSinkThreads, kOnChip ? 1 : 0)
    soft_sort_bwd_kernel(const float* __restrict__ s,
                         const float* __restrict__ pad,
                         const float* __restrict__ vec,
                         const float* __restrict__ a_hist,
                         const float* __restrict__ b_hist,
                         const float* __restrict__ dout, float* m_scratch,
                         float* uv, float* __restrict__ ds, int n, int L,
                         int T, float tau, int transpose) {
  extern __shared__ float smem_base[];
  float* M = m_scratch + (size_t)blockIdx.x * 2 * L * L;
  float* dM = M + (size_t)L * L;
  float* U = uv + (size_t)blockIdx.x * 2 * T * L;
  float* V = U + (size_t)T * L;
  for (int slate = blockIdx.x; slate < n; slate += gridDim.x) {
    const size_t o = (size_t)slate * L;
    float* smem = smem_base;
    const Chain c = neural_sort_chain(s + o, pad + o, vec + o, L, tau, smem,
                                      M);
    float* go = take(smem, L);
    for (int j = threadIdx.x; j < L; j += kSinkThreads) go[j] = dout[o + j];
    __syncthreads();
    // the contraction's cotangent, gated by the mask after the scaling
    auto dp = [&](int i, int j) {
      return (transpose ? go[j] * c.vec[i] : go[i] * c.vec[j]) *
             pair_valid(c, i, j);
    };
    const float* a_rec = a_hist + o * (T + 1);
    const float* b_rec = b_hist + o * (T + 1);
    sinkhorn_backward(M, L, T, dp, a_rec, b_rec, U, V, dM, smem);
    // the reverse pass's vectors are free again
    float* inner = take(smem, L);
    float* ds_zero = take(smem, L);
    float* drs = take(smem, L);
    float* sgn_sum = take(smem, L);
    float* drs_sgn = take(smem, L);
    float* partial = take(smem, kSinkGroups * L);
    // softmax over the row: inner_i = sum_j dP_hat P_hat, with P_hat = M0
    // and dP_hat = dM0 on the valid pairs (the pad fills are constants)
    row_reduce(L, [&](int i, int j) {
      const size_t e = (size_t)i * L + j;
      return dM[e] * pair_valid(c, i, j) * M[e];
    }, inner);
    __syncthreads();
    auto dpm = [&](int i, int j) {
      const size_t e = (size_t)i * L + j;
      const float pv = pair_valid(c, i, j);
      return (dM[e] * pv - inner[i]) * M[e] / tau * pv;
    };
    // pm[i, j] = scaling[i] * s_z[j] - rs[j]
    col_reduce(L, [&](int i, int j) { return dpm(i, j) * c.scaling[i]; },
               ds_zero, partial);
    __syncthreads();
    col_reduce(L, [&](int i, int j) { return -dpm(i, j); }, drs, partial);
    __syncthreads();
    // rs[j] = sum_k |s_f[j] - s_f[k]| over valid pairs
    row_reduce(L, [&](int j, int k) {
      return sign_of(c.s_f[j] - c.s_f[k]) * pair_valid(c, j, k);
    }, sgn_sum);
    row_reduce(L, [&](int j, int k) {
      return drs[k] * (sign_of(c.s_f[k] - c.s_f[j]) * pair_valid(c, k, j));
    }, drs_sgn);
    __syncthreads();
    for (int j = threadIdx.x; j < L; j += kSinkThreads)
      ds[o + j] = (ds_zero[j] + (drs[j] * sgn_sum[j] - drs_sgn[j])) *
                  c.valid[j];
    __syncthreads();
  }
}
// the epilogue's 5 + kSinkGroups vectors fit in the reverse pass's room
constexpr int kSoftSortBwdVectors = kChainVectors + 1 + kSinkBwdVectors;
static_assert(5 + kSinkGroups <= kSinkBwdVectors, "epilogue room");

template <class K>
int prepare(K kernel, int vectors, int L) {
  const int bytes = vectors * L * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return err == cudaSuccess ? bytes : -(int)err;
}

}  // namespace
}  // namespace allrank
