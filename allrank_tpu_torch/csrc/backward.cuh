// Pieces shared by the sublayer backward kernels: the LayerNorm backward of a
// 64-row tile, and the weight-gradient reductions over all B * L rows.
//
// The TPU kernels add each grid step's parameter gradients into fp32 output
// blocks, which is race-free there because a TPU grid runs in order. Blocks
// of a GPU grid run in no order, so every cross-block sum here is two
// passes: each block writes its partial sums, and reduce_partials_kernel
// adds them in a fixed order. No atomics: two backwards of the same batch
// give the same bits.
#pragma once

#include "common.cuh"

namespace allrank {

// The unbiased-std LayerNorm backward of rows [0, rows) of one tile, as the
// TPU kernels take it (allrank_tpu/ops/attention_block.py:239-253): with
// xhat = (x - mean) / denom, denom = sqrt(max(var, 1e-24)) + eps and dn the
// gradient at the LN output (smem, pitch ldn),
//   c = xhat * denom, proj = sum(dn * g * c),
//   dc = dn * g / denom - [var > 1e-24] * c * proj / ((d-1) * s * denom^2),
//   dx = round(dy + dc - mean(dc)),
// with dy = 0 where `dy` is null (a LayerNorm with no residual around it,
// such as the encoder's final one). One warp per row; then one thread per
// column writes the tile's partial sums part[0:d] = sum_r dn * xhat (dg)
// and part[d:2d] = sum_r dn (db). rmean / rden are [kTile] smem scratch.
template <class T>
__device__ void ln_backward_tile(const T* x, const T* dy, T* dx,
                                 const float* dn, int ldn, int rows, int d,
                                 const float* __restrict__ g, float* part,
                                 float* rmean, float* rden) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kThreads / 32) {
    const T* xr = x + (size_t)r * d;
    const float* dnr = dn + (size_t)r * ldn;
    float mu, var;
    row_moments(xr, d, mu, var);
    const float s = sqrtf(fmaxf(var, kVarFloor));
    const float denom = s + kLnEps;
    const float rd = 1.f / denom;
    const float gate = var > kVarFloor ? 1.f : 0.f;
    float proj = 0.f;
    for (int k = lane; k < d; k += 32) {
      const float c = (to_float(xr[k]) - mu) * rd * denom;
      proj += dnr[k] * g[k] * c;
    }
    proj = warp_sum(proj);
    const float den2 = (float)(d - 1) * s * denom * denom;
    float sum_dc = 0.f;
    for (int k = lane; k < d; k += 32) {
      const float c = (to_float(xr[k]) - mu) * rd * denom;
      sum_dc += dnr[k] * g[k] / denom - gate * c * proj / den2;
    }
    const float mean_dc = warp_sum(sum_dc) / (float)d;
    for (int k = lane; k < d; k += 32) {
      const float c = (to_float(xr[k]) - mu) * rd * denom;
      const float dc = dnr[k] * g[k] / denom - gate * c * proj / den2;
      const float res = dy != nullptr ? to_float(dy[(size_t)r * d + k]) : 0.f;
      dx[(size_t)r * d + k] = from_float<T>(res + (dc - mean_dc));
    }
    if (lane == 0) {
      rmean[r] = mu;
      rden[r] = rd;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float dg = 0.f, db = 0.f;
    for (int r = 0; r < rows; ++r) {
      const float v = dn[(size_t)r * ldn + c];
      dg += v * ((to_float(x[(size_t)r * d + c]) - rmean[r]) * rden[r]);
      db += v;
    }
    part[c] = dg;
    part[d + c] = db;
  }
}

// Split `split` of C = A^T . B and of colsum(B), for A [M, K] and B [M, N]
// in T (row-major), output tile (k_tile, n_tile): part[split] holds C's
// partial [K, N] followed by colsum's [N], summed over rows [split *
// rows_per_split, (split + 1) * rows_per_split). Only the tiles of the first
// K tile add the column sums. Products are fp32 FMAs on 64 x 64 register
// tiles (common.cuh), A staged transposed in shared memory (`smem`,
// atb_smem_floats()).
__host__ __device__ constexpr int atb_smem_floats() {
  return kTile * kLdA + kChunk * kLdB;
}

template <class T>
__device__ void atb_partial_tile(float* smem, const T* A, const T* B,
                                 float* part, int M, int K, int N,
                                 int rows_per_split, int k_tile, int n_tile,
                                 int split) {
  float* As = smem;               // [64 k][kChunk m]
  float* Bs = As + kTile * kLdA;  // [kChunk m][64 n]
  const int k0 = k_tile * kTile, n0 = n_tile * kTile;
  const int m_begin = split * rows_per_split;
  const int m_end = min(M, m_begin + rows_per_split);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const bool col_sums = k_tile == 0;
  float acc[4][4] = {};
  float csum = 0.f;
  for (int m0 = m_begin; m0 < m_end; m0 += kChunk) {
    for (int e = tid; e < kChunk * kTile; e += kThreads) {
      const int mm = e / kTile, kk = e % kTile, m = m0 + mm;
      As[kk * kLdA + mm] = (m < m_end && k0 + kk < K)
                               ? to_float(A[(size_t)m * K + k0 + kk])
                               : 0.f;
      Bs[mm * kLdB + kk] = (m < m_end && n0 + kk < N)
                               ? to_float(B[(size_t)m * N + n0 + kk])
                               : 0.f;
    }
    __syncthreads();
    mma_tile(acc, As, kLdA, Bs, kLdB, kChunk);
    if (col_sums && tid < kTile)
      for (int mm = 0; mm < kChunk; ++mm) csum += Bs[mm * kLdB + tid];
    __syncthreads();
  }
  float* out = part + (size_t)split * ((size_t)K * N + N);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (k < K && n < N) out[(size_t)k * N + n] = acc[i][j];
    }
  }
  if (col_sums && tid < kTile && n0 + tid < N)
    out[(size_t)K * N + n0 + tid] = csum;
}

template <class T>
__global__ void __launch_bounds__(kThreads)
    atb_partial_kernel(const T* __restrict__ A, const T* __restrict__ B,
                       float* __restrict__ part, int M, int K, int N,
                       int rows_per_split) {
  __shared__ float smem[atb_smem_floats()];
  atb_partial_tile(smem, A, B, part, M, K, N, rows_per_split, blockIdx.x,
                   blockIdx.y, blockIdx.z);
}

// Rows of a split A^T . B: ceil(M / splits) rounded up to whole chunks.
__host__ __device__ inline int split_rows(int M, int splits) {
  const int rows = (M + splits - 1) / splits;
  return (rows + kChunk - 1) / kChunk * kChunk;
}

// out0[i] (i < n0) and out1[i - n0] (n0 <= i < n0 + n1) = the sum over
// s < splits of part[s * (n0 + n1) + i], in order of s, for the kThreads
// values i of chunk `tile`.
__device__ __forceinline__ void reduce_partials_tile(const float* part,
                                                     int splits, float* out0,
                                                     int n0, float* out1,
                                                     int n1, int tile) {
  const int n = n0 + n1;
  const int i = tile * kThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += part[(size_t)sp * n + i];
  if (i < n0)
    out0[i] = s;
  else
    out1[i - n0] = s;
}

__global__ void __launch_bounds__(kThreads)
    reduce_partials_kernel(const float* __restrict__ part, int splits,
                           float* __restrict__ out0, int n0,
                           float* __restrict__ out1, int n1) {
  reduce_partials_tile(part, splits, out0, n0, out1, n1, blockIdx.x);
}

inline cudaError_t launch_reduce(const float* part, int splits, float* out0,
                                 int n0, float* out1, int n1,
                                 cudaStream_t stream) {
  const int n = n0 + n1;
  reduce_partials_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                           stream>>>(part, splits, out0, n0, out1, n1);
  return cudaGetLastError();
}

// dW = A^T . B [K, N] and db = colsum(B) [N], through `splits` partial sums
// in `part` ([splits, K * N + N] fp32 scratch).
template <class T>
cudaError_t launch_weight_grad(const T* A, const T* B, float* part, float* dw,
                               float* db, int M, int K, int N, int splits,
                               cudaStream_t stream) {
  const dim3 grid((K + kTile - 1) / kTile, (N + kTile - 1) / kTile, splits);
  atb_partial_kernel<T><<<grid, kThreads, 0, stream>>>(
      A, B, part, M, K, N, split_rows(M, splits));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(part, splits, dw, K * N, db, N, stream);
}

}  // namespace allrank
