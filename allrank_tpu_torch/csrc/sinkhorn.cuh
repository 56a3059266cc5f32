// The fixed-trip Sinkhorn iteration and its reverse pass, shared by the
// Sinkhorn kernel (sinkhorn.cu) and the fused soft-sort kernel
// (neuralsort.cu), as `sinkhorn_loop` and `sinkhorn_bwd_core` are shared by
// the two TPU kernels of the JAX package (ops/sinkhorn_pallas.py:88, :152).
//
// Any sequence of row and column scalings is P = diag(a) M0 diag(b); one
// iteration is
//   c = b * (M0^T a);  b <- c == 0 ? b : min(b / max(c, eps), cap)
//   r = a * (M0 b);    a <- r == 0 ? a : min(a / max(r, eps), cap)
// always `T` iterations, with every (a_t, b_t) recorded for the reverse pass.
// The reverse pass rebuilds each iteration's matvec values from the records
// by true division (m_r = a_{t-1} / a_t, M0 b_t = m_r / a_{t-1}), applies M0
// to the two new cotangent vectors, and collects
//   dM0 = dP * outer(a_T, b_T) + sum_t outer(u_t, b_t) + outer(a_{t-1}, v_t).
//
// One block of 1024 threads works on one slate. On the TPU the point of the
// kernel is M0 [L, L] resident in fast memory; here a block's shared memory
// (232,448 B) cannot hold 240 x 240 fp32 (230,400 B) beside anything else,
// and not at all from L = 241, so M0 stays in device memory and the block
// re-reads it on every half-iteration: a slate's 230 KB sits in the 50 MB L2
// while its block loops. Both matvec directions read M0 row-major: M0 b is
// a warp per row with the lanes along the row; M0^T a is a thread per
// column walking a group of rows (eight row groups, their partial sums added
// in a fixed order). The vectors live in shared memory, the records go
// straight to device memory (they are outputs).
//
// Every sum is an fp32 FMA chain in a fixed order (no atomics, no TF32), and
// every division is a true division: the recurrence compounds over 50
// iterations and its gradient cancels heavily.
#pragma once

#include "common.cuh"

namespace allrank {

constexpr int kSinkThreads = 1024;
constexpr int kSinkWarps = kSinkThreads / 32;
constexpr int kSinkGroups = 8;  // row groups of a column sum
constexpr float kSinkEps = 1e-10f;
constexpr float kScalingCap = 1e15f;
// the clamp max(., eps) passes gradient only where it is inactive
constexpr float kClampGate = (float)(1e-10 * 1.0001);

__device__ __forceinline__ float* take(float*& p, int n) {
  float* out = p;
  p += n;
  return out;
}

// y[i] = sum_j f(i, j) for i < L: a warp per row, lanes along the row.
template <class F>
__device__ __forceinline__ void row_reduce(int L, F f, float* y) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < L; i += kSinkWarps) {
    float acc = 0.f;
    for (int j = lane; j < L; j += 32) acc += f(i, j);
    acc = warp_sum(acc);
    if (lane == 0) y[i] = acc;
  }
}

// y[j] = sum_i f(i, j) for j < L: thread (g, j) sums the rows of group g,
// neighbouring threads on neighbouring columns; `partial` holds
// kSinkGroups * L floats. Ends with every y[j] written by thread j % 1024.
template <class F>
__device__ __forceinline__ void col_reduce(int L, F f, float* y,
                                           float* partial) {
  const int rows = (L + kSinkGroups - 1) / kSinkGroups;
  for (int idx = threadIdx.x; idx < kSinkGroups * L; idx += kSinkThreads) {
    const int g = idx / L, j = idx - g * L;
    const int i1 = min(L, (g + 1) * rows);
    float acc = 0.f;
#pragma unroll 4
    for (int i = g * rows; i < i1; ++i) acc += f(i, j);
    partial[idx] = acc;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < L; j += kSinkThreads) {
    float acc = 0.f;
#pragma unroll
    for (int g = 0; g < kSinkGroups; ++g) acc += partial[g * L + j];
    y[j] = acc;
  }
}

__device__ __forceinline__ float rescale(float s, float sum) {
  return sum == 0.f ? s : fminf(s / fmaxf(sum, kSinkEps), kScalingCap);
}

// The shared-memory vectors of the forward loop: 3 + kSinkGroups of length L.
constexpr int kSinkFwdVectors = 3 + kSinkGroups;

// T iterations on M [L, L] (device memory); leaves the final scalings in
// `a` and `b` (shared memory, returned) and writes rows 0..T of a_hist and
// b_hist [T + 1, L].
__device__ inline void sinkhorn_forward(const float* M, int L, int T,
                                        float*& smem, float*& a, float*& b,
                                        float* a_hist, float* b_hist) {
  a = take(smem, L);
  b = take(smem, L);
  float* tmp = take(smem, L);
  float* partial = take(smem, kSinkGroups * L);
  for (int i = threadIdx.x; i < L; i += kSinkThreads) {
    a[i] = 1.f;
    b[i] = 1.f;
    a_hist[i] = 1.f;
    b_hist[i] = 1.f;
  }
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    col_reduce(L, [&](int i, int j) { return M[(size_t)i * L + j] * a[i]; },
               tmp, partial);
    __syncthreads();
    for (int j = threadIdx.x; j < L; j += kSinkThreads) {
      const float b2 = rescale(b[j], b[j] * tmp[j]);
      b[j] = b2;
      b_hist[(size_t)(t + 1) * L + j] = b2;
    }
    __syncthreads();
    row_reduce(L, [&](int i, int j) { return M[(size_t)i * L + j] * b[j]; },
               tmp);
    __syncthreads();
    for (int i = threadIdx.x; i < L; i += kSinkThreads) {
      const float a2 = rescale(a[i], a[i] * tmp[i]);
      a[i] = a2;
      a_hist[(size_t)(t + 1) * L + i] = a2;
    }
    __syncthreads();
  }
}

// The shared-memory vectors of the reverse pass.
constexpr int kSinkBwdVectors = 7 + kSinkGroups;

// dM [L, L] (device memory) from the output cotangent dp(i, j), M and the
// records. U and V are [T, L] stacks in device memory, written here.
template <class DP>
__device__ inline void sinkhorn_backward(const float* M, int L, int T, DP dp,
                                         const float* a_hist,
                                         const float* b_hist, float* U,
                                         float* V, float* dM, float* smem) {
  float* a_t = take(smem, L);
  float* b_t = take(smem, L);
  float* a_p = take(smem, L);
  float* da = take(smem, L);
  float* db = take(smem, L);
  float* w = take(smem, L);
  float* tmp = take(smem, L);
  float* partial = take(smem, kSinkGroups * L);
  const float* a_T = a_hist + (size_t)T * L;
  const float* b_T = b_hist + (size_t)T * L;
  for (int i = threadIdx.x; i < L; i += kSinkThreads) {
    a_t[i] = a_T[i];
    b_t[i] = b_T[i];
  }
  __syncthreads();
  // dP -> (da_T, db_T) through P = a_T (.) M (.) b_T
  row_reduce(L, [&](int i, int j) {
    return dp(i, j) * M[(size_t)i * L + j] * b_t[j];
  }, da);
  col_reduce(L, [&](int i, int j) {
    return dp(i, j) * M[(size_t)i * L + j] * a_t[i];
  }, db, partial);
  __syncthreads();
  for (int t = T; t >= 1; --t) {
    const float* a_prev = a_hist + (size_t)(t - 1) * L;
    const float* b_prev = b_hist + (size_t)(t - 1) * L;
    // a_t = a_prev / m_r,  r_t = a_prev * (M b_t)
    for (int i = threadIdx.x; i < L; i += kSinkThreads) {
      const float ap = a_prev[i];
      const float m_r = ap / a_t[i];
      const float mb = m_r / ap;
      const float d = da[i];
      const float dr = m_r > kClampGate ? -d * ap / (m_r * m_r) : 0.f;
      da[i] = d / m_r + dr * mb;
      const float u = dr * ap;
      w[i] = u;
      U[(size_t)(t - 1) * L + i] = u;
      a_p[i] = ap;
    }
    __syncthreads();
    col_reduce(L, [&](int i, int j) { return M[(size_t)i * L + j] * w[i]; },
               tmp, partial);
    __syncthreads();
    // b_t = b_prev / m_c,  c_t = b_prev * (M^T a_prev)
    for (int j = threadIdx.x; j < L; j += kSinkThreads) {
      const float bp = b_prev[j];
      const float m_c = bp / b_t[j];
      const float mta = m_c / bp;
      const float cot = db[j] + tmp[j];
      const float dc = m_c > kClampGate ? -cot * bp / (m_c * m_c) : 0.f;
      db[j] = cot / m_c + dc * mta;
      const float v = dc * bp;
      w[j] = v;
      V[(size_t)(t - 1) * L + j] = v;
      b_t[j] = bp;
    }
    __syncthreads();
    row_reduce(L, [&](int i, int j) { return M[(size_t)i * L + j] * w[j]; },
               tmp);
    __syncthreads();
    for (int i = threadIdx.x; i < L; i += kSinkThreads) {
      da[i] += tmp[i];
      a_t[i] = a_p[i];
    }
    __syncthreads();
  }
  // dM = dp * outer(a_T, b_T) + sum_s U[s] (x) b_hist[s + 1] + a_hist[s] (x)
  // V[s]: the two [L, T] . [T, L] products, each warp on tiles of 4 rows by
  // 128 columns, each thread 4 x 4 outputs (columns lane + 32 jj, so that a
  // warp's loads of b and v are whole lines and those of u and a broadcast).
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row_tiles = (L + 3) / 4, col_tiles = (L + 127) / 128;
  for (int tile = warp; tile < row_tiles * col_tiles; tile += kSinkWarps) {
    const int i0 = (tile / col_tiles) * 4;
    const int j0 = (tile % col_tiles) * 128 + lane;
    int ii[4], jj[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      ii[r] = min(i0 + r, L - 1);
      jj[r] = min(j0 + 32 * r, L - 1);
    }
    float acc[4][4] = {};
    for (int s = 0; s < T; ++s) {
      const float* us = U + (size_t)s * L;
      const float* vs = V + (size_t)s * L;
      const float* as = a_hist + (size_t)s * L;
      const float* bs = b_hist + (size_t)(s + 1) * L;
      float u4[4], a4[4], b4[4], v4[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        u4[r] = us[ii[r]];
        a4[r] = as[ii[r]];
        b4[r] = bs[jj[r]];
        v4[r] = vs[jj[r]];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][c] = fmaf(a4[r], v4[c], fmaf(u4[r], b4[c], acc[r][c]));
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = i0 + r, j = j0 + 32 * c;
        if (i < L && j < L)
          dM[(size_t)i * L + j] = dp(i, j) * a_T[i] * b_T[j] + acc[r][c];
      }
  }
  __syncthreads();
}

}  // namespace allrank
