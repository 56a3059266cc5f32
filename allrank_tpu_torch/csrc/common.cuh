// Pieces shared by the kernels: conversion at the TPU kernels' rounding
// points, the unbiased-std LayerNorm row statistics, and a 64 x 64
// register-tiled fp32 product over operands staged in shared memory.
//
// Every product in these kernels is an fp32 FMA on the SIMT units: exact
// for fp32 and bf16 operands alike (no TF32), so the kernels match their
// plain PyTorch versions closely. Tensor-core tiles are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace allrank {

constexpr int kThreads = 256;     // a 16 x 16 grid of threads, 4 x 4 outputs each
constexpr int kTile = 64;         // rows and columns of one output tile
constexpr int kChunk = 32;        // depth of one staged operand chunk
constexpr int kLdA = kChunk + 1;  // padded pitch of an A chunk [kTile][kChunk]
constexpr int kLdB = kTile + 1;   // padded pitch of a B chunk [kChunk][kTile]
constexpr float kNegInfFill = -1e9f;
constexpr float kLnEps = 1e-6f;
constexpr float kVarFloor = 1e-24f;
constexpr float kLog2e = 1.4426950408889634f;

// The attention core of B1's forward bodies (attn_out_tile of
// sublayer_tiles.cuh on the SIMT units, b1_attn_out_mma_tile of
// b1_mma_tiles.cuh on the tensor cores): B1 and B10 take kAttnFull; the
// probe kernels of X3 (attention_variants.cu, attention_variants_mma.cuh)
// take the others, each with one stage changed (wrong math, honest timing;
// no dropout, no stats):
//   kAttnNoSoftmax    p = masked scores x 0.001 (no max, exp, sum)
//   kAttnExp2         exp2 of the scaled scores times log2(e)
//   kAttnNormAfterPv  P unnormalised, ctx scaled by 1 / sum after P.V
//   kAttnNoPv         ctx = v + 0.001 p[:, :d_k] (no P.V; needs L >= d_k)
//   kAttnFrame        ctx = q + k + v (no attention core at all)
enum AttnMode : int {
  kAttnFull = 0,
  kAttnNoSoftmax,
  kAttnExp2,
  kAttnNormAfterPv,
  kAttnNoPv,
  kAttnFrame
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <class T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T's precision (round to nearest even), kept as a float
template <class T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// The barrier of a tile body of kThreads threads run in a block of kBlock:
// __syncthreads() where the body is the whole block; else the body runs on
// the block's first kThreads threads and waits at the named barrier 1 for
// those alone, while the rest of the block waits elsewhere.
template <int kThreads, int kBlock>
__device__ __forceinline__ void tile_sync() {
  if constexpr (kThreads == kBlock) {
    __syncthreads();
  } else {
    static_assert(kThreads < kBlock && kThreads % 32 == 0, "whole warps");
    asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory");
  }
}

// __syncthreads_and(p) over the body's threads, as tile_sync's barrier.
template <int kThreads, int kBlock>
__device__ __forceinline__ int tile_sync_and(int p) {
  if constexpr (kThreads == kBlock) {
    return __syncthreads_and(p);
  } else {
    static_assert(kThreads < kBlock && kThreads % 32 == 0, "whole warps");
    int all;
    asm volatile(
        "{\n\t.reg .pred p, q;\n\tsetp.ne.s32 p, %1, 0;\n\t"
        "bar.red.and.pred q, 1, %2, p;\n\tselp.s32 %0, 1, 0, q;\n\t}"
        : "=r"(all)
        : "r"(p), "n"(kThreads)
        : "memory");
    return all;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Mean and unbiased variance of one row of x (length d), by one warp; every
// lane gets both.
template <class T>
__device__ __forceinline__ void row_moments(const T* row, int d,
                                            float& mu, float& var) {
  const int lane = threadIdx.x % 32;
  float s = 0.f;
  for (int k = lane; k < d; k += 32) s += to_float(row[k]);
  mu = warp_sum(s) / (float)d;
  float ss = 0.f;
  for (int k = lane; k < d; k += 32) {
    const float c = to_float(row[k]) - mu;
    ss = fmaf(c, c, ss);
  }
  var = warp_sum(ss) / (float)max(d - 1, 1);
}

// Mean and 1 / (unbiased std + eps) of rows [0, rows) of x (pitch d), one
// warp per row, the variance floored at 1e-24 first (an all-zero row has
// variance 0). Rows in [rows, kTile) get zeros.
template <class T>
__device__ void ln_row_stats(const T* x, int rows, int d,
                             float* mean, float* rdenom) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kTile; r += kThreads / 32) {
    float mu = 0.f, rd = 0.f;
    if (r < rows) {
      float var;
      row_moments(x + (size_t)r * d, d, mu, var);
      rd = 1.f / (sqrtf(fmaxf(var, kVarFloor)) + kLnEps);
    }
    if (lane == 0) {
      mean[r] = mu;
      rdenom[r] = rd;
    }
  }
}

// acc[i][j] += sum_{k < depth} A[(ty + 16 i) * lda + k] * B[k * ldb + tx + 16 j]
// with (tx, ty) the thread's place in the 16 x 16 grid: output rows ty + 16 i
// and columns tx + 16 j of a 64 x 64 tile. A warp reads two A rows
// (broadcast) and 16 consecutive B columns per k, without bank conflicts.
__device__ __forceinline__ void mma_tile(float acc[4][4], const float* A,
                                         int lda, const float* B, int ldb,
                                         int depth) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int k = 0; k < depth; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * lda + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[k * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// The same with A stored transposed: acc[i][j] += sum_k A[k * lda + ty +
// 16 i] * B[k * ldb + tx + 16 j] (A^T . B for an A tile kept [depth][64]).
__device__ __forceinline__ void mma_tile_t(float acc[4][4], const float* A,
                                           int lda, const float* B, int ldb,
                                           int depth) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int k = 0; k < depth; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[k * lda + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[k * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

}  // namespace allrank

// the message of a non-zero code returned by a launch function
extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
