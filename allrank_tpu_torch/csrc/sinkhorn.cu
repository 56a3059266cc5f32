// Fixed-trip Sinkhorn scaling for Hopper (sm_90a), fp32, forward and backward.
//
// Replaces the TPU kernel `sinkhorn_core_fused` of the JAX package's
// ops/sinkhorn_pallas.py:275 (forward pallas_call at line 286, backward at
// line 325). Forward: pre-masked M0 [N, L, L] -> P = diag(a_T) M0 diag(b_T)
// and the scaling records a_hist, b_hist [N, T + 1, L]. Backward: dM0
// [N, L, L] from dP, M0 and the records. L <= 768, the TPU kernel's cap.
//
// What bounds it: bytes. The function reads M0 once and writes P once
// (2 * 4 N L^2 bytes, 26 MB at N = 8, L = 640), and does 2 T matvecs of
// 2 L^2 FLOP per slate (0.66 GFLOP there), 10 us of fp32 FMA work beside
// 8 us of memory traffic; the backward reads two and writes one matrix. What
// the kernel really pays for is latency: each slate is a chain of 100
// dependent matvecs, each a pass over L^2 values from L2 by one block.
//
// Design: one block per slate (see sinkhorn.cuh for the loop, the matvecs
// and why M0 stays in device memory). A launch of N blocks fills N of the
// card's 132 SMs.
#include <cuda_runtime.h>

#include "sinkhorn.cuh"

namespace allrank {
namespace {

__global__ void __launch_bounds__(kSinkThreads)
    sinkhorn_fwd_kernel(const float* __restrict__ m0, float* __restrict__ p,
                        float* __restrict__ a_hist,
                        float* __restrict__ b_hist, int n, int L, int T) {
  extern __shared__ float smem_base[];
  for (int slate = blockIdx.x; slate < n; slate += gridDim.x) {
    const float* M = m0 + (size_t)slate * L * L;
    float* smem = smem_base;
    float *a, *b;
    sinkhorn_forward(M, L, T, smem, a, b,
                     a_hist + (size_t)slate * (T + 1) * L,
                     b_hist + (size_t)slate * (T + 1) * L);
    float* out = p + (size_t)slate * L * L;
    for (int idx = threadIdx.x; idx < L * L; idx += kSinkThreads) {
      const int i = idx / L, j = idx - i * L;
      out[idx] = a[i] * M[idx] * b[j];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kSinkThreads)
    sinkhorn_bwd_kernel(const float* __restrict__ m0,
                        const float* __restrict__ a_hist,
                        const float* __restrict__ b_hist,
                        const float* __restrict__ dp, float* uv,
                        float* __restrict__ dm0, int n, int L, int T) {
  extern __shared__ float smem_base[];
  float* U = uv + (size_t)blockIdx.x * 2 * T * L;
  float* V = U + (size_t)T * L;
  for (int slate = blockIdx.x; slate < n; slate += gridDim.x) {
    const float* d = dp + (size_t)slate * L * L;
    sinkhorn_backward(
        m0 + (size_t)slate * L * L, L, T,
        [=](int i, int j) { return d[(size_t)i * L + j]; },
        a_hist + (size_t)slate * (T + 1) * L,
        b_hist + (size_t)slate * (T + 1) * L, U, V,
        dm0 + (size_t)slate * L * L, smem_base);
  }
}

template <class K>
int prepare(K kernel, int vectors, int L) {
  const int bytes = vectors * L * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return err == cudaSuccess ? bytes : -(int)err;
}

}  // namespace
}  // namespace allrank

// Forward on `stream`: p [n, L, L], a_hist, b_hist [n, T + 1, L] from m0
// [n, L, L], all fp32; `grid` blocks walk the slates. Returns 0 or the CUDA
// error code.
extern "C" int sinkhorn_fwd(const void* m0, void* p, void* a_hist,
                            void* b_hist, int n, int L, int T, int grid,
                            void* stream) {
  const int bytes = allrank::prepare(allrank::sinkhorn_fwd_kernel,
                                     allrank::kSinkFwdVectors, L);
  if (bytes < 0) return -bytes;
  allrank::sinkhorn_fwd_kernel<<<grid, allrank::kSinkThreads, bytes,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(m0), static_cast<float*>(p),
      static_cast<float*>(a_hist), static_cast<float*>(b_hist), n, L, T);
  return cudaGetLastError();
}

// Backward on `stream`: dm0 [n, L, L] from m0, the records and dp [n, L, L];
// uv is scratch of [grid, 2, T, L] floats.
extern "C" int sinkhorn_bwd(const void* m0, const void* a_hist,
                            const void* b_hist, const void* dp, void* uv,
                            void* dm0, int n, int L, int T, int grid,
                            void* stream) {
  const int bytes = allrank::prepare(allrank::sinkhorn_bwd_kernel,
                                     allrank::kSinkBwdVectors, L);
  if (bytes < 0) return -bytes;
  allrank::sinkhorn_bwd_kernel<<<grid, allrank::kSinkThreads, bytes,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(m0), static_cast<const float*>(a_hist),
      static_cast<const float*>(b_hist), static_cast<const float*>(dp),
      static_cast<float*>(uv), static_cast<float*>(dm0), n, L, T);
  return cudaGetLastError();
}
