// The fused NeuralNDCG soft-sort for Hopper (sm_90a), fp32, forward and
// backward: NeuralSort relaxation -> Sinkhorn scaling -> one contraction.
//
// Replaces the TPU kernel `fused_soft_sort_contract` of the JAX package's
// ops/neuralsort_pallas.py:237 (forward pallas_call at line 186, backward at
// line 214; the chain in _chain, lines 51-84). Per slate, with pad = 1 at
// padded documents:
//   s_f = pad ? -1e8 : s;  s_z = pad ? 0 : s
//   rs[j]    = sum_k |s_f[j] - s_f[k]| over valid pairs
//   pm[i, j] = scaling[i] * s_z[j] - rs[j]   (-inf where one of i, j is
//              padded, 1 where both are)
//   P_hat = softmax(pm / tau) over j;  M0 = P_hat, 0 / 1 at the pad fills
//   P = sinkhorn(M0), T fixed iterations
//   out = (P masked to valid pairs) @ vec, or its transpose @ vec
// and the scaling records a_hist, b_hist [N, T + 1, L] for the backward,
// which gives ds [N, L]. L <= 512, the TPU kernel's cap.
//
// What bounds it: operations, nominally. The function moves only O(N L)
// values in and O(N T L) out (3.3 MB at N = 64, L = 240, T = 50) but does
// 2 T matvecs of 2 L^2 FLOP per slate (1.5 GFLOP there, 22 us of the
// card's fp32 rate; the backward twice that and two [L, T] . [T, L]
// products). What it pays for is the latency of 100 dependent matvecs by one
// block per slate.
//
// Design. Nothing [L, L] leaves the kernel as a result, but M0 cannot live
// in shared memory (sinkhorn.cuh), so each block keeps its slate's M0 in a
// scratch of its own in device memory, written once and re-read from L2 on
// every half-iteration; recomputing M0[i, j] from the O(L) vectors instead
// would cost an expf per element per matvec. A launch has at most one block
// per SM and the blocks walk the slates, so the scratch is [blocks, L, L]
// whatever N is (2,048 slates in the stochastic variant). The backward
// rebuilds M0, runs the shared reverse pass with the rank-1 cotangent of the
// contraction, writes dM0 to a second scratch, and reads both once by row
// (the softmax's inner sum) and twice by column (ds through scaling * s_z
// and through the row sums). Sums in a fixed order, true division, expf.
// The kernels live in soft_sort.cuh as templates, whose other
// instantiation (neuralsort_layout.cu) keeps the records in shared memory.
#include "soft_sort.cuh"

// Forward on `stream`: out [n, L], a_hist, b_hist [n, T + 1, L] from s, pad
// (1 = padded), vec [n, L], all fp32; m_scratch holds [grid, L, L] floats.
// Returns 0 or the CUDA error code.
extern "C" int soft_sort_fwd(const void* s, const void* pad, const void* vec,
                             void* m_scratch, void* out, void* a_hist,
                             void* b_hist, int n, int L, int T, float tau,
                             int transpose, int grid, void* stream) {
  const int bytes = allrank::prepare(allrank::soft_sort_fwd_kernel<false>,
                                     allrank::kSoftSortFwdVectors, L);
  if (bytes < 0) return -bytes;
  allrank::soft_sort_fwd_kernel<false><<<grid, allrank::kSinkThreads, bytes,
                                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<const float*>(pad),
      static_cast<const float*>(vec), static_cast<float*>(m_scratch),
      static_cast<float*>(out), static_cast<float*>(a_hist),
      static_cast<float*>(b_hist), n, L, T, tau, transpose);
  return cudaGetLastError();
}

// Backward on `stream`: ds [n, L] from the forward's inputs and records and
// dout [n, L]; m_scratch holds [grid, 2, L, L] floats, uv [grid, 2, T, L].
extern "C" int soft_sort_bwd(const void* s, const void* pad, const void* vec,
                             const void* a_hist, const void* b_hist,
                             const void* dout, void* m_scratch, void* uv,
                             void* ds, int n, int L, int T, float tau,
                             int transpose, int grid, void* stream) {
  const int bytes = allrank::prepare(allrank::soft_sort_bwd_kernel<false>,
                                     allrank::kSoftSortBwdVectors, L);
  if (bytes < 0) return -bytes;
  allrank::soft_sort_bwd_kernel<false><<<grid, allrank::kSinkThreads, bytes,
                                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<const float*>(pad),
      static_cast<const float*>(vec), static_cast<const float*>(a_hist),
      static_cast<const float*>(b_hist), static_cast<const float*>(dout),
      static_cast<float*>(m_scratch), static_cast<float*>(uv),
      static_cast<float*>(ds), n, L, T, tau, transpose);
  return cudaGetLastError();
}
