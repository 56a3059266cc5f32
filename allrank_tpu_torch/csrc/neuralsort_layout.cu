// The fused NeuralNDCG soft-sort with its Sinkhorn records held on chip, for
// Hopper (sm_90a), fp32, forward and backward: B8's function (neuralsort.cu)
// with another home for the rows the loop writes and re-reads.
//
// Replaces the TPU kernel `make_fused_C` of the JAX package's
// tools/exp_sinkhorn_layout.py:186 (forward pallas_call at line 205,
// backward at line 231): the probe that asks whether B8's scaling records
// belong in fast memory in iteration-major order. There the records are a
// [T + 1, bb, L] VMEM scratch, relaid to the slate-major [N, T + 1, L]
// outputs once per program, and the backward carries (a_t, b_t) so that it
// reads one new record row per iteration.
//
// On this card a block works on one slate, whose [T + 1, L] records are
// iteration-major already; B8 writes each row to device memory as the loop
// makes it and its backward re-reads the rows, and its U and V stacks, from
// device memory (L2). Here the forward keeps both records in shared memory
// for the whole loop and writes them out in one coalesced pass per slate;
// the backward reads them in one coalesced pass, and keeps its U and V
// stacks [T, L] in shared memory too, so that the reverse loop and the two
// [L, T] . [T, L] products touch device memory only for M0 and dM0. B8's
// backward already carries (a_t, b_t).
//
// Both kernels are B8's own templates (soft_sort.cuh) with kOnChip set: the
// same sums in the same order, so out, the records and ds equal B8's bit
// for bit.
//
// What bounds it: as B8, operations nominally and the latency of 100
// dependent matvecs by one block per slate in practice. The envelope: the
// backward holds 2 (T + 1) record rows, 2 T U/V rows and
// kSoftSortBwdVectors vectors of L floats, (4 T + 24) L floats, 896 L bytes
// at T = 50, against the 232,448 bytes a block may take: L <= 259 there
// (ops/neuralsort_layout.py states the cap and refuses beyond it).
#include <cuda_runtime.h>

#include "soft_sort.cuh"

namespace allrank {
namespace {

constexpr int fwd_rows(int T) { return 2 * (T + 1); }
constexpr int bwd_rows(int T) { return 2 * (T + 1) + 2 * T; }

}  // namespace
}  // namespace allrank

// The dynamic shared memory, in floats per slate position L, of the forward
// (backward = 0) or the backward (backward = 1) at T iterations.
extern "C" int soft_sort_layout_vectors(int T, int backward) {
  return backward ? allrank::bwd_rows(T) + allrank::kSoftSortBwdVectors
                  : allrank::fwd_rows(T) + allrank::kSoftSortFwdVectors;
}

// Forward on `stream`: out [n, L], a_hist, b_hist [n, T + 1, L] from s, pad
// (1 = padded), vec [n, L], all fp32; m_scratch holds [grid, L, L] floats.
// Returns 0 or the CUDA error code.
extern "C" int soft_sort_layout_fwd(const void* s, const void* pad,
                                    const void* vec, void* m_scratch,
                                    void* out, void* a_hist, void* b_hist,
                                    int n, int L, int T, float tau,
                                    int transpose, int grid, void* stream) {
  const int bytes = allrank::prepare(allrank::soft_sort_fwd_kernel<true>,
                                     soft_sort_layout_vectors(T, 0), L);
  if (bytes < 0) return -bytes;
  allrank::soft_sort_fwd_kernel<true><<<grid, allrank::kSinkThreads, bytes,
                                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<const float*>(pad),
      static_cast<const float*>(vec), static_cast<float*>(m_scratch),
      static_cast<float*>(out), static_cast<float*>(a_hist),
      static_cast<float*>(b_hist), n, L, T, tau, transpose);
  return cudaGetLastError();
}

// Backward on `stream`: ds [n, L] from the forward's inputs and records and
// dout [n, L]; m_scratch holds [grid, 2, L, L] floats.
extern "C" int soft_sort_layout_bwd(const void* s, const void* pad,
                                    const void* vec, const void* a_hist,
                                    const void* b_hist, const void* dout,
                                    void* m_scratch, void* ds, int n, int L,
                                    int T, float tau, int transpose, int grid,
                                    void* stream) {
  const int bytes = allrank::prepare(allrank::soft_sort_bwd_kernel<true>,
                                     soft_sort_layout_vectors(T, 1), L);
  if (bytes < 0) return -bytes;
  allrank::soft_sort_bwd_kernel<true><<<grid, allrank::kSinkThreads, bytes,
                                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<const float*>(pad),
      static_cast<const float*>(vec), static_cast<const float*>(a_hist),
      static_cast<const float*>(b_hist), static_cast<const float*>(dout),
      static_cast<float*>(m_scratch), nullptr, static_cast<float*>(ds), n, L,
      T, tau, transpose);
  return cudaGetLastError();
}
