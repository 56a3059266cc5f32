// The fused NeuralNDCG soft-sort for Hopper (sm_90a), fp32, forward and
// backward, with M0 on chip: a slate's rows of M0 split across a
// thread-block cluster, each block's share held in its shared memory and,
// for the Sinkhorn loop, in its registers. B8's main route ("cluster");
// neuralsort.cu's kernels, which re-read M0 from L2, stay as route "l2".
//
// Replaces the TPU kernel `fused_soft_sort_contract` of the JAX package's
// ops/neuralsort_pallas.py:237 (forward pallas_call at line 186, backward at
// line 214; the chain in _chain, lines 51-84), whose point is M0 [L, L]
// resident in fast memory. The function is neuralsort.cu's (see there):
// NeuralSort relaxation -> T Sinkhorn iterations -> one contraction, the
// records a_hist, b_hist [N, T + 1, L] out of the forward and into the
// backward, ds [N, L] out of the backward. L <= 512.
//
// What bounds it: the latency of 2 T dependent matvecs on a slate's M0
// (1.5 GFLOP at N = 64, L = 240, T = 50: 22 us of the card's fp32 rate).
// Route "l2" runs each on one block per slate reading M0 from L2 (some 6.8
// us a half-iteration at L = 240, 64 of 132 SMs at N = 64); read from
// shared memory, M0 still costs a matvec some 900 cycles of the SM's 128
// bytes a clock at L = 240.
//
// Design. A block may hold 232,448 bytes of shared memory, and 240^2 fp32
// is 230,400: M0 goes to a cluster of C blocks, block `rank` holding the
// R = ceil(L / C) rows [rank R, rank R + R) of M0. C follows the registers
// (ops/neuralsort.py's cluster_plan): 512 threads a block hold its rows of
// M0 in registers during the loop, 64 floats a thread at most, with lane l
// on the rows l, l + 32, ... (KR of them) and warp w on KQ quads of columns
// from 4 KQ w on: (KR, KQ) = (8, 2) to L = 128 (C = 1), (4, 4) to 256 (C
// = 2: 128 blocks at N = 64, L = 240) and (2, 8) to 512 (C = 8). Each block
// keeps the O(L) vectors whole: the chain's, and the scaling b (all
// columns), beside a (its own rows).
//   M0^T a:  each lane sums its rows of its columns, and a halving
//            butterfly across the warp's lanes adds the rows up, one
//            column a lane at its end; each block stores its column sums
//            into every block's shared memory (distributed shared memory)
//            and, after one cluster barrier, every block adds the C blocks'
//            sums in rank order from its own, so every block computes the
//            same new b in full.
//   M0 b:    each lane sums its warp's columns of its rows; the 16 warps'
//            partial sums meet in shared memory, added in warp order.
// The column sums are double-buffered, so one cluster barrier an iteration
// suffices: a block writes buffer k & 1 only after the barrier that every
// block reaches once done reading exchange k - 2.
// The clusters walk the slates (N = 2,048 in the stochastic variant); the
// wrapper sizes the grid with cudaOccupancyMaxActiveClusters.
// The backward rebuilds M0's rows the same way, runs the reverse pass on
// them (U for its own rows, V for all columns, in a per-block scratch of
// device memory), and never writes dM0: it forms each dM0 element where it
// is used, from the stacks staged through shared memory 4 iterations at a
// time (cp.async into one buffer while the block reads the other), as an
// 8 x 4 register tile per thread (the FMA chain over t of neuralsort.cu's
// product), for the two column sums of the softmax cotangent, which go
// through the cluster as the once-a-slate sums do (each block reads the
// others' partials). The softmax's row sums inner_i = sum_j dM0_ij M0_ij
// need no pass over dM0: M0's rows times dM0's terms are the loop's own
// row sums (M0 V[t], and M0 b_hist[t] beside it), weighted by U and a_hist.
// Every sum is an fp32 FMA chain in a fixed order, every division a true
// division, expf; no TF32, no atomics: a second run gives the same bits.
#include "soft_sort_cluster.cuh"

namespace allrank {
namespace {

// the records and the stacks in device memory
constexpr bool kRecordsOnChip = false;
#include "soft_sort_cluster_kernels.cuh"

// 0, or the reason a launch cannot take these sizes
cudaError_t check_plan(int n, int L, int T, int csize, int bytes,
                       bool backward) {
  if (n < 1 || L < 1 || L > kMaxClusterL || T < 1 ||
      csize != cluster_blocks(L) || bytes > 232448 ||
      (long long)bytes < 4LL * smem_floats(L, csize, backward))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace
}  // namespace allrank

// The blocks of a cluster at length L (1 to L = 128, 2 to 256, 8 to 512)
// and the floats of shared memory a block of the forward (backward = 0) or
// backward takes there.
extern "C" int soft_sort_cluster_blocks(int L) {
  return allrank::cluster_blocks(L);
}
extern "C" int soft_sort_cluster_floats(int L, int cluster, int backward) {
  return allrank::smem_floats(L, cluster, backward != 0);
}

// The clusters of `cluster` blocks with `bytes` of shared memory each that
// the card holds at once for the forward (backward = 0) or backward kernel
// of length L, or minus the CUDA error code.
extern "C" int soft_sort_cluster_occupancy(int backward, int L, int cluster,
                                           int bytes) {
  using namespace allrank;
  const void* kernel =
      backward ? kernel_for<true>(L) : kernel_for<false>(L);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config = cluster_config(&attr, 1, cluster, bytes, 0);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  return err == cudaSuccess ? clusters : -(int)err;
}

// Forward on `stream`: out [n, L], a_hist, b_hist [n, T + 1, L] from s, pad
// (1 = padded), vec [n, L], all fp32; `clusters` clusters of `cluster`
// blocks with `bytes` of shared memory each. Returns 0 or the CUDA error
// code.
extern "C" int soft_sort_cluster_fwd(const void* s, const void* pad,
                                     const void* vec, void* out,
                                     void* a_hist, void* b_hist, int n,
                                     int L, int T, float tau, int transpose,
                                     int cluster, int bytes, int clusters,
                                     void* stream) {
  using namespace allrank;
  cudaError_t err = check_plan(n, L, T, cluster, bytes, false);
  if (err == cudaSuccess && clusters < 1) err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  void* args[] = {&s, &pad, &vec, &out, &a_hist, &b_hist, &n, &L, &T, &tau,
                  &transpose};
  return launch(kernel_for<false>(L), clusters, cluster, bytes, stream,
                args);
}

// Backward on `stream`: ds [n, L] from the forward's inputs and records and
// dout [n, L]; uv holds [clusters * cluster, T, round8(ceil(L / cluster))
// + L] floats (each block's U and V stacks).
extern "C" int soft_sort_cluster_bwd(const void* s, const void* pad,
                                     const void* vec, const void* a_hist,
                                     const void* b_hist, const void* dout,
                                     void* uv, void* ds, int n, int L, int T,
                                     float tau, int transpose, int cluster,
                                     int bytes, int clusters, void* stream) {
  using namespace allrank;
  cudaError_t err = check_plan(n, L, T, cluster, bytes, true);
  if (err == cudaSuccess && clusters < 1) err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  void* args[] = {&s, &pad, &vec, &a_hist, &b_hist, &dout, &uv, &ds,
                  &n, &L, &T, &tau, &transpose};
  return launch(kernel_for<true>(L), clusters, cluster, bytes, stream, args);
}
