// The fused NeuralNDCG soft-sort with its Sinkhorn records held on chip, for
// Hopper (sm_90a), fp32, forward and backward: B8's route "cluster"
// (neuralsort_cluster.cu) with another home for the rows the loop writes and
// re-reads.
//
// Replaces the TPU kernel `make_fused_C` of the JAX package's
// tools/exp_sinkhorn_layout.py:186 (forward pallas_call at line 205,
// backward at line 231): the probe that asks whether B8's scaling records
// belong in fast memory in iteration-major order. There the records are a
// [T + 1, bb, L] VMEM scratch, relaid to the slate-major [N, T + 1, L]
// outputs once per program, and the backward carries (a_t, b_t) so that it
// reads one new record row per iteration.
//
// On this card B8 runs a slate on a thread-block cluster: its forward writes
// each record row to device memory as the loop makes it, and its backward
// re-reads them and keeps its U and V stacks in a per-block scratch of
// device memory, staged back through shared memory for the epilogue. X4 is
// B8's slate kernels (soft_sort_cluster_kernels.cuh) with kRecordsOnChip
// set, at B8's cluster sizes and register shapes:
//   forward:  each block's records (a for its rows, b for its share of the
//             columns) stay in its shared memory for the whole loop and go
//             out in one pass a slate;
//   backward: the records come in in one pass a slate, and with U and V stay
//             in shared memory for the whole loop and the epilogue, in the
//             room of the block's rows of M0, which the loop holds in
//             registers; the epilogue rebuilds each M0 value it needs from
//             the chain's vectors and its row's softmax max and sum (the
//             same logit, exponential and division: the same bits). No
//             device scratch.
// The same sums in the same order: out, the records and ds equal B8's bit
// for bit.
//
// What bounds it: as B8, the latency of 100 dependent matvecs a slate.
// The envelope: the backward's stacks take (2 T + 1) (round8(R) +
// round128(L)) floats a block, so at T = 50 L <= 384 (ops/neuralsort_layout.py
// states the cap and refuses beyond it); the forward's records fit to 512.
#include "soft_sort_cluster.cuh"

namespace allrank {
namespace {
namespace on_chip {

// the records and the stacks in shared memory
constexpr bool kRecordsOnChip = true;
#include "soft_sort_cluster_kernels.cuh"

}  // namespace on_chip

// Floats of shared memory a block of X4 takes at T iterations
// (ops/neuralsort_layout.py's smem_floats mirrors this): the forward B8's
// and the block's records [T + 1, Rp] of a and of b (its share of the
// columns); the backward the stacks in the room of M0's rows, the rows'
// softmax max and sum, and no staging room.
__host__ __device__ constexpr int layout_smem_floats(int L, int csize, int T,
                                                     bool backward) {
  return backward ? records_m0_room(L, csize, T) +
                        kBwdVectors * round_up(L, 4) +
                        6 * round_up(rows_per_block(L, csize), 4) +
                        records_bwd_room(L, csize)
                  : smem_floats(L, csize, false) +
                        2 * (T + 1) * round_up(rows_per_block(L, csize), 4);
}

// 0, or the reason a launch cannot take these sizes
cudaError_t layout_check(int n, int L, int T, int csize, int bytes,
                         int clusters, bool backward) {
  if (n < 1 || L < 1 || L > kMaxClusterL || T < 1 || clusters < 1 ||
      csize != cluster_blocks(L) || bytes > 232448 ||
      (long long)bytes < 4LL * layout_smem_floats(L, csize, T, backward))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace
}  // namespace allrank

// The floats of shared memory a block of the forward (backward = 0) or
// backward takes at length L, T iterations, with `cluster` blocks a
// cluster (B8's cluster_blocks(L)).
extern "C" int soft_sort_layout_floats(int L, int cluster, int T,
                                       int backward) {
  return allrank::layout_smem_floats(L, cluster, T, backward != 0);
}

// The clusters of `cluster` blocks with `bytes` of shared memory each that
// the card holds at once for the forward (backward = 0) or backward kernel
// of length L, or minus the CUDA error code.
extern "C" int soft_sort_layout_occupancy(int backward, int L, int cluster,
                                          int bytes) {
  using namespace allrank;
  const void* kernel =
      backward ? on_chip::kernel_for<true>(L) : on_chip::kernel_for<false>(L);
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
extern "C" int soft_sort_layout_fwd(const void* s, const void* pad,
                                    const void* vec, void* out, void* a_hist,
                                    void* b_hist, int n, int L, int T,
                                    float tau, int transpose, int cluster,
                                    int bytes, int clusters, void* stream) {
  using namespace allrank;
  const cudaError_t err =
      layout_check(n, L, T, cluster, bytes, clusters, false);
  if (err != cudaSuccess) return err;
  void* args[] = {&s, &pad, &vec, &out, &a_hist, &b_hist, &n, &L, &T, &tau,
                  &transpose};
  return launch(on_chip::kernel_for<false>(L), clusters, cluster, bytes,
                stream, args);
}

// Backward on `stream`: ds [n, L] from the forward's inputs and records and
// dout [n, L]; no scratch (the kernel's `uv` is null).
extern "C" int soft_sort_layout_bwd(const void* s, const void* pad,
                                    const void* vec, const void* a_hist,
                                    const void* b_hist, const void* dout,
                                    void* ds, int n, int L, int T, float tau,
                                    int transpose, int cluster, int bytes,
                                    int clusters, void* stream) {
  using namespace allrank;
  const cudaError_t err = layout_check(n, L, T, cluster, bytes, clusters, true);
  if (err != cudaSuccess) return err;
  void* uv = nullptr;
  void* args[] = {&s, &pad, &vec, &a_hist, &b_hist, &dout, &uv, &ds,
                  &n, &L, &T, &tau, &transpose};
  return launch(on_chip::kernel_for<true>(L), clusters, cluster, bytes,
                stream, args);
}
