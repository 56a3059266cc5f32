// The lambdaLoss pair chain for Hopper (sm_90a), fp32, forward and backward.
//
// Replaces the TPU kernel `fused_lambda_pairs` of the JAX package's
// ops/lambda_pallas.py:222 (forward pallas_call at line 174, backward at
// line 197; the chain in _chain, lines 71-102, and the backward's w / a
// collapse at lines 127-135). Over the prediction-sorted top-k block of each
// slate, for every pair (i, j):
//   sel  = valid_i & valid_j & (ts_i > ts_j, except for ndcgLoss1)
//   s    = sigmoid(sigma * clip(yp_i - yp_j, +-1e8)), a = max(s, eps)
//   loss = sel * max(w_ij * log a, log eps) [/ ln 2]
// summed per slate with the count of selected pairs; the backward gives
//   dyp_i = gout * (sum_j c_ij - sum_j c_ji),
//   c = sel * [w log a > log eps] * (w / a) [/ ln 2] * [s > eps] * sigma s (1-s)
// The weight w_ij comes from one of seven schemes (or is 1); it depends on
// the labels and the positions only, so no other gradient path exists. The
// per-pair arithmetic is lambda_chain.cuh's selected_term, which the kernel
// for longer blocks (lambda_tiled.cu) runs too.
//
// What bounds it: neither bytes nor products. The inputs are five [B, k]
// rows (some 300 KB at B=64, k=240); the work is O(B k^2) pair evaluations
// of a few transcendentals each (about 3.7 M pairs, one exp and one log
// apiece where selected), far below the card's rate for either, so the
// number of warps at work and the latency of the sums dominate.
//
// Design. A slate runs on a thread-block cluster of 1, 2 or 4 blocks of 8
// warps (ops/lambda_pairs.py's cluster_size; at B=64, k=240 that is 256
// blocks on the 132 SMs). Each block holds the slate's six rows and two
// per-row quotients (1/d_row, g/d_row: the chain's fp32 divisions, taken
// once a document, so each pair's value keeps its bits) in shared memory,
// 12 KB at k = 384. Block `rank` of a cluster of C takes the rows i = rank
// (mod C), its warp w those with (i - rank) / C = w (mod 8): rows
// interleaved, so a k_eff of 10 or a padding tail still spreads over every
// block. A warp sweeps its row i with lane l on j = l, l + 32, ... A pair
// that is not selected adds nothing to the loss, the count or the
// gradient, and pays only for the test: the exp, the log and the divisions
// run for selected pairs alone (lambda_chain.cuh's selected_pair). A row
// that selects nothing (padded, or at or beyond k_eff) is skipped whole.
//   forward:  each lane sums its pairs' loss and count; then a butterfly
//             across the warp, the warps in order, the cluster's blocks in
//             rank order (block 0 reads the others' sums from their shared
//             memory), one write per slate.
//   backward: each ordered pair is evaluated once: c_ij adds to row i's
//             sum (a butterfly across the warp) and to column j's, which
//             lane l keeps in registers for its 12 columns across the
//             warp's rows; the warps' column sums are added in warp order
//             in shared memory, the blocks' in rank order through
//             distributed shared memory, and block `rank` writes
//             dyp_i = gout (row sum - column sum) for its own rows.
// Every sum runs in a fixed order and nothing is added atomically, so a
// second run gives the same bits; counts are fp32 sums of ones, exact.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"
#include "lambda_chain.cuh"

namespace cg = cooperative_groups;

namespace allrank {
namespace {

constexpr int kMaxK = 384;
constexpr int kPairThreads = 256;  // 8 warps a block
constexpr int kPairWarps = kPairThreads / 32;
constexpr int kColsPerLane = kMaxK / 32;

// The slate's rows, 1 / d_row and g / d_row into shared memory, eight
// arrays of kMaxK floats, by the whole block.
__device__ __forceinline__ Slate load_slate(float* sm, int slate,
                                            const float* yp, const float* ts,
                                            const float* g,
                                            const float* valid,
                                            const float* d_row,
                                            const float* delta, int L) {
  const size_t o = (size_t)slate * L;
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const float gi = g[o + i], di = d_row[i];
    sm[i] = yp[o + i];
    sm[kMaxK + i] = ts[o + i];
    sm[2 * kMaxK + i] = gi;
    sm[3 * kMaxK + i] = valid[o + i];
    sm[4 * kMaxK + i] = di;
    sm[5 * kMaxK + i] = delta[i];
    sm[6 * kMaxK + i] = 1.f / di;
    sm[7 * kMaxK + i] = gi / di;
  }
  __syncthreads();
  return Slate{Row{sm, sm + kMaxK, sm + 2 * kMaxK, sm + 3 * kMaxK,
                   sm + 4 * kMaxK, sm + 5 * kMaxK},
               sm + 6 * kMaxK, sm + 7 * kMaxK};
}

// Whether row i can select a pair: a valid document inside k_eff.
__device__ __forceinline__ bool row_live(const Row& row, const ChainArgs& a,
                                         int i) {
  return row.valid[i] > 0.5f && !(a.k_eff < a.L && i >= a.k_eff);
}

// The chain's selection for a live row i: no transcendental.
__device__ __forceinline__ bool selects(const Row& row, const ChainArgs& a,
                                        int i, int j) {
  bool sel = row.valid[j] > 0.5f;
  if (a.scheme != kNdcgLoss1) sel = sel && (row.ts[i] - row.ts[j]) > 0.f;
  if (a.k_eff < a.L) sel = sel && j < a.k_eff;
  return sel;
}

// loss[b] = sum over selected pairs, cnt[b] = their count
__global__ void __launch_bounds__(kPairThreads)
    lambda_cluster_fwd_kernel(const float* __restrict__ yp,
                              const float* __restrict__ ts,
                              const float* __restrict__ g,
                              const float* __restrict__ valid,
                              const float* __restrict__ d_row,
                              const float* __restrict__ delta,
                              float* __restrict__ loss,
                              float* __restrict__ cnt, ChainArgs a) {
  __shared__ float sm[8 * kMaxK];
  __shared__ float warp_sums[2][kPairWarps];
  __shared__ float block_sums[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int slate = blockIdx.x / csize;
  const Slate sl = load_slate(sm, slate, yp, ts, g, valid, d_row, delta,
                              a.L);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float ls = 0.f, cs = 0.f;
  for (int i = rank + csize * warp; i < a.L; i += csize * kPairWarps) {
    if (!row_live(sl.row, a, i)) continue;
    for (int j = lane; j < a.L; j += 32) {
      if (selects(sl.row, a, i, j)) {
        ls += selected_pair(sl, a, i, j, false);
        cs += 1.f;
      }
    }
  }
  ls = warp_sum(ls);
  cs = warp_sum(cs);
  if (lane == 0) {
    warp_sums[0][warp] = ls;
    warp_sums[1][warp] = cs;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bl = 0.f, bc = 0.f;
    for (int w = 0; w < kPairWarps; ++w) {
      bl += warp_sums[0][w];
      bc += warp_sums[1][w];
    }
    block_sums[0] = bl;
    block_sums[1] = bc;
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    float tl = 0.f, tc = 0.f;
    for (int r = 0; r < csize; ++r) {
      const float* other = cluster.map_shared_rank(block_sums, r);
      tl += other[0];
      tc += other[1];
    }
    loss[slate] = tl;
    cnt[slate] = tc;
  }
  // the other blocks' sums stay in place until block 0 has read them
  cluster.sync();
}

// dyp[b, i] = gout[b] * (sum_j c_ij - sum_j c_ji)
__global__ void __launch_bounds__(kPairThreads)
    lambda_cluster_bwd_kernel(const float* __restrict__ yp,
                              const float* __restrict__ ts,
                              const float* __restrict__ g,
                              const float* __restrict__ valid,
                              const float* __restrict__ d_row,
                              const float* __restrict__ delta,
                              const float* __restrict__ gout,
                              float* __restrict__ dyp, ChainArgs a) {
  __shared__ float sm[8 * kMaxK];
  __shared__ float col_part[kPairWarps][kMaxK];
  __shared__ float block_col[kMaxK];  // read by the cluster
  __shared__ float row_out[kMaxK];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int slate = blockIdx.x / csize;
  const Slate sl = load_slate(sm, slate, yp, ts, g, valid, d_row, delta,
                              a.L);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float col[kColsPerLane];
#pragma unroll
  for (int m = 0; m < kColsPerLane; ++m) col[m] = 0.f;
  for (int i = rank + csize * warp; i < a.L; i += csize * kPairWarps) {
    float out = 0.f;
    if (row_live(sl.row, a, i)) {
#pragma unroll
      for (int m = 0; m < kColsPerLane; ++m) {
        const int j = lane + 32 * m;
        if (j < a.L && selects(sl.row, a, i, j)) {
          const float c = selected_pair(sl, a, i, j, true);
          out += c;
          col[m] += c;
        }
      }
      out = warp_sum(out);
    }
    if (lane == 0) row_out[i] = out;
  }
#pragma unroll
  for (int m = 0; m < kColsPerLane; ++m) {
    const int j = lane + 32 * m;
    if (j < a.L) col_part[warp][j] = col[m];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < a.L; j += kPairThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kPairWarps; ++w) s += col_part[w][j];
    block_col[j] = s;
  }
  cluster.sync();
  const float go = gout[slate];
  for (int i = rank + csize * threadIdx.x; i < a.L;
       i += csize * kPairThreads) {
    float in_sum = 0.f;
    for (int r = 0; r < csize; ++r)
      in_sum += cluster.map_shared_rank(block_col, r)[i];
    dyp[(size_t)slate * a.L + i] = (row_out[i] - in_sum) * go;
  }
  // every block's column sums stay in place until the cluster has read them
  cluster.sync();
}

// The launch of `kernel` on `batch` clusters of `csize` blocks.
template <class... Params, class... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int batch, int csize,
                            cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(batch * csize);
  config.blockDim = dim3(kPairThreads);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, args...);
}

bool valid_shape(int batch, int L, int csize) {
  return batch >= 1 && L >= 1 && L <= kMaxK &&
         (csize == 1 || csize == 2 || csize == 4);
}

}  // namespace
}  // namespace allrank

namespace {
allrank::ChainArgs chain_args(int L, int k_eff, int scheme, int binary,
                              float sigma, float mu, float eps,
                              float log_eps) {
  return allrank::ChainArgs{L, k_eff, scheme, binary, sigma, mu, eps, log_eps};
}
}  // namespace

// Forward on `stream`: loss, cnt [B] from yp, ts, g, valid [B, L] fp32,
// d_row = log2(i + 2) and delta (the ndcgLoss2 delta of distance i) [L];
// L <= 384, a cluster of `cluster` (1, 2 or 4) blocks a slate. Returns 0 or
// the CUDA error code.
extern "C" int lambda_pairs_fwd(const void* yp, const void* ts, const void* g,
                                const void* valid, const void* d_row,
                                const void* delta, void* loss, void* cnt,
                                int batch, int L, int k_eff, int scheme,
                                int binary, float sigma, float mu, float eps,
                                float log_eps, int cluster, void* stream) {
  using namespace allrank;
  if (!valid_shape(batch, L, cluster)) return cudaErrorInvalidValue;
  return launch_clusters(
      lambda_cluster_fwd_kernel, batch, cluster,
      static_cast<cudaStream_t>(stream), static_cast<const float*>(yp),
      static_cast<const float*>(ts), static_cast<const float*>(g),
      static_cast<const float*>(valid), static_cast<const float*>(d_row),
      static_cast<const float*>(delta), static_cast<float*>(loss),
      static_cast<float*>(cnt),
      chain_args(L, k_eff, scheme, binary, sigma, mu, eps, log_eps));
}

// Backward on `stream`: dyp [B, L] from the forward's inputs and gout [B],
// the loss sums' cotangent.
extern "C" int lambda_pairs_bwd(const void* yp, const void* ts, const void* g,
                                const void* valid, const void* d_row,
                                const void* delta, const void* gout,
                                void* dyp, int batch, int L, int k_eff,
                                int scheme, int binary, float sigma, float mu,
                                float eps, float log_eps, int cluster,
                                void* stream) {
  using namespace allrank;
  if (!valid_shape(batch, L, cluster)) return cudaErrorInvalidValue;
  return launch_clusters(
      lambda_cluster_bwd_kernel, batch, cluster,
      static_cast<cudaStream_t>(stream), static_cast<const float*>(yp),
      static_cast<const float*>(ts), static_cast<const float*>(g),
      static_cast<const float*>(valid), static_cast<const float*>(d_row),
      static_cast<const float*>(delta), static_cast<const float*>(gout),
      static_cast<float*>(dyp),
      chain_args(L, k_eff, scheme, binary, sigma, mu, eps, log_eps));
}
