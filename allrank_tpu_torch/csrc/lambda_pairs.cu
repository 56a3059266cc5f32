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
// per-pair device function lives in lambda_chain.cuh, shared with the
// row-tiled kernel for longer blocks (lambda_tiled.cu).
//
// What bounds it: neither bytes nor products. The inputs are five [B, k]
// rows (some 300 KB at B=64, k=240); the work is O(B k^2) pair evaluations
// of a few transcendentals each (about 3.7 M pairs, one exp and one log
// apiece), far below the card's rate for either, so launch and latency
// dominate.
//
// Design: one block per slate, one thread per row i (k <= 384, the JAX
// kernel's MAX_FUSED_LENGTH). The slate's rows of yp, ts, g, valid, the
// log2 discounts and the ndcgLoss2 delta table live in shared memory; the
// deltas depend only on |i - j|, so the table is the host's float64 values
// rounded to fp32, indexed by distance, not a [k, k] table. The forward's
// per-slate sums and the backward's per-row sums are taken in a fixed order
// (each thread owns row i and evaluates both c_ij and c_ji), so the results
// need no atomics and are deterministic.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"
#include "lambda_chain.cuh"

namespace allrank {
namespace {

constexpr int kMaxK = 384;

// loss[b] = sum over selected pairs, cnt[b] = their count; the row sums go
// through shared memory and are added in order of i by one thread.
__global__ void lambda_fwd_kernel(const float* __restrict__ yp,
                                  const float* __restrict__ ts,
                                  const float* __restrict__ g,
                                  const float* __restrict__ valid,
                                  const float* __restrict__ d_row,
                                  const float* __restrict__ delta,
                                  float* __restrict__ loss,
                                  float* __restrict__ cnt, ChainArgs a) {
  __shared__ float sm[6 * kMaxK];
  __shared__ float row_loss[kMaxK], row_cnt[kMaxK];
  const Row row = load_row(sm, kMaxK, blockIdx.x, yp, ts, g, valid, d_row,
                           delta, a.L);
  for (int i = threadIdx.x; i < a.L; i += blockDim.x) {
    float ls = 0.f, cs = 0.f;
    for (int j = 0; j < a.L; ++j) {
      const PairOut p = pair(row, a, i, j, false);
      if (p.sel) {
        ls += p.logs;
        cs += 1.f;
      }
    }
    row_loss[i] = ls;
    row_cnt[i] = cs;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ls = 0.f, cs = 0.f;
    for (int i = 0; i < a.L; ++i) {
      ls += row_loss[i];
      cs += row_cnt[i];
    }
    loss[blockIdx.x] = ls;
    cnt[blockIdx.x] = cs;
  }
}

// dyp[b, i] = gout[b] * (sum_j c_ij - sum_j c_ji)
__global__ void lambda_bwd_kernel(const float* __restrict__ yp,
                                  const float* __restrict__ ts,
                                  const float* __restrict__ g,
                                  const float* __restrict__ valid,
                                  const float* __restrict__ d_row,
                                  const float* __restrict__ delta,
                                  const float* __restrict__ gout,
                                  float* __restrict__ dyp, ChainArgs a) {
  __shared__ float sm[6 * kMaxK];
  const Row row = load_row(sm, kMaxK, blockIdx.x, yp, ts, g, valid, d_row,
                           delta, a.L);
  const float go = gout[blockIdx.x];
  for (int i = threadIdx.x; i < a.L; i += blockDim.x) {
    float out_sum = 0.f, in_sum = 0.f;
    for (int j = 0; j < a.L; ++j) {
      out_sum += pair(row, a, i, j, true).c;
      in_sum += pair(row, a, j, i, true).c;
    }
    dyp[(size_t)blockIdx.x * a.L + i] = (out_sum - in_sum) * go;
  }
}

}  // namespace
}  // namespace allrank

namespace {
allrank::ChainArgs chain_args(int L, int k_eff, int scheme, int binary,
                              float sigma, float mu, float eps,
                              float log_eps) {
  return allrank::ChainArgs{L, k_eff, scheme, binary, sigma, mu, eps, log_eps};
}
int threads_for(int L) { return ((L + 31) / 32) * 32; }
}  // namespace

// Forward on `stream`: loss, cnt [B] from yp, ts, g, valid [B, L] fp32,
// d_row = log2(i + 2) and delta (the ndcgLoss2 delta of distance i) [L];
// L <= 384. Returns 0 or the CUDA error code.
extern "C" int lambda_pairs_fwd(const void* yp, const void* ts, const void* g,
                                const void* valid, const void* d_row,
                                const void* delta, void* loss, void* cnt,
                                int batch, int L, int k_eff, int scheme,
                                int binary, float sigma, float mu, float eps,
                                float log_eps, void* stream) {
  allrank::lambda_fwd_kernel<<<batch, threads_for(L), 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(yp), static_cast<const float*>(ts),
      static_cast<const float*>(g), static_cast<const float*>(valid),
      static_cast<const float*>(d_row), static_cast<const float*>(delta),
      static_cast<float*>(loss), static_cast<float*>(cnt),
      chain_args(L, k_eff, scheme, binary, sigma, mu, eps, log_eps));
  return cudaGetLastError();
}

// Backward on `stream`: dyp [B, L] from the forward's inputs and gout [B],
// the loss sums' cotangent.
extern "C" int lambda_pairs_bwd(const void* yp, const void* ts, const void* g,
                                const void* valid, const void* d_row,
                                const void* delta, const void* gout,
                                void* dyp, int batch, int L, int k_eff,
                                int scheme, int binary, float sigma, float mu,
                                float eps, float log_eps, void* stream) {
  allrank::lambda_bwd_kernel<<<batch, threads_for(L), 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(yp), static_cast<const float*>(ts),
      static_cast<const float*>(g), static_cast<const float*>(valid),
      static_cast<const float*>(d_row), static_cast<const float*>(delta),
      static_cast<const float*>(gout), static_cast<float*>(dyp),
      chain_args(L, k_eff, scheme, binary, sigma, mu, eps, log_eps));
  return cudaGetLastError();
}
