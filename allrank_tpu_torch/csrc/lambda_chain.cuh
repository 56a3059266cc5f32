// The lambdaLoss pair chain as a device function, shared by the one-block
// kernel (lambda_pairs.cu, k <= 384) and the row-tiled kernel
// (lambda_tiled.cu, k <= 4096) so that the two cannot drift: for a pair
// (i, j) of one slate's prediction-sorted top-k block
//   sel  = valid_i & valid_j & (ts_i > ts_j, except for ndcgLoss1)
//          & (i, j < k_eff)
//   s    = sigmoid(sigma * clip(yp_i - yp_j, +-1e8)), a = max(s, eps)
//   logs = max(w_ij * log a, log eps) [/ ln 2]
//   c    = sel * [w log a > log eps] * (w / a) [/ ln 2]
//          * [s > eps] * sigma s (1 - s)
// (the JAX package's ops/lambda_pallas.py, _chain at lines 71-102 and the
// backward's w / a collapse at lines 127-135). Exact fp32: expf, logf and
// true division, no fast-math flag.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace allrank {

constexpr float kLn2 = 0.6931471805599453f;

// the weighing schemes, in the order ops/lambda_pairs.py numbers them
enum Scheme {
  kNone = 0,
  kNdcgLoss1 = 1,
  kNdcgLoss2 = 2,
  kLambdaRank = 3,
  kNdcgLoss2PP = 4,
  kRankNet = 5,
  kGTDiff = 6,
  kGTDiffPowed = 7,
};

struct ChainArgs {
  int L, k_eff, scheme, binary;
  float sigma, mu, eps, log_eps;
};

struct Row {  // the slate's rows in shared memory
  const float *yp, *ts, *g, *valid, *d_row, *delta;
};

struct PairOut {
  bool sel;
  float logs, c;
};

__device__ __forceinline__ PairOut pair(const Row& row, const ChainArgs& a,
                                        int i, int j, bool want_grad) {
  PairOut out;
  const bool pv = row.valid[i] > 0.5f && row.valid[j] > 0.5f;
  bool sel = pv;
  if (a.scheme != kNdcgLoss1) sel = sel && (row.ts[i] - row.ts[j]) > 0.f;
  if (a.k_eff < a.L) sel = sel && i < a.k_eff && j < a.k_eff;
  float d = pv ? row.yp[i] - row.yp[j] : 0.f;
  d = fminf(fmaxf(d, -1e8f), 1e8f);
  const float s = 1.f / (1.f + expf(-(a.sigma * d)));
  const float am = fmaxf(s, a.eps);
  bool weighted = true;
  float w = 1.f;
  switch (a.scheme) {
    case kNdcgLoss1:
      w = row.g[i] / row.d_row[i];
      break;
    case kGTDiff:
      w = fabsf(row.ts[i] - row.ts[j]);
      break;
    case kGTDiffPowed:
      w = fabsf(row.ts[i] * row.ts[i] - row.ts[j] * row.ts[j]);
      break;
    case kNdcgLoss2:
    case kLambdaRank:
    case kNdcgLoss2PP: {
      const float gdiff = fabsf(row.g[i] - row.g[j]);
      const float nd2 = row.delta[abs(i - j)] * gdiff;
      const float lrank =
          fabsf(1.f / row.d_row[i] - 1.f / row.d_row[j]) * gdiff;
      w = a.scheme == kNdcgLoss2 ? nd2
          : a.scheme == kLambdaRank ? lrank
                                    : a.mu * nd2 + lrank;
      break;
    }
    default:  // none and rankNet: weight 1, the power is the identity
      weighted = false;
  }
  const float log_a = logf(am);
  const float wlog = weighted ? w * log_a : log_a;
  float logs = fmaxf(wlog, a.log_eps);
  if (a.binary) logs = logs / kLn2;
  out.sel = sel;
  out.logs = logs;
  out.c = 0.f;
  if (want_grad && sel) {
    const float w_over_a = weighted ? w / am : 1.f / am;
    float c = wlog > a.log_eps ? w_over_a / (a.binary ? kLn2 : 1.f) : 0.f;
    out.c = c * (s > a.eps ? a.sigma * s * (1.f - s) : 0.f);
  }
  return out;
}

// The rows of slate `slate` and the two position tables into shared memory,
// six arrays of `pitch` floats each (pitch >= L), by the whole block.
__device__ __forceinline__ Row load_row(float* sm, int pitch, int slate,
                                        const float* yp, const float* ts,
                                        const float* g, const float* valid,
                                        const float* d_row,
                                        const float* delta, int L) {
  const size_t o = (size_t)slate * L;
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    sm[i] = yp[o + i];
    sm[pitch + i] = ts[o + i];
    sm[2 * pitch + i] = g[o + i];
    sm[3 * pitch + i] = valid[o + i];
    sm[4 * pitch + i] = d_row[i];
    sm[5 * pitch + i] = delta[i];
  }
  __syncthreads();
  return Row{sm, sm + pitch, sm + 2 * pitch, sm + 3 * pitch, sm + 4 * pitch,
             sm + 5 * pitch};
}

}  // namespace allrank
