// The lambdaLoss pair chain as device code, shared by the cluster kernel
// (lambda_pairs.cu, k <= 384) and the row-tile x column-stripe kernel
// (lambda_tiled.cu, k <= 4096) so that the two cannot drift: for a pair
// (i, j) of one slate's prediction-sorted top-k block
//   sel  = valid_i & valid_j & (ts_i > ts_j, except for ndcgLoss1)
//          & (i, j < k_eff)
//   s    = sigmoid(sigma * clip(yp_i - yp_j, +-1e8)), a = max(s, eps)
//   logs = max(w_ij * log a, log eps) [/ ln 2]
//   c    = sel * [w log a > log eps] * (w / a) [/ ln 2]
//          * [s > eps] * sigma s (1 - s)
// (the JAX package's ops/lambda_pallas.py, _chain at lines 71-102 and the
// backward's w / a collapse at lines 127-135). Each kernel tests sel itself
// and calls selected_term for a selected pair only, so an unselected pair
// pays for the test and nothing else. Exact fp32: expf, logf and true
// division, no fast-math flag.
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

struct Row {  // a slate's documents (or a range of them) in shared memory
  const float *yp, *ts, *g, *valid, *d_row, *delta;
};

struct Slate {  // the rows, and the per-row quotients the chain divides out
  Row row;
  const float *inv_d, *g_over_d;
};

// The log term (want_grad false) or the gradient factor c (true) of a
// selected pair whose row document is rs's entry ri and whose column
// document is cs's entry cj, |i - j| = dist apart: yp, ts, g and 1 / d_row
// of both sides, g / d_row of the row and the ndcgLoss2 delta of the
// distance (rs.row.delta[dist]). 1 / d_row and g / d_row are the fp32
// divisions of the chain, taken once a document, so each pair keeps its
// bits. Both documents are valid, so the difference is taken unmasked.
__device__ __forceinline__ float selected_term(const ChainArgs& a,
                                               const Slate& rs, int ri,
                                               const Slate& cs, int cj,
                                               int dist, bool want_grad) {
  float d = rs.row.yp[ri] - cs.row.yp[cj];
  d = fminf(fmaxf(d, -1e8f), 1e8f);
  const float s = 1.f / (1.f + expf(-(a.sigma * d)));
  const float am = fmaxf(s, a.eps);
  bool weighted = true;
  float w = 1.f;
  switch (a.scheme) {
    case kNdcgLoss1:
      w = rs.g_over_d[ri];
      break;
    case kGTDiff:
      w = fabsf(rs.row.ts[ri] - cs.row.ts[cj]);
      break;
    case kGTDiffPowed:
      w = fabsf(rs.row.ts[ri] * rs.row.ts[ri] - cs.row.ts[cj] * cs.row.ts[cj]);
      break;
    case kNdcgLoss2:
    case kLambdaRank:
    case kNdcgLoss2PP: {
      const float gdiff = fabsf(rs.row.g[ri] - cs.row.g[cj]);
      const float nd2 = rs.row.delta[dist] * gdiff;
      const float lrank = fabsf(rs.inv_d[ri] - cs.inv_d[cj]) * gdiff;
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
  if (!want_grad) {
    const float logs = fmaxf(wlog, a.log_eps);
    return a.binary ? logs / kLn2 : logs;
  }
  const float w_over_a = weighted ? w / am : 1.f / am;
  const float c = wlog > a.log_eps ? w_over_a / (a.binary ? kLn2 : 1.f)
                                   : 0.f;
  return c * (s > a.eps ? a.sigma * s * (1.f - s) : 0.f);
}

// selected_term of the pair (i, j) of one slate held whole in sl.
__device__ __forceinline__ float selected_pair(const Slate& sl,
                                               const ChainArgs& a, int i,
                                               int j, bool want_grad) {
  return selected_term(a, sl, i, sl, j, abs(i - j), want_grad);
}

}  // namespace allrank
