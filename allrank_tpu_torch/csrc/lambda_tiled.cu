// The lambdaLoss pair chain for long top-k blocks on Hopper (sm_90a), fp32,
// forward and backward: 384 < k <= 4096, past the cluster kernel's length
// (lambda_pairs.cu).
//
// Replaces the TPU kernel `tiled_lambda_pairs` of the JAX package's
// ops/lambda_tiled.py:280 (forward pallas_call at line 237, backward at line
// 261; the tile body _chain_tiled, lines 72-99). The per-pair arithmetic is
// lambda_chain.cuh's selected_term, the one lambda_pairs.cu runs, so the two
// kernels give the same pair values.
//
// What bounds it: operations, and of them the pairs' exp, log and divisions
// on the SIMT units. The inputs are four [B, k] rows and two [k] tables (0.4
// MB at B=16, k=1024); the work is B k^2 pair tests and, for the selected
// pairs (about a third at that shape: labels 0-4, a 100-document padding
// tail), one expf, one logf and up to four IEEE divisions each.
//
// Design. A block of 8 warps takes one slate's tile of rows (16 to k =
// 1024, 32 beyond) against one stripe of its columns: k split into
// ceil(k / 512) stripes of equal width (ops/lambda_tiled.py's tile_plan;
// 2048 blocks at (16, 1024), 8192 at (8, 4096): enough warps to hide the
// chain's latency, while the tile still amortises staging its stripe). It
// stages the stripe's columns and the tile's rows in shared memory, with
// the per-document quotients 1 / d_row and g / d_row (the chain's fp32
// divisions, taken once a document, so each pair keeps its bits). A warp
// takes rows w, w + 8, ... of the tile; a row that selects nothing
// (padded, at or past k_eff) is skipped whole, and the sweep ends at the
// stripe's last column that can be selected, so a padding tail costs
// nothing past the test. For a live row
// the warp tests 32 columns at a time (no transcendental) and queues the
// selected ones in a ring of 64 in shared memory; each time 32 are queued,
// every lane evaluates one, so the exp, the log and the divisions run for
// selected pairs only and with every lane at work (a warp that evaluated
// its 32 columns in place would run the chain for a third of its lanes).
//   forward:  each lane sums its pairs' loss terms, the warp counts its
//             selected pairs from the tests (an integer, exact); a
//             butterfly across the warp and the warps in order give the
//             block's partials in a [2, blocks + 1, B] buffer, and a second
//             kernel adds a slate's partials in a fixed order into the last
//             row.
//   backward: each ordered pair is evaluated once. c_ij adds to row i's
//             sum (a butterfly across the warp at the row's end) and to
//             column j's in the warp's own [stripe] array of column partials
//             in shared memory: the lanes of a batch hold distinct columns,
//             so no two write one word. The block adds its warps' column
//             partials in warp order; row sums (one a stripe) and column
//             partials (one a row tile) go to a [B, stripes + tiles, k]
//             scratch, and a second kernel writes dyp_i = gout (sum of row
//             i's stripes - sum of column i's tiles), each sum in a fixed
//             order.
// A thread-block cluster a slate with the column partials in distributed
// shared memory (lambda_pairs.cu's design) does not carry to k = 4096: each
// warp needs its own [k] partials (8 x 16 KB) beside the slate's 8 x 16 KB
// of rows, more than a block's 227 KB, and 8 blocks a slate fill only 64 of
// the 132 SMs at (8, 4096). Nothing is added atomically and every sum runs
// in a fixed order, so a second run gives the same bits; counts are exact.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"
#include "lambda_chain.cuh"

namespace allrank {
namespace {

constexpr int kMaxTiledK = 4096;
constexpr int kTiledThreads = 256;  // 8 warps
constexpr int kTiledWarps = kTiledThreads / 32;
constexpr int kTileRows = 32;       // rows of a block's tile, 4 a warp,
constexpr int kShortTileRows = 16;  // but 16, 2 a warp, up to kShortK
constexpr int kShortK = 1024;
constexpr int kMaxStripe = 512;  // columns of a block's stripe
constexpr int kRing = 64;         // a warp's queue of selected columns
constexpr int kColArrays = 5;     // yp, ts, g, selectable, 1 / d_row

struct Plan {
  int tiles, stripes, stripe, rows;  // row tiles, column stripes, stripe
                                     // width, rows a tile
};

// Tiles of 16 rows to L = 1024, of 32 beyond; ceil(L / 512) stripes of
// equal width, rounded up to whole warps
Plan plan_of(int L) {
  const int rows = L <= kShortK ? kShortTileRows : kTileRows;
  const int stripes = (L + kMaxStripe - 1) / kMaxStripe;
  const int width = (L + stripes - 1) / stripes;
  return Plan{(L + rows - 1) / rows, stripes, (width + 31) / 32 * 32, rows};
}

size_t shared_bytes(const Plan& p, bool grad) {
  return (size_t)(kColArrays + (grad ? kTiledWarps : 0)) * p.stripe *
         sizeof(float);
}

// The forward (kGrad false): out is the [2, blocks + 1, B] buffer of
// partials, blocks = tiles * stripes. The backward: out is the [B, stripes
// + tiles, L] scratch, row i's sum over stripe s at [b, s, i] and column
// j's partial over row tile t at [b, stripes + t, j].
template <bool kGrad>
__global__ void __launch_bounds__(kTiledThreads)
    tiled_pairs_kernel(const float* __restrict__ yp,
                       const float* __restrict__ ts,
                       const float* __restrict__ g,
                       const float* __restrict__ valid,
                       const float* __restrict__ d_row,
                       const float* __restrict__ delta,
                       float* __restrict__ out, ChainArgs a, Plan p) {
  extern __shared__ float sm[];
  __shared__ float rows[6][kTileRows];  // yp, ts, g, live, 1/d, g/d
  __shared__ int ring[kTiledWarps][kRing];
  __shared__ float warp_loss[kTiledWarps];
  __shared__ int warp_int[kTiledWarps];
  const int blocks = p.tiles * p.stripes;
  const int slate = blockIdx.x / blocks, blk = blockIdx.x % blocks;
  const int tile = blk / p.stripes, stripe = blk % p.stripes;
  const int L = a.L, i0 = tile * p.rows, j0 = stripe * p.stripe;
  // rows and columns at or past `top` select nothing
  const int top = a.k_eff < L ? max(a.k_eff, 0) : L;
  const int width = max(0, min(p.stripe, L - j0));
  const int nrows = min(p.rows, L - i0);
  const size_t o = (size_t)slate * L;
  float* c_yp = sm;
  float* c_ts = sm + p.stripe;
  float* c_g = sm + 2 * p.stripe;
  float* c_ok = sm + 3 * p.stripe;  // 1 where column j can be selected
  float* c_inv_d = sm + 4 * p.stripe;
  float* col_part = sm + kColArrays * p.stripe;  // [warp][stripe], kGrad
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  int end = 0;  // one past this thread's last selectable column
  for (int cj = threadIdx.x; cj < p.stripe; cj += kTiledThreads) {
    const int j = j0 + cj;
    float y = 0.f, t = 0.f, gj = 0.f, ok = 0.f, inv_d = 0.f;
    if (cj < width) {
      y = yp[o + j];
      t = ts[o + j];
      gj = g[o + j];
      ok = valid[o + j] > 0.5f && j < top ? 1.f : 0.f;
      inv_d = 1.f / d_row[j];
    }
    c_yp[cj] = y;
    c_ts[cj] = t;
    c_g[cj] = gj;
    c_ok[cj] = ok;
    c_inv_d[cj] = inv_d;
    if (ok > 0.f) end = cj + 1;
  }
  if (kGrad) {
    for (int x = threadIdx.x; x < kTiledWarps * p.stripe; x += kTiledThreads)
      col_part[x] = 0.f;
  }
  if (threadIdx.x < p.rows) {
    const int ri = threadIdx.x, i = i0 + ri;
    float y = 0.f, t = 0.f, gi = 0.f, live = 0.f, inv_d = 0.f, g_d = 0.f;
    if (ri < nrows) {
      const float di = d_row[i];
      y = yp[o + i];
      t = ts[o + i];
      gi = g[o + i];
      live = valid[o + i] > 0.5f && i < top ? 1.f : 0.f;
      inv_d = 1.f / di;
      g_d = gi / di;
    }
    rows[0][ri] = y;
    rows[1][ri] = t;
    rows[2][ri] = gi;
    rows[3][ri] = live;
    rows[4][ri] = inv_d;
    rows[5][ri] = g_d;
  }
  end = __reduce_max_sync(0xffffffffu, end);
  if (lane == 0) warp_int[warp] = end;
  __syncthreads();
  int scan_end = 0;
#pragma unroll
  for (int w = 0; w < kTiledWarps; ++w) scan_end = max(scan_end, warp_int[w]);

  const Slate rs{Row{rows[0], rows[1], rows[2], rows[3], nullptr, delta},
                 rows[4], rows[5]};
  const Slate cs{Row{c_yp, c_ts, c_g, c_ok, nullptr, nullptr}, c_inv_d,
                 nullptr};
  int* queue = ring[warp];
  float* my_cols = col_part + warp * p.stripe;
  const unsigned below = (1u << lane) - 1u;
  float loss = 0.f;
  int count = 0;
  for (int ri = warp; ri < nrows; ri += kTiledWarps) {
    const int i = i0 + ri;
    float row_sum = 0.f;
    // the pair (i, j0 + cj) into this lane's sums
    auto take = [&](int cj) {
      const float v = selected_term(a, rs, ri, cs, cj, abs(i - j0 - cj),
                                    kGrad);
      if constexpr (kGrad) {
        row_sum += v;
        my_cols[cj] += v;
      } else {
        loss += v;
      }
    };
    if (rows[3][ri] > 0.5f) {
      const float ts_i = rows[1][ri];
      int head = 0, tail = 0;
      for (int c0 = 0; c0 < scan_end; c0 += 32) {
        const int cj = c0 + lane;
        bool sel = c_ok[cj] > 0.5f;
        if (a.scheme != kNdcgLoss1) sel = sel && (ts_i - c_ts[cj]) > 0.f;
        const unsigned m = __ballot_sync(0xffffffffu, sel);
        if (sel) queue[(tail + __popc(m & below)) & (kRing - 1)] = cj;
        tail += __popc(m);
        if (tail - head >= 32) {
          __syncwarp();
          take(queue[(head + lane) & (kRing - 1)]);
          head += 32;
          __syncwarp();  // the slots read are written again next
        }
      }
      __syncwarp();
      if (lane < tail - head) take(queue[(head + lane) & (kRing - 1)]);
      __syncwarp();
      count += tail;
    }
    if (kGrad) {
      row_sum = warp_sum(row_sum);
      if (lane == 0)
        out[((size_t)slate * (p.stripes + p.tiles) + stripe) * L + i] =
            row_sum;
    }
  }

  if (kGrad) {
    __syncthreads();
    float* col_out =
        out + ((size_t)slate * (p.stripes + p.tiles) + p.stripes + tile) * L +
        j0;
    for (int cj = threadIdx.x; cj < width; cj += kTiledThreads) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kTiledWarps; ++w) s += col_part[w * p.stripe + cj];
      col_out[cj] = s;
    }
  } else {
    loss = warp_sum(loss);
    __syncthreads();  // every warp has read warp_int
    if (lane == 0) {
      warp_loss[warp] = loss;
      warp_int[warp] = count;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float ls = 0.f;
      int cs_total = 0;
      for (int w = 0; w < kTiledWarps; ++w) {
        ls += warp_loss[w];
        cs_total += warp_int[w];
      }
      const size_t batch = gridDim.x / blocks, at = (size_t)blk * batch + slate;
      out[at] = ls;
      out[(blocks + 1) * batch + at] = (float)cs_total;
    }
  }
}

// buf[0 | 1, blocks, b] = the slate's partials added in a fixed order, a
// warp per slate.
__global__ void tiled_sum_kernel(float* __restrict__ buf, int batch,
                                 int blocks) {
  const int slate = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (slate >= batch) return;
  float* cnt = buf + (size_t)(blocks + 1) * batch;
  float ls = 0.f, cs = 0.f;
  for (int t = lane; t < blocks; t += 32) {
    ls += buf[(size_t)t * batch + slate];
    cs += cnt[(size_t)t * batch + slate];
  }
  ls = warp_sum(ls);
  cs = warp_sum(cs);
  if (lane == 0) {
    buf[(size_t)blocks * batch + slate] = ls;
    cnt[(size_t)blocks * batch + slate] = cs;
  }
}

// dyp[b, i] = gout[b] * (row i's stripe sums - column i's tile partials),
// each added in order, from the backward's scratch.
__global__ void tiled_finish_kernel(const float* __restrict__ part,
                                    const float* __restrict__ gout,
                                    float* __restrict__ dyp, int batch, int L,
                                    Plan p) {
  const size_t at = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (at >= (size_t)batch * L) return;
  const int slate = (int)(at / L), i = (int)(at % L);
  const float* rows = part + (size_t)slate * (p.stripes + p.tiles) * L + i;
  const float* cols = rows + (size_t)p.stripes * L;
  float out_sum = 0.f, in_sum = 0.f;
  for (int s = 0; s < p.stripes; ++s) out_sum += rows[(size_t)s * L];
  for (int t = 0; t < p.tiles; ++t) in_sum += cols[(size_t)t * L];
  dyp[at] = (out_sum - in_sum) * gout[slate];
}

template <class Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The plan for L, or a zero plan if L is out of range or the caller's
// (tiles, stripes) differ from it.
Plan checked_plan(int batch, int L, int tiles, int stripes) {
  if (L < 1 || L > kMaxTiledK || batch < 1) return Plan{0, 0, 0, 0};
  const Plan p = plan_of(L);
  if (p.tiles != tiles || p.stripes != stripes) return Plan{0, 0, 0, 0};
  return p;
}

}  // namespace
}  // namespace allrank

// Forward on `stream`, from yp, ts, g, valid [B, L] fp32, d_row = log2(i + 2)
// and delta (the ndcgLoss2 delta of distance i) [L]; L <= 4096, (tiles,
// stripes) the plan of L (ops/lambda_tiled.py's tile_plan). buf is [2,
// tiles * stripes + 1, B]: the loss sums [B] come back in its row [0,
// tiles * stripes], the counts in [1, tiles * stripes]; the rows before
// are scratch. Returns 0 or the CUDA error code.
extern "C" int lambda_tiled_fwd(const void* yp, const void* ts, const void* g,
                                const void* valid, const void* d_row,
                                const void* delta, void* buf, int batch,
                                int L, int k_eff, int scheme, int binary,
                                float sigma, float mu, float eps,
                                float log_eps, int tiles, int stripes,
                                void* stream) {
  using namespace allrank;
  const Plan p = checked_plan(batch, L, tiles, stripes);
  if (p.tiles == 0) return cudaErrorInvalidValue;
  const size_t shared = shared_bytes(p, false);
  cudaError_t err = allow_shared(tiled_pairs_kernel<false>, shared);
  if (err != cudaSuccess) return err;
  const int blocks = p.tiles * p.stripes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  tiled_pairs_kernel<false><<<batch * blocks, kTiledThreads, shared, s>>>(
      static_cast<const float*>(yp), static_cast<const float*>(ts),
      static_cast<const float*>(g), static_cast<const float*>(valid),
      static_cast<const float*>(d_row), static_cast<const float*>(delta),
      static_cast<float*>(buf),
      ChainArgs{L, k_eff, scheme, binary, sigma, mu, eps, log_eps}, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int slates_per_block = kTiledThreads / 32;
  tiled_sum_kernel<<<(batch + slates_per_block - 1) / slates_per_block,
                     kTiledThreads, 0, s>>>(static_cast<float*>(buf), batch,
                                            blocks);
  return cudaGetLastError();
}

// Backward on `stream`: dyp [B, L] from the forward's inputs and gout [B],
// the loss sums' cotangent; part is a [B, stripes + tiles, L] fp32 scratch.
extern "C" int lambda_tiled_bwd(const void* yp, const void* ts, const void* g,
                                const void* valid, const void* d_row,
                                const void* delta, const void* gout,
                                void* dyp, void* part, int batch, int L,
                                int k_eff, int scheme, int binary, float sigma,
                                float mu, float eps, float log_eps, int tiles,
                                int stripes, void* stream) {
  using namespace allrank;
  const Plan p = checked_plan(batch, L, tiles, stripes);
  if (p.tiles == 0) return cudaErrorInvalidValue;
  const size_t shared = shared_bytes(p, true);
  cudaError_t err = allow_shared(tiled_pairs_kernel<true>, shared);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  tiled_pairs_kernel<true>
      <<<batch * p.tiles * p.stripes, kTiledThreads, shared, s>>>(
          static_cast<const float*>(yp), static_cast<const float*>(ts),
          static_cast<const float*>(g), static_cast<const float*>(valid),
          static_cast<const float*>(d_row), static_cast<const float*>(delta),
          static_cast<float*>(part),
          ChainArgs{L, k_eff, scheme, binary, sigma, mu, eps, log_eps}, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)batch * L;
  tiled_finish_kernel<<<(unsigned)((n + kTiledThreads - 1) / kTiledThreads),
                        kTiledThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<const float*>(gout),
      static_cast<float*>(dyp), batch, L, p);
  return cudaGetLastError();
}
