// The lambdaLoss pair chain for long top-k blocks on Hopper (sm_90a), fp32,
// forward and backward: 384 < k <= 4096, where one block per slate and one
// thread per row (lambda_pairs.cu) no longer fits.
//
// Replaces the TPU kernel `tiled_lambda_pairs` of the JAX package's
// ops/lambda_tiled.py:280 (forward pallas_call at line 237, backward at line
// 261; the tile body _chain_tiled, lines 72-99). The per-pair arithmetic is
// the device function of lambda_chain.cuh, the same one lambda_pairs.cu
// runs, so the two kernels give the same pair values.
//
// What bounds it: operations. The inputs are four [B, k] rows and two [k]
// tables (0.4 MB at B=16, k=1024); the work is B k^2 pair evaluations of one
// expf, one logf and a few divisions each (16.8 M pairs at that shape), all
// on the SIMT units.
//
// Design. The TPU kernel tiles both pair axes because a [bb, Ti, Tj] tile
// must fit VMEM, pads k to a multiple of 128 and sums the column term of the
// backward through an [k/Ti, B, k] auxiliary. None of that carries over: a
// pair is evaluated in registers, so only the slate's six [k] vectors need
// to be near, and at k = 4096 they are 96 KB of a block's 227 KB of shared
// memory. So: grid (slate, row tile of 32 rows), the whole slate in dynamic
// shared memory, a warp per row i sweeping j (lane l takes j = l, l + 32,
// ...), no padding (the sweep stops at k). Rows that are not valid, or lie
// at or beyond k_eff, select no pair and are skipped.
//   forward:  each block writes the partial loss and count of its rows
//             into one [2, tiles + 1, B] buffer; a second kernel adds a
//             slate's partials in a fixed order into the buffer's last row.
//   backward: for its row i the warp evaluates c_ij and the transposed c_ji
//             in one sweep and writes dyp_i = gout (sum_j c_ij - sum_j c_ji)
//             once: no auxiliary, no atomics, the same bits every run.
// Counts are fp32 sums of 0/1, exact up to 2^24 = 4096^2 per slate.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"
#include "lambda_chain.cuh"

namespace allrank {
namespace {

constexpr int kMaxTiledK = 4096;
constexpr int kTiledThreads = 256;  // 8 warps
constexpr int kRowsPerBlock = 32;   // 4 rows a warp

__device__ __forceinline__ bool row_selects(const Row& row,
                                            const ChainArgs& a, int i) {
  return row.valid[i] > 0.5f && !(a.k_eff < a.L && i >= a.k_eff);
}

// buf[0 | 1, tile, slate] = (loss | count) over the tile's rows; buf is
// [2, gridDim.y + 1, gridDim.x]
__global__ void tiled_fwd_kernel(const float* __restrict__ yp,
                                 const float* __restrict__ ts,
                                 const float* __restrict__ g,
                                 const float* __restrict__ valid,
                                 const float* __restrict__ d_row,
                                 const float* __restrict__ delta,
                                 float* __restrict__ buf, ChainArgs a) {
  extern __shared__ float sm[];
  __shared__ float warp_loss[kRowsPerBlock], warp_cnt[kRowsPerBlock];
  const int slate = blockIdx.x, tile = blockIdx.y;
  const Row row = load_row(sm, a.L, slate, yp, ts, g, valid, d_row, delta,
                           a.L);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRowsPerBlock; r += kTiledThreads / 32) {
    const int i = tile * kRowsPerBlock + r;
    float ls = 0.f, cs = 0.f;
    if (i < a.L && row_selects(row, a, i)) {
      for (int j = lane; j < a.L; j += 32) {
        const PairOut p = pair(row, a, i, j, false);
        if (p.sel) {
          ls += p.logs;
          cs += 1.f;
        }
      }
    }
    ls = warp_sum(ls);
    cs = warp_sum(cs);
    if (lane == 0) {
      warp_loss[r] = ls;
      warp_cnt[r] = cs;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ls = 0.f, cs = 0.f;
    for (int r = 0; r < kRowsPerBlock; ++r) {
      ls += warp_loss[r];
      cs += warp_cnt[r];
    }
    const size_t batch = gridDim.x, at = (size_t)tile * batch + slate;
    buf[at] = ls;
    buf[(gridDim.y + 1) * batch + at] = cs;
  }
}

// buf[0 | 1, tiles, b] = the slate's partials added in a fixed order, a warp
// per slate.
__global__ void tiled_sum_kernel(float* __restrict__ buf, int batch,
                                 int tiles) {
  const int slate = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (slate >= batch) return;
  float* cnt = buf + (size_t)(tiles + 1) * batch;
  float ls = 0.f, cs = 0.f;
  for (int t = lane; t < tiles; t += 32) {
    ls += buf[(size_t)t * batch + slate];
    cs += cnt[(size_t)t * batch + slate];
  }
  ls = warp_sum(ls);
  cs = warp_sum(cs);
  if (lane == 0) {
    buf[(size_t)tiles * batch + slate] = ls;
    cnt[(size_t)tiles * batch + slate] = cs;
  }
}

// dyp[b, i] = gout[b] * (sum_j c_ij - sum_j c_ji)
__global__ void tiled_bwd_kernel(const float* __restrict__ yp,
                                 const float* __restrict__ ts,
                                 const float* __restrict__ g,
                                 const float* __restrict__ valid,
                                 const float* __restrict__ d_row,
                                 const float* __restrict__ delta,
                                 const float* __restrict__ gout,
                                 float* __restrict__ dyp, ChainArgs a) {
  extern __shared__ float sm[];
  const int slate = blockIdx.x, tile = blockIdx.y;
  const Row row = load_row(sm, a.L, slate, yp, ts, g, valid, d_row, delta,
                           a.L);
  const float go = gout[slate];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRowsPerBlock; r += kTiledThreads / 32) {
    const int i = tile * kRowsPerBlock + r;
    if (i >= a.L) break;
    float out_sum = 0.f, in_sum = 0.f;
    if (row_selects(row, a, i)) {
      for (int j = lane; j < a.L; j += 32) {
        out_sum += pair(row, a, i, j, true).c;
        in_sum += pair(row, a, j, i, true).c;
      }
    }
    out_sum = warp_sum(out_sum);
    in_sum = warp_sum(in_sum);
    if (lane == 0) dyp[(size_t)slate * a.L + i] = (out_sum - in_sum) * go;
  }
}

template <class Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace
}  // namespace allrank

namespace {
int tiles_for(int L) {
  return (L + allrank::kRowsPerBlock - 1) / allrank::kRowsPerBlock;
}
}  // namespace

// Forward on `stream`, from yp, ts, g, valid [B, L] fp32, d_row = log2(i + 2)
// and delta (the ndcgLoss2 delta of distance i) [L]; L <= 4096. buf is
// [2, tiles + 1, B] with tiles = ceil(L / 32): the loss sums [B] come back in
// buf[0, tiles], the counts in buf[1, tiles]; the rows before are scratch.
// Returns 0 or the CUDA error code.
extern "C" int lambda_tiled_fwd(const void* yp, const void* ts, const void* g,
                                const void* valid, const void* d_row,
                                const void* delta, void* buf, int batch,
                                int L, int k_eff, int scheme, int binary,
                                float sigma, float mu, float eps,
                                float log_eps, void* stream) {
  using namespace allrank;
  if (L < 1 || L > kMaxTiledK || batch < 1) return cudaErrorInvalidValue;
  const size_t shared = 6 * (size_t)L * sizeof(float);
  cudaError_t err = allow_shared(tiled_fwd_kernel, shared);
  if (err != cudaSuccess) return err;
  const int tiles = tiles_for(L);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  tiled_fwd_kernel<<<dim3(batch, tiles), kTiledThreads, shared, s>>>(
      static_cast<const float*>(yp), static_cast<const float*>(ts),
      static_cast<const float*>(g), static_cast<const float*>(valid),
      static_cast<const float*>(d_row), static_cast<const float*>(delta),
      static_cast<float*>(buf),
      ChainArgs{L, k_eff, scheme, binary, sigma, mu, eps, log_eps});
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int slates_per_block = kTiledThreads / 32;
  tiled_sum_kernel<<<(batch + slates_per_block - 1) / slates_per_block,
                     kTiledThreads, 0, s>>>(static_cast<float*>(buf), batch,
                                            tiles);
  return cudaGetLastError();
}

// Backward on `stream`: dyp [B, L] from the forward's inputs and gout [B],
// the loss sums' cotangent.
extern "C" int lambda_tiled_bwd(const void* yp, const void* ts, const void* g,
                                const void* valid, const void* d_row,
                                const void* delta, const void* gout,
                                void* dyp, int batch, int L, int k_eff,
                                int scheme, int binary, float sigma, float mu,
                                float eps, float log_eps, void* stream) {
  using namespace allrank;
  if (L < 1 || L > kMaxTiledK || batch < 1) return cudaErrorInvalidValue;
  const size_t shared = 6 * (size_t)L * sizeof(float);
  cudaError_t err = allow_shared(tiled_bwd_kernel, shared);
  if (err != cudaSuccess) return err;
  tiled_bwd_kernel<<<dim3(batch, tiles_for(L)), kTiledThreads, shared,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(yp), static_cast<const float*>(ts),
      static_cast<const float*>(g), static_cast<const float*>(valid),
      static_cast<const float*>(d_row), static_cast<const float*>(delta),
      static_cast<const float*>(gout), static_cast<float*>(dyp),
      ChainArgs{L, k_eff, scheme, binary, sigma, mu, eps, log_eps});
  return cudaGetLastError();
}
