// Attention sublayer forward and backward for Hopper (sm_90a), fp32 or bf16
// activations:
//   y = x + drop_r(Wout . MHA_drop_a(LN(x) . Wqkv + bqkv) + bout)
// with the unbiased-std LayerNorm, scores scaled by 1/sqrt(d_k), padded keys
// filled with -1e9 before a max-subtracted softmax, dropout on the attention
// probabilities and on the sublayer output (csrc/dropout.cuh), and the
// residual added in fp32.
//
// Replaces the TPU kernel `attention_sublayer` of the JAX package's
// ops/attention_block.py: forward pallas_call at line 343 (math in
// attn_sublayer_fwd_vmem, lines 122-144), backward pallas_call at line 375
// (math in attn_sublayer_bwd_vmem, lines 159-254).
//
// What bounds it: the products. At the flagship shape (B=64, L=240, d=128,
// h=4) the forward does about 3.9 GFLOP and the backward about 9.7 GFLOP
// (each product counted once) on some 16 MB (forward) and 48 MB (backward)
// of fp32 tensors in and out, 200 or more FLOP per byte, so on this card
// both are bound by operations, not by memory.
//
// What the design does about it, and about the TPU kernel's assumptions:
//  * The TPU kernel keeps whole slates in many MB of VMEM. A block here has
//    227 KB, less than one head's [240, 240] fp32 probability tile. So the
//    forward is two kernels: ln_qkv (LN + QKV projection over 64-row tiles,
//    writing qkv [B, L, 3d] in x's dtype, the one intermediate in device
//    memory) and attn_out (one block per slate and 64-query tile). attn_out
//    walks the keys in tiles of 64 and never holds more than a 64 x 64 score
//    tile: a first pass takes the running row max and sum, a second
//    recomputes the scores, forms the probabilities exactly as the TPU kernel
//    does (exp(s - max) / sum, dropped, rounded to x's dtype) and accumulates
//    P.V. In training the forward also stores each row's max and sum
//    [B, h, L, 2], and qkv is kept for the backward.
//  * The out-projection sums over heads. attn_out loops over the heads and
//    keeps ctx for all of them in shared memory, then multiplies by Wout in
//    the same block: no atomics, no second pass over device memory.
//  * The backward never holds [L, L] either. It recomputes P tile by tile
//    from the saved qkv and row statistics (bitwise the forward's P: the
//    same products in the same order) and replays both dropout masks from
//    their (seed, stream, index) keys. Seven kernels: bwd_rows (da = drop_r(dy)
//    and dO = da . Wout^T per 64-row tile, and LN(x)); bwd_dq (per slate,
//    head and 64-query tile: ctx for dWout, D = sum_j dPd * P as the TPU
//    kernel takes it, then dQ); bwd_dkv (per slate, head and 64-key tile,
//    looping over query tiles: dK and dV); bwd_ln_qkv (dn = dqkv . Wqkv^T and
//    the LN backward per 64-row tile); the weight gradients dWqkv, dWout and
//    their biases as split A^T . B products, and the LN parameter gradients,
//    each summed over the B * L rows in a fixed order (backward.cuh).
//  * L = 240 is not a multiple of 64, and d_k of 72 or 96 not a power of two:
//    every staged load masks its edge with zeros, keys past L get -inf
//    (weight 0) and padded keys -1e9, so a fully padded slate gets a uniform
//    softmax, never NaN; its dS is zero at every padded key.
//  * Products run as fp32 FMAs on 64 x 64 register tiles (common.cuh); the
//    bf16 rounding points are the TPU kernel's: LN output, qkv,
//    probabilities, ctx, and in the backward da, dO, dS and dqkv. Tensor
//    cores (wgmma) are later work.
#include "backward.cuh"
#include "common.cuh"
#include "dropout.cuh"

namespace allrank {
namespace {

// qkv[m, :] = round(round(LN(x[m, :])) . round(Wqkv) + bqkv) for a 64-row by
// 64-column tile of the [M, 3d] output.
template <class T>
__global__ void __launch_bounds__(kThreads)
    ln_qkv_kernel(const T* __restrict__ x, const float* __restrict__ ln_scale,
                  const float* __restrict__ ln_bias,
                  const float* __restrict__ wqkv,
                  const float* __restrict__ bqkv, T* __restrict__ qkv, int M,
                  int d) {
  extern __shared__ float smem[];
  float* As = smem;                  // [kTile][kLdA]  LN(x) chunk
  float* Bs = As + kTile * kLdA;     // [kChunk][kLdB] Wqkv chunk
  float* mean = Bs + kChunk * kLdB;  // [kTile]
  float* rdenom = mean + kTile;      // [kTile]
  const int n_out = 3 * d;
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const int rows = min(kTile, M - m0);
  const T* xt = x + (size_t)m0 * d;

  ln_row_stats(xt, rows, d, mean, rdenom);
  __syncthreads();

  float acc[4][4] = {};
  for (int k0 = 0; k0 < d; k0 += kChunk) {
    for (int e = threadIdx.x; e < kTile * kChunk; e += kThreads) {
      const int r = e / kChunk, kk = e % kChunk, k = k0 + kk;
      float v = 0.f;
      if (r < rows && k < d)
        v = round_to<T>((to_float(xt[(size_t)r * d + k]) - mean[r]) *
                            rdenom[r] * ln_scale[k] +
                        ln_bias[k]);
      As[r * kLdA + kk] = v;
    }
    for (int e = threadIdx.x; e < kChunk * kTile; e += kThreads) {
      const int kk = e / kTile, n = e % kTile, k = k0 + kk;
      Bs[kk * kLdB + n] = (k < d && n0 + n < n_out)
                              ? round_to<T>(wqkv[(size_t)k * n_out + n0 + n])
                              : 0.f;
    }
    __syncthreads();
    mma_tile(acc, As, kLdA, Bs, kLdB, kChunk);
    __syncthreads();
  }

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i, n = n0 + tx + 16 * j;
      if (r < rows && n < n_out)
        qkv[(size_t)(m0 + r) * n_out + n] = from_float<T>(acc[i][j] + bqkv[n]);
    }
  }
}

// y[q0:q0+64] of one slate: attention over all heads, then the
// out-projection, its bias, the output dropout and the residual. With
// `stats` non-null, also each row's softmax max and sum per head.
template <class T>
__global__ void __launch_bounds__(kThreads)
    attn_out_kernel(const T* __restrict__ qkv,
                    const unsigned char* __restrict__ key_mask,
                    const T* __restrict__ x, const float* __restrict__ wout,
                    const float* __restrict__ bout, T* __restrict__ y,
                    float* __restrict__ stats, int L, int d, int h,
                    float scale, DropStream drop_a, DropStream drop_r) {
  extern __shared__ float smem[];
  float* As = smem;                    // [kTile][kLdA]  query chunk
  float* Bs = As + kTile * kLdA;       // [kChunk][kLdB] key, value or Wout chunk
  float* Ps = Bs + kChunk * kLdB;      // [kTile][kLdB]  scores, then probabilities
  float* row_max = Ps + kTile * kLdB;  // [kTile]
  float* row_sum = row_max + kTile;    // [kTile]
  float* Cs = row_sum + kTile;         // [kTile][d + 1] ctx of all heads
  const int ldc = d + 1;
  const int dk = d / h, ld = 3 * d;
  const int slate = blockIdx.y, q0 = blockIdx.x * kTile;
  const int rows = min(kTile, L - q0);
  const T* base = qkv + (size_t)slate * L * ld;
  const unsigned char* padded = key_mask + (size_t)slate * L;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  for (int e = tid; e < kTile * ldc; e += kThreads) Cs[e] = 0.f;

  for (int head = 0; head < h; ++head) {
    const int qoff = head * dk, koff = d + head * dk, voff = 2 * d + head * dk;
    if (tid < kTile) {
      row_max[tid] = -INFINITY;
      row_sum[tid] = 0.f;
    }
    __syncthreads();
    // pass 0: row max and sum of exp; pass 1: probabilities and P.V
    for (int pass = 0; pass < 2; ++pass) {
      for (int k0 = 0; k0 < L; k0 += kTile) {
        float acc[4][4] = {};
        for (int c0 = 0; c0 < dk; c0 += kChunk) {
          for (int e = tid; e < kTile * kChunk; e += kThreads) {
            const int r = e / kChunk, kk = e % kChunk, c = c0 + kk;
            As[r * kLdA + kk] =
                (r < rows && c < dk)
                    ? to_float(base[(size_t)(q0 + r) * ld + qoff + c])
                    : 0.f;
          }
          // keys go along the tile's columns: read along d_k, store
          // transposed (the padded pitch keeps the stores conflict-free)
          for (int e = tid; e < kTile * kChunk; e += kThreads) {
            const int n = e / kChunk, kk = e % kChunk, c = c0 + kk;
            Bs[kk * kLdB + n] =
                (k0 + n < L && c < dk)
                    ? to_float(base[(size_t)(k0 + n) * ld + koff + c])
                    : 0.f;
          }
          __syncthreads();
          mma_tile(acc, As, kLdA, Bs, kLdB, kChunk);
          __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = tx + 16 * j, key = k0 + c;
            float s = acc[i][j] * scale;
            if (key >= L)
              s = -INFINITY;
            else if (padded[key])
              s = kNegInfFill;
            Ps[(ty + 16 * i) * kLdB + c] = s;
          }
        }
        __syncthreads();
        if (pass == 0) {
          // four neighbouring lanes per row, 16 keys each
          const int r = tid / 4, part = tid % 4;
          const float* prow = Ps + r * kLdB + part * 16;
          float tmax = -INFINITY;
          for (int c = 0; c < 16; ++c) tmax = fmaxf(tmax, prow[c]);
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
          const float old_max = row_max[r];
          const float new_max = fmaxf(old_max, tmax);
          float tsum = 0.f;
          for (int c = 0; c < 16; ++c) tsum += expf(prow[c] - new_max);
          tsum += __shfl_xor_sync(0xffffffffu, tsum, 1);
          tsum += __shfl_xor_sync(0xffffffffu, tsum, 2);
          __syncwarp();  // the row's four lanes have read row_max[r]
          if (part == 0) {
            row_sum[r] = row_sum[r] * expf(old_max - new_max) + tsum;
            row_max[r] = new_max;
          }
        } else {
          const size_t prob0 = (((size_t)slate * h + head) * L + q0) * L + k0;
          for (int e = tid; e < kTile * kTile; e += kThreads) {
            const int r = e / kTile, c = e % kTile;
            float p = expf(Ps[r * kLdB + c] - row_max[r]) * (1.f / row_sum[r]);
            if (drop_a.on)
              p = drop_keep(drop_a, prob0 + (size_t)r * L + c) ? p / drop_a.denom
                                                               : 0.f;
            Ps[r * kLdB + c] = round_to<T>(p);
          }
          __syncthreads();
          for (int t0 = 0; t0 < dk; t0 += kTile) {
            float cacc[4][4] = {};
            for (int kk0 = 0; kk0 < kTile; kk0 += kChunk) {
              for (int e = tid; e < kChunk * kTile; e += kThreads) {
                const int kk = e / kTile, n = e % kTile;
                const int key = k0 + kk0 + kk, c = t0 + n;
                Bs[kk * kLdB + n] =
                    (key < L && c < dk)
                        ? to_float(base[(size_t)key * ld + voff + c])
                        : 0.f;
              }
              __syncthreads();
              mma_tile(cacc, Ps + kk0, kLdB, Bs, kLdB, kChunk);
              __syncthreads();
            }
            // each (row, column) of ctx belongs to one thread throughout
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int c = t0 + tx + 16 * j;
                if (c < dk) Cs[(ty + 16 * i) * ldc + qoff + c] += cacc[i][j];
              }
            }
          }
        }
        __syncthreads();
      }
      if (pass == 0 && stats != nullptr && tid < rows) {
        const size_t o = (((size_t)slate * h + head) * L + q0 + tid) * 2;
        stats[o] = row_max[tid];
        stats[o + 1] = row_sum[tid];
      }
    }
  }

  for (int e = tid; e < kTile * d; e += kThreads) {
    const int r = e / d, c = e % d;
    Cs[r * ldc + c] = round_to<T>(Cs[r * ldc + c]);
  }
  __syncthreads();

  const size_t row0 = (size_t)slate * L + q0;
  const T* xt = x + row0 * d;
  T* yt = y + row0 * d;
  for (int n0 = 0; n0 < d; n0 += kTile) {
    float acc[4][4] = {};
    for (int k0 = 0; k0 < d; k0 += kChunk) {
      const int depth = min(kChunk, d - k0);
      for (int e = tid; e < kChunk * kTile; e += kThreads) {
        const int kk = e / kTile, n = e % kTile;
        Bs[kk * kLdB + n] =
            (kk < depth && n0 + n < d)
                ? round_to<T>(wout[(size_t)(k0 + kk) * d + n0 + n])
                : 0.f;
      }
      __syncthreads();
      mma_tile(acc, Cs + k0, ldc, Bs, kLdB, depth);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, n = n0 + tx + 16 * j;
        if (r < rows && n < d) {
          const size_t o = (size_t)r * d + n;
          float a = acc[i][j] + bout[n];
          if (drop_r.on)
            a = drop_keep(drop_r, row0 * d + o) ? a / drop_r.denom : 0.f;
          yt[o] = from_float<T>(to_float(xt[o]) + a);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward

// Stages the [64 rows, kChunk] chunk of columns [c0, c0 + kChunk) of a
// [*, ld] matrix at rows [row0, row0 + 64) (rows past `rows` and columns past
// `cols` read as 0) into As, and the same chunk of rows [key0, key0 + 64) of
// another, transposed, into Bs: the operands of one step of a row-by-key
// product such as q . k^T.
template <class T>
__device__ __forceinline__ void stage_row_key(float* As, float* Bs,
                                              const T* a, int lda, int row0,
                                              int rows, const T* b, int ldb,
                                              int key0, int keys, int c0,
                                              int cols) {
  for (int e = threadIdx.x; e < kTile * kChunk; e += kThreads) {
    const int r = e / kChunk, kk = e % kChunk, c = c0 + kk;
    As[r * kLdA + kk] = (r < rows && c < cols)
                            ? to_float(a[(size_t)(row0 + r) * lda + c])
                            : 0.f;
    Bs[kk * kLdB + r] = (r < keys && c < cols)
                            ? to_float(b[(size_t)(key0 + r) * ldb + c])
                            : 0.f;
  }
}

// Stages rows [row0, row0 + kChunk) and columns [c0, c0 + 64) of a [*, ld]
// matrix (rows past `rows`, columns past `cols` read as 0) into Bs.
template <class T>
__device__ __forceinline__ void stage_rows(float* Bs, const T* b, int ld,
                                           int row0, int rows, int c0,
                                           int cols) {
  for (int e = threadIdx.x; e < kChunk * kTile; e += kThreads) {
    const int kk = e / kTile, n = e % kTile;
    Bs[kk * kLdB + n] = (row0 + kk < rows && c0 + n < cols)
                            ? to_float(b[(size_t)(row0 + kk) * ld + c0 + n])
                            : 0.f;
  }
}

// da = round(drop_r(dy)) and dO = round(da . round(Wout)^T) for 64 rows by
// 64 columns; the blocks of the first column tile also write da and
// n = round(LN(x)) (the A operand of dWqkv).
template <class T>
__global__ void __launch_bounds__(kThreads)
    bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                    const float* __restrict__ ln_scale,
                    const float* __restrict__ ln_bias,
                    const float* __restrict__ wout, T* __restrict__ da,
                    T* __restrict__ dO, T* __restrict__ n_act, int M, int d,
                    DropStream drop_r) {
  __shared__ float As[kTile * kLdA];
  __shared__ float Bs[kChunk * kLdB];
  __shared__ float mean[kTile], rdenom[kTile];
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const int rows = min(kTile, M - m0);
  const bool lead = blockIdx.y == 0;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < d; k0 += kChunk) {
    for (int e = tid; e < kTile * kChunk; e += kThreads) {
      const int r = e / kChunk, kk = e % kChunk, k = k0 + kk;
      float v = 0.f;
      if (r < rows && k < d) {
        const size_t i = (size_t)(m0 + r) * d + k;
        v = to_float(dy[i]);
        if (drop_r.on) v = drop_keep(drop_r, i) ? v * drop_r.inv : 0.f;
        v = round_to<T>(v);
        if (lead) da[i] = from_float<T>(v);
      }
      As[r * kLdA + kk] = v;
    }
    // Bs[kk][n] = Wout[n0 + n][k0 + kk]: read along Wout's rows
    for (int e = tid; e < kTile * kChunk; e += kThreads) {
      const int n = e / kChunk, kk = e % kChunk, k = k0 + kk;
      Bs[kk * kLdB + n] = (k < d && n0 + n < d)
                              ? round_to<T>(wout[(size_t)(n0 + n) * d + k])
                              : 0.f;
    }
    __syncthreads();
    mma_tile(acc, As, kLdA, Bs, kLdB, kChunk);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i, n = n0 + tx + 16 * j;
      if (r < rows && n < d)
        dO[(size_t)(m0 + r) * d + n] = from_float<T>(acc[i][j]);
    }
  }
  if (!lead) return;
  const T* xt = x + (size_t)m0 * d;
  ln_row_stats(xt, rows, d, mean, rdenom);
  __syncthreads();
  for (int e = tid; e < rows * d; e += kThreads) {
    const int r = e / d, k = e % d;
    n_act[(size_t)m0 * d + e] = from_float<T>(
        (to_float(xt[e]) - mean[r]) * rdenom[r] * ln_scale[k] + ln_bias[k]);
  }
}

// The probability P, its dropout factor and the mask of one (query, key)
// element of a recomputed score tile; P is the forward's undropped value.
struct ProbElem {
  float p, pd_scale;
  bool key_live;  // a real, unpadded key: dS may be non-zero
};

__device__ __forceinline__ ProbElem prob_elem(
    float score, float scale, int q_ok, int key, int L,
    const unsigned char* padded, float rmax, float rinv,
    const DropStream& drop_a, size_t prob_index) {
  ProbElem e;
  e.key_live = false;
  e.p = 0.f;
  if (q_ok && key < L) {
    float sc = score * scale;
    const bool pad = padded[key] != 0;
    if (pad) sc = kNegInfFill;
    e.p = expf(sc - rmax) * rinv;
    e.key_live = !pad;
  }
  e.pd_scale = 1.f;
  if (drop_a.on) e.pd_scale = drop_keep(drop_a, prob_index) ? drop_a.inv : 0.f;
  return e;
}

// Per (slate, head, 64-query tile, 64-column tile of d_k). Pass 0 walks the
// key tiles for ctx = round(P_d) . v (dWout's A operand) and D = sum_j
// dPd * P; pass 1 walks them again for dS = P (dPd - D), rounded, and
// dQ = dS . k * scale. P and dP = dO . v^T are recomputed per tile.
template <class T>
__global__ void __launch_bounds__(kThreads)
    bwd_dq_kernel(const T* __restrict__ qkv,
                  const unsigned char* __restrict__ key_mask,
                  const float* __restrict__ stats, const T* __restrict__ dO,
                  T* __restrict__ ctx, float* __restrict__ Dg,
                  T* __restrict__ dqkv, int L, int d, int h, float scale,
                  DropStream drop_a) {
  __shared__ float As[kTile * kLdA];
  __shared__ float Bs[kChunk * kLdB];
  __shared__ float Ps[kTile * kLdB];
  __shared__ float rmax[kTile], rinv[kTile], Drow[kTile];
  const int dk = d / h, ld = 3 * d;
  const int slate = blockIdx.y / h, head = blockIdx.y % h;
  const int q0 = blockIdx.x * kTile, t0 = blockIdx.z * kTile;
  const int rows = min(kTile, L - q0);
  const T* base = qkv + (size_t)slate * L * ld;
  const T* dob = dO + (size_t)slate * L * d;
  const unsigned char* padded = key_mask + (size_t)slate * L;
  const int qoff = head * dk, koff = d + head * dk, voff = 2 * d + head * dk;
  const size_t sh = (size_t)slate * h + head;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  if (tid < kTile) {
    const bool ok = tid < rows;
    const float* st = stats + (sh * L + q0 + tid) * 2;
    rmax[tid] = ok ? st[0] : 0.f;
    rinv[tid] = ok ? 1.f / st[1] : 0.f;
    Drow[tid] = 0.f;
  }
  __syncthreads();

  for (int pass = 0; pass < 2; ++pass) {
    float out[4][4] = {};
    for (int k0 = 0; k0 < L; k0 += kTile) {
      const int keys = min(kTile, L - k0);
      float sacc[4][4] = {}, dp[4][4] = {};
      for (int c0 = 0; c0 < dk; c0 += kChunk) {
        stage_row_key(As, Bs, base + qoff, ld, q0, rows, base + koff, ld, k0,
                      keys, c0, dk);
        __syncthreads();
        mma_tile(sacc, As, kLdA, Bs, kLdB, kChunk);
        __syncthreads();
      }
      for (int c0 = 0; c0 < dk; c0 += kChunk) {
        stage_row_key(As, Bs, dob + qoff, d, q0, rows, base + voff, ld, k0,
                      keys, c0, dk);
        __syncthreads();
        mma_tile(dp, As, kLdA, Bs, kLdB, kChunk);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        float dsum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j, key = k0 + c;
          const ProbElem pe = prob_elem(
              sacc[i][j], scale, r < rows, key, L, padded, rmax[r], rinv[r],
              drop_a, (sh * L + q0 + r) * L + key);
          const float dpd = dp[i][j] * pe.pd_scale;
          float v;
          if (pass == 0) {
            dsum += dpd * pe.p;
            v = pe.p * pe.pd_scale;
          } else {
            v = pe.key_live ? pe.p * (dpd - Drow[r]) : 0.f;
          }
          Ps[r * kLdB + c] = round_to<T>(v);
        }
        if (pass == 0) {
          // the 16 lanes of a half warp share the row
#pragma unroll
          for (int o = 8; o > 0; o >>= 1)
            dsum += __shfl_xor_sync(0xffffffffu, dsum, o);
          if (tx == 0) Drow[r] += dsum;
        }
      }
      __syncthreads();
      const int off = pass == 0 ? voff : koff;
      for (int kk0 = 0; kk0 < kTile; kk0 += kChunk) {
        stage_rows(Bs, base + off + t0, ld, k0 + kk0, L, 0, dk - t0);
        __syncthreads();
        mma_tile(out, Ps + kk0, kLdB, Bs, kLdB, kChunk);
        __syncthreads();
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = t0 + tx + 16 * j;
        if (r >= rows || c >= dk) continue;
        const size_t m = (size_t)slate * L + q0 + r;
        if (pass == 0)
          ctx[m * d + qoff + c] = from_float<T>(out[i][j]);
        else
          dqkv[m * ld + qoff + c] = from_float<T>(out[i][j] * scale);
      }
    }
    if (pass == 0 && blockIdx.z == 0 && tid < rows)
      Dg[sh * L + q0 + tid] = Drow[tid];
  }
}

// Per (slate, head, 64-key tile, 64-column tile of d_k), looping over the
// query tiles: dV = round(P_d)^T . dO and dK = dS^T . q * scale, with P, dP
// and dS recomputed exactly as bwd_dq_kernel computes them.
template <class T>
__global__ void __launch_bounds__(kThreads)
    bwd_dkv_kernel(const T* __restrict__ qkv,
                   const unsigned char* __restrict__ key_mask,
                   const float* __restrict__ stats, const float* __restrict__ Dg,
                   const T* __restrict__ dO, T* __restrict__ dqkv, int L, int d,
                   int h, float scale, DropStream drop_a) {
  __shared__ float As[kTile * kLdA];
  __shared__ float Bs[kChunk * kLdB];
  __shared__ float Ps[kTile * kLdB];
  __shared__ float rmax[kTile], rinv[kTile], Drow[kTile];
  const int dk = d / h, ld = 3 * d;
  const int slate = blockIdx.y / h, head = blockIdx.y % h;
  const int kt0 = blockIdx.x * kTile, t0 = blockIdx.z * kTile;
  const int keys = min(kTile, L - kt0);
  const T* base = qkv + (size_t)slate * L * ld;
  const T* dob = dO + (size_t)slate * L * d;
  const unsigned char* padded = key_mask + (size_t)slate * L;
  const int qoff = head * dk, koff = d + head * dk, voff = 2 * d + head * dk;
  const size_t sh = (size_t)slate * h + head;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float dv[4][4] = {}, dkacc[4][4] = {};
  for (int q0 = 0; q0 < L; q0 += kTile) {
    const int rows = min(kTile, L - q0);
    if (tid < kTile) {
      const bool ok = tid < rows;
      const float* st = stats + (sh * L + q0 + tid) * 2;
      rmax[tid] = ok ? st[0] : 0.f;
      rinv[tid] = ok ? 1.f / st[1] : 0.f;
      Drow[tid] = ok ? Dg[sh * L + q0 + tid] : 0.f;
    }
    float sacc[4][4] = {}, dp[4][4] = {};
    for (int c0 = 0; c0 < dk; c0 += kChunk) {
      stage_row_key(As, Bs, base + qoff, ld, q0, rows, base + koff, ld, kt0,
                    keys, c0, dk);
      __syncthreads();
      mma_tile(sacc, As, kLdA, Bs, kLdB, kChunk);
      __syncthreads();
    }
    for (int c0 = 0; c0 < dk; c0 += kChunk) {
      stage_row_key(As, Bs, dob + qoff, d, q0, rows, base + voff, ld, kt0,
                    keys, c0, dk);
      __syncthreads();
      mma_tile(dp, As, kLdA, Bs, kLdB, kChunk);
      __syncthreads();
    }
    float dsv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, key = kt0 + c;
        const ProbElem pe = prob_elem(
            sacc[i][j], scale, r < rows, key, L, padded, rmax[r], rinv[r],
            drop_a, (sh * L + q0 + r) * L + key);
        const float dpd = dp[i][j] * pe.pd_scale;
        dsv[i][j] = pe.key_live ? pe.p * (dpd - Drow[r]) : 0.f;
        Ps[r * kLdB + c] = round_to<T>(pe.p * pe.pd_scale);
      }
    }
    __syncthreads();
    for (int kk0 = 0; kk0 < kTile; kk0 += kChunk) {
      stage_rows(Bs, dob + qoff + t0, d, q0 + kk0, L, 0, dk - t0);
      __syncthreads();
      mma_tile_t(dv, Ps + kk0 * kLdB, kLdB, Bs, kLdB, kChunk);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(ty + 16 * i) * kLdB + tx + 16 * j] = round_to<T>(dsv[i][j]);
    __syncthreads();
    for (int kk0 = 0; kk0 < kTile; kk0 += kChunk) {
      stage_rows(Bs, base + qoff + t0, ld, q0 + kk0, L, 0, dk - t0);
      __syncthreads();
      mma_tile_t(dkacc, Ps + kk0 * kLdB, kLdB, Bs, kLdB, kChunk);
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i, c = t0 + tx + 16 * j;
      if (r >= keys || c >= dk) continue;
      const size_t m = (size_t)slate * L + kt0 + r;
      dqkv[m * ld + koff + c] = from_float<T>(dkacc[i][j] * scale);
      dqkv[m * ld + voff + c] = from_float<T>(dv[i][j]);
    }
  }
}

// dn = dqkv . round(Wqkv)^T for 64 rows, then the LN backward: dx and the
// tile's partial sums of dg and db.
template <class T>
__global__ void __launch_bounds__(kThreads)
    bwd_ln_qkv_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const T* __restrict__ dqkv,
                      const float* __restrict__ ln_scale,
                      const float* __restrict__ wqkv, T* __restrict__ dx,
                      float* __restrict__ part_ln, int M, int d) {
  extern __shared__ float smem[];
  float* As = smem;                  // [kTile][kLdA]  dqkv chunk
  float* Bs = As + kTile * kLdA;     // [kChunk][kLdB] Wqkv^T chunk
  float* rmean = Bs + kChunk * kLdB;  // [kTile]
  float* rden = rmean + kTile;        // [kTile]
  float* Ns = rden + kTile;           // [kTile][d + 1] dn
  const int ldn = d + 1, n3 = 3 * d;
  const int m0 = blockIdx.x * kTile;
  const int rows = min(kTile, M - m0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float out[4][4][4] = {};  // [64-column tile of d][i][j]
  for (int k0 = 0; k0 < n3; k0 += kChunk) {
    for (int e = tid; e < kTile * kChunk; e += kThreads) {
      const int r = e / kChunk, kk = e % kChunk, k = k0 + kk;
      As[r * kLdA + kk] =
          (r < rows && k < n3) ? to_float(dqkv[(size_t)(m0 + r) * n3 + k]) : 0.f;
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (t * kTile < d) {
        for (int e = tid; e < kTile * kChunk; e += kThreads) {
          const int n = e / kChunk, kk = e % kChunk, k = k0 + kk;
          const int c = t * kTile + n;
          Bs[kk * kLdB + n] = (c < d && k < n3)
                                  ? round_to<T>(wqkv[(size_t)c * n3 + k])
                                  : 0.f;
        }
        __syncthreads();
        mma_tile(out[t], As, kLdA, Bs, kLdB, kChunk);
        __syncthreads();
      }
    }
  }
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = t * kTile + tx + 16 * j;
        if (n < d) Ns[(ty + 16 * i) * ldn + n] = out[t][i][j];
      }
  __syncthreads();
  const size_t o = (size_t)m0 * d;
  ln_backward_tile(x + o, dy + o, dx + o, Ns, ldn, rows, d, ln_scale,
                   part_ln + (size_t)blockIdx.x * 2 * d, rmean, rden);
}

// ---------------------------------------------------------------------------
// launches

template <class T>
int launch_fwd(const void* x, const void* key_mask, const void* ln_scale,
               const void* ln_bias, const void* wqkv, const void* bqkv,
               const void* wout, const void* bout, void* qkv, void* y,
               void* stats, int batch, int L, int d, int h, float scale,
               DropStream drop_a, DropStream drop_r, cudaStream_t stream) {
  const int M = batch * L;
  const size_t smem1 = (kTile * kLdA + kChunk * kLdB + 2 * kTile) * sizeof(float);
  const dim3 grid1((M + kTile - 1) / kTile, (3 * d + kTile - 1) / kTile);
  ln_qkv_kernel<T><<<grid1, kThreads, smem1, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const float*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<T*>(qkv), M, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem2 =
      (kTile * kLdA + kChunk * kLdB + kTile * kLdB + 2 * kTile + kTile * (d + 1)) *
      sizeof(float);
  err = cudaFuncSetAttribute(attn_out_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return err;
  const dim3 grid2((L + kTile - 1) / kTile, batch);
  attn_out_kernel<T><<<grid2, kThreads, smem2, stream>>>(
      static_cast<const T*>(qkv), static_cast<const unsigned char*>(key_mask),
      static_cast<const T*>(x), static_cast<const float*>(wout),
      static_cast<const float*>(bout), static_cast<T*>(y),
      static_cast<float*>(stats), L, d, h, scale, drop_a, drop_r);
  return cudaGetLastError();
}

struct BwdArgs {
  const void *x, *key_mask, *ln_scale, *ln_bias, *wqkv, *wout, *qkv, *stats,
      *dy;
  void *dx, *dg, *db, *dwqkv, *dbqkv, *dwout, *dbout;
  void *da, *dO, *n_act, *ctx, *dqkv, *D, *part_qkv, *part_out, *part_ln;
  int batch, L, d, h, splits_qkv, splits_out;
  float scale;
};

template <class T>
int launch_bwd(const BwdArgs& a, DropStream drop_a, DropStream drop_r,
               cudaStream_t stream) {
  const int M = a.batch * a.L, d = a.d, dk = d / a.h;
  const int row_tiles = (M + kTile - 1) / kTile;
  const T* x = static_cast<const T*>(a.x);
  const T* qkv = static_cast<const T*>(a.qkv);
  const auto* mask = static_cast<const unsigned char*>(a.key_mask);
  const auto* stats = static_cast<const float*>(a.stats);
  T* da = static_cast<T*>(a.da);
  T* dO = static_cast<T*>(a.dO);
  T* n_act = static_cast<T*>(a.n_act);
  T* ctx = static_cast<T*>(a.ctx);
  T* dqkv = static_cast<T*>(a.dqkv);
  float* D = static_cast<float*>(a.D);

  bwd_rows_kernel<T><<<dim3(row_tiles, (d + kTile - 1) / kTile), kThreads, 0,
                       stream>>>(
      x, static_cast<const T*>(a.dy), static_cast<const float*>(a.ln_scale),
      static_cast<const float*>(a.ln_bias), static_cast<const float*>(a.wout),
      da, dO, n_act, M, d, drop_r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid_h((a.L + kTile - 1) / kTile, a.batch * a.h,
                    (dk + kTile - 1) / kTile);
  bwd_dq_kernel<T><<<grid_h, kThreads, 0, stream>>>(
      qkv, mask, stats, dO, ctx, D, dqkv, a.L, d, a.h, a.scale, drop_a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_dkv_kernel<T><<<grid_h, kThreads, 0, stream>>>(
      qkv, mask, stats, D, dO, dqkv, a.L, d, a.h, a.scale, drop_a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem4 =
      (kTile * kLdA + kChunk * kLdB + 2 * kTile + kTile * (d + 1)) * sizeof(float);
  err = cudaFuncSetAttribute(bwd_ln_qkv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem4));
  if (err != cudaSuccess) return err;
  float* part_ln = static_cast<float*>(a.part_ln);
  bwd_ln_qkv_kernel<T><<<row_tiles, kThreads, smem4, stream>>>(
      x, static_cast<const T*>(a.dy), dqkv,
      static_cast<const float*>(a.ln_scale), static_cast<const float*>(a.wqkv),
      static_cast<T*>(a.dx), part_ln, M, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  err = launch_weight_grad<T>(n_act, dqkv, static_cast<float*>(a.part_qkv),
                              static_cast<float*>(a.dwqkv),
                              static_cast<float*>(a.dbqkv), M, d, 3 * d,
                              a.splits_qkv, stream);
  if (err != cudaSuccess) return err;
  err = launch_weight_grad<T>(ctx, da, static_cast<float*>(a.part_out),
                              static_cast<float*>(a.dwout),
                              static_cast<float*>(a.dbout), M, d, d,
                              a.splits_out, stream);
  if (err != cudaSuccess) return err;
  return launch_reduce(part_ln, row_tiles, static_cast<float*>(a.dg), d,
                       static_cast<float*>(a.db), d, stream);
}

}  // namespace
}  // namespace allrank

// Launches the forward's two kernels on `stream`; returns 0 or the CUDA
// error code. x, qkv ([B, L, 3d], kept for the backward) and y are in x's
// dtype (bf16 if is_bf16, else fp32); key_mask is [B, L] bytes, non-zero at
// padded documents; parameters are fp32. stats ([B, h, L, 2] fp32: each
// row's softmax max and sum) may be null. drop_keys holds {k0, k1,
// threshold} of the probability stream, then of the output stream
// (ops/dropout.py); p_attn / p_resid are their rates (0: no dropout).
extern "C" int attention_sublayer_fwd(const void* x, const void* key_mask,
                                      const void* ln_scale, const void* ln_bias,
                                      const void* wqkv, const void* bqkv,
                                      const void* wout, const void* bout,
                                      void* qkv, void* y, void* stats,
                                      int batch, int L, int d, int h,
                                      float scale, int is_bf16,
                                      const unsigned* drop_keys, double p_attn,
                                      double p_resid, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto da = allrank::make_stream(drop_keys, p_attn);
  const auto dr = allrank::make_stream(drop_keys + 3, p_resid);
  if (is_bf16)
    return allrank::launch_fwd<__nv_bfloat16>(x, key_mask, ln_scale, ln_bias,
                                              wqkv, bqkv, wout, bout, qkv, y,
                                              stats, batch, L, d, h, scale, da,
                                              dr, s);
  return allrank::launch_fwd<float>(x, key_mask, ln_scale, ln_bias, wqkv, bqkv,
                                    wout, bout, qkv, y, stats, batch, L, d, h,
                                    scale, da, dr, s);
}

// Launches the backward's nine kernels on `stream`; returns 0 or the CUDA
// error code. Inputs: x, key_mask, ln_scale, ln_bias, wqkv, wout, and qkv
// and stats from the forward, dy in x's dtype. Outputs: dx (x's dtype) and
// the fp32 gradients dg, db [d], dwqkv [d, 3d], dbqkv [3d], dwout [d, d],
// dbout [d]. Scratch, all from the caller: da, dO, n_act, ctx [B*L, d] and
// dqkv [B*L, 3d] in x's dtype; fp32 D [B, h, L], part_qkv
// [splits_qkv, 3d*d + 3d], part_out [splits_out, d*d + d] and part_ln
// [ceil(B*L / 64), 2d].
extern "C" int attention_sublayer_bwd(
    const void* x, const void* key_mask, const void* ln_scale,
    const void* ln_bias, const void* wqkv, const void* wout, const void* qkv,
    const void* stats, const void* dy, void* dx, void* dg, void* db,
    void* dwqkv, void* dbqkv, void* dwout, void* dbout, void* da, void* dO,
    void* n_act, void* ctx, void* dqkv, void* D, void* part_qkv,
    void* part_out, void* part_ln, int batch, int L, int d, int h,
    int splits_qkv, int splits_out, float scale, int is_bf16,
    const unsigned* drop_keys, double p_attn, double p_resid, void* stream) {
  const allrank::BwdArgs a{x,     key_mask, ln_scale, ln_bias, wqkv,  wout,
                           qkv,   stats,    dy,       dx,      dg,    db,
                           dwqkv, dbqkv,    dwout,    dbout,   da,    dO,
                           n_act, ctx,      dqkv,     D,       part_qkv,
                           part_out, part_ln, batch,  L,       d,     h,
                           splits_qkv, splits_out, scale};
  auto s = static_cast<cudaStream_t>(stream);
  const auto drop_a = allrank::make_stream(drop_keys, p_attn);
  const auto drop_r = allrank::make_stream(drop_keys + 3, p_resid);
  if (is_bf16)
    return allrank::launch_bwd<__nv_bfloat16>(a, drop_a, drop_r, s);
  return allrank::launch_bwd<float>(a, drop_a, drop_r, s);
}
