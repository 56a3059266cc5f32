// The per-tile bodies of the sublayer kernels B1 (attention_block.cu) and
// B2 (ffn_block.cu), as __device__ functions of a tile index: one call
// computes what one block of the chained kernels' grids computes. The
// chained __global__ kernels are thin wrappers that pass their blockIdx;
// the whole-encoder kernel (encoder_block.cuh) walks B1's tiles from a
// persistent grid where a head is wider than 128, as B1's route does. Both
// therefore run the same products in the same order.
//
// Each body takes its shared memory as `smem` (the *_smem_floats() below
// give the sizes) and its tile coordinates as arguments and reads nothing
// of blockIdx or gridDim. Every body is called by all kThreads threads of a
// block; a caller that runs several bodies in a row on one block puts a
// __syncthreads() between them (a body's last reads of `smem` may still be
// in flight when it returns).
//
// Only the parameters (weights, biases, LN pairs) and the key mask carry
// __restrict__: the whole-encoder kernel writes the activations and the
// scratch in one phase and reads them in the next, within one launch, so
// they must not be read through the non-coherent read-only cache that a
// const __restrict__ pointer lets the compiler use.
//
// The math, the rounding points and the TPU kernels each body replaces are
// described in attention_block.cu and ffn_block.cu.
#pragma once

#include "backward.cuh"
#include "common.cuh"
#include "dropout.cuh"

namespace allrank {

// ---------------------------------------------------------------------------
// shared-memory sizes, in floats

__host__ __device__ constexpr int ln_qkv_smem_floats() {
  return kTile * kLdA + kChunk * kLdB + 2 * kTile;
}
__host__ __device__ constexpr int attn_out_smem_floats(int d) {
  return kTile * kLdA + kChunk * kLdB + kTile * kLdB + 2 * kTile +
         kTile * (d + 1);
}
__host__ __device__ constexpr int bwd_rows_smem_floats() {
  return kTile * kLdA + kChunk * kLdB + 2 * kTile;
}
__host__ __device__ constexpr int bwd_attn_smem_floats() {
  return kTile * kLdA + kChunk * kLdB + kTile * kLdB + 3 * kTile;
}
__host__ __device__ constexpr int bwd_ln_qkv_smem_floats(int d) {
  return kTile * kLdA + kChunk * kLdB + 2 * kTile + kTile * (d + 1);
}
__host__ __device__ constexpr int ffn_fwd_smem_floats(int d) {
  return kChunk * kLdB + kTile * kLdB + 2 * kTile + kTile * (d + 1);
}
__host__ __device__ constexpr int ffn_bwd_smem_floats(int d) {
  return kChunk * kLdB + kTile * kLdB + 2 * kTile + 2 * kTile * (d + 1);
}

// ---------------------------------------------------------------------------
// B1 forward

// qkv[m, :] = round(round(LN(x[m, :])) . round(Wqkv) + bqkv) for the 64-row
// by 64-column tile (m_tile, n_tile) of the [M, 3d] output.
template <class T>
__device__ void ln_qkv_tile(float* smem, const T* x,
                            const float* __restrict__ ln_scale,
                            const float* __restrict__ ln_bias,
                            const float* __restrict__ wqkv,
                            const float* __restrict__ bqkv,
                            T* qkv, int M, int d, int m_tile,
                            int n_tile) {
  float* As = smem;                  // [kTile][kLdA]  LN(x) chunk
  float* Bs = As + kTile * kLdA;     // [kChunk][kLdB] Wqkv chunk
  float* mean = Bs + kChunk * kLdB;  // [kTile]
  float* rdenom = mean + kTile;      // [kTile]
  const int n_out = 3 * d;
  const int m0 = m_tile * kTile, n0 = n_tile * kTile;
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

// y[q0:q0+64] of one slate (q0 = q_tile * 64): attention over all heads,
// then the out-projection, its bias, the output dropout and the residual.
// With `stats` non-null, also each row's softmax max and sum per head.
template <class T, int kMode = kAttnFull>
__device__ void attn_out_tile(float* smem, const T* qkv,
                              const unsigned char* __restrict__ key_mask,
                              const T* x,
                              const float* __restrict__ wout,
                              const float* __restrict__ bout,
                              T* y, float* stats,
                              int L, int d, int h, float scale,
                              const DropStream& drop_a,
                              const DropStream& drop_r, int q_tile,
                              int slate) {
  float* As = smem;                    // [kTile][kLdA]  query chunk
  float* Bs = As + kTile * kLdA;       // [kChunk][kLdB] key, value or Wout chunk
  float* Ps = Bs + kChunk * kLdB;      // [kTile][kLdB]  scores, then probabilities
  float* row_max = Ps + kTile * kLdB;  // [kTile]
  float* row_sum = row_max + kTile;    // [kTile]
  float* Cs = row_sum + kTile;         // [kTile][d + 1] ctx of all heads
  const int ldc = d + 1;
  const int dk = d / h, ld = 3 * d;
  const int q0 = q_tile * kTile;
  const int rows = min(kTile, L - q0);
  const T* base = qkv + (size_t)slate * L * ld;
  const unsigned char* padded = key_mask + (size_t)slate * L;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  for (int e = tid; e < kTile * ldc; e += kThreads) Cs[e] = 0.f;

  if constexpr (kMode == kAttnFrame) {
    __syncthreads();
    for (int e = tid; e < kTile * d; e += kThreads) {
      const int r = e / d, c = e % d;
      if (r < rows) {
        const T* row = base + (size_t)(q0 + r) * ld;
        Cs[r * ldc + c] = round_to<T>(
            round_to<T>(to_float(row[c]) + to_float(row[d + c])) +
            to_float(row[2 * d + c]));
      }
    }
  }
  for (int head = 0; head < (kMode == kAttnFrame ? 0 : h); ++head) {
    const int qoff = head * dk, koff = d + head * dk, voff = 2 * d + head * dk;
    if (tid < kTile) {
      row_max[tid] = -INFINITY;
      row_sum[tid] = 0.f;
    }
    __syncthreads();
    // pass 0: row max and sum of exp; pass 1: probabilities and P.V
    for (int pass = kMode == kAttnNoSoftmax ? 1 : 0; pass < 2; ++pass) {
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
          if constexpr (kMode == kAttnExp2) {
            for (int c = 0; c < 16; ++c)
              tsum += exp2f((prow[c] - new_max) * kLog2e);
          } else {
            for (int c = 0; c < 16; ++c) tsum += expf(prow[c] - new_max);
          }
          tsum += __shfl_xor_sync(0xffffffffu, tsum, 1);
          tsum += __shfl_xor_sync(0xffffffffu, tsum, 2);
          __syncwarp();  // the row's four lanes have read row_max[r]
          if (part == 0) {
            if constexpr (kMode == kAttnExp2)
              row_sum[r] =
                  row_sum[r] * exp2f((old_max - new_max) * kLog2e) + tsum;
            else
              row_sum[r] = row_sum[r] * expf(old_max - new_max) + tsum;
            row_max[r] = new_max;
          }
        } else {
          const size_t prob0 = (((size_t)slate * h + head) * L + q0) * L + k0;
          for (int e = tid; e < kTile * kTile; e += kThreads) {
            const int r = e / kTile, c = e % kTile;
            float p;
            if constexpr (kMode == kAttnNoSoftmax)
              p = k0 + c < L ? Ps[r * kLdB + c] * 0.001f : 0.f;
            else if constexpr (kMode == kAttnExp2)
              p = exp2f((Ps[r * kLdB + c] - row_max[r]) * kLog2e) *
                  (1.f / row_sum[r]);
            else if constexpr (kMode == kAttnNormAfterPv)
              p = expf(Ps[r * kLdB + c] - row_max[r]);
            else
              p = expf(Ps[r * kLdB + c] - row_max[r]) * (1.f / row_sum[r]);
            if (drop_a.on)
              p = drop_keep(drop_a, prob0 + (size_t)r * L + c) ? p / drop_a.denom
                                                               : 0.f;
            Ps[r * kLdB + c] = round_to<T>(p);
          }
          __syncthreads();
          if constexpr (kMode == kAttnNoPv) {
            // each (row, key < d_k) of this key tile belongs to one thread
            for (int e = tid; e < kTile * kTile; e += kThreads) {
              const int r = e / kTile, key = k0 + e % kTile;
              if (r < rows && key < dk && key < L)
                Cs[r * ldc + qoff + key] = round_to<T>(
                    to_float(base[(size_t)(q0 + r) * ld + voff + key]) +
                    round_to<T>(Ps[r * kLdB + e % kTile] * 0.001f));
            }
          }
          for (int t0 = 0; t0 < (kMode == kAttnNoPv ? 0 : dk); t0 += kTile) {
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
    if constexpr (kMode == kAttnNormAfterPv) {
      for (int e = tid; e < kTile * dk; e += kThreads) {
        const int r = e / dk, c = e % dk;
        Cs[r * ldc + qoff + c] *= 1.f / row_sum[r];
      }
      __syncthreads();  // before the next head resets row_sum
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
// B1 backward

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

// da = round(drop_r(dy)) and dO = round(da . round(Wout)^T) for the 64-row by
// 64-column tile (m_tile, n_tile); the tiles of the first column tile also
// write da and n = round(LN(x)) (the A operand of dWqkv).
template <class T>
__device__ void bwd_rows_tile(float* smem, const T* x,
                              const T* dy,
                              const float* __restrict__ ln_scale,
                              const float* __restrict__ ln_bias,
                              const float* __restrict__ wout,
                              T* da, T* dO,
                              T* n_act, int M, int d,
                              const DropStream& drop_r, int m_tile,
                              int n_tile) {
  float* As = smem;                  // [kTile][kLdA]
  float* Bs = As + kTile * kLdA;     // [kChunk][kLdB]
  float* mean = Bs + kChunk * kLdB;  // [kTile]
  float* rdenom = mean + kTile;      // [kTile]
  const int m0 = m_tile * kTile, n0 = n_tile * kTile;
  const int rows = min(kTile, M - m0);
  const bool lead = n_tile == 0;
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

// Per (slate, head) = slate_head, 64-query tile q_tile and 64-column tile
// t_tile of d_k. Pass 0 walks the key tiles for ctx = round(P_d) . v
// (dWout's A operand) and D = sum_j dPd * P; pass 1 walks them again for
// dS = P (dPd - D), rounded, and dQ = dS . k * scale. P and dP = dO . v^T
// are recomputed per tile.
template <class T>
__device__ void bwd_dq_tile(float* smem, const T* qkv,
                            const unsigned char* __restrict__ key_mask,
                            const float* stats,
                            const T* dO, T* ctx,
                            float* Dg, T* dqkv,
                            int L, int d, int h, float scale,
                            const DropStream& drop_a, int q_tile,
                            int slate_head, int t_tile) {
  float* As = smem;                  // [kTile][kLdA]
  float* Bs = As + kTile * kLdA;     // [kChunk][kLdB]
  float* Ps = Bs + kChunk * kLdB;    // [kTile][kLdB]
  float* rmax = Ps + kTile * kLdB;   // [kTile]
  float* rinv = rmax + kTile;        // [kTile]
  float* Drow = rinv + kTile;        // [kTile]
  const int dk = d / h, ld = 3 * d;
  const int slate = slate_head / h, head = slate_head % h;
  const int q0 = q_tile * kTile, t0 = t_tile * kTile;
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
    if (pass == 0 && t_tile == 0 && tid < rows)
      Dg[sh * L + q0 + tid] = Drow[tid];
  }
}

// Per (slate, head) = slate_head, 64-key tile k_tile and 64-column tile
// t_tile of d_k, looping over the query tiles: dV = round(P_d)^T . dO and
// dK = dS^T . q * scale, with P, dP and dS recomputed exactly as
// bwd_dq_tile computes them.
template <class T>
__device__ void bwd_dkv_tile(float* smem, const T* qkv,
                             const unsigned char* __restrict__ key_mask,
                             const float* stats,
                             const float* Dg,
                             const T* dO, T* dqkv,
                             int L, int d, int h, float scale,
                             const DropStream& drop_a, int k_tile,
                             int slate_head, int t_tile) {
  float* As = smem;                  // [kTile][kLdA]
  float* Bs = As + kTile * kLdA;     // [kChunk][kLdB]
  float* Ps = Bs + kChunk * kLdB;    // [kTile][kLdB]
  float* rmax = Ps + kTile * kLdB;   // [kTile]
  float* rinv = rmax + kTile;        // [kTile]
  float* Drow = rinv + kTile;        // [kTile]
  const int dk = d / h, ld = 3 * d;
  const int slate = slate_head / h, head = slate_head % h;
  const int kt0 = k_tile * kTile, t0 = t_tile * kTile;
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

// dn = dqkv . round(Wqkv)^T for the 64 rows of m_tile, then the LN
// backward: dx and the tile's partial sums of dg and db (part_ln row
// m_tile).
template <class T>
__device__ void bwd_ln_qkv_tile(float* smem, const T* x,
                                const T* dy,
                                const T* dqkv,
                                const float* __restrict__ ln_scale,
                                const float* __restrict__ wqkv,
                                T* dx,
                                float* part_ln, int M, int d,
                                int m_tile) {
  float* As = smem;                   // [kTile][kLdA]  dqkv chunk
  float* Bs = As + kTile * kLdA;      // [kChunk][kLdB] Wqkv^T chunk
  float* rmean = Bs + kChunk * kLdB;  // [kTile]
  float* rden = rmean + kTile;        // [kTile]
  float* Ns = rden + kTile;           // [kTile][d + 1] dn
  const int ldn = d + 1, n3 = 3 * d;
  const int m0 = m_tile * kTile;
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
                   part_ln + (size_t)m_tile * 2 * d, rmean, rden);
}

// ---------------------------------------------------------------------------
// B2 forward and backward

// The FFN forward of the 64 rows of m_tile.
template <class T>
__device__ void ffn_fwd_tile(float* smem, const T* x,
                             const float* __restrict__ ln_scale,
                             const float* __restrict__ ln_bias,
                             const float* __restrict__ w1,
                             const float* __restrict__ b1,
                             const float* __restrict__ w2,
                             const float* __restrict__ b2, T* y,
                             int M, int d, int d_ff, const DropStream& drop_h,
                             const DropStream& drop_r, int m_tile) {
  float* Bs = smem;                  // [kChunk][kLdB] W1 or W2 chunk
  float* Hs = Bs + kChunk * kLdB;    // [kTile][kLdB]  hidden chunk
  float* mean = Hs + kTile * kLdB;   // [kTile]
  float* rdenom = mean + kTile;      // [kTile]
  float* Ns = rdenom + kTile;        // [kTile][d + 1] LN(x) rows
  const int ldn = d + 1;
  const int m0 = m_tile * kTile;
  const int rows = min(kTile, M - m0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* xt = x + (size_t)m0 * d;
  T* yt = y + (size_t)m0 * d;

  ln_row_stats(xt, rows, d, mean, rdenom);
  __syncthreads();
  for (int e = tid; e < kTile * d; e += kThreads) {
    const int r = e / d, k = e % d;
    Ns[r * ldn + k] =
        r < rows ? round_to<T>((to_float(xt[(size_t)r * d + k]) - mean[r]) *
                                   rdenom[r] * ln_scale[k] +
                               ln_bias[k])
                 : 0.f;
  }
  __syncthreads();

  float out[4][4][4] = {};  // [64-column tile of d][i][j]
  for (int f0 = 0; f0 < d_ff; f0 += kTile) {
    float hacc[4][4] = {};
    for (int k0 = 0; k0 < d; k0 += kChunk) {
      const int depth = min(kChunk, d - k0);
      for (int e = tid; e < kChunk * kTile; e += kThreads) {
        const int kk = e / kTile, n = e % kTile;
        Bs[kk * kLdB + n] =
            (kk < depth && f0 + n < d_ff)
                ? round_to<T>(w1[(size_t)(k0 + kk) * d_ff + f0 + n])
                : 0.f;
      }
      __syncthreads();
      mma_tile(hacc, Ns + k0, ldn, Bs, kLdB, depth);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j, f = f0 + c;
        float hv = 0.f;
        if (f < d_ff) {
          hv = fmaxf(hacc[i][j] + b1[f], 0.f);
          if (drop_h.on)
            hv = drop_keep(drop_h, (size_t)(m0 + r) * d_ff + f)
                     ? hv / drop_h.denom
                     : 0.f;
        }
        Hs[r * kLdB + c] = round_to<T>(hv);
      }
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (t * kTile < d) {
        for (int kk0 = 0; kk0 < kTile; kk0 += kChunk) {
          for (int e = tid; e < kChunk * kTile; e += kThreads) {
            const int kk = e / kTile, n = e % kTile;
            const int f = f0 + kk0 + kk, c = t * kTile + n;
            Bs[kk * kLdB + n] =
                (f < d_ff && c < d) ? round_to<T>(w2[(size_t)f * d + c]) : 0.f;
          }
          __syncthreads();
          mma_tile(out[t], Hs + kk0, kLdB, Bs, kLdB, kChunk);
          __syncthreads();
        }
      }
    }
  }

#pragma unroll
  for (int t = 0; t < 4; ++t) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, n = t * kTile + tx + 16 * j;
        if (r < rows && n < d) {
          const size_t o = (size_t)r * d + n;
          float v = out[t][i][j] + b2[n];
          if (drop_r.on)
            v = drop_keep(drop_r, (size_t)m0 * d + o) ? v / drop_r.denom : 0.f;
          yt[o] = from_float<T>(to_float(xt[o]) + v);
        }
      }
    }
  }
}

// The FFN backward of the 64 rows of m_tile: writes n_act = round(LN(x)),
// dout = round(drop_r(dy)), hidden = round(drop_h(relu(pre))) and
// dh = round((dout . W2^T) * mask * gate) (the operands of the weight
// gradients), dx, and the tile's partial sums of dg and db (part_ln row
// m_tile).
template <class T>
__device__ void ffn_bwd_tile(float* smem, const T* x,
                             const float* __restrict__ ln_scale,
                             const float* __restrict__ ln_bias,
                             const float* __restrict__ w1,
                             const float* __restrict__ b1,
                             const float* __restrict__ w2,
                             const T* dy, T* dx,
                             T* n_act, T* dout,
                             T* hidden, T* dh,
                             float* part_ln, int M, int d,
                             int d_ff, const DropStream& drop_h,
                             const DropStream& drop_r, int m_tile) {
  float* Bs = smem;                  // [kChunk][kLdB] W1 or W2 chunk
  float* Hs = Bs + kChunk * kLdB;    // [kTile][kLdB]  dh chunk
  float* mean = Hs + kTile * kLdB;   // [kTile]
  float* rdenom = mean + kTile;      // [kTile]
  float* Ns = rdenom + kTile;        // [kTile][d + 1] LN(x) rows, then dn
  const int ldn = d + 1;
  float* Ds = Ns + kTile * ldn;      // [kTile][d + 1] dout rows
  const int m0 = m_tile * kTile;
  const int rows = min(kTile, M - m0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t o0 = (size_t)m0 * d;
  const T* xt = x + o0;

  ln_row_stats(xt, rows, d, mean, rdenom);
  __syncthreads();
  for (int e = tid; e < kTile * d; e += kThreads) {
    const int r = e / d, k = e % d;
    float n = 0.f, g = 0.f;
    if (r < rows) {
      n = round_to<T>((to_float(xt[e]) - mean[r]) * rdenom[r] * ln_scale[k] +
                      ln_bias[k]);
      n_act[o0 + e] = from_float<T>(n);
      g = to_float(dy[o0 + e]);
      if (drop_r.on) g = drop_keep(drop_r, o0 + e) ? g * drop_r.inv : 0.f;
      g = round_to<T>(g);
      dout[o0 + e] = from_float<T>(g);
    }
    Ns[r * ldn + k] = n;
    Ds[r * ldn + k] = g;
  }
  __syncthreads();

  float dn[4][4][4] = {};  // [64-column tile of d][i][j]
  for (int f0 = 0; f0 < d_ff; f0 += kTile) {
    float pre[4][4] = {}, dhacc[4][4] = {};
    for (int k0 = 0; k0 < d; k0 += kChunk) {
      const int depth = min(kChunk, d - k0);
      for (int e = tid; e < kChunk * kTile; e += kThreads) {
        const int kk = e / kTile, n = e % kTile;
        Bs[kk * kLdB + n] =
            (kk < depth && f0 + n < d_ff)
                ? round_to<T>(w1[(size_t)(k0 + kk) * d_ff + f0 + n])
                : 0.f;
      }
      __syncthreads();
      mma_tile(pre, Ns + k0, ldn, Bs, kLdB, depth);
      __syncthreads();
    }
    for (int k0 = 0; k0 < d; k0 += kChunk) {
      const int depth = min(kChunk, d - k0);
      // Bs[kk][n] = W2[f0 + n][k0 + kk]: read along W2's rows
      for (int e = tid; e < kChunk * kTile; e += kThreads) {
        const int n = e / kChunk, kk = e % kChunk;
        Bs[kk * kLdB + n] =
            (kk < depth && f0 + n < d_ff)
                ? round_to<T>(w2[(size_t)(f0 + n) * d + k0 + kk])
                : 0.f;
      }
      __syncthreads();
      mma_tile(dhacc, Ds + k0, ldn, Bs, kLdB, depth);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j, f = f0 + c;
        float hv = 0.f, g = 0.f;
        if (f < d_ff) {
          const float p = pre[i][j] + b1[f];
          const float gate = p > 0.f ? 1.f : 0.f;
          hv = fmaxf(p, 0.f);
          g = dhacc[i][j];
          if (drop_h.on) {
            const bool keep = drop_keep(drop_h, (size_t)(m0 + r) * d_ff + f);
            hv = keep ? hv * drop_h.inv : 0.f;
            g = keep ? g * drop_h.inv : 0.f;
          }
          g = round_to<T>(g * gate);
          if (r < rows) {
            const size_t o = (size_t)(m0 + r) * d_ff + f;
            hidden[o] = from_float<T>(hv);
            dh[o] = from_float<T>(g);
          }
        }
        Hs[r * kLdB + c] = g;
      }
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (t * kTile < d) {
        for (int kk0 = 0; kk0 < kTile; kk0 += kChunk) {
          // Bs[kk][n] = W1[t*64 + n][f0 + kk0 + kk]: read along W1's rows
          for (int e = tid; e < kChunk * kTile; e += kThreads) {
            const int n = e / kChunk, kk = e % kChunk;
            const int f = f0 + kk0 + kk, c = t * kTile + n;
            Bs[kk * kLdB + n] =
                (f < d_ff && c < d) ? round_to<T>(w1[(size_t)c * d_ff + f])
                                    : 0.f;
          }
          __syncthreads();
          mma_tile(dn[t], Hs + kk0, kLdB, Bs, kLdB, kChunk);
          __syncthreads();
        }
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
        if (n < d) Ns[(ty + 16 * i) * ldn + n] = dn[t][i][j];
      }
  __syncthreads();
  ln_backward_tile(xt, dy + o0, dx + o0, Ns, ldn, rows, d, ln_scale,
                   part_ln + (size_t)m_tile * 2 * d, mean, rdenom);
}

}  // namespace allrank
