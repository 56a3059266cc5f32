// Pieces shared by the bare slate-attention kernels B4 (attention_fused.cu)
// and B5 (attention_tiled.cu) in fp32: tile staging for q, k, v of one
// slate-head laid out [L, d_k], the masked score of one (query, key) pair,
// half-warp row reductions, and the two backward kernels, which differ
// between B4 and B5 only in how a row's probabilities are rebuilt and where
// D comes from. (Their bf16 flows run on the tensor cores:
// attention_mma_tiles.cuh.)
//
// Layout: q, k, v, out and their gradients are [G, L, d_k] with G = B * h
// (the [B, h, L, d_k] tensors of the wrappers, contiguous); key_mask is
// [B, L] bytes, non-zero at padded documents; slate-head g reads the mask
// row g / h. d_k <= 128: a [64, d_k] tile of fp32 is at most 32 KB, so a
// block keeps its query rows, one key tile and one 64 x 64 probability tile
// in shared memory and never anything of size L.
//
// The products are fp32 FMAs on 64 x 64 register tiles (common.cuh), a
// thread owning rows ty + 16 i and columns tx + 16 j of each tile; the 16
// threads of a row are one half warp, so row maxima and sums are shuffles.
#pragma once

#include "common.cuh"
#include "dropout.cuh"

namespace allrank {

constexpr int kMaxHeadDim = 128;

// d_k rounded up to whole 64-column tiles (64 or 128)
__host__ __device__ __forceinline__ int head_pad(int dk) {
  return (dk + kTile - 1) / kTile * kTile;
}

__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// S[r * ld + c] = src[row0 + r][c] for r < 64, c < dkp; zero past L and
// past d_k (the columns up to dkp are read by whole-tile products).
template <class T>
__device__ __forceinline__ void stage_rows_tile(float* S, int ld,
                                                const T* __restrict__ src,
                                                int row0, int L, int dk,
                                                int dkp) {
  for (int e = threadIdx.x; e < kTile * dkp; e += kThreads) {
    const int r = e / dkp, c = e % dkp;
    S[r * ld + c] = (row0 + r < L && c < dk)
                        ? to_float(src[(size_t)(row0 + r) * dk + c])
                        : 0.f;
  }
}

// S[c * kLdB + r] = src[row0 + r][c] for c < d_k: the tile transposed, the
// B operand of a product against its rows (q . k^T, dO . v^T). Neighbouring
// threads read neighbouring columns of a row; the odd pitch keeps the
// transposed stores free of bank conflicts.
template <class T>
__device__ __forceinline__ void stage_cols_tile(float* S,
                                                const T* __restrict__ src,
                                                int row0, int L, int dk) {
  for (int e = threadIdx.x; e < kTile * dk; e += kThreads) {
    const int r = e / dk, c = e % dk;
    S[c * kLdB + r] =
        row0 + r < L ? to_float(src[(size_t)(row0 + r) * dk + c]) : 0.f;
  }
}

// The scaled score of one pair: NEG_INF_FILL at a padded key; keys past L
// take no part (the callers give them weight 0).
__device__ __forceinline__ float masked_score(float acc, float scale, int key,
                                              const unsigned char* padded) {
  return padded[key] ? kNegInfFill : acc * scale;
}

// The attention probability of a pair from its row's statistics:
// exp(s - sub) * mul. B4 keeps (max, sum) per row, so sub = max and
// mul = 1 / sum (its forward's reciprocal-multiply, bit for bit); B5 keeps
// the row's logsumexp, so sub = lse and mul = 1.
struct RowSoftmax {
  float sub, mul;
};

template <bool kLse>
__device__ __forceinline__ RowSoftmax row_softmax(const float* __restrict__ st,
                                                  size_t row, bool ok) {
  RowSoftmax r{0.f, 0.f};
  if (ok) {
    if (kLse) {
      r.sub = st[row];
      r.mul = 1.f;
    } else {
      r.sub = st[2 * row];
      r.mul = 1.f / st[2 * row + 1];
    }
  }
  return r;
}

// One pair of the backward: the undropped probability p, the dropped
// gradient at it dpd = keep * dp / (1 - p_drop), the dropped probability,
// and whether dS may be non-zero there (a real, unpadded key).
struct PairGrad {
  float p, dpd, pd;
  bool live;
};

__device__ __forceinline__ PairGrad pair_grad(float s_acc, float dp,
                                              float scale, bool q_ok, int key,
                                              int L,
                                              const unsigned char* padded,
                                              RowSoftmax rs,
                                              const DropStream& drop,
                                              size_t prob_index) {
  PairGrad g{0.f, 0.f, 0.f, false};
  if (!q_ok || key >= L) return g;
  g.p = expf(masked_score(s_acc, scale, key, padded) - rs.sub) * rs.mul;
  g.live = !padded[key];
  float f = 1.f;
  if (drop.on) f = drop_keep(drop, prob_index) ? drop.inv : 0.f;
  g.dpd = dp * f;
  g.pd = g.p * f;
  return g;
}

// Floats of a buffer that holds either a transposed key tile [d_k, 65] or a
// row tile [64, dkp].
__host__ __device__ __forceinline__ int kv_floats(int dk, int dkp) {
  return dk * kLdB > kTile * dkp ? dk * kLdB : kTile * dkp;
}

// Shared memory of the forward kernels, in floats: one [64, dkp + 1] query
// tile, one [64, 65] probability tile, one key-or-value buffer.
__host__ __forceinline__ size_t fwd_smem_floats(int dk) {
  const int dkp = head_pad(dk);
  return (size_t)kTile * (dkp + 1) + (size_t)kTile * kLdB + kv_floats(dk, dkp);
}

// Shared memory of the backward kernels, in floats: two [64, dkp + 1] row
// tiles, a [d_k, 65] transposed key tile, a key-or-value buffer, one
// [64, 65] probability tile.
__host__ __forceinline__ size_t bwd_smem_floats(int dk) {
  const int dkp = head_pad(dk);
  return 2 * (size_t)kTile * (dkp + 1) + (size_t)dk * kLdB +
         kv_floats(dk, dkp) + (size_t)kTile * kLdB;
}

// The forward kernels of B4 and B5 share one signature: q, k, v, key_mask,
// out, the per-row statistics (B4's max and sum, B5's logsumexp; may be
// null), L, d_k, h, scale, the dropout stream.
template <class T>
using AttnFwdKernel = void (*)(const T*, const T*, const T*,
                               const unsigned char*, T*, float*, int, int,
                               int, float, DropStream);

// Launches a forward kernel on `stream`, one block per (64-query tile,
// slate-head); returns 0 or the CUDA error code.
template <class T>
cudaError_t launch_attn_fwd(AttnFwdKernel<T> kernel, const void* q,
                            const void* k, const void* v,
                            const void* key_mask, void* out, void* stats,
                            int G, int L, int dk, int h, float scale,
                            DropStream drop, cudaStream_t stream) {
  const size_t smem = fwd_smem_floats(dk) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kTile - 1) / kTile, G);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const unsigned char*>(key_mask),
      static_cast<T*>(out), static_cast<float*>(stats), L, dk, h, scale, drop);
  return cudaGetLastError();
}

// dQ of one (query tile, slate-head), looping over the key tiles:
// dS = P (dPd - D), zero at padded keys, rounded to T, then dQ += dS . k,
// scaled once at the end. D goes to Dg [G, L] for the dK/dV kernel. With
// kLse (B5) D = rowsum(dO * O), O the forward's output, summed in mma_tile's
// order for dP = dO . v^T, one fmaf chain over d_k: where a row has a single
// key O is that key's v, and dP - D is 0 as in exact arithmetic, not the
// noise of two sums in different orders. Otherwise (B4) a first walk over
// the key tiles takes D = rowsum(dPd * P) as the TPU kernel does.
template <class T, bool kLse>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const unsigned char* __restrict__ key_mask,
                       const float* __restrict__ stats,
                       const T* __restrict__ dO, const T* __restrict__ O,
                       float* __restrict__ Dg, T* __restrict__ dq, int L,
                       int dk, int h, float scale, DropStream drop) {
  extern __shared__ float smem[];
  const int dkp = head_pad(dk), ldq = dkp + 1;
  float* Qs = smem;                 // [64][ldq] query rows
  float* Os = Qs + kTile * ldq;     // [64][ldq] dO rows
  float* Ks = Os + kTile * ldq;     // [dk][kLdB] keys, transposed
  float* Us = Ks + dk * kLdB;       // values transposed, then key rows [64][dkp]
  float* Ps = Us + kv_floats(dk, dkp);  // [64][kLdB] dS
  const int g = blockIdx.y, q0 = blockIdx.x * kTile;
  const size_t base = (size_t)g * L * dk;
  const unsigned char* padded = key_mask + (size_t)(g / h) * L;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nt = dkp / kTile;

  stage_rows_tile(Qs, ldq, q + base, q0, L, dk, dkp);
  stage_rows_tile(Os, ldq, dO + base, q0, L, dk, dkp);
  RowSoftmax rs[4];
  float D[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const bool ok = q0 + r < L;
    rs[i] = row_softmax<kLse>(stats, (size_t)g * L + q0 + r, ok);
    D[i] = 0.f;
    if (kLse && ok) {
      const size_t at = base + (size_t)(q0 + r) * dk;
      for (int c = 0; c < dk; ++c)
        D[i] = fmaf(to_float(dO[at + c]), to_float(O[at + c]), D[i]);
      if (tx == 0) Dg[(size_t)g * L + q0 + r] = D[i];
    }
  }

  float acc[2][4][4] = {};
  for (int pass = kLse ? 1 : 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < L; k0 += kTile) {
      stage_cols_tile(Ks, k + base, k0, L, dk);
      stage_cols_tile(Us, v + base, k0, L, dk);
      __syncthreads();
      float s[4][4] = {}, dp[4][4] = {};
      mma_tile(s, Qs, ldq, Ks, kLdB, dk);
      mma_tile(dp, Os, ldq, Us, kLdB, dk);
      __syncthreads();
      if (pass == 1) stage_rows_tile(Us, dkp, k + base, k0, L, dk, dkp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const size_t row = (size_t)g * L + q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j, key = k0 + c;
          const PairGrad pg = pair_grad(s[i][j], dp[i][j], scale, q0 + r < L,
                                        key, L, padded, rs[i], drop,
                                        row * L + key);
          if (pass == 0)
            D[i] += pg.dpd * pg.p;
          else
            Ps[r * kLdB + c] =
                round_to<T>(pg.live ? pg.p * (pg.dpd - D[i]) : 0.f);
        }
      }
      if (pass == 0) continue;
      __syncthreads();
#pragma unroll
      for (int t = 0; t < 2; ++t)
        if (t < nt) mma_tile(acc[t], Ps, kLdB, Us + t * kTile, dkp, kTile);
      __syncthreads();
    }
    if (pass == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        D[i] = half_sum(D[i]);
        const int r = ty + 16 * i;
        if (tx == 0 && q0 + r < L) Dg[(size_t)g * L + q0 + r] = D[i];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= L) continue;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = t * kTile + tx + 16 * j;
        if (t < nt && c < dk)
          dq[base + (size_t)(q0 + r) * dk + c] = from_float<T>(acc[t][i][j] * scale);
      }
    }
  }
}

// dK and dV of one (key tile, slate-head), looping over the query tiles with
// P, dP and dS rebuilt exactly as the dQ kernel rebuilds them:
// dV += round(P_dropped)^T . dO and dK += round(dS)^T . q, scaled at the end.
template <class T, bool kLse>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const unsigned char* __restrict__ key_mask,
                        const float* __restrict__ stats,
                        const T* __restrict__ dO,
                        const float* __restrict__ Dg, T* __restrict__ dk_out,
                        T* __restrict__ dv_out, int L, int dk, int h,
                        float scale, DropStream drop) {
  extern __shared__ float smem[];
  const int dkp = head_pad(dk), ldq = dkp + 1;
  float* Qs = smem;                 // [64][ldq] query rows
  float* Os = Qs + kTile * ldq;     // [64][ldq] dO rows
  float* Ks = Os + kTile * ldq;     // [dk][kLdB] keys, transposed
  float* Vs = Ks + dk * kLdB;       // [dk][kLdB] values, transposed
  float* Ps = Vs + kv_floats(dk, dkp);  // [64][kLdB] P dropped, then dS
  const int g = blockIdx.y, kt0 = blockIdx.x * kTile;
  const size_t base = (size_t)g * L * dk;
  const unsigned char* padded = key_mask + (size_t)(g / h) * L;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nt = dkp / kTile;

  stage_cols_tile(Ks, k + base, kt0, L, dk);
  stage_cols_tile(Vs, v + base, kt0, L, dk);
  float dvacc[2][4][4] = {}, dkacc[2][4][4] = {};
  for (int q0 = 0; q0 < L; q0 += kTile) {
    stage_rows_tile(Qs, ldq, q + base, q0, L, dk, dkp);
    stage_rows_tile(Os, ldq, dO + base, q0, L, dk, dkp);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {}, ds[4][4];
    mma_tile(s, Qs, ldq, Ks, kLdB, dk);
    mma_tile(dp, Os, ldq, Vs, kLdB, dk);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const bool ok = q0 + r < L;
      const size_t row = (size_t)g * L + q0 + r;
      const RowSoftmax rs = row_softmax<kLse>(stats, row, ok);
      const float Dr = ok ? Dg[row] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, key = kt0 + c;
        const PairGrad pg = pair_grad(s[i][j], dp[i][j], scale, ok, key, L,
                                      padded, rs, drop, row * L + key);
        ds[i][j] = pg.live ? pg.p * (pg.dpd - Dr) : 0.f;
        Ps[r * kLdB + c] = round_to<T>(pg.pd);
      }
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < 2; ++t)
      if (t < nt) mma_tile_t(dvacc[t], Ps, kLdB, Os + t * kTile, ldq, kTile);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(ty + 16 * i) * kLdB + tx + 16 * j] = round_to<T>(ds[i][j]);
    __syncthreads();
#pragma unroll
    for (int t = 0; t < 2; ++t)
      if (t < nt) mma_tile_t(dkacc[t], Ps, kLdB, Qs + t * kTile, ldq, kTile);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (kt0 + r >= L) continue;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = t * kTile + tx + 16 * j;
        if (t < nt && c < dk) {
          const size_t o = base + (size_t)(kt0 + r) * dk + c;
          dk_out[o] = from_float<T>(dkacc[t][i][j] * scale);
          dv_out[o] = from_float<T>(dvacc[t][i][j]);
        }
      }
    }
  }
}

// The two backward kernels of one call, on `stream`: the dQ kernel first,
// which writes D [G, L] (B5, kLse: from the forward's output O; B4: O is
// unused and may be null), then the dK/dV kernel. Returns 0 or the CUDA
// error code.
template <class T, bool kLse>
cudaError_t launch_attn_bwd(const void* q, const void* k, const void* v,
                            const void* key_mask, const void* stats,
                            const void* dO, const void* O, void* D, void* dq,
                            void* dk_out, void* dv_out, int G, int L, int dk,
                            int h, float scale, DropStream drop,
                            cudaStream_t stream) {
  const size_t smem = bwd_smem_floats(dk) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_kernel<T, kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_bwd_dkv_kernel<T, kLse>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kTile - 1) / kTile, G);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const auto* mask = static_cast<const unsigned char*>(key_mask);
  const auto* st = static_cast<const float*>(stats);
  const T* dot = static_cast<const T*>(dO);
  float* Dg = static_cast<float*>(D);
  attn_bwd_dq_kernel<T, kLse><<<grid, kThreads, smem, stream>>>(
      qt, kt, vt, mask, st, dot, static_cast<const T*>(O), Dg,
      static_cast<T*>(dq), L, dk, h, scale, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attn_bwd_dkv_kernel<T, kLse><<<grid, kThreads, smem, stream>>>(
      qt, kt, vt, mask, st, dot, Dg, static_cast<T*>(dk_out),
      static_cast<T*>(dv_out), L, dk, h, scale, drop);
  return cudaGetLastError();
}

}  // namespace allrank
