// B4: masked slate attention with the exact, normalised probabilities,
// forward and backward, for Hopper (sm_90a), fp32 or bf16 q, k, v:
//   out = drop(P) . v,  P = softmax(q . k^T / sqrt(d_k), padded keys -1e9)
// with P formed as exp(s - max) * (1 / sum) and dropout on P from the keyed
// hash of csrc/dropout.cuh (stream ATTN_PROBS, index
// ((b * h + head) * L + i) * L + j).
//
// Replaces the TPU kernel `fused_slate_attention` of the JAX package's
// ops/attention_pallas.py: forward pallas_call at line 179 (math in
// _fwd_kernel, lines 82-92), backward at line 206 (_bwd_kernel, 95-117).
//
// What bounds it: the two L x L products, 4 * L^2 * d_k operations per
// slate-head forward, against 4 * L * d_k values in and out; at L = 1200,
// d_k = 32 that is some 1,900 operations a byte, so operations bound it on
// this card in fp32 and bf16 alike.
//
// What the design does about it, and about the TPU kernel's assumptions:
//  * The TPU kernel holds whole [L, L] probability tiles in VMEM (its cap of
//    1224 is a VMEM fact). A block here has 227 KB: one slate-head's
//    [1200, 1200] fp32 tile is 5.8 MB. So one block per (slate-head,
//    64-query tile) walks the key tiles twice, holding one 64 x 64 score
//    tile: a first pass takes each row's max and sum (online, rescaled per
//    tile), a second recomputes the scores, forms P exactly as the TPU
//    kernel's _probs does, drops it, rounds it to v's dtype and accumulates
//    P . v in registers. In training the row max and sum [G, L, 2] are kept.
//  * The backward (attention_core.cuh) recomputes P tile by tile from them,
//    bitwise the forward's, and needs no atomics: a dQ kernel per query
//    tile, which first takes D = rowsum(dPd * P) as the TPU kernel does and
//    writes it, then a dK/dV kernel per key tile looping over the query
//    tiles. dS is zero at padded keys; in bf16 P_dropped and dS are rounded
//    where the TPU kernel rounds them.
//  * Keys past L have weight 0 and padded keys score -1e9, so a fully padded
//    slate averages v over its L keys, never NaN.
//  * Products are fp32 FMAs on the SIMT units; tensor cores are later work.
#include "attention_core.cuh"

namespace allrank {
namespace {

template <class T>
__global__ void __launch_bounds__(kThreads)
    fused_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const unsigned char* __restrict__ key_mask,
                     T* __restrict__ out, float* __restrict__ stats, int L,
                     int dk, int h, float scale, DropStream drop) {
  extern __shared__ float smem[];
  const int dkp = head_pad(dk), ldq = dkp + 1;
  float* Qs = smem;                // [64][ldq] query rows
  float* Ps = Qs + kTile * ldq;    // [64][kLdB] probabilities
  float* KV = Ps + kTile * kLdB;   // keys transposed [dk][kLdB], then values [64][dkp]
  const int g = blockIdx.y, q0 = blockIdx.x * kTile;
  const size_t base = (size_t)g * L * dk;
  const unsigned char* padded = key_mask + (size_t)(g / h) * L;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nt = dkp / kTile;

  stage_rows_tile(Qs, ldq, q + base, q0, L, dk, dkp);
  float m[4], l[4], o[2][4][4] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  // pass 0: row max and sum; pass 1: probabilities and P . v
  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < L; k0 += kTile) {
      stage_cols_tile(KV, k + base, k0, L, dk);
      __syncthreads();
      float s[4][4] = {};
      mma_tile(s, Qs, ldq, KV, kLdB, dk);
      __syncthreads();
      if (pass == 1) stage_rows_tile(KV, dkp, v + base, k0, L, dk, dkp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + tx + 16 * j;
          s[i][j] = key < L ? masked_score(s[i][j], scale, key, padded)
                            : -INFINITY;
        }
        if (pass == 0) {
          float tmax = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
          const float new_max = fmaxf(m[i], half_max(tmax));
          float tsum = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) tsum += expf(s[i][j] - new_max);
          l[i] = l[i] * expf(m[i] - new_max) + half_sum(tsum);
          m[i] = new_max;
        } else {
          const size_t prob0 = ((size_t)g * L + q0 + r) * L + k0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = tx + 16 * j;
            float p = expf(s[i][j] - m[i]) * (1.f / l[i]);
            if (drop.on)
              p = drop_keep(drop, prob0 + c) ? p / drop.denom : 0.f;
            Ps[r * kLdB + c] = round_to<T>(p);
          }
        }
      }
      if (pass == 0) continue;
      __syncthreads();
#pragma unroll
      for (int t = 0; t < 2; ++t)
        if (t < nt) mma_tile(o[t], Ps, kLdB, KV + t * kTile, dkp, kTile);
      __syncthreads();
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
          out[base + (size_t)(q0 + r) * dk + c] = from_float<T>(o[t][i][j]);
      }
    }
    if (stats != nullptr && tx == 0) {
      const size_t row = (size_t)g * L + q0 + r;
      stats[2 * row] = m[i];
      stats[2 * row + 1] = l[i];
    }
  }
}

}  // namespace
}  // namespace allrank

// Launches the forward on `stream`; returns 0 or the CUDA error code. q, k,
// v and out are [G, L, d_k] (G = B * h, d_k <= 128) in bf16 if is_bf16, else
// fp32; key_mask is [B, L] bytes, non-zero at padded documents. stats
// ([G, L, 2] fp32: each row's max and sum) may be null. drop_keys holds
// {k0, k1, threshold} of the probability stream (ops/dropout.py), p_drop
// its rate (0: no dropout).
extern "C" int attention_fused_fwd(const void* q, const void* k,
                                   const void* v, const void* key_mask,
                                   void* out, void* stats, int G, int L,
                                   int dk, int h, float scale, int is_bf16,
                                   const unsigned* drop_keys, double p_drop,
                                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto drop = allrank::make_stream(drop_keys, p_drop);
  if (is_bf16)
    return allrank::launch_attn_fwd<__nv_bfloat16>(
        allrank::fused_fwd_kernel<__nv_bfloat16>, q, k, v, key_mask, out,
        stats, G, L, dk, h, scale, drop, s);
  return allrank::launch_attn_fwd<float>(allrank::fused_fwd_kernel<float>, q,
                                         k, v, key_mask, out, stats, G, L, dk,
                                         h, scale, drop, s);
}

// Launches the backward's two kernels on `stream`; returns 0 or the CUDA
// error code. Inputs q, k, v, key_mask, stats from the forward and dO
// ([G, L, d_k], q's dtype); outputs dq, dk, dv in q's dtype; D ([G, L] fp32)
// is scratch from the caller.
extern "C" int attention_fused_bwd(const void* q, const void* k,
                                   const void* v, const void* key_mask,
                                   const void* stats, const void* dO, void* D,
                                   void* dq, void* dk_out, void* dv_out, int G,
                                   int L, int dk, int h, float scale,
                                   int is_bf16, const unsigned* drop_keys,
                                   double p_drop, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto drop = allrank::make_stream(drop_keys, p_drop);
  if (is_bf16)
    return allrank::launch_attn_bwd<__nv_bfloat16, false>(
        q, k, v, key_mask, stats, dO, D, dq, dk_out, dv_out, G, L, dk, h,
        scale, drop, s);
  return allrank::launch_attn_bwd<float, false>(q, k, v, key_mask, stats, dO,
                                                D, dq, dk_out, dv_out, G, L,
                                                dk, h, scale, drop, s);
}
