// B5: masked slate attention for long slates with the K-streamed online
// softmax, forward and backward, for Hopper (sm_90a), fp32 or bf16 q, k, v:
// the same function as B4 (attention_fused.cu), plus each row's logsumexp.
//
// Replaces the TPU kernel `tiled_slate_attention` of the JAX package's
// ops/attention_tiled.py: forward pallas_call at line 228 (math in
// _fwd_kernel, lines 62-101), backward at line 265 (_bwd_kernel, 104-143).
//
// What bounds it: as B4, the L x L products, 4 * L^2 * d_k operations per
// slate-head forward and 10 * L^2 * d_k backward (S and dP rebuilt, dV, dQ,
// dK) against O(L * d_k) bytes: operations, in fp32 and bf16 alike.
//
// What the design does about it, and about the TPU kernel's assumptions:
//  * The TPU kernel keeps a slate-head's whole query block [Lp, d_k] in
//    VMEM and steps over key tiles in the grid's sequential axis, carrying
//    m, l and the accumulator in scratch. A GPU grid has no order, so the
//    key loop is inside the block: one block per (slate-head, 64-query
//    tile) streams 64-key tiles through shared memory with the recurrence of
//    attention_tiled.py:78-101 (m from -1e30, the denominator undropped,
//    the keep mask on the accumulator only, O = acc * (inv / max(l, 1e-30)),
//    lse = m + log(max(l, 1e-30))). m and l live in registers (a row's 16
//    threads are one half warp); the accumulator [64, d_k] in registers too.
//  * Tile width 64, not the TPU's 128-256: 64 rows by 64 keys is the
//    register tile of common.cuh, and with d_k <= 128 a block's q rows, one
//    key tile and one probability tile take at most 83 KB, so two blocks fit
//    an SM. The plain version in ops/attention_tiled.py walks the same
//    64-key tiles, so bf16 rounds at the same points.
//  * Keys past L are skipped with weight 0, not NEG_INF_FILL: a fully
//    padded slate therefore averages v over its L keys, as B4 and the XLA
//    path do. The JAX kernel pads keys to a multiple of its tile with the
//    mask set and averages over the padded length instead (ROADMAP Queue C).
//  * In bf16 the unnormalised p_acc is rounded to v's dtype before P . v, as
//    the TPU kernel does (line 92).
//  * The backward (attention_core.cuh) rebuilds P = exp(s - lse) per tile,
//    takes D = rowsum(dO * O) from the wrapper, and runs a dK/dV kernel per
//    key tile and a dQ kernel per query tile: no atomics, no [L, L] state.
//    The dropout masks replay from their keys.
//  * At B = 8, h = 4, L = 8192 the probability index reaches 2.1e9: it is a
//    64-bit size_t throughout.
#include "attention_core.cuh"

namespace allrank {
namespace {

template <class T>
__global__ void __launch_bounds__(kThreads)
    tiled_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const unsigned char* __restrict__ key_mask,
                     T* __restrict__ out, float* __restrict__ lse, int L,
                     int dk, int h, float scale, DropStream drop) {
  extern __shared__ float smem[];
  const int dkp = head_pad(dk), ldq = dkp + 1;
  float* Qs = smem;                // [64][ldq] query rows
  float* Ps = Qs + kTile * ldq;    // [64][kLdB] unnormalised probabilities
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
    m[i] = -1e30f;
    l[i] = 0.f;
  }
  for (int k0 = 0; k0 < L; k0 += kTile) {
    stage_cols_tile(KV, k + base, k0, L, dk);
    __syncthreads();
    float s[4][4] = {};
    mma_tile(s, Qs, ldq, KV, kLdB, dk);
    __syncthreads();
    stage_rows_tile(KV, dkp, v + base, k0, L, dk, dkp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        s[i][j] = key < L ? masked_score(s[i][j], scale, key, padded)
                          : -INFINITY;
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_max(tmax));
      const float alpha = expf(m[i] - m_new);
      const size_t prob0 = ((size_t)g * L + q0 + r) * L + k0;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float p = expf(s[i][j] - m_new);
        psum += p;
        if (drop.on && !drop_keep(drop, prob0 + c)) p = 0.f;
        Ps[r * kLdB + c] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + half_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[t][i][j] *= alpha;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < 2; ++t)
      if (t < nt) mma_tile(o[t], Ps, kLdB, KV + t * kTile, dkp, kTile);
    __syncthreads();
  }
  const float inv = drop.on ? drop.inv : 1.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= L) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    const float f = inv / denom;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = t * kTile + tx + 16 * j;
        if (t < nt && c < dk)
          out[base + (size_t)(q0 + r) * dk + c] = from_float<T>(o[t][i][j] * f);
      }
    }
    if (lse != nullptr && tx == 0)
      lse[(size_t)g * L + q0 + r] = m[i] + logf(denom);
  }
}

}  // namespace
}  // namespace allrank

// Launches the forward on `stream`; returns 0 or the CUDA error code. q, k,
// v and out are [G, L, d_k] (G = B * h, d_k <= 128) in bf16 if is_bf16, else
// fp32; key_mask is [B, L] bytes, non-zero at padded documents. lse ([G, L]
// fp32, each row's logsumexp) may be null. drop_keys holds {k0, k1,
// threshold} of the probability stream (ops/dropout.py), p_drop its rate.
extern "C" int tiled_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* key_mask,
                                   void* out, void* lse, int G, int L, int dk,
                                   int h, float scale, int is_bf16,
                                   const unsigned* drop_keys, double p_drop,
                                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto drop = allrank::make_stream(drop_keys, p_drop);
  if (is_bf16)
    return allrank::launch_attn_fwd<__nv_bfloat16>(
        allrank::tiled_fwd_kernel<__nv_bfloat16>, q, k, v, key_mask, out, lse,
        G, L, dk, h, scale, drop, s);
  return allrank::launch_attn_fwd<float>(allrank::tiled_fwd_kernel<float>, q,
                                         k, v, key_mask, out, lse, G, L, dk,
                                         h, scale, drop, s);
}

// Launches the backward's two kernels on `stream`; returns 0 or the CUDA
// error code. Inputs q, k, v, key_mask, lse from the forward, D ([G, L] fp32,
// rowsum(dO * O)) and dO ([G, L, d_k], q's dtype); outputs dq, dk, dv in
// q's dtype.
extern "C" int tiled_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* key_mask,
                                   const void* lse, const void* D,
                                   const void* dO, void* dq, void* dk_out,
                                   void* dv_out, int G, int L, int dk, int h,
                                   float scale, int is_bf16,
                                   const unsigned* drop_keys, double p_drop,
                                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const auto drop = allrank::make_stream(drop_keys, p_drop);
  void* Dm = const_cast<void*>(D);  // read only: the kernels with kLse
  if (is_bf16)
    return allrank::launch_attn_bwd<__nv_bfloat16, true>(
        q, k, v, key_mask, lse, dO, Dm, dq, dk_out, dv_out, G, L, dk, h,
        scale, drop, s);
  return allrank::launch_attn_bwd<float, true>(q, k, v, key_mask, lse, dO, Dm,
                                               dq, dk_out, dv_out, G, L, dk,
                                               h, scale, drop, s);
}
