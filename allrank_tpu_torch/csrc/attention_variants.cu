// The attention sublayer forward with one stage changed, for Hopper
// (sm_90a), bf16: the kernels of the stage-by-stage probe of B1's forward.
//
// Replaces the TPU kernel `make_variant` of the JAX package's
// tools/exp_attn_decompose.py:114 (pallas_call at line 126, math in
// _variant_fwd_vmem, lines 54-103): B1's forward at dropout 0 (LN with gain
// and bias, QKV and its bias, h heads, padded keys filled with -1e9, the
// softmax, P.V, the out-projection and its bias, the residual) in one of six
// modes, which differ in the attention core alone (sublayer_tiles.cuh,
// AttnMode): full (B1's own math), no_softmax, exp2, norm_after_pv, no_pv
// and frame. Timing the modes side by side splits the forward's time by
// stage.
//
// The kernels are B1's forward (attention_block.cu): ln_qkv over 64-row
// tiles, then one block per slate and 64-query tile running attn_out_tile
// with the mode as a template parameter; kAttnFull is B1's instantiation,
// so the full mode computes B1's forward bit for bit, and B1 and the
// whole-encoder kernel compile as before. What bounds them is B1's bound
// (operations; attention_block.cu), less the stage a mode removes.
#include "common.cuh"
#include "dropout.cuh"
#include "sublayer_tiles.cuh"

namespace allrank {
namespace {

using bf16 = __nv_bfloat16;

__global__ void __launch_bounds__(kThreads)
    variant_ln_qkv_kernel(const bf16* __restrict__ x,
                          const float* __restrict__ ln_scale,
                          const float* __restrict__ ln_bias,
                          const float* __restrict__ wqkv,
                          const float* __restrict__ bqkv,
                          bf16* __restrict__ qkv, int M, int d) {
  extern __shared__ float smem[];
  ln_qkv_tile(smem, x, ln_scale, ln_bias, wqkv, bqkv, qkv, M, d, blockIdx.x,
              blockIdx.y);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    variant_attn_out_kernel(const bf16* __restrict__ qkv,
                            const unsigned char* __restrict__ key_mask,
                            const bf16* __restrict__ x,
                            const float* __restrict__ wout,
                            const float* __restrict__ bout,
                            bf16* __restrict__ y, int L, int d, int h,
                            float scale) {
  extern __shared__ float smem[];
  const DropStream off{0u, 0u, 0u, 0, 1.f, 1.f};
  attn_out_tile<bf16, kMode>(smem, qkv, key_mask, x, wout, bout, y, nullptr,
                             L, d, h, scale, off, off, blockIdx.x,
                             blockIdx.y);
}

template <int kMode>
int launch_attn_out(const bf16* qkv, const unsigned char* key_mask,
                    const bf16* x, const float* wout, const float* bout,
                    bf16* y, int batch, int L, int d, int h, float scale,
                    cudaStream_t stream) {
  const size_t smem = attn_out_smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      variant_attn_out_kernel<kMode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  variant_attn_out_kernel<kMode>
      <<<dim3((L + kTile - 1) / kTile, batch), kThreads, smem, stream>>>(
          qkv, key_mask, x, wout, bout, y, L, d, h, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace allrank

// Launches the two kernels of one mode (0 full, 1 no_softmax, 2 exp2,
// 3 norm_after_pv, 4 no_pv, 5 frame) on `stream`; returns 0 or the CUDA
// error code. x, qkv ([B, L, 3d] scratch) and y are bf16, key_mask [B, L]
// bytes non-zero at padded documents, the parameters fp32 in B1's layout.
extern "C" int attention_variant_fwd(const void* x, const void* key_mask,
                                     const void* ln_scale, const void* ln_bias,
                                     const void* wqkv, const void* bqkv,
                                     const void* wout, const void* bout,
                                     void* qkv, void* y, int batch, int L,
                                     int d, int h, float scale, int mode,
                                     void* stream) {
  using bf16 = __nv_bfloat16;
  auto s = static_cast<cudaStream_t>(stream);
  const int M = batch * L;
  const size_t smem1 = allrank::ln_qkv_smem_floats() * sizeof(float);
  const dim3 grid1((M + allrank::kTile - 1) / allrank::kTile,
                   (3 * d + allrank::kTile - 1) / allrank::kTile);
  allrank::variant_ln_qkv_kernel<<<grid1, allrank::kThreads, smem1, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const float*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<bf16*>(qkv), M, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const auto* q = static_cast<const bf16*>(qkv);
  const auto* m = static_cast<const unsigned char*>(key_mask);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* wo = static_cast<const float*>(wout);
  const auto* bo = static_cast<const float*>(bout);
  auto* yb = static_cast<bf16*>(y);
  switch (mode) {
    case allrank::kAttnFull:
      return allrank::launch_attn_out<allrank::kAttnFull>(
          q, m, xb, wo, bo, yb, batch, L, d, h, scale, s);
    case allrank::kAttnNoSoftmax:
      return allrank::launch_attn_out<allrank::kAttnNoSoftmax>(
          q, m, xb, wo, bo, yb, batch, L, d, h, scale, s);
    case allrank::kAttnExp2:
      return allrank::launch_attn_out<allrank::kAttnExp2>(
          q, m, xb, wo, bo, yb, batch, L, d, h, scale, s);
    case allrank::kAttnNormAfterPv:
      return allrank::launch_attn_out<allrank::kAttnNormAfterPv>(
          q, m, xb, wo, bo, yb, batch, L, d, h, scale, s);
    case allrank::kAttnNoPv:
      return allrank::launch_attn_out<allrank::kAttnNoPv>(
          q, m, xb, wo, bo, yb, batch, L, d, h, scale, s);
    case allrank::kAttnFrame:
      return allrank::launch_attn_out<allrank::kAttnFrame>(
          q, m, xb, wo, bo, yb, batch, L, d, h, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
