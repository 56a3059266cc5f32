// The attention sublayer forward with one stage changed (X3), bf16, on
// Hopper's tensor cores (sm_90a): B1's own tensor-core forward
// (attention_block_mma.cu) with the mode as a template parameter of its
// attention tile.
//
// Replaces the TPU kernel `make_variant` of the JAX package's
// tools/exp_attn_decompose.py:114 (pallas_call at line 126, math in
// _variant_fwd_vmem, lines 54-103) for heads of d_k <= 128, B1's
// tensor-core route; wider heads keep the SIMT kernels of
// attention_variants.cu, B1's SIMT route (ops/attention_variants.py picks
// the route from d and h alone). Each mode is one source,
// attention_variants_mma_<mode>.cu, so that the five build in parallel.
//
// The kernels are B1's two forward bodies (b1_mma_tiles.cuh): LN + QKV
// over 64 x 128 output tiles (b1_ln_qkv_mma_tile), then one block of eight
// warps per (slate, 128 queries) running b1_attn_out_mma_tile<kDk,
// kAligned, kMode>: B4's two passes head by head on mma.sync bf16 -> fp32,
// ctx in shared memory, the out-projection, bout and x. kAttnFull is B1's
// instantiation, so `full` is B1's bf16 forward bit for bit; `exp2` runs
// it too, since B1's exponent is exp2 of pre-scaled scores already
// (b4_exponent), and `frame` needs no head class. What the modes change is
// set out beside b1_attn_out_mma_tile.
//
// What bounds them: B1's bound, operations (3.9 GFLOP at B=64, L=240,
// d=128, h=4: 0.004 ms at 989 TFLOP/s), less the products a mode removes;
// `frame` and `no_pv` by bytes. Every product runs on the tensor cores as
// B1's does; nothing goes to a library.
#pragma once

#include "b1_mma_tiles.cuh"

namespace allrank {
namespace {

__global__ void __launch_bounds__(kGemmThreads)
    variant_ln_qkv_mma_kernel(const bf16* __restrict__ x,
                              const float* __restrict__ ln_scale,
                              const float* __restrict__ ln_bias,
                              const float* __restrict__ wqkv,
                              const float* __restrict__ bqkv,
                              bf16* __restrict__ qkv, int M, int d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  b1_ln_qkv_mma_tile(smem_raw, x, ln_scale, ln_bias, wqkv, bqkv, qkv, M, d,
                     blockIdx.x, blockIdx.y);
}

template <int kDk, bool kAligned, int kMode>
__global__ void __launch_bounds__(32 * kOutWarps)
    variant_attn_out_mma_kernel(const bf16* __restrict__ qkv,
                                const unsigned char* __restrict__ key_mask,
                                const bf16* __restrict__ x,
                                const float* __restrict__ wout,
                                const float* __restrict__ bout,
                                bf16* __restrict__ y, int L, int d, int h,
                                float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const DropStream off{0u, 0u, 0u, 0, 1.f, 1.f};
  b1_attn_out_mma_tile<kDk, kAligned, kMode>(
      smem_raw, qkv, key_mask, x, wout, bout, y, nullptr, L, d, h, scale, off,
      off, blockIdx.x, blockIdx.y);
}

// B1's forward launches (attention_block_mma.cu's launch_fwd) at dropout 0
// with kMode's attention tile, for MMA_DK_DISPATCH.
template <int kMode>
struct Variant {
  template <int kDk, bool kAligned>
  static cudaError_t launch(const void* x, const void* key_mask,
                            const void* ln_scale, const void* ln_bias,
                            const void* wqkv, const void* bqkv,
                            const void* wout, const void* bout, void* qkv,
                            void* y, int batch, int L, int d, int h,
                            float scale, cudaStream_t stream) {
    constexpr int kRows = 16 * kOutWarps;
    const int M = batch * L, dpad = round16(d);
    const size_t smem1 = (size_t)(kGemmRows * tile_pitch(d) +
                                  dpad * tile_pitch(kGemmCols)) *
                             sizeof(bf16) +
                         2 * kTile * sizeof(float);
    cudaError_t err = allow_smem(variant_ln_qkv_mma_kernel, smem1);
    if (err != cudaSuccess) return err;
    variant_ln_qkv_mma_kernel<<<dim3((M + kGemmRows - 1) / kGemmRows,
                                     (3 * d + kGemmCols - 1) / kGemmCols),
                                kGemmThreads, smem1, stream>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(ln_scale),
        static_cast<const float*>(ln_bias), static_cast<const float*>(wqkv),
        static_cast<const float*>(bqkv), static_cast<bf16*>(qkv), M, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;

    auto kernel = variant_attn_out_mma_kernel<kDk, kAligned, kMode>;
    const size_t attn = mma_smem(d / h, kRows + 2 * kStages * kKeyTile,
                                 4 * kStages * sizeof(uint32_t));
    const size_t w_slice =
        (size_t)dpad * tile_pitch(kOutCols) * sizeof(bf16);
    const size_t smem2 = (size_t)kRows * tile_pitch(d) * sizeof(bf16) +
                         (attn > w_slice ? attn : w_slice);
    if ((err = allow_smem(kernel, smem2)) != cudaSuccess) return err;
    kernel<<<dim3((L + kRows - 1) / kRows, batch), 32 * kOutWarps, smem2,
             stream>>>(
        static_cast<const bf16*>(qkv),
        static_cast<const unsigned char*>(key_mask),
        static_cast<const bf16*>(x), static_cast<const float*>(wout),
        static_cast<const float*>(bout), static_cast<bf16*>(y), L, d, h,
        scale);
    return cudaGetLastError();
  }
};

// The two kernels of kMode for d_k's padded class (32, 64 or 128) and
// whether qkv's head rows start on 16-byte boundaries; `frame` reads no
// head tile and has one instantiation.
template <int kMode>
int variant_fwd(const void* x, const void* key_mask, const void* ln_scale,
                const void* ln_bias, const void* wqkv, const void* bqkv,
                const void* wout, const void* bout, void* qkv, void* y,
                int batch, int L, int d, int h, float scale, void* stream) {
  const int dk = d / h;
  if (dk > 128) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if constexpr (kMode == kAttnFrame)
    return Variant<kMode>::template launch<32, false>(
        x, key_mask, ln_scale, ln_bias, wqkv, bqkv, wout, bout, qkv, y,
        batch, L, d, h, scale, s);
  else
    MMA_DK_DISPATCH(Variant<kMode>::template launch, dk,
                    rows_aligned(dk, {qkv}), x, key_mask, ln_scale, ln_bias,
                    wqkv, bqkv, wout, bout, qkv, y, batch, L, d, h, scale,
                    s);
}

}  // namespace
}  // namespace allrank

// Each source defines the entry point of its mode with this signature:
// launches LN + QKV, then the mode's attention tile + out-projection +
// residual, on `stream`; returns 0 or the CUDA error code. x, qkv ([B, L,
// 3d] scratch) and y are bf16, d_k = d / h <= 128, key_mask [B, L] bytes
// non-zero at padded documents, the parameters fp32 in B1's layout.
#define ALLRANK_VARIANT_ENTRY(mode)                                          \
  extern "C" int attention_variant_fwd_mma(                                  \
      const void* x, const void* key_mask, const void* ln_scale,             \
      const void* ln_bias, const void* wqkv, const void* bqkv,               \
      const void* wout, const void* bout, void* qkv, void* y, int batch,     \
      int L, int d, int h, float scale, void* stream) {                      \
    return allrank::variant_fwd<mode>(x, key_mask, ln_scale, ln_bias, wqkv,  \
                                      bqkv, wout, bout, qkv, y, batch, L, d, \
                                      h, scale, stream);                     \
  }
