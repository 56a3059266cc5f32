// X1: the int8 dense layer of the quantized serving tower, for Hopper
// (sm_90a), in one kernel: quantize the activation, multiply on the int8
// tensor cores, dequantize and add the bias,
//   static:  y = (int8(clip(rint(x * s_in[k]), +-127)) @ w_q) * out_scale + b
//   dynamic: y = ((int8(clip(rint(x / xs[m]), +-127)) @ w_q) * xs[m])
//                * w_scale + b
// x [M, K] fp32 or bf16; w_q kept transposed, w_t [N, K] int8; s_in [K] fp32
// (or one value for every k), xs [M] fp32, the scales and b [N] fp32; y
// [M, N] in x's dtype (static) or fp32 (dynamic).
//
// Replaces the TPU kernel `fused_q8_dense` of tools/exp_int8_matmul_kernel.py
// (pallas_call at line 50), the fused form of allrank_tpu/quant.py:93-107;
// the dynamic mode is quant.py:108-116, which the JAX package leaves to XLA.
//
// What bounds it: bytes, at every site of the flagship tower. With
// K, N <= 512 an output row costs 2 K N operations against 4 K + 4 N bytes
// of x and y, some 60 operations a byte, far below the card's int8 ridge
// (1,979 TOP/s over 3.35 TB/s, about 590).
//
// What the design does about it: x is read once from device memory and
// quantized in registers on its way into shared memory, and the int32 sums
// are dequantized in registers on their way out, so neither x_q nor the
// accumulator ever reaches device memory (what X1 exists for); only x, w, the
// [N] vectors and y move. A block computes a 64 x 64 tile of y with four
// warps, each a 32 x 32 tile of mma.sync.m16n8k32 s8 x s8 -> s32 products,
// walking K in 64-wide chunks staged in shared memory (rows padded to 80
// bytes: the fragment loads hit 32 distinct banks). Ragged edges are zeros:
// k >= K and rows m >= M quantize to 0, columns n >= N hold weight 0, and the
// store is masked. int32 sums are exact in any order (|acc| <= 127^2 K <
// 2^31 for K < 133,144), so the result needs no atomics and is the same
// every run. The epilogue converts with __int2float_rn and multiplies and
// adds with __fmul_rn/__fadd_rn, which nvcc may not contract into an FMA:
// quant.py's chain is a rounded multiply then a rounded add, and the
// kernel matches it and its plain version bit for bit. Rounding is rint
// (half to even) as jnp.round and torch.round, never roundf.
// Plain mma.sync tiles without pipelining; wgmma and TMA are later work.
#include "common.cuh"

#include <stdint.h>

namespace allrank {
namespace {

constexpr int kQThreads = 128;  // four warps, 2 x 2 over the block tile
constexpr int kQTile = 64;      // rows and columns of a block's tile of y
constexpr int kQChunk = 64;     // depth of one staged K chunk
constexpr int kQPitch = kQChunk + 16;  // bytes per staged row

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       const uint32_t b[2]) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t quantize(float v) {
  const int q = min(max(__float2int_rn(v), -127), 127);
  return static_cast<uint32_t>(q) & 0xffu;
}

template <class T, class Out>
__global__ void __launch_bounds__(kQThreads)
    q8_dense_kernel(const T* __restrict__ x, const int8_t* __restrict__ w_t,
                    const float* __restrict__ s_in, int s_in_per_channel,
                    const float* __restrict__ xs,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, Out* __restrict__ y, int M,
                    int K, int N) {
  __shared__ __align__(16) uint8_t As[kQTile * kQPitch];
  __shared__ __align__(16) uint8_t Bs[kQTile * kQPitch];
  const int m0 = blockIdx.x * kQTile, n0 = blockIdx.y * kQTile;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int g = lane / 4, t = lane % 4;
  int acc[2][4][4] = {};

  for (int k0 = 0; k0 < K; k0 += kQChunk) {
    // stage: each thread packs four consecutive k of one row into a word
    for (int word = tid; word < kQTile * kQChunk / 4; word += kQThreads) {
      const int r = word / (kQChunk / 4), kq = (word % (kQChunk / 4)) * 4;
      const int m = m0 + r, n = n0 + r;
      uint32_t a = 0, b = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + kq + j;
        if (k >= K) break;
        if (m < M) {
          const float v = to_float(x[(size_t)m * K + k]);
          const float s = xs != nullptr
                              ? __fdiv_rn(v, xs[m])
                              : __fmul_rn(v, s_in[s_in_per_channel ? k : 0]);
          a |= quantize(s) << (8 * j);
        }
        if (n < N)
          b |= (static_cast<uint32_t>(w_t[(size_t)n * K + k]) & 0xffu)
               << (8 * j);
      }
      *reinterpret_cast<uint32_t*>(&As[r * kQPitch + kq]) = a;
      *reinterpret_cast<uint32_t*>(&Bs[r * kQPitch + kq]) = b;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kQChunk; kk += 32) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint8_t* row = &As[(wm + 16 * i + g) * kQPitch + kk + 4 * t];
        af[i][0] = *reinterpret_cast<const uint32_t*>(row);
        af[i][1] = *reinterpret_cast<const uint32_t*>(row + 8 * kQPitch);
        af[i][2] = *reinterpret_cast<const uint32_t*>(row + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(row + 8 * kQPitch + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint8_t* col = &Bs[(wn + 8 * j + g) * kQPitch + kk + 4 * t];
        bf[j][0] = *reinterpret_cast<const uint32_t*>(col);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(col + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }

  // epilogue: c0, c1 at row g, columns 2t, 2t + 1; c2, c3 at row g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + 16 * i + g + 8 * half;
      if (m >= M) continue;
      const float row_scale = xs != nullptr ? xs[m] : 1.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = n0 + wn + 8 * j + 2 * t + c;
          if (n >= N) continue;
          float v = __int2float_rn(acc[i][j][2 * half + c]);
          if (xs != nullptr) v = __fmul_rn(v, row_scale);
          v = __fadd_rn(__fmul_rn(v, scale[n]), bias[n]);
          y[(size_t)m * N + n] = from_float<Out>(v);
        }
      }
    }
  }
}

template <class T, class Out>
int launch(const void* x, const void* w_t, const void* s_in,
           int s_in_per_channel, const void* xs, const void* scale,
           const void* bias, void* y, int M, int K, int N,
           cudaStream_t stream) {
  const dim3 grid((M + kQTile - 1) / kQTile, (N + kQTile - 1) / kQTile);
  q8_dense_kernel<T, Out><<<grid, kQThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w_t),
      static_cast<const float*>(s_in), s_in_per_channel,
      static_cast<const float*>(xs), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<Out*>(y), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace allrank

// Launches X1 on `stream`; returns 0 or the CUDA error code. x is [M, K]
// (bf16 if x_bf16, else fp32), w_t [N, K] int8, scale and bias [N] fp32, y
// [M, N] (bf16 if y_bf16, else fp32). Static mode: xs is null and s_in holds
// K values (s_in_per_channel = 1) or one (0); scale is out_scale. Dynamic
// mode: s_in is null, xs holds each row's scale [M], scale is w_scale, and y
// must be fp32.
extern "C" int q8_dense(const void* x, const void* w_t, const void* s_in,
                        int s_in_per_channel, const void* xs,
                        const void* scale, const void* bias, void* y, int M,
                        int K, int N, int x_bf16, int y_bf16, void* stream) {
  using allrank::launch;
  auto s = static_cast<cudaStream_t>(stream);
  if ((xs == nullptr) == (s_in == nullptr) || (xs != nullptr && y_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (x_bf16 && y_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        x, w_t, s_in, s_in_per_channel, xs, scale, bias, y, M, K, N, s);
  if (x_bf16)
    return launch<__nv_bfloat16, float>(x, w_t, s_in, s_in_per_channel, xs,
                                        scale, bias, y, M, K, N, s);
  if (y_bf16) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float, float>(x, w_t, s_in, s_in_per_channel, xs, scale, bias,
                              y, M, K, N, s);
}
