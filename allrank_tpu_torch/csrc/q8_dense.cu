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
// What the design does about it: every byte moves once. As the TPU kernel holds
// a TM x K tile of x against the whole weight, a block owns 64 rows of x across
// all of N. It reads its x tile from device memory once, in 16-byte vectors
// where the rows allow (8 bf16 or 4 fp32 a thread; a K whose rows are not
// 16-byte multiples, as K = 1 or 33, element by element), quantizes it once in
// registers into shared memory and keeps it there for every column of y: so
// each row of x is read and quantized once a call, whatever N is (a grid over
// tiles of y would re-read and re-quantize it for every tile of columns). The
// weight goes into shared memory by cp.async (16-, 8- or 4-byte copies as K's
// alignment allows, zero filled past N and K) while the x tile is quantized:
// all of it where it fits beside the x tile in the block's 112 KB (at every
// flagship site), else in groups of 64-column multiples with one barrier a
// group. Then the sixteen warps run without a barrier: warp w takes rows
// 16*(w%4).. of the tile and the 32-column pieces 32*(w/4), 32*(w/4) + 128, ...
// of y, as mma.sync.m16n8k32 s8 x s8 -> s32 products; it dequantizes its sums
// in registers, and each quad of threads trades them (quad_gather) so that a
// thread holds 8 neighbouring columns of a row and stores them as whole 16-byte
// pieces (a full 32-byte sector a pair of threads; on an H100 each thread's own
// 4-byte pairs took 22.9 us at ff1, these 18.3), where N allows (a multiple of
// 8 for bf16 y, 4 for fp32), else one element at a time, while the other warps
// compute. Neither x_q nor the accumulator reaches device memory, with one
// exception: a block holds at most 1024 of K (a 66 KB x tile); a wider K splits
// into 1024-wide slabs, each block quantizes its slab of its rows once and adds
// its int32 sums into an [M, N] scratch with integer atomics (exact, so the
// same every run), and a second kernel dequantizes. No layer of the flagship
// has K past 512. int32 sums are exact in any order (|acc| <= 127^2 K < 2^31
// for K < 133,144). The epilogue converts with __int2float_rn and multiplies
// and adds with __fmul_rn/__fadd_rn, which nvcc may not contract into an FMA:
// quant.py's chain is a rounded multiply then a rounded add, and the kernel
// matches it and its plain version bit for bit. Rounding is rint (half to even)
// as jnp.round and torch.round, never roundf.
#include "attention_mma.cuh"
#include "common.cuh"

#include <stdint.h>

namespace allrank {
namespace {

constexpr int kQThreads = 512;  // 16 warps: 4 row groups x 4 quarters
constexpr int kQRows = 64;      // rows of x and y a block owns
constexpr int kQCols = 64;      // the weight staged in 64-column groups
constexpr int kQSlab = 1024;    // K a block holds
// shared memory a block aims at (two blocks an SM): the x tile and as many
// 64-column groups of the weight as fit
constexpr int kQShared = 112 * 1024;

// The staged row of a slab of `width` K values, for x and the weight
// alike: whole 32-byte k steps plus 16 bytes, so that the eight rows of a
// fragment load fall in eight distinct bank quads.
__host__ __device__ __forceinline__ int staged_pitch(int width) {
  return (width + 31) / 32 * 32 + 16;
}

// The weight columns a block stages at once: the most 64-column groups
// that fit beside the x tile, at least one, at most N's.
int weight_columns(int N, int width) {
  const int pitch = staged_pitch(width);
  const int fit = (kQShared - kQRows * pitch) / pitch / kQCols;
  return min(max(fit, 1), (N + kQCols - 1) / kQCols) * kQCols;
}

size_t shared_bytes(int N, int width) {
  return (size_t)(kQRows + weight_columns(N, width)) * staged_pitch(width);
}

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

// x's value at row m, column k, scaled for rounding: times s_in (static)
// or divided by the row's scale (dynamic), each rounded once
__device__ __forceinline__ float scaled(float v, const float* s_in,
                                        int s_in_per_channel, const float* xs,
                                        int m, int k) {
  return xs != nullptr ? __fdiv_rn(v, xs[m])
                       : __fmul_rn(v, s_in[s_in_per_channel ? k : 0]);
}

// quant.py's epilogue on one int32 sum: ((acc [* xs]) * scale + b)
__device__ __forceinline__ float dequantize(int acc, const float* xs, int m,
                                            float scale, float bias) {
  float v = __int2float_rn(acc);
  if (xs != nullptr) v = __fmul_rn(v, xs[m]);
  return __fadd_rn(__fmul_rn(v, scale), bias);
}

// kBytes global -> shared (4, 8 or 16), through L1; full false writes zeros
template <int kBytes>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src,
                                            bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(kBytes), "r"(full ? kBytes : 0)
               : "memory");
}

// Weight rows n0..n0 + rows - 1 of w_t, K values k..k + width - 1 (width
// a multiple of 32) into dst [rows][pitch] by cp.async, zeros past N and
// K; kBytes divides K, so a copy is all inside K or all past it.
template <int kBytes>
__device__ __forceinline__ void stage_w_by(uint8_t* dst, int pitch,
                                           const int8_t* w_t, int N, int K,
                                           int n0, int rows, int k,
                                           int width) {
  const int per_row = width / kBytes;
  for (int c = threadIdx.x; c < rows * per_row; c += kQThreads) {
    const int r = c / per_row, kb = (c % per_row) * kBytes;
    const bool in = n0 + r < N && k + kb < K;
    cp_async_ca<kBytes>(dst + r * pitch + kb,
                        in ? w_t + (size_t)(n0 + r) * K + k + kb : w_t, in);
  }
}

__device__ __forceinline__ void stage_w(uint8_t* dst, int pitch,
                                        const int8_t* w_t, int N, int K,
                                        int n0, int rows, int k, int width,
                                        int w_bytes) {
  switch (w_bytes) {
    case 16:
      stage_w_by<16>(dst, pitch, w_t, N, K, n0, rows, k, width);
      break;
    case 8:
      stage_w_by<8>(dst, pitch, w_t, N, K, n0, rows, k, width);
      break;
    case 4:
      stage_w_by<4>(dst, pitch, w_t, N, K, n0, rows, k, width);
      break;
    default:  // K odd or 2 mod 4: bytes, by plain loads
      for (int c = threadIdx.x; c < rows * width; c += kQThreads) {
        const int r = c / width, kb = c % width;
        const bool in = n0 + r < N && k + kb < K;
        dst[r * pitch + kb] =
            in ? static_cast<uint8_t>(w_t[(size_t)(n0 + r) * K + k + kb]) : 0;
      }
  }
}

// x rows m0..m0 + 63, K values k0..k0 + width - 1, quantized into xq
// [kQRows][pitch]; zeros past M and from width to the pitch's k steps.
// x_vec: every row starts on 16 bytes and width is a multiple of the
// vector (K * sizeof(T) % 16 == 0). A thread loads up to kBatch vectors
// before it quantizes any, so their reads are in flight together.
template <class T>
__device__ __forceinline__ void stage_x(uint8_t* xq, int pitch,
                                        const T* __restrict__ x, int M, int K,
                                        int m0, int k0, int width, int x_vec,
                                        const float* s_in,
                                        int s_in_per_channel,
                                        const float* xs) {
  constexpr int kVec = 16 / sizeof(T), kBatch = 4;
  if (x_vec) {
    const int per_row = width / kVec, total = kQRows * per_row;
    for (int c0 = threadIdx.x; c0 < total; c0 += kBatch * kQThreads) {
      uint4 raw[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int c = c0 + b * kQThreads, m = m0 + c / per_row;
        raw[b] = c < total && m < M
                     ? __ldg(reinterpret_cast<const uint4*>(
                           x + (size_t)m * K + k0 + (c % per_row) * kVec))
                     : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int c = c0 + b * kQThreads;
        if (c >= total) break;
        const int r = c / per_row, kk = (c % per_row) * kVec, m = m0 + r;
        uint32_t words[kVec / 4] = {};
        if (m < M) {
          alignas(16) T v[kVec];
          *reinterpret_cast<uint4*>(v) = raw[b];
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            words[e / 4] |= quantize(scaled(to_float(v[e]), s_in,
                                            s_in_per_channel, xs, m,
                                            k0 + kk + e))
                            << (8 * (e % 4));
        }
        if constexpr (kVec == 8) {
          *reinterpret_cast<uint2*>(xq + r * pitch + kk) =
              make_uint2(words[0], words[1]);
        } else {
          *reinterpret_cast<uint32_t*>(xq + r * pitch + kk) = words[0];
        }
      }
    }
  } else {
    for (int e = threadIdx.x; e < kQRows * width; e += kQThreads) {
      const int r = e / width, kk = e % width, m = m0 + r;
      uint32_t q = 0;
      if (m < M)
        q = quantize(scaled(to_float(x[(size_t)m * K + k0 + kk]), s_in,
                            s_in_per_channel, xs, m, k0 + kk));
      xq[r * pitch + kk] = static_cast<uint8_t>(q);
    }
  }
  const int pad = (width + 31) / 32 * 32 - width;
  for (int e = threadIdx.x; e < kQRows * pad; e += kQThreads)
    xq[(e / pad) * pitch + width + e % pad] = 0;
}

// b[s] = what lane s of this lane's quad holds in a[t], t = lane % 4: a
// 4 x 4 transpose across the quad in three exchanges (register arrays
// indexed only by constants, so they stay in registers)
__device__ __forceinline__ uint32_t pick4(const uint32_t a[4], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

__device__ __forceinline__ void quad_gather(const uint32_t a[4],
                                            uint32_t b[4], int t) {
  uint32_t r[4];
  r[0] = pick4(a, t);
#pragma unroll
  for (int k = 1; k < 4; ++k)
    r[k] = __shfl_xor_sync(0xffffffffu, pick4(a, t ^ k), k);
#pragma unroll
  for (int s = 0; s < 4; ++s) b[s] = pick4(r, s ^ t);
}

// One block: rows m0..m0 + 63 of y against K slab blockIdx.y, the weight
// staged w_cols columns at a time. With one slab (acc == nullptr) it writes
// y; with more it adds its int32 sums into acc [M, N] for
// q8_dequant_kernel. y_vec: a row of y is whole 16-byte pieces (N *
// sizeof(Out) a multiple of 16, y on 16 bytes), which each quad gathers by
// quad_gather so that a thread stores 8 columns of a row at once; else the
// outputs go one by one.
template <class T, class Out>
__global__ void __launch_bounds__(kQThreads, 2)
    q8_dense_kernel(const T* __restrict__ x, const int8_t* __restrict__ w_t,
                    const float* __restrict__ s_in, int s_in_per_channel,
                    const float* __restrict__ xs,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, Out* __restrict__ y,
                    int* __restrict__ acc_out, int M, int K, int N, int w_cols,
                    int x_vec, int w_bytes, int y_vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  uint8_t* xq = smem;  // [kQRows][pitch]
  const int m0 = blockIdx.x * kQRows, k0 = blockIdx.y * kQSlab;
  const int width = min(kQSlab, K - k0), pitch = staged_pitch(width);
  const int kp = (width + 31) / 32 * 32;
  uint8_t* ws = xq + kQRows * pitch;  // [w_cols][pitch]
  // rows 16 * group.. of the block, 32-column pieces quarter, quarter + 4..
  const int group = warp % 4, quarter = warp / 4;
  const int g = lane / 4, t = lane % 4;

  for (int w0 = 0; w0 < N; w0 += w_cols) {
    if (w0 > 0) __syncthreads();  // every warp is done with the last group
    stage_w(ws, pitch, w_t, N, K, w0, w_cols, k0, kp, w_bytes);
    cp_async_commit();
    // the x tile, quantized once, while the weight's copies land
    if (w0 == 0)
      stage_x(xq, pitch, x, M, K, m0, k0, width, x_vec, s_in,
              s_in_per_channel, xs);
    cp_async_wait<0>();
    __syncthreads();
    const int w_end = min(N, w0 + w_cols);
    for (int n0 = w0 + 32 * quarter; n0 < w_end; n0 += 128) {
      int acc[4][4] = {};
      for (int kk = 0; kk < kp; kk += 32) {
        uint32_t af[4], bf[4][2];
        const uint8_t* row = xq + (16 * group + g) * pitch + kk + 4 * t;
        af[0] = *reinterpret_cast<const uint32_t*>(row);
        af[1] = *reinterpret_cast<const uint32_t*>(row + 8 * pitch);
        af[2] = *reinterpret_cast<const uint32_t*>(row + 16);
        af[3] = *reinterpret_cast<const uint32_t*>(row + 8 * pitch + 16);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint8_t* col =
              ws + (n0 - w0 + 8 * j + g) * pitch + kk + 4 * t;
          bf[j][0] = *reinterpret_cast<const uint32_t*>(col);
          bf[j][1] = *reinterpret_cast<const uint32_t*>(col + 16);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[j], af, bf[j]);
      }

      // the sums: c0, c1 at row g, columns 2t, 2t + 1; c2, c3 at row g + 8
      if (y_vec && acc_out == nullptr) {
        float v[4][2][2];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int n = n0 + 8 * j + 2 * t + c;
            const float sc = n < N ? scale[n] : 0.f;
            const float bi = n < N ? bias[n] : 0.f;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int m = m0 + 16 * group + g + 8 * h;
              v[j][h][c] = m < M && n < N
                               ? dequantize(acc[j][2 * h + c], xs, m, sc, bi)
                               : 0.f;
            }
          }
        // thread t of a quad stores columns n0 + 8t .. + 7 of its two rows
        const int n = n0 + 8 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + 16 * group + g + 8 * h;
          Out* at = y + (size_t)m * N + n;
          if constexpr (sizeof(Out) == 2) {
            uint32_t a[4], b[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const __nv_bfloat162 pair =
                  __floats2bfloat162_rn(v[j][h][0], v[j][h][1]);
              a[j] = *reinterpret_cast<const uint32_t*>(&pair);
            }
            quad_gather(a, b, t);
            if (m < M && n < N)
              *reinterpret_cast<uint4*>(at) =
                  make_uint4(b[0], b[1], b[2], b[3]);
          } else {
            uint32_t ax[4], ay[4], bx[4], by[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              ax[j] = __float_as_uint(v[j][h][0]);
              ay[j] = __float_as_uint(v[j][h][1]);
            }
            quad_gather(ax, bx, t);
            quad_gather(ay, by, t);
            if (m < M && n < N)
              *reinterpret_cast<uint4*>(at) =
                  make_uint4(bx[0], by[0], bx[1], by[1]);
            if (m < M && n + 4 < N)
              *reinterpret_cast<uint4*>(at + 4) =
                  make_uint4(bx[2], by[2], bx[3], by[3]);
          }
        }
        continue;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + 8 * j + 2 * t;
        if (n >= N) continue;
        const bool two = n + 1 < N;
        const float s0 = scale[n], b0 = bias[n];
        const float s1 = two ? scale[n + 1] : 0.f, b1 = two ? bias[n + 1] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + 16 * group + g + 8 * h;
          if (m >= M) continue;
          const size_t at = (size_t)m * N + n;
          if (acc_out != nullptr) {
            atomicAdd(acc_out + at, acc[j][2 * h]);
            if (two) atomicAdd(acc_out + at + 1, acc[j][2 * h + 1]);
            continue;
          }
          y[at] = from_float<Out>(dequantize(acc[j][2 * h], xs, m, s0, b0));
          if (two)
            y[at + 1] =
                from_float<Out>(dequantize(acc[j][2 * h + 1], xs, m, s1, b1));
        }
      }
    }
  }
}

// y from the slabs' int32 sums in acc [M, N]
template <class Out>
__global__ void q8_dequant_kernel(const int* __restrict__ acc,
                                  const float* __restrict__ xs,
                                  const float* __restrict__ scale,
                                  const float* __restrict__ bias,
                                  Out* __restrict__ y, int M, int N) {
  const size_t at = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (at >= (size_t)M * N) return;
  const int m = (int)(at / N), n = (int)(at % N);
  y[at] = from_float<Out>(dequantize(acc[at], xs, m, scale[n], bias[n]));
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <class T, class Out>
int launch(const void* x, const void* w_t, const void* s_in,
           int s_in_per_channel, const void* xs, const void* scale,
           const void* bias, void* y, void* acc, int M, int K, int N,
           cudaStream_t stream) {
  const int slabs = (K + kQSlab - 1) / kQSlab;
  if ((slabs > 1) != (acc != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = q8_dense_kernel<T, Out>;
  const int width = min(K, kQSlab), w_cols = weight_columns(N, width);
  const size_t shared = shared_bytes(N, width);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int x_vec = aligned(x, 16) && K * sizeof(T) % 16 == 0;
  const int w_bytes = K % 16 == 0 && aligned(w_t, 16) ? 16
                      : K % 8 == 0 && aligned(w_t, 8) ? 8
                      : K % 4 == 0 && aligned(w_t, 4) ? 4
                                                       : 1;
  const int y_vec = aligned(y, 16) && N * sizeof(Out) % 16 == 0;
  const dim3 grid((M + kQRows - 1) / kQRows, slabs);
  kernel<<<grid, kQThreads, shared, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w_t),
      static_cast<const float*>(s_in), s_in_per_channel,
      static_cast<const float*>(xs), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<Out*>(y),
      static_cast<int*>(acc), M, K, N, w_cols, x_vec, w_bytes, y_vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || slabs == 1) return static_cast<int>(err);
  const size_t n = (size_t)M * N;
  q8_dequant_kernel<Out><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const int*>(acc), static_cast<const float*>(xs),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<Out*>(y), M, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace allrank

// Launches X1 on `stream`; returns 0 or the CUDA error code. x is [M, K]
// (bf16 if x_bf16, else fp32), w_t [N, K] int8, scale and bias [N] fp32, y
// [M, N] (bf16 if y_bf16, else fp32). Static mode: xs is null and s_in holds
// K values (s_in_per_channel = 1) or one (0); scale is out_scale. Dynamic
// mode: s_in is null, xs holds each row's scale [M], scale is w_scale, and y
// must be fp32. acc: null when K <= 1024, else an [M, N] int32 scratch of
// zeros (ops/q8_dense.py's tile_plan says which).
extern "C" int q8_dense(const void* x, const void* w_t, const void* s_in,
                        int s_in_per_channel, const void* xs,
                        const void* scale, const void* bias, void* y,
                        void* acc, int M, int K, int N, int x_bf16,
                        int y_bf16, void* stream) {
  using allrank::launch;
  auto s = static_cast<cudaStream_t>(stream);
  if ((xs == nullptr) == (s_in == nullptr) || (xs != nullptr && y_bf16) ||
      M < 1 || K < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (x_bf16 && y_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        x, w_t, s_in, s_in_per_channel, xs, scale, bias, y, acc, M, K, N, s);
  if (x_bf16)
    return launch<__nv_bfloat16, float>(x, w_t, s_in, s_in_per_channel, xs,
                                        scale, bias, y, acc, M, K, N, s);
  if (y_bf16) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float, float>(x, w_t, s_in, s_in_per_channel, xs, scale, bias,
                              y, acc, M, K, N, s);
}
