// The two synthetic kernels of the boundary-shift probe for Hopper
// (sm_90a), bf16 activations and weights, fp32 accumulation:
//   plain:   y = x + relu(LN(x) . W1) . W2
//   shifted: out = x + relu(pre) . W2,  pre_out = LN(out) . W1'
// with the unbiased-std LayerNorm without gain or bias,
// LN(v) = (v - mean) / (sqrt(max(var, 1e-24)) + 1e-6), rounded to bf16
// before its product, as is the ReLU output; the residual is added in fp32
// and the shifted kernel normalises that fp32 sum, not its bf16 copy.
//
// Replaces the TPU kernel `make_calls` of the JAX package's
// tools/exp_boundary_shift.py:87 (pallas_calls at lines 95 and 102, math in
// _plain_kernel and _shift_kernel, lines 66-84). The probe chains N of them
// with distinct weights and asks whether a kernel boundary that ends in a
// fresh product for the next kernel (shifted) costs less than one that
// ends in a bare residual (plain).
//
// What bounds them, at the probe's shape (M = B L = 15,360 rows, d = 128,
// d3 = 384): each does two products of 2 M d d3 = 1.51 GFLOP, 3.05 us at
// the card's bf16 tensor-core rate; plain moves x and y (and the weights),
// 8.06 MB, 2.41 us at 3.35 TB/s, so it is bound by operations; shifted
// also reads pre and writes pre_out [M, d3], 31.7 MB, 9.45 us, so it is
// bound by bytes.
//
// Design: one block of 256 threads per 64 rows, B2's forward structure
// (sublayer_tiles.cuh, ffn_fwd_tile). The block keeps its 64 rows of LN(x)
// (or, shifted, of the fp32 residual sum and then its LN) in shared memory
// and walks d3 in chunks of 64 columns: the [64, 64] hidden chunk goes to
// shared memory and the [64, d] output stays in registers, so the hidden
// state never reaches device memory; the weights stream through shared
// memory in 32 x 64 chunks from L2. Products are fp32 FMAs on the SIMT
// units over bf16 values (common.cuh's mma_tile), exact products summed in
// fp32; tensor cores are later work.
#include "common.cuh"

namespace allrank {
namespace {

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int boundary_smem_floats(int d) {
  return kTile * (d + 1) + kTile * kLdB + kChunk * kLdB;
}

// Rows [0, rows) of Ns (pitch ldn, fp32) replaced by their LayerNorm,
// rounded to bf16; one warp per row.
__device__ void ln_rows_inplace(float* Ns, int ldn, int rows, int d) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kThreads / 32) {
    float* row = Ns + r * ldn;
    float mu, var;
    row_moments(row, d, mu, var);  // every lane has read the row
    const float denom = sqrtf(fmaxf(var, kVarFloor)) + kLnEps;
    for (int k = lane; k < d; k += 32)
      row[k] = round_to<bf16>((row[k] - mu) / denom);
  }
}

// acc = Ns[:, 0:d] . W[:, f0:f0 + 64] for W [d, d3] bf16 (columns past d3
// read as 0).
__device__ void ln_product(float acc[4][4], const float* Ns, int ldn,
                           const bf16* __restrict__ w, int d, int d3, int f0,
                           float* Bs) {
  for (int k0 = 0; k0 < d; k0 += kChunk) {
    const int depth = min(kChunk, d - k0);
    for (int e = threadIdx.x; e < kChunk * kTile; e += kThreads) {
      const int kk = e / kTile, n = e % kTile;
      Bs[kk * kLdB + n] = (kk < depth && f0 + n < d3)
                              ? to_float(w[(size_t)(k0 + kk) * d3 + f0 + n])
                              : 0.f;
    }
    __syncthreads();
    mma_tile(acc, Ns + k0, ldn, Bs, kLdB, depth);
    __syncthreads();
  }
}

template <bool kShift>
__global__ void __launch_bounds__(kThreads)
    boundary_kernel(const bf16* __restrict__ x, const bf16* __restrict__ pre,
                    const bf16* __restrict__ w1, const bf16* __restrict__ w2,
                    bf16* __restrict__ y, bf16* __restrict__ pre_out, int M,
                    int d, int d3) {
  extern __shared__ float smem[];
  const int ldn = d + 1;
  float* Ns = smem;               // [kTile][d + 1] LN rows or residual sums
  float* Hs = Ns + kTile * ldn;   // [kTile][kLdB]  hidden chunk
  float* Bs = Hs + kTile * kLdB;  // [kChunk][kLdB] weight chunk
  const int m0 = blockIdx.x * kTile;
  const int rows = min(kTile, M - m0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const bf16* xt = x + (size_t)m0 * d;

  if constexpr (!kShift) {
    for (int e = tid; e < kTile * d; e += kThreads) {
      const int r = e / d, k = e % d;
      Ns[r * ldn + k] = r < rows ? to_float(xt[(size_t)r * d + k]) : 0.f;
    }
    __syncthreads();
    ln_rows_inplace(Ns, ldn, rows, d);
    __syncthreads();
  }

  float out[4][4][4] = {};  // [64-column tile of d][i][j]
  for (int f0 = 0; f0 < d3; f0 += kTile) {
    if constexpr (kShift) {
      for (int e = tid; e < kTile * kTile; e += kThreads) {
        const int r = e / kTile, c = e % kTile, f = f0 + c;
        Hs[r * kLdB + c] =
            (r < rows && f < d3)
                ? fmaxf(to_float(pre[(size_t)(m0 + r) * d3 + f]), 0.f)
                : 0.f;
      }
    } else {
      float hacc[4][4] = {};
      ln_product(hacc, Ns, ldn, w1, d, d3, f0, Bs);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Hs[(ty + 16 * i) * kLdB + tx + 16 * j] =
              round_to<bf16>(fmaxf(hacc[i][j], 0.f));
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
                (f < d3 && c < d) ? to_float(w2[(size_t)f * d + c]) : 0.f;
          }
          __syncthreads();
          mma_tile(out[t], Hs + kk0, kLdB, Bs, kLdB, kChunk);
          __syncthreads();
        }
      }
    }
  }

  bf16* yt = y + (size_t)m0 * d;
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, n = t * kTile + tx + 16 * j;
        if (n < d) {
          float o = 0.f;
          if (r < rows) {
            o = to_float(xt[(size_t)r * d + n]) + out[t][i][j];
            yt[(size_t)r * d + n] = from_float<bf16>(o);
          }
          if constexpr (kShift) Ns[r * ldn + n] = o;
        }
      }
  if constexpr (kShift) {
    // the boundary-shifted tail: the next kernel's LN and first product
    __syncthreads();
    ln_rows_inplace(Ns, ldn, rows, d);
    __syncthreads();
    for (int f0 = 0; f0 < d3; f0 += kTile) {
      float pacc[4][4] = {};
      ln_product(pacc, Ns, ldn, w1, d, d3, f0, Bs);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, f = f0 + tx + 16 * j;
          if (r < rows && f < d3)
            pre_out[(size_t)(m0 + r) * d3 + f] = from_float<bf16>(pacc[i][j]);
        }
    }
  }
}

template <bool kShift>
int launch(const void* x, const void* pre, const void* w1, const void* w2,
           void* y, void* pre_out, int M, int d, int d3,
           cudaStream_t stream) {
  const int bytes = boundary_smem_floats(d) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      boundary_kernel<kShift>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  boundary_kernel<kShift><<<(M + kTile - 1) / kTile, kThreads, bytes,
                            stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(pre),
      static_cast<const bf16*>(w1), static_cast<const bf16*>(w2),
      static_cast<bf16*>(y), static_cast<bf16*>(pre_out), M, d, d3);
  return cudaGetLastError();
}

}  // namespace
}  // namespace allrank

// One kernel on `stream`, every tensor bf16 and contiguous: x [M, d],
// w1 [d, d3] (shifted: the next kernel's W1'), w2 [d3, d], y [M, d]; the
// shifted kernel (shifted = 1) also reads pre [M, d3] and writes pre_out
// [M, d3] (both null for the plain kernel). d <= 256. Returns 0 or the CUDA
// error code.
extern "C" int boundary_fwd(const void* x, const void* pre, const void* w1,
                            const void* w2, void* y, void* pre_out, int M,
                            int d, int d3, int shifted, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (shifted)
    return allrank::launch<true>(x, pre, w1, w2, y, pre_out, M, d, d3, s);
  return allrank::launch<false>(x, pre, w1, w2, y, pre_out, M, d, d3, s);
}
