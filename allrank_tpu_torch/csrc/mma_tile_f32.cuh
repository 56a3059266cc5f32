// The fp32 product tile of the sublayer kernels on Hopper's tensor cores,
// B1's attention_block_tf32x3.cu and B2's ffn_block_tf32x3.cu: the
// counterpart of mma_tile.cuh's bf16 pieces, with every fp32 product a
// 3xTF32 split product on mma.sync.m16n8k8 (attention_tf32x3.cuh's
// split_tf32 and mma_3xtf32: lo_a hi_b + hi_a lo_b + hi_a hi_b, small terms
// first, some 2^-21 of |a b|, inside fp32's tolerance). Operands are split
// as they are read from shared memory: weights need no rounding launch.
//
// A warp sums acc += A . B for its 16 rows and 8 kN columns. The tensor
// cores truncate their fp32 sums, so each 64-deep group of k8 steps sums
// from zero and joins acc in fp32 (f32_product's kGroup).
//
// Fragments of mma.m16n8k8 .tf32 (g = lane / 4, t = lane % 4): A a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B b0 (k t, n g), b1
// (k t + 4, n g); C c0, c1 (g, 2t..2t+1), c2, c3 (g + 8, 2t..2t+1). Where an
// operand lies in shared memory as rows of its k (A [row][k], or B stored
// transposed [n][k]) ldmatrix reads it as pairs of b16 (the fp32 element),
// from a pitch of 4 mod 8 floats (an odd number of 16-byte units: eight
// rows in eight bank quads). Where it lies with k down the rows (B [k][n],
// or A^T [k][row] of a weight gradient) ldmatrix .trans cannot help (it
// moves 16-bit elements), so each thread reads its four elements with
// 32-bit loads, from a pitch of 8 or 24 mod 32 floats (the rows t and columns
// g of one load fall in 32 distinct banks): f32_kn_pitch.
//
// A C tile does not match the A layout, so products whose A comes from
// registers (B2's hidden chunk) permute the k slots as attention_tf32x3.cuh
// does for P: slot t is column 2t, slot t + 4 column 2t + 1, and the B rows
// are read in that order (f32_regs_product).
#pragma once

#include "attention_tf32x3.cuh"
#include "backward.cuh"
#include "common.cuh"

namespace allrank {

// the k8 steps a group of f32_product sums from zero (64 deep)
constexpr int kF32Group = 8;

__host__ __device__ __forceinline__ int round8(int n) {
  return (n + 7) / 8 * 8;
}

// C tiles of 8 columns, an even number, that cover `cols` columns
__host__ __device__ __forceinline__ int c_tiles_f32(int cols) {
  return cols > 0 ? (cols + 15) / 16 * 2 : 0;
}

// pitch of a tile read by ldmatrix (rows of its k), for `cols` columns:
// whole 16-column steps plus 4 floats, 4 mod 16 (so also 4 mod 8, and the
// permuted rows 2t, 2t + 1 of f32_regs_product fall in distinct banks)
__host__ __device__ __forceinline__ int f32_row_pitch(int cols) {
  return (cols + 15) / 16 * 16 + 4;
}

// pitch of a tile read element by element with k down its rows: whole
// 16-column steps plus 8 floats, 8 or 24 mod 32
__host__ __device__ __forceinline__ int f32_kn_pitch(int cols) {
  return (cols + 15) / 16 * 16 + 8;
}

__device__ __forceinline__ void split4(uint32_t hi[4], uint32_t lo[4],
                                       const float a[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Tf32Pair s = split_tf32(a[i]);
    hi[i] = s.hi;
    lo[i] = s.lo;
  }
}

// The A fragment (hi, lo) of k8 step kc: kAT false, As [row][lda] at the
// warp's first row (ldmatrix); kAT true, As stored [k][lda] at the warp's
// first row's column (32-bit loads).
template <bool kAT>
__device__ __forceinline__ void f32_a_frag(uint32_t ah[4], uint32_t al[4],
                                           const float* As, int lda, int kc) {
  const int lane = threadIdx.x % 32;
  float a[4];
  if constexpr (kAT) {
    const float* p = As + (kc * 8 + lane % 4) * lda + lane / 4;
    a[0] = p[0];
    a[1] = p[8];
    a[2] = p[4 * lda];
    a[3] = p[4 * lda + 8];
  } else {
    uint32_t r[4];
    ldmatrix_x4(r, As + (lane % 16) * lda + kc * 8 + (lane / 16) * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = __uint_as_float(r[i]);
  }
  split4(ah, al, a);
}

// acc[n] (C tiles n < n_tiles, n_tiles even and at most kN) += A . B over
// nk k8 steps, each group of kF32Group steps summed from zero first. A is
// [row][lda] at the warp's first row (ldmatrix);
//   B: kBT false [k][ldb] at the first column (32-bit loads, f32_kn_pitch);
//      kBT true stored transposed [n][ldb] at the first column's row
//      (ldmatrix; x . W^T for a weight W read along its rows).
template <int kN, bool kBT>
__device__ __forceinline__ void f32_product(float (*acc)[4], const float* As,
                                            int lda, const float* Bs,
                                            int ldb, int nk, int n_tiles) {
  const int lane = threadIdx.x % 32;
  for (int k0 = 0; k0 < nk; k0 += kF32Group) {
    float t[kN][4] = {};
    const int k_end = min(nk, k0 + kF32Group);
    for (int kc = k0; kc < k_end; ++kc) {
      uint32_t ah[4], al[4];
      f32_a_frag<false>(ah, al, As, lda, kc);
#pragma unroll
      for (int n = 0; n < kN; n += 2) {
        if (n >= n_tiles) break;
        float b[4];
        if constexpr (kBT) {
          uint32_t r[4];
          ldmatrix_x4(r, Bs + (8 * n + lane % 8 + (lane / 16) * 8) * ldb +
                             kc * 8 + ((lane / 8) % 2) * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) b[i] = __uint_as_float(r[i]);
        } else {
          const float* p = Bs + (kc * 8 + lane % 4) * ldb + 8 * n + lane / 4;
          b[0] = p[0];
          b[1] = p[4 * ldb];
          b[2] = p[8];
          b[3] = p[4 * ldb + 8];
        }
        mma_3xtf32<true>(t[n], ah, al, split_tf32(b[0]), split_tf32(b[1]));
        mma_3xtf32<true>(t[n + 1], ah, al, split_tf32(b[2]),
                         split_tf32(b[3]));
      }
    }
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += t[n][e];
  }
}

// acc[n] (C tiles n < n_tiles, even, at most kN) += H . B with H the warp's
// 16 x 8 kSteps tile as fp32 C tiles h[kSteps] (B2's hidden chunk), each k
// step's columns permuted into the A fragment: slot t is column 2t, slot
// t + 4 column 2t + 1. Summed from zero, then added to acc in fp32.
//   kBT false: B [k][ldb] at the first column, rows 2t and 2t + 1 of each
//              step read (f32_row_pitch);
//   kBT true:  B stored transposed [n][ldb] at the first column's row, the
//              pair (2t, 2t + 1) one 64-bit load (f32_kn_pitch).
template <int kN, int kSteps, bool kBT>
__device__ __forceinline__ void f32_regs_product(float (*acc)[4],
                                                 const float (*h)[4],
                                                 const float* Bs, int ldb,
                                                 int n_tiles) {
  const int lane = threadIdx.x % 32, g = lane / 4, t2 = 2 * (lane % 4);
  float t[kN][4] = {};
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    uint32_t ah[4], al[4];
    const float a[4] = {h[j][0], h[j][2], h[j][1], h[j][3]};
    split4(ah, al, a);
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      if (n >= n_tiles) break;
      float b0, b1;
      if constexpr (kBT) {
        const float2 v = *reinterpret_cast<const float2*>(
            Bs + (8 * n + g) * ldb + 8 * j + t2);
        b0 = v.x;
        b1 = v.y;
      } else {
        const float* p = Bs + (8 * j + t2) * ldb + 8 * n + g;
        b0 = p[0];
        b1 = p[ldb];
      }
      mma_3xtf32<true>(t[n], ah, al, split_tf32(b0), split_tf32(b1));
    }
  }
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += t[n][e];
}

// Stages S[r][c] = src[(r0 + r) * ld + c0 + c] for r < nr, c < nc (nc a
// multiple of 4), zero at rows r0 + r >= rows_in or columns c0 + c >=
// cols_in, with a block of kThreads threads. With `vec` (ld and c0
// multiples of 4 and src 16-byte aligned) four columns a 16-byte cp.async
// where they lie inside, which lands after the caller's cp_async_wait and
// barrier; otherwise element by element.
template <int kThreads>
__device__ __forceinline__ void stage_f32(float* S, int pitch,
                                          const float* __restrict__ src,
                                          size_t ld, int r0, int nr,
                                          int rows_in, int c0, int nc,
                                          int cols_in, bool vec) {
  const int groups = nc / 4;
  for (int e = threadIdx.x; e < nr * groups; e += kThreads) {
    const int r = e / groups, c = (e % groups) * 4;
    const int row = r0 + r, col = c0 + c;
    float* dst = S + r * pitch + c;
    const float* from = src + (size_t)row * ld + col;
    if (vec && (row >= rows_in || col >= cols_in)) {
      cp_async_16(dst, src, 0);
    } else if (vec && col + 3 < cols_in) {
      cp_async_16(dst, from, 16);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dst[i] = row < rows_in && col + i < cols_in ? from[i] : 0.f;
    }
  }
}

// Mean and 1 / (unbiased std + eps) of rows [0, rows) of x (pitch d), one
// warp a row, kWarps warps; rows past `rows` up to kRows get zeros.
template <int kRows, int kWarps>
__device__ __forceinline__ void f32_ln_stats(const float* x, int rows, int d,
                                             float* mean, float* rdenom) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kWarps) {
    float mu = 0.f, rd = 0.f;
    if (r < rows) {
      float var;
      row_moments(x + (size_t)r * d, d, mu, var);
      rd = 1.f / (sqrtf(fmaxf(var, kVarFloor)) + kLnEps);
    }
    if (lane == 0) {
      mean[r] = mu;
      rdenom[r] = rd;
    }
  }
}

// S [kRows][pitch] = LN(x) of the block's rows (pitch d in x), zero past
// `rows` and in the columns d..dpad, from the rows' statistics.
template <int kRows, int kThreads>
__device__ __forceinline__ void f32_stage_ln(float* S, int pitch,
                                             const float* __restrict__ x,
                                             int rows, int d, int dpad,
                                             const float* __restrict__ g,
                                             const float* __restrict__ b,
                                             const float* mean,
                                             const float* rdenom) {
  for (int e = threadIdx.x; e < kRows * dpad; e += kThreads) {
    const int r = e / dpad, k = e % dpad;
    S[r * pitch + k] =
        r < rows && k < d
            ? (x[(size_t)r * d + k] - mean[r]) * rdenom[r] * g[k] + b[k]
            : 0.f;
  }
}

// acc[r][n] (r < 2, C tiles n < n_tiles, even, at most 4) += A^T . B over
// one 64-row step, summed from zero first: A stored [m][lda] at the warp's
// first row of C (two 16-row tiles of C, 16 columns apart), B [m][ldb] at
// its first column, both read with 32-bit loads (f32_kn_pitch). A warp of
// two row tiles reads and splits each B element once for both (and each A
// element once for four C tiles): 2.7 loads and split instructions an
// HMMA, where one row tile of eight C tiles takes 4.7.
__device__ __forceinline__ void f32_atb_step(float (*acc)[4][4],
                                             const float* As, int lda,
                                             const float* Bs, int ldb,
                                             int n_tiles) {
  const int lane = threadIdx.x % 32;
  float t[2][4][4] = {};
#pragma unroll 2
  for (int kc = 0; kc < kF32Group; ++kc) {
    uint32_t ah[2][4], al[2][4];
    f32_a_frag<true>(ah[0], al[0], As, lda, kc);
    f32_a_frag<true>(ah[1], al[1], As + 16, lda, kc);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      if (n >= n_tiles) break;
      const float* p = Bs + (kc * 8 + lane % 4) * ldb + 8 * n + lane / 4;
      const Tf32Pair b0 = split_tf32(p[0]), b1 = split_tf32(p[4 * ldb]);
      mma_3xtf32<true>(t[0][n], ah[0], al[0], b0, b1);
      mma_3xtf32<true>(t[1][n], ah[1], al[1], b0, b1);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][n][e] += t[r][n][e];
}

// Split `split` of C = A^T . B and colsum(B) for A [M, lda] (K columns
// used) and B [M, ldb] (N used) fp32, output tile (k_tile, n_tile) of 64 x
// 16 kWarps, by kWarps warps as 2 x kWarps / 2 of 32 rows by 32 columns of
// C: part[split] holds C's partial [K, N] and then colsum's [N] over rows
// [split * rows_per_split, (split + 1) * rows_per_split), 64 rows a step
// through a two-slot cp.async ring (each step's product summed from zero,
// f32_atb_step); only the first row of tiles adds the column sums, in fp32.
// Four warps (the chained kernels' block) take a 64 x 64 tile, eight (a
// whole-encoder block) 64 x 128. `smem` holds f32_atb_smem(kWarps) bytes
// (dynamic: above the 48 KB of a static array).
constexpr int kF32AtbThreads = 128, kF32AtbRows = 64;
constexpr int kF32AtbPitch = 64 + 8;  // f32_kn_pitch(64)
__host__ __device__ constexpr size_t f32_atb_smem(int warps) {
  return 2 * (kF32AtbRows * kF32AtbPitch + kF32AtbRows * (16 * warps + 8)) *
         sizeof(float);
}
constexpr size_t kF32AtbSmem = f32_atb_smem(4);

template <int kWarps = 4>
__device__ __forceinline__ void f32_atb_tile(float* smem,
                                             const float* A,
                                             int lda,
                                             const float* Bm,
                                             int ldb, float* part,
                                             int M, int K, int N,
                                             int rows_per_split, bool vec,
                                             unsigned k_tile, unsigned n_tile,
                                             unsigned split_index) {
  constexpr int kThreads = 32 * kWarps, kCols = 16 * kWarps;
  constexpr int kPitch = kF32AtbPitch, kPitchB = kCols + 8;
  constexpr int kTileF = kF32AtbRows * kPitch;
  constexpr int kSlot = kTileF + kF32AtbRows * kPitchB;
  const int k0 = k_tile * kTile, n0 = n_tile * kCols;
  const int split = split_index;
  const int m_begin = split * rows_per_split;
  const int m_end = min(M, m_begin + rows_per_split);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wk = 32 * (warp % 2), wn = 32 * (warp / 2);
  const bool col_sums = k_tile == 0;
  const int nt = c_tiles_f32(min(32, N - n0 - wn));
  auto stage = [&](int m, int s) {
    float* As = smem + s * kSlot;
    stage_f32<kThreads>(As, kPitch, A, lda, m, kF32AtbRows, m_end, k0, kTile,
                        K, vec);
    stage_f32<kThreads>(As + kTileF, kPitchB, Bm, ldb, m, kF32AtbRows, m_end,
                        n0, kCols, N, vec);
  };
  float acc[2][4][4] = {};
  float csum = 0.f;
  if (m_begin < m_end) stage(m_begin, 0);
  cp_async_commit();
  for (int m = m_begin, s = 0; m < m_end; m += kF32AtbRows, s ^= 1) {
    if (m + kF32AtbRows < m_end) stage(m + kF32AtbRows, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* As = smem + s * kSlot;
    const float* Bs = As + kTileF;
    f32_atb_step(acc, As + wk, kPitch, Bs + wn, kPitchB, nt);
    if (col_sums && threadIdx.x < kCols)
      for (int mm = 0; mm < kF32AtbRows; ++mm)
        csum += Bs[mm * kPitchB + threadIdx.x];
    __syncthreads();  // the slot is read before it is staged again
  }
  float* out = part + (size_t)split * ((size_t)K * N + N);
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = k0 + wk + 16 * r + lane / 4 + 8 * (e >> 1);
        const int col = n0 + wn + 8 * n + 2 * (lane % 4) + (e & 1);
        if (n < nt && i < K && col < N)
          out[(size_t)i * N + col] = acc[r][n][e];
      }
  if (col_sums && threadIdx.x < kCols && n0 + threadIdx.x < N)
    out[(size_t)K * N + n0 + threadIdx.x] = csum;
}

// true when every pointer is 16-byte aligned (cp.async's rule)
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// dW = A^T . B [K, N] and db = colsum(B) [N] for A [M, K] and B [M, N]
// through `splits` partial sums in `part` ([splits, K * N + N] fp32
// scratch), reduced in split order; `kernel` is a source's __global__
// wrapper of f32_atb_tile.
template <class Kernel>
cudaError_t f32_weight_grad(Kernel kernel, const float* A, const float* B,
                            float* part, float* dw, float* db, int M, int K,
                            int N, int splits, cudaStream_t stream) {
  const bool vec = K % 4 == 0 && N % 4 == 0 && aligned16({A, B});
  const dim3 grid((K + kTile - 1) / kTile, (N + kTile - 1) / kTile, splits);
  cudaError_t err = allow_smem(kernel, kF32AtbSmem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kF32AtbThreads, kF32AtbSmem, stream>>>(
      A, B, part, M, K, N, split_rows(M, splits), vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_reduce(part, splits, dw, K * N, db, N, stream);
}

}  // namespace allrank
