// The bf16 product tile of the sublayer kernels on Hopper's tensor cores
// (B1's attention_block_mma.cu; B2 next): a warp sums acc += A . B for its
// 16 rows and 8 kN columns over operands staged in shared memory, with
// mma.sync.m16n8k16 bf16 x bf16 -> fp32 (attention_mma.cuh). Either operand
// may be stored transposed, so that weights are read along their rows and a
// weight gradient A^T . B sums over the rows both operands share; ldmatrix
// (.trans where needed) forms the fragments. Beside it: the staging of
// bf16 activation tiles (16-byte cp.async where rows are aligned), of
// weight tiles rounded from fp32 to bf16 as they are loaded (the TPU
// kernels cast their weights to x's dtype), and the store of a warp's
// accumulator rows.
//
// Staged tiles are [rows][pitch] bf16, pitch = tile_pitch(cols): whole
// 16-column steps plus 8, an odd number of 16-byte units, so the eight row
// addresses of one ldmatrix 8 x 8 matrix fall in eight distinct bank quads.
#pragma once

#include "attention_mma.cuh"
#include "common.cuh"

namespace allrank {

using bf16 = __nv_bfloat16;

__host__ __device__ __forceinline__ int round16(int n) {
  return (n + 15) / 16 * 16;
}

__host__ __device__ __forceinline__ int tile_pitch(int cols) {
  return round16(cols) + 8;
}

// acc[n] (C tiles n < n_tiles, n_tiles even and at most kN) += A . B over
// nk 16-deep steps: the warp's 16 rows of A by 8 n_tiles columns of B.
//   A: kAT false, row-major [row][lda], As at the warp's first row;
//      kAT true, stored transposed [k][lda], As at the warp's first row's
//      column (A^T . B for a weight gradient over shared rows k).
//   B: kBT false, [k][ldb], Bs at the first column;
//      kBT true, stored transposed [n][ldb], Bs at the first column's row
//      (x . W^T for a weight W read along its rows).
template <int kN, bool kAT, bool kBT>
__device__ __forceinline__ void warp_product(float (*acc)[4], const bf16* As,
                                             int lda, const bf16* Bs,
                                             int ldb, int nk, int n_tiles) {
  const int lane = threadIdx.x % 32;
  for (int kc = 0; kc < nk; ++kc) {
    uint32_t af[4];
    if constexpr (kAT)
      ldmatrix_x4_trans(af, As + (kc * 16 + lane % 8 + (lane / 16) * 8) * lda +
                                ((lane / 8) % 2) * 8);
    else
      ldmatrix_x4(af, As + (lane % 16) * lda + kc * 16 + (lane / 16) * 8);
#pragma unroll
    for (int n = 0; n < kN; n += 2) {
      if (n >= n_tiles) break;
      uint32_t b[4];
      if constexpr (kBT)
        ldmatrix_x4(b, Bs + (8 * n + lane % 8 + (lane / 16) * 8) * ldb +
                           kc * 16 + ((lane / 8) % 2) * 8);
      else
        ldmatrix_x4_trans(b, Bs + (kc * 16 + lane % 8 + ((lane / 8) % 2) * 8) *
                                      ldb + 8 * n + (lane / 16) * 8);
      mma_bf16(acc[n], af, b[0], b[1]);
      mma_bf16(acc[n + 1], af, b[2], b[3]);
    }
  }
}

// C tiles of 8 columns, an even number, that cover `cols` columns
__host__ __device__ __forceinline__ int c_tiles(int cols) {
  return cols > 0 ? round16(cols) / 8 : 0;
}

// Stages rows [row0, row0 + kRows) and columns [0, cols) (cols a multiple
// of 8) of a bf16 matrix whose rows are `ld` elements apart, starting at
// src, into S [kRows][pitch] with a block of kThreads threads: zero at rows
// >= rows and columns >= cols_in. With `vec` (ld, cols_in and the offset of
// src multiples of 8 elements from a 16-byte aligned base) 16-byte
// cp.async copies that land while the block computes, complete after the
// caller's cp_async_wait and barrier; otherwise element by element.
template <int kRows, int kThreads>
__device__ __forceinline__ void stage_tile(bf16* S, int pitch,
                                           const bf16* __restrict__ src,
                                           size_t ld, int row0, int rows,
                                           int cols, int cols_in, bool vec) {
  if (vec) {
    const int per_row = cols / 8;
    for (int c = threadIdx.x; c < kRows * per_row; c += kThreads) {
      const int r = c / per_row, col = (c % per_row) * 8;
      const bool in = row0 + r < rows && col < cols_in;
      const bf16* from = in ? src + (size_t)(row0 + r) * ld + col : src;
      cp_async_16(S + r * pitch + col, from, in ? 16 : 0);
    }
  } else {
    const bf16 zero = __float2bfloat16_rn(0.f);
#pragma unroll 4
    for (int e = threadIdx.x; e < kRows * cols; e += kThreads) {
      const int r = e / cols, col = e % cols;
      S[r * pitch + col] = (row0 + r < rows && col < cols_in)
                               ? src[(size_t)(row0 + r) * ld + col]
                               : zero;
    }
  }
}

// S[r][c] = bf16(w[(r0 + r) * ldw + c0 + c]) for r < nr, c < nc (S
// [nr][pitch], nc and pitch multiples of 4), zero at rows r0 + r >= rows_in
// or columns c0 + c >= cols_in: a weight tile of an fp32 matrix, rounded as
// the TPU kernels round it. Four columns a thread and step, by one 16-byte
// load where they lie inside and on a 16-byte boundary, and four steps
// unrolled, so that a thread has sixteen loads in flight: the staging is
// bound by their latency, not by bandwidth.
template <int kThreads>
__device__ __forceinline__ void stage_weight(bf16* S, int pitch,
                                             const float* __restrict__ w,
                                             int ldw, int r0, int nr,
                                             int rows_in, int c0, int nc,
                                             int cols_in) {
  const int groups = nc / 4;
#pragma unroll 4
  for (int e = threadIdx.x; e < nr * groups; e += kThreads) {
    const int r = e / groups, c = (e % groups) * 4;
    const int row = r0 + r, col = c0 + c;
    const float* src = w + (size_t)row * ldw + col;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < rows_in && col + 3 < cols_in &&
        reinterpret_cast<uintptr_t>(src) % 16 == 0) {
      v = *reinterpret_cast<const float4*>(src);
    } else if (row < rows_in) {
      v.x = col < cols_in ? src[0] : 0.f;
      v.y = col + 1 < cols_in ? src[1] : 0.f;
      v.z = col + 2 < cols_in ? src[2] : 0.f;
      v.w = col + 3 < cols_in ? src[3] : 0.f;
    }
    __nv_bfloat162* dst =
        reinterpret_cast<__nv_bfloat162*>(S + r * pitch + c);
    dst[0] = __floats2bfloat162_rn(v.x, v.y);
    dst[1] = __floats2bfloat162_rn(v.z, v.w);
  }
}

// Writes the warp's accumulator rows acc * f[r] (rows row0 + g + 8 r, C
// tiles n < n_tiles) to dst [rows, ld] in bf16, at rows below `rows` and
// columns below `cols`.
template <int kN>
__device__ __forceinline__ void store_acc_rows(bf16* __restrict__ dst,
                                               size_t ld, const float (*acc)[4],
                                               const float f[2], int row0,
                                               int rows, int cols,
                                               int n_tiles) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + lane / 4 + 8 * r;
    if (row >= rows) continue;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      if (n >= n_tiles) break;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * (lane % 4) + e;
        if (col < cols)
          dst[(size_t)row * ld + col] =
              __float2bfloat16_rn(acc[n][2 * r + e] * f[r]);
      }
    }
  }
}

}  // namespace allrank
