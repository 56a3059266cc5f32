// Warp-level tensor-core pieces for the bf16 attention kernels on Hopper
// (sm_90a): ldmatrix fragment loads, the bf16 mma.sync m16n8k16 product
// with fp32 sums, the repacking of an fp32 accumulator into a bf16 A
// fragment, quad reductions over the accumulator's rows, a cp.async ring for
// bf16 row tiles and the base-2 exponential.
//
// Fragment layout of mma.sync.m16n8k16 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), with g = lane / 4 and t = lane % 4:
//   A (16 x 16, row major), four .b32 of two bf16: a0 (g, 2t..2t+1),
//     a1 (g + 8, 2t..), a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..);
//   B (16 x 8, k by n), two .b32: b0 (k 2t..2t+1, n g), b1 (k 2t + 8.., n g);
//   C (16 x 8 fp32): c0, c1 (g, 2t..2t+1), c2, c3 (g + 8, 2t..2t+1).
// So the four threads of a quad hold one row pair of C, and the C tiles of
// two neighbouring 8-column blocks are, rounded to bf16, the A fragment of
// the 16-deep product over those 16 columns: a score or probability tile
// never passes through shared memory on its way to the next product.
//
// Row tiles are [rows][pitch] bf16 in shared memory with pitch = dkp + 8
// (dkp the head width padded to whole 16-column steps, zero filled): a row
// is an odd number of 16-byte units, so the eight row addresses of one
// ldmatrix 8 x 8 matrix fall in eight distinct bank quads.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace allrank {

// d_k rounded up to whole 16-column (k16) steps
__host__ __device__ __forceinline__ int mma_head_pad(int dk) {
  return (dk + 15) / 16 * 16;
}

// bf16 elements of one staged row
__host__ __device__ __forceinline__ int mma_pitch(int dkp) { return dkp + 8; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// r[i] = matrix i of four 8 x 8 bf16 matrices; lane l gives the address of
// row l % 8 of matrix l / 8. Thread (g, t) receives (row g, cols 2t, 2t+1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// the same, each matrix transposed: thread (g, t) receives (rows 2t, 2t+1,
// col g)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a . b, bf16 x bf16 products summed in fp32
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of the k16 step over C tiles n and n + 1 (16 columns).
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float c0[4],
                                         const float c1[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// max and sum over the four threads of a quad, which hold one C row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 2^x on the special-function unit (MUFU.EX2); -inf gives +0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most n of this thread's groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Stages rows [row0, row0 + kRows) of src [L, dk] into S [kRows][pitch] with
// a block of kThreads threads, zero past L and in the columns dk..dkp.
// kAligned (every row starts on a 16-byte boundary: dk % 8 == 0 and src
// aligned) issues
// 16-byte cp.async copies that land while the block computes; otherwise the
// elements are copied one by one, synchronously. Either way the tile is
// complete for every thread after the caller's cp_async_wait and
// __syncthreads.
template <int kRows, int kThreads, bool kAligned>
__device__ __forceinline__ void stage_bf16_rows(
    __nv_bfloat16* S, const __nv_bfloat16* __restrict__ src, int row0, int L,
    int dk, int dkp) {
  const int pitch = mma_pitch(dkp);
  if (kAligned) {
    const int per_row = dkp / 8;
    for (int c = threadIdx.x; c < kRows * per_row; c += kThreads) {
      const int r = c / per_row, col = (c % per_row) * 8;
      const bool in = row0 + r < L && col < dk;
      const __nv_bfloat16* from =
          in ? src + (size_t)(row0 + r) * dk + col : src;
      cp_async_16(S + r * pitch + col, from, in ? 16 : 0);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
    for (int e = threadIdx.x; e < kRows * dkp; e += kThreads) {
      const int r = e / dkp, col = e % dkp;
      S[r * pitch + col] = (row0 + r < L && col < dk)
                               ? src[(size_t)(row0 + r) * dk + col]
                               : zero;
    }
  }
}

}  // namespace allrank
