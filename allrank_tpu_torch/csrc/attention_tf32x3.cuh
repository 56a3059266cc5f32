// The fp32 tensor-core pieces of the bare slate-attention kernels B4
// (attention_fused.cu) and B5 (attention_tiled.cu): every fp32 product runs
// as three TF32 products on mma.sync.m16n8k8 ("3xTF32"), the staging of
// fp32 row tiles, the row-by-row products S = Q K^T, dP = dO V^T and their
// transposes, the probability-weighted sums O += P V, dQ += dS K,
// dV += P_d^T dO and dK += dS^T Q with P or dS kept in registers, the row
// store, the block shapes, and the two backward kernels, which B4 and B5
// share and which differ only in how a row's probabilities are rebuilt and
// where D comes from.
//
// The split. An fp32 operand a is hi = cvt.rna.tf32(a) and lo = a - hi
// truncated to TF32 (its low 13 bits cleared); a . b is lo_a hi_b +
// hi_a lo_b + hi_a hi_b, summed in fp32 small terms first, lo_a lo_b
// dropped: some 2^-21 of |a b| against fp32's 2^-24, inside the kernels'
// fp32 tolerance. Truncating lo (and not rounding it) makes the split
// reproducible: hi + lo re-splits into the same hi and lo (|lo| stays
// below half of hi's last place, or on a tie leaves hi on the far side),
// which B5's dQ kernel needs (D below).
//
// Fragment layout of mma.sync.m16n8k8 with .tf32 operands (PTX ISA,
// "Matrix Fragments for mma.m16n8k8"), g = lane / 4, t = lane % 4:
//   A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
//   B (8 x 8, k by n): b0 (k t, n g), b1 (k t + 4, n g);
//   C (16 x 8 fp32): c0, c1 (g, 2t..2t+1), c2, c3 (g + 8, 2t..2t+1).
// ldmatrix of 8 x 8 b16 matrices reads fp32 as pairs: a thread receives
// (row g, fp32 column t) of each 8 x 4 fp32 matrix, the A and B layouts
// above. A C tile does not match the A layout (a thread holds columns 2t,
// 2t + 1, its A fragment wants k slots t, t + 4), so the products that
// weigh rows by P or dS permute the 8 keys of each k step: slot t is key
// 2t, slot t + 4 key 2t + 1. Then C's (c0, c2, c1, c3) is the A fragment as
// it stands, and the weighed rows' B fragment reads rows 2t and 2t + 1: P
// and dS never pass through shared memory.
//
// The tensor cores truncate their fp32 sums. A long sum (O, dQ, dK, dV over
// thousands of keys) would lose one last place per product, so each key or
// query tile sums from zero and is added to the running sum in fp32.
//
// Row tiles are [rows][pitch] fp32 in shared memory with pitch = dkp + 4
// (dkp the head padded to whole 8-column steps, zero filled): a row is an
// odd number of 16-byte units, so the eight rows of one ldmatrix matrix fall
// in eight distinct bank quads, and the column reads of the weighed rows
// (rows 2t and 2t + 1, column g) in 32 distinct banks.
#pragma once

#include "attention_mma_tiles.cuh"

#include <cstdint>

namespace allrank {

// d_k rounded up to whole 8-column (k8) steps
__host__ __device__ __forceinline__ int f32_head_pad(int dk) {
  return (dk + 7) / 8 * 8;
}

// floats of one staged row
__host__ __device__ __forceinline__ int f32_pitch(int dkp) { return dkp + 4; }

// The block shapes, for head widths padded to at most dk_max, as fp32's
// shared memory allows: the forward 8 warps (128 queries) through d_k 64,
// 4 at 128, with a ring of three slots (two at 128); the backward kernels
// 8 warps (128 rows) at d_k <= 32, 4 at 64 and 2 at 128, with a ring of two
// slots (three at 64), so that two blocks of 8 warps share an SM at
// d_k 32. At d_k = 32 on an H100 that took 20-33 % less backward device
// time than 4-warp blocks with three slots (PERF.md, B4's and B5's
// redesign in fp32).
__host__ __device__ constexpr int f32_fwd_warps(int dk_max) {
  return dk_max <= 64 ? 8 : 4;
}
__host__ __device__ constexpr int f32_dq_warps(int dk_max) {
  return dk_max <= 32 ? 8 : dk_max <= 64 ? 4 : 2;
}
__host__ __device__ constexpr int f32_dkv_warps(int dk_max) {
  return dk_max <= 32 ? 8 : dk_max <= 64 ? 4 : 2;
}
__host__ __device__ constexpr int f32_fwd_stages(int dk_max) {
  return dk_max <= 64 ? 3 : 2;
}
__host__ __device__ constexpr int f32_bwd_stages(int dk_max) {
  return dk_max <= 32 ? 2 : dk_max <= 64 ? 3 : 2;
}

struct Tf32Pair {
  uint32_t hi, lo;
};

__device__ __forceinline__ Tf32Pair split_tf32(float a) {
  uint32_t hi;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(a));
  return {hi, __float_as_uint(a - __uint_as_float(hi)) & 0xffffe000u};
}

// c += a . b, TF32 x TF32 products summed in fp32
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b as three TF32 products, the small terms first. kALoFirst takes
// lo_a hi_b before hi_a lo_b, else the reverse: a product and its transpose
// (S = Q K^T and S^T = K Q^T) then add the same terms in the same order, so
// the backward rebuilds the forward's scores bit for bit either way round.
template <bool kALoFirst>
__device__ __forceinline__ void mma_3xtf32(float c[4], const uint32_t ah[4],
                                           const uint32_t al[4],
                                           Tf32Pair b0, Tf32Pair b1) {
  if (kALoFirst) {
    mma_tf32(c, al, b0.hi, b1.hi);
    mma_tf32(c, ah, b0.lo, b1.lo);
  } else {
    mma_tf32(c, ah, b0.lo, b1.lo);
    mma_tf32(c, al, b0.hi, b1.hi);
  }
  mma_tf32(c, ah, b0.hi, b1.hi);
}

// Stages rows [row0, row0 + kRows) of src [L, dk] into S [kRows][pitch],
// zero past L and in the columns dk..dkp: kAligned by 16-byte cp.async
// copies that land while the block computes, otherwise element by element.
// Either way the tile is complete after the caller's cp_async_wait and
// __syncthreads.
template <int kRows, int kThreads, bool kAligned>
__device__ __forceinline__ void stage_f32_rows(float* S,
                                               const float* __restrict__ src,
                                               int row0, int L, int dk,
                                               int dkp) {
  const int pitch = f32_pitch(dkp);
  if (kAligned) {
    const int per_row = dkp / 4;
    for (int c = threadIdx.x; c < kRows * per_row; c += kThreads) {
      const int r = c / per_row, col = (c % per_row) * 4;
      const bool in = row0 + r < L && col < dk;
      const float* from = in ? src + (size_t)(row0 + r) * dk + col : src;
      cp_async_16(S + r * pitch + col, from, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kRows * dkp; e += kThreads) {
      const int r = e / dkp, col = e % dkp;
      S[r * pitch + col] = (row0 + r < L && col < dk)
                               ? src[(size_t)(row0 + r) * dk + col]
                               : 0.f;
    }
  }
}

// Splits a staged [kRows][pitch] tile in place into its hi plane (H) and
// lo plane (Lo): once a block, for rows every key or query tile reuses.
template <int kRows, int kThreads>
__device__ __forceinline__ void split_planes(float* H, float* Lo, int pitch,
                                             int dkp) {
  for (int e = threadIdx.x; e < kRows * dkp; e += kThreads) {
    const int at = (e / dkp) * pitch + e % dkp;
    const Tf32Pair s = split_tf32(H[at]);
    H[at] = __uint_as_float(s.hi);
    Lo[at] = __uint_as_float(s.lo);
  }
}

// The A fragments (hi and lo) of 16 rows from row0 at k8 step kc.
__device__ __forceinline__ void load_a_split(uint32_t ah[4], uint32_t al[4],
                                             const float* H, const float* Lo,
                                             int pitch, int row0, int kc) {
  const int lane = threadIdx.x % 32;
  const int at = (row0 + lane % 16) * pitch + kc * 8 + (lane / 16) * 4;
  ldmatrix_x4(ah, H + at);
  ldmatrix_x4(al, Lo + at);
}

// acc[j] += A . B^T over the head for C tiles j < kN: A the 16 rows from
// row0 of the planes (H, Lo), B the 8 kN rows of Bs [rows][pitch], split as
// they are read: S = Q K^T, dP = dO V^T and their transposes.
template <int kDk, int kN, bool kALoFirst>
__device__ __forceinline__ void rows_by_rows_f32(float (*acc)[4],
                                                 const float* H,
                                                 const float* Lo, int row0,
                                                 const float* Bs, int pitch,
                                                 int nk) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kc = 0; kc < kDk / 8; ++kc) {
    if (kc >= nk) break;
    uint32_t ah[4], al[4];
    load_a_split(ah, al, H, Lo, pitch, row0, kc);
#pragma unroll
    for (int j = 0; j < kN; j += 2) {
      uint32_t r[4];
      ldmatrix_x4(r, Bs + (8 * j + lane % 8 + (lane / 16) * 8) * pitch +
                         kc * 8 + ((lane / 8) % 2) * 4);
      mma_3xtf32<kALoFirst>(acc[j], ah, al, split_tf32(__uint_as_float(r[0])),
                            split_tf32(__uint_as_float(r[1])));
      mma_3xtf32<kALoFirst>(acc[j + 1], ah, al,
                            split_tf32(__uint_as_float(r[2])),
                            split_tf32(__uint_as_float(r[3])));
    }
  }
}

// acc[n] (C tiles n < dkp / 8) += P . Bs: P the 16 x 8 kSteps tile as fp32
// C tiles p[kSteps], each k step's keys permuted into the A fragment, and
// Bs [8 kSteps][pitch] the rows it weighs: O += P V, dQ += dS K,
// dV += P_d^T dO, dK += dS^T Q.
template <int kDk, int kSteps>
__device__ __forceinline__ void weigh_rows_f32(float (*acc)[4],
                                               const float (*p)[4],
                                               const float* Bs, int pitch,
                                               int nk) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    uint32_t ah[4], al[4];
    const float a[4] = {p[j][0], p[j][2], p[j][1], p[j][3]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const Tf32Pair s = split_tf32(a[i]);
      ah[i] = s.hi;
      al[i] = s.lo;
    }
    const float* row = Bs + (8 * j + 2 * (lane % 4)) * pitch + lane / 4;
#pragma unroll
    for (int n = 0; n < kDk / 8; ++n) {
      if (n >= nk) break;
      mma_3xtf32<true>(acc[n], ah, al, split_tf32(row[8 * n]),
                       split_tf32(row[pitch + 8 * n]));
    }
  }
}

// sum[n] += t[n] over the C tiles of a head (t summed from zero over one
// tile), in fp32
template <int kDk>
__device__ __forceinline__ void add_tiles(float (*sum)[4],
                                          const float (*t)[4]) {
#pragma unroll
  for (int n = 0; n < kDk / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[n][e] += t[n][e];
}

// Writes the warp's 16 rows acc * f (rows row0 + g + 8 r, factor f[r]) to
// dst [L, dk], rows below L.
template <int kDk>
__device__ __forceinline__ void store_rows_f32(float* __restrict__ dst,
                                               const float (*acc)[4],
                                               const float f[2], int row0,
                                               int L, int dk, int nk) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + lane / 4 + 8 * r;
    if (row >= L) continue;
#pragma unroll
    for (int n = 0; n < kDk / 8; ++n) {
      if (n >= nk) break;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * (lane % 4) + e;
        if (col < dk) dst[(size_t)row * dk + col] = acc[n][2 * r + e] * f[r];
      }
    }
  }
}

// The probability of a pair from its scaled, masked score sc and its row's
// statistics: exp2((sc - sub) * log2(e)) * mul. B4 keeps (max, sum) per
// row, so sub = max and mul = 1 / sum; B5 the row's logsumexp, sub = lse
// and mul = 1. Every fp32 kernel of B4 and B5 takes its row's max (or lse)
// in these units and forms P here, so where a row has a single key
// sc - sub is exactly 0 and P exactly 1. The kernels take sc, and dP times
// the dropout scale, with __fmul_rn: a product the compiler fused into the
// following subtraction would skip its rounding, and the cancellation
// against the forward's (or the other kernel's) rounded value would leave
// its rounding error.
__device__ __forceinline__ float f32_prob(float sc, float sub, float mul) {
  return exp2_approx((sc - sub) * kLog2e) * mul;
}

// Shared memory of the fp32 kernels in bytes: `rows` fp32 rows of the
// padded head and `extra` bytes after them.
__host__ __forceinline__ size_t f32_smem(int dk, int rows, size_t extra) {
  return (size_t)rows * f32_pitch(f32_head_pad(dk)) * sizeof(float) + extra;
}

// The row statistics of one query as the backward reads them: sub and mul
// of f32_prob (see above), zero past L.
template <bool kLse>
__device__ __forceinline__ void f32_row_stats(const float* __restrict__ stats,
                                              size_t row, bool ok,
                                              float& sub, float& mul) {
  sub = 0.f;
  mul = 0.f;
  if (!ok) return;
  if (kLse) {
    sub = stats[row];
    mul = 1.f;
  } else {
    sub = stats[2 * row];
    mul = 1.f / stats[2 * row + 1];
  }
}

// dQ of one block of 16 kWarps queries, walking the 64-key tiles through
// the ring, each in two halves of 32 keys: S = Q K^T and dP = dO V^T, then
// dS = P (dPd - D) at live keys and query rows below L (zero elsewhere),
// and dQ += dS K, scaled once at the end. D goes to Dg [G, L] for the dK/dV
// kernel. B4 (!kLse), and B5 under dropout, first walk the key tiles once
// for D = rowsum(dPd P), the TPU kernel's own row term; from the same
// fragments, so where a row has a single key (P exactly 1) dP - D is
// exactly 0. B5 (kLse) without dropout takes D = rowsum(dO O) from the
// forward's output O through the same split product as dP, dO . O the
// diagonal of one 16 x 16 product a warp: where a row has a single key O is
// that key's v_hi + v_lo, which re-splits into the same pair, and again
// dP - D is exactly 0 (ROADMAP Queue C3). Under dropout O is that sum times
// 1 / (1 - p), rounded, which splits otherwise: there the D pass keeps the
// cancellation exact.
template <bool kLse, int kDk, bool kAligned>
__device__ __forceinline__ void bwd_dq_tf32x3(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const unsigned char* __restrict__ key_mask,
    const float* __restrict__ stats, const float* __restrict__ dO,
    const float* __restrict__ O, float* __restrict__ Dg,
    float* __restrict__ dq, int L, int dk, int h, float scale,
    DropStream drop) {
  constexpr int kWarps = f32_dq_warps(kDk), kSt = f32_bwd_stages(kDk);
  constexpr int kThreads = 32 * kWarps, kRows = 16 * kWarps, kKey = 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dkp = f32_head_pad(dk), pitch = f32_pitch(dkp), nk = dkp / 8;
  const int tile = kKey * pitch;
  float* Qh = reinterpret_cast<float*>(smem_raw);  // [kRows][pitch] q, hi
  float* Ql = Qh + kRows * pitch;                  // q, lo
  float* Oh = Ql + kRows * pitch;                  // dO, hi
  float* Ol = Oh + kRows * pitch;                  // dO, lo
  float* Ks = Ol + kRows * pitch;   // [kSt][64][pitch] key tiles
  float* Vs = Ks + kSt * tile;      // [kSt][64][pitch] value tiles
  uint32_t* bits = reinterpret_cast<uint32_t*>(Vs + kSt * tile);
  const int g = blockIdx.y, q0 = blockIdx.x * kRows;
  const size_t base = (size_t)g * L * dk;
  const unsigned char* padded = key_mask + (size_t)(g / h) * L;
  const int lane = threadIdx.x % 32, col = 2 * (lane % 4);
  const int wrow = (threadIdx.x / 32) * 16, row0 = q0 + wrow;
  const int n_tiles = (L + kKey - 1) / kKey;
  const bool d_pass = !kLse || drop.on;
  const int n_steps = d_pass ? 2 * n_tiles : n_tiles;

  // step i into ring slot b: key tile i mod n, its values and keys' bits
  auto stage = [&](int i, int b) {
    const int k0 = (i < n_tiles ? i : i - n_tiles) * kKey;
    stage_f32_rows<kKey, kThreads, kAligned>(Ks + b * tile, k + base, k0, L,
                                             dk, dkp);
    stage_f32_rows<kKey, kThreads, kAligned>(Vs + b * tile, v + base, k0, L,
                                             dk, dkp);
    stage_key_bits(bits + 4 * b, padded, k0, L);
  };
  stage_f32_rows<kRows, kThreads, kAligned>(Qh, q + base, q0, L, dk, dkp);
  stage_f32_rows<kRows, kThreads, kAligned>(Oh, dO + base, q0, L, dk, dkp);
#pragma unroll
  for (int i = 0; i < kSt - 1; ++i) {
    if (i < n_steps) stage(i, i);
    cp_async_commit();
  }
  cp_async_wait<kSt - 2>();
  __syncthreads();
  split_planes<kRows, kThreads>(Qh, Ql, pitch, dkp);
  split_planes<kRows, kThreads>(Oh, Ol, pitch, dkp);
  __syncthreads();

  // the rows' statistics as the forward left them; rows past L take no part
  bool ok[2];
  float sub[2], mul[2], D[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + lane / 4 + 8 * r;
    ok[r] = row < L;
    f32_row_stats<kLse>(stats, (size_t)g * L + row, ok[r], sub[r], mul[r]);
  }
  if (!d_pass) {
    // D = dO . O for the warp's 16 rows: the diagonal of dO O^T over the
    // same 16 rows, O's B fragments read from device memory
    float dd[2][4] = {};
#pragma unroll
    for (int kc = 0; kc < kDk / 8; ++kc) {
      if (kc >= nk) break;
      uint32_t ah[4], al[4];
      load_a_split(ah, al, Oh, Ol, pitch, wrow, kc);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int row = row0 + 8 * jj + lane / 4;
        float b[2];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int c = 8 * kc + 4 * hf + lane % 4;
          b[hf] = row < L && c < dk ? O[base + (size_t)row * dk + c] : 0.f;
        }
        mma_3xtf32<true>(dd[jj], ah, al, split_tf32(b[0]), split_tf32(b[1]));
      }
    }
    // row g sits in tile 0 at column g, row g + 8 in tile 1: the thread
    // with 2t <= g < 2t + 2 holds both
    const int gr = lane / 4, src = 4 * gr + gr / 2;
    const float d0 = gr % 2 ? dd[0][1] : dd[0][0];
    const float d1 = gr % 2 ? dd[1][3] : dd[1][2];
    D[0] = __shfl_sync(0xffffffffu, d0, src);
    D[1] = __shfl_sync(0xffffffffu, d1, src);
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (lane % 4 == 0 && ok[r])
        Dg[(size_t)g * L + row0 + lane / 4 + 8 * r] = D[r];
  }

  float acc[kDk / 8][4] = {};
  for (int it = 0, buf = 0; it < n_steps;
       ++it, buf = buf == kSt - 1 ? 0 : buf + 1) {
    cp_async_wait<kSt - 2>();
    __syncthreads();
    if (it + kSt - 1 < n_steps)
      stage(it + kSt - 1, buf == 0 ? kSt - 1 : buf - 1);
    cp_async_commit();
    const bool pass0 = d_pass && it < n_tiles;
    if (d_pass && it == n_tiles) {
      // D is complete: sum the quad's partials, in a fixed order
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        D[r] = quad_sum(D[r]);
        if (lane % 4 == 0 && ok[r])
          Dg[(size_t)g * L + row0 + lane / 4 + 8 * r] = D[r];
      }
    }
    const int k0 = (it < n_tiles ? it : it - n_tiles) * kKey;
    const uint32_t* kb = bits + 4 * buf;
    const bool live = (kb[0] | kb[1] | kb[2] | kb[3]) == 0;
    // the tile in two halves of 32 keys, half the registers for S and dP
#pragma unroll 1
    for (int hk = 0; hk < 2; ++hk) {
      const float* Kh = Ks + buf * tile + 32 * hk * pitch;
      const uint32_t pad = kb[hk] >> col, past = kb[2 + hk] >> col;
      float s[4][4] = {}, dp[4][4] = {};
      rows_by_rows_f32<kDk, 4, true>(s, Qh, Ql, wrow, Kh, pitch, nk);
      rows_by_rows_f32<kDk, 4, true>(dp, Oh, Ol, wrow,
                                     Vs + buf * tile + 32 * hk * pitch, pitch,
                                     nk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, bit = 8 * j + (e & 1);
          const bool kpad = !live && ((pad >> bit) & 1u);
          const bool kpast = !live && ((past >> bit) & 1u);
          // past L: no part (P 0); dS is zero there and at padded keys
          const float sc = kpad ? kNegInfFill : __fmul_rn(s[j][e], scale);
          const float p = kpast ? 0.f : f32_prob(sc, sub[r], mul[r]);
          float dpd = dp[j][e];
          if (drop.on) {
            const size_t index =
                ((size_t)g * L + row0 + lane / 4 + 8 * r) * L + k0 + 32 * hk +
                8 * j + col + (e & 1);
            dpd = drop_keep(drop, index) ? __fmul_rn(dpd, drop.inv) : 0.f;
          }
          if (pass0)
            D[r] += dpd * p;
          else
            s[j][e] = ok[r] && !kpad && !kpast ? p * (dpd - D[r]) : 0.f;
        }
      if (pass0) continue;
      float t[kDk / 8][4] = {};
      weigh_rows_f32<kDk, 4>(t, s, Kh, pitch, nk);
      add_tiles<kDk>(acc, t);
    }
  }
  const float f[2] = {scale, scale};
  store_rows_f32<kDk>(dq + (size_t)g * L * dk, acc, f, row0, L, dk, nk);
}

// dK and dV of one block of 16 kWarps keys, walking 64-query tiles with q,
// dO and each query's statistics and D streamed through the ring; per 32
// queries S^T = K Q^T and dP^T = V dO^T (each warp 16 keys, the products
// taken in the forward's order of terms), P^T rebuilt as the forward
// formed P, then dV += P_d^T dO and dK += dS^T Q, scaled at the end.
template <bool kLse, int kDk, bool kAligned>
__device__ __forceinline__ void bwd_dkv_tf32x3(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const unsigned char* __restrict__ key_mask,
    const float* __restrict__ stats, const float* __restrict__ Dg,
    const float* __restrict__ dO, float* __restrict__ dk_out,
    float* __restrict__ dv_out, int L, int dk, int h, float scale,
    DropStream drop) {
  constexpr int kWarps = f32_dkv_warps(kDk), kSt = f32_bwd_stages(kDk);
  constexpr int kThreads = 32 * kWarps, kRows = 16 * kWarps, kQ = 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dkp = f32_head_pad(dk), pitch = f32_pitch(dkp), nk = dkp / 8;
  const int tile = kQ * pitch;
  float* Kh = reinterpret_cast<float*>(smem_raw);  // [kRows][pitch] k, hi
  float* Kl = Kh + kRows * pitch;                  // k, lo
  float* Vh = Kl + kRows * pitch;                  // v, hi
  float* Vl = Vh + kRows * pitch;                  // v, lo
  float* Qs = Vl + kRows * pitch;   // [kSt][64][pitch] query tiles
  float* Os = Qs + kSt * tile;      // [kSt][64][pitch] dO tiles
  // [kSt][3][64]: each query's sub and mul (f32_prob) and D, zero past L
  float* St = Os + kSt * tile;
  const int g = blockIdx.y, kt0 = blockIdx.x * kRows;
  const size_t base = (size_t)g * L * dk;
  const unsigned char* padded = key_mask + (size_t)(g / h) * L;
  const int lane = threadIdx.x % 32, col = 2 * (lane % 4);
  const int wrow = (threadIdx.x / 32) * 16, key0 = kt0 + wrow;
  const int n_tiles = (L + kQ - 1) / kQ;

  // query tile t into ring slot b: q, dO and the rows' statistics
  auto stage = [&](int t, int b) {
    const int r0 = t * kQ;
    stage_f32_rows<kQ, kThreads, kAligned>(Qs + b * tile, q + base, r0, L,
                                           dk, dkp);
    stage_f32_rows<kQ, kThreads, kAligned>(Os + b * tile, dO + base, r0, L,
                                           dk, dkp);
    float* dst = St + b * 3 * kQ;
    for (int c = threadIdx.x; c < kQ; c += kThreads) {
      const bool in = r0 + c < L;
      const size_t row = (size_t)g * L + r0 + c;
      f32_row_stats<kLse>(stats, row, in, dst[c], dst[kQ + c]);
      dst[2 * kQ + c] = in ? Dg[row] : 0.f;
    }
  };
  stage_f32_rows<kRows, kThreads, kAligned>(Kh, k + base, kt0, L, dk, dkp);
  stage_f32_rows<kRows, kThreads, kAligned>(Vh, v + base, kt0, L, dk, dkp);
#pragma unroll
  for (int i = 0; i < kSt - 1; ++i) {
    if (i < n_tiles) stage(i, i);
    cp_async_commit();
  }
  cp_async_wait<kSt - 2>();
  __syncthreads();
  split_planes<kRows, kThreads>(Kh, Kl, pitch, dkp);
  split_planes<kRows, kThreads>(Vh, Vl, pitch, dkp);

  // this thread's two keys: padded, past L (no part), or live
  bool pad[2], past[2], all_live = true;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + lane / 4 + 8 * r;
    past[r] = key >= L;
    pad[r] = !past[r] && padded[key];
    all_live &= !past[r] && !pad[r];
  }
  // a block of live keys only takes, at query tiles below L, no mask
  all_live = __syncthreads_and(all_live);
  float dk_acc[kDk / 8][4] = {}, dv_acc[kDk / 8][4] = {};
  for (int it = 0, buf = 0; it < n_tiles;
       ++it, buf = buf == kSt - 1 ? 0 : buf + 1) {
    const int q0 = it * kQ;
    cp_async_wait<kSt - 2>();
    __syncthreads();
    if (it + kSt - 1 < n_tiles)
      stage(it + kSt - 1, buf == 0 ? kSt - 1 : buf - 1);
    cp_async_commit();
    const float* sub_t = St + buf * 3 * kQ;
    const float* mul_t = sub_t + kQ;
    const float* D_t = mul_t + kQ;
    const bool live = all_live && q0 + kQ <= L;
    // the tile in two halves of 32 queries, half the registers for S^T and
    // dP^T
#pragma unroll 1
    for (int hq = 0; hq < 2; ++hq) {
      const float* Qh_ = Qs + buf * tile + 32 * hq * pitch;
      const float* Oh_ = Os + buf * tile + 32 * hq * pitch;
      float s[4][4] = {}, dp[4][4] = {};
      rows_by_rows_f32<kDk, 4, false>(s, Kh, Kl, wrow, Qh_, pitch, nk);
      rows_by_rows_f32<kDk, 4, false>(dp, Vh, Vl, wrow, Oh_, pitch, nk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = 32 * hq + 8 * j + col + (e & 1);
          float pd = 0.f, ds = 0.f;
          if (live || (q0 + c < L && !past[r])) {
            // a padded key scores NEG_INF_FILL; on a fully padded slate
            // its row's max (or lse) is NEG_INF_FILL too, so P reads the
            // forward's 1 / L (or 1), as in the plain version
            const float sc = !live && pad[r] ? kNegInfFill
                                             : __fmul_rn(s[j][e], scale);
            const float p = f32_prob(sc, sub_t[c], mul_t[c]);
            float f = 1.f;
            if (drop.on) {
              const size_t index =
                  ((size_t)g * L + q0 + c) * L + key0 + lane / 4 + 8 * r;
              f = drop_keep(drop, index) ? drop.inv : 0.f;
            }
            pd = p * f;
            if (live || !pad[r])
              ds = p * (__fmul_rn(dp[j][e], f) - D_t[c]);
          }
          s[j][e] = pd;
          dp[j][e] = ds;
        }
      float t[kDk / 8][4] = {};
      weigh_rows_f32<kDk, 4>(t, s, Oh_, pitch, nk);
      add_tiles<kDk>(dv_acc, t);
#pragma unroll
      for (int n = 0; n < kDk / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) t[n][e] = 0.f;
      weigh_rows_f32<kDk, 4>(t, dp, Qh_, pitch, nk);
      add_tiles<kDk>(dk_acc, t);
    }
  }
  const float f_k[2] = {scale, scale}, f_v[2] = {1.f, 1.f};
  store_rows_f32<kDk>(dk_out + base, dk_acc, f_k, key0, L, dk, nk);
  store_rows_f32<kDk>(dv_out + base, dv_acc, f_v, key0, L, dk, nk);
}

// The fp32 backward's two kernels of one call, on `stream`: dq_kernel
// (which writes D) then dkv_kernel, each a __global__ wrapper of the bodies
// above for head widths padded to at most kDk.
template <int kDk, class DqKernel, class DkvKernel>
cudaError_t launch_bwd_tf32x3(DqKernel dq_kernel, DkvKernel dkv_kernel,
                              const void* q, const void* k, const void* v,
                              const void* key_mask, const void* stats,
                              const void* dO, const void* O, void* D,
                              void* dq, void* dk_out, void* dv_out, int G,
                              int L, int dk, int h, float scale,
                              DropStream drop, cudaStream_t stream) {
  constexpr int kSt = f32_bwd_stages(kDk);
  constexpr int kRowsQ = 16 * f32_dq_warps(kDk);
  constexpr int kRowsKv = 16 * f32_dkv_warps(kDk);
  const size_t smem_q = f32_smem(dk, 4 * kRowsQ + 2 * kSt * 64,
                                 4 * kSt * sizeof(uint32_t));
  const size_t smem_kv = f32_smem(dk, 4 * kRowsKv + 2 * kSt * 64,
                                  3 * kSt * 64 * sizeof(float));
  cudaError_t err = allow_smem(dq_kernel, smem_q);
  if (err != cudaSuccess) return err;
  if ((err = allow_smem(dkv_kernel, smem_kv)) != cudaSuccess) return err;
  const auto* qt = static_cast<const float*>(q);
  const auto* kt = static_cast<const float*>(k);
  const auto* vt = static_cast<const float*>(v);
  const auto* mask = static_cast<const unsigned char*>(key_mask);
  const auto* st = static_cast<const float*>(stats);
  const auto* dot = static_cast<const float*>(dO);
  float* Dg = static_cast<float*>(D);
  dq_kernel<<<dim3((L + kRowsQ - 1) / kRowsQ, G), 32 * f32_dq_warps(kDk),
              smem_q, stream>>>(
      qt, kt, vt, mask, st, dot, static_cast<const float*>(O), Dg,
      static_cast<float*>(dq), L, dk, h, scale, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkv_kernel<<<dim3((L + kRowsKv - 1) / kRowsKv, G), 32 * f32_dkv_warps(kDk),
               smem_kv, stream>>>(
      qt, kt, vt, mask, st, Dg, dot, static_cast<float*>(dk_out),
      static_cast<float*>(dv_out), L, dk, h, scale, drop);
  return cudaGetLastError();
}

}  // namespace allrank
