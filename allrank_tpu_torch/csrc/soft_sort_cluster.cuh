// The pieces of the fused NeuralNDCG soft-sort on a thread-block cluster
// that B8's route "cluster" (neuralsort_cluster.cu, whose header describes
// the math and the design) and X4 (neuralsort_layout.cu, the same slate
// kernels with the Sinkhorn records and the backward's U and V stacks in
// shared memory) share: the plan of a block's shared memory, the chain, the
// register-held loop's matvecs and exchanges, the once-a-slate sums, X4's
// helpers and the cluster launch. The slate kernels themselves are in
// soft_sort_cluster_kernels.cuh.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "soft_sort.cuh"

namespace cg = cooperative_groups;

namespace allrank {
namespace {

constexpr int kClusterThreads = 512;  // 16 warps, 128 registers a thread
constexpr int kClusterWarps = kClusterThreads / 32;
constexpr int kMaxClusterL = 512;
constexpr int kFwdVectors = kChainVectors + 1;  // the chain's and b
constexpr int kBwdVectors = kChainVectors + 7;  // + go, b_t, db, v, drs, 2
constexpr int kTileRows = 8, kTileCols = 128;   // a warp's product tile
constexpr int kStage = 8;  // iterations of the stacks staged: 2 buffers
constexpr int kChunk = kStage / 2;  // of 4, one filled while one is read
constexpr int kMaxGather = 16;  // partials of a column over a cluster

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
// the blocks of a cluster at length L: the register shape's
__host__ __device__ constexpr int cluster_blocks(int L) {
  return L <= 128 ? 1 : L <= 256 ? 2 : 8;
}
__host__ __device__ constexpr int rows_per_block(int L, int csize) {
  return (L + csize - 1) / csize;
}
__host__ __device__ constexpr int col_tiles(int L) {
  return (L + kTileCols - 1) / kTileCols;
}
// the epilogue's warp teams: each a row of whole column tiles
__host__ __device__ constexpr int tile_teams(int L) {
  return kClusterWarps / col_tiles(L);
}
// the exchange buffers (each block's pushed column sums, or the
// once-a-slate sums' partials) and the row sums' warp partials of the loop
// (the backward's two row sums an iteration, the forward's one)
__host__ __device__ constexpr int loop_room(int L, int csize, bool backward) {
  return 2 * imax(csize * round_up(L, 4), 512) +
         (backward ? 2 : 1) * kClusterWarps *
             round_up(rows_per_block(L, csize), 4);
}
// the backward's room: the loop's, then the epilogue's column sums and
// staged stacks
__host__ __device__ constexpr int bwd_union(int L, int csize) {
  return imax(imax(loop_room(L, csize, true),
                   2 * tile_teams(L) * round_up(L, 4)),
              kStage * (2 * round_up(rows_per_block(L, csize), 8) +
                        2 * round_up(L, kTileCols)));
}
// Floats of shared memory a block takes (ops/neuralsort.py's
// cluster_smem_floats mirrors this): its rows of M0 at a pitch of L
// rounded up to 4 (16-byte rows), the O(L) vectors, its own rows' vectors
// and the room for the sums.
__host__ __device__ constexpr int smem_floats(int L, int csize,
                                              bool backward) {
  return rows_per_block(L, csize) * round_up(L, 4) +
         (backward ? kBwdVectors * round_up(L, 4) +
                         4 * round_up(rows_per_block(L, csize), 4) +
                         bwd_union(L, csize)
                   : kFwdVectors * round_up(L, 4) +
                         round_up(rows_per_block(L, csize), 4) +
                         loop_room(L, csize, false));
}

struct Share {  // this block's rows of the slate
  int rank, csize, r0, rows;
};

__device__ __forceinline__ Share my_share(const cg::cluster_group& cluster,
                                          int L) {
  Share sh;
  sh.rank = (int)cluster.block_rank();
  sh.csize = (int)cluster.num_blocks();
  const int R = rows_per_block(L, sh.csize);
  sh.r0 = min(L, sh.rank * R);
  sh.rows = min(L, sh.r0 + R) - sh.r0;
  return sh;
}

__device__ __forceinline__ Chain take_chain(float*& smem, int P) {
  Chain c;
  c.s_f = take(smem, P);
  c.s_z = take(smem, P);
  c.valid = take(smem, P);
  c.rs = take(smem, P);
  c.scaling = take(smem, P);
  c.vec = take(smem, P);
  return c;
}

// A 4-byte copy from device to shared memory that lands while the block
// computes (cp.async), zero where `in` is false.
__device__ __forceinline__ void cp_async_4(float* dst, const float* src,
                                           bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// x / tau; a division by 1 is exact, so it is skipped
__device__ __forceinline__ float over_tau(float x, float tau) {
  return tau == 1.f ? x : x / tau;
}

// The chain's vectors in full, and the block's rows of M0 into M [rows, P]
// (shared memory, the columns from L to P zero): neural_sort_chain's values
// (each logit computed once, its exponential once, then divided by the
// row's sum, kept in `sums` [rows]), for rows r0 .. r0 + rows - 1 only.
__device__ inline void chain_rows(const float* s, const float* pad,
                                  const float* vec, int L, float tau,
                                  const Chain& c, float* M, const Share& sh,
                                  float* sums) {
  const int P = round_up(L, 4);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j = threadIdx.x; j < L; j += kClusterThreads) {
    const bool padded = pad[j] > 0.5f;
    const float valid = 1.f - pad[j];
    c.valid[j] = valid;
    c.s_f[j] = padded ? kNegFill : s[j];
    c.s_z[j] = s[j] * valid;
    c.vec[j] = vec[j];
  }
  for (int j = L + threadIdx.x; j < P; j += kClusterThreads) c.valid[j] = 0.f;
  __syncthreads();
  float valid_n = 0.f;  // every warp takes the same sum in the same order
  for (int j = lane; j < L; j += 32) valid_n += c.valid[j];
  valid_n = warp_sum(valid_n);
  for (int j = threadIdx.x; j < L; j += kClusterThreads) {
    const float rank = (float)(j + 1);
    c.scaling[j] = rank <= valid_n ? valid_n + 1.f - 2.f * rank : 0.f;
  }
  for (int j = warp; j < L; j += kClusterWarps) {
    float acc = 0.f;
    for (int k = lane; k < L; k += 32)
      acc += fabsf(c.s_f[j] - c.s_f[k]) * pair_valid(c, j, k);
    acc = warp_sum(acc);
    if (lane == 0) c.rs[j] = acc;
  }
  __syncthreads();
  for (int il = warp; il < sh.rows; il += kClusterWarps) {
    const int i = sh.r0 + il;
    float* row = M + (size_t)il * P;
    if (c.valid[i] < 0.5f) {
      for (int j = lane; j < P; j += 32)
        row[j] = j < L && c.valid[j] < 0.5f ? 1.f : 0.f;
      continue;
    }
    const float sc = c.scaling[i];
    float z_max = -INFINITY;
    for (int j = lane; j < P; j += 32) {
      float z = 0.f;
      if (j < L && c.valid[j] > 0.5f) {
        z = over_tau(sc * c.s_z[j] - c.rs[j], tau);
        z_max = fmaxf(z_max, z);
      }
      row[j] = z;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      z_max = fmaxf(z_max, __shfl_xor_sync(0xffffffffu, z_max, o));
    float sum = 0.f;
    for (int j = lane; j < L; j += 32)
      if (c.valid[j] > 0.5f) {
        const float e = expf(row[j] - z_max);
        row[j] = e;
        sum += e;
      }
    sum = warp_sum(sum);
    if (lane == 0) sums[il] = sum;
  }
  __syncthreads();
  // each valid row's terms over its sum: the block's threads on quads of
  // the rows, four independent divisions at a time
  const int quads = P / 4;
  for (int e = threadIdx.x; e < sh.rows * quads; e += kClusterThreads) {
    const int il = e / quads, q = e - il * quads;
    if (c.valid[sh.r0 + il] < 0.5f) continue;
    float4* at = reinterpret_cast<float4*>(M + (size_t)il * P) + q;
    const float4 vq = reinterpret_cast<const float4*>(c.valid)[q];
    const float sum = sums[il];
    float4 m = *at;
    if (vq.x > 0.5f) m.x = m.x / sum;
    if (vq.y > 0.5f) m.y = m.y / sum;
    if (vq.z > 0.5f) m.z = m.z / sum;
    if (vq.w > 0.5f) m.w = m.w / sum;
    *at = m;
  }
  __syncthreads();
}

// A thread's share of the block's rows of M0 for the Sinkhorn loop: lane l
// holds the rows l + 32 k (k < KR), warp w the column quads KQ w + m (m <
// KQ); rows past the block's and columns past L hold zeros.
template <int kKR, int kKQ>
struct MRegs {
  float4 m[kKR][kKQ];
};

template <int kKR, int kKQ>
__device__ __forceinline__ void load_regs(MRegs<kKR, kKQ>& g, const float* M,
                                          int P, int rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < kKR; ++k) {
    const int il = lane + 32 * k;
#pragma unroll
    for (int m = 0; m < kKQ; ++m) {
      const int q = warp * kKQ + m;
      g.m[k][m] = il < rows && 4 * q < P
                      ? reinterpret_cast<const float4*>(M + (size_t)il * P)[q]
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// The block's column sums over its rows il of M[il][j] * w[il] for the
// warp's columns, pushed to every block of the cluster: each lane sums its
// KR rows (in k order), then the lanes' sums meet in a halving butterfly
// (each step a lane keeps half of its columns and adds its partner's share
// of them), which leaves column vi(lane) on the lane; one lane a column
// stores it at xk[rank][j] in each block's shared memory (the stores land
// while the cluster barrier that follows is reached).
template <int kKR, int kKQ>
__device__ __forceinline__ void col_dots(const MRegs<kKR, kKQ>& g,
                                         const float* w, int rows, int P,
                                         const cg::cluster_group& cluster,
                                         const Share& sh, float* xk) {
  constexpr int kV = 4 * kKQ;  // 8, 16 or 32 columns a warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float wk[kKR];
#pragma unroll
  for (int k = 0; k < kKR; ++k) {
    const int il = lane + 32 * k;
    wk[k] = il < rows ? w[il] : 0.f;
  }
  float v[kV];
#pragma unroll
  for (int m = 0; m < kKQ; ++m) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kKR; ++k) {
      acc.x += g.m[k][m].x * wk[k];
      acc.y += g.m[k][m].y * wk[k];
      acc.z += g.m[k][m].z * wk[k];
      acc.w += g.m[k][m].w * wk[k];
    }
    v[4 * m] = acc.x;
    v[4 * m + 1] = acc.y;
    v[4 * m + 2] = acc.z;
    v[4 * m + 3] = acc.w;
  }
  int vi = 0;
#pragma unroll
  for (int lvl = 0; lvl < 5; ++lvl) {
    const int o = 16 >> lvl, n = kV >> lvl;
    const bool upper = (lane & o) != 0;
    if (n >= 2) {
#pragma unroll
      for (int i = 0; i < kV / 2; ++i) {
        if (i < n / 2) {
          const float send = upper ? v[i] : v[i + n / 2];
          const float keep = upper ? v[i + n / 2] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
      }
      if (upper) vi += n / 2;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
  }
  // the lanes that no halving step told apart hold the same sum
  constexpr int kSame = kV >= 32 ? 0 : kV == 16 ? 1 : 3;
  const int j = 4 * warp * kKQ + vi;
  if ((lane & kSame) == 0 && j < P)
    for (int r = 0; r < sh.csize; ++r)
      cluster.map_shared_rank(xk, r)[sh.rank * P + j] = v[0];
}

// Column j's sum of the blocks' pushed column sums, in rank order.
__device__ __forceinline__ float pushed_total(const float* xk, int csize,
                                              int P, int j) {
  float acc = 0.f;
  for (int r = 0; r < csize; ++r) acc += xk[r * P + j];
  return acc;
}

// part[w][il] = sum over warp w's columns j of M[il][j] * x[j], for the
// lane's rows il < Rp (x zero from L to P).
template <int kKR, int kKQ>
__device__ __forceinline__ void row_parts(const MRegs<kKR, kKQ>& g,
                                          const float* x, int P, int Rp,
                                          float* part) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float4 xv[kKQ];
#pragma unroll
  for (int m = 0; m < kKQ; ++m) {
    const int q = warp * kKQ + m;
    xv[m] = 4 * q < P ? reinterpret_cast<const float4*>(x)[q]
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int k = 0; k < kKR; ++k) {
    float acc = 0.f;
#pragma unroll
    for (int m = 0; m < kKQ; ++m) {
      acc += g.m[k][m].x * xv[m].x;
      acc += g.m[k][m].y * xv[m].y;
      acc += g.m[k][m].z * xv[m].z;
      acc += g.m[k][m].w * xv[m].w;
    }
    const int il = lane + 32 * k;
    if (il < Rp) part[warp * Rp + il] = acc;
  }
}

// row_parts of two vectors at once: part_x[w][il] for x, part_y[w][il]
// for y (both zero from L to P), each in row_parts' order.
template <int kKR, int kKQ>
__device__ __forceinline__ void row_parts2(const MRegs<kKR, kKQ>& g,
                                           const float* x, const float* y,
                                           int P, int Rp, float* part_x,
                                           float* part_y) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float4 xv[kKQ], yv[kKQ];
#pragma unroll
  for (int m = 0; m < kKQ; ++m) {
    const int q = warp * kKQ + m;
    xv[m] = 4 * q < P ? reinterpret_cast<const float4*>(x)[q]
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    yv[m] = 4 * q < P ? reinterpret_cast<const float4*>(y)[q]
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int k = 0; k < kKR; ++k) {
    float ax = 0.f, ay = 0.f;
#pragma unroll
    for (int m = 0; m < kKQ; ++m) {
      ax += g.m[k][m].x * xv[m].x;
      ax += g.m[k][m].y * xv[m].y;
      ax += g.m[k][m].z * xv[m].z;
      ax += g.m[k][m].w * xv[m].w;
      ay += g.m[k][m].x * yv[m].x;
      ay += g.m[k][m].y * yv[m].y;
      ay += g.m[k][m].z * yv[m].z;
      ay += g.m[k][m].w * yv[m].w;
    }
    const int il = lane + 32 * k;
    if (il < Rp) {
      part_x[warp * Rp + il] = ax;
      part_y[warp * Rp + il] = ay;
    }
  }
}

// Row il's sum of the warps' partials, in warp order.
__device__ __forceinline__ float row_total(const float* part, int Rp,
                                           int il) {
  float acc = 0.f;
#pragma unroll
  for (int w = 0; w < kClusterWarps; ++w) acc += part[w * Rp + il];
  return acc;
}

// Column j's sum over the cluster: `count` partials a block at a stride of
// `stride` (the loop's one, the once-a-slate sums' teams), every block's in
// rank order, then in order (after the cluster barrier that follows the
// partials). The loads are issued together, then added in that order.
__device__ __forceinline__ float col_total(const cg::cluster_group& cluster,
                                           int csize, int count, int stride,
                                           const float* part, int j) {
  const int total = csize * count;
  float* base = const_cast<float*>(part) + j;
  float v[kMaxGather];
  int r = 0, g = 0;
#pragma unroll
  for (int q = 0; q < kMaxGather; ++q) {
    v[q] = q < total ? cluster.map_shared_rank(base, r)[g * stride] : 0.f;
    if (++g == count) {
      g = 0;
      ++r;
    }
  }
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < kMaxGather; ++q)
    if (q < total) acc += v[q];
  return acc;
}

// The once-a-slate column sums of a general f(il, j) in [team][P] partials:
// a warp takes 8 column quads (lane % 8) of its quad set and, with its four
// row lanes (lane / 8), every fourth row of its team's run of rows, the
// four row lanes' sums added across the warp; teams few enough that a
// cluster's column gathers at most kMaxGather partials.
struct ColLayout {
  int P, sets, teams, per;
};

__device__ __forceinline__ ColLayout col_layout(int L, int rows, int csize) {
  ColLayout cl;
  cl.P = round_up(L, 4);
  cl.sets = (cl.P / 4 + 7) / 8;
  cl.teams = max(1, min(kClusterWarps / cl.sets, kMaxGather / csize));
  cl.per = (rows + cl.teams - 1) / cl.teams;
  return cl;
}

template <class F>
__device__ __forceinline__ void col_partials(const ColLayout& cl, int rows,
                                             int L, F f, float* part) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int unit = warp; unit < cl.sets * cl.teams; unit += kClusterWarps) {
    const int set = unit % cl.sets, team = unit / cl.sets;
    const int quad = set * 8 + lane % 8, sub = lane / 8;
    const bool live = quad * 4 < cl.P;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const int i1 = min(rows, (team + 1) * cl.per);
    if (live) {
      for (int il = team * cl.per + sub; il < i1; il += 4) {
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if (quad * 4 + x < L) acc[x] += f(il, quad * 4 + x);
      }
    }
#pragma unroll
    for (int o = 8; o <= 16; o <<= 1)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        acc[x] += __shfl_xor_sync(0xffffffffu, acc[x], o);
    if (sub == 0 && live)
      reinterpret_cast<float4*>(part + team * cl.P)[quad] =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

// One warp's sum of f(j) over j < L (lanes along the row), on every lane.
template <class F>
__device__ __forceinline__ float row_sum(int L, F f) {
  const int lane = threadIdx.x % 32;
  float acc = 0.f;
  for (int j = lane; j < L; j += 32) acc += f(j);
  return warp_sum(acc);
}

// put(il, sum over j < L of f(il, j)) for the block's rows il < rows (the
// once-a-slate row sums): warp w owns w, w + 16, ..., sums four of its rows
// at once, each as row_sum would, and lane q puts the q-th of the four.
template <class F, class Put>
__device__ __forceinline__ void row_sums(int L, int rows, F f, Put put) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int il0 = warp; il0 < rows; il0 += 4 * kClusterWarps) {
    int il[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) il[q] = min(il0 + q * kClusterWarps, rows - 1);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = lane; j < L; j += 32) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] += f(il[q], j);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] = warp_sum(acc[q]);
    const float mine = lane == 0 ? acc[0] : lane == 1 ? acc[1]
                     : lane == 2 ? acc[2] : acc[3];
    if (lane < 4 && il0 + lane * kClusterWarps < rows)
      put(il0 + lane * kClusterWarps, mine);
  }
}


// With the records on chip (neuralsort_layout.cu), the backward keeps a and U
// for its rows [T + 1 | T, round8(R)] and b and V for every column [T + 1 |
// T, whole epilogue tiles] in the room of M0's rows, which the loop's
// registers hold, and needs no staging room.
__host__ __device__ constexpr int records_m0_room(int L, int csize, int T) {
  return imax(rows_per_block(L, csize) * round_up(L, 4),
              (2 * T + 1) * (round_up(rows_per_block(L, csize), 8) +
                             col_tiles(L) * kTileCols));
}
__host__ __device__ constexpr int records_bwd_room(int L, int csize) {
  return imax(loop_room(L, csize, true), 2 * tile_teams(L) * round_up(L, 4));
}

// M0[i][j] as chain_rows leaves it (the same logit, exponential and
// division: the same bits), from row i's largest logit and sum; j < L.
__device__ __forceinline__ float chain_value(const Chain& c, int i, int j,
                                             float tau, float z_max,
                                             float sum) {
  if (c.valid[i] < 0.5f) return c.valid[j] < 0.5f ? 1.f : 0.f;
  if (c.valid[j] < 0.5f) return 0.f;
  return expf(over_tau(c.scaling[i] * c.s_z[j] - c.rs[j], tau) - z_max) /
         sum;
}

// Each of the block's valid rows' largest logit, as chain_rows takes it (a
// maximum: the same value in any order), into zmax [rows].
__device__ __forceinline__ void row_max_logits(int L, float tau,
                                               const Chain& c,
                                               const Share& sh, float* zmax) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int il = warp; il < sh.rows; il += kClusterWarps) {
    const float sc = c.scaling[sh.r0 + il];
    float z_max = -INFINITY;
    for (int j = lane; j < L; j += 32)
      if (c.valid[j] > 0.5f)
        z_max = fmaxf(z_max, over_tau(sc * c.s_z[j] - c.rs[j], tau));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      z_max = fmaxf(z_max, __shfl_xor_sync(0xffffffffu, z_max, o));
    if (lane == 0) zmax[il] = z_max;
  }
}

cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int clusters,
                                  int csize, int bytes, cudaStream_t stream) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(clusters * csize);
  config.blockDim = dim3(kClusterThreads);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = csize;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}
cudaError_t launch(const void* kernel, int clusters, int csize, int bytes,
                   void* stream, void** args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = cluster_config(
      &attr, clusters, csize, bytes, static_cast<cudaStream_t>(stream));
  return cudaLaunchKernelExC(&config, kernel, args);
}

}  // namespace
}  // namespace allrank
