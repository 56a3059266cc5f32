// The fused NeuralNDCG soft-sort for Hopper (sm_90a), fp32, forward and
// backward, with M0 on chip: a slate's rows of M0 split across a
// thread-block cluster, each block's share held in its shared memory and,
// for the Sinkhorn loop, in its registers. B8's main route ("cluster");
// neuralsort.cu's kernels, which re-read M0 from L2, stay as route "l2".
//
// Replaces the TPU kernel `fused_soft_sort_contract` of the JAX package's
// ops/neuralsort_pallas.py:237 (forward pallas_call at line 186, backward at
// line 214; the chain in _chain, lines 51-84), whose point is M0 [L, L]
// resident in fast memory. The function is neuralsort.cu's (see there):
// NeuralSort relaxation -> T Sinkhorn iterations -> one contraction, the
// records a_hist, b_hist [N, T + 1, L] out of the forward and into the
// backward, ds [N, L] out of the backward. L <= 512.
//
// What bounds it: the latency of 2 T dependent matvecs on a slate's M0
// (1.5 GFLOP at N = 64, L = 240, T = 50: 22 us of the card's fp32 rate).
// Route "l2" runs each on one block per slate reading M0 from L2 (some 6.8
// us a half-iteration at L = 240, 64 of 132 SMs at N = 64); read from
// shared memory, M0 still costs a matvec some 900 cycles of the SM's 128
// bytes a clock at L = 240.
//
// Design. A block may hold 232,448 bytes of shared memory, and 240^2 fp32
// is 230,400: M0 goes to a cluster of C blocks, block `rank` holding the
// R = ceil(L / C) rows [rank R, rank R + R) of M0. C follows the registers
// (ops/neuralsort.py's cluster_plan): 512 threads a block hold its rows of
// M0 in registers during the loop, 64 floats a thread at most, with lane l
// on the rows l, l + 32, ... (KR of them) and warp w on KQ quads of columns
// from 4 KQ w on: (KR, KQ) = (8, 2) to L = 128 (C = 1), (4, 4) to 256 (C
// = 2: 128 blocks at N = 64, L = 240) and (2, 8) to 512 (C = 8). Each block
// keeps the O(L) vectors whole: the chain's, and the scaling b (all
// columns), beside a (its own rows).
//   M0^T a:  each lane sums its rows of its columns, and a halving
//            butterfly across the warp's lanes adds the rows up, one
//            column a lane at its end; each block stores its column sums
//            into every block's shared memory (distributed shared memory)
//            and, after one cluster barrier, every block adds the C blocks'
//            sums in rank order from its own, so every block computes the
//            same new b in full.
//   M0 b:    each lane sums its warp's columns of its rows; the 16 warps'
//            partial sums meet in shared memory, added in warp order.
// The column sums are double-buffered, so one cluster barrier an iteration
// suffices: a block writes buffer k & 1 only after the barrier that every
// block reaches once done reading exchange k - 2.
// The clusters walk the slates (N = 2,048 in the stochastic variant); the
// wrapper sizes the grid with cudaOccupancyMaxActiveClusters.
// The backward rebuilds M0's rows the same way, runs the reverse pass on
// them (U for its own rows, V for all columns, in a per-block scratch of
// device memory), and never writes dM0: it forms each dM0 element where it
// is used, from the stacks staged through shared memory 4 iterations at a
// time (cp.async into one buffer while the block reads the other), as an
// 8 x 4 register tile per thread (the FMA chain over t of neuralsort.cu's
// product), for the two column sums of the softmax cotangent, which go
// through the cluster as the once-a-slate sums do (each block reads the
// others' partials). The softmax's row sums inner_i = sum_j dM0_ij M0_ij
// need no pass over dM0: M0's rows times dM0's terms are the loop's own
// row sums (M0 V[t], and M0 b_hist[t] beside it), weighted by U and a_hist.
// Every sum is an fp32 FMA chain in a fixed order, every division a true
// division, expf; no TF32, no atomics: a second run gives the same bits.
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

template <int kKR, int kKQ>
__global__ void __launch_bounds__(kClusterThreads, 1)
    soft_sort_cluster_fwd_kernel(const float* __restrict__ s,
                                 const float* __restrict__ pad,
                                 const float* __restrict__ vec,
                                 float* __restrict__ out,
                                 float* __restrict__ a_hist,
                                 float* __restrict__ b_hist, int n, int L,
                                 int T, float tau, int transpose) {
  extern __shared__ float4 smem_base4[];
  cg::cluster_group cluster = cg::this_cluster();
  const Share sh = my_share(cluster, L);
  const int P = round_up(L, 4), R = rows_per_block(L, sh.csize);
  const int Rp = round_up(R, 4), X = imax(sh.csize * P, 512);
  const ColLayout cl = col_layout(L, sh.rows, sh.csize);
  float* smem = reinterpret_cast<float*>(smem_base4);
  float* M = take(smem, R * P);
  const Chain c = take_chain(smem, P);
  float* b = take(smem, P);
  float* a = take(smem, Rp);
  float* xch = take(smem, 2 * X);  // the exchanges, double-buffered
  float* rpart = take(smem, kClusterWarps * Rp);
  const int clusters = gridDim.x / sh.csize;
  const int tid = threadIdx.x;  // a thread a column, and a row: L <= 512
  int k = 0;  // the cluster's exchanges so far: the next one uses xch k & 1
  for (int slate = blockIdx.x / sh.csize; slate < n; slate += clusters) {
    const size_t o = (size_t)slate * L;
    chain_rows(s + o, pad + o, vec + o, L, tau, c, M, sh, a);
    MRegs<kKR, kKQ> g;
    load_regs(g, M, P, sh.rows);
    float* a_rec = a_hist + o * (T + 1);
    float* b_rec = b_hist + o * (T + 1);
    if (tid < sh.rows) {
      a[tid] = 1.f;
      a_rec[sh.r0 + tid] = 1.f;
    }
    if (tid < P) b[tid] = tid < L ? 1.f : 0.f;
    if (tid >= sh.r0 && tid < sh.r0 + sh.rows) b_rec[tid] = 1.f;
    __syncthreads();
    for (int t = 0; t < T; ++t) {
      // c = b * (M0^T a); b <- rescale: the cluster's column sums
      float* xk = xch + (k++ & 1) * X;
      col_dots(g, a, sh.rows, P, cluster, sh, xk);
      cluster.sync();
      if (tid < L) {
        const float cj = pushed_total(xk, sh.csize, P, tid);
        const float b2 = rescale(b[tid], b[tid] * cj);
        b[tid] = b2;
        if (tid >= sh.r0 && tid < sh.r0 + sh.rows)
          b_rec[(size_t)(t + 1) * L + tid] = b2;
      }
      __syncthreads();
      // r = a * (M0 b); a <- rescale: the block's own rows
      row_parts(g, b, P, Rp, rpart);
      __syncthreads();
      if (tid < sh.rows) {
        const float r = row_total(rpart, Rp, tid);
        const float a2 = rescale(a[tid], a[tid] * r);
        a[tid] = a2;
        a_rec[(size_t)(t + 1) * L + sh.r0 + tid] = a2;
      }
      __syncthreads();
    }
    // p = a (.) M0 (.) b masked to the valid pairs, contracted with vec
    if (transpose) {
      float* xk = xch + (k++ & 1) * X;
      col_partials(cl, sh.rows, L, [&](int il, int j) {
        const int i = sh.r0 + il;
        return a[il] * M[(size_t)il * P + j] * b[j] * pair_valid(c, i, j) *
               c.vec[i];
      }, xk);
      cluster.sync();
      if (tid >= sh.r0 && tid < sh.r0 + sh.rows)
        out[o + tid] = col_total(cluster, sh.csize, cl.teams, P, xk, tid);
    } else {
      row_sums(L, sh.rows, [&](int il, int j) {
        return a[il] * M[(size_t)il * P + j] * b[j] *
               pair_valid(c, sh.r0 + il, j) * c.vec[j];
      }, [&](int il, float r) { out[o + sh.r0 + il] = r; });
    }
    __syncthreads();
  }
  // no block leaves while another may still read its partials
  cluster.sync();
}

template <int kKR, int kKQ>
__global__ void __launch_bounds__(kClusterThreads, 1)
    soft_sort_cluster_bwd_kernel(const float* __restrict__ s,
                                 const float* __restrict__ pad,
                                 const float* __restrict__ vec,
                                 const float* __restrict__ a_hist,
                                 const float* __restrict__ b_hist,
                                 const float* __restrict__ dout,
                                 float* __restrict__ uv,
                                 float* __restrict__ ds, int n, int L, int T,
                                 float tau, int transpose) {
  extern __shared__ float4 smem_base4[];
  cg::cluster_group cluster = cg::this_cluster();
  const Share sh = my_share(cluster, L);
  const int P = round_up(L, 4), R = rows_per_block(L, sh.csize);
  const int Rp = round_up(R, 4), Rs = round_up(R, 8);
  const int X = imax(sh.csize * P, 512);
  const ColLayout cl = col_layout(L, sh.rows, sh.csize);
  float* smem = reinterpret_cast<float*>(smem_base4);
  float* M = take(smem, R * P);
  const Chain c = take_chain(smem, P);
  float* go = take(smem, P);
  float* b_t = take(smem, P);  // b_t in the loop, then b_T
  float* db = take(smem, P);
  float* v = take(smem, P);
  float* drs = take(smem, P);    // the cluster's column sums, all columns
  float* blk_z = take(smem, P);  // this block's column sums, read by all
  float* blk_r = take(smem, P);
  float* a_t = take(smem, Rp);  // a_t in the loop, then a_T
  float* da = take(smem, Rp);
  float* u = take(smem, Rp);
  float* inner = take(smem, Rp);
  float* room = take(smem, bwd_union(L, sh.csize));
  float* xch = room;                    // the loop's exchanges,
  float* rpart = room + 2 * X;          // its row sums' warp partials
  float* rpart_b = rpart + kClusterWarps * Rp;  // (M0 v, then M0 b_t)
  float* U = uv + (size_t)blockIdx.x * T * (Rs + L);  // [T, Rs]
  float* V = U + (size_t)T * Rs;                      // [T, L]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int clusters = gridDim.x / sh.csize;
  const int tid = threadIdx.x;  // a thread a column, and a row: L <= 512
  int k = 0;  // the cluster's exchanges so far: the next one uses xch k & 1
  for (int slate = blockIdx.x / sh.csize; slate < n; slate += clusters) {
    const size_t o = (size_t)slate * L;
    chain_rows(s + o, pad + o, vec + o, L, tau, c, M, sh, u);
    const float* a_rec = a_hist + o * (T + 1);
    const float* b_rec = b_hist + o * (T + 1);
    const float* a_T = a_rec + (size_t)T * L;
    const float* b_T = b_rec + (size_t)T * L;
    if (tid < L) {
      go[tid] = dout[o + tid];
      b_t[tid] = b_T[tid];
    } else if (tid < P) {
      v[tid] = 0.f;  // row_parts reads v and b_t by quads
      b_t[tid] = 0.f;
    }
    if (tid < sh.rows) a_t[tid] = a_T[sh.r0 + tid];
    __syncthreads();
    // the contraction's cotangent, gated by the mask after the scaling
    auto dp = [&](int i, int j) {
      return (transpose ? go[j] * c.vec[i] : go[i] * c.vec[j]) *
             pair_valid(c, i, j);
    };
    // dP -> (da_T, db_T) through P = a_T (.) M0 (.) b_T
    float* xk = xch + (k++ & 1) * X;
    col_partials(cl, sh.rows, L, [&](int il, int j) {
      return dp(sh.r0 + il, j) * M[(size_t)il * P + j] * a_t[il];
    }, xk);
    row_sums(L, sh.rows, [&](int il, int j) {
      return dp(sh.r0 + il, j) * M[(size_t)il * P + j] * b_t[j];
    }, [&](int il, float r) { da[il] = r; });
    MRegs<kKR, kKQ> g;
    load_regs(g, M, P, sh.rows);
    // M0 b_T, for the softmax's row sums below
    row_parts(g, b_t, P, Rp, rpart_b);
    cluster.sync();
    if (tid < L) db[tid] = col_total(cluster, sh.csize, cl.teams, P, xk, tid);
    // The softmax's row sums inner_i = sum_j dM0_ij M0_ij over the valid
    // pairs, taken from the stacks' terms as the loop makes them (dM0 =
    // dp (.) outer(a_T, b_T) + sum_t U[t] (x) b_hist[t + 1] + a_hist[t] (x)
    // V[t], and M0's rows vanish off the valid columns):
    //   inner_i = a_T,i D_i + sum_t U[t]_i (M0 b_hist[t + 1])_i
    //             + a_hist[t]_i (M0 V[t])_i,   D_i = sum_j dp_ij M0_ij b_T,j
    // with D the first da, and M0 b_hist[t + 1], M0 V[t] the loop's row
    // sums; a padded row's is 0.
    float rb = 0.f;  // this thread's row of M0 b_hist[t], t the next one
    if (tid < sh.rows) {
      inner[tid] = a_t[tid] * da[tid];
      rb = row_total(rpart_b, Rp, tid);
    }
    // a_t = a_prev / m_r,  r_t = a_prev * (M0 b_t): the block's rows, with
    // ap = a_prev = a_hist[t - 1][r0 + il]
    auto a_step = [&](int t, int il, float ap) {
      const float m_r = ap / a_t[il];
      const float mb = m_r / ap;
      const float d = da[il];
      const float dr = m_r > kClampGate ? -d * ap / (m_r * m_r) : 0.f;
      da[il] = d / m_r + dr * mb;
      const float uu = dr * ap;
      u[il] = uu;
      U[(size_t)(t - 1) * Rs + il] = uu;
      a_t[il] = ap;
    };
    if (tid < sh.rows) {
      a_step(T, tid, a_rec[(size_t)(T - 1) * L + sh.r0 + tid]);
      inner[tid] += u[tid] * rb;
    }
    __syncthreads();
    for (int t = T; t >= 1; --t) {
      // b_prev's and the next a_prev's loads in flight across the exchange
      const float bp = tid < L ? b_rec[(size_t)(t - 1) * L + tid] : 0.f;
      const float ap = tid < sh.rows && t > 1
                           ? a_rec[(size_t)(t - 2) * L + sh.r0 + tid]
                           : 0.f;
      xk = xch + (k++ & 1) * X;
      col_dots(g, u, sh.rows, P, cluster, sh, xk);
      cluster.sync();
      // b_t = b_prev / m_c,  c_t = b_prev * (M0^T a_prev): every column
      if (tid < L) {
        const float m_c = bp / b_t[tid];
        const float mta = m_c / bp;
        const float cot = db[tid] + pushed_total(xk, sh.csize, P, tid);
        const float dc = m_c > kClampGate ? -cot * bp / (m_c * m_c) : 0.f;
        db[tid] = cot / m_c + dc * mta;
        const float vv = dc * bp;
        v[tid] = vv;
        V[(size_t)(t - 1) * L + tid] = vv;
        b_t[tid] = bp;
      }
      __syncthreads();
      row_parts2(g, v, b_t, P, Rp, rpart, rpart_b);
      __syncthreads();
      if (tid < sh.rows) {
        // M0 V[t - 1] and M0 b_hist[t - 1] on this row
        const float rv = row_total(rpart, Rp, tid);
        da[tid] += rv;
        inner[tid] += a_t[tid] * rv;
        if (t > 1) {
          a_step(t - 1, tid, ap);
          inner[tid] += u[tid] * row_total(rpart_b, Rp, tid);
        }
      }
      __syncthreads();
    }
    if (tid < sh.rows && c.valid[sh.r0 + tid] < 0.5f) inner[tid] = 0.f;
    // every block is done reading the exchanges: `room` is free for the
    // epilogue's sums and stages
    cluster.sync();
    if (tid < L) b_t[tid] = b_T[tid];
    if (tid < sh.rows) a_t[tid] = a_T[sh.r0 + tid];
    // dM0 = dp (.) outer(a_T, b_T) + sum_t U[t] (x) b_hist[t + 1]
    // + a_hist[t] (x) V[t], an 8 x 128 tile a warp (columns lane + 32 q),
    // the warps in tile_teams(L) teams of whole column tiles; the stacks'
    // rows pass through shared memory kChunk iterations at a time
    const int ncc = col_tiles(L), teams = tile_teams(L);
    const int Ps = ncc * kTileCols;
    const int cc = warp % ncc, team = warp / ncc;
    const int row_tiles = (sh.rows + kTileRows - 1) / kTileRows;
    const int rounds = (row_tiles + teams - 1) / teams;
    float* stage = room;
    const int chunk_floats = kChunk * (2 * Rs + 2 * Ps);
    const int chunks = (T + kChunk - 1) / kChunk;
    // the chunk of iterations t0 .. t0 + kChunk - 1 into buffer `buf`: U
    // and a_hist's rows of the block [kChunk, Rs] each, b_hist a step on and
    // V [kChunk, Ps] each, zero past the block's rows, past L and past T
    auto issue = [&](int chunk, int buf) {
      float* su = stage + buf * chunk_floats;
      float* sa = su + kChunk * Rs;
      float* sb = sa + kChunk * Rs;
      float* sv = sb + kChunk * Ps;
      const int t0 = chunk * kChunk;
      for (int e = tid; e < kChunk * Rs; e += kClusterThreads) {
        const int st = e / Rs, r = e - st * Rs;
        const bool in = r < sh.rows && t0 + st < T;
        cp_async_4(su + e, in ? U + (size_t)(t0 + st) * Rs + r : U, in);
        cp_async_4(sa + e,
                   in ? a_rec + (size_t)(t0 + st) * L + sh.r0 + r : a_rec,
                   in);
      }
      for (int e = tid; e < kChunk * Ps; e += kClusterThreads) {
        const int st = e / Ps, j = e - st * Ps;
        const bool in = j < L && t0 + st < T;
        cp_async_4(sb + e, in ? b_rec + (size_t)(t0 + st + 1) * L + j : b_rec,
                   in);
        cp_async_4(sv + e, in ? V + (size_t)(t0 + st) * L + j : V, in);
      }
      cp_async_commit();
    };
    float colz[4] = {0.f, 0.f, 0.f, 0.f}, colr[4] = {0.f, 0.f, 0.f, 0.f};
    for (int round = 0; round < rounds; ++round) {
      const int rt = team + round * teams;
      const bool has = team < teams && rt < row_tiles;
      const int il0 = rt * kTileRows, j0 = cc * kTileCols + lane;
      float acc[kTileRows][4];
#pragma unroll
      for (int r = 0; r < kTileRows; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
      __syncthreads();  // the last round's readers are done
      issue(0, 0);
      for (int ch = 0; ch < chunks; ++ch) {
        if (ch + 1 < chunks) {
          issue(ch + 1, (ch + 1) & 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();  // chunk ch is in for every thread
        const float* su = stage + (ch & 1) * chunk_floats;
        const float* sa = su + kChunk * Rs;
        const float* sb = sa + kChunk * Rs;
        const float* sv = sb + kChunk * Ps;
        if (has) {
          for (int st = 0; st < kChunk; ++st) {
            float bq[4], vq[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              bq[q] = sb[st * Ps + j0 + 32 * q];
              vq[q] = sv[st * Ps + j0 + 32 * q];
            }
#pragma unroll
            for (int r = 0; r < kTileRows; ++r) {
              const float ur = su[st * Rs + il0 + r];
              const float ar = sa[st * Rs + il0 + r];
#pragma unroll
              for (int q = 0; q < 4; ++q)
                acc[r][q] = fmaf(ar, vq[q], fmaf(ur, bq[q], acc[r][q]));
            }
          }
        }
        __syncthreads();  // before chunk ch + 2 lands in this buffer
      }
      if (!has) continue;
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) {
        const int il = il0 + r;
        if (il >= sh.rows) continue;
        const int i = sh.r0 + il;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + 32 * q;
          if (j >= L) continue;
          // softmax over the row: P_hat = M0, dP_hat = dM0 on the valid
          // pairs (the pad fills are constants)
          const float pv = pair_valid(c, i, j);
          const float dm = dp(i, j) * a_t[il] * b_t[j] + acc[r][q];
          const float dpm = over_tau((dm * pv - inner[il]) *
                                         M[(size_t)il * P + j], tau) * pv;
          colz[q] += dpm * c.scaling[i];
          colr[q] += -dpm;
        }
      }
    }
    __syncthreads();
    if (team < teams) {
      float* colpart_z = room;
      float* colpart_r = room + teams * P;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = cc * kTileCols + lane + 32 * q;
        if (j < L) {
          colpart_z[team * P + j] = colz[q];
          colpart_r[team * P + j] = colr[q];
        }
      }
    }
    __syncthreads();
    if (tid < L) {
      float z = 0.f, r = 0.f;
      for (int q = 0; q < teams; ++q) {
        z += room[q * P + tid];
        r += room[(teams + q) * P + tid];
      }
      blk_z[tid] = z;
      blk_r[tid] = r;
    }
    cluster.sync();
    if (tid < L) {
      float r = 0.f;
      for (int q = 0; q < sh.csize; ++q)
        r += cluster.map_shared_rank(blk_r, q)[tid];
      drs[tid] = r;
    }
    __syncthreads();
    // rs[j] = sum_k |s_f[j] - s_f[k]| over valid pairs: ds for the block's
    // share of the documents, j = r0 .. r0 + rows - 1
    for (int jl = warp; jl < sh.rows; jl += kClusterWarps) {
      const int j = sh.r0 + jl;
      const float sgn_sum = row_sum(L, [&](int kk) {
        return sign_of(c.s_f[j] - c.s_f[kk]) * pair_valid(c, j, kk);
      });
      const float drs_sgn = row_sum(L, [&](int kk) {
        return drs[kk] * (sign_of(c.s_f[kk] - c.s_f[j]) * pair_valid(c, kk, j));
      });
      if (lane == 0) {
        float z = 0.f;
        for (int q = 0; q < sh.csize; ++q)
          z += cluster.map_shared_rank(blk_z, q)[j];
        ds[o + j] = (z + (drs[j] * sgn_sum - drs_sgn)) * c.valid[j];
      }
    }
    // every block's column sums stay in place until the cluster has read
    // them
    cluster.sync();
  }
}

// The kernel of the register shape that length L takes.
template <bool kBackward>
const void* kernel_for(int L) {
  if (L <= 128)
    return kBackward ? (const void*)soft_sort_cluster_bwd_kernel<8, 2>
                     : (const void*)soft_sort_cluster_fwd_kernel<8, 2>;
  if (L <= 256)
    return kBackward ? (const void*)soft_sort_cluster_bwd_kernel<4, 4>
                     : (const void*)soft_sort_cluster_fwd_kernel<4, 4>;
  return kBackward ? (const void*)soft_sort_cluster_bwd_kernel<2, 8>
                   : (const void*)soft_sort_cluster_fwd_kernel<2, 8>;
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

// 0, or the reason a launch cannot take these sizes
cudaError_t check_plan(int n, int L, int T, int csize, int bytes,
                       bool backward) {
  if (n < 1 || L < 1 || L > kMaxClusterL || T < 1 ||
      csize != cluster_blocks(L) || bytes > 232448 ||
      (long long)bytes < 4LL * smem_floats(L, csize, backward))
    return cudaErrorInvalidValue;
  return cudaSuccess;
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

// The blocks of a cluster at length L (1 to L = 128, 2 to 256, 8 to 512)
// and the floats of shared memory a block of the forward (backward = 0) or
// backward takes there.
extern "C" int soft_sort_cluster_blocks(int L) {
  return allrank::cluster_blocks(L);
}
extern "C" int soft_sort_cluster_floats(int L, int cluster, int backward) {
  return allrank::smem_floats(L, cluster, backward != 0);
}

// The clusters of `cluster` blocks with `bytes` of shared memory each that
// the card holds at once for the forward (backward = 0) or backward kernel
// of length L, or minus the CUDA error code.
extern "C" int soft_sort_cluster_occupancy(int backward, int L, int cluster,
                                           int bytes) {
  using namespace allrank;
  const void* kernel =
      backward ? kernel_for<true>(L) : kernel_for<false>(L);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config = cluster_config(&attr, 1, cluster, bytes, 0);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  return err == cudaSuccess ? clusters : -(int)err;
}

// Forward on `stream`: out [n, L], a_hist, b_hist [n, T + 1, L] from s, pad
// (1 = padded), vec [n, L], all fp32; `clusters` clusters of `cluster`
// blocks with `bytes` of shared memory each. Returns 0 or the CUDA error
// code.
extern "C" int soft_sort_cluster_fwd(const void* s, const void* pad,
                                     const void* vec, void* out,
                                     void* a_hist, void* b_hist, int n,
                                     int L, int T, float tau, int transpose,
                                     int cluster, int bytes, int clusters,
                                     void* stream) {
  using namespace allrank;
  cudaError_t err = check_plan(n, L, T, cluster, bytes, false);
  if (err == cudaSuccess && clusters < 1) err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  void* args[] = {&s, &pad, &vec, &out, &a_hist, &b_hist, &n, &L, &T, &tau,
                  &transpose};
  return launch(kernel_for<false>(L), clusters, cluster, bytes, stream,
                args);
}

// Backward on `stream`: ds [n, L] from the forward's inputs and records and
// dout [n, L]; uv holds [clusters * cluster, T, round8(ceil(L / cluster))
// + L] floats (each block's U and V stacks).
extern "C" int soft_sort_cluster_bwd(const void* s, const void* pad,
                                     const void* vec, const void* a_hist,
                                     const void* b_hist, const void* dout,
                                     void* uv, void* ds, int n, int L, int T,
                                     float tau, int transpose, int cluster,
                                     int bytes, int clusters, void* stream) {
  using namespace allrank;
  cudaError_t err = check_plan(n, L, T, cluster, bytes, true);
  if (err == cudaSuccess && clusters < 1) err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  void* args[] = {&s, &pad, &vec, &a_hist, &b_hist, &dout, &uv, &ds,
                  &n, &L, &T, &tau, &transpose};
  return launch(kernel_for<true>(L), clusters, cluster, bytes, stream, args);
}
