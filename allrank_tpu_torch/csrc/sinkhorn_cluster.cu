// Fixed-trip Sinkhorn scaling for Hopper (sm_90a), fp32, forward and
// backward, with a slate's M0 on chip: its rows split across a thread-block
// cluster, each block's share in its shared memory for the whole loop. B7's
// main route ("cluster"); sinkhorn.cu's kernels, one block a slate that
// re-reads M0 from L2, stay as route "l2".
//
// Replaces the TPU kernel `sinkhorn_core_fused` of the JAX package's
// ops/sinkhorn_pallas.py:275 (forward pallas_call at line 286, backward at
// line 325; the loop at :88, the reverse pass at :152), whose point is M0
// [L, L] resident in fast memory. The function is sinkhorn.cuh's: P =
// diag(a_T) M0 diag(b_T) and the records a_hist, b_hist [N, T + 1, L] out
// of the forward, dM0 [N, L, L] out of the backward. L <= 768.
//
// What bounds it: the latency of 2 T dependent matvecs on a slate's M0.
// The work is small (0.66 GFLOP forward at N = 8, L = 640, T = 50: 10 us of
// an H100's fp32 rate; 26 MB of M0 in and P out, 8 us); route "l2" takes
// 2.2 ms there on an H100, 8 blocks on 132 SMs each re-reading 1.6 MB from
// L2 on every half-iteration. Here each matvec reads the block's rows of M0
// from shared memory; an iteration also pays the pull and a cluster
// barrier.
//
// Design. M0 [L, L] fp32 is 1.6 MB at L = 640, a block may hold 232,448
// bytes: a cluster of C blocks (ops/sinkhorn.py's cluster_plan: the
// smallest power of two whose blocks fit, 8 at L = 640 and 16 at 768; the
// card holds 15 clusters of 8 at once and 7 of 16) takes the slate, block
// `rank` holding the R = ceil(L / C) rows [rank R, rank R + R) of M0
// (204,800 bytes at L = 640, 147,456 at 768), and the same share of the
// columns for the records. A block of 1024 threads keeps b whole (all
// columns) and a for its own rows. Each half-iteration:
//   M0^T a:  the block's column sums over its rows, its threads on column
//            quads by groups of rows, the groups' partials added in group
//            order, published in the block's own shared memory; after one
//            cluster barrier every block pulls the C blocks' partials of
//            every column through distributed shared memory and adds them
//            in rank order, so every block computes the same new b in full.
//   M0 b:    a warp a row of the block's own, lanes on column quads: local.
// The published partials are double-buffered (2 L floats: the pull keeps
// the exchange small where a push into every block would take 2 C L), so
// one cluster barrier an iteration suffices: a block writes buffer k & 1
// only after the barrier that every block reaches once done reading
// exchange k - 2.
// The backward runs the reverse pass on the same split: U for the block's
// rows, V for every column (each block computes all of V, as b; it stores
// its share), both in a per-cluster scratch of device memory; dP enters
// twice, for da_T and db_T and for the epilogue dM0 = dP a_T b_T + sum_t
// U_t (x) b_t + a_{t-1} (x) V_t, which each block writes for its own rows,
// from the stacks staged through the shared memory that held M0 (the
// epilogue needs M0 no more), 4 x 4 outputs a thread.
// The clusters walk the slates; the wrapper sizes the grid with
// cudaOccupancyMaxActiveClusters. Every sum is an fp32 FMA chain in a fixed
// order, every division a true division; no TF32, no atomics: a second run
// gives the same bits.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "sinkhorn.cuh"

namespace cg = cooperative_groups;

namespace allrank {
namespace {

constexpr int kClThreads = 1024;  // 32 warps, 64 registers a thread
constexpr int kClWarps = kClThreads / 32;
constexpr int kClMaxL = 768;
constexpr int kClMaxCluster = 16;  // the pull's partials of a column
constexpr int kClRowQuads = 6;     // x's quads a lane holds: P <= 768
constexpr int kEpiCols = 128;      // a warp's epilogue tile: 4 x 128
constexpr int kClSmemBytes = 232448;

__host__ __device__ constexpr int cl_round_up(int n, int m) {
  return (n + m - 1) / m * m;
}
__host__ __device__ constexpr int cl_max(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int cl_min(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int sink_rows(int L, int csize) {
  return (L + csize - 1) / csize;
}
// the row groups of a column pass: a thread a column quad and group, at
// most one pass of the block's threads, at most one group a row
__host__ __device__ constexpr int sink_groups(int L, int csize) {
  return cl_max(1, cl_min(kClThreads / (cl_round_up(L, 4) / 4),
                          sink_rows(L, csize)));
}
// the room that holds the block's rows of M0 and, in the backward's
// epilogue, the staged stacks (at least one iteration of them)
__host__ __device__ constexpr int sink_room(int L, int csize) {
  return cl_max(sink_rows(L, csize) * cl_round_up(L, 4),
                2 * (cl_round_up(L, 4) + cl_round_up(sink_rows(L, csize), 4)));
}
// Floats of shared memory a block takes (ops/sinkhorn.py's
// cluster_smem_floats mirrors this): its rows of M0 at a pitch of L rounded
// up to 4 (16-byte rows), the group partials of a column pass (in the
// backward also v, which is live only while they are not), two published
// buffers, the vectors of all columns (forward b; backward b_t, db) and of
// the block's rows (forward a; backward a_t, da, u).
__host__ __device__ constexpr int sink_smem_floats(int L, int csize,
                                                   bool backward) {
  return sink_room(L, csize) +
         (sink_groups(L, csize) + 2 + (backward ? 2 : 1)) * cl_round_up(L, 4) +
         (backward ? 3 : 1) * cl_round_up(sink_rows(L, csize), 4);
}
// the blocks of a cluster at length L: the smallest power of two whose
// blocks' shares fit the shared memory, both directions (fewer blocks, less
// exchange: 8 at L = 640, 16 at 768)
__host__ __device__ constexpr int sink_cluster_blocks(int L) {
  int csize = 1;
  while (csize < kClMaxCluster &&
         4 * cl_max(sink_smem_floats(L, csize, false),
                    sink_smem_floats(L, csize, true)) > kClSmemBytes)
    csize *= 2;
  return csize;
}

struct SinkShare {  // this block's rows (and share of the columns)
  int rank, csize, r0, rows, R, P, G;
};

__device__ __forceinline__ SinkShare sink_share(const cg::cluster_group& cl,
                                                int L) {
  SinkShare sh;
  sh.rank = (int)cl.block_rank();
  sh.csize = (int)cl.num_blocks();
  sh.R = sink_rows(L, sh.csize);
  sh.r0 = min(L, sh.rank * sh.R);
  sh.rows = min(L, sh.r0 + sh.R) - sh.r0;
  sh.P = cl_round_up(L, 4);
  sh.G = sink_groups(L, sh.csize);
  return sh;
}

// The block's rows of m0 [L, L] (device memory) into M [rows, P], the
// columns from L to P zero.
__device__ __forceinline__ void load_rows(const float* m0, int L,
                                          const SinkShare& sh, float* M) {
  const float* src = m0 + (size_t)sh.r0 * L;
  for (int e = threadIdx.x; e < sh.rows * sh.P; e += kClThreads) {
    const int il = e / sh.P, j = e - il * sh.P;
    M[e] = j < L ? src[(size_t)il * L + j] : 0.f;
  }
}

// cpart[g][j] = the sum over the rows il of group g of f(il, quad) (a
// float4 of columns 4 quad .. 4 quad + 3), rows in order; thread (g, quad).
template <class F>
__device__ __forceinline__ void col_groups(const SinkShare& sh, F f,
                                           float* cpart) {
  const int Q = sh.P / 4, per = (sh.R + sh.G - 1) / sh.G;
  const int t = threadIdx.x;
  if (t < sh.G * Q) {
    const int g = t / Q, q = t - g * Q;
    const int i1 = min(sh.rows, (g + 1) * per);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int il = g * per; il < i1; ++il) {
      const float4 v = f(il, q);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    reinterpret_cast<float4*>(cpart + g * sh.P)[q] = acc;
  }
}

// M[il][quad] * w[il], the column pass's term of M0^T w
__device__ __forceinline__ float4 scaled_quad(const float* M, int P, int il,
                                              int q, float w) {
  const float4 m = reinterpret_cast<const float4*>(M + (size_t)il * P)[q];
  return make_float4(m.x * w, m.y * w, m.z * w, m.w * w);
}

// The block's column sums (its groups' partials in group order) into its
// published buffer `pub` (after the barrier that follows col_groups).
__device__ __forceinline__ void publish(const SinkShare& sh,
                                        const float* cpart, float* pub) {
  for (int j = threadIdx.x; j < sh.P; j += kClThreads) {
    float acc = 0.f;
    for (int g = 0; g < sh.G; ++g) acc += cpart[g * sh.P + j];
    pub[j] = acc;
  }
}

// Column j's sum over the cluster: every block's published partial, in rank
// order (after the cluster barrier that follows the publishing). The loads
// are issued together, then added in that order.
__device__ __forceinline__ float pulled(const cg::cluster_group& cl,
                                        int csize, const float* pub, int j) {
  float* at = const_cast<float*>(pub) + j;
  float v[kClMaxCluster];
#pragma unroll
  for (int r = 0; r < kClMaxCluster; ++r)
    v[r] = r < csize ? *cl.map_shared_rank(at, r) : 0.f;
  float acc = 0.f;
#pragma unroll
  for (int r = 0; r < kClMaxCluster; ++r)
    if (r < csize) acc += v[r];
  return acc;
}

// put(il, sum over j < P of M[il][j] * x[j]) for the block's rows: a warp a
// row, lanes on column quads (x's in registers, read once a warp), the
// lanes' sums added across the warp (x zero from L to P).
template <class Put>
__device__ __forceinline__ void row_pass(const SinkShare& sh, const float* M,
                                         const float* x, Put put) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= sh.rows) return;
  const int Q = sh.P / 4;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4 xv[kClRowQuads];
#pragma unroll
  for (int m = 0; m < kClRowQuads; ++m) {
    const int q = lane + 32 * m;
    xv[m] = q < Q ? x4[q] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int il = warp; il < sh.rows; il += kClWarps) {
    const float4* m4 = reinterpret_cast<const float4*>(M + (size_t)il * sh.P);
    float acc = 0.f;
#pragma unroll
    for (int m = 0; m < kClRowQuads; ++m) {
      const int q = lane + 32 * m;
      if (q < Q) {
        const float4 v = m4[q];
        acc += v.x * xv[m].x;
        acc += v.y * xv[m].y;
        acc += v.z * xv[m].z;
        acc += v.w * xv[m].w;
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) put(il, acc);
  }
}

__global__ void __launch_bounds__(kClThreads, 1)
    sinkhorn_cluster_fwd_kernel(const float* __restrict__ m0,
                                float* __restrict__ p,
                                float* __restrict__ a_hist,
                                float* __restrict__ b_hist, int n, int L,
                                int T) {
  extern __shared__ float4 sink_smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const SinkShare sh = sink_share(cluster, L);
  const int P = sh.P;
  float* smem = reinterpret_cast<float*>(sink_smem4);
  float* M = take(smem, sink_room(L, sh.csize));
  float* cpart = take(smem, sh.G * P);
  float* pub = take(smem, 2 * P);  // the published partials, two buffers
  float* b = take(smem, P);
  float* a = take(smem, cl_round_up(sh.R, 4));
  const int clusters = gridDim.x / sh.csize;
  const int tid = threadIdx.x;  // a thread a column, and a row: L <= 1024
  const bool own_col = tid >= sh.r0 && tid < sh.r0 + sh.rows;
  int k = 0;  // the cluster's exchanges so far: the next one uses pub k & 1
  for (int slate = blockIdx.x / sh.csize; slate < n; slate += clusters) {
    const size_t o = (size_t)slate * L;
    load_rows(m0 + o * L, L, sh, M);
    float* a_rec = a_hist + o * (T + 1);
    float* b_rec = b_hist + o * (T + 1);
    if (tid < sh.rows) {
      a[tid] = 1.f;
      a_rec[sh.r0 + tid] = 1.f;
    }
    if (tid < P) b[tid] = tid < L ? 1.f : 0.f;
    if (own_col) b_rec[tid] = 1.f;
    __syncthreads();
    for (int t = 0; t < T; ++t) {
      // c = b * (M0^T a); b <- rescale: the cluster's column sums
      float* pk = pub + (k++ & 1) * P;
      col_groups(sh, [&](int il, int q) {
        return scaled_quad(M, P, il, q, a[il]);
      }, cpart);
      __syncthreads();
      publish(sh, cpart, pk);
      cluster.sync();
      if (tid < L) {
        const float cj = pulled(cluster, sh.csize, pk, tid);
        const float b2 = rescale(b[tid], b[tid] * cj);
        b[tid] = b2;
        if (own_col) b_rec[(size_t)(t + 1) * L + tid] = b2;
      }
      __syncthreads();
      // r = a * (M0 b); a <- rescale: the block's own rows
      row_pass(sh, M, b, [&](int il, float r) {
        const float a2 = rescale(a[il], a[il] * r);
        a[il] = a2;
        a_rec[(size_t)(t + 1) * L + sh.r0 + il] = a2;
      });
      __syncthreads();
    }
    // P = a (.) M0 (.) b on the block's rows
    float* out = p + (o + sh.r0) * L;
    for (int e = tid; e < sh.rows * L; e += kClThreads) {
      const int il = e / L, j = e - il * L;
      out[e] = a[il] * M[(size_t)il * P + j] * b[j];
    }
    __syncthreads();
  }
  // no block leaves while another may still read its partials
  cluster.sync();
}

__global__ void __launch_bounds__(kClThreads, 1)
    sinkhorn_cluster_bwd_kernel(const float* __restrict__ m0,
                                const float* __restrict__ a_hist,
                                const float* __restrict__ b_hist,
                                const float* __restrict__ dp, float* uv,
                                float* __restrict__ dm0, int n, int L,
                                int T) {
  extern __shared__ float4 sink_smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const SinkShare sh = sink_share(cluster, L);
  const int P = sh.P, Rp = cl_round_up(sh.R, 4);
  float* smem = reinterpret_cast<float*>(sink_smem4);
  const int room = sink_room(L, sh.csize);
  float* M = take(smem, room);  // M0's rows; the epilogue's stages
  float* cpart = take(smem, sh.G * P);
  float* v = cpart;  // written after the partials are published, read before
                     // the next column pass
  float* pub = take(smem, 2 * P);
  float* b_t = take(smem, P);  // b_t in the loop, then b_T
  float* db = take(smem, P);
  float* a_t = take(smem, Rp);  // a_t in the loop, then a_T
  float* da = take(smem, Rp);
  float* u = take(smem, Rp);
  // the cluster's stacks, U for every row and V for every column [T, L]
  // each: each block writes its share of both
  const int cid = blockIdx.x / sh.csize, clusters = gridDim.x / sh.csize;
  float* U = uv + (size_t)cid * 2 * T * L;
  float* V = U + (size_t)T * L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tid = threadIdx.x;
  const bool own_col = tid >= sh.r0 && tid < sh.r0 + sh.rows;
  int k = 0;
  for (int slate = blockIdx.x / sh.csize; slate < n; slate += clusters) {
    const size_t o = (size_t)slate * L;
    load_rows(m0 + o * L, L, sh, M);
    const float* a_rec = a_hist + o * (T + 1);
    const float* b_rec = b_hist + o * (T + 1);
    const float* a_T = a_rec + (size_t)T * L;
    const float* b_T = b_rec + (size_t)T * L;
    const float* d = dp + (o + sh.r0) * L;  // dP's rows of the block
    if (tid < P) b_t[tid] = tid < L ? b_T[tid] : 0.f;
    if (tid < sh.rows) a_t[tid] = a_T[sh.r0 + tid];
    __syncthreads();
    // dP -> (da_T, db_T) through P = a_T (.) M0 (.) b_T
    float* pk = pub + (k++ & 1) * P;
    col_groups(sh, [&](int il, int q) {
      float x[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = 4 * q + c;
        x[c] = j < L ? d[(size_t)il * L + j] * M[(size_t)il * P + j] * a_t[il]
                     : 0.f;
      }
      return make_float4(x[0], x[1], x[2], x[3]);
    }, cpart);
    for (int il = warp; il < sh.rows; il += kClWarps) {
      float acc = 0.f;
      for (int j = lane; j < L; j += 32)
        acc += d[(size_t)il * L + j] * M[(size_t)il * P + j] * b_t[j];
      acc = warp_sum(acc);
      if (lane == 0) da[il] = acc;
    }
    __syncthreads();
    publish(sh, cpart, pk);
    cluster.sync();
    if (tid < P) db[tid] = tid < L ? pulled(cluster, sh.csize, pk, tid) : 0.f;
    // a_t = a_prev / m_r,  r_t = a_prev * (M0 b_t): the block's rows, with
    // ap = a_prev = a_hist[t - 1][r0 + il]
    auto a_step = [&](int t, int il, float ap) {
      const float m_r = ap / a_t[il];
      const float mb = m_r / ap;
      const float dd = da[il];
      const float dr = m_r > kClampGate ? -dd * ap / (m_r * m_r) : 0.f;
      da[il] = dd / m_r + dr * mb;
      const float uu = dr * ap;
      u[il] = uu;
      U[(size_t)(t - 1) * L + sh.r0 + il] = uu;
      a_t[il] = ap;
    };
    __syncthreads();
    if (tid < sh.rows) a_step(T, tid, a_rec[(size_t)(T - 1) * L + sh.r0 + tid]);
    __syncthreads();
    for (int t = T; t >= 1; --t) {
      // b_prev's and the next a_prev's loads in flight across the exchange
      const float bp = tid < L ? b_rec[(size_t)(t - 1) * L + tid] : 0.f;
      const float ap = tid < sh.rows && t > 1
                           ? a_rec[(size_t)(t - 2) * L + sh.r0 + tid]
                           : 0.f;
      pk = pub + (k++ & 1) * P;
      col_groups(sh, [&](int il, int q) {
        return scaled_quad(M, P, il, q, u[il]);
      }, cpart);
      __syncthreads();
      publish(sh, cpart, pk);
      cluster.sync();
      // b_t = b_prev / m_c,  c_t = b_prev * (M0^T a_prev): every column
      if (tid < L) {
        const float m_c = bp / b_t[tid];
        const float mta = m_c / bp;
        const float cot = db[tid] + pulled(cluster, sh.csize, pk, tid);
        const float dc = m_c > kClampGate ? -cot * bp / (m_c * m_c) : 0.f;
        db[tid] = cot / m_c + dc * mta;
        const float vv = dc * bp;
        v[tid] = vv;
        if (own_col) V[(size_t)(t - 1) * L + tid] = vv;
        b_t[tid] = bp;
      } else if (tid < P) {
        v[tid] = 0.f;  // the row pass reads v by quads
      }
      __syncthreads();
      row_pass(sh, M, v, [&](int il, float r) { da[il] += r; });
      __syncthreads();
      if (t > 1) {
        if (tid < sh.rows) a_step(t - 1, tid, ap);
        __syncthreads();
      }
    }
    // every block's shares of U and V are in device memory and every block
    // is done with M0: the epilogue reads the cluster's stacks
    __threadfence();
    cluster.sync();
    if (tid < P) b_t[tid] = tid < L ? b_T[tid] : 0.f;
    if (tid < sh.rows) a_t[tid] = a_T[sh.r0 + tid];
    // dM0 = dP (.) outer(a_T, b_T) + sum_s U[s] (x) b_hist[s + 1]
    // + a_hist[s] (x) V[s] on the block's rows: a warp a 4 x 128 tile
    // (lane on 4 columns), the stacks staged S iterations at a time: U and
    // a_hist's rows of the block [S, Rp] each, b_hist a step on and V [S, P]
    // each, zero past the block's rows, past L and past T
    const int S = room / (2 * (P + Rp));
    float* su = M;
    float* sa = su + S * Rp;
    float* sb = sa + S * Rp;
    float* sv = sb + S * P;
    const int ct_n = (P + kEpiCols - 1) / kEpiCols;
    const int tiles = (sh.rows + 3) / 4 * ct_n;
    for (int first = 0; first < tiles; first += kClWarps) {
      const int tile = first + warp;
      const bool has = tile < tiles;
      const int il0 = (tile / ct_n) * 4;
      const int j0 = (tile % ct_n) * kEpiCols + 4 * lane;
      const bool live = has && j0 < P;
      float acc[4][4] = {};
      for (int s0 = 0; s0 < T; s0 += S) {
        __syncthreads();  // the last chunk's readers are done
        for (int e = tid; e < S * P; e += kClThreads) {
          const int sc = e / P, j = e - sc * P, s = s0 + sc;
          const bool in = s < T && j < L;
          sb[e] = in ? b_rec[(size_t)(s + 1) * L + j] : 0.f;
          sv[e] = in ? __ldcg(V + (size_t)s * L + j) : 0.f;
        }
        for (int e = tid; e < S * Rp; e += kClThreads) {
          const int sc = e / Rp, il = e - sc * Rp, s = s0 + sc;
          const bool in = s < T && il < sh.rows;
          su[e] = in ? __ldcg(U + (size_t)s * L + sh.r0 + il) : 0.f;
          sa[e] = in ? a_rec[(size_t)s * L + sh.r0 + il] : 0.f;
        }
        __syncthreads();
        if (live) {
          const int steps = min(S, T - s0);
          for (int sc = 0; sc < steps; ++sc) {
            const float4 u4 =
                reinterpret_cast<const float4*>(su + sc * Rp)[il0 / 4];
            const float4 a4 =
                reinterpret_cast<const float4*>(sa + sc * Rp)[il0 / 4];
            const float4 b4 =
                reinterpret_cast<const float4*>(sb + sc * P)[j0 / 4];
            const float4 v4 =
                reinterpret_cast<const float4*>(sv + sc * P)[j0 / 4];
            const float ur[4] = {u4.x, u4.y, u4.z, u4.w};
            const float ar[4] = {a4.x, a4.y, a4.z, a4.w};
            const float bc[4] = {b4.x, b4.y, b4.z, b4.w};
            const float vc[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                acc[r][c] = fmaf(ar[r], vc[c], fmaf(ur[r], bc[c], acc[r][c]));
          }
        }
      }
      if (!live) continue;
      float* out = dm0 + (o + sh.r0) * L;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int il = il0 + r;
        if (il >= sh.rows) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j0 + c;
          if (j < L)
            out[(size_t)il * L + j] =
                d[(size_t)il * L + j] * a_t[il] * b_t[j] + acc[r][c];
        }
      }
    }
    __syncthreads();  // before the next slate's rows land in M
  }
  cluster.sync();
}

cudaLaunchConfig_t sink_config(cudaLaunchAttribute* attr, int clusters,
                               int csize, int bytes, cudaStream_t stream) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(clusters * csize);
  config.blockDim = dim3(kClThreads);
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

// the attributes a launch of `csize`-block clusters with `bytes` of shared
// memory a block needs (a cluster of 16 is beyond the portable 8)
cudaError_t sink_prepare(const void* kernel, int csize, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && csize > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// 0, or the reason a launch cannot take these sizes
cudaError_t sink_check(int n, int L, int T, int csize, int bytes,
                       int clusters, bool backward) {
  if (n < 1 || L < 1 || L > kClMaxL || T < 1 || csize < 1 ||
      csize > kClMaxCluster || clusters < 1 || bytes > kClSmemBytes ||
      (long long)bytes < 4LL * sink_smem_floats(L, csize, backward))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

cudaError_t sink_launch(const void* kernel, int clusters, int csize,
                        int bytes, void* stream, void** args) {
  cudaError_t err = sink_prepare(kernel, csize, bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = sink_config(
      &attr, clusters, csize, bytes, static_cast<cudaStream_t>(stream));
  return cudaLaunchKernelExC(&config, kernel, args);
}

const void* sink_kernel(bool backward) {
  return backward ? (const void*)sinkhorn_cluster_bwd_kernel
                  : (const void*)sinkhorn_cluster_fwd_kernel;
}

}  // namespace
}  // namespace allrank

// The blocks of a cluster at length L (the smallest power of two whose
// blocks fit: 8 at L = 640, 16 at 768) and the floats of shared memory a
// block of the forward (backward = 0) or backward takes with `cluster`
// blocks a cluster.
extern "C" int sinkhorn_cluster_blocks(int L) {
  return allrank::sink_cluster_blocks(L);
}
extern "C" int sinkhorn_cluster_floats(int L, int cluster, int backward) {
  return allrank::sink_smem_floats(L, cluster, backward != 0);
}

// The clusters of `cluster` blocks with `bytes` of shared memory each that
// the card holds at once for the forward (backward = 0) or backward kernel,
// or minus the CUDA error code.
extern "C" int sinkhorn_cluster_occupancy(int backward, int cluster,
                                          int bytes) {
  using namespace allrank;
  const void* kernel = sink_kernel(backward != 0);
  cudaError_t err = sink_prepare(kernel, cluster, bytes);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config = sink_config(&attr, 1, cluster, bytes, 0);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  return err == cudaSuccess ? clusters : -(int)err;
}

// Forward on `stream`: p [n, L, L], a_hist, b_hist [n, T + 1, L] from m0
// [n, L, L], all fp32; `clusters` clusters of `cluster` blocks with `bytes`
// of shared memory each walk the slates. Returns 0 or the CUDA error code.
extern "C" int sinkhorn_cluster_fwd(const void* m0, void* p, void* a_hist,
                                    void* b_hist, int n, int L, int T,
                                    int cluster, int bytes, int clusters,
                                    void* stream) {
  using namespace allrank;
  const cudaError_t err = sink_check(n, L, T, cluster, bytes, clusters, false);
  if (err != cudaSuccess) return err;
  void* args[] = {&m0, &p, &a_hist, &b_hist, &n, &L, &T};
  return sink_launch(sink_kernel(false), clusters, cluster, bytes, stream,
                     args);
}

// Backward on `stream`: dm0 [n, L, L] from m0, the records and dp [n, L, L];
// uv holds [clusters, 2, T, L] floats (each cluster's U and V stacks).
extern "C" int sinkhorn_cluster_bwd(const void* m0, const void* a_hist,
                                    const void* b_hist, const void* dp,
                                    void* uv, void* dm0, int n, int L, int T,
                                    int cluster, int bytes, int clusters,
                                    void* stream) {
  using namespace allrank;
  const cudaError_t err = sink_check(n, L, T, cluster, bytes, clusters, true);
  if (err != cudaSuccess) return err;
  void* args[] = {&m0, &a_hist, &b_hist, &dp, &uv, &dm0, &n, &L, &T};
  return sink_launch(sink_kernel(true), clusters, cluster, bytes, stream,
                     args);
}
