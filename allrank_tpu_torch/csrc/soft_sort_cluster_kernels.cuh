// The slate kernels of the fused NeuralNDCG soft-sort on a thread-block
// cluster, forward and backward, and the choice of their register shape by
// length. No include guard: a source includes this file inside a namespace
// of its own, after soft_sort_cluster.cuh and after defining
//   constexpr bool kRecordsOnChip
// there, which says where the Sinkhorn records and the backward's U and V
// stacks live:
//   false: B8's route "cluster" (neuralsort_cluster.cu, whose header
//          describes the math and the design): the forward writes each
//          record row to device memory as the loop makes it; the backward
//          re-reads them there, keeps U and V in a per-block scratch `uv` of
//          device memory and stages the stacks back through shared memory,
//          kChunk iterations at a time, for the epilogue.
//   true:  X4 (neuralsort_layout.cu): the forward keeps each block's
//          records (a for its rows, b for its share of the columns) in its
//          shared memory for the whole loop and writes them out in one pass
//          a slate; the backward reads them in one pass a slate and keeps
//          them, with U and V, in shared memory for the loop and the
//          epilogue, in the room of the block's rows of M0, which the loop
//          holds in registers. The epilogue rebuilds each M0 value it needs
//          from the chain's vectors and its row's softmax max and sum (the
//          same logit, exponential and division: the same bits). `uv` is
//          unused (null).
// Both run the same sums in the same order, so out, the records and ds are
// the same bits. Each part that differs is an `if constexpr` whose false
// branch is B8's code as it was, so that B8's kernels build as before.

// B8's forward: see neuralsort_cluster.cu.
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
  // on chip: the block's records [T + 1, Rp], a for its rows and b for its
  // share of the columns (the same run of indices)
  float* ha = smem;
  float* hb = ha + (T + 1) * Rp;
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
      if constexpr (kRecordsOnChip)
        ha[tid] = 1.f;
      else
        a_rec[sh.r0 + tid] = 1.f;
    }
    if (tid < P) b[tid] = tid < L ? 1.f : 0.f;
    if (tid >= sh.r0 && tid < sh.r0 + sh.rows) {
      if constexpr (kRecordsOnChip)
        hb[tid - sh.r0] = 1.f;
      else
        b_rec[tid] = 1.f;
    }
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
        if (tid >= sh.r0 && tid < sh.r0 + sh.rows) {
          if constexpr (kRecordsOnChip)
            hb[(t + 1) * Rp + tid - sh.r0] = b2;
          else
            b_rec[(size_t)(t + 1) * L + tid] = b2;
        }
      }
      __syncthreads();
      // r = a * (M0 b); a <- rescale: the block's own rows
      row_parts(g, b, P, Rp, rpart);
      __syncthreads();
      if (tid < sh.rows) {
        const float r = row_total(rpart, Rp, tid);
        const float a2 = rescale(a[tid], a[tid] * r);
        a[tid] = a2;
        if constexpr (kRecordsOnChip)
          ha[(t + 1) * Rp + tid] = a2;
        else
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
    if constexpr (kRecordsOnChip) {
      // the records out in one pass, rows of the block's run of indices
      for (int e = tid; e < (T + 1) * sh.rows; e += kClusterThreads) {
        const int t = e / sh.rows, il = e - t * sh.rows;
        a_rec[(size_t)t * L + sh.r0 + il] = ha[t * Rp + il];
        b_rec[(size_t)t * L + sh.r0 + il] = hb[t * Rp + il];
      }
    }
    __syncthreads();
  }
  // no block leaves while another may still read its partials
  cluster.sync();
}

// B8's backward: see neuralsort_cluster.cu.
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
  float* M;  // on chip: M0, then the stacks
  if constexpr (kRecordsOnChip)
    M = take(smem, records_m0_room(L, sh.csize, T));
  else
    M = take(smem, R * P);
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
  float* room;
  if constexpr (kRecordsOnChip)
    room = take(smem, records_bwd_room(L, sh.csize));
  else
    room = take(smem, bwd_union(L, sh.csize));
  float* xch = room;                    // the loop's exchanges,
  float* rpart = room + 2 * X;          // its row sums' warp partials
  float* rpart_b = rpart + kClusterWarps * Rp;  // (M0 v, then M0 b_t)
  // on chip: each row's softmax max and sum, to rebuild M0 in the epilogue,
  // and the stacks in M0's room once the loop holds M0 in registers:
  // a_hist's rows of the block [T + 1, Rs] and U [T, Rs], b_hist [T + 1,
  // Pk] and V [T, Pk], all columns at a pitch of whole epilogue tiles
  float* zmax = smem;
  float* sums = zmax + Rp;
  const int Pk = col_tiles(L) * kTileCols;
  float* ha = M;
  float* U;  // [T, Rs]
  float* hb = M + (2 * T + 1) * Rs;
  float* V;  // [T, L] (B8), [T, Pk] (on chip)
  if constexpr (kRecordsOnChip) {
    U = ha + (T + 1) * Rs;
    V = hb + (T + 1) * Pk;
  } else {
    U = uv + (size_t)blockIdx.x * T * (Rs + L);
    V = U + (size_t)T * Rs;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int clusters = gridDim.x / sh.csize;
  const int tid = threadIdx.x;  // a thread a column, and a row: L <= 512
  int k = 0;  // the cluster's exchanges so far: the next one uses xch k & 1
  for (int slate = blockIdx.x / sh.csize; slate < n; slate += clusters) {
    const size_t o = (size_t)slate * L;
    if constexpr (kRecordsOnChip) {
      chain_rows(s + o, pad + o, vec + o, L, tau, c, M, sh, sums);
      row_max_logits(L, tau, c, sh, zmax);
    } else {
      chain_rows(s + o, pad + o, vec + o, L, tau, c, M, sh, u);
    }
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
    if constexpr (kRecordsOnChip) {
      // M0 is in the registers: its room takes the records, in one pass
      __syncthreads();
      for (int e = tid; e < (T + 1) * L; e += kClusterThreads) {
        const int t = e / L, j = e - t * L;
        hb[t * Pk + j] = b_rec[e];
        if (j < sh.rows) ha[t * Rs + j] = a_rec[(size_t)t * L + sh.r0 + j];
      }
    }
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
      if constexpr (kRecordsOnChip)
        a_step(T, tid, ha[(T - 1) * Rs + tid]);
      else
        a_step(T, tid, a_rec[(size_t)(T - 1) * L + sh.r0 + tid]);
      inner[tid] += u[tid] * rb;
    }
    __syncthreads();
    for (int t = T; t >= 1; --t) {
      // b_prev's and the next a_prev's loads in flight across the exchange
      float bp, ap;
      if constexpr (kRecordsOnChip) {
        bp = tid < L ? hb[(t - 1) * Pk + tid] : 0.f;
        ap = tid < sh.rows && t > 1 ? ha[(t - 2) * Rs + tid] : 0.f;
      } else {
        bp = tid < L ? b_rec[(size_t)(t - 1) * L + tid] : 0.f;
        ap = tid < sh.rows && t > 1
                 ? a_rec[(size_t)(t - 2) * L + sh.r0 + tid]
                 : 0.f;
      }
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
        if constexpr (kRecordsOnChip)
          V[(t - 1) * Pk + tid] = vv;
        else
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
    if constexpr (kRecordsOnChip) __syncthreads();
    // dM0 = dp (.) outer(a_T, b_T) + sum_t U[t] (x) b_hist[t + 1]
    // + a_hist[t] (x) V[t], an 8 x 128 tile a warp (columns lane + 32 q),
    // the warps in tile_teams(L) teams of whole column tiles; in device
    // memory the stacks' rows pass through shared memory kChunk iterations
    // at a time, on chip the chain runs on them where they lie
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
      if constexpr (kRecordsOnChip) {
        if (has) {
          for (int t = 0; t < T; ++t) {
            float bq[4], vq[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              bq[q] = hb[(t + 1) * Pk + j0 + 32 * q];
              vq[q] = V[t * Pk + j0 + 32 * q];
            }
#pragma unroll
            for (int r = 0; r < kTileRows; ++r) {
              const float ur = U[t * Rs + il0 + r];
              const float ar = ha[t * Rs + il0 + r];
#pragma unroll
              for (int q = 0; q < 4; ++q)
                acc[r][q] = fmaf(ar, vq[q], fmaf(ur, bq[q], acc[r][q]));
            }
          }
        }
      } else {
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
          float dpm;
          if constexpr (kRecordsOnChip)
            dpm = over_tau((dm * pv - inner[il]) *
                               chain_value(c, i, j, tau, zmax[il], sums[il]),
                           tau) *
                  pv;
          else
            dpm = over_tau((dm * pv - inner[il]) * M[(size_t)il * P + j],
                           tau) *
                  pv;
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
