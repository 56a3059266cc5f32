// B10, the whole-encoder kernel pair (encoder_block.cuh), route of bf16
// activations on Hopper's tensor cores: its phases run the tile bodies of
// B1's and B2's bf16 routes (b1_mma_tiles.cuh, b2_mma_tiles.cuh; heads
// wider than 128 B1's SIMT bodies, as B1's route), in the chained kernels'
// order:
//   forward: W1 and W2 of all N blocks rounded to padded bf16 scratch once
//     (b2_round_weights_kernel's work); per block LN + QKV, attention +
//     out-projection + residual (128 queries a tile), the FFN (128 rows a
//     tile at d <= 128, 64 above); the final LayerNorm.
//   backward: the FFN's rows, its split A^T B products (64 x 128 tiles of
//     8 warps), the attention's rows, dQ (8 warps, 128 queries a tile: the
//     chained kernel's 4-warp body at twice the rows), dK/dV, dn + the LN
//     backward beside the attention's A^T B products.
// The split counts are the bf16 route's (ops/attention_block.SPLIT_BLOCKS),
// so each weight gradient is the chained route's sum in its order.
//
// Replaces the TPU kernel `encoder_forward` of the JAX package's
// ops/encoder_block.py (forward pallas_call at line 302, backward at line
// 333) for bf16 activations; fp32 takes encoder_block_f32.cuh.
#pragma once

#include "b1_mma_tiles.cuh"
#include "b2_mma_tiles.cuh"
#include "encoder_block.cuh"

namespace allrank {
namespace {

struct MmaRoute {
  using T = bf16;
  static constexpr bool kRounds = true;

  __host__ __device__ static constexpr int attn_fwd_phases(int) { return 2; }
  __host__ __device__ static constexpr int ffn_rows(int cs) {
    return block_rows(cs);
  }
  __host__ __device__ static int attn_rows_tiles(int M, int d) {
    return cdiv(M, kGemmRows) * cdiv(d, kGemmCols);
  }

  __device__ static bf16* w1b(const EncoderArgs& a, int n) {
    return static_cast<bf16*>(a.w1b) +
           (size_t)n * round16(a.d) * ff_pad(a.d_ff);
  }
  __device__ static bf16* w2b(const EncoderArgs& a, int n) {
    return static_cast<bf16*>(a.w2b) +
           (size_t)n * round16(a.d) * ff_pad(a.d_ff);
  }

  // W1 and W2 of every block rounded to bf16, padded with zeros
  static __device__ __noinline__ void round_weights(const EncoderArgs& a) {
    const int dpad = round16(a.d), ffp = ff_pad(a.d_ff);
    for (int n = 0; n < a.n_blocks; ++n) {
      const BlockPtrs w = block_ptrs(a.w, n, a.d, a.d_ff);
      b2_round_weights_range(w.p[kW1], w.p[kW2], w1b(a, n), w2b(a, n), a.d,
                             a.d_ff, dpad, ffp,
                             (size_t)blockIdx.x * kEncThreads + threadIdx.x,
                             (size_t)gridDim.x * kEncThreads);
    }
  }

  // ---- the forward: LN + QKV, then attention + out-projection ------------
  static __device__ __forceinline__ void ln_qkv(const EncoderArgs& args,
                                                int n) {
    const int row_tiles = cdiv(args.batch * args.L, kGemmRows);
    FOR_TILES_OF(t, 0, row_tiles * cdiv(3 * args.d, kGemmCols), args, a) {
      const BlockPtrs w = block_ptrs(a.w, n, a.d, a.d_ff);
      __syncthreads();
      b1_ln_qkv_mma_tile(enc_smem(), sublayer_in<bf16>(a, 2 * n), w.p[kLn1S],
                         w.p[kLn1B], w.p[kWqkv], w.p[kBqkv],
                         qkv_at<bf16>(a, n), a.batch * a.L, a.d,
                         t % row_tiles, t / row_tiles);
    }
  }

  template <int kDk>
  static __device__ __forceinline__ void attn_out(const EncoderArgs& args,
                                                  int n) {
    const int q_tiles = cdiv(args.L, 16 * kOutWarps);
    FOR_TILES_OF(t, 0, q_tiles * args.batch, args, a) {
      const BlockPtrs w = block_ptrs(a.w, n, a.d, a.d_ff);
      __syncthreads();
      b1_attn_out_mma_tile<kDk, true>(
          enc_smem(), qkv_at<bf16>(a, n), a.key_mask,
          sublayer_in<bf16>(a, 2 * n), w.p[kWout], w.p[kBout],
          sublayer_in<bf16>(a, 2 * n + 1), stats_at(a, n), a.L, a.d, a.h,
          a.scale, drop_at(a, 4 * n), drop_at(a, 4 * n + 1), t % q_tiles,
          t / q_tiles);
    }
  }

  template <int kDk>
  static __device__ __noinline__ void attn_fwd(const EncoderArgs& a,
                                               int phase, int n) {
    if (phase == 0)
      ln_qkv(a, n);
    else
      attn_out<kDk>(a, n);
  }

  template <int kCs>
  static __device__ __noinline__ void ffn_fwd(const EncoderArgs& args,
                                              int n) {
    FOR_TILES_OF(t, 0, cdiv(args.batch * args.L, block_rows(kCs)), args, a) {
      const BlockPtrs w = block_ptrs(a.w, n, a.d, a.d_ff);
      __syncthreads();
      b2_fwd_mma_tile<kCs>(enc_smem(), sublayer_in<bf16>(a, 2 * n + 1),
                           w.p[kLn2S], w.p[kLn2B], w1b(a, n), w.p[kB1],
                           w2b(a, n), w.p[kB2], sublayer_in<bf16>(a, 2 * n + 2),
                           a.batch * a.L, a.d, a.d_ff, drop_at(a, 4 * n + 2),
                           drop_at(a, 4 * n + 3), t);
    }
  }

  // ---- the backward ------------------------------------------------------
  template <int kCs>
  static __device__ __noinline__ void ffn_bwd_rows(const EncoderArgs& args,
                                                   int n) {
    FOR_TILES_OF(t, 0, cdiv(args.batch * args.L, block_rows(kCs)), args, a) {
      const BlockPtrs w = block_ptrs(a.w, n, a.d, a.d_ff);
      __syncthreads();
      b2_bwd_rows_mma_tile<kCs>(
          enc_smem(), sublayer_in<bf16>(a, 2 * n + 1), w.p[kLn2S],
          w.p[kLn2B], w1b(a, n), w.p[kB1], w2b(a, n), grad_out<bf16>(a),
          grad_mid<bf16>(a), static_cast<bf16*>(a.n_act_f),
          static_cast<bf16*>(a.dout), static_cast<bf16*>(a.hidden),
          static_cast<bf16*>(a.dh), a.part_ln_f, a.batch * a.L, a.d, a.d_ff,
          drop_at(a, 4 * n + 2), drop_at(a, 4 * n + 3), t);
    }
  }

  // One split A^T B product of padded rows (B2's) in 64 x 128 tiles, after
  // `first` tiles of its phase; returns its tile count.
  static __device__ int ffn_product(const bf16* A, int lda, const bf16* B,
                                    int ldb, float* part, int M, int K, int N,
                                    int splits, int first) {
    const int kt = cdiv(K, kTile), nt = cdiv(N, 128);
    FOR_TILES(t, first, kt * nt * splits) {
      __syncthreads();
      b2_atb_mma_tile<8>(enc_smem(), A, lda, B, ldb, part, M, K, N,
                         split_rows(M, splits), t % kt, (t / kt) % nt,
                         t / (kt * nt));
    }
    return kt * nt * splits;
  }

  // dW1 = n^T . dh and dW2 = hidden^T . dout, with the bias column sums
  static __device__ __noinline__ void ffn_products(const EncoderArgs& a) {
    const int M = a.batch * a.L, dpad = round16(a.d), ffp = ff_pad(a.d_ff);
    const int first = ffn_product(
        static_cast<const bf16*>(a.n_act_f), dpad,
        static_cast<const bf16*>(a.dh), ffp, a.part_1, M, a.d, a.d_ff, a.s_1,
        0);
    ffn_product(static_cast<const bf16*>(a.hidden), ffp,
                static_cast<const bf16*>(a.dout), dpad, a.part_2, M, a.d_ff,
                a.d, a.s_2, first);
  }

  // da, dO and LN1(x)
  static __device__ __forceinline__ void bwd_rows(const EncoderArgs& args,
                                                  int n) {
    const int row_tiles = cdiv(args.batch * args.L, kGemmRows);
    FOR_TILES_OF(t, 0, row_tiles * cdiv(args.d, kGemmCols), args, a) {
      const BlockPtrs w = block_ptrs(a.w, n, a.d, a.d_ff);
      __syncthreads();
      b1_bwd_rows_mma_tile(enc_smem(), sublayer_in<bf16>(a, 2 * n),
                           grad_mid<bf16>(a), w.p[kLn1S], w.p[kLn1B],
                           w.p[kWout], static_cast<bf16*>(a.da),
                           static_cast<bf16*>(a.dO),
                           static_cast<bf16*>(a.n_act_a), a.batch * a.L, a.d,
                           drop_at(a, 4 * n + 1), t % row_tiles,
                           t / row_tiles);
    }
  }

  // dQ, ctx and D: 8 warps, 128 queries a tile
  template <int kDk>
  static __device__ __forceinline__ void bwd_dq(const EncoderArgs& args,
                                                int n) {
    const int q_tiles = cdiv(args.L, 128);
    FOR_TILES_OF(t, 0, q_tiles * args.batch * args.h, args, a) {
      __syncthreads();
      b1_bwd_dq_mma_tile<kDk, true, 8>(
          enc_smem(), qkv_at<bf16>(a, n), a.key_mask, stats_at(a, n),
          static_cast<const bf16*>(a.dO), static_cast<bf16*>(a.ctx), a.D,
          static_cast<bf16*>(a.dqkv), a.L, a.d, a.h, a.scale,
          drop_at(a, 4 * n), t % q_tiles, t / q_tiles);
    }
  }

  template <int kDk>
  static __device__ __forceinline__ void bwd_dkv(const EncoderArgs& args,
                                                 int n) {
    const int k_tiles = cdiv(args.L, 16 * kDkvWarps);
    FOR_TILES_OF(t, 0, k_tiles * args.batch * args.h, args, a) {
      __syncthreads();
      b1_bwd_dkv_mma_tile<kDk, true>(
          enc_smem(), qkv_at<bf16>(a, n), a.key_mask, stats_at(a, n), a.D,
          static_cast<const bf16*>(a.dO), static_cast<bf16*>(a.dqkv), a.L,
          a.d, a.h, a.scale, drop_at(a, 4 * n), t % k_tiles, t / k_tiles);
    }
  }

  // One split A^T B product of B1's (rows of K and N elements) in 64 x 128
  // tiles, after `first` tiles of its phase; returns its tile count.
  static __device__ int attn_product(const bf16* A, const bf16* B,
                                     float* part, int M, int K, int N,
                                     int splits, bool vec, int first) {
    const int kt = cdiv(K, kTile), nt = cdiv(N, 128);
    FOR_TILES(t, first, kt * nt * splits) {
      __syncthreads();
      b1_atb_mma_tile<8>(enc_smem(), A, B, part, M, K, N,
                         split_rows(M, splits), vec, t % kt, (t / kt) % nt,
                         t / (kt * nt));
    }
    return kt * nt * splits;
  }

  // dn + the LN1 backward (the gradient at S(2n)), beside dWqkv and dWout
  static __device__ __forceinline__ void bwd_ln_qkv(const EncoderArgs& args,
                                                    int n) {
    const int M = args.batch * args.L, d = args.d;
    const int row_tiles = cdiv(M, kGemmRows);
    // rows of d and 3d elements on 16-byte boundaries
    const bool vec = args.aligned && d % 8 == 0;
    FOR_TILES_OF(t, 0, row_tiles, args, a) {
      const BlockPtrs w = block_ptrs(a.w, n, a.d, a.d_ff);
      __syncthreads();
      b1_bwd_ln_qkv_mma_tile(enc_smem(), sublayer_in<bf16>(a, 2 * n),
                             grad_mid<bf16>(a),
                             static_cast<const bf16*>(a.dqkv), w.p[kLn1S],
                             w.p[kWqkv], grad_in<bf16>(a, n), a.part_ln_a,
                             a.batch * a.L, a.d, a.aligned && a.d % 8 == 0,
                             t);
    }
    const int first = row_tiles + attn_product(
        static_cast<const bf16*>(args.n_act_a),
        static_cast<const bf16*>(args.dqkv), args.part_qkv, M, d, 3 * d,
        args.s_qkv, vec, row_tiles);
    attn_product(static_cast<const bf16*>(args.ctx),
                 static_cast<const bf16*>(args.da), args.part_out, M, d, d,
                 args.s_out, vec, first);
  }

  template <int kDk>
  static __device__ __noinline__ void attn_bwd(const EncoderArgs& a,
                                               int phase, int n) {
    switch (phase) {
      case 0: bwd_rows(a, n); break;
      case 1: bwd_dq<kDk>(a, n); break;
      case 2: bwd_dkv<kDk>(a, n); break;
      default: bwd_ln_qkv(a, n);
    }
  }

  // ---- host: each phase's shared memory, the chained launches' ----------
  template <int kDk, int kCs>
  static size_t smem(int d, int h, bool backward) {
    const int dpad = round16(d), dk = d / h;
    const size_t rows = 2 * kGemmRows * sizeof(float);
    size_t s = row_smem(dpad, backward ? 2 : 1, block_rows(kCs));
    if (kDk == 0) {
      s = std::max(s, simt_smem(d));
    } else {
      s = std::max(s, (kGemmRows * tile_pitch(d) + dpad * tile_pitch(kGemmCols)) *
                          sizeof(bf16) + rows);
      const size_t attn = mma_smem(dk, 128 + 2 * kStages * kKeyTile,
                                   4 * kStages * sizeof(uint32_t));
      const size_t w_slice = (size_t)dpad * tile_pitch(kOutCols) * sizeof(bf16);
      s = std::max(s, 128 * tile_pitch(d) * sizeof(bf16) + std::max(attn, w_slice));
    }
    if (!backward) return s;
    s = std::max({s, (size_t)b2_atb_smem(8),
                  final_ln_bwd_smem_floats(d) * sizeof(float)});
    if (kDk == 0) return s;
    return std::max(
        {s, (kGemmRows + kGemmCols) * tile_pitch(d) * sizeof(bf16) + rows,
         mma_smem(dk, 2 * 128 + 2 * kStages * kKeyTile,
                  4 * kStages * sizeof(uint32_t)),
         mma_smem(dk, 2 * 16 * kDkvWarps + 2 * kStages * kQueryTile,
                  3 * kStages * kQueryTile * sizeof(float)),
         (size_t)(kGemmRows + dpad) * tile_pitch(64) * sizeof(bf16) +
             ((size_t)kGemmRows * (d + 1) + 2 * kTile) * sizeof(float),
         (size_t)b1_atb_smem(8)});
  }
};

}  // namespace
}  // namespace allrank
