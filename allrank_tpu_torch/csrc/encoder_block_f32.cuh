// B10, the whole-encoder kernel pair (encoder_block.cuh), route of fp32
// activations on Hopper's tensor cores as 3xTF32 split products: its
// phases run the tile bodies of B1's and B2's fp32 routes
// (b1_tf32x3_tiles.cuh, b2_tf32x3_tiles.cuh; heads wider than 128 B1's
// SIMT bodies, as B1's route), in the chained kernels' order:
//   forward: per block LN + QKV, the attention core per (slate, head,
//     queries) into ctx, the out-projection + residual, the FFN; the final
//     LayerNorm.
//   backward: the FFN's rows, its split A^T B products (64 x 128 tiles of
//     8 warps), the attention's rows, dQ, dK/dV, dn + the LN backward
//     beside the attention's A^T B products.
// The attention bodies keep the chained kernels' warps (8 at d_k <= 32; at
// 64 and 128 the forward 8 and 4, dQ and dK/dV 4 and 2, as fp32's shared
// memory allows), the block's other warps waiting at the phase's end. The
// split counts are the fp32 route's (ops/attention_block.SPLIT_BLOCKS_TF32X3
// on the tensor cores, SPLIT_BLOCKS on B1's SIMT phases), so each weight
// gradient is the chained route's sum in its order.
//
// Replaces the TPU kernel `encoder_forward` of the JAX package's
// ops/encoder_block.py (forward pallas_call at line 302, backward at line
// 333) for fp32 activations; bf16 takes encoder_block_bf16.cuh.
#pragma once

#include "b1_tf32x3_tiles.cuh"
#include "b2_tf32x3_tiles.cuh"
#include "encoder_block.cuh"

namespace allrank {
namespace {

struct Tf32x3Route {
  using T = float;
  static constexpr bool kRounds = false;

  __host__ __device__ static constexpr int attn_fwd_phases(int) { return 3; }
  __host__ __device__ static constexpr int ffn_rows(int cs) {
    return block_rows(cs);
  }
  __host__ __device__ static int attn_rows_tiles(int M, int d) {
    return cdiv(M, kGemmRows) * cdiv(d, kGemmCols);
  }
  // B2's hidden units a chunk, forward and backward
  __host__ __device__ static constexpr int fwd_units(int cs) {
    return cs == 2 ? 32 : 64;
  }
  __host__ __device__ static constexpr int bwd_units(int cs) {
    return cs == 2 ? 16 : 32;
  }
  // 16-byte staging of rows of d elements and of the weights
  __device__ static bool vec(const EncoderArgs& a, int cols) {
    return a.aligned && cols % 4 == 0;
  }

  // ---- the forward: LN + QKV, the core into ctx, the out-projection ------
  static __device__ __forceinline__ void ln_qkv(const EncoderArgs& args,
                                                int n) {
    const int row_tiles = cdiv(args.batch * args.L, kGemmRows);
    FOR_TILES_OF(t, 0, row_tiles * cdiv(3 * args.d, kGemmCols), args, a) {
      const BlockPtrs w = block_ptrs(a.w, n, a.d, a.d_ff);
      __syncthreads();
      b1_ln_qkv_tf32x3_tile(enc_smem(), sublayer_in<float>(a, 2 * n),
                            w.p[kLn1S], w.p[kLn1B], w.p[kWqkv], w.p[kBqkv],
                            qkv_at<float>(a, n), a.batch * a.L, a.d,
                            vec(a, a.d), t % row_tiles, t / row_tiles);
    }
  }

  // the core per (slate, head, queries) on the chained kernel's warps
  template <int kDk>
  static __device__ __forceinline__ void attn_core(const EncoderArgs& args,
                                                   int n) {
    constexpr int kBody = 32 * f32_fwd_warps(kDk);
    const int q_tiles = cdiv(args.L, kBody / 2);
    if (threadIdx.x >= kBody) return;
    FOR_TILES_OF(t, 0, q_tiles * args.batch * args.h, args, a) {
      tile_sync<kBody, kEncThreads>();
      b1_attn_tf32x3_tile<kDk, true, kEncThreads>(
          enc_smem(), qkv_at<float>(a, n), a.key_mask,
          static_cast<float*>(a.ctx), stats_at(a, n), a.L, a.d, a.h, a.scale,
          drop_at(a, 4 * n), t % q_tiles, t / q_tiles);
    }
  }

  static __device__ __forceinline__ void out_proj(const EncoderArgs& args,
                                                  int n) {
    const int row_tiles = cdiv(args.batch * args.L, kGemmRows);
    FOR_TILES_OF(t, 0, row_tiles * cdiv(args.d, kGemmCols), args, a) {
      const BlockPtrs w = block_ptrs(a.w, n, a.d, a.d_ff);
      __syncthreads();
      b1_out_tf32x3_tile(enc_smem(), static_cast<const float*>(a.ctx),
                         sublayer_in<float>(a, 2 * n), w.p[kWout], w.p[kBout],
                         sublayer_in<float>(a, 2 * n + 1), a.batch * a.L, a.d,
                         vec(a, a.d), vec(a, a.d), drop_at(a, 4 * n + 1),
                         t % row_tiles, t / row_tiles);
    }
  }

  template <int kDk>
  static __device__ __noinline__ void attn_fwd(const EncoderArgs& a,
                                               int phase, int n) {
    if (phase == 0)
      ln_qkv(a, n);
    else if (phase == 1)
      attn_core<kDk>(a, n);
    else
      out_proj(a, n);
  }

  template <int kCs>
  static __device__ __noinline__ void ffn_fwd(const EncoderArgs& args,
                                              int n) {
    FOR_TILES_OF(t, 0, cdiv(args.batch * args.L, block_rows(kCs)), args, a) {
      const BlockPtrs w = block_ptrs(a.w, n, a.d, a.d_ff);
      __syncthreads();
      b2_fwd_tf32x3_tile<kCs, fwd_units(kCs)>(
          enc_smem(), sublayer_in<float>(a, 2 * n + 1), w.p[kLn2S],
          w.p[kLn2B], w.p[kW1], w.p[kB1], w.p[kW2], w.p[kB2],
          sublayer_in<float>(a, 2 * n + 2), a.batch * a.L, a.d, a.d_ff,
          vec(a, a.d_ff), vec(a, a.d), drop_at(a, 4 * n + 2),
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
      b2_bwd_rows_tf32x3_tile<kCs, bwd_units(kCs)>(
          enc_smem(), sublayer_in<float>(a, 2 * n + 1), w.p[kLn2S],
          w.p[kLn2B], w.p[kW1], w.p[kB1], w.p[kW2], grad_out<float>(a),
          grad_mid<float>(a), static_cast<float*>(a.n_act_f),
          static_cast<float*>(a.dout), static_cast<float*>(a.hidden),
          static_cast<float*>(a.dh), a.part_ln_f, a.batch * a.L, a.d, a.d_ff,
          vec(a, a.d_ff), vec(a, a.d), drop_at(a, 4 * n + 2),
          drop_at(a, 4 * n + 3), t);
    }
  }

  // One split A^T B product (f32_atb_tile) in 64 x 128 tiles, after
  // `first` tiles of its phase; returns its tile count.
  static __device__ int product(const EncoderArgs& a, const float* A,
                                const float* B, float* part, int K, int N,
                                int splits, int first) {
    const int M = a.batch * a.L, kt = cdiv(K, kTile), nt = cdiv(N, 128);
    const bool v = a.aligned && K % 4 == 0 && N % 4 == 0;
    FOR_TILES(t, first, kt * nt * splits) {
      __syncthreads();
      f32_atb_tile<8>(reinterpret_cast<float*>(enc_smem()), A, K, B, N, part,
                      M, K, N, split_rows(M, splits), v, t % kt,
                      (t / kt) % nt, t / (kt * nt));
    }
    return kt * nt * splits;
  }

  // dW1 = n^T . dh and dW2 = hidden^T . dout, with the bias column sums
  static __device__ __noinline__ void ffn_products(const EncoderArgs& a) {
    const int first = product(a, static_cast<const float*>(a.n_act_f),
                              static_cast<const float*>(a.dh), a.part_1, a.d,
                              a.d_ff, a.s_1, 0);
    product(a, static_cast<const float*>(a.hidden),
            static_cast<const float*>(a.dout), a.part_2, a.d_ff, a.d, a.s_2,
            first);
  }

  // da, dO and LN1(x)
  static __device__ __forceinline__ void bwd_rows(const EncoderArgs& args,
                                                  int n) {
    const int row_tiles = cdiv(args.batch * args.L, kGemmRows);
    FOR_TILES_OF(t, 0, row_tiles * cdiv(args.d, kGemmCols), args, a) {
      const BlockPtrs w = block_ptrs(a.w, n, a.d, a.d_ff);
      __syncthreads();
      b1_bwd_rows_tf32x3_tile(
          enc_smem(), sublayer_in<float>(a, 2 * n), grad_mid<float>(a),
          w.p[kLn1S], w.p[kLn1B], w.p[kWout], static_cast<float*>(a.da),
          static_cast<float*>(a.dO), static_cast<float*>(a.n_act_a),
          a.batch * a.L, a.d, vec(a, a.d), drop_at(a, 4 * n + 1),
          t % row_tiles, t / row_tiles);
    }
  }

  // dQ, ctx and D on the chained kernel's warps
  template <int kDk>
  static __device__ __forceinline__ void bwd_dq(const EncoderArgs& args,
                                                int n) {
    constexpr int kBody = 32 * f32_dq_warps(kDk);
    const int q_tiles = cdiv(args.L, kBody / 2);
    if (threadIdx.x >= kBody) return;
    FOR_TILES_OF(t, 0, q_tiles * args.batch * args.h, args, a) {
      tile_sync<kBody, kEncThreads>();
      b1_bwd_dq_tf32x3_tile<kDk, true, kEncThreads>(
          enc_smem(), qkv_at<float>(a, n), a.key_mask, stats_at(a, n),
          static_cast<const float*>(a.dO), static_cast<float*>(a.ctx), a.D,
          static_cast<float*>(a.dqkv), a.L, a.d, a.h, a.scale,
          drop_at(a, 4 * n), t % q_tiles, t / q_tiles);
    }
  }

  // dK and dV on the chained kernel's warps
  template <int kDk>
  static __device__ __forceinline__ void bwd_dkv(const EncoderArgs& args,
                                                 int n) {
    constexpr int kBody = 32 * f32_dkv_warps(kDk);
    const int k_tiles = cdiv(args.L, kBody / 2);
    if (threadIdx.x >= kBody) return;
    FOR_TILES_OF(t, 0, k_tiles * args.batch * args.h, args, a) {
      tile_sync<kBody, kEncThreads>();
      b1_bwd_dkv_tf32x3_tile<kDk, true, kEncThreads>(
          enc_smem(), qkv_at<float>(a, n), a.key_mask, stats_at(a, n), a.D,
          static_cast<const float*>(a.dO), static_cast<float*>(a.dqkv), a.L,
          a.d, a.h, a.scale, drop_at(a, 4 * n), t % k_tiles, t / k_tiles);
    }
  }

  // dn + the LN1 backward (the gradient at S(2n)), beside dWqkv and dWout
  static __device__ __forceinline__ void bwd_ln_qkv(const EncoderArgs& args,
                                                    int n) {
    const int d = args.d, row_tiles = cdiv(args.batch * args.L, kGemmRows);
    FOR_TILES_OF(t, 0, row_tiles, args, a) {
      const BlockPtrs w = block_ptrs(a.w, n, a.d, a.d_ff);
      __syncthreads();
      b1_bwd_ln_qkv_tf32x3_tile(
          enc_smem(), sublayer_in<float>(a, 2 * n), grad_mid<float>(a),
          static_cast<const float*>(a.dqkv), w.p[kLn1S], w.p[kWqkv],
          grad_in<float>(a, n), a.part_ln_a, a.batch * a.L, a.d, vec(a, a.d),
          vec(a, a.d), t);
    }
    const int first = row_tiles + product(
        args, static_cast<const float*>(args.n_act_a),
        static_cast<const float*>(args.dqkv), args.part_qkv, d, 3 * d,
        args.s_qkv, row_tiles);
    product(args, static_cast<const float*>(args.ctx),
            static_cast<const float*>(args.da), args.part_out, d, d,
            args.s_out, first);
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
    const int dpad = round8(d), dk = d / h, lda = f32_row_pitch(d);
    const int dpad16 = (d + 15) / 16 * 16, ldb = f32_kn_pitch(kGemmCols);
    const int rows = block_rows(kCs);
    size_t s = backward ? row_smem(d, 2, rows, dpad16, bwd_units(kCs))
                        : row_smem(d, 1, rows, dpad, fwd_units(kCs));
    if (kDk == 0) {
      s = std::max(s, simt_smem(d));
    } else {
      constexpr int kSt = f32_fwd_stages(kDk);
      constexpr int kRows = 16 * f32_fwd_warps(kDk);
      s = std::max(
          {s, ((size_t)kGemmRows * lda + (size_t)dpad * ldb + 2 * kGemmRows) *
                  sizeof(float),
           f32_smem(dk, 2 * kRows + 2 * kSt * kKeyTile,
                    4 * kSt * sizeof(uint32_t))});
    }
    if (!backward) return s;
    s = std::max({s, f32_atb_smem(8),
                  final_ln_bwd_smem_floats(d) * sizeof(float)});
    if (kDk == 0) return s;
    constexpr int kSt = f32_bwd_stages(kDk);
    constexpr int kRowsQ = 16 * f32_dq_warps(kDk);
    constexpr int kRowsKv = 16 * f32_dkv_warps(kDk);
    const int kp = f32_row_pitch(kLnK);
    return std::max(
        {s, ((size_t)(kGemmRows + kGemmCols) * lda + 2 * kGemmRows) *
                sizeof(float),
         f32_smem(dk, 4 * kRowsQ + 2 * kSt * kKeyTile,
                  4 * kSt * sizeof(uint32_t)),
         f32_smem(dk, 4 * kRowsKv + 2 * kSt * 64, 3 * kSt * 64 * sizeof(float)),
         ((size_t)(kGemmRows + dpad16) * kp + (size_t)kGemmRows * (d + 1) +
          2 * kTile) * sizeof(float)});
  }
};

}  // namespace
}  // namespace allrank
