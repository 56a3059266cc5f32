"""The lambdaLoss pair chain for long top-k blocks: the CUDA kernels of
``csrc/lambda_tiled.cu`` (forward and backward) for CUDA tensors and their
plain PyTorch versions for CPU tensors, tied into autograd by
``TiledLambdaPairs``.

Replaces the TPU kernel ``tiled_lambda_pairs`` of the JAX package's
``ops/lambda_tiled.py:280`` (forward ``pallas_call`` at line 237, backward
at line 261): the chain of ``ops/lambda_pairs.py`` on a pair block too
large for one thread-block cluster. The arithmetic, the argument checks,
the position tables and the scheme indices are those of
``ops/lambda_pairs.py``; the contract is ``fused_lambda_pairs``'s.

On the card a block takes a tile of rows of one slate against a stripe of
its columns (``tile_plan``); the forward's partials go
to a [2, blocks + 1, B] buffer and the backward's row and column sums to a
[B, stripes + tiles, k] scratch, both allocated here and added in a fixed
order by a second kernel. It covers k <= ``MAX_TILED_LENGTH``, the JAX
kernel's own envelope.
"""

from __future__ import annotations

import ctypes

import torch

from allrank_tpu_torch.ops import _build
from allrank_tpu_torch.ops.lambda_pairs import (
    CHAIN_ARGTYPES,
    check_args,
    lambda_pairs_bwd_plain,
    lambda_pairs_fwd_plain,
    launch_chain,
)

MAX_TILED_LENGTH = 4096
# a block's rows (SHORT_TILE_ROWS up to SHORT_LENGTH) and its widest column
# stripe: kTileRows, kShortTileRows, kShortK and kMaxStripe of
# csrc/lambda_tiled.cu
TILE_ROWS = 32
SHORT_TILE_ROWS = 16
SHORT_LENGTH = 1024
MAX_STRIPE = 512
# the chain's scalars, then the plan's tiles and stripes, then the stream
_PLAN_ARGTYPES = CHAIN_ARGTYPES[:-1] + [ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p]
_SIGNATURES = {"lambda_tiled_fwd": [ctypes.c_void_p] * 7 + _PLAN_ARGTYPES,
               "lambda_tiled_bwd": [ctypes.c_void_p] * 9 + _PLAN_ARGTYPES}


# the plain PyTorch versions: the one-block kernel's, the same function
lambda_tiled_fwd_plain = lambda_pairs_fwd_plain
lambda_tiled_bwd_plain = lambda_pairs_bwd_plain


def tile_plan(k: int) -> tuple:
    """(row tiles, column stripes, stripe width, rows a tile) of the
    kernels at top-k length ``k`` (1 <= k <= ``MAX_TILED_LENGTH``): tiles
    of ``SHORT_TILE_ROWS`` rows up to ``SHORT_LENGTH``, of ``TILE_ROWS``
    beyond; ceil(k / ``MAX_STRIPE``) stripes of equal width, rounded up to
    32 columns. A block takes one (slate, tile, stripe)."""
    if not 1 <= k <= MAX_TILED_LENGTH:
        raise ValueError(f"no tile plan for a top-k block of {k}")
    rows = SHORT_TILE_ROWS if k <= SHORT_LENGTH else TILE_ROWS
    stripes = -(-k // MAX_STRIPE)
    width = -(-k // stripes)
    return -(-k // rows), stripes, -(-width // 32) * 32, rows


def _check_length(yp):
    if yp.shape[1] > MAX_TILED_LENGTH:
        raise NotImplementedError(
            f"the tiled lambdaLoss pair kernel covers k <= "
            f"{MAX_TILED_LENGTH}, got {yp.shape[1]}")


def lambda_tiled_fwd(yp, ts, g, valid, **kw):
    """(loss sums [B], counts [B]). A CPU tensor takes the plain version; a
    CUDA tensor launches the forward kernel or raises."""
    if yp.device.type == "cpu":
        return lambda_tiled_fwd_plain(yp, ts, g, valid, **kw)
    if yp.device.type != "cuda":
        raise ValueError(f"no lambdaLoss pair chain for device {yp.device}")
    check_args(yp, kw)
    _check_length(yp)
    b, n = yp.shape
    tiles, stripes, _, _ = tile_plan(n)
    blocks = tiles * stripes
    # (loss, count) by block and slate; the kernel's last row is the sum
    buf = torch.empty(2, blocks + 1, b, dtype=torch.float32, device=yp.device)
    launch_chain("lambda_tiled", _SIGNATURES, "lambda_tiled_fwd", yp, ts, g,
                 valid, (), (buf,), kw, (tiles, stripes))
    lambda_tiled_fwd.launches += 1
    return buf[0, blocks], buf[1, blocks]


lambda_tiled_fwd.launches = 0


def lambda_tiled_bwd(yp, ts, g, valid, gout, **kw):
    """dL/dyp [B, k]. A CPU tensor takes the plain version; a CUDA tensor
    launches the backward kernel or raises."""
    if yp.device.type == "cpu":
        return lambda_tiled_bwd_plain(yp, ts, g, valid, gout, **kw)
    if yp.device.type != "cuda":
        raise ValueError(f"no lambdaLoss pair chain for device {yp.device}")
    check_args(yp, kw)
    _check_length(yp)
    _build.require(gout, "gout", (yp.shape[0],), torch.float32, yp.device)
    b, n = yp.shape
    tiles, stripes, _, _ = tile_plan(n)
    dyp = torch.empty_like(yp)
    # row i's sum by stripe, then column j's partial by row tile
    part = torch.empty(b, stripes + tiles, n, dtype=torch.float32,
                       device=yp.device)
    launch_chain("lambda_tiled", _SIGNATURES, "lambda_tiled_bwd", yp, ts, g,
                 valid, (gout,), (dyp, part), kw, (tiles, stripes))
    lambda_tiled_bwd.launches += 1
    return dyp


lambda_tiled_bwd.launches = 0


class TiledLambdaPairs(torch.autograd.Function):
    """The chain under autograd; gradients flow to ``y_pred_sorted`` only
    (the counts carry none)."""

    @staticmethod
    def forward(ctx, yp, ts, g, valid, kw):
        ctx.save_for_backward(yp, ts, g, valid)
        ctx.kw = kw
        loss, cnt = lambda_tiled_fwd(yp, ts, g, valid, **kw)
        ctx.mark_non_differentiable(cnt)
        return loss, cnt

    @staticmethod
    def backward(ctx, g_loss, _g_cnt):
        yp, ts, g, valid = ctx.saved_tensors
        dyp = lambda_tiled_bwd(yp, ts, g, valid, g_loss.float().contiguous(),
                               **ctx.kw)
        return dyp, None, None, None, None


def tiled_lambda_pairs(y_pred_sorted, true_sorted, gains, valid, *, scheme,
                       k_eff: int, sigma: float, mu: float, log_base: str,
                       eps: float):
    """(per-slate loss sums [B], selected-pair counts [B]) of the lambdaLoss
    pair chain; all inputs [B, k] (``valid`` as 0/1 floats), cast to fp32:
    the contract of ``fused_lambda_pairs``. On CUDA, k above
    ``MAX_TILED_LENGTH`` raises ``NotImplementedError``."""
    kw = dict(scheme=scheme, k_eff=int(k_eff), sigma=float(sigma),
              mu=float(mu), log_base=str(log_base), eps=float(eps))
    args = [t.float().contiguous() for t in (y_pred_sorted, true_sorted,
                                              gains, valid)]
    return TiledLambdaPairs.apply(*args, kw)
