"""The lambdaLoss pair chain over the prediction-sorted top-k block: the
CUDA kernels of ``csrc/lambda_pairs.cu`` (forward and backward) for CUDA
tensors and their plain PyTorch versions for CPU tensors, tied into
autograd by ``LambdaPairs``. On the card a slate runs on a thread-block
cluster of ``cluster_size(k)`` blocks, each taking the rows
``rows_of(rank, warp, cluster, k)`` by warp.

Replaces the TPU kernel ``fused_lambda_pairs`` of the JAX package's
``ops/lambda_pallas.py:222`` (forward ``pallas_call`` at line 174, backward
at line 197). The chain runs in log space as the TPU kernel's ``_chain``
(lines 71-102): ``log(max(a^w, eps)) == max(w log a, log eps)`` with
``a = max(sigmoid(sigma d), eps)``, so ``a^w`` is never evaluated, and the
backward collapses ``w a^(w-1) / max(a^w, eps)`` to ``w / a`` on the active
branch (lines 127-135)::

    dL/dyp_i = sum_j c_ij - sum_j c_ji,
    c = sel * [w log a > log eps] * (w / a) / ln * [s > eps] * sigma s (1-s)

(``ln`` = ln 2 for the binary log, 1 for the natural one). The weight never
depends on the predictions except through the sort, so gradients flow to
``y_pred_sorted`` only. fp32 only, as the JAX loss upcasts.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from allrank_tpu_torch.ops import _build

# the kernel's envelope, the JAX kernel's own MAX_FUSED_LENGTH
MAX_FUSED_LENGTH = 384
SCHEMES = (None, "ndcgLoss1_scheme", "ndcgLoss2_scheme", "lambdaRank_scheme",
           "ndcgLoss2PP_scheme", "rankNet_scheme",
           "rankNetWeightedByGTDiff_scheme",
           "rankNetWeightedByGTDiffPowed_scheme")
_LN2 = float(np.log(2.0))
# the chain's scalar arguments and the stream, after the pointers
CHAIN_ARGTYPES = ([ctypes.c_int] * 5 + [ctypes.c_float] * 4
                  + [ctypes.c_void_p])
# the one-block-a-row-tile kernels also take their cluster size
_CLUSTER_ARGTYPES = CHAIN_ARGTYPES[:-1] + [ctypes.c_int, ctypes.c_void_p]
_SIGNATURES = {"lambda_pairs_fwd": [ctypes.c_void_p] * 8 + _CLUSTER_ARGTYPES,
               "lambda_pairs_bwd": [ctypes.c_void_p] * 8 + _CLUSTER_ARGTYPES}
# the kernels' warps a block (csrc/lambda_pairs.cu's kPairWarps)
CLUSTER_WARPS = 8


def check_scheme(scheme: Optional[str]) -> int:
    if scheme not in SCHEMES:
        raise ValueError(f"unknown weighing scheme {scheme!r}; known: "
                         f"{[s for s in SCHEMES if s]}")
    return SCHEMES.index(scheme)


def log2_positions(n: int) -> np.ndarray:
    """D[i] = log2(2 + i), computed in float64 and stored as float32."""
    return np.log2(np.arange(n, dtype=np.float64) + 2.0).astype(np.float32)


def ndcg2_deltas(n: int) -> np.ndarray:
    """The ndcgLoss2 delta table ``|1/D[|i-j|-1] - 1/D[|i-j|]|`` with a zero
    diagonal, [n, n], in float64 rounded to float32 (the JAX package's
    ``_ndcgLoss2_deltas``)."""
    return ndcg2_delta_by_distance(n)[
        np.abs(np.arange(n)[:, None] - np.arange(n)[None, :])]


def ndcg2_delta_by_distance(n: int) -> np.ndarray:
    """The same deltas as a function of ``t = |i - j|`` alone, [n]: the
    kernel's table."""
    D = np.log2(np.arange(n, dtype=np.float64) + 2.0)
    t = np.arange(n)
    out = np.abs(1.0 / D[np.clip(t - 1, 0, n - 1)] - 1.0 / D[t])
    out[0] = 0.0
    return out.astype(np.float32)


def pair_weights(scheme, g, ts, d_row, deltas, mu):
    """The reference's weighing schemes on [B, k] gains ``g`` and labels
    ``ts``, discounts ``d_row`` [k] and the ndcgLoss2 ``deltas`` [k, k]:
    [B, k, k] weights, or None for weight 1. The one definition of the
    schemes, shared by the kernel's plain version and the CPU loss."""
    if scheme is None or scheme == "rankNet_scheme":
        return None
    if scheme == "ndcgLoss1_scheme":
        return (g / d_row[None, :])[:, :, None].expand(-1, -1, g.shape[1])
    if scheme == "rankNetWeightedByGTDiff_scheme":
        return (ts[:, :, None] - ts[:, None, :]).abs()
    if scheme == "rankNetWeightedByGTDiffPowed_scheme":
        return (ts[:, :, None] ** 2 - ts[:, None, :] ** 2).abs()
    gdiff = (g[:, :, None] - g[:, None, :]).abs()
    if scheme == "ndcgLoss2_scheme":
        return deltas[None] * gdiff
    inv_d = 1.0 / d_row
    lrank = (inv_d[None, :, None] - inv_d[None, None, :]).abs() * gdiff
    if scheme == "lambdaRank_scheme":
        return lrank
    return mu * (deltas[None] * gdiff) + lrank


def _chain(yp, ts, g, valid, *, scheme, k_eff, sigma, mu, log_base, eps):
    """The TPU kernel's ``_chain`` on [B, L, L] tensors: returns
    ``(logs, sel, s, a, wlog, w)``."""
    b, n = yp.shape
    dev = yp.device
    d_row = torch.from_numpy(log2_positions(n)).to(dev)
    deltas = torch.from_numpy(ndcg2_deltas(n)).to(dev)
    pv = (valid[:, :, None] > 0.5) & (valid[:, None, :] > 0.5)
    sel = pv
    if scheme != "ndcgLoss1_scheme":
        sel = sel & ((ts[:, :, None] - ts[:, None, :]) > 0)
    if k_eff < n:
        idx = torch.arange(n, device=dev)
        top = idx < k_eff
        sel = sel & top[None, :, None] & top[None, None, :]
    d = torch.where(pv, yp[:, :, None] - yp[:, None, :], 0.0)
    d = torch.clamp(d, -1e8, 1e8)
    s = torch.sigmoid(sigma * d)
    a = torch.clamp(s, min=eps)
    w = pair_weights(scheme, g, ts, d_row, deltas, mu)
    log_a = torch.log(a)
    wlog = log_a if w is None else w * log_a
    logs = torch.clamp(wlog, min=float(np.log(eps)))
    if log_base == "binary":
        logs = logs / _LN2
    return logs, sel, s, a, wlog, w


def check_args(yp, kw):
    check_scheme(kw["scheme"])
    if kw["log_base"] not in ("natural", "binary"):
        raise ValueError("Reduction logarithm base can be either natural or "
                         "binary")
    if yp.dim() != 2:
        raise ValueError(f"inputs must be [B, k], got {tuple(yp.shape)}")


def lambda_pairs_fwd_plain(yp, ts, g, valid, **kw):
    """(per-slate loss sums [B], selected-pair counts [B]) in plain PyTorch
    ops."""
    check_args(yp, kw)
    logs, sel, *_ = _chain(yp, ts, g, valid, **kw)
    sel = sel.float()
    return (logs * sel).sum(dim=(1, 2)), sel.sum(dim=(1, 2))


def lambda_pairs_bwd_plain(yp, ts, g, valid, gout, **kw):
    """dL/dyp [B, k] for the loss sums' cotangent ``gout`` [B], in plain
    PyTorch ops (the TPU kernel's ``_bwd_kernel``)."""
    check_args(yp, kw)
    eps, sigma = kw["eps"], kw["sigma"]
    ln = _LN2 if kw["log_base"] == "binary" else 1.0
    _, sel, s, a, wlog, w = _chain(yp, ts, g, valid, **kw)
    w_over_a = 1.0 / a if w is None else w / a
    c = sel.float() * torch.where(wlog > float(np.log(eps)), w_over_a / ln,
                                  0.0)
    c = c * torch.where(s > eps, sigma * s * (1.0 - s), 0.0)
    return (c.sum(dim=2) - c.sum(dim=1)) * gout[:, None]


_TABLES: dict = {}


def position_tables(n: int, dev) -> tuple:
    """The [n] tables (log2 discounts, ndcgLoss2 deltas by distance) on
    ``dev``, copied there once: a host-to-device copy per call would stall
    the host until the device caught up."""
    key = (n, dev)
    if key not in _TABLES:
        # a tensor made under inference mode could not enter autograd later
        with torch.inference_mode(False):
            _TABLES[key] = (
                torch.from_numpy(log2_positions(n)).to(dev),
                torch.from_numpy(ndcg2_delta_by_distance(n)).to(dev))
    return _TABLES[key]


def cluster_size(k: int) -> int:
    """The blocks of a slate's thread-block cluster at top-k length ``k``
    (1 <= k <= ``MAX_FUSED_LENGTH``): one warp's sweep of 32 columns a row
    tile, so 1 to k = 32, 2 to 64, else 4 (256 blocks at B = 64)."""
    if not 1 <= k <= MAX_FUSED_LENGTH:
        raise ValueError(f"no cluster for a top-k block of {k}")
    return 1 if k <= 32 else 2 if k <= 64 else 4


def rows_of(rank: int, warp: int, cluster: int, k: int) -> range:
    """The rows that warp ``warp`` of block ``rank`` of a ``cluster``-block
    cluster sweeps, as the kernels walk them: rows interleaved across the
    blocks, then across the ``CLUSTER_WARPS`` warps, so that a short k_eff
    or a padding tail still spreads over every block."""
    return range(rank + cluster * warp, k, cluster * CLUSTER_WARPS)


def launch_chain(lib_name, signatures, name, yp, ts, g, valid, extra, outs,
                 kw, ints=()):
    """Launches function ``name`` of ``csrc/<lib_name>.cu`` on the chain's
    [B, k] inputs, the position tables, ``extra`` inputs and ``outs``, the
    chain's scalars and ``ints``, in the order of its C signature, after
    checking every [B, k] argument; the call both pair-chain kernels
    make."""
    b, n = yp.shape
    dev = yp.device
    for t_name, t in (("y_pred_sorted", yp), ("true_sorted", ts),
                      ("gains", g), ("valid", valid)):
        _build.require(t, t_name, (b, n), torch.float32, dev)
    tables = position_tables(n, dev)
    eps = float(kw["eps"])
    lib = _build.load(lib_name, signatures)
    with torch.cuda.device(dev):
        rc = getattr(lib, name)(
            *map(_build.ptr, (yp, ts, g, valid, *tables, *extra, *outs)),
            b, n, int(kw["k_eff"]), check_scheme(kw["scheme"]),
            int(kw["log_base"] == "binary"), float(kw["sigma"]),
            float(kw["mu"]), eps, float(np.log(eps)), *ints,
            _build.stream_of(yp))
    _build.check_launch(lib, rc, name)


def _launch(name, yp, ts, g, valid, extra, outs, kw):
    n = yp.shape[1]
    if n > MAX_FUSED_LENGTH:
        raise NotImplementedError(
            f"the lambdaLoss pair kernel covers k <= {MAX_FUSED_LENGTH}, got "
            f"{n}; longer top-k blocks take the tiled kernel "
            f"(ops/lambda_tiled.tiled_lambda_pairs)")
    launch_chain("lambda_pairs", _SIGNATURES, name, yp, ts, g, valid, extra,
                 outs, kw, (cluster_size(n),))


def lambda_pairs_fwd(yp, ts, g, valid, **kw):
    """(loss sums [B], counts [B]). A CPU tensor takes the plain version; a
    CUDA tensor launches the forward kernel or raises."""
    if yp.device.type == "cpu":
        return lambda_pairs_fwd_plain(yp, ts, g, valid, **kw)
    if yp.device.type != "cuda":
        raise ValueError(f"no lambdaLoss pair chain for device {yp.device}")
    check_args(yp, kw)
    loss = torch.empty(yp.shape[0], dtype=torch.float32, device=yp.device)
    cnt = torch.empty_like(loss)
    _launch("lambda_pairs_fwd", yp, ts, g, valid, (), (loss, cnt), kw)
    lambda_pairs_fwd.launches += 1
    return loss, cnt


lambda_pairs_fwd.launches = 0


def lambda_pairs_bwd(yp, ts, g, valid, gout, **kw):
    """dL/dyp [B, k]. A CPU tensor takes the plain version; a CUDA tensor
    launches the backward kernel or raises."""
    if yp.device.type == "cpu":
        return lambda_pairs_bwd_plain(yp, ts, g, valid, gout, **kw)
    if yp.device.type != "cuda":
        raise ValueError(f"no lambdaLoss pair chain for device {yp.device}")
    check_args(yp, kw)
    _build.require(gout, "gout", (yp.shape[0],), torch.float32, yp.device)
    dyp = torch.empty_like(yp)
    _launch("lambda_pairs_bwd", yp, ts, g, valid, (gout,), (dyp,), kw)
    lambda_pairs_bwd.launches += 1
    return dyp


lambda_pairs_bwd.launches = 0


class LambdaPairs(torch.autograd.Function):
    """The chain under autograd; gradients flow to ``y_pred_sorted`` only
    (the counts carry none)."""

    @staticmethod
    def forward(ctx, yp, ts, g, valid, kw):
        ctx.save_for_backward(yp, ts, g, valid)
        ctx.kw = kw
        loss, cnt = lambda_pairs_fwd(yp, ts, g, valid, **kw)
        ctx.mark_non_differentiable(cnt)
        return loss, cnt

    @staticmethod
    def backward(ctx, g_loss, _g_cnt):
        yp, ts, g, valid = ctx.saved_tensors
        dyp = lambda_pairs_bwd(yp, ts, g, valid, g_loss.float().contiguous(),
                               **ctx.kw)
        return dyp, None, None, None, None


def fused_lambda_pairs(y_pred_sorted, true_sorted, gains, valid, *, scheme,
                       k_eff: int, sigma: float, mu: float, log_base: str,
                       eps: float):
    """(per-slate loss sums [B], selected-pair counts [B]) of the lambdaLoss
    pair chain; all inputs [B, k] (``valid`` as 0/1 floats), cast to fp32.
    On CUDA, k above ``MAX_FUSED_LENGTH`` raises ``NotImplementedError``."""
    kw = dict(scheme=scheme, k_eff=int(k_eff), sigma=float(sigma),
              mu=float(mu), log_base=str(log_base), eps=float(eps))
    args = [t.float().contiguous() for t in (y_pred_sorted, true_sorted,
                                              gains, valid)]
    return LambdaPairs.apply(*args, kw)

