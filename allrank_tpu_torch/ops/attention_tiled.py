"""Masked slate attention for long slates with the K-streamed online softmax
(B5), forward and backward: the CUDA kernels of ``csrc/attention_tiled.cu``
for CUDA tensors (B4's routes, ``ops/attention_fused.route``: bf16 and fp32
both on the tensor cores, fp32 as 3xTF32 split products) and their plain
PyTorch versions, of the same signatures, for CPU tensors;
``TiledAttention`` ties the two into autograd.

Replaces the TPU kernel ``tiled_slate_attention`` of the JAX package's
``ops/attention_tiled.py`` (forward ``pallas_call`` at line 228, backward
at line 265). The function is B4's (``ops/attention_fused.py``: same
layouts, mask and dropout stream), computed key tile by key tile with the
recurrence of the TPU kernel (``attention_tiled.py:78-101``): m from -1e30,
an undropped denominator, the keep mask on the accumulator only, ``O = acc *
(inv / max(l, 1e-30))``, and the row logsumexp ``lse = m + log(max(l,
1e-30))`` kept for the backward, which rebuilds P = exp(s - lse) and takes
D = rowsum(dO * O). In bf16 the unnormalised probabilities are rounded to
v's dtype before P . v, so the plain version walks the kernel's own key
tiles, ``TILE_K`` wide.

One difference from the TPU kernel, on purpose: keys past L take no part
(weight 0). The TPU kernel pads keys to a multiple of its tile width with
the padding mask set, so on a fully padded slate it averages v over the
padded length; here, as in B4 and the XLA path, over the slate's L keys
(ROADMAP Queue C).
"""

from __future__ import annotations

import ctypes
import math

import torch

from allrank_tpu_torch.constants import NEG_INF_FILL
from allrank_tpu_torch.ops import _build, dropout
from allrank_tpu_torch.ops.attention_fused import (
    _I,
    _P,
    _TAIL,
    ROUTES,
    check_args,
    probs_keep,
    probs_keys,
    route,
)

TILE_K = 64  # the kernels' key tile (kKeyTile in csrc/attention_tiled.cu)
_SIGNATURES = {
    "tiled_attention_fwd": [_P] * 6 + [_I] * 4 + _TAIL,
    "tiled_attention_bwd": [_P] * 11 + [_I] * 4 + _TAIL,
}


def _scores(qf, kf, key_mask, scale):
    s = (qf @ kf.transpose(-1, -2)) * scale
    return s.masked_fill(key_mask[:, None, None, :], NEG_INF_FILL)


def tiled_attention_fwd_plain(q, k, v, key_mask, p_drop: float = 0.0,
                              seed: int = 0):
    """``(out, lse)``: the online recurrence over key tiles of the kernel's
    width, vectorised over slates, heads and queries, with its rounding
    points and dropout mask."""
    p_drop = dropout.check_rate(p_drop)
    b, h, l, dk = q.shape
    dtype = q.dtype
    scale = 1.0 / math.sqrt(dk)
    qf, kf, vf = q.float(), k.float(), v.float()
    keep = probs_keep(seed, p_drop, b, h, l, q.device)
    m = torch.full((b, h, l), -1e30, device=q.device)
    run = torch.zeros((b, h, l), device=q.device)
    acc = torch.zeros((b, h, l, dk), device=q.device)
    for k0 in range(0, l, TILE_K):
        k1 = min(k0 + TILE_K, l)
        s = _scores(qf, kf[:, :, k0:k1], key_mask[:, k0:k1], scale)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        run = run * alpha + p.sum(dim=-1)
        if keep is not None:
            p = torch.where(keep[..., k0:k1], p, 0.0)
        acc = acc * alpha[..., None] + p.to(dtype).float() @ vf[:, :, k0:k1]
        m = m_new
    denom = torch.clamp(run, min=1e-30)
    inv = 1.0 / (1.0 - p_drop) if p_drop else 1.0
    out = (acc * (inv / denom)[..., None]).to(dtype)
    return out, m + torch.log(denom)


def tiled_attention_bwd_plain(q, k, v, key_mask, out, lse, do,
                              p_drop: float = 0.0, seed: int = 0):
    """``(dq, dk, dv)`` written out as the TPU kernel's ``_bwd_kernel``
    (the JAX package's ``ops/attention_tiled.py:104-143``): P from the
    forward's ``lse``, D = rowsum(dO * O) in fp32, and its rounding points;
    in q's dtype."""
    p_drop = dropout.check_rate(p_drop)
    b, h, l, dk = q.shape
    dtype = q.dtype
    scale = 1.0 / math.sqrt(dk)
    qf, kf, vf = q.float(), k.float(), v.float()
    dof = do.to(dtype).float()
    delta = (do.float() * out.float()).sum(dim=-1, keepdim=True)
    p = torch.exp(_scores(qf, kf, key_mask, scale) - lse[..., None])
    dp = dof @ vf.transpose(-1, -2)
    keep = probs_keep(seed, p_drop, b, h, l, q.device)
    pd = p
    if keep is not None:
        inv = 1.0 / (1.0 - p_drop)
        pd = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    dv = pd.to(dtype).float().transpose(-1, -2) @ dof
    ds = (p * (dp - delta)).masked_fill(key_mask[:, None, None, :], 0.0)
    ds = ds.to(dtype).float()
    dq = (ds @ kf) * scale
    dkk = (ds.transpose(-1, -2) @ qf) * scale
    return dq.to(dtype), dkk.to(dtype), dv.to(dtype)


def tiled_attention_fwd(q, k, v, key_mask, p_drop: float = 0.0,
                        seed: int = 0, return_saved: bool = False):
    """``out`` [B, h, L, d_k] in q's dtype. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel of ``route``'s answer or
    raises. With ``return_saved`` returns ``(out, lse)``, lse [B, h, L]
    fp32."""
    if q.device.type == "cpu":
        out, lse = tiled_attention_fwd_plain(q, k, v, key_mask, p_drop, seed)
        return (out, lse) if return_saved else out
    if q.device.type != "cuda":
        raise ValueError(f"no tiled attention for device {q.device}")
    p_drop = dropout.check_rate(p_drop)
    b, h, l, dk = check_args(q, k, v, key_mask)
    way = route(q.dtype, dk)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, l), dtype=torch.float32, device=q.device)
           if return_saved else None)
    lib = _build.load("attention_tiled", _SIGNATURES)
    with torch.cuda.device(q.device):
        rc = lib.tiled_attention_fwd(
            *map(_build.ptr, (q, k, v, key_mask, out)),
            _build.ptr(lse) if lse is not None else None,
            b * h, l, dk, h, 1.0 / math.sqrt(dk),
            int(q.dtype == torch.bfloat16), probs_keys(seed, p_drop), p_drop,
            _build.stream_of(q))
    _build.check_launch(lib, rc, "tiled_attention_fwd")
    tiled_attention_fwd.launches += 1
    tiled_attention_fwd.route_launches[way] += 1
    return (out, lse) if return_saved else out


tiled_attention_fwd.launches = 0
tiled_attention_fwd.route_launches = dict.fromkeys(ROUTES, 0)


def tiled_attention_bwd(q, k, v, key_mask, out, lse, do, p_drop: float = 0.0,
                        seed: int = 0):
    """``(dq, dk, dv)`` for the output gradient ``do``, from the forward's
    ``out`` and ``lse`` for the same inputs, seed and rate. A CPU tensor
    takes the plain version; a CUDA tensor launches the backward kernels
    of ``route``'s answer or raises. D = rowsum(dO * O) is taken first in
    PyTorch ops in bf16, as the JAX package takes it in XLA; in fp32 the dQ
    kernel takes it through the split product it takes dP by (under
    dropout as rowsum(dPd * P), B4's row term), so that dP - D cancels
    exactly where a row has one key."""
    if q.device.type == "cpu":
        return tiled_attention_bwd_plain(q, k, v, key_mask, out, lse, do,
                                         p_drop, seed)
    if q.device.type != "cuda":
        raise ValueError(f"no tiled attention for device {q.device}")
    p_drop = dropout.check_rate(p_drop)
    b, h, l, dk = q.shape
    check_args(q, k, v, key_mask, out=(out, (b, h, l, dk), q.dtype),
               lse=(lse, (b, h, l), torch.float32),
               do=(do, (b, h, l, dk), q.dtype))
    way = route(q.dtype, dk)
    if q.dtype == torch.bfloat16:
        delta = (do.float() * out.float()).sum(dim=-1)
    else:
        delta = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    grads = [torch.empty_like(q) for _ in range(3)]
    lib = _build.load("attention_tiled", _SIGNATURES)
    with torch.cuda.device(q.device):
        rc = lib.tiled_attention_bwd(
            *map(_build.ptr, (q, k, v, key_mask, out, lse, delta, do,
                              *grads)),
            b * h, l, dk, h, 1.0 / math.sqrt(dk),
            int(q.dtype == torch.bfloat16), probs_keys(seed, p_drop), p_drop,
            _build.stream_of(q))
    _build.check_launch(lib, rc, "tiled_attention_bwd")
    tiled_attention_bwd.launches += 1
    tiled_attention_bwd.route_launches[way] += 1
    return tuple(grads)


tiled_attention_bwd.launches = 0
tiled_attention_bwd.route_launches = dict.fromkeys(ROUTES, 0)


class TiledAttention(torch.autograd.Function):
    """B5 under autograd: the forward keeps q, k, v, the output and its
    row logsumexp; the backward is ``tiled_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, p_drop, seed):
        out, lse = tiled_attention_fwd(q, k, v, key_mask, p_drop, seed,
                                       return_saved=True)
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        ctx.config = (p_drop, seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        grads = tiled_attention_bwd(q, k, v, key_mask, out, lse,
                                    dout.to(q.dtype).contiguous(),
                                    *ctx.config)
        return grads + (None,) * 3


def tiled_slate_attention(q, k, v, key_mask, p_drop: float = 0.0,
                          seed: int = 0):
    """B5 as the encoder calls it: through ``TiledAttention`` when autograd
    records, else the forward alone."""
    if torch.is_grad_enabled():
        return TiledAttention.apply(q, k, v, key_mask, p_drop, seed)
    return tiled_attention_fwd(q, k, v, key_mask, p_drop, seed)
