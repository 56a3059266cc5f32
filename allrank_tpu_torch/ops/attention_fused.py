"""Masked slate attention with the exact, normalised probabilities (B4),
``out = drop(softmax(q . k^T / sqrt(d_k), padded keys -1e9)) . v``, forward
and backward: the CUDA kernels of ``csrc/attention_fused.cu`` for CUDA
tensors and their plain PyTorch versions, of the same signatures, for CPU
tensors; ``FusedAttention`` ties the two into autograd. Two routes of
kernels (``route``), both on the tensor cores: bf16 on bf16 products
(``"mma"``), fp32 on 3xTF32 split products (``"tf32x3"``,
``csrc/attention_tf32x3.cuh``: each fp32 operand split into two TF32
halves, three TF32 products summed in fp32, some 2^-21 of a product
against fp32's 2^-24).

Replaces the TPU kernel ``fused_slate_attention`` of the JAX package's
``ops/attention_pallas.py`` (forward ``pallas_call`` at line 179, backward
at line 206). q, k, v are ``[B, h, L, d_k]`` float32 or bfloat16 (the JAX
layout), ``key_mask`` ``[B, L]`` bool, True at padded documents. The
probabilities are ``exp(s - max) * (1 / sum)`` as the TPU kernel's
``_probs``; dropout on them (stream ``ATTN_PROBS``, index
``((b * h + head) * L + i) * L + j``) comes from ``ops/dropout.py``, so it
is the mask the attention sublayer (B1) draws from the same seed. In bf16
every version rounds where the TPU kernel does: P dropped before P . v, and
in the backward P dropped before dV and dS before dQ and dK. The backward's
row term is D = rowsum(dPd * P), the TPU kernel's.

The envelope of both bare attention kernels (B4 here and B5 in
``ops/attention_tiled.py``) is ``check_envelope``'s: d_k <= 128, L <= 8192;
``route`` names the kernels a call takes before any launch.
"""

from __future__ import annotations

import ctypes
import math

import torch

from allrank_tpu_torch.ops import _build, dropout
from allrank_tpu_torch.ops.attention_block import _probs

MAX_HEAD_DIM = 128
MAX_LEN = 8192
MAX_GROUPS = 65535  # B * h: the grid's second axis
DTYPES = (torch.float32, torch.bfloat16)
_P = ctypes.c_void_p
_I = ctypes.c_int
_TAIL = [ctypes.c_float, _I, _P, ctypes.c_double, _P]
_SIGNATURES = {
    "attention_fused_fwd": [_P] * 6 + [_I] * 4 + _TAIL,
    "attention_fused_bwd": [_P] * 10 + [_I] * 4 + _TAIL,
}


ROUTES = ("mma", "tf32x3")


def route(dtype, dk: int) -> str:
    """The kernels a CUDA call of B4 or B5 takes, from dtype and d_k alone,
    before any launch: ``"mma"`` (bf16 x bf16 products) for bf16,
    ``"tf32x3"`` (three TF32 products an fp32 product) for fp32. Raises
    ``NotImplementedError`` outside the kernels' envelope."""
    check_envelope(1, 1, 1, dk, dtype)
    return "mma" if dtype == torch.bfloat16 else "tf32x3"


def check_envelope(b: int, h: int, l: int, dk: int, dtype) -> None:
    """Raises ``NotImplementedError`` naming the limit the bare attention
    kernels do not cover."""
    if dtype not in DTYPES:
        raise NotImplementedError(
            f"attention kernels take float32 or bfloat16 q, k, v, got {dtype}")
    if not 1 <= dk <= MAX_HEAD_DIM:
        raise NotImplementedError(
            f"attention kernels cover d_k <= {MAX_HEAD_DIM}, got {dk}")
    if not 1 <= l <= MAX_LEN:
        raise NotImplementedError(
            f"attention kernels cover 1 <= L <= {MAX_LEN}, got {l}")
    if not 1 <= b * h <= MAX_GROUPS:
        raise NotImplementedError(
            f"attention kernels cover 1 <= B * h <= {MAX_GROUPS}, got "
            f"{b * h}")


def check_args(q, k, v, key_mask, **more):
    """Validates q, k, v, key_mask (and the named extra tensors, given as
    ``name=(tensor, shape, dtype)``) before pointers go to C; returns
    ``(b, h, l, dk)``."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B, h, L, d_k], got {tuple(q.shape)}")
    b, h, l, dk = q.shape
    check_envelope(b, h, l, dk, q.dtype)
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(t, name, (b, h, l, dk), q.dtype, dev)
    _build.require(key_mask, "key_mask", (b, l), torch.bool, dev)
    for name, (t, shape, dtype) in more.items():
        _build.require(t, name, shape, dtype, dev)
    return b, h, l, dk


def probs_keys(seed: int, p_drop: float) -> ctypes.Array:
    return dropout.key_array(
        dropout.kernel_keys(seed, dropout.ATTN_PROBS, p_drop))


def probs_keep(seed: int, p_drop: float, b: int, h: int, l: int, device):
    """The keep mask of the attention probabilities, None at rate 0."""
    if not p_drop:
        return None
    return dropout.keep_mask(seed, dropout.ATTN_PROBS, p_drop, (b, h, l, l),
                             device)


def attention_fused_fwd_plain(q, k, v, key_mask, p_drop: float = 0.0,
                              seed: int = 0):
    """The materialised formula with the kernel's rounding points and
    dropout mask: ``_probs``, dropout, then P . v."""
    p_drop = dropout.check_rate(p_drop)
    b, h, l, dk = q.shape
    dtype = q.dtype
    p = _probs(q.float(), k.float(), key_mask, 1.0 / math.sqrt(dk))
    keep = probs_keep(seed, p_drop, b, h, l, q.device)
    if keep is not None:
        p = torch.where(keep, p / (1.0 - p_drop), 0.0)
    return (p.to(dtype).float() @ v.float()).to(dtype)


def attention_fused_bwd_plain(q, k, v, key_mask, do, p_drop: float = 0.0,
                              seed: int = 0):
    """``(dq, dk, dv)`` written out as the TPU kernel's ``_bwd_kernel``
    (the JAX package's ``ops/attention_pallas.py:95-117``), with D =
    rowsum(dPd * P) and its rounding points; in q's dtype."""
    p_drop = dropout.check_rate(p_drop)
    b, h, l, dk = q.shape
    dtype = q.dtype
    scale = 1.0 / math.sqrt(dk)
    qf, kf, vf = q.float(), k.float(), v.float()
    dof = do.to(dtype).float()
    p = _probs(qf, kf, key_mask, scale)
    keep = probs_keep(seed, p_drop, b, h, l, q.device)
    pd = p
    dp = dof @ vf.transpose(-1, -2)
    if keep is not None:
        inv = 1.0 / (1.0 - p_drop)
        pd = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    dv = pd.to(dtype).float().transpose(-1, -2) @ dof
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds = ds.masked_fill(key_mask[:, None, None, :], 0.0).to(dtype).float()
    dq = (ds @ kf) * scale
    dkk = (ds.transpose(-1, -2) @ qf) * scale
    return dq.to(dtype), dkk.to(dtype), dv.to(dtype)


def attention_fused_fwd(q, k, v, key_mask, p_drop: float = 0.0,
                        seed: int = 0, return_saved: bool = False):
    """``out`` [B, h, L, d_k] in q's dtype. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel of ``route``'s answer or
    raises. With ``return_saved`` returns ``(out, stats)``: on CUDA each
    row's softmax max and sum [B, h, L, 2] fp32, which the backward kernels
    read; on the CPU None."""
    if q.device.type == "cpu":
        out = attention_fused_fwd_plain(q, k, v, key_mask, p_drop, seed)
        return (out, None) if return_saved else out
    if q.device.type != "cuda":
        raise ValueError(f"no fused attention for device {q.device}")
    p_drop = dropout.check_rate(p_drop)
    b, h, l, dk = check_args(q, k, v, key_mask)
    way = route(q.dtype, dk)
    out = torch.empty_like(q)
    stats = (torch.empty((b, h, l, 2), dtype=torch.float32, device=q.device)
             if return_saved else None)
    lib = _build.load("attention_fused", _SIGNATURES)
    with torch.cuda.device(q.device):
        rc = lib.attention_fused_fwd(
            *map(_build.ptr, (q, k, v, key_mask, out)),
            _build.ptr(stats) if stats is not None else None,
            b * h, l, dk, h, 1.0 / math.sqrt(dk),
            int(q.dtype == torch.bfloat16), probs_keys(seed, p_drop), p_drop,
            _build.stream_of(q))
    _build.check_launch(lib, rc, "attention_fused_fwd")
    attention_fused_fwd.launches += 1
    attention_fused_fwd.route_launches[way] += 1
    return (out, stats) if return_saved else out


attention_fused_fwd.launches = 0
attention_fused_fwd.route_launches = dict.fromkeys(ROUTES, 0)


def attention_fused_bwd(q, k, v, key_mask, do, p_drop: float = 0.0,
                        seed: int = 0, stats=None):
    """``(dq, dk, dv)`` for the output gradient ``do``. A CPU tensor takes
    the plain version; a CUDA tensor launches the backward kernels on
    ``stats``, the forward kernel's for the same inputs, seed and rate, or
    raises."""
    if q.device.type == "cpu":
        return attention_fused_bwd_plain(q, k, v, key_mask, do, p_drop, seed)
    if q.device.type != "cuda":
        raise ValueError(f"no fused attention for device {q.device}")
    p_drop = dropout.check_rate(p_drop)
    if stats is None:
        raise ValueError("the backward kernels need the forward's row "
                         "statistics (return_saved=True)")
    b, h, l, dk = q.shape
    check_args(q, k, v, key_mask, do=(do, (b, h, l, dk), q.dtype),
               stats=(stats, (b, h, l, 2), torch.float32))
    way = route(q.dtype, dk)
    grads = [torch.empty_like(q) for _ in range(3)]
    d_rows = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    lib = _build.load("attention_fused", _SIGNATURES)
    with torch.cuda.device(q.device):
        rc = lib.attention_fused_bwd(
            *map(_build.ptr, (q, k, v, key_mask, stats, do, d_rows, *grads)),
            b * h, l, dk, h, 1.0 / math.sqrt(dk),
            int(q.dtype == torch.bfloat16), probs_keys(seed, p_drop), p_drop,
            _build.stream_of(q))
    _build.check_launch(lib, rc, "attention_fused_bwd")
    attention_fused_bwd.launches += 1
    attention_fused_bwd.route_launches[way] += 1
    return tuple(grads)


attention_fused_bwd.launches = 0
attention_fused_bwd.route_launches = dict.fromkeys(ROUTES, 0)


class FusedAttention(torch.autograd.Function):
    """B4 under autograd: the forward (kernel or plain version by device)
    keeps q, k, v and, on CUDA, the row statistics; the backward is
    ``attention_fused_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, p_drop, seed):
        out, stats = attention_fused_fwd(q, k, v, key_mask, p_drop, seed,
                                         return_saved=True)
        ctx.save_for_backward(q, k, v, key_mask,
                              *(() if stats is None else (stats,)))
        ctx.config = (p_drop, seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_mask, *stats = ctx.saved_tensors
        grads = attention_fused_bwd(q, k, v, key_mask,
                                    dout.to(q.dtype).contiguous(),
                                    *ctx.config,
                                    stats=stats[0] if stats else None)
        return grads + (None,) * 3


def fused_slate_attention(q, k, v, key_mask, p_drop: float = 0.0,
                          seed: int = 0):
    """B4 as the encoder calls it: through ``FusedAttention`` when autograd
    records, else the forward alone."""
    if torch.is_grad_enabled():
        return FusedAttention.apply(q, k, v, key_mask, p_drop, seed)
    return attention_fused_fwd(q, k, v, key_mask, p_drop, seed)
