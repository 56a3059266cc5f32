"""The attention sublayer forward with one stage changed (X3), bf16: the
CUDA kernels of ``csrc/attention_variants.cu`` for CUDA tensors and their
plain PyTorch versions for CPU tensors.

Replaces the TPU kernel ``make_variant`` of the JAX package's
``tools/exp_attn_decompose.py:114`` (``pallas_call`` at line 126, math in
``_variant_fwd_vmem``, lines 54-103): B1's forward at dropout 0
(``ops/attention_block.py``) in one of ``MODES``, which differ in the
attention core alone (wrong math, honest timing):

- ``full``: B1's own forward;
- ``no_softmax``: p = masked scores x 0.001;
- ``exp2``: e = exp2((s - max) log2(e)) in place of exp;
- ``norm_after_pv``: ctx = (e . v) / sum e, the row scale after P.V;
- ``no_pv``: ctx = v + 0.001 p[:, :, :d_k], no P.V (needs L >= d_k);
- ``frame``: ctx = q + k + v, no attention core at all.

Arguments are B1's: ``x`` [B, L, d] bf16, ``key_mask`` [B, L] bool (True at
padded documents), fp32 parameters in B1's layout. The probe CLI is
``allrank_tpu_torch.tools.exp_attn_decompose``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from allrank_tpu_torch.constants import NEG_INF_FILL
from allrank_tpu_torch.models.core import std_layer_norm
from allrank_tpu_torch.ops import _build
from allrank_tpu_torch.ops.attention_block import _heads, check_envelope

MODES = ("full", "no_softmax", "exp2", "norm_after_pv", "no_pv", "frame")
LOG2E = 1.4426950408889634
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"attention_variant_fwd": [_P] * 10 + [_I] * 4
               + [ctypes.c_float, _I, _P]}


def attention_variant_fwd_plain(x, key_mask, ln_scale, ln_bias, wqkv, bqkv,
                                wout, bout, h: int, mode: str = "full"):
    """The mode's function in plain PyTorch ops, with B1's rounding points
    (after LN, after the QKV projection, the probabilities before P.V, ctx)
    and each mode's own (``_variant_fwd_vmem``)."""
    b, l, d = x.shape
    dk = d // h
    dtype = x.dtype
    x32 = x.float()
    n = std_layer_norm(x32, ln_scale, ln_bias).to(dtype).float()
    qkv = (n @ wqkv.to(dtype).float() + bqkv).to(dtype)
    if mode == "frame":
        q, k, v = qkv.split(d, dim=-1)
        ctx = q + k + v                       # each sum rounded to dtype
    else:
        q, k, v = (_heads(t, b, l, h) for t in qkv.split(d, dim=-1))
        scores = (q.float() @ k.float().transpose(-1, -2)) * (
            1.0 / math.sqrt(dk))
        scores = scores.masked_fill(key_mask[:, None, None, :], NEG_INF_FILL)
        vf = v.float()
        if mode == "no_softmax":
            ctx = (scores * 0.001).to(dtype).float() @ vf
        else:
            shifted = scores - scores.amax(dim=-1, keepdim=True)
            e = torch.exp2(shifted * LOG2E) if mode == "exp2" else torch.exp(
                shifted)
            inv = 1.0 / e.sum(dim=-1, keepdim=True)
            if mode == "norm_after_pv":
                ctx = (e.to(dtype).float() @ vf) * inv
            elif mode == "no_pv":
                ctx = v + (e * inv)[..., :dk].to(dtype) * 0.001
            else:
                ctx = (e * inv).to(dtype).float() @ vf
        ctx = ctx.to(dtype).transpose(1, 2).reshape(b, l, d)
    a = ctx.float() @ wout.to(dtype).float() + bout
    return (x32 + a).to(dtype)


def _check(x, key_mask, params, h, mode):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if x.dim() != 3:
        raise ValueError(f"x must be [B, L, d], got {tuple(x.shape)}")
    b, l, d = x.shape
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the variants take bfloat16 x, got {x.dtype}")
    check_envelope(b, l, d, x.dtype, h)
    if mode == "no_pv" and l < d // h:
        raise ValueError(f"no_pv slices the first d_k = {d // h} keys and "
                         f"needs L >= d_k, got L = {l}")
    dev = x.device
    _build.require(key_mask, "key_mask", (b, l), torch.bool, dev)
    for name, t, shape in zip(
            ("ln_scale", "ln_bias", "wqkv", "bqkv", "wout", "bout"), params,
            ((d,), (d,), (d, 3 * d), (3 * d,), (d, d), (d,))):
        _build.require(t, name, shape, torch.float32, dev)
    return b, l, d


def attention_variant_fwd(x, key_mask, ln_scale, ln_bias, wqkv, bqkv, wout,
                          bout, h: int, mode: str = "full"):
    """y [B, L, d] bf16. A CPU tensor takes the plain version; a CUDA
    tensor launches the mode's two kernels (LN + QKV, then the changed
    attention core + out-projection + residual) or raises."""
    params = (ln_scale, ln_bias, wqkv, bqkv, wout, bout)
    b, l, d = _check(x, key_mask, params, h, mode)
    if x.device.type == "cpu":
        return attention_variant_fwd_plain(x, key_mask, *params, h, mode)
    if x.device.type != "cuda":
        raise ValueError(f"no attention variant for device {x.device}")
    _build.require(x, "x", (b, l, d), torch.bfloat16, x.device)
    y = torch.empty_like(x)
    qkv = torch.empty((b, l, 3 * d), dtype=x.dtype, device=x.device)
    lib = _build.load("attention_variants", _SIGNATURES)
    with torch.cuda.device(x.device):
        rc = lib.attention_variant_fwd(
            *map(_build.ptr, (x, key_mask) + params + (qkv, y)),
            b, l, d, h, 1.0 / math.sqrt(d // h), MODES.index(mode),
            _build.stream_of(x))
    _build.check_launch(lib, rc, "attention_variant_fwd")
    attention_variant_fwd.launches[mode] += 1
    return y


attention_variant_fwd.launches = dict.fromkeys(MODES, 0)
