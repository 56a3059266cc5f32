"""FFN sublayer, ``y = x + drop_r(drop_h(relu(LN(x) . W1 + b1)) . W2 + b2)``,
forward and backward: the CUDA kernels of ``csrc/ffn_block.cu`` for CUDA
tensors and their plain PyTorch versions, of the same signatures, for CPU
tensors; ``FFNSublayer`` ties the two into autograd.

Replaces the TPU kernel ``ffn_sublayer`` of the JAX package's
``ops/ffn_block.py`` (forward ``pallas_call`` at line 204, backward at line
233). Dropout on the hidden activation (stream ``FFN_HIDDEN``, seed
``seeds[0]``) and on the output (``FFN_RESID``, ``seeds[1]``) comes from
``ops/dropout.py``. In bf16 every version rounds where the TPU kernel does:
after LN and the hidden activation before W2, and in the backward dout and
dh; products accumulate in fp32, the residual is added in fp32 and the
parameter gradients are fp32. ``w1`` is ``[d, d_ff]``, ``w2`` is
``[d_ff, d]``; parameters are float32.
"""

from __future__ import annotations

import ctypes

import torch

from allrank_tpu_torch.models.core import std_layer_norm
from allrank_tpu_torch.ops import _build, dropout
from allrank_tpu_torch.ops.attention_block import (
    check_envelope,
    ln_backward,
    splits,
)

MAX_FF = 1024
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ffn_sublayer_fwd": [_P] * 8 + [_I] * 4
    + [_P, ctypes.c_double, ctypes.c_double, _P],
    "ffn_sublayer_bwd": [_P] * 21 + [_I] * 6
    + [_P, ctypes.c_double, ctypes.c_double, _P],
}


def _masks(m_shape, d_ff, p_hidden, p_resid, seeds, device):
    keep_h = keep_r = None
    if p_hidden:
        keep_h = dropout.keep_mask(seeds[0], dropout.FFN_HIDDEN, p_hidden,
                                   tuple(m_shape[:-1]) + (d_ff,), device)
    if p_resid:
        keep_r = dropout.keep_mask(seeds[1], dropout.FFN_RESID, p_resid,
                                   m_shape, device)
    return keep_h, keep_r


def ffn_sublayer_fwd_plain(x, ln_scale, ln_bias, w1, b1, w2, b2,
                           p_hidden: float = 0.0, p_resid: float = 0.0,
                           seeds=(0, 0)):
    """The same function in plain PyTorch ops, with the kernel's rounding
    points and dropout masks."""
    p_hidden = dropout.check_rate(p_hidden)
    p_resid = dropout.check_rate(p_resid)
    dtype = x.dtype
    x32 = x.float()
    keep_h, keep_r = _masks(x.shape, w1.shape[-1], p_hidden, p_resid, seeds,
                            x.device)
    n = std_layer_norm(x32, ln_scale, ln_bias).to(dtype).float()
    hidden = torch.relu(n @ w1.to(dtype).float() + b1)
    if keep_h is not None:
        hidden = torch.where(keep_h, hidden / (1.0 - p_hidden), 0.0)
    out = hidden.to(dtype).float() @ w2.to(dtype).float() + b2
    if keep_r is not None:
        out = torch.where(keep_r, out / (1.0 - p_resid), 0.0)
    return (x32 + out).to(dtype)


def ffn_sublayer_bwd_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, dy,
                           p_hidden: float = 0.0, p_resid: float = 0.0,
                           seeds=(0, 0)):
    """The backward in plain PyTorch ops, mirroring the TPU kernel's
    ``ffn_sublayer_bwd_vmem`` (the JAX package's ``ops/ffn_block.py:76-132``)
    with its rounding points. Returns ``(dx, dg, db, dw1, db1, dw2, db2)``:
    dx in x's dtype, the parameter gradients fp32."""
    del b2  # the output bias does not enter the backward
    p_hidden = dropout.check_rate(p_hidden)
    p_resid = dropout.check_rate(p_resid)
    dtype = x.dtype
    x32 = x.float()
    dy = dy.to(dtype).float()
    keep_h, keep_r = _masks(x.shape, w1.shape[-1], p_hidden, p_resid, seeds,
                            x.device)
    n = std_layer_norm(x32, ln_scale, ln_bias).to(dtype).float()
    w1c, w2c = w1.to(dtype).float(), w2.to(dtype).float()
    pre = n @ w1c + b1
    gate = (pre > 0.0).float()
    hidden = torch.relu(pre)
    if keep_h is not None:
        hidden = torch.where(keep_h, hidden * (1.0 / (1.0 - p_hidden)), 0.0)
    hidden = hidden.to(dtype).float()
    dout = dy
    if keep_r is not None:
        dout = torch.where(keep_r, dout * (1.0 / (1.0 - p_resid)), 0.0)
    dout = dout.to(dtype).float()
    dw2 = torch.einsum("blf,bld->fd", hidden, dout)
    dh = dout @ w2c.t()
    if keep_h is not None:
        dh = torch.where(keep_h, dh * (1.0 / (1.0 - p_hidden)), 0.0)
    dh = (dh * gate).to(dtype).float()
    dw1 = torch.einsum("bld,blf->df", n, dh)
    dx_ln, dg, db = ln_backward(x32, ln_scale, dh @ w1c.t())
    return ((dy + dx_ln).to(dtype), dg, db, dw1, dh.sum(dim=(0, 1)), dw2,
            dout.sum(dim=(0, 1)))


def _check(x, params):
    if x.dim() != 3:
        raise ValueError(f"x must be [B, L, d], got {tuple(x.shape)}")
    b, l, d = x.shape
    check_envelope(b, l, d, x.dtype)
    w1 = params[2]
    d_ff = w1.shape[-1] if w1.dim() == 2 else -1
    if not 1 <= d_ff <= MAX_FF:
        raise NotImplementedError(
            f"FFN kernel covers d_ff <= {MAX_FF}, got {d_ff}")
    dev = x.device
    _build.require(x, "x", (b, l, d), x.dtype, dev)
    for name, t, shape in zip(("ln_scale", "ln_bias", "w1", "b1", "w2", "b2"),
                              params, ((d,), (d,), (d, d_ff), (d_ff,),
                                       (d_ff, d), (d,))):
        _build.require(t, name, shape, torch.float32, dev)
    return b * l, d, d_ff


def _keys(seeds, p_hidden, p_resid):
    return dropout.key_array(
        dropout.kernel_keys(seeds[0], dropout.FFN_HIDDEN, p_hidden),
        dropout.kernel_keys(seeds[1], dropout.FFN_RESID, p_resid))


def ffn_sublayer_fwd(x, ln_scale, ln_bias, w1, b1, w2, b2,
                     p_hidden: float = 0.0, p_resid: float = 0.0,
                     seeds=(0, 0)):
    """``x`` [B, L, d] float32/bfloat16; ``seeds`` the two streams' int
    seeds. A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if x.device.type == "cpu":
        return ffn_sublayer_fwd_plain(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                      p_hidden, p_resid, seeds)
    if x.device.type != "cuda":
        raise ValueError(f"no FFN sublayer for device {x.device}")
    p_hidden = dropout.check_rate(p_hidden)
    p_resid = dropout.check_rate(p_resid)
    params = (ln_scale, ln_bias, w1, b1, w2, b2)
    m, d, d_ff = _check(x, params)

    lib = _build.load("ffn_block", _SIGNATURES)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.ffn_sublayer_fwd(
            *map(_build.ptr, (x,) + params + (y,)), m, d, d_ff,
            int(x.dtype == torch.bfloat16), _keys(seeds, p_hidden, p_resid),
            p_hidden, p_resid, _build.stream_of(x))
    _build.check_launch(lib, rc, "ffn_sublayer_fwd")
    ffn_sublayer_fwd.launches += 1
    return y


ffn_sublayer_fwd.launches = 0


def ffn_sublayer_bwd(x, ln_scale, ln_bias, w1, b1, w2, b2, dy,
                     p_hidden: float = 0.0, p_resid: float = 0.0,
                     seeds=(0, 0)):
    """``(dx, dg, db, dw1, db1, dw2, db2)`` of the sublayer at x for the
    output gradient ``dy``. A CPU tensor takes the plain version; a CUDA
    tensor launches the backward kernels (they recompute the forward from
    x; nothing is saved) or raises."""
    if x.device.type == "cpu":
        return ffn_sublayer_bwd_plain(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                      dy, p_hidden, p_resid, seeds)
    if x.device.type != "cuda":
        raise ValueError(f"no FFN sublayer for device {x.device}")
    p_hidden = dropout.check_rate(p_hidden)
    p_resid = dropout.check_rate(p_resid)
    params = (ln_scale, ln_bias, w1, b1, w2, b2)
    m, d, d_ff = _check(x, params)
    dev, dtype = x.device, x.dtype
    _build.require(dy, "dy", tuple(x.shape), dtype, dev)

    s1, s2 = splits(m, d, d_ff), splits(m, d_ff, d)
    f32 = dict(dtype=torch.float32, device=dev)
    outs = [torch.empty_like(x), torch.empty(d, **f32), torch.empty(d, **f32),
            torch.empty((d, d_ff), **f32), torch.empty(d_ff, **f32),
            torch.empty((d_ff, d), **f32), torch.empty(d, **f32)]
    scratch = [torch.empty((m, d), dtype=dtype, device=dev),
               torch.empty((m, d), dtype=dtype, device=dev),
               torch.empty((m, d_ff), dtype=dtype, device=dev),
               torch.empty((m, d_ff), dtype=dtype, device=dev),
               torch.empty(s1 * (d * d_ff + d_ff), **f32),
               torch.empty(s2 * (d_ff * d + d), **f32),
               torch.empty(-(-m // 64) * 2 * d, **f32)]
    lib = _build.load("ffn_block", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.ffn_sublayer_bwd(
            *map(_build.ptr, (x, ln_scale, ln_bias, w1, b1, w2, dy)),
            *map(_build.ptr, outs), *map(_build.ptr, scratch),
            m, d, d_ff, s1, s2, int(dtype == torch.bfloat16),
            _keys(seeds, p_hidden, p_resid), p_hidden, p_resid,
            _build.stream_of(x))
    _build.check_launch(lib, rc, "ffn_sublayer_bwd")
    ffn_sublayer_bwd.launches += 1
    return tuple(outs)


ffn_sublayer_bwd.launches = 0


class FFNSublayer(torch.autograd.Function):
    """The sublayer under autograd: the forward (kernel or plain version by
    device) keeps x and the parameters; the backward is
    ``ffn_sublayer_bwd``, which recomputes the forward as the TPU kernel
    does."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2, p_hidden, p_resid,
                seeds):
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, w2, b2)
        ctx.config = (p_hidden, p_resid, seeds)
        return ffn_sublayer_fwd(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                p_hidden, p_resid, seeds)

    @staticmethod
    def backward(ctx, dy):
        x, *params = ctx.saved_tensors
        grads = ffn_sublayer_bwd(x, *params, dy.to(x.dtype).contiguous(),
                                 *ctx.config)
        return grads + (None,) * 3


def ffn_sublayer(x, ln_scale, ln_bias, w1, b1, w2, b2,
                 p_hidden: float = 0.0, p_resid: float = 0.0, seeds=(0, 0)):
    """The sublayer as the encoder calls it: through ``FFNSublayer`` when
    autograd records, else the forward alone."""
    args = (x, ln_scale, ln_bias, w1, b1, w2, b2, p_hidden, p_resid,
            tuple(seeds))
    if torch.is_grad_enabled():
        return FFNSublayer.apply(*args)
    return ffn_sublayer_fwd(*args)
