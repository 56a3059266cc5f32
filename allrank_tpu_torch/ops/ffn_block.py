"""FFN sublayer forward, ``y = x + (relu(LN(x) . W1 + b1) . W2 + b2)``: the
CUDA kernel ``csrc/ffn_block.cu`` for CUDA tensors and its plain PyTorch
version, of the same signature, for CPU tensors.

Replaces the TPU kernel ``ffn_sublayer`` of the JAX package's
``ops/ffn_block.py`` (forward ``pallas_call`` at line 204) at dropout rate 0.
In bf16 both versions round where the TPU kernel does: after LN and the
hidden activation before W2; products accumulate in fp32 and the residual
is added in fp32. ``w1`` is ``[d, d_ff]``, ``w2`` is ``[d_ff, d]``;
parameters are float32.
"""

from __future__ import annotations

import ctypes

import torch

from allrank_tpu_torch.models.core import std_layer_norm
from allrank_tpu_torch.ops import _build
from allrank_tpu_torch.ops.attention_block import _no_dropout, check_envelope

MAX_FF = 1024
_SIGNATURES = {"ffn_sublayer_fwd": [ctypes.c_void_p] * 8
               + [ctypes.c_int] * 4 + [ctypes.c_void_p]}


def ffn_sublayer_fwd_plain(x, ln_scale, ln_bias, w1, b1, w2, b2,
                           p_drop: float = 0.0):
    """The same function in plain PyTorch ops, with the kernel's rounding
    points."""
    _no_dropout(p_drop)
    dtype = x.dtype
    x32 = x.float()
    n = std_layer_norm(x32, ln_scale, ln_bias).to(dtype).float()
    hidden = torch.relu(n @ w1.to(dtype).float() + b1).to(dtype).float()
    out = hidden @ w2.to(dtype).float() + b2
    return (x32 + out).to(dtype)


def ffn_sublayer_fwd(x, ln_scale, ln_bias, w1, b1, w2, b2,
                     p_drop: float = 0.0):
    """``x`` [B, L, d] float32/bfloat16. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        return ffn_sublayer_fwd_plain(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                      p_drop)
    if x.device.type != "cuda":
        raise ValueError(f"no FFN sublayer for device {x.device}")
    _no_dropout(p_drop)
    if x.dim() != 3:
        raise ValueError(f"x must be [B, L, d], got {tuple(x.shape)}")
    b, l, d = x.shape
    check_envelope(b, l, d, x.dtype)
    d_ff = w1.shape[-1] if w1.dim() == 2 else -1
    if not 1 <= d_ff <= MAX_FF:
        raise NotImplementedError(
            f"FFN kernel covers d_ff <= {MAX_FF}, got {d_ff}")
    dev = x.device
    _build.require(x, "x", (b, l, d), x.dtype, dev)
    for name, t, shape in (("ln_scale", ln_scale, (d,)),
                           ("ln_bias", ln_bias, (d,)),
                           ("w1", w1, (d, d_ff)), ("b1", b1, (d_ff,)),
                           ("w2", w2, (d_ff, d)), ("b2", b2, (d,))):
        _build.require(t, name, shape, torch.float32, dev)

    lib = _build.load("ffn_block", _SIGNATURES)
    y = torch.empty_like(x)
    with torch.cuda.device(dev):
        rc = lib.ffn_sublayer_fwd(
            _build.ptr(x), _build.ptr(ln_scale), _build.ptr(ln_bias),
            _build.ptr(w1), _build.ptr(b1), _build.ptr(w2), _build.ptr(b2),
            _build.ptr(y), b * l, d, d_ff, int(x.dtype == torch.bfloat16),
            _build.stream_of(x))
    _build.check_launch(lib, rc, "ffn_sublayer_fwd")
    ffn_sublayer_fwd.launches += 1
    return y


ffn_sublayer_fwd.launches = 0

