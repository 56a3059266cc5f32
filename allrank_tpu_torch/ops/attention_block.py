"""Attention sublayer forward, ``y = x + (MHA(LN(x) . Wqkv + bqkv) . Wout
+ bout)``: the CUDA kernel ``csrc/attention_block.cu`` for CUDA tensors and
its plain PyTorch version, of the same signature, for CPU tensors.

Replaces the TPU kernel ``attention_sublayer`` of the JAX package's
``ops/attention_block.py`` (forward ``pallas_call`` at line 343) at dropout
rate 0. LN is the unbiased-std LayerNorm in fp32; padded keys get
``NEG_INF_FILL`` before a max-subtracted softmax; the residual is added in
fp32. In bf16 both versions round where the TPU kernel does: after LN,
after the QKV projection, the probabilities before P.V, and ctx; every
product accumulates in fp32.

Layouts are the JAX package's: ``wqkv`` is ``[d, 3d]`` as q|k|v blocks with
each head's d_k columns contiguous, ``wout`` is ``[d, d]``. Parameters are
float32 (the kernel rounds them to x's dtype as it loads them, as the TPU
kernel casts them).
"""

from __future__ import annotations

import ctypes
import math

import torch

from allrank_tpu_torch.constants import NEG_INF_FILL
from allrank_tpu_torch.models.core import std_layer_norm
from allrank_tpu_torch.ops import _build

# the kernels' envelope, the JAX kernels' own (models/transformer.py there)
MAX_WIDTH = 256
MAX_LEN = 1024
DTYPES = (torch.float32, torch.bfloat16)
_SIGNATURES = {"attention_sublayer_fwd": [ctypes.c_void_p] * 10
               + [ctypes.c_int] * 4
               + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]}


def _no_dropout(p_drop: float) -> None:
    if p_drop:
        raise NotImplementedError(
            "dropout inside the sublayer kernels is not ported yet; the "
            "serving path runs at rate 0")


def check_envelope(b: int, l: int, d: int, dtype, h: int = 1) -> None:
    """Raises ``NotImplementedError`` naming the limit the kernels do not
    cover."""
    if dtype not in DTYPES:
        raise NotImplementedError(
            f"sublayer kernels take float32 or bfloat16 x, got {dtype}")
    if not 1 <= d <= MAX_WIDTH:
        raise NotImplementedError(
            f"sublayer kernels cover d_model <= {MAX_WIDTH}, got {d}")
    if h < 1 or d % h:
        raise NotImplementedError(
            f"d_model {d} must be a positive multiple of h {h}")
    if not 1 <= l <= MAX_LEN:
        raise NotImplementedError(
            f"sublayer kernels cover 1 <= L <= {MAX_LEN}, got {l}")
    if b < 1:
        raise NotImplementedError(f"empty batch (B={b})")


def attention_sublayer_fwd_plain(x, key_mask, ln_scale, ln_bias, wqkv, bqkv,
                                 wout, bout, h: int, p_drop: float = 0.0):
    """The same function in plain PyTorch ops, with the kernel's rounding
    points. ``key_mask`` [B, L] is True at padded documents."""
    _no_dropout(p_drop)
    b, l, d = x.shape
    dk = d // h
    dtype = x.dtype
    x32 = x.float()
    n = std_layer_norm(x32, ln_scale, ln_bias).to(dtype).float()
    qkv = (n @ wqkv.to(dtype).float() + bqkv).to(dtype).float()
    q, k, v = (t.reshape(b, l, h, dk).transpose(1, 2)
               for t in qkv.split(d, dim=-1))
    scores = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(dk))
    scores = scores.masked_fill(key_mask[:, None, None, :], NEG_INF_FILL)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = e * (1.0 / e.sum(dim=-1, keepdim=True))
    ctx = p.to(dtype).float() @ v
    ctx = ctx.transpose(1, 2).reshape(b, l, d).to(dtype).float()
    a = ctx @ wout.to(dtype).float() + bout
    return (x32 + a).to(dtype)


def attention_sublayer_fwd(x, key_mask, ln_scale, ln_bias, wqkv, bqkv, wout,
                           bout, h: int, p_drop: float = 0.0):
    """``x`` [B, L, d] float32/bfloat16; ``key_mask`` [B, L] bool (True =
    padded). A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel (two CUDA kernels: LN + QKV, then attention + out-projection
    + residual) or raises."""
    if x.device.type == "cpu":
        return attention_sublayer_fwd_plain(x, key_mask, ln_scale, ln_bias,
                                            wqkv, bqkv, wout, bout, h, p_drop)
    if x.device.type != "cuda":
        raise ValueError(f"no attention sublayer for device {x.device}")
    _no_dropout(p_drop)
    if x.dim() != 3:
        raise ValueError(f"x must be [B, L, d], got {tuple(x.shape)}")
    b, l, d = x.shape
    check_envelope(b, l, d, x.dtype, h)
    dev = x.device
    _build.require(x, "x", (b, l, d), x.dtype, dev)
    _build.require(key_mask, "key_mask", (b, l), torch.bool, dev)
    for name, t, shape in (("ln_scale", ln_scale, (d,)),
                           ("ln_bias", ln_bias, (d,)),
                           ("wqkv", wqkv, (d, 3 * d)),
                           ("bqkv", bqkv, (3 * d,)),
                           ("wout", wout, (d, d)),
                           ("bout", bout, (d,))):
        _build.require(t, name, shape, torch.float32, dev)

    lib = _build.load("attention_block", _SIGNATURES)
    y = torch.empty_like(x)
    qkv = torch.empty((b, l, 3 * d), dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        rc = lib.attention_sublayer_fwd(
            _build.ptr(x), _build.ptr(key_mask), _build.ptr(ln_scale),
            _build.ptr(ln_bias), _build.ptr(wqkv), _build.ptr(bqkv),
            _build.ptr(wout), _build.ptr(bout), _build.ptr(qkv),
            _build.ptr(y), b, l, d, h, 1.0 / math.sqrt(d // h),
            int(x.dtype == torch.bfloat16), _build.stream_of(x))
    _build.check_launch(lib, rc, "attention_sublayer_fwd")
    attention_sublayer_fwd.launches += 1
    return y


attention_sublayer_fwd.launches = 0

