"""The attention sublayer forward with one stage changed (X3), bf16: the
CUDA kernels for CUDA tensors and their plain PyTorch versions for CPU
tensors. Two routes, B1's (``route``): heads of d_k <= 128 run B1's
tensor-core forward bodies with the mode as a template parameter
(``csrc/attention_variants_mma_<mode>.cu`` over
``csrc/attention_variants_mma.cuh``; ``exp2`` runs ``full``'s kernels,
whose exponent is exp2 already), wider heads B1's SIMT bodies
(``csrc/attention_variants.cu``).

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
from allrank_tpu_torch.ops import attention_block
from allrank_tpu_torch.ops.attention_block import _heads, check_envelope

MODES = ("full", "no_softmax", "exp2", "norm_after_pv", "no_pv", "frame")
ROUTES = ("mma", "simt")
LOG2E = 1.4426950408889634
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"attention_variant_fwd": [_P] * 10 + [_I] * 4
               + [ctypes.c_float, _I, _P]}
# the tensor-core route's entry point: the SIMT one less the mode, which
# picks the library
_SIGNATURES_MMA = {"attention_variant_fwd_mma": [_P] * 10 + [_I] * 4
                   + [ctypes.c_float, _P]}
# each mode's tensor-core library: exp2 runs full's kernels (B1's exponent
# is exp2 of pre-scaled scores already)
MMA_LIBRARIES = {mode: "attention_variants_mma_"
                 + ("full" if mode == "exp2" else mode) for mode in MODES}


def route(d: int, h: int) -> str:
    """The kernels a CUDA call takes, from d and h alone, before any
    launch: B1's bf16 route (``ops/attention_block.route``), ``"mma"``
    (the tensor cores) for d_k = d / h <= 128 and ``"simt"`` for wider
    heads. Raises ``NotImplementedError`` outside B1's envelope."""
    return attention_block.route(torch.bfloat16, d, h)


def qkv_plain(x, ln_scale, ln_bias, wqkv, bqkv):
    """qkv [B, L, 3d] in x's dtype: LN + QKV with B1's rounding points
    (after LN, after the projection)."""
    dtype = x.dtype
    n = std_layer_norm(x.float(), ln_scale, ln_bias).to(dtype).float()
    return (n @ wqkv.to(dtype).float() + bqkv).to(dtype)


def attention_variant_fwd_plain(x, key_mask, ln_scale, ln_bias, wqkv, bqkv,
                                wout, bout, h: int, mode: str = "full",
                                qkv=None):
    """The mode's function in plain PyTorch ops, with B1's rounding points
    (after LN, after the QKV projection, the probabilities before P.V, ctx)
    and each mode's own (``_variant_fwd_vmem``). ``qkv``, where given,
    stands for ``qkv_plain``'s: a check on the card replays the kernel's
    own qkv with it, as ROADMAP Queue C5 replays flipped ReLU gates."""
    b, l, d = x.shape
    dk = d // h
    dtype = x.dtype
    x32 = x.float()
    if qkv is None:
        qkv = qkv_plain(x, ln_scale, ln_bias, wqkv, bqkv)
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


def launch_fwd(way: str, x, key_mask, ln_scale, ln_bias, wqkv, bqkv, wout,
               bout, h: int, mode: str = "full", return_qkv: bool = False):
    """y [B, L, d] bf16 from the kernels of route ``way`` ("mma" or
    "simt"), whatever ``route`` would pick: the SIMT route takes any head
    width, the tensor-core route d_k <= 128. Counts the launch under
    ``way``. With ``return_qkv`` returns ``(y, qkv)``, qkv [B, L, 3d] the
    first kernel's result."""
    if way not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {way!r}")
    params = (ln_scale, ln_bias, wqkv, bqkv, wout, bout)
    b, l, d = _check(x, key_mask, params, h, mode)
    if x.device.type != "cuda":
        raise ValueError(f"the variant kernels need a CUDA tensor, got "
                         f"{x.device}")
    if way == "mma" and d // h > attention_block.MMA_MAX_HEAD:
        raise NotImplementedError(
            f"the tensor-core variants cover d_k <= "
            f"{attention_block.MMA_MAX_HEAD}, got {d // h}")
    _build.require(x, "x", (b, l, d), torch.bfloat16, x.device)
    y = torch.empty_like(x)
    qkv = torch.empty((b, l, 3 * d), dtype=x.dtype, device=x.device)
    ptrs = map(_build.ptr, (x, key_mask) + params + (qkv, y))
    scale = 1.0 / math.sqrt(d // h)
    with torch.cuda.device(x.device):
        if way == "mma":
            lib = _build.load(MMA_LIBRARIES[mode], _SIGNATURES_MMA)
            rc = lib.attention_variant_fwd_mma(*ptrs, b, l, d, h, scale,
                                               _build.stream_of(x))
        else:
            lib = _build.load("attention_variants", _SIGNATURES)
            rc = lib.attention_variant_fwd(*ptrs, b, l, d, h, scale,
                                           MODES.index(mode),
                                           _build.stream_of(x))
    _build.check_launch(lib, rc, f"attention_variant_fwd ({way})")
    attention_variant_fwd.launches[mode] += 1
    attention_variant_fwd.route_launches[way] += 1
    return (y, qkv) if return_qkv else y


def attention_variant_fwd(x, key_mask, ln_scale, ln_bias, wqkv, bqkv, wout,
                          bout, h: int, mode: str = "full"):
    """y [B, L, d] bf16. A CPU tensor takes the plain version; a CUDA
    tensor launches the mode's two kernels of ``route``'s answer (LN +
    QKV, then the changed attention core + out-projection + residual) or
    raises."""
    params = (ln_scale, ln_bias, wqkv, bqkv, wout, bout)
    b, l, d = _check(x, key_mask, params, h, mode)
    if x.device.type == "cpu":
        return attention_variant_fwd_plain(x, key_mask, *params, h, mode)
    if x.device.type != "cuda":
        raise ValueError(f"no attention variant for device {x.device}")
    return launch_fwd(route(d, h), x, key_mask, *params, h, mode)


attention_variant_fwd.launches = dict.fromkeys(MODES, 0)
attention_variant_fwd.route_launches = dict.fromkeys(ROUTES, 0)
