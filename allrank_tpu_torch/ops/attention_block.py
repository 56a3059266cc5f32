"""Attention sublayer, ``y = x + drop_r((MHA_drop_a(LN(x) . Wqkv + bqkv))
. Wout + bout)``, forward and backward: the CUDA kernels for CUDA tensors
and their plain PyTorch versions, of the same signatures, for CPU tensors;
``AttentionSublayer`` ties the two into autograd. Three routes of kernels
(``route``): with d_k <= 128 bf16 runs on the tensor cores
(``csrc/attention_block_mma.cu``) and fp32 on them as 3xTF32 split
products (``csrc/attention_block_tf32x3.cu``, three TF32 products an fp32
one, fp32's parity); heads wider than 128 run on the SIMT units
(``csrc/attention_block.cu``) in either dtype.

Replaces the TPU kernel ``attention_sublayer`` of the JAX package's
``ops/attention_block.py`` (forward ``pallas_call`` at line 343, backward at
line 375). LN is the unbiased-std LayerNorm in fp32; padded keys get
``NEG_INF_FILL`` before a max-subtracted softmax; dropout on the attention
probabilities (stream ``ATTN_PROBS``, seed ``seeds[0]``) and on the
sublayer output (``ATTN_RESID``, ``seeds[1]``) comes from ``ops/dropout.py``;
the residual is added in fp32. In bf16 every version rounds where the TPU
kernel does: after LN, after the QKV projection, the probabilities before
P.V, and ctx; in the backward da, dO, dS and dqkv. Every product
accumulates in fp32 and the parameter gradients are fp32.

Layouts are the JAX package's: ``wqkv`` is ``[d, 3d]`` as q|k|v blocks with
each head's d_k columns contiguous, ``wout`` is ``[d, d]``. Parameters are
float32 (the kernels round them to x's dtype as they load them, as the TPU
kernel casts them).
"""

from __future__ import annotations

import ctypes
import math

import torch

from allrank_tpu_torch.constants import NEG_INF_FILL
from allrank_tpu_torch.models.core import std_layer_norm
from allrank_tpu_torch.ops import _build, dropout

# the port's envelope of the sublayer kernels B1 and B2: d_model <= 256
# (the JAX package's MEGA_SUBLAYER_MAX_WIDTH) and, for B1, L <= 1024. JAX
# dispatches its sublayer kernel only up to L=768 (MEGA_SUBLAYER_MAX_LEN,
# a VMEM bound, models/transformer.py:120 there); 1024 is this port's own,
# and the encoder takes longer slates through the split block
# (models/transformer.py)
MAX_WIDTH = 256
MAX_LEN = 1024
DTYPES = (torch.float32, torch.bfloat16)
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "attention_sublayer_fwd": [_P] * 11 + [_I] * 4
    + [ctypes.c_float, _I, _P, ctypes.c_double, ctypes.c_double, _P],
    "attention_sublayer_bwd": [_P] * 25 + [_I] * 6
    + [ctypes.c_float, _I, _P, ctypes.c_double, ctypes.c_double, _P],
}
# the tensor-core route's entry points: the SIMT ones less is_bf16
_SIGNATURES_MMA = {
    "attention_sublayer_fwd_mma": [_P] * 11 + [_I] * 4
    + [ctypes.c_float, _P, ctypes.c_double, ctypes.c_double, _P],
    "attention_sublayer_bwd_mma": [_P] * 25 + [_I] * 6
    + [ctypes.c_float, _P, ctypes.c_double, ctypes.c_double, _P],
}
# the 3xTF32 route's entry points: the tensor-core route's, the forward
# with the scratch ctx [B, L, d] after stats
_SIGNATURES_TF32X3 = {
    "attention_sublayer_fwd_tf32x3": [_P] * 12 + [_I] * 4
    + [ctypes.c_float, _P, ctypes.c_double, ctypes.c_double, _P],
    "attention_sublayer_bwd_tf32x3":
    _SIGNATURES_MMA["attention_sublayer_bwd_mma"],
}
# the widest head the tensor-core kernels take (d_k padded to 32, 64 or 128)
MMA_MAX_HEAD = 128
ROUTES = ("mma", "tf32x3", "simt")
# each route's library and entry points
_LIBRARIES = {"mma": ("attention_block_mma", _SIGNATURES_MMA),
              "tf32x3": ("attention_block_tf32x3", _SIGNATURES_TF32X3),
              "simt": ("attention_block", _SIGNATURES)}


def check_width(b: int, d: int, dtype, h: int = 1) -> None:
    """The envelope both sublayer kernels share: dtype, d_model, heads and
    a non-empty batch; raises ``NotImplementedError`` naming the limit."""
    if dtype not in DTYPES:
        raise NotImplementedError(
            f"sublayer kernels take float32 or bfloat16 x, got {dtype}")
    if not 1 <= d <= MAX_WIDTH:
        raise NotImplementedError(
            f"sublayer kernels cover d_model <= {MAX_WIDTH}, got {d}")
    if h < 1 or d % h:
        raise NotImplementedError(
            f"d_model {d} must be a positive multiple of h {h}")
    if b < 1:
        raise NotImplementedError(f"empty batch (B={b})")


def check_envelope(b: int, l: int, d: int, dtype, h: int = 1) -> None:
    """B1's envelope: ``check_width`` and 1 <= L <= 1024. Raises
    ``NotImplementedError`` naming the limit the kernel does not cover."""
    check_width(b, d, dtype, h)
    if not 1 <= l <= MAX_LEN:
        raise NotImplementedError(
            f"sublayer kernels cover 1 <= L <= {MAX_LEN}, got {l}")


def route(dtype, d: int, h: int) -> str:
    """The kernels a CUDA call takes, from dtype, d and h alone, before any
    launch: with d_k = d / h <= 128 ``"mma"`` (the tensor cores,
    ``attention_block_mma.cu``) for bf16 and ``"tf32x3"`` (the tensor cores
    as 3xTF32 split products, ``attention_block_tf32x3.cu``) for fp32;
    ``"simt"`` (``attention_block.cu``) for wider heads in either dtype.
    Raises ``NotImplementedError`` outside the sublayer kernels' envelope."""
    check_width(1, d, dtype, h)
    if d // h > MMA_MAX_HEAD:
        return "simt"
    return "mma" if dtype == torch.bfloat16 else "tf32x3"


# blocks of a weight-gradient product the splits aim at: two waves of
# 64 x 64 output tiles on 132 SMs; the 3xTF32 tile (72 KB of shared memory,
# three blocks an SM) one full wave of three, which took 6 % less of B2's
# fp32 backward device time than 264 (PERF.md)
SPLIT_BLOCKS = 264
SPLIT_BLOCKS_TF32X3 = 396


def splits(m: int, k: int, n: int, blocks: int = SPLIT_BLOCKS) -> int:
    """Row splits of a weight-gradient product ``A^T . B`` over ``m`` rows
    into a ``[k, n]`` result: about ``blocks`` blocks of 64 x 64 output
    tiles, and at least 32 rows per split."""
    tiles = -(-k // 64) * -(-n // 64)
    return max(1, min(-(-blocks // tiles), -(-m // 32)))


def _masks(b, l, d, h, p_attn, p_resid, seeds, device):
    """The keep masks of both streams (None at rate 0)."""
    keep_a = keep_r = None
    if p_attn:
        keep_a = dropout.keep_mask(seeds[0], dropout.ATTN_PROBS, p_attn,
                                   (b, h, l, l), device)
    if p_resid:
        keep_r = dropout.keep_mask(seeds[1], dropout.ATTN_RESID, p_resid,
                                   (b, l, d), device)
    return keep_a, keep_r


def _probs(q, k, key_mask, scale):
    scores = (q @ k.transpose(-1, -2)) * scale
    scores = scores.masked_fill(key_mask[:, None, None, :], NEG_INF_FILL)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    return e * (1.0 / e.sum(dim=-1, keepdim=True))


def _heads(t, b, l, h):
    return t.reshape(b, l, h, -1).transpose(1, 2)


def attention_sublayer_fwd_plain(x, key_mask, ln_scale, ln_bias, wqkv, bqkv,
                                 wout, bout, h: int, p_attn: float = 0.0,
                                 p_resid: float = 0.0, seeds=(0, 0)):
    """The same function in plain PyTorch ops, with the kernel's rounding
    points and dropout masks. ``key_mask`` [B, L] is True at padded
    documents."""
    p_attn, p_resid = dropout.check_rate(p_attn), dropout.check_rate(p_resid)
    b, l, d = x.shape
    dtype = x.dtype
    x32 = x.float()
    keep_a, keep_r = _masks(b, l, d, h, p_attn, p_resid, seeds, x.device)
    n = std_layer_norm(x32, ln_scale, ln_bias).to(dtype).float()
    qkv = (n @ wqkv.to(dtype).float() + bqkv).to(dtype).float()
    q, k, v = (_heads(t, b, l, h) for t in qkv.split(d, dim=-1))
    p = _probs(q, k, key_mask, 1.0 / math.sqrt(d // h))
    if keep_a is not None:
        p = torch.where(keep_a, p / (1.0 - p_attn), 0.0)
    ctx = p.to(dtype).float() @ v
    ctx = ctx.transpose(1, 2).reshape(b, l, d).to(dtype).float()
    a = ctx @ wout.to(dtype).float() + bout
    if keep_r is not None:
        a = torch.where(keep_r, a / (1.0 - p_resid), 0.0)
    return (x32 + a).to(dtype)


def ln_backward(x32, ln_scale, dn):
    """The unbiased-std LayerNorm backward as the TPU kernels take it
    (the JAX package's ``ops/attention_block.py:239-253``): returns
    ``(dx_ln, dg, db)``, all fp32."""
    d = x32.shape[-1]
    mean = x32.mean(dim=-1, keepdim=True)
    c = x32 - mean
    var = (c * c).sum(dim=-1, keepdim=True) / max(d - 1, 1)
    s = torch.sqrt(torch.clamp(var, min=1e-24))
    denom = s + 1e-6
    xhat = c * (1.0 / denom)
    dg = (dn * xhat).sum(dim=(0, 1))
    db = dn.sum(dim=(0, 1))
    dxhat = dn * ln_scale
    c = xhat * denom
    proj = (dxhat * c).sum(dim=-1, keepdim=True)
    gate = (var > 1e-24).float()
    dc = dxhat / denom - gate * c * proj / ((d - 1) * s * denom * denom)
    return dc - dc.mean(dim=-1, keepdim=True), dg, db


def attention_sublayer_bwd_plain(x, key_mask, ln_scale, ln_bias, wqkv, bqkv,
                                 wout, bout, dy, h: int, p_attn: float = 0.0,
                                 p_resid: float = 0.0, seeds=(0, 0)):
    """The backward in plain PyTorch ops, mirroring the TPU kernel's
    ``attn_sublayer_bwd_vmem`` (the JAX package's
    ``ops/attention_block.py:159-254``) with its rounding points: not
    autograd of the forward, whose rounding would differ in bf16. Returns
    ``(dx, dg, db, dwqkv, dbqkv, dwout, dbout)``: dx in x's dtype, the
    parameter gradients fp32."""
    del bout  # the output bias does not enter the backward
    p_attn, p_resid = dropout.check_rate(p_attn), dropout.check_rate(p_resid)
    b, l, d = x.shape
    dk = d // h
    dtype = x.dtype
    scale = 1.0 / math.sqrt(dk)
    keep_a, keep_r = _masks(b, l, d, h, p_attn, p_resid, seeds, x.device)
    x32 = x.float()
    dy = dy.to(dtype).float()
    n = std_layer_norm(x32, ln_scale, ln_bias).to(dtype).float()
    wq = wqkv.to(dtype).float()
    qkv = (n @ wq + bqkv).to(dtype).float()
    q, k, v = (_heads(t, b, l, h) for t in qkv.split(d, dim=-1))

    da = dy
    if keep_r is not None:
        da = torch.where(keep_r, da * (1.0 / (1.0 - p_resid)), 0.0)
    da = da.to(dtype).float()

    p = _probs(q, k, key_mask, scale)
    pd = p
    if keep_a is not None:
        pd = torch.where(keep_a, p * (1.0 / (1.0 - p_attn)), 0.0)
    pd = pd.to(dtype).float()
    ctx = (pd @ v).to(dtype).float()                    # [B, h, L, dk]
    dwout = torch.einsum("bhlk,blj->hkj", ctx, da).reshape(d, d)
    wo = wout.to(dtype).float()
    do_h = (da @ wo.t()).to(dtype).float()              # [B, L, d]
    do_h = _heads(do_h, b, l, h)
    dv = pd.transpose(-1, -2) @ do_h
    dp = do_h @ v.transpose(-1, -2)
    if keep_a is not None:
        dp = torch.where(keep_a, dp * (1.0 / (1.0 - p_attn)), 0.0)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds = ds.masked_fill(key_mask[:, None, None, :], 0.0).to(dtype).float()
    dq = (ds @ k) * scale
    dkk = (ds.transpose(-1, -2) @ q) * scale

    def merge(t):
        return t.transpose(1, 2).reshape(b, l, d)

    dqkv = torch.cat([merge(dq), merge(dkk), merge(dv)], dim=-1)
    dqkv = dqkv.to(dtype).float()
    dn = dqkv @ wq.t()
    dwqkv = torch.einsum("bli,blj->ij", n, dqkv)
    dx_ln, dg, db = ln_backward(x32, ln_scale, dn)
    return ((dy + dx_ln).to(dtype), dg, db, dwqkv, dqkv.sum(dim=(0, 1)),
            dwout, da.sum(dim=(0, 1)))


def _check(x, key_mask, params, h):
    if x.dim() != 3:
        raise ValueError(f"x must be [B, L, d], got {tuple(x.shape)}")
    b, l, d = x.shape
    check_envelope(b, l, d, x.dtype, h)
    dev = x.device
    _build.require(x, "x", (b, l, d), x.dtype, dev)
    _build.require(key_mask, "key_mask", (b, l), torch.bool, dev)
    for name, t, shape in zip(
            ("ln_scale", "ln_bias", "wqkv", "bqkv", "wout", "bout"), params,
            ((d,), (d,), (d, 3 * d), (3 * d,), (d, d), (d,))):
        _build.require(t, name, shape, torch.float32, dev)
    return b, l, d


def _keys(seeds, p_attn, p_resid):
    return dropout.key_array(
        dropout.kernel_keys(seeds[0], dropout.ATTN_PROBS, p_attn),
        dropout.kernel_keys(seeds[1], dropout.ATTN_RESID, p_resid))


def attention_sublayer_fwd(x, key_mask, ln_scale, ln_bias, wqkv, bqkv, wout,
                           bout, h: int, p_attn: float = 0.0,
                           p_resid: float = 0.0, seeds=(0, 0),
                           return_saved: bool = False):
    """``x`` [B, L, d] float32/bfloat16; ``key_mask`` [B, L] bool (True =
    padded); ``seeds`` the two streams' int seeds. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel (two CUDA kernels: LN +
    QKV, then attention + out-projection + residual) or raises. With
    ``return_saved`` returns ``(y, saved)``: on CUDA ``saved`` is what the
    backward kernel reads (qkv [B, L, 3d] and the softmax row statistics
    [B, h, L, 2]), on the CPU None."""
    if x.device.type == "cpu":
        y = attention_sublayer_fwd_plain(x, key_mask, ln_scale, ln_bias, wqkv,
                                         bqkv, wout, bout, h, p_attn, p_resid,
                                         seeds)
        return (y, None) if return_saved else y
    if x.device.type != "cuda":
        raise ValueError(f"no attention sublayer for device {x.device}")
    return launch_fwd(route(x.dtype, x.shape[-1], h), x, key_mask, ln_scale,
                      ln_bias, wqkv, bqkv, wout, bout, h, p_attn, p_resid,
                      seeds, return_saved)


def _check_way(way, dtype, d, h):
    if way not in ROUTES or (way != "simt" and route(dtype, d, h) != way):
        raise ValueError(f"no {way!r} kernels for {dtype}, d={d}, h={h}")


def launch_fwd(way, x, key_mask, ln_scale, ln_bias, wqkv, bqkv, wout, bout,
               h: int, p_attn: float = 0.0, p_resid: float = 0.0,
               seeds=(0, 0), return_saved: bool = False):
    """``attention_sublayer_fwd`` on CUDA tensors through the kernels of
    route ``way``: the wrapper passes ``route``'s answer; the SIMT kernels
    also at narrower heads, for comparisons. Counts the launch as
    the wrapper's."""
    p_attn, p_resid = dropout.check_rate(p_attn), dropout.check_rate(p_resid)
    params = (ln_scale, ln_bias, wqkv, bqkv, wout, bout)
    b, l, d = _check(x, key_mask, params, h)
    _check_way(way, x.dtype, d, h)
    dev = x.device

    y = torch.empty_like(x)
    qkv = torch.empty((b, l, 3 * d), dtype=x.dtype, device=dev)
    stats = (torch.empty((b, h, l, 2), dtype=torch.float32, device=dev)
             if return_saved else None)
    args = (*map(_build.ptr, (x, key_mask) + params + (qkv, y)),
            _build.ptr(stats) if stats is not None else None,
            b, l, d, h, 1.0 / math.sqrt(d // h))
    tail = (_keys(seeds, p_attn, p_resid), p_attn, p_resid,
            _build.stream_of(x))
    with torch.cuda.device(dev):
        lib = _build.load(*_LIBRARIES[way])
        if way == "mma":
            rc = lib.attention_sublayer_fwd_mma(*args, *tail)
        elif way == "tf32x3":
            ctx = torch.empty((b, l, d), dtype=x.dtype, device=dev)
            rc = lib.attention_sublayer_fwd_tf32x3(
                *args[:11], _build.ptr(ctx), *args[11:], *tail)
        else:
            rc = lib.attention_sublayer_fwd(
                *args, int(x.dtype == torch.bfloat16), *tail)
    _build.check_launch(lib, rc, f"attention_sublayer_fwd ({way})")
    attention_sublayer_fwd.launches += 1
    attention_sublayer_fwd.route_launches[way] += 1
    return (y, (qkv, stats)) if return_saved else y


attention_sublayer_fwd.launches = 0
attention_sublayer_fwd.route_launches = dict.fromkeys(ROUTES, 0)


def attention_sublayer_bwd(x, key_mask, ln_scale, ln_bias, wqkv, bqkv, wout,
                           bout, dy, h: int, p_attn: float = 0.0,
                           p_resid: float = 0.0, seeds=(0, 0), saved=None):
    """``(dx, dg, db, dwqkv, dbqkv, dwout, dbout)`` of the sublayer at x for
    the output gradient ``dy``. A CPU tensor takes the plain version; a CUDA
    tensor launches the backward kernels on ``saved``, the forward kernel's
    ``(qkv, stats)`` for the same inputs, seeds and rates, or raises."""
    if x.device.type == "cpu":
        return attention_sublayer_bwd_plain(x, key_mask, ln_scale, ln_bias,
                                            wqkv, bqkv, wout, bout, dy, h,
                                            p_attn, p_resid, seeds)
    if x.device.type != "cuda":
        raise ValueError(f"no attention sublayer for device {x.device}")
    return launch_bwd(route(x.dtype, x.shape[-1], h), x, key_mask, ln_scale,
                      ln_bias, wqkv, bqkv, wout, bout, dy, h, p_attn, p_resid,
                      seeds, saved)


def launch_bwd(way, x, key_mask, ln_scale, ln_bias, wqkv, bqkv, wout, bout,
               dy, h: int, p_attn: float = 0.0, p_resid: float = 0.0,
               seeds=(0, 0), saved=None):
    """``attention_sublayer_bwd`` on CUDA tensors through the kernels of
    route ``way`` (see ``launch_fwd``), on ``saved`` from the same route's
    forward. Counts the launch as the wrapper's."""
    p_attn, p_resid = dropout.check_rate(p_attn), dropout.check_rate(p_resid)
    params = (ln_scale, ln_bias, wqkv, bqkv, wout, bout)
    b, l, d = _check(x, key_mask, params, h)
    _check_way(way, x.dtype, d, h)
    if saved is None:
        raise ValueError("the backward kernel needs the forward's saved qkv "
                         "and row statistics (return_saved=True)")
    qkv, stats = saved
    dev, dtype = x.device, x.dtype
    _build.require(qkv, "qkv", (b, l, 3 * d), dtype, dev)
    _build.require(stats, "stats", (b, h, l, 2), torch.float32, dev)
    _build.require(dy, "dy", (b, l, d), dtype, dev)

    m = b * l
    blocks = SPLIT_BLOCKS_TF32X3 if way == "tf32x3" else SPLIT_BLOCKS
    s_qkv, s_out = splits(m, d, 3 * d, blocks), splits(m, d, d, blocks)
    f32 = dict(dtype=torch.float32, device=dev)
    outs = [torch.empty_like(x), torch.empty(d, **f32), torch.empty(d, **f32),
            torch.empty((d, 3 * d), **f32), torch.empty(3 * d, **f32),
            torch.empty((d, d), **f32), torch.empty(d, **f32)]
    scratch = [torch.empty((m, d), dtype=dtype, device=dev) for _ in range(4)]
    scratch += [torch.empty((m, 3 * d), dtype=dtype, device=dev),
                torch.empty((b, h, l), **f32),
                torch.empty(s_qkv * (3 * d * d + 3 * d), **f32),
                torch.empty(s_out * (d * d + d), **f32),
                torch.empty(-(-m // 64) * 2 * d, **f32)]
    args = (*map(_build.ptr, (x, key_mask, ln_scale, ln_bias, wqkv, wout,
                              qkv, stats, dy)),
            *map(_build.ptr, outs), *map(_build.ptr, scratch),
            b, l, d, h, s_qkv, s_out, 1.0 / math.sqrt(d // h))
    tail = (_keys(seeds, p_attn, p_resid), p_attn, p_resid,
            _build.stream_of(x))
    with torch.cuda.device(dev):
        lib = _build.load(*_LIBRARIES[way])
        if way == "mma":
            rc = lib.attention_sublayer_bwd_mma(*args, *tail)
        elif way == "tf32x3":
            rc = lib.attention_sublayer_bwd_tf32x3(*args, *tail)
        else:
            rc = lib.attention_sublayer_bwd(
                *args, int(dtype == torch.bfloat16), *tail)
    _build.check_launch(lib, rc, f"attention_sublayer_bwd ({way})")
    attention_sublayer_bwd.launches += 1
    attention_sublayer_bwd.route_launches[way] += 1
    return tuple(outs)


attention_sublayer_bwd.launches = 0
attention_sublayer_bwd.route_launches = dict.fromkeys(ROUTES, 0)


class AttentionSublayer(torch.autograd.Function):
    """The sublayer under autograd: the forward (kernel or plain version by
    device) keeps x, the parameters and, on CUDA, the forward kernel's qkv
    and row statistics; the backward is ``attention_sublayer_bwd``."""

    @staticmethod
    def forward(ctx, x, key_mask, ln_scale, ln_bias, wqkv, bqkv, wout, bout,
                h, p_attn, p_resid, seeds):
        y, saved = attention_sublayer_fwd(
            x, key_mask, ln_scale, ln_bias, wqkv, bqkv, wout, bout, h, p_attn,
            p_resid, seeds, return_saved=True)
        ctx.save_for_backward(x, key_mask, ln_scale, ln_bias, wqkv, bqkv,
                              wout, bout, *(saved or ()))
        ctx.config = (h, p_attn, p_resid, seeds)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, key_mask, *params = ctx.saved_tensors
        saved = tuple(params[6:]) or None
        h, p_attn, p_resid, seeds = ctx.config
        grads = attention_sublayer_bwd(
            x, key_mask, *params[:6], dy.to(x.dtype).contiguous(), h, p_attn,
            p_resid, seeds, saved=saved)
        return (grads[0], None) + tuple(grads[1:]) + (None,) * 4


def attention_sublayer(x, key_mask, ln_scale, ln_bias, wqkv, bqkv, wout,
                       bout, h: int, p_attn: float = 0.0,
                       p_resid: float = 0.0, seeds=(0, 0)):
    """The sublayer as the encoder calls it: through ``AttentionSublayer``
    when autograd records, else the forward alone (one kernel launch, no
    saved state)."""
    args = (x, key_mask, ln_scale, ln_bias, wqkv, bqkv, wout, bout, h,
            p_attn, p_resid, tuple(seeds))
    if torch.is_grad_enabled():
        return AttentionSublayer.apply(*args)
    return attention_sublayer_fwd(*args)
