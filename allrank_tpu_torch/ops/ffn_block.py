"""FFN sublayer, ``y = x + drop_r(drop_h(relu(LN(x) . W1 + b1)) . W2 + b2)``,
forward and backward: the CUDA kernels for CUDA tensors and their plain
PyTorch versions, of the same signatures, for CPU tensors; ``FFNSublayer``
ties the two into autograd. Two routes of kernels (``route``), both on the
tensor cores: bf16 (``csrc/ffn_block_mma.cu``) and fp32 as 3xTF32 split
products (``csrc/ffn_block_tf32x3.cu``, three TF32 products an fp32 one,
fp32's parity). The SIMT kernels (``csrc/ffn_block.cu``) stay as a third
route that only an explicit ``launch_fwd`` / ``launch_bwd`` takes.

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
    SPLIT_BLOCKS,
    SPLIT_BLOCKS_TF32X3,
    check_width,
    ln_backward,
    splits,
)

MAX_FF = 1024
# the kernel works row by row on the M = B * L rows, at any L; its widest
# index, row * d_ff into the hidden state and its dropout mask, stays an int
MAX_HIDDEN = 2 ** 31
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ffn_sublayer_fwd": [_P] * 8 + [_I] * 4
    + [_P, ctypes.c_double, ctypes.c_double, _P],
    "ffn_sublayer_bwd": [_P] * 21 + [_I] * 6
    + [_P, ctypes.c_double, ctypes.c_double, _P],
}
# the tensor-core route's entry points: the SIMT ones less is_bf16, plus
# the scratch of the weights rounded to bf16 (w1b, w2b)
_SIGNATURES_MMA = {
    "ffn_sublayer_fwd_mma": [_P] * 10 + [_I] * 3
    + [_P, ctypes.c_double, ctypes.c_double, _P],
    "ffn_sublayer_bwd_mma": [_P] * 23 + [_I] * 5
    + [_P, ctypes.c_double, ctypes.c_double, _P],
}
# the 3xTF32 route's entry points: the SIMT ones less is_bf16
_SIGNATURES_TF32X3 = {
    "ffn_sublayer_fwd_tf32x3": [_P] * 8 + [_I] * 3
    + [_P, ctypes.c_double, ctypes.c_double, _P],
    "ffn_sublayer_bwd_tf32x3": [_P] * 21 + [_I] * 5
    + [_P, ctypes.c_double, ctypes.c_double, _P],
}
ROUTES = ("mma", "tf32x3", "simt")
# each route's library and entry points
_LIBRARIES = {"mma": ("ffn_block_mma", _SIGNATURES_MMA),
              "tf32x3": ("ffn_block_tf32x3", _SIGNATURES_TF32X3),
              "simt": ("ffn_block", _SIGNATURES)}


def route(dtype, d: int, d_ff: int) -> str:
    """The kernels a CUDA call takes, from dtype, d and d_ff alone, before
    any launch: ``"mma"`` (the tensor cores, ``ffn_block_mma.cu``) for
    bf16, ``"tf32x3"`` (the tensor cores as 3xTF32 split products,
    ``ffn_block_tf32x3.cu``) for fp32, across the whole envelope: fp32's
    operands fit in shared memory at every d <= 256 (128 rows a block and
    64-unit hidden chunks forward at d <= 128, 64 rows and 32-unit chunks
    above; the backward's 32- and 16-unit chunks). Raises
    ``NotImplementedError`` outside the kernels' envelope (d <= 256,
    d_ff <= 1024)."""
    check_width(1, d, dtype)
    if not 1 <= d_ff <= MAX_FF:
        raise NotImplementedError(
            f"FFN kernel covers d_ff <= {MAX_FF}, got {d_ff}")
    return "mma" if dtype == torch.bfloat16 else "tf32x3"


def _pad(n: int, step: int) -> int:
    return -(-n // step) * step


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


def _bwd_parts(x, ln_scale, ln_bias, w1, b1, w2, dy, p_hidden, p_resid,
               seeds):
    """The backward's terms before the ReLU gate, at its rounding points:
    ``(dy, n, pre, hidden, dout, dh, w1c)``, dh not yet gated."""
    dtype = x.dtype
    x32 = x.float()
    dy = dy.to(dtype).float()
    keep_h, keep_r = _masks(x.shape, w1.shape[-1], p_hidden, p_resid, seeds,
                            x.device)
    n = std_layer_norm(x32, ln_scale, ln_bias).to(dtype).float()
    w1c, w2c = w1.to(dtype).float(), w2.to(dtype).float()
    pre = n @ w1c + b1
    hidden = torch.relu(pre)
    if keep_h is not None:
        hidden = torch.where(keep_h, hidden * (1.0 / (1.0 - p_hidden)), 0.0)
    hidden = hidden.to(dtype).float()
    dout = dy
    if keep_r is not None:
        dout = torch.where(keep_r, dout * (1.0 / (1.0 - p_resid)), 0.0)
    dout = dout.to(dtype).float()
    dh = dout @ w2c.t()
    if keep_h is not None:
        dh = torch.where(keep_h, dh * (1.0 / (1.0 - p_hidden)), 0.0)
    return dy, n, pre, hidden, dout, dh, w1c


def ffn_sublayer_bwd_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, dy,
                           p_hidden: float = 0.0, p_resid: float = 0.0,
                           seeds=(0, 0), flip=None):
    """The backward in plain PyTorch ops, mirroring the TPU kernel's
    ``ffn_sublayer_bwd_vmem`` (the JAX package's ``ops/ffn_block.py:76-132``)
    with its rounding points. Returns ``(dx, dg, db, dw1, db1, dw2, db2)``:
    dx in x's dtype, the parameter gradients fp32. ``flip``, a [B, L, d_ff]
    bool mask, inverts those hidden units' ReLU gates (``gate_flips``)."""
    del b2  # the output bias does not enter the backward
    p_hidden = dropout.check_rate(p_hidden)
    p_resid = dropout.check_rate(p_resid)
    dy, n, pre, hidden, dout, dh, w1c = _bwd_parts(
        x, ln_scale, ln_bias, w1, b1, w2, dy, p_hidden, p_resid, seeds)
    gate = pre > 0.0
    if flip is not None:
        gate = gate ^ flip
    dw2 = torch.einsum("blf,bld->fd", hidden, dout)
    dh = (dh * gate.float()).to(x.dtype).float()
    dw1 = torch.einsum("bld,blf->df", n, dh)
    dx_ln, dg, db = ln_backward(x.float(), ln_scale, dh @ w1c.t())
    return ((dy + dx_ln).to(x.dtype), dg, db, dw1, dh.sum(dim=(0, 1)), dw2,
            dout.sum(dim=(0, 1)))


def gate_flips(dx, x, ln_scale, ln_bias, w1, b1, w2, b2, dy,
               p_hidden: float = 0.0, p_resid: float = 0.0, seeds=(0, 0),
               rtol: float = 2 ** -5):
    """The ReLU gates that another backward's ``dx`` took the other way, as
    the [B, L, d_ff] bool mask of ``ffn_sublayer_bwd_plain``'s ``flip``.

    A kept hidden unit whose pre-activation lies within rounding of 0 may
    gate either way in two sums of the same terms, and its row of dx then
    differs by the whole unit's term: the gradient is not continuous there.
    For each row whose ``dx`` differs from the plain one by more than half
    of ``rtol`` times the plain dx's largest value, this tries every subset
    of the row's four kept units closest to their kink (relative to the sum
    of their terms' magnitudes) and keeps the subset whose dx comes
    closest. Rows are independent in dx, so each row is searched alone."""
    p_hidden = dropout.check_rate(p_hidden)
    p_resid = dropout.check_rate(p_resid)
    d, d_ff = x.shape[-1], w1.shape[-1]
    dy32, n, pre, _, _, dh, w1c = _bwd_parts(
        x, ln_scale, ln_bias, w1, b1, w2, dy, p_hidden, p_resid, seeds)
    ref = ffn_sublayer_bwd_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, dy,
                                 p_hidden, p_resid, seeds)[0].float()
    err = (dx.float() - ref).abs().reshape(-1, d).amax(dim=-1)
    rows = torch.nonzero(err > 0.5 * rtol * ref.abs().max()).flatten()
    flip = torch.zeros(x.shape[:-1] + (d_ff,), dtype=torch.bool,
                       device=x.device)
    if rows.numel() == 0:
        return flip
    pre_r, dh_r = pre.reshape(-1, d_ff)[rows], dh.reshape(-1, d_ff)[rows]
    margin = pre_r.abs() / (n.reshape(-1, d)[rows].abs() @ w1c.abs()
                            + b1.abs())
    kept = dh_r != 0.0  # a dropped unit's gate changes nothing
    k = min(4, d_ff)
    near = torch.where(kept, margin, torch.inf).topk(k, largest=False).indices
    choices = ((torch.arange(2 ** k, device=x.device)[:, None]
                >> torch.arange(k, device=x.device)) & 1).bool()
    tried = torch.zeros(rows.numel(), 2 ** k, d_ff, dtype=torch.bool,
                        device=x.device)
    tried.scatter_(2, near[:, None, :].expand(-1, 2 ** k, -1),
                   choices[None].expand(rows.numel(), -1, -1))
    gate = (pre_r > 0.0)[:, None, :] ^ tried
    dh_t = (dh_r[:, None, :] * gate.float()).to(x.dtype).float()
    x_r = x.float().reshape(-1, d)[rows][:, None, :].expand(-1, 2 ** k, -1)
    dx_t = (dy32.reshape(-1, d)[rows][:, None, :]
            + ln_backward(x_r, ln_scale, dh_t @ w1c.t())[0]).to(x.dtype)
    miss = (dx_t.float() - dx.reshape(-1, d)[rows][:, None, :].float()).abs()
    best = miss.amax(dim=-1).argmin(dim=1)
    flip.reshape(-1, d_ff)[rows] = tried[torch.arange(rows.numel()), best]
    return flip


def _d_ff(w1) -> int:
    return w1.shape[-1] if isinstance(w1, torch.Tensor) and w1.dim() == 2 \
        else -1


def _check(x, params):
    if x.dim() != 3:
        raise ValueError(f"x must be [B, L, d], got {tuple(x.shape)}")
    b, l, d = x.shape
    check_width(b, d, x.dtype)
    d_ff = _d_ff(params[2])
    route(x.dtype, d, d_ff)
    if l < 1 or b * l * d_ff >= MAX_HIDDEN:
        raise NotImplementedError(
            f"FFN kernel covers L >= 1 and B * L * d_ff < 2**31, got "
            f"B={b}, L={l}, d_ff={d_ff}")
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
    kernels of ``route``'s answer or raises."""
    if x.device.type == "cpu":
        return ffn_sublayer_fwd_plain(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                      p_hidden, p_resid, seeds)
    if x.device.type != "cuda":
        raise ValueError(f"no FFN sublayer for device {x.device}")
    return launch_fwd(route(x.dtype, x.shape[-1], _d_ff(w1)), x, ln_scale,
                      ln_bias, w1, b1, w2, b2, p_hidden, p_resid, seeds)


def _check_way(way, dtype, d, d_ff):
    if way not in ROUTES or (way != "simt" and route(dtype, d, d_ff) != way):
        raise ValueError(f"no {way!r} kernels for {dtype}, d={d}, "
                         f"d_ff={d_ff}")


def _rounded_weights(d, d_ff, dev):
    """Scratch of the tensor-core route: W1 and W2 rounded to bf16, padded
    with zeros to whole 16-row and 64-column steps."""
    dpad, ffp = _pad(d, 16), _pad(d_ff, 64)
    return (torch.empty((dpad, ffp), dtype=torch.bfloat16, device=dev),
            torch.empty((ffp, dpad), dtype=torch.bfloat16, device=dev))


def launch_fwd(way, x, ln_scale, ln_bias, w1, b1, w2, b2,
               p_hidden: float = 0.0, p_resid: float = 0.0, seeds=(0, 0)):
    """``ffn_sublayer_fwd`` on CUDA tensors through the kernels of route
    ``way``: the wrapper passes ``route``'s answer; the SIMT kernels only
    when named, for comparisons. Counts the launch as the
    wrapper's."""
    p_hidden = dropout.check_rate(p_hidden)
    p_resid = dropout.check_rate(p_resid)
    params = (ln_scale, ln_bias, w1, b1, w2, b2)
    m, d, d_ff = _check(x, params)
    _check_way(way, x.dtype, d, d_ff)

    y = torch.empty_like(x)
    head = (*map(_build.ptr, (x,) + params + (y,)),)
    tail = (_keys(seeds, p_hidden, p_resid), p_hidden, p_resid,
            _build.stream_of(x))
    with torch.cuda.device(x.device):
        lib = _build.load(*_LIBRARIES[way])
        if way == "mma":
            rounded = _rounded_weights(d, d_ff, x.device)
            rc = lib.ffn_sublayer_fwd_mma(*head, *map(_build.ptr, rounded),
                                          m, d, d_ff, *tail)
        elif way == "tf32x3":
            rc = lib.ffn_sublayer_fwd_tf32x3(*head, m, d, d_ff, *tail)
        else:
            rc = lib.ffn_sublayer_fwd(*head, m, d, d_ff,
                                      int(x.dtype == torch.bfloat16), *tail)
    _build.check_launch(lib, rc, f"ffn_sublayer_fwd ({way})")
    ffn_sublayer_fwd.launches += 1
    ffn_sublayer_fwd.route_launches[way] += 1
    return y


ffn_sublayer_fwd.launches = 0
ffn_sublayer_fwd.route_launches = dict.fromkeys(ROUTES, 0)


def ffn_sublayer_bwd(x, ln_scale, ln_bias, w1, b1, w2, b2, dy,
                     p_hidden: float = 0.0, p_resid: float = 0.0,
                     seeds=(0, 0)):
    """``(dx, dg, db, dw1, db1, dw2, db2)`` of the sublayer at x for the
    output gradient ``dy``. A CPU tensor takes the plain version; a CUDA
    tensor launches the backward kernels of ``route``'s answer (they
    recompute the forward from x; nothing is saved) or raises."""
    if x.device.type == "cpu":
        return ffn_sublayer_bwd_plain(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                      dy, p_hidden, p_resid, seeds)
    if x.device.type != "cuda":
        raise ValueError(f"no FFN sublayer for device {x.device}")
    return launch_bwd(route(x.dtype, x.shape[-1], _d_ff(w1)), x, ln_scale,
                      ln_bias, w1, b1, w2, b2, dy, p_hidden, p_resid, seeds)


def launch_bwd(way, x, ln_scale, ln_bias, w1, b1, w2, b2, dy,
               p_hidden: float = 0.0, p_resid: float = 0.0, seeds=(0, 0)):
    """``ffn_sublayer_bwd`` on CUDA tensors through the kernels of route
    ``way`` (see ``launch_fwd``). Counts the launch as the wrapper's."""
    p_hidden = dropout.check_rate(p_hidden)
    p_resid = dropout.check_rate(p_resid)
    params = (ln_scale, ln_bias, w1, b1, w2, b2)
    m, d, d_ff = _check(x, params)
    _check_way(way, x.dtype, d, d_ff)
    dev, dtype = x.device, x.dtype
    _build.require(dy, "dy", tuple(x.shape), dtype, dev)

    blocks = SPLIT_BLOCKS_TF32X3 if way == "tf32x3" else SPLIT_BLOCKS
    s1, s2 = splits(m, d, d_ff, blocks), splits(m, d_ff, d, blocks)
    f32 = dict(dtype=torch.float32, device=dev)
    outs = [torch.empty_like(x), torch.empty(d, **f32), torch.empty(d, **f32),
            torch.empty((d, d_ff), **f32), torch.empty(d_ff, **f32),
            torch.empty((d_ff, d), **f32), torch.empty(d, **f32)]
    # the weight gradients' operands: the tensor-core route pads their rows
    # to whole 16-byte steps (d to 16, d_ff to 64 columns)
    dw, fw = (_pad(d, 16), _pad(d_ff, 64)) if way == "mma" else (d, d_ff)
    scratch = [torch.empty((m, dw), dtype=dtype, device=dev),
               torch.empty((m, dw), dtype=dtype, device=dev),
               torch.empty((m, fw), dtype=dtype, device=dev),
               torch.empty((m, fw), dtype=dtype, device=dev),
               torch.empty(s1 * (d * d_ff + d_ff), **f32),
               torch.empty(s2 * (d_ff * d + d), **f32),
               torch.empty(-(-m // 64) * 2 * d, **f32)]
    head = (*map(_build.ptr, (x, ln_scale, ln_bias, w1, b1, w2, dy)),
            *map(_build.ptr, outs), *map(_build.ptr, scratch))
    tail = (_keys(seeds, p_hidden, p_resid), p_hidden, p_resid,
            _build.stream_of(x))
    with torch.cuda.device(dev):
        lib = _build.load(*_LIBRARIES[way])
        if way == "mma":
            rounded = _rounded_weights(d, d_ff, dev)
            rc = lib.ffn_sublayer_bwd_mma(*head, *map(_build.ptr, rounded),
                                          m, d, d_ff, s1, s2, *tail)
        elif way == "tf32x3":
            rc = lib.ffn_sublayer_bwd_tf32x3(*head, m, d, d_ff, s1, s2,
                                             *tail)
        else:
            rc = lib.ffn_sublayer_bwd(*head, m, d, d_ff, s1, s2,
                                      int(dtype == torch.bfloat16), *tail)
    _build.check_launch(lib, rc, f"ffn_sublayer_bwd ({way})")
    ffn_sublayer_bwd.launches += 1
    ffn_sublayer_bwd.route_launches[way] += 1
    return tuple(outs)


ffn_sublayer_bwd.launches = 0
ffn_sublayer_bwd.route_launches = dict.fromkeys(ROUTES, 0)


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
