"""The whole encoder, N x (attention sublayer, FFN sublayer) and the final
std-LayerNorm, forward and backward: the CUDA kernel pair B10 of
``csrc/encoder_block.cu`` for CUDA tensors and its plain PyTorch versions,
of the same signatures, for CPU tensors; ``WholeEncoder`` ties the two into
autograd and ``encoder_forward`` is the entry point, with the JAX package's
signature.

Replaces the TPU kernel ``encoder_forward`` of the JAX package's
``ops/encoder_block.py`` (forward ``pallas_call`` at line 302, backward at
line 333), which its ``models/transformer.py`` dispatches only when
``MEGA_ENCODER_ENABLED`` is set. The port's ``models/transformer.py`` has
the same switch, off by default as there.

The function is the chain of the sublayers B1 and B2 (``ops/attention_block``,
``ops/ffn_block``) with each block's four dropout streams (attention
probabilities, attention output, FFN hidden, FFN output; seeds
``seeds[4n:4n + 4]`` at the one rate ``p_drop``), then
``std_layer_norm``. The masks are keyed on (seed, stream, global element
index) (``ops/dropout.py``), so B10's masks equal the chained sublayers' at
every shape, and the kernel, which runs the chained kernels' tile bodies,
gives their bits. In bf16 every version rounds where B1 and B2 do, and the
final LayerNorm's output and its backward's dz are rounded to x's dtype.

Weights arrive stacked on a leading [N] axis in ``STACKED_PER_BLOCK``
order (``stack_block_weights``), float32, in the JAX package's layouts.
"""

from __future__ import annotations

import ctypes

import torch

from allrank_tpu_torch.models.core import std_layer_norm
from allrank_tpu_torch.ops import _build, dropout
from allrank_tpu_torch.ops.attention_block import (
    attention_sublayer_bwd_plain,
    attention_sublayer_fwd_plain,
    ln_backward,
    splits,
)
from allrank_tpu_torch.ops.attention_block import (
    check_envelope as check_attention_envelope,
)
from allrank_tpu_torch.ops.ffn_block import (
    MAX_FF,
    MAX_HIDDEN,
    ffn_sublayer_bwd_plain,
    ffn_sublayer_fwd_plain,
)

# the stacked per-block parameters, in the JAX package's order
# (ops/encoder_block.py:64-67 there), by their names in an EncoderBlock
STACKED_NAMES = ("ln1.scale", "ln1.bias", "qkv.w", "qkv.b", "out.w", "out.b",
                 "ln2.scale", "ln2.bias", "ff1.w", "ff1.b", "ff2.w", "ff2.b")
STACKED_PER_BLOCK = len(STACKED_NAMES)
# per block, the dropout stream of each of its four seeds
STREAMS = (dropout.ATTN_PROBS, dropout.ATTN_RESID, dropout.FFN_HIDDEN,
           dropout.FFN_RESID)
# the most blocks a launch takes (csrc/encoder_block.cu, kMaxBlocks): the
# 4N dropout keys ride in the launch's parameters
MAX_BLOCKS = 16
_P = ctypes.c_void_p
_SIGNATURES = {
    "encoder_block_fwd": [_P, _P, _P, ctypes.c_double, ctypes.c_int, _P],
    "encoder_block_bwd": [_P, _P, _P, ctypes.c_double, ctypes.c_int, _P],
    "encoder_block_grid": [ctypes.c_int] * 3 + [_P],
}


def stack_block_weights(transformer):
    """``(stacks, final_scale, final_bias)`` of a ``Transformer``: the 12
    ``[N, ...]`` stacks of its blocks' parameters in ``STACKED_PER_BLOCK``
    order (the JAX package's ``flat_weights``), and the final LayerNorm's
    pair. Under autograd the stacks pass gradients back to the blocks."""
    stacks = tuple(
        torch.stack([blk.get_parameter(name) for blk in transformer.layers])
        for name in STACKED_NAMES)
    return stacks, transformer.final_ln.scale, transformer.final_ln.bias


def check_envelope(b: int, l: int, d: int, d_ff: int, n_blocks: int, dtype,
                   h: int) -> None:
    """B10's envelope, B1's and B2's: float32 or bfloat16, B >= 1,
    1 <= L <= 1024, d <= 256, d % h == 0, d_ff <= 1024, B * L * d_ff < 2**31,
    and 1 <= N <= 16. Raises ``NotImplementedError`` naming the limit. (The
    JAX package also gates on 120 <= L <= 768 and on its VMEM budget, facts
    of the TPU that are not copied.)"""
    check_attention_envelope(b, l, d, dtype, h)
    if not 1 <= d_ff <= MAX_FF:
        raise NotImplementedError(
            f"the encoder kernel covers d_ff <= {MAX_FF}, got {d_ff}")
    if b * l * d_ff >= MAX_HIDDEN:
        raise NotImplementedError(
            f"the encoder kernel covers B * L * d_ff < 2**31, got B={b}, "
            f"L={l}, d_ff={d_ff}")
    if not 1 <= n_blocks <= MAX_BLOCKS:
        raise NotImplementedError(
            f"the encoder kernel covers 1 <= N <= {MAX_BLOCKS}, got "
            f"N={n_blocks}")


def covers(b: int, l: int, d: int, d_ff: int, n_blocks: int, dtype,
           h: int) -> bool:
    """Whether ``check_envelope`` passes."""
    try:
        check_envelope(b, l, d, d_ff, n_blocks, dtype, h)
    except NotImplementedError:
        return False
    return True


def _seeds(seeds, n_blocks: int) -> tuple:
    seeds = tuple(int(s) for s in (seeds.tolist() if torch.is_tensor(seeds)
                                   else seeds))
    if len(seeds) != 4 * n_blocks:
        raise ValueError(f"the encoder takes 4 seeds per block: "
                         f"{4 * n_blocks}, got {len(seeds)}")
    return seeds


def _block(block_weights, n: int) -> list:
    return [w[n] for w in block_weights]


def encoder_forward_plain(x, key_mask, seeds, block_weights, final_scale,
                          final_bias, *, h: int, p_drop: float = 0.0):
    """The same function in plain PyTorch ops: the loop of the sublayers'
    plain forwards, then the final std-LayerNorm."""
    p = dropout.check_rate(p_drop)
    n_blocks = block_weights[0].shape[0]
    seeds = _seeds(seeds, n_blocks)
    for n in range(n_blocks):
        w = _block(block_weights, n)
        x = attention_sublayer_fwd_plain(x, key_mask, *w[:6], h, p, p,
                                         seeds[4 * n:4 * n + 2])
        x = ffn_sublayer_fwd_plain(x, *w[6:], p, p, seeds[4 * n + 2:4 * n + 4])
    return std_layer_norm(x, final_scale, final_bias)


def encoder_backward_plain(x, key_mask, seeds, block_weights, final_scale,
                           final_bias, dy, *, h: int, p_drop: float = 0.0):
    """The backward in plain PyTorch ops, with the kernel's structure: the
    replay of the forward keeping the 2N sublayer inputs, the final
    LayerNorm's backward, then the reverse sweep through the sublayers'
    plain backwards. Returns ``(dx, *12 stacked gradients, d_final_scale,
    d_final_bias)``: dx in x's dtype, the rest fp32."""
    del final_bias  # the final LayerNorm's bias does not enter the backward
    p = dropout.check_rate(p_drop)
    n_blocks = block_weights[0].shape[0]
    seeds = _seeds(seeds, n_blocks)
    dtype = x.dtype
    inputs = []
    for n in range(n_blocks):
        w = _block(block_weights, n)
        inputs.append(x)
        x = attention_sublayer_fwd_plain(x, key_mask, *w[:6], h, p, p,
                                         seeds[4 * n:4 * n + 2])
        inputs.append(x)
        x = ffn_sublayer_fwd_plain(x, *w[6:], p, p, seeds[4 * n + 2:4 * n + 4])
    dz, dfs, dfb = ln_backward(x.float(), final_scale, dy.to(dtype).float())
    g = dz.to(dtype)
    grads = [[None] * n_blocks for _ in range(STACKED_PER_BLOCK)]
    for n in reversed(range(n_blocks)):
        w = _block(block_weights, n)
        g, *ffn = ffn_sublayer_bwd_plain(inputs[2 * n + 1], *w[6:], g, p, p,
                                         seeds[4 * n + 2:4 * n + 4])
        g, *attn = attention_sublayer_bwd_plain(
            inputs[2 * n], key_mask, *w[:6], g, h, p, p, seeds[4 * n:4 * n + 2])
        for i, t in enumerate(attn + ffn):
            grads[i][n] = t
    return (g, *(torch.stack(s) for s in grads), dfs, dfb)


def _check(x, key_mask, block_weights, final_scale, final_bias, h):
    if x.dim() != 3:
        raise ValueError(f"x must be [B, L, d], got {tuple(x.shape)}")
    if len(block_weights) != STACKED_PER_BLOCK:
        raise ValueError(f"{STACKED_PER_BLOCK} stacked weights, got "
                         f"{len(block_weights)}")
    b, l, d = x.shape
    n_blocks = block_weights[0].shape[0]
    d_ff = block_weights[8].shape[-1]
    check_envelope(b, l, d, d_ff, n_blocks, x.dtype, h)
    dev = x.device
    _build.require(x, "x", (b, l, d), x.dtype, dev)
    _build.require(key_mask, "key_mask", (b, l), torch.bool, dev)
    shapes = ((d,), (d,), (d, 3 * d), (3 * d,), (d, d), (d,), (d,), (d,),
              (d, d_ff), (d_ff,), (d_ff, d), (d,))
    for name, t, shape in zip(STACKED_NAMES, block_weights, shapes):
        _build.require(t, name, (n_blocks,) + shape, torch.float32, dev)
    _build.require(final_scale, "final_scale", (d,), torch.float32, dev)
    _build.require(final_bias, "final_bias", (d,), torch.float32, dev)
    return b, l, d, d_ff, n_blocks


def _launch(fn_name, tensors, dims, seeds, p, x):
    """One launch of ``fn_name`` on the buffers ``tensors``, with the 4N
    streams' keys as a host array (ops/dropout.py)."""
    lib = _build.load("encoder_block", _SIGNATURES)
    bufs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    dims = (ctypes.c_int * len(dims))(*dims)
    keys = dropout.key_array(*(dropout.kernel_keys(s, STREAMS[i % 4], p)
                               for i, s in enumerate(seeds)))
    with torch.cuda.device(x.device):
        rc = getattr(lib, fn_name)(bufs, dims, keys, p,
                                   int(x.dtype == torch.bfloat16),
                                   _build.stream_of(x))
    _build.check_launch(lib, rc, fn_name)


def encoder_block_fwd(x, key_mask, seeds, block_weights, final_scale,
                      final_bias, *, h: int, p_drop: float = 0.0):
    """``x`` [B, L, d] float32/bfloat16; ``key_mask`` [B, L] bool (True =
    padded); ``seeds`` the 4N int seeds. A CPU tensor takes the plain
    version; a CUDA tensor launches the forward kernel (one cooperative
    launch) or raises, outside the envelope before any launch."""
    if x.device.type == "cpu":
        return encoder_forward_plain(x, key_mask, seeds, block_weights,
                                     final_scale, final_bias, h=h,
                                     p_drop=p_drop)
    if x.device.type != "cuda":
        raise ValueError(f"no encoder kernel for device {x.device}")
    p = dropout.check_rate(p_drop)
    b, l, d, d_ff, n_blocks = _check(x, key_mask, block_weights, final_scale,
                                     final_bias, h)
    seeds = _seeds(seeds, n_blocks)
    dev, dtype = x.device, x.dtype
    m = b * l
    y = torch.empty_like(x)
    scratch = [torch.empty((2, m, d), dtype=dtype, device=dev),
               torch.empty((m, 3 * d), dtype=dtype, device=dev)]
    tensors = [x, key_mask, *block_weights, final_scale, final_bias, y,
               *scratch]
    _launch("encoder_block_fwd", tensors, (b, l, d, h, d_ff, n_blocks), seeds,
            p, x)
    encoder_block_fwd.launches += 1
    return y


encoder_block_fwd.launches = 0


def encoder_block_bwd(x, key_mask, seeds, block_weights, final_scale,
                      final_bias, dy, *, h: int, p_drop: float = 0.0):
    """``(dx, *12 stacked gradients, d_final_scale, d_final_bias)`` of the
    encoder at x for the output gradient ``dy``. A CPU tensor takes the
    plain version; a CUDA tensor launches the backward kernel (one
    cooperative launch: it replays the forward, so nothing is saved) or
    raises."""
    if x.device.type == "cpu":
        return encoder_backward_plain(x, key_mask, seeds, block_weights,
                                      final_scale, final_bias, dy, h=h,
                                      p_drop=p_drop)
    if x.device.type != "cuda":
        raise ValueError(f"no encoder kernel for device {x.device}")
    p = dropout.check_rate(p_drop)
    b, l, d, d_ff, n_blocks = _check(x, key_mask, block_weights, final_scale,
                                     final_bias, h)
    seeds = _seeds(seeds, n_blocks)
    dev, dtype = x.device, x.dtype
    _build.require(dy, "dy", (b, l, d), dtype, dev)
    m, tiles = b * l, -(-b * l // 64)
    s_qkv, s_out = splits(m, d, 3 * d), splits(m, d, d)
    s_1, s_2 = splits(m, d, d_ff), splits(m, d_ff, d)
    f32 = dict(dtype=torch.float32, device=dev)
    act = dict(dtype=dtype, device=dev)
    outs = [torch.empty_like(x),
            *(torch.empty_like(w, dtype=torch.float32) for w in block_weights),
            torch.empty(d, **f32), torch.empty(d, **f32)]
    scratch = [torch.empty((2 * n_blocks, m, d), **act),       # xs
               torch.empty((n_blocks, m, 3 * d), **act),       # qkv
               torch.empty((n_blocks, b, h, l, 2), **f32),     # stats
               *(torch.empty((m, d), **act) for _ in range(6)),
               # gz0, gz1, da, dO, n_act_a, ctx
               torch.empty((m, 3 * d), **act),                 # dqkv
               torch.empty((b, h, l), **f32),                  # D
               torch.empty((m, d), **act), torch.empty((m, d), **act),
               # n_act_f, dout
               torch.empty((m, d_ff), **act), torch.empty((m, d_ff), **act),
               # hidden, dh
               torch.empty(s_qkv * (3 * d * d + 3 * d), **f32),
               torch.empty(s_out * (d * d + d), **f32),
               torch.empty(tiles * 2 * d, **f32),
               torch.empty(s_1 * (d * d_ff + d_ff), **f32),
               torch.empty(s_2 * (d_ff * d + d), **f32),
               torch.empty(tiles * 2 * d, **f32),
               torch.empty(tiles * 2 * d, **f32)]
    tensors = [x, key_mask, *block_weights, final_scale, final_bias, dy,
               *outs, *scratch]
    _launch("encoder_block_bwd", tensors,
            (b, l, d, h, d_ff, n_blocks, s_qkv, s_out, s_1, s_2), seeds, p, x)
    encoder_block_bwd.launches += 1
    return tuple(outs)


encoder_block_bwd.launches = 0


def cooperative_grid(d: int, dtype, backward: bool, device=None) -> dict:
    """The cooperative launch of the forward or backward kernel at width d
    on the current (or given) CUDA device: ``{"grid", "blocks_per_sm",
    "sms", "smem_bytes"}``; the grid is what the card holds at once."""
    lib = _build.load("encoder_block", _SIGNATURES)
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        rc = lib.encoder_block_grid(int(backward), d,
                                    int(dtype == torch.bfloat16), out)
    _build.check_launch(lib, rc, "encoder_block_grid")
    return dict(zip(("grid", "blocks_per_sm", "sms", "smem_bytes"), out))


class WholeEncoder(torch.autograd.Function):
    """The encoder under autograd: the forward (kernel or plain version by
    device) keeps x and the weights; the backward is ``encoder_block_bwd``,
    which replays the forward as the TPU kernel does."""

    @staticmethod
    def forward(ctx, x, key_mask, seeds, h, p_drop, final_scale, final_bias,
                *block_weights):
        ctx.save_for_backward(x, key_mask, final_scale, final_bias,
                              *block_weights)
        ctx.config = (seeds, h, p_drop)
        return encoder_block_fwd(x, key_mask, seeds, block_weights,
                                 final_scale, final_bias, h=h, p_drop=p_drop)

    @staticmethod
    def backward(ctx, dy):
        x, key_mask, final_scale, final_bias, *block_weights = (
            ctx.saved_tensors)
        seeds, h, p_drop = ctx.config
        dx, *grads = encoder_block_bwd(
            x, key_mask, seeds, block_weights, final_scale, final_bias,
            dy.to(x.dtype).contiguous(), h=h, p_drop=p_drop)
        return (dx, None, None, None, None, grads[-2], grads[-1],
                *grads[:-2])


def encoder_forward(x, key_mask, seeds, block_weights, final_scale,
                    final_bias, *, h: int, p_drop: float = 0.0):
    """N-block encoder and final LayerNorm in one kernel pair, the JAX
    package's ``encoder_forward``: x [B, L, d]; key_mask [B, L] (True =
    padded); seeds the 4N int seeds (per block: attention probabilities,
    attention output, FFN hidden, FFN output); block_weights the 12 stacks
    of ``stack_block_weights``. Through ``WholeEncoder`` when autograd
    records, else the forward alone (one launch)."""
    seeds = tuple(seeds.tolist() if torch.is_tensor(seeds) else seeds)
    if torch.is_grad_enabled():
        return WholeEncoder.apply(x, key_mask, seeds, h, p_drop, final_scale,
                                  final_bias, *block_weights)
    return encoder_block_fwd(x, key_mask, seeds, block_weights, final_scale,
                             final_bias, h=h, p_drop=p_drop)
