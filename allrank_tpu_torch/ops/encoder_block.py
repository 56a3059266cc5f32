"""The whole encoder, N x (attention sublayer, FFN sublayer) and the final
std-LayerNorm, forward and backward: the CUDA kernel pair B10 for CUDA
tensors (``csrc/encoder_block.cuh`` with the routes of
``csrc/encoder_block_bf16.cuh`` and ``csrc/encoder_block_f32.cuh``, one
source a dtype and head class, ``csrc/encoder_block_{bf16,f32}_*.cu``) and
its plain PyTorch versions, of the same signatures, for CPU tensors; ``WholeEncoder`` ties the two into
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
every shape. Each kernel runs the tile bodies of the routes the chained
sublayers take (``route``: B1's and B2's tensor-core routes, B1's SIMT
kernels for heads wider than 128) with their weight-gradient split counts,
so up to the final LayerNorm it gives the chained kernels' bits. In bf16
every version rounds where B1 and B2 do, and the final LayerNorm's output
and its backward's dz are rounded to x's dtype.

Under autograd the forward parks what the backward reads (on CUDA the 2N
sublayer inputs, each block's qkv and its softmax row statistics; on the
CPU the plain version's sublayer inputs), and the backward starts at the
final LayerNorm's backward. ``encoder_block_bwd`` without that state, the
JAX signature, replays the forward first, as the TPU kernel does.

Weights arrive stacked on a leading [N] axis in ``STACKED_PER_BLOCK``
order (``stack_block_weights``), float32, in the JAX package's layouts.
"""

from __future__ import annotations

import ctypes

import torch

from allrank_tpu_torch.models.core import std_layer_norm
from allrank_tpu_torch.ops import _build, dropout
from allrank_tpu_torch.ops import attention_block, ffn_block
from allrank_tpu_torch.ops.attention_block import (
    SPLIT_BLOCKS,
    SPLIT_BLOCKS_TF32X3,
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
# the most blocks a launch takes (csrc/encoder_block.cuh, kMaxBlocks): the
# 4N dropout keys ride in the launch's parameters
MAX_BLOCKS = 16
_P = ctypes.c_void_p
_SIGNATURES = {
    "encoder_block_fwd": [_P, _P, _P, ctypes.c_double, _P],
    "encoder_block_bwd": [_P, _P, _P, ctypes.c_double, _P],
    "encoder_block_grid": [ctypes.c_int] * 3 + [_P],
}
# B10's routes, (attention, FFN) as ``route`` names them, by their launches
ROUTES = ("mma/mma", "tf32x3/tf32x3", "simt/mma", "simt/tf32x3")


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
    and 1 <= N <= 16; a head of 128 or fewer columns takes whole 16-byte
    rows (d_k a multiple of 8 in bf16, of 4 in fp32: B10 stages heads by
    16-byte copies alone, where the chained kernels have an element-wise
    form too). Raises ``NotImplementedError`` naming the limit. (The JAX
    package also gates on 120 <= L <= 768 and on its VMEM budget, facts of
    the TPU that are not copied.)"""
    check_attention_envelope(b, l, d, dtype, h)
    row = 8 if dtype == torch.bfloat16 else 4
    if d // h <= attention_block.MMA_MAX_HEAD and (d // h) % row:
        raise NotImplementedError(
            f"the encoder kernel covers heads of whole 16-byte rows (d_k a "
            f"multiple of {row} in {dtype}), got d_k={d // h}")
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


def route(dtype, d: int, h: int, d_ff: int) -> tuple:
    """The (attention, FFN) routes whose tile bodies B10 runs, from dtype,
    d, h and d_ff alone, before any launch: the answers of
    ``attention_block.route`` and ``ffn_block.route``, whose chained
    kernels the encoder takes with the switch off. Raises
    ``NotImplementedError`` where they do."""
    return (attention_block.route(dtype, d, h),
            ffn_block.route(dtype, d, d_ff))


def split_counts(dtype, m: int, d: int, h: int, d_ff: int) -> tuple:
    """``(s_qkv, s_out, s_1, s_2)``: the row splits of B10's four
    weight-gradient products over m = B * L rows, each the chained route's
    (``SPLIT_BLOCKS_TF32X3`` on the 3xTF32 routes, ``SPLIT_BLOCKS`` on the
    others), so that each gradient is the chained kernels' sum."""
    way_a, way_f = route(dtype, d, h, d_ff)
    blocks_a = SPLIT_BLOCKS_TF32X3 if way_a == "tf32x3" else SPLIT_BLOCKS
    blocks_f = SPLIT_BLOCKS_TF32X3 if way_f == "tf32x3" else SPLIT_BLOCKS
    return (splits(m, d, 3 * d, blocks_a), splits(m, d, d, blocks_a),
            splits(m, d, d_ff, blocks_f), splits(m, d_ff, d, blocks_f))


def _route_name(dtype, d, h, d_ff) -> str:
    return "/".join(route(dtype, d, h, d_ff))


def library(dtype, d: int, h: int) -> str:
    """The source of B10's kernels for dtype and the head width d / h: one
    a dtype and head class (d_k padded to 32, 64 or 128, or wider than 128
    on B1's SIMT phases)."""
    dk = d // h
    head = ("simt" if dk > attention_block.MMA_MAX_HEAD
            else f"dk{32 if dk <= 32 else 64 if dk <= 64 else 128}")
    return (f"encoder_block_{'bf16' if dtype == torch.bfloat16 else 'f32'}_"
            f"{head}")


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


def _blocks_plain(x, key_mask, seeds, block_weights, h, p):
    """The N blocks' plain forwards: the 2N + 1 sublayer inputs, the last
    the final LayerNorm's."""
    inputs = [x]
    for n in range(block_weights[0].shape[0]):
        w = _block(block_weights, n)
        inputs.append(attention_sublayer_fwd_plain(
            inputs[-1], key_mask, *w[:6], h, p, p, seeds[4 * n:4 * n + 2]))
        inputs.append(ffn_sublayer_fwd_plain(
            inputs[-1], *w[6:], p, p, seeds[4 * n + 2:4 * n + 4]))
    return inputs


def encoder_forward_plain(x, key_mask, seeds, block_weights, final_scale,
                          final_bias, *, h: int, p_drop: float = 0.0,
                          return_saved: bool = False):
    """The same function in plain PyTorch ops: the loop of the sublayers'
    plain forwards, then the final std-LayerNorm. With ``return_saved``
    returns ``(y, saved)``: saved the 2N + 1 sublayer inputs, which
    ``encoder_backward_plain`` reads instead of replaying the forward."""
    p = dropout.check_rate(p_drop)
    seeds = _seeds(seeds, block_weights[0].shape[0])
    inputs = _blocks_plain(x, key_mask, seeds, block_weights, h, p)
    y = std_layer_norm(inputs[-1], final_scale, final_bias)
    return (y, tuple(inputs)) if return_saved else y


def encoder_backward_plain(x, key_mask, seeds, block_weights, final_scale,
                           final_bias, dy, *, h: int, p_drop: float = 0.0,
                           saved=None):
    """The backward in plain PyTorch ops, with the kernel's structure: the
    2N sublayer inputs (``saved`` from ``encoder_forward_plain(...,
    return_saved=True)``, else a replay of the forward), the final
    LayerNorm's backward, then the reverse sweep through the sublayers'
    plain backwards. Returns ``(dx, *12 stacked gradients, d_final_scale,
    d_final_bias)``: dx in x's dtype, the rest fp32."""
    del final_bias  # the final LayerNorm's bias does not enter the backward
    p = dropout.check_rate(p_drop)
    n_blocks = block_weights[0].shape[0]
    seeds = _seeds(seeds, n_blocks)
    dtype = x.dtype
    inputs = (list(saved) if saved is not None
              else _blocks_plain(x, key_mask, seeds, block_weights, h, p))
    if len(inputs) != 2 * n_blocks + 1:
        raise ValueError(f"saved holds the {2 * n_blocks + 1} sublayer "
                         f"inputs, got {len(inputs)}")
    dz, dfs, dfb = ln_backward(inputs[-1].float(), final_scale,
                               dy.to(dtype).float())
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
    """One launch of ``fn_name`` of the library of x's dtype and head width
    (``dims``: B, L, d, h, ...) on the buffers ``tensors`` (None: a null
    pointer), with the 4N streams' keys as a host array (ops/dropout.py)."""
    lib = _build.load(library(x.dtype, dims[2], dims[3]), _SIGNATURES)
    bufs = (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])
    dims = (ctypes.c_int * len(dims))(*dims)
    keys = dropout.key_array(*(dropout.kernel_keys(s, STREAMS[i % 4], p)
                               for i, s in enumerate(seeds)))
    with torch.cuda.device(x.device):
        rc = getattr(lib, fn_name)(bufs, dims, keys, p, _build.stream_of(x))
    _build.check_launch(lib, rc, fn_name)


def _parked(b, l, d, h, n_blocks, dtype, dev, park: bool) -> tuple:
    """The buffers the forward leaves for the backward, (xs, qkv, stats):
    parked, the 2N sublayer inputs after x [2N, B*L, d], each block's qkv
    [N, B*L, 3d] and row statistics [N, B, h, L, 2]; else the forward's
    scratch alone, two stream buffers, one qkv and no statistics."""
    m = b * l
    act = dict(dtype=dtype, device=dev)
    if not park:
        return (torch.empty((2, m, d), **act), torch.empty((m, 3 * d), **act),
                None)
    return (torch.empty((2 * n_blocks, m, d), **act),
            torch.empty((n_blocks, m, 3 * d), **act),
            torch.empty((n_blocks, b, h, l, 2), dtype=torch.float32,
                        device=dev))


def _rounded_weights(d, d_ff, n_blocks, dtype, dev) -> list:
    """The bf16 kernels' scratch W1 and W2 of every block rounded to bf16,
    padded to whole 16-row and 64-column steps (``ffn_block``'s); the fp32
    kernels take none."""
    if dtype != torch.bfloat16:
        return [None, None]
    dpad, ffp = -(-d // 16) * 16, -(-d_ff // 64) * 64
    return [torch.empty((n_blocks, dpad, ffp), dtype=dtype, device=dev),
            torch.empty((n_blocks, ffp, dpad), dtype=dtype, device=dev)]


def _count(fn, dtype, d, h, d_ff):
    fn.launches += 1
    fn.route_launches[_route_name(dtype, d, h, d_ff)] += 1


def encoder_block_fwd(x, key_mask, seeds, block_weights, final_scale,
                      final_bias, *, h: int, p_drop: float = 0.0,
                      return_saved: bool = False):
    """``x`` [B, L, d] float32/bfloat16; ``key_mask`` [B, L] bool (True =
    padded); ``seeds`` the 4N int seeds. A CPU tensor takes the plain
    version; a CUDA tensor launches the forward kernel of ``route``'s
    routes (one cooperative launch) or raises, outside the envelope before
    any launch. With ``return_saved`` returns ``(y, saved)``, saved what
    ``encoder_block_bwd`` reads instead of replaying the forward."""
    if x.device.type == "cpu":
        return encoder_forward_plain(x, key_mask, seeds, block_weights,
                                     final_scale, final_bias, h=h,
                                     p_drop=p_drop, return_saved=return_saved)
    if x.device.type != "cuda":
        raise ValueError(f"no encoder kernel for device {x.device}")
    p = dropout.check_rate(p_drop)
    b, l, d, d_ff, n_blocks = _check(x, key_mask, block_weights, final_scale,
                                     final_bias, h)
    seeds = _seeds(seeds, n_blocks)
    dev, dtype = x.device, x.dtype
    y = torch.empty_like(x)
    saved = _parked(b, l, d, h, n_blocks, dtype, dev, return_saved)
    ctx = (torch.empty((b * l, d), dtype=dtype, device=dev)
           if dtype == torch.float32 else None)
    tensors = [x, key_mask, *block_weights, final_scale, final_bias, y,
               *saved, ctx, *_rounded_weights(d, d_ff, n_blocks, dtype, dev)]
    _launch("encoder_block_fwd", tensors,
            (b, l, d, h, d_ff, n_blocks, int(return_saved)), seeds, p, x)
    _count(encoder_block_fwd, dtype, d, h, d_ff)
    return (y, saved) if return_saved else y


encoder_block_fwd.launches = 0
encoder_block_fwd.route_launches = dict.fromkeys(ROUTES, 0)


def encoder_block_bwd(x, key_mask, seeds, block_weights, final_scale,
                      final_bias, dy, *, h: int, p_drop: float = 0.0,
                      saved=None):
    """``(dx, *12 stacked gradients, d_final_scale, d_final_bias)`` of the
    encoder at x for the output gradient ``dy``. A CPU tensor takes the
    plain version; a CUDA tensor launches the backward kernel (one
    cooperative launch) or raises. ``saved``, the forward's parked state
    for the same inputs, seeds and rate (``encoder_block_fwd(...,
    return_saved=True)``), spares the kernel its replay of the forward."""
    if x.device.type == "cpu":
        return encoder_backward_plain(x, key_mask, seeds, block_weights,
                                      final_scale, final_bias, dy, h=h,
                                      p_drop=p_drop, saved=saved)
    if x.device.type != "cuda":
        raise ValueError(f"no encoder kernel for device {x.device}")
    p = dropout.check_rate(p_drop)
    b, l, d, d_ff, n_blocks = _check(x, key_mask, block_weights, final_scale,
                                     final_bias, h)
    seeds = _seeds(seeds, n_blocks)
    dev, dtype = x.device, x.dtype
    _build.require(dy, "dy", (b, l, d), dtype, dev)
    m, tiles = b * l, -(-b * l // 64)
    replay = saved is None
    if replay:
        saved = _parked(b, l, d, h, n_blocks, dtype, dev, True)
    else:
        for name, t, shape, want in zip(
                ("xs", "qkv", "stats"), saved,
                ((2 * n_blocks, m, d), (n_blocks, m, 3 * d),
                 (n_blocks, b, h, l, 2)), (dtype, dtype, torch.float32)):
            _build.require(t, f"saved {name}", shape, want, dev)
    s_qkv, s_out, s_1, s_2 = split_counts(dtype, m, d, h, d_ff)
    # B2's scratch rows: padded to 16 (d) and 64 (d_ff) columns in bf16
    dw, fw = ((-(-d // 16) * 16, -(-d_ff // 64) * 64)
              if dtype == torch.bfloat16 else (d, d_ff))
    f32 = dict(dtype=torch.float32, device=dev)
    act = dict(dtype=dtype, device=dev)
    outs = [torch.empty_like(x),
            *(torch.empty_like(w, dtype=torch.float32) for w in block_weights),
            torch.empty(d, **f32), torch.empty(d, **f32)]
    scratch = [*saved,
               *(torch.empty((m, d), **act) for _ in range(6)),
               # gz0, gz1, da, dO, n_act_a, ctx
               torch.empty((m, 3 * d), **act),                 # dqkv
               torch.empty((b, h, l), **f32),                  # D
               torch.empty((m, dw), **act), torch.empty((m, dw), **act),
               # n_act_f, dout
               torch.empty((m, fw), **act), torch.empty((m, fw), **act),
               # hidden, dh
               torch.empty(s_qkv * (3 * d * d + 3 * d), **f32),
               torch.empty(s_out * (d * d + d), **f32),
               torch.empty(tiles * 2 * d, **f32),
               torch.empty(s_1 * (d * d_ff + d_ff), **f32),
               torch.empty(s_2 * (d_ff * d + d), **f32),
               torch.empty(tiles * 2 * d, **f32),
               torch.empty(tiles * 2 * d, **f32),
               *_rounded_weights(d, d_ff, n_blocks, dtype, dev)]
    tensors = [x, key_mask, *block_weights, final_scale, final_bias, dy,
               *outs, *scratch]
    _launch("encoder_block_bwd", tensors,
            (b, l, d, h, d_ff, n_blocks, s_qkv, s_out, s_1, s_2, int(replay)),
            seeds, p, x)
    _count(encoder_block_bwd, dtype, d, h, d_ff)
    return tuple(outs)


encoder_block_bwd.launches = 0
encoder_block_bwd.route_launches = dict.fromkeys(ROUTES, 0)


def cooperative_grid(d: int, dtype, backward: bool, device=None,
                     h: int = 1) -> dict:
    """The cooperative launch of the forward or backward kernel at width d
    with h heads on the current (or given) CUDA device: ``{"grid",
    "blocks_per_sm", "sms", "smem_bytes"}``; the grid is what the card
    holds at once."""
    lib = _build.load(library(dtype, d, h), _SIGNATURES)
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        rc = lib.encoder_block_grid(int(backward), d, h, out)
    _build.check_launch(lib, rc, "encoder_block_grid")
    return dict(zip(("grid", "blocks_per_sm", "sms", "smem_bytes"), out))


class WholeEncoder(torch.autograd.Function):
    """The encoder under autograd: the forward (kernel or plain version by
    device) keeps x, the weights and its parked state; the backward is
    ``encoder_block_bwd`` on that state, which starts at the final
    LayerNorm's backward."""

    @staticmethod
    def forward(ctx, x, key_mask, seeds, h, p_drop, final_scale, final_bias,
                *block_weights):
        y, saved = encoder_block_fwd(x, key_mask, seeds, block_weights,
                                     final_scale, final_bias, h=h,
                                     p_drop=p_drop, return_saved=True)
        ctx.save_for_backward(x, key_mask, final_scale, final_bias,
                              *block_weights, *saved)
        ctx.config = (seeds, h, p_drop)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, key_mask, final_scale, final_bias, *rest = ctx.saved_tensors
        block_weights, saved = rest[:STACKED_PER_BLOCK], rest[STACKED_PER_BLOCK:]
        seeds, h, p_drop = ctx.config
        dx, *grads = encoder_block_bwd(
            x, key_mask, seeds, block_weights, final_scale, final_bias,
            dy.to(x.dtype).contiguous(), h=h, p_drop=p_drop,
            saved=tuple(saved))
        return (dx, None, None, None, None, grads[-2], grads[-1],
                *grads[:-2])


def encoder_forward(x, key_mask, seeds, block_weights, final_scale,
                    final_bias, *, h: int, p_drop: float = 0.0):
    """N-block encoder and final LayerNorm in one kernel pair, the JAX
    package's ``encoder_forward``: x [B, L, d]; key_mask [B, L] (True =
    padded); seeds the 4N int seeds (per block: attention probabilities,
    attention output, FFN hidden, FFN output); block_weights the 12 stacks
    of ``stack_block_weights``. Through ``WholeEncoder`` when autograd
    records, else the forward alone (one launch, nothing parked)."""
    seeds = tuple(seeds.tolist() if torch.is_tensor(seeds) else seeds)
    if torch.is_grad_enabled():
        return WholeEncoder.apply(x, key_mask, seeds, h, p_drop, final_scale,
                                  final_bias, *block_weights)
    return encoder_block_fwd(x, key_mask, seeds, block_weights, final_scale,
                             final_bias, h=h, p_drop=p_drop)
