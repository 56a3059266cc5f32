"""Slate Transformer encoder (paper: "Context-Aware Learning to Rank with
Self-Attention", arXiv 2005.10084): positional encoding, N pre-norm blocks
over the slate axis with padding-masked self-attention, final LayerNorm.

Each block is an attention sublayer then the FFN sublayer (B2,
``ops/ffn_block``, at every L). ``Transformer.forward`` picks the attention
sublayer's form by slate length, the same for every block
(``encoder_form``):

- L <= 1024: the whole sublayer in one kernel pair (B1,
  ``ops/attention_block``);
- 1024 < L <= 1224: the split block, the JAX package's ``_attention``
  (``models/transformer.py:416-466, 516-518`` there): LayerNorm and the QKV
  projection in PyTorch ops, the bare attention kernel B4
  (``ops/attention_fused``) with dropout on the probabilities inside it,
  the out-projection, the output dropout and the residual in PyTorch ops;
- 1224 < L <= 8192: the split block with the K-tiled kernel B5
  (``ops/attention_tiled``);
- beyond 8192 the encoder raises ``NotImplementedError`` on the GPU.

With ``MEGA_ENCODER_ENABLED`` set (off by default, as the JAX package's
switch of the same name, ``models/transformer.py:202`` there) and the shape
inside B10's envelope (``ops/encoder_block.check_envelope``: L <= 1024,
d <= 256, d_ff <= 1024, N <= 16), ``Transformer.forward`` sends the whole
encoder after the positional encoding, final LayerNorm included, through
the whole-encoder kernel pair B10 (``ops/encoder_block.encoder_forward``)
with the same 4N seeds; outside the envelope it takes the forms above, a gate
before any launch as the JAX package's ``_mega_encoder_runner`` returning
None. Turn it on from Python with
``allrank_tpu_torch.models.transformer.MEGA_ENCODER_ENABLED = True``.

1224 and 8192 are the JAX package's ``FUSED_ATTENTION_MAX_LEN`` and
``TILED_ATTENTION_MAX_LEN``; on this card all three are the port's envelope
until measured, with no gate on B, dtype or heads. CPU tensors take every
kernel's plain version, through the same forms. When autograd records, the
kernels run as autograd Functions whose backwards are the backward kernels;
under ``torch.no_grad``/``inference_mode`` the forward kernels run alone.

In training form (``train=True`` with a generator and a dropout rate) each
block draws four int32 seeds, as the JAX package's ``transformer_apply``
splits four keys per block: attention probabilities, the attention
sublayer's output, the FFN hidden activation and the FFN output. Every form
keys its dropout masks on them the same way (ops/dropout.py: the global
element index of each tensor), so at any L inside B1's envelope the split
block computes B1's function with B1's masks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from allrank_tpu_torch.models.core import (
    Dense,
    LayerNormParams,
    std_layer_norm,
    xavier_uniform,
)
from allrank_tpu_torch.models.positional import (
    FixedPositionalEncoding,
    LearnedPositionalEncoding,
)
from allrank_tpu_torch.ops import dropout
from allrank_tpu_torch.ops.attention_block import MAX_LEN as SUBLAYER_MAX_LEN
from allrank_tpu_torch.ops.attention_block import attention_sublayer
from allrank_tpu_torch.ops.attention_fused import fused_slate_attention
from allrank_tpu_torch.ops.attention_tiled import tiled_slate_attention
from allrank_tpu_torch.ops.encoder_block import (
    covers,
    encoder_forward,
    stack_block_weights,
)
from allrank_tpu_torch.ops.ffn_block import ffn_sublayer

SEED_HIGH = 2 ** 31 - 1  # seeds are drawn from [0, 2**31 - 1), as in JAX
FUSED_ATTENTION_MAX_LEN = 1224
TILED_ATTENTION_MAX_LEN = 8192
# the whole-encoder kernel pair B10 (ops/encoder_block.py); off, as the JAX
# package's switch, until a benchmark judges it
MEGA_ENCODER_ENABLED = False


def encoder_form(l: int, device_type: str):
    """The attention sublayer's form at slate length ``l``: None for the B1
    sublayer, else the bare attention of the split block,
    ``fused_slate_attention`` (B4) or ``tiled_slate_attention`` (B5). Raises
    ``NotImplementedError`` beyond 8192 on the GPU, before any launch; CPU
    tensors run the plain versions at any length."""
    if l <= SUBLAYER_MAX_LEN:
        return None
    if l <= FUSED_ATTENTION_MAX_LEN:
        return fused_slate_attention
    if l <= TILED_ATTENTION_MAX_LEN or device_type == "cpu":
        return tiled_slate_attention
    raise NotImplementedError(
        f"the encoder covers slates of L <= {TILED_ATTENTION_MAX_LEN} on the "
        f"GPU (the tiled attention kernel's envelope), got L={l}")


def split_attention_sublayer(x, key_mask, ln_scale, ln_bias, wqkv, bqkv,
                             wout, bout, h: int, p_attn: float = 0.0,
                             p_resid: float = 0.0, seeds=(0, 0), *,
                             attention):
    """``x + drop_r(attention(LN(x) . Wqkv + bqkv) . Wout + bout)`` with the
    bare attention kernel ``attention`` (B4 or B5) and everything around it
    in PyTorch ops, with B1's rounding points: LN(x), qkv and the attention
    output in x's dtype, the products in fp32 on weights rounded to it, the
    residual in fp32. Dropout on the probabilities (``seeds[0]``) happens
    inside the kernel, on the output (``seeds[1]``, stream ``ATTN_RESID``
    over (b, l, d)) here."""
    b, l, d = x.shape
    dtype = x.dtype
    x32 = x.float()
    n = std_layer_norm(x32, ln_scale, ln_bias).to(dtype)
    qkv = (torch.matmul(n.float(), wqkv.to(dtype).float()) + bqkv).to(dtype)
    q, k, v = (t.reshape(b, l, h, d // h).transpose(1, 2).contiguous()
               for t in qkv.split(d, dim=-1))
    ctx = attention(q, k, v, key_mask, p_attn, seeds[0])
    ctx = ctx.transpose(1, 2).reshape(b, l, d)
    a = torch.matmul(ctx.float(), wout.to(dtype).float()) + bout
    if p_resid:
        keep = dropout.keep_mask(seeds[1], dropout.ATTN_RESID, p_resid,
                                 (b, l, d), x.device)
        a = torch.where(keep, a / (1.0 - p_resid), 0.0)
    return (x32 + a).to(dtype)


@dataclass(frozen=True)
class TransformerDef:
    N: int
    d_model: int
    d_ff: int
    h: int
    dropout: float
    positional_encoding: Optional[str] = None  # None | "fixed" | "learned"
    max_indices: int = 5000

    def __post_init__(self):
        if self.d_model % self.h != 0:
            raise ValueError(
                f"d_model ({self.d_model}) must be divisible by h ({self.h})"
            )


class EncoderBlock(nn.Module):
    def __init__(self, tdef: TransformerDef,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d = tdef.d_model
        self.h = tdef.h
        # three Xavier [d, d] blocks fused on the output axis (q | k | v),
        # so fan statistics match separate projections
        self.qkv = Dense(d, 3 * d, w=torch.cat(
            [xavier_uniform((d, d), generator) for _ in range(3)], dim=1))
        self.out = Dense(d, d, generator)
        self.ff1 = Dense(d, tdef.d_ff, generator)
        self.ff2 = Dense(tdef.d_ff, d, generator)
        self.ln1 = LayerNormParams(d)
        self.ln2 = LayerNormParams(d)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, p: float = 0.0,
                seeds=(0, 0, 0, 0), attention=None) -> torch.Tensor:
        """``seeds``: (attention probabilities, attention output, FFN hidden,
        FFN output) at dropout rate ``p``; ``attention`` that of
        ``encoder_form``: None for the B1 sublayer, else the split block's
        bare attention."""
        args = (x, mask, self.ln1.scale, self.ln1.bias, self.qkv.w,
                self.qkv.b, self.out.w, self.out.b, self.h, p, p, seeds[:2])
        if attention is None:
            x = attention_sublayer(*args)
        else:
            x = split_attention_sublayer(*args, attention=attention)
        return ffn_sublayer(
            x, self.ln2.scale, self.ln2.bias, self.ff1.w, self.ff1.b,
            self.ff2.w, self.ff2.b, p, p, seeds[2:])


class Transformer(nn.Module):
    def __init__(self, tdef: TransformerDef,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.tdef = tdef
        self.layers = nn.ModuleList(
            [EncoderBlock(tdef, generator) for _ in range(tdef.N)])
        self.final_ln = LayerNormParams(tdef.d_model)
        if tdef.positional_encoding == "fixed":
            self.pe = FixedPositionalEncoding(tdef.d_model, tdef.max_indices)
        elif tdef.positional_encoding == "learned":
            self.pe = LearnedPositionalEncoding(tdef.d_model,
                                                tdef.max_indices, generator)
        elif tdef.positional_encoding is not None:
            raise ValueError(
                f"unknown positional encoding '{tdef.positional_encoding}'")
        else:
            self.pe = None

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                indices: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: [B, L, d_model]; mask: [B, L] bool, True at padded documents;
        indices: [B, L] original ranks. With ``train`` and a CPU
        ``generator`` the blocks run with dropout, their seeds drawn from
        the generator on the host."""
        if self.pe is not None:
            x = self.pe(x, mask, indices)
        tdef = self.tdef
        n = len(self.layers)
        whole = MEGA_ENCODER_ENABLED and covers(
            x.shape[0], x.shape[1], tdef.d_model, tdef.d_ff, n, x.dtype,
            tdef.h)
        attention = None if whole else encoder_form(x.shape[1],
                                                    x.device.type)
        x = x.contiguous()
        p = float(tdef.dropout)
        if train and p > 0.0 and generator is not None:
            seeds = torch.randint(0, SEED_HIGH, (4 * n,),
                                  generator=generator).tolist()
        else:
            p, seeds = 0.0, [0] * (4 * n)
        if whole:
            stacks, final_scale, final_bias = stack_block_weights(self)
            return encoder_forward(x, mask, seeds, stacks, final_scale,
                                   final_bias, h=tdef.h, p_drop=p)
        for i, block in enumerate(self.layers):
            x = block(x, mask, p, tuple(seeds[4 * i:4 * i + 4]), attention)
        return std_layer_norm(x, self.final_ln.scale, self.final_ln.bias)
