"""Slate Transformer encoder (paper: "Context-Aware Learning to Rank with
Self-Attention", arXiv 2005.10084): positional encoding, N pre-norm blocks
over the slate axis with padding-masked self-attention, final LayerNorm.

Each block is the attention sublayer then the FFN sublayer, both through
``ops``: on CUDA tensors the hand-written kernels, on CPU tensors their
plain versions. There is no dispatch gate on B or L: on CUDA every sublayer
inside the kernels' envelope runs the kernel, and outside it the encoder
raises ``NotImplementedError`` naming the limit. When autograd records, the
sublayers run as autograd Functions whose backwards are the backward
kernels; under ``torch.no_grad``/``inference_mode`` the forward kernels run
alone.

In training form (``train=True`` with a generator and a dropout rate) each
block draws four int32 seeds, as the JAX package's ``transformer_apply``
splits four keys per block: attention probabilities, the attention
sublayer's output, the FFN hidden activation and the FFN output. The
kernels key their dropout masks on them (ops/dropout.py).
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
from allrank_tpu_torch.ops.attention_block import attention_sublayer
from allrank_tpu_torch.ops.ffn_block import ffn_sublayer

SEED_HIGH = 2 ** 31 - 1  # seeds are drawn from [0, 2**31 - 1), as in JAX


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
                seeds=(0, 0, 0, 0)) -> torch.Tensor:
        """``seeds``: (attention probabilities, attention output, FFN hidden,
        FFN output) at dropout rate ``p``."""
        x = attention_sublayer(
            x, mask, self.ln1.scale, self.ln1.bias, self.qkv.w, self.qkv.b,
            self.out.w, self.out.b, self.h, p, p, seeds[:2])
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
        x = x.contiguous()
        n = len(self.layers)
        p = float(self.tdef.dropout)
        if train and p > 0.0 and generator is not None:
            seeds = torch.randint(0, SEED_HIGH, (4 * n,),
                                  generator=generator).tolist()
        else:
            p, seeds = 0.0, [0] * (4 * n)
        for i, block in enumerate(self.layers):
            x = block(x, mask, p, tuple(seeds[4 * i:4 * i + 4]))
        return std_layer_norm(x, self.final_ln.scale, self.final_ln.bias)
