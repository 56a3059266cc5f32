"""Slate Transformer encoder (paper: "Context-Aware Learning to Rank with
Self-Attention", arXiv 2005.10084): positional encoding, N pre-norm blocks
over the slate axis with padding-masked self-attention, final LayerNorm.

Each block is the attention sublayer then the FFN sublayer, both through
``ops``: on CUDA tensors the hand-written kernels, on CPU tensors their
plain versions. There is no dispatch gate on B or L: on CUDA every sublayer
inside the kernels' envelope runs the kernel, and outside it the encoder
raises ``NotImplementedError`` naming the limit.
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
from allrank_tpu_torch.ops.attention_block import attention_sublayer_fwd
from allrank_tpu_torch.ops.ffn_block import ffn_sublayer_fwd


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

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = attention_sublayer_fwd(
            x, mask, self.ln1.scale, self.ln1.bias, self.qkv.w, self.qkv.b,
            self.out.w, self.out.b, self.h)
        return ffn_sublayer_fwd(
            x, self.ln2.scale, self.ln2.bias, self.ff1.w, self.ff1.b,
            self.ff2.w, self.ff2.b)


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
                indices: torch.Tensor) -> torch.Tensor:
        """x: [B, L, d_model]; mask: [B, L] bool, True at padded documents;
        indices: [B, L] original ranks."""
        if self.pe is not None:
            x = self.pe(x, mask, indices)
        x = x.contiguous()
        for block in self.layers:
            x = block(x, mask)
        return std_layer_norm(x, self.final_ln.scale, self.final_ln.bias)
