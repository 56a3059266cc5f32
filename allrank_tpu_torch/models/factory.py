"""LTR model assembly: FC tower -> (optional) Transformer -> output head.

``make_model`` turns a parsed config into a static ``LTRModelDef`` (the
same definitions as the JAX package's); ``LTRModel`` is the ``nn.Module``
that holds the weights, under the JAX package's parameter names (``.`` in
place of its ``|``), so interop.py carries them across by name.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch
from torch import nn

from allrank_tpu_torch.config import ModelConfig
from allrank_tpu_torch.models.core import (
    Dense,
    LayerNormParams,
    dropout,
    get_activation,
    layer_norm,
)
from allrank_tpu_torch.models.transformer import Transformer, TransformerDef
from allrank_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class FCDef:
    sizes: Tuple[int, ...]
    input_norm: bool
    activation: Optional[str]
    dropout: float
    n_features: int

    @property
    def output_size(self) -> int:
        return self.sizes[-1]


@dataclass(frozen=True)
class OutputDef:
    d_model: int
    d_output: int
    output_activation: Optional[str] = None


@dataclass(frozen=True)
class LTRModelDef:
    fc: Optional[FCDef]
    transformer: Optional[TransformerDef]
    output: OutputDef
    n_features: int


def make_model(model_config: ModelConfig, n_features: int) -> LTRModelDef:
    """The architecture definition of a parsed config."""
    fc = None
    d_model = n_features
    if model_config.fc_model:
        fcc = model_config.fc_model
        fc = FCDef(
            sizes=tuple(fcc.sizes),
            input_norm=fcc.input_norm,
            activation=fcc.activation,
            dropout=float(fcc.dropout or 0.0),
            n_features=n_features,
        )
        d_model = fc.output_size

    transformer = None
    if model_config.transformer:
        tc = model_config.transformer
        pe_strategy = None
        max_indices = 5000
        if tc.positional_encoding:
            pe_strategy = tc.positional_encoding.strategy
            max_indices = tc.positional_encoding.max_indices
        transformer = TransformerDef(
            N=tc.N,
            d_model=d_model,
            d_ff=tc.d_ff,
            h=tc.h,
            dropout=float(tc.dropout or 0.0),
            positional_encoding=pe_strategy,
            max_indices=max_indices,
        )

    output = OutputDef(
        d_model=d_model,
        d_output=model_config.post_model.d_output,
        output_activation=model_config.post_model.output_activation,
    )
    return LTRModelDef(fc=fc, transformer=transformer, output=output,
                       n_features=n_features)


def as_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """``"float32"``/``"bfloat16"`` (or the torch dtype itself)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute dtype must be float32 or bfloat16, "
                         f"got {dtype!r}")
    return getattr(torch, dtype)


class FCTower(nn.Module):
    def __init__(self, fcdef: FCDef,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = (fcdef.n_features,) + fcdef.sizes
        self.layers = nn.ModuleList(
            [Dense(dims[i], dims[i + 1], generator)
             for i in range(len(fcdef.sizes))])
        self.input_norm = (LayerNormParams(fcdef.n_features)
                           if fcdef.input_norm else None)
        self.activation = get_activation(fcdef.activation)
        self.p = float(fcdef.dropout)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` (on x's device) turns on dropout after each layer,
        as the JAX package's ``_fc_apply`` in training."""
        if self.input_norm is not None:
            x = layer_norm(x, self.input_norm.scale, self.input_norm.bias)
        for layer in self.layers:
            x = dropout(self.activation(layer(x)), self.p, generator)
        return x


def device_generator(generator: torch.Generator,
                     device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded from the host ``generator``: the
    generator itself on the CPU, a fresh one on a GPU."""
    if device.type == "cpu":
        return generator
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    return torch.Generator(device=device).manual_seed(seed)


class LTRModel(nn.Module):
    """The ranking model, for scoring and, with ``train=True``, for training
    with dropout. Weights are drawn on the CPU from ``generator`` and then
    moved to ``device`` (default: the GPU)."""

    def __init__(self, mdef: LTRModelDef,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.mdef = mdef
        self.fc = FCTower(mdef.fc, generator) if mdef.fc else None
        self.transformer = (Transformer(mdef.transformer, generator)
                            if mdef.transformer else None)
        self.output = Dense(mdef.output.d_model, mdef.output.d_output,
                            generator)
        self.to(dev)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                indices: torch.Tensor,
                compute_dtype: Union[str, torch.dtype] = torch.float32,
                train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """[B, L, F] -> [B, L, d_output], squeezed to [B, L] when
        d_output == 1. x is cast to ``compute_dtype`` at the input and the
        encoder output back to fp32 before the head. With ``train`` and a
        CPU ``generator``, dropout is on in the FC tower and the encoder
        (the JAX package's ``forward(..., train=True, rng=...)``)."""
        h = x.to(as_dtype(compute_dtype))
        gen = generator if train else None
        if self.fc is not None:
            fc_gen = None
            if gen is not None and self.fc.p > 0.0:
                fc_gen = device_generator(gen, h.device)
            h = self.fc(h, fc_gen)
        if self.transformer is not None:
            h = self.transformer(h, mask, indices, train, gen)
        out = self.output(h.float())
        if self.mdef.output.d_output == 1:
            out = out.squeeze(2)
        return get_activation(self.mdef.output.output_activation)(out)

    def score(self, x, mask, indices,
              compute_dtype: Union[str, torch.dtype] = torch.float32
              ) -> torch.Tensor:
        """Per-document scores [B, L]; multi-output heads sum over
        d_output (how the ordinal head scores)."""
        out = self.forward(x, mask, indices, compute_dtype)
        if self.mdef.output.d_output > 1:
            out = out.sum(dim=-1)
        return out
