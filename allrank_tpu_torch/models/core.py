"""Core NN primitives: dense, layer norms, activations, dropout, Xavier
init.

Layouts follow the JAX package (``w`` is ``[d_in, d_out]``), so weights
carry across without transposes (interop.py).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

ACTIVATIONS = {
    "ReLU": F.relu,
    "ReLU6": F.relu6,
    "Sigmoid": torch.sigmoid,
    "Tanh": torch.tanh,
    # jax.nn.gelu defaults to the tanh approximation
    "GELU": lambda x: F.gelu(x, approximate="tanh"),
    "ELU": F.elu,
    "LeakyReLU": lambda x: F.leaky_relu(x, 0.01),
    "SELU": F.selu,
    "CELU": F.celu,
    "SiLU": F.silu,
    "Mish": F.mish,
    "Softplus": F.softplus,
    "Softsign": F.softsign,
    "Hardtanh": lambda x: torch.clamp(x, -1.0, 1.0),
    "Hardsigmoid": F.hardsigmoid,
    "Identity": lambda x: x,
}


def get_activation(name: Optional[str]):
    if name is None:
        return lambda x: x
    if name not in ACTIVATIONS:
        raise ValueError(
            f"Unknown activation '{name}'. Available: {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[name]


def xavier_uniform(shape, generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Glorot/fan-avg uniform over the last two axes, drawn on the CPU from
    ``generator`` (the reference applies it to every parameter with dim > 1)."""
    fan_in, fan_out = shape[-2], shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32)
    return u * (2.0 * limit) - limit


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` in x's dtype; ``w`` is ``[d_in, d_out]``."""
    return x @ w.to(x.dtype) + b.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """torch ``nn.LayerNorm`` semantics in fp32: (x - mean) / sqrt(biased
    var + eps); the FC tower's input norm."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=-1, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return (scale * out + bias).to(x.dtype)


def std_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """The reference encoder's LayerNorm: a * (x - mean) / (std + eps) + b
    with the *unbiased* std and a 1e-24 variance floor (an all-zero row,
    such as a padded document, has variance 0). Not ``nn.LayerNorm``."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    n = x.shape[-1]
    var = ((x32 - mean) ** 2).sum(dim=-1, keepdim=True) / max(n - 1, 1)
    out = (x32 - mean) / (torch.sqrt(torch.clamp(var, min=1e-24)) + eps)
    return (scale * out + bias).to(x.dtype)


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with the JAX package's XLA-path semantics
    (``models/core.py:95-100`` there): each element is kept with
    probability ``1 - p`` and scaled by ``1 / (1 - p)``; the identity at
    ``p == 0`` or without a generator. ``generator`` lives on x's device."""
    if p == 0.0 or generator is None:
        return x
    keep = 1.0 - p
    mask = torch.bernoulli(torch.full(x.shape, keep, device=x.device),
                           generator=generator).bool()
    return torch.where(mask, x / keep, torch.zeros_like(x))


class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int,
                 generator: Optional[torch.Generator] = None,
                 w: Optional[torch.Tensor] = None):
        super().__init__()
        self.w = nn.Parameter(
            xavier_uniform((d_in, d_out), generator) if w is None else w)
        self.b = nn.Parameter(torch.zeros(d_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.w, self.b)


class LayerNormParams(nn.Module):
    """``scale``/``bias`` of one layer norm; which norm applies is the
    caller's choice (``layer_norm`` or ``std_layer_norm``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
