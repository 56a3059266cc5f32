"""Rank-indexed positional encodings.

Both variants index by the documents' *original ranks* (``indices``), not
their slate positions; padded documents map to a dedicated zero row, the
table's last. The result is ``sqrt(d_model) * x + table[idx]``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from allrank_tpu_torch.models.core import xavier_uniform


def fixed_positional_table(d_model: int, max_len: int) -> np.ndarray:
    """[max_len + 1, d_model] sin/cos table computed in float64 and stored
    as float32; the extra last row is the zero padding row."""
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float64)
        * -(math.log(10000.0) / d_model)
    )
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)[:, : pe[:, 1::2].shape[1]]
    return np.vstack([pe, np.zeros((1, d_model))]).astype(np.float32)


def padded_indices(indices: torch.Tensor, mask: torch.Tensor,
                   padding_idx: int) -> torch.Tensor:
    """Padded documents go to ``padding_idx``; ranks past it are clamped to
    it (the zero row)."""
    idx = torch.where(mask, torch.full_like(indices, padding_idx), indices)
    return torch.clamp(idx, max=padding_idx)


def positional_apply(table: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                     indices: torch.Tensor) -> torch.Tensor:
    padding_idx = table.shape[0] - 1
    idx = padded_indices(indices.long(), mask, padding_idx)
    return math.sqrt(table.shape[1]) * x + table[idx].to(x.dtype)


class FixedPositionalEncoding(nn.Module):
    """The sin/cos table, kept as a buffer (a constant, never trained)."""

    def __init__(self, d_model: int, max_len: int):
        super().__init__()
        self.register_buffer(
            "table", torch.from_numpy(fixed_positional_table(d_model, max_len)))

    def forward(self, x, mask, indices):
        return positional_apply(self.table, x, mask, indices)


class LearnedPositionalEncoding(nn.Module):
    """[max_len + 1, d_model] learned embedding with a zero padding row."""

    def __init__(self, d_model: int, max_len: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        table = xavier_uniform((max_len + 1, d_model), generator)
        table[-1] = 0.0
        self.table = nn.Parameter(table)

    def forward(self, x, mask, indices):
        return positional_apply(self.table, x, mask, indices)
