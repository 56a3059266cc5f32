"""Ordinal regression loss (the JAX package's ``losses/ordinal.py``;
reference allrank/models/losses/ordinal.py:8-50)."""

from __future__ import annotations

from typing import Optional

import torch

from allrank_tpu_torch.constants import PADDED_Y_VALUE
from allrank_tpu_torch.losses.common import as_f32, bce_elementwise


def with_ordinals(y: torch.Tensor, n: int,
                  padded_value_indicator: int = PADDED_Y_VALUE
                  ) -> torch.Tensor:
    """Labels -> cumulative one-hot ordinals: out[..., k] = (y >= k + 1);
    padding propagates."""
    (y,) = as_f32(y)
    thresholds = torch.arange(1, n + 1, dtype=torch.float32, device=y.device)
    expanded = y[..., None]
    ordinals = (expanded >= thresholds).float()
    return torch.where(expanded == padded_value_indicator,
                       float(padded_value_indicator), ordinals)


def ordinal(y_pred: torch.Tensor, y_true: torch.Tensor, n: int,
            padded_value_indicator: int = PADDED_Y_VALUE,
            slate_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked BCE over n cumulative ordinal targets, normalized by the count
    of valid documents. ``y_pred`` is [B, L, n] from a sigmoid head
    (d_output = n)."""
    y_pred, y_true = as_f32(y_pred, y_true)
    targets = with_ordinals(y_true, n, padded_value_indicator)

    mask = targets == padded_value_indicator
    ls = torch.where(mask, 0.0, bce_elementwise(
        y_pred, torch.where(mask, 0.0, targets)))

    document_loss = ls.sum(dim=2)
    doc_valid = (~mask).any(dim=2).float()
    if slate_mask is not None:
        sw = torch.as_tensor(slate_mask, device=y_true.device).float()
        document_loss = document_loss * sw[:, None]
        doc_valid = doc_valid * sw[:, None]

    return document_loss.sum() / torch.clamp(doc_valid.sum(), min=1.0)
