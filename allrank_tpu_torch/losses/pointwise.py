"""Pointwise RMSE loss (the JAX package's ``losses/pointwise.py``; reference
allrank/models/losses/pointwise.py:6-32)."""

from __future__ import annotations

from typing import Optional

import torch

from allrank_tpu_torch.constants import PADDED_Y_VALUE
from allrank_tpu_torch.losses.common import (
    as_f32,
    masked_mean_over_slates,
    padding_mask,
    resolve_slate_mask,
)


def pointwise_rmse(y_pred: torch.Tensor, y_true: torch.Tensor,
                   no_of_levels: float,
                   padded_value_indicator: int = PADDED_Y_VALUE,
                   slate_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-slate masked RMSE of (y - no_of_levels * y_pred), averaged over
    slates."""
    y_pred, y_true = as_f32(y_pred, y_true)
    mask = padding_mask(y_true, padded_value_indicator)
    sw = resolve_slate_mask(y_true, slate_mask)

    valid = (~mask).float()
    y_true = torch.where(mask, 0.0, y_true)
    y_pred = torch.where(mask, 0.0, y_pred)

    errors = (y_true - no_of_levels * y_pred) ** 2
    mse = errors.sum(dim=1) / torch.clamp(valid.sum(dim=1), min=1.0)
    return masked_mean_over_slates(torch.sqrt(mse), sw)
