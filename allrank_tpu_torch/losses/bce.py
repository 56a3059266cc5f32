"""Binary cross-entropy loss (the JAX package's ``losses/bce.py``; reference
allrank/models/losses/bce.py:8-32)."""

from __future__ import annotations

from typing import Optional

import torch

from allrank_tpu_torch.constants import PADDED_Y_VALUE
from allrank_tpu_torch.losses.common import (
    as_f32,
    bce_elementwise,
    padding_mask,
)


def bce(y_pred: torch.Tensor, y_true: torch.Tensor,
        padded_value_indicator: int = PADDED_Y_VALUE,
        slate_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked elementwise BCE normalized by the number of slates with at
    least one valid document."""
    y_pred, y_true = as_f32(y_pred, y_true)
    mask = padding_mask(y_true, padded_value_indicator)

    ls = torch.where(mask, 0.0, bce_elementwise(
        y_pred, torch.where(mask, 0.0, y_true)))

    document_loss = ls.sum(dim=-1)
    slate_has_valid = (~mask).any(dim=-1).float()
    if slate_mask is not None:
        sw = torch.as_tensor(slate_mask, device=y_true.device).float()
        document_loss = document_loss * sw
        slate_has_valid = slate_has_valid * sw

    return document_loss.sum() / torch.clamp(slate_has_valid.sum(), min=1.0)
