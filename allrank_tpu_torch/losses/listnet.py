"""ListNet losses (the JAX package's ``losses/listnet.py``; reference
allrank/models/losses/listNet.py:8-30 and binary_listNet.py:8-33)."""

from __future__ import annotations

from typing import Optional

import torch

from allrank_tpu_torch.constants import DEFAULT_EPS, PADDED_Y_VALUE
from allrank_tpu_torch.losses.common import (
    as_f32,
    masked_mean_over_slates,
    padding_mask,
    resolve_slate_mask,
)


def listNet(y_pred: torch.Tensor, y_true: torch.Tensor,
            eps: float = DEFAULT_EPS,
            padded_value_indicator: int = PADDED_Y_VALUE,
            slate_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked softmax cross-entropy between softmax(y_true) and
    softmax(y_pred). Padded documents are excluded by a -inf fill on both
    sides before the softmax."""
    y_pred, y_true = as_f32(y_pred, y_true)
    mask = padding_mask(y_true, padded_value_indicator)
    sw = resolve_slate_mask(y_true, slate_mask)

    y_pred = torch.where(mask, float("-inf"), y_pred)
    y_true = torch.where(mask, float("-inf"), y_true)

    preds_smax = torch.softmax(y_pred, dim=1)
    true_smax = torch.softmax(y_true, dim=1)

    preds_log = torch.log(preds_smax + eps)
    # an all-padded slate's rows of -inf softmax to NaN
    ce = torch.where(mask, 0.0, true_smax * preds_log)
    per_slate = -torch.where(torch.isnan(ce), 0.0, ce).sum(dim=1)
    return masked_mean_over_slates(per_slate, sw)


def binary_listNet(y_pred: torch.Tensor, y_true: torch.Tensor,
                   eps: float = DEFAULT_EPS,
                   padded_value_indicator: int = PADDED_Y_VALUE,
                   slate_mask: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """ListNet for binary labels: the targets are y_true / sum(y_true)
    (zero-safe) instead of a label softmax."""
    y_pred, y_true = as_f32(y_pred, y_true)
    mask = padding_mask(y_true, padded_value_indicator)
    sw = resolve_slate_mask(y_true, slate_mask)

    y_pred = torch.where(mask, float("-inf"), y_pred)
    y_true = torch.where(mask, 0.0, y_true)

    normalizer = y_true.sum(dim=-1, keepdim=True)
    normalizer = torch.where(normalizer == 0.0, 1.0, normalizer)
    targets = y_true / normalizer

    preds_smax = torch.softmax(y_pred, dim=1)
    preds_log = torch.log(preds_smax + eps)
    ce = targets * preds_log
    per_slate = -torch.where(torch.isnan(ce), 0.0, ce).sum(dim=1)
    return masked_mean_over_slates(per_slate, sw)
