"""RankNet pairwise losses (the JAX package's ``losses/ranknet.py``;
reference allrank/models/losses/rankNet.py:9-79).

As there, the reference's boolean-indexed pair list becomes dense [B, L, L]
score and label difference matrices with the unselected pairs weighted 0;
the reduction is the reference's: a mean over the count of selected pairs
in the batch.
"""

from __future__ import annotations

from typing import Optional

import torch

from allrank_tpu_torch.constants import PADDED_Y_VALUE
from allrank_tpu_torch.losses.common import (
    as_f32,
    bce_with_logits,
    padding_mask,
    resolve_slate_mask,
)


def rankNet(y_pred: torch.Tensor, y_true: torch.Tensor,
            padded_value_indicator: int = PADDED_Y_VALUE,
            weight_by_diff: bool = False, weight_by_diff_powed: bool = False,
            slate_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pairwise logistic loss over all (i, j) with y_true_i > y_true_j."""
    y_pred, y_true = as_f32(y_pred, y_true)
    mask = padding_mask(y_true, padded_value_indicator)
    sw = resolve_slate_mask(y_true, slate_mask)

    valid = ~mask
    pair_valid = valid[:, :, None] & valid[:, None, :]

    true_diffs = y_true[:, :, None] - y_true[:, None, :]
    selected = pair_valid & (true_diffs > 0)
    selected = selected & (sw[:, None, None] > 0)
    sel_f = selected.float()

    pred_diffs = y_pred[:, :, None] - y_pred[:, None, :]
    pred_diffs = torch.where(selected, pred_diffs, 0.0)

    if weight_by_diff:
        weight = true_diffs.abs()
    elif weight_by_diff_powed:
        weight = (y_true[:, :, None] ** 2 - y_true[:, None, :] ** 2).abs()
    else:
        weight = torch.ones_like(true_diffs)
    weight = torch.where(selected, weight, 0.0)

    # the selected targets are all 1 (true_diffs > 0)
    losses = bce_with_logits(pred_diffs, torch.ones_like(pred_diffs)) \
        * weight * sel_f

    return losses.sum() / torch.clamp(sel_f.sum(), min=1.0)


def rankNet_weightByGTDiff(y_pred, y_true,
                           padded_value_indicator: int = PADDED_Y_VALUE,
                           slate_mask=None):
    """RankNet weighted by |delta ground truth|."""
    return rankNet(y_pred, y_true, padded_value_indicator,
                   weight_by_diff=True, slate_mask=slate_mask)


def rankNet_weightByGTDiff_pow(y_pred, y_true,
                               padded_value_indicator: int = PADDED_Y_VALUE,
                               slate_mask=None):
    """RankNet weighted by |delta of squared ground truth|."""
    return rankNet(y_pred, y_true, padded_value_indicator,
                   weight_by_diff=False, weight_by_diff_powed=True,
                   slate_mask=slate_mask)
