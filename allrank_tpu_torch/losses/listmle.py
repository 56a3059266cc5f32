"""ListMLE Plackett-Luce likelihood loss (the JAX package's
``losses/listmle.py``; reference allrank/models/losses/listMLE.py:7-38)."""

from __future__ import annotations

from typing import Optional

import torch

from allrank_tpu_torch.constants import DEFAULT_EPS, PADDED_Y_VALUE
from allrank_tpu_torch.losses.common import (
    as_f32,
    masked_mean_over_slates,
    resolve_slate_mask,
)


def listMLE(y_pred: torch.Tensor, y_true: torch.Tensor,
            eps: float = DEFAULT_EPS,
            padded_value_indicator: int = PADDED_Y_VALUE,
            generator: Optional[torch.Generator] = None,
            slate_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plackett-Luce negative log-likelihood of the label-descending order.

    ``generator`` (a CPU ``torch.Generator``) drives the random column
    permutation that resolves ties, as the reference's ``torch.randperm``
    each call; with ``generator=None`` the order is that of a stable sort.
    The loss is the same either way whenever the labels are free of ties.
    """
    y_pred, y_true = as_f32(y_pred, y_true)
    sw = resolve_slate_mask(y_true, slate_mask)

    if generator is not None:
        perm = torch.randperm(y_pred.shape[-1], generator=generator).to(
            y_pred.device)
        y_pred = y_pred[:, perm]
        y_true = y_true[:, perm]

    # the stable label-descending order; y_pred rides it and its gradient
    # flows back through the gather
    y_true_sorted, order = torch.sort(y_true, dim=-1, descending=True,
                                      stable=True)
    preds_sorted = torch.gather(y_pred, 1, order)
    mask = y_true_sorted == padded_value_indicator

    preds_sorted = torch.where(mask, float("-inf"), preds_sorted)

    max_pred = preds_sorted.max(dim=-1, keepdim=True).values
    # an all-padded slate has no finite score
    max_pred = torch.where(torch.isfinite(max_pred), max_pred, 0.0)
    shifted = preds_sorted - max_pred

    # reversed cumulative logsumexp: log sum_{j >= i} exp(s_j - max)
    exp_shifted = torch.where(mask, 0.0, torch.exp(shifted))
    rev_cumsum = torch.flip(torch.cumsum(torch.flip(exp_shifted, dims=[1]),
                                         dim=1), dims=[1])

    observation_loss = torch.log(rev_cumsum + eps) - torch.where(
        mask, 0.0, shifted)
    observation_loss = torch.where(mask, 0.0, observation_loss)

    return masked_mean_over_slates(observation_loss.sum(dim=1), sw)
