"""ApproxNDCG loss (the JAX package's ``losses/approxndcg.py``; reference
allrank/models/losses/approxNDCG.py:7-53).

The only O(L^2) work is the approximate-position sum over valid
off-diagonal pairs. On CUDA it is the rank-sum kernel B9
(``ops/approx_pos.py``), whose wrapper raises ``NotImplementedError``
beyond the kernel's length (L <= 8192, the encoder's cap); on the CPU the
loss runs the JAX package's XLA-path chain of torch ops under autograd,
the plain version.
"""

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
from allrank_tpu_torch.ops.approx_pos import fused_approx_pos
from allrank_tpu_torch.ops.lambda_pairs import position_tables


def approxNDCGLoss(y_pred: torch.Tensor, y_true: torch.Tensor,
                   eps: float = DEFAULT_EPS,
                   padded_value_indicator: int = PADDED_Y_VALUE,
                   alpha: float = 1.0,
                   slate_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NDCG with sigmoid-approximated ranks:
    rank_i ~ 1 + sum_j sigmoid(-alpha (s_i - s_j))."""
    y_pred, y_true = as_f32(y_pred, y_true)
    mask = padding_mask(y_true, padded_value_indicator)
    sw = resolve_slate_mask(y_true, slate_mask)
    slate_length = y_true.shape[1]

    y_pred_f = torch.where(mask, float("-inf"), y_pred)
    y_true_f = torch.where(mask, float("-inf"), y_true)

    # the reference's stable descending argsort; padding (-inf) goes last
    y_pred_sorted, order = torch.sort(y_pred_f, dim=-1, descending=True,
                                      stable=True)
    true_sorted_by_preds = torch.gather(y_true_f, 1, order)
    y_true_sorted = torch.sort(y_true_f, dim=-1, descending=True).values

    valid = torch.isfinite(true_sorted_by_preds)

    true_sorted_by_preds = torch.clamp(true_sorted_by_preds, min=0.0)
    y_true_sorted = torch.clamp(y_true_sorted, min=0.0)

    D = position_tables(slate_length, y_pred.device)[0]
    max_dcgs = torch.clamp(
        ((torch.pow(2.0, y_true_sorted) - 1.0) / D).sum(dim=-1), min=eps)
    G = (torch.pow(2.0, true_sorted_by_preds) - 1.0) / max_dcgs[:, None]

    chain = _fused_pos if y_pred.device.type == "cuda" else _plain_pos
    approx_pos = 1.0 + chain(y_pred_sorted, valid, alpha, eps)
    approx_D = torch.log2(1.0 + approx_pos)
    approx_ndcg = (G / approx_D).sum(dim=-1)

    return -masked_mean_over_slates(approx_ndcg, sw)


def _fused_pos(y_pred_sorted, valid, alpha, eps):
    """The rank sums through the kernel B9, which reads the valid
    documents' scores only; the padded ones (-inf) are zeroed first, so that
    the plain version on a CPU tensor sees finite scores."""
    return fused_approx_pos(torch.where(valid, y_pred_sorted, 0.0),
                            valid.float(), alpha=alpha, eps=eps)


def _plain_pos(y_pred_sorted, valid, alpha, eps):
    """The same in the JAX package's XLA-path formulation
    (``losses/approxndcg.py:70-80`` there), under autograd."""
    n = y_pred_sorted.shape[1]
    pair_valid = valid[:, :, None] & valid[:, None, :]
    # the diagonal is no part of the approximate rank sum
    off_diag = ~torch.eye(n, dtype=torch.bool, device=valid.device)
    pairs = pair_valid & off_diag[None]
    scores_diffs = y_pred_sorted[:, :, None] - y_pred_sorted[:, None, :]
    scores_diffs = torch.where(pairs, scores_diffs, 0.0)
    return (pairs.float() * torch.clamp(
        torch.sigmoid(-alpha * scores_diffs), min=eps)).sum(dim=-1)
