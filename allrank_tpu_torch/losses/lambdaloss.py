"""LambdaLoss with pluggable weighing schemes (the JAX package's
``losses/lambdaloss.py:87-224``; reference allrank/models/losses/
lambdaLoss.py:7-114).

As there, the reference's boolean-mask reduction becomes a dense pair mask
over the top-k block, and the position tables (log2 discounts, ndcgLoss2
deltas) are host float64 values rounded to float32. On CUDA the pair chain
is the kernel B3 (``ops/lambda_pairs.py``); on the CPU the loss runs the
JAX package's XLA-path formulation under autograd, the plain version.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from allrank_tpu_torch.constants import DEFAULT_EPS, PADDED_Y_VALUE
from allrank_tpu_torch.losses.common import as_f32, padding_mask
from allrank_tpu_torch.ops.lambda_pairs import (
    check_scheme,
    fused_lambda_pairs,
    ndcg2_deltas,
    pair_weights,
    position_tables,
)


def lambdaLoss(y_pred: torch.Tensor, y_true: torch.Tensor,
               eps: float = DEFAULT_EPS,
               padded_value_indicator: int = PADDED_Y_VALUE,
               weighing_scheme: Optional[str] = None, k: Optional[int] = None,
               sigma: float = 1.0, mu: float = 10.0, reduction: str = "sum",
               reduction_log: str = "binary",
               slate_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Unified LambdaLoss: weighted pairwise sigmoid probabilities over
    prediction-sorted slates, truncated to the top-k x top-k pair block.
    ``y_pred``/``y_true`` [B, L]; padded documents carry
    ``y_true == padded_value_indicator``; ``slate_mask`` [B] marks real
    slates (None: all)."""
    if reduction_log not in ("natural", "binary"):
        raise ValueError(
            "Reduction logarithm base can be either natural or binary")
    if reduction not in ("sum", "mean"):
        raise ValueError("Reduction method can be either sum or mean")
    check_scheme(weighing_scheme)

    y_pred, y_true = as_f32(y_pred, y_true)
    mask = padding_mask(y_true, padded_value_indicator)
    slate_length = y_true.shape[1]
    dev = y_pred.device

    y_pred_f = torch.where(mask, float("-inf"), y_pred)
    y_true_f = torch.where(mask, float("-inf"), y_true)
    # the reference's stable descending argsort; padding (-inf) goes last
    y_pred_sorted, order = torch.sort(y_pred_f, dim=-1, descending=True,
                                      stable=True)
    true_sorted_by_preds = torch.gather(y_true_f, 1, order)
    y_true_sorted = torch.sort(y_true_f, dim=-1, descending=True).values

    k_eff = slate_length if k is None else min(int(k), slate_length)

    y_true_sorted = torch.clamp(y_true_sorted, min=0.0)
    D = position_tables(slate_length, dev)[0]
    max_dcgs = torch.clamp(
        (((torch.pow(2.0, y_true_sorted) - 1.0) / D)[:, :k_eff]).sum(dim=-1),
        min=eps)

    # every selected pair lies in the top-k x top-k block of the
    # prediction-sorted slate: slice to it before any pair tensor exists
    true_raw_topk = true_sorted_by_preds[:, :k_eff]  # -inf at padding
    y_pred_sorted = y_pred_sorted[:, :k_eff]
    pred_valid = torch.isfinite(true_raw_topk)
    true_sorted_by_preds = torch.clamp(true_raw_topk, min=0.0)
    G = (torch.pow(2.0, true_sorted_by_preds) - 1.0) / max_dcgs[:, None]
    D = D[:k_eff]
    slate_ok = (None if slate_mask is None
                else torch.as_tensor(slate_mask, device=dev).bool())
    # the CPU runs the JAX package's XLA-path formulation, not the kernel's
    # plain version, so the kernel route is held against an independent one
    chain = _fused_chain if dev.type == "cuda" else _plain_chain
    total, count = chain(y_pred_sorted, true_raw_topk, true_sorted_by_preds,
                         pred_valid, G, D, slate_ok, weighing_scheme, k_eff,
                         sigma, mu, reduction_log, eps)
    if reduction == "sum":
        return -total
    return -total / torch.clamp(count, min=1.0)


def _fused_chain(y_pred_sorted, true_raw_topk, true_sorted_by_preds,
                 pred_valid, G, D, slate_ok, scheme, k_eff, sigma, mu,
                 reduction_log, eps):
    """(loss total, selected-pair count) through the pair-chain kernel B3."""
    del true_raw_topk, D  # the kernel takes its own position tables
    valid_rows = pred_valid
    if slate_ok is not None:
        valid_rows = valid_rows & slate_ok[:, None]
    loss_sums, counts = fused_lambda_pairs(
        torch.where(pred_valid, y_pred_sorted, 0.0), true_sorted_by_preds, G,
        valid_rows.float(), scheme=scheme, k_eff=k_eff, sigma=sigma, mu=mu,
        log_base=reduction_log, eps=eps)
    return loss_sums.sum(), counts.sum()


def _plain_chain(y_pred_sorted, true_raw_topk, true_sorted_by_preds,
                 pred_valid, G, D, slate_ok, scheme, k_eff, sigma, mu,
                 reduction_log, eps):
    """The same in the JAX package's XLA-path formulation
    (``losses/lambdaloss.py:186-224`` there), under autograd."""
    del k_eff  # the inputs are already the top-k block
    pair_valid = pred_valid[:, :, None] & pred_valid[:, None, :]
    true_diffs = torch.where(
        pair_valid, true_raw_topk[:, :, None] - true_raw_topk[:, None, :],
        0.0)
    selected = pair_valid
    if scheme != "ndcgLoss1_scheme":
        selected = selected & (true_diffs > 0)
    if slate_ok is not None:
        selected = selected & slate_ok[:, None, None]

    deltas = torch.from_numpy(ndcg2_deltas(G.shape[1])).to(G.device)
    weights = pair_weights(scheme, G, true_sorted_by_preds, D, deltas, mu)
    scores_diffs = torch.where(
        pair_valid, y_pred_sorted[:, :, None] - y_pred_sorted[:, None, :],
        0.0)
    scores_diffs = torch.clamp(scores_diffs, -1e8, 1e8)
    # log(max(pow(max(s, eps), w), eps)) == max(w log(max(s, eps)), log eps)
    log_a = torch.log(torch.clamp(torch.sigmoid(sigma * scores_diffs),
                                  min=eps))
    losses = log_a if weights is None else weights * log_a
    losses = torch.clamp(losses, min=float(np.log(eps)))
    if reduction_log == "binary":
        losses = losses / float(np.log(2.0))
    selected = selected.float()
    return (losses * selected).sum(), selected.sum()
