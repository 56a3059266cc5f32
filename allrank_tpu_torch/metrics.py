"""Mask-aware ranking metrics, vectorised over slates and cutoffs (the JAX
package's ``metrics.py``, and through it the reference's).

* ``ndcg``: NDCG@k; slates with IDCG == 0 score ``filler_value`` (1.0).
* ``dcg``:  DCG@k from one descending sort and a cumulative sum, every
  cutoff read from the same cumsum.
* ``mrr``:  reciprocal rank of the first maximal label. By default it keeps
  the reference's quirk: the "no relevant document" zeroing is decided by
  the batch-global sum of the slates' maximal labels, not per slate;
  ``strict=True`` zeroes per slate.
* ``map_``, ``err``: mean average precision and expected reciprocal rank.

All functions take [B, L] tensors (or arrays) and return [B, len(ats)]
float32 tensors on the predictions' device. Padded documents carry
``y_true == padding_indicator`` and sort last.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from allrank_tpu_torch.constants import PADDED_Y_VALUE


def position_discounts(slate_length: int) -> np.ndarray:
    """1 / log2(rank + 2), computed in float64 and stored as float32."""
    return (1.0 / np.log2(np.arange(slate_length, dtype=np.float64) + 2.0)
            ).astype(np.float32)


_DISCOUNTS: dict = {}


def discounts_on(slate_length: int, device) -> torch.Tensor:
    """``position_discounts`` as a tensor on ``device``, copied there once:
    a host-to-device copy per call would stall the host."""
    key = (slate_length, torch.device(device))
    if key not in _DISCOUNTS:
        # a tensor made under inference mode could not enter autograd later
        with torch.inference_mode(False):
            _DISCOUNTS[key] = torch.from_numpy(
                position_discounts(slate_length)).to(device)
    return _DISCOUNTS[key]


def pow2_gain(x: torch.Tensor) -> torch.Tensor:
    return torch.pow(2.0, x) - 1.0


def identity_gain(x: torch.Tensor) -> torch.Tensor:
    return x


def _as_f32_pair(y_pred, y_true):
    y_pred = torch.as_tensor(y_pred).float()
    y_true = torch.as_tensor(y_true, device=y_pred.device).float()
    return y_pred, y_true


def _true_sorted_by_preds(y_pred, y_true, padding_indicator):
    """True labels by descending prediction (stable); padded documents sort
    last with label 0."""
    mask = y_true == padding_indicator
    y_pred = torch.where(mask, float("-inf"), y_pred)
    y_true = torch.where(mask, 0.0, y_true)
    order = torch.sort(-y_pred, dim=-1, stable=True).indices
    return torch.gather(y_true, -1, order)


def _cutoffs(ats, slate_length):
    if ats is None:
        ats = [slate_length]
    return [min(int(at), slate_length) for at in ats]


def dcg(y_pred, y_true, ats: Optional[Sequence[int]] = None,
        gain_function: Callable = pow2_gain,
        padding_indicator: int = PADDED_Y_VALUE) -> torch.Tensor:
    """DCG at each cutoff in ``ats`` (at full length if None)."""
    y_pred, y_true = _as_f32_pair(y_pred, y_true)
    slate_length = y_true.shape[-1]
    ats = _cutoffs(ats, slate_length)
    true_sorted = _true_sorted_by_preds(y_pred, y_true, padding_indicator)
    cum_dcg = torch.cumsum(gain_function(true_sorted)
                           * discounts_on(slate_length, y_true.device), dim=-1)
    return cum_dcg[:, [at - 1 for at in ats]]


def ndcg(y_pred, y_true, ats: Optional[Sequence[int]] = None,
         gain_function: Callable = pow2_gain,
         padding_indicator: int = PADDED_Y_VALUE,
         filler_value: float = 1.0) -> torch.Tensor:
    """NDCG at each cutoff; slates with IDCG == 0 score ``filler_value``."""
    idcg = dcg(y_true, y_true, ats, gain_function, padding_indicator)
    raw = dcg(y_pred, y_true, ats, gain_function, padding_indicator)
    safe_idcg = torch.where(idcg == 0.0, 1.0, idcg)
    return torch.where(idcg == 0.0, filler_value, raw / safe_idcg)


def mrr(y_pred, y_true, ats: Optional[Sequence[int]] = None,
        padding_indicator: int = PADDED_Y_VALUE,
        strict: bool = False) -> torch.Tensor:
    """Reciprocal rank of the first maximal true label under the predicted
    order (see the module docstring for the batch-global quirk)."""
    y_pred, y_true = _as_f32_pair(y_pred, y_true)
    slate_length = y_true.shape[-1]
    if ats is None:
        ats = [slate_length]
    true_sorted = _true_sorted_by_preds(y_pred, y_true, padding_indicator)
    values = true_sorted.max(dim=-1).values
    # the first maximal position: torch.argmax leaves ties unspecified
    is_best = true_sorted == values[:, None]
    first_best = is_best.float().argmax(dim=-1).float()
    ats_row = torch.tensor([float(at) for at in ats],
                           device=y_true.device)[None, :]
    positions = first_best[:, None]
    within_at = (positions < ats_row).float()
    result = 1.0 / (positions + 1.0)
    if strict:
        result = torch.where(values[:, None] == 0.0, 0.0, result)
        return result * within_at
    result = torch.where(values.sum() == 0.0, 0.0, result)
    return result * within_at


def map_(y_pred, y_true, ats: Optional[Sequence[int]] = None,
         padding_indicator: int = PADDED_Y_VALUE,
         relevancy_threshold: float = 1.0,
         filler_value: float = 1.0) -> torch.Tensor:
    """Mean average precision at each cutoff: relevant iff ``y_true >=
    relevancy_threshold``; AP@k divides by ``min(R, k)``; slates without a
    relevant document score ``filler_value``."""
    y_pred, y_true = _as_f32_pair(y_pred, y_true)
    slate_length = y_true.shape[-1]
    ats = _cutoffs(ats, slate_length)
    true_sorted = _true_sorted_by_preds(y_pred, y_true, padding_indicator)
    rel = (true_sorted >= relevancy_threshold).float()
    cum_rel = torch.cumsum(rel, dim=-1)
    ranks = torch.arange(slate_length, dtype=torch.float32,
                         device=y_true.device) + 1.0
    ap_cum = torch.cumsum(rel * (cum_rel / ranks), dim=-1)
    total_rel = cum_rel[:, -1:]
    denom = torch.minimum(total_rel, torch.tensor(
        [float(at) for at in ats], device=y_true.device)[None, :])
    ap = ap_cum[:, [at - 1 for at in ats]] / torch.clamp(denom, min=1.0)
    return torch.where(total_rel == 0.0, filler_value, ap)


def err(y_pred, y_true, ats: Optional[Sequence[int]] = None,
        padding_indicator: int = PADDED_Y_VALUE,
        max_relevance: float = 4.0) -> torch.Tensor:
    """Expected reciprocal rank at each cutoff, with stop probability
    ``(2^y - 1) / 2^max_relevance`` per document."""
    y_pred, y_true = _as_f32_pair(y_pred, y_true)
    slate_length = y_true.shape[-1]
    ats = _cutoffs(ats, slate_length)
    true_sorted = _true_sorted_by_preds(y_pred, y_true, padding_indicator)
    stop = (torch.pow(2.0, true_sorted) - 1.0) / (2.0 ** max_relevance)
    reach = torch.cumprod(torch.cat(
        [torch.ones_like(stop[:, :1]), (1.0 - stop)[:, :-1]], dim=-1), dim=-1)
    inv_rank = 1.0 / (torch.arange(slate_length, dtype=torch.float32,
                                   device=y_true.device) + 1.0)
    err_cum = torch.cumsum(inv_rank * stop * reach, dim=-1)
    return err_cum[:, [at - 1 for at in ats]]


METRICS = {
    "ndcg": ndcg,
    "dcg": dcg,
    "mrr": mrr,
    "map": map_,
    "err": err,
}


def get_metric(name: str) -> Callable:
    if name not in METRICS:
        raise ValueError(
            f"Unknown metric '{name}'. Available: {sorted(METRICS)}")
    return METRICS[name]
