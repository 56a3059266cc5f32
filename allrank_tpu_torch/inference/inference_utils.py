"""Rank slates with a trained model on its device, and click on them (the
JAX package's ``inference/inference_utils.py``).

A batch's scoring, its sort and the gather of features and labels into
ranked order run on the model's device; the host streams fixed-shape
batches in and trims the batch-padding dummy slates out. Scores are fp32
through ``LTRModel.score``, as ``serving.make_scorer`` computes them, and,
as at serving time, the positional encoding sees ``indices == 1`` (true
ranks are unknown). Padded documents score -inf and a stable descending
sort puts them last.

With a batch click function (``click_models/device_models.py``) the clicks
follow on the device too: batch ``i`` draws from ``ClickKey(seed, i)``.
The index-mode twins read features from a ``DeviceFeatureStore`` (always
fp32, which keeps their outputs identical to the materialising feed's) and
send back the ranked row ids, from which the host rebuilds the ranked rows
out of its own flat feature matrix.
"""

from __future__ import annotations

from typing import Dict, Generator, Iterable, Tuple

import numpy as np
import torch

from allrank_tpu_torch.click_models.device_models import ClickKey
from allrank_tpu_torch.constants import PADDED_Y_VALUE
from allrank_tpu_torch.data.batching import DevicePrefetcher, SlateBatcher
from allrank_tpu_torch.data.feature_store import (
    DeviceFeatureStore,
    table_gather,
)
from allrank_tpu_torch.models.factory import LTRModel


def _device(model: LTRModel) -> torch.device:
    return next(model.parameters()).device


def rank_order(model: LTRModel, x: torch.Tensor, y: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [B, L] fp32 with padded documents at -inf, order [B, L]: a
    stable descending sort of them) of a padded batch on the model's
    device."""
    mask = y == PADDED_Y_VALUE
    indices = torch.ones(y.shape, dtype=torch.long, device=y.device)
    scores = model.score(x, mask, indices, compute_dtype=torch.float32)
    scores = torch.where(mask, float("-inf"), scores.float())
    order = torch.argsort(scores, dim=-1, descending=True, stable=True)
    return scores, order


def _ranked(x: torch.Tensor, y: torch.Tensor, order: torch.Tensor):
    return (torch.take_along_dim(x, order[..., None], dim=1),
            torch.take_along_dim(y, order, dim=1))


def make_rank_step(model: LTRModel):
    """``(x [B, L, F], y [B, L]) -> (x ranked, y ranked)`` for one padded
    batch, tensors on the model's device."""

    @torch.inference_mode()
    def step(x, y):
        _, order = rank_order(model, x, y)
        return _ranked(x, y, order)

    return step


def rank_slates_dataset(dataset, slate_length: int, model: LTRModel,
                        batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Rank every slate of a dataset; returns (X [N, L, F], y [N, L]) in
    descending score order (padded documents last)."""
    batcher = SlateBatcher(dataset, slate_length, batch_size, shuffle=False)
    step = make_rank_step(model)
    xs, ys = [], []
    for batch in DevicePrefetcher(batcher, device=_device(model)):
        x_ranked, y_ranked = step(batch.x, batch.y)
        real = batch.slate_mask.cpu().numpy()
        xs.append(x_ranked.cpu().numpy()[real])
        ys.append(y_ranked.cpu().numpy()[real])
    return np.concatenate(xs), np.concatenate(ys)


def rank_slates(datasets: Dict[str, Tuple[object, int]], model: LTRModel,
                batch_size: int) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Rank each role's dataset. ``datasets`` maps role ->
    (dataset, effective slate length), as ``load_dataset_role`` returns."""
    return {role: rank_slates_dataset(ds, slate_len, model, batch_size)
            for role, (ds, slate_len) in datasets.items()}


def _host_dcg(labels_in_order: np.ndarray) -> float:
    """DCG of labels already in presentation order (padded documents have
    label PADDED_Y_VALUE and gain 0)."""
    labels = np.where(labels_in_order == PADDED_Y_VALUE, 0.0,
                      labels_in_order).astype(np.float64)
    gains = np.power(2.0, labels) - 1.0
    discounts = 1.0 / np.log2(np.arange(len(labels)) + 2.0)
    return float(np.sum(gains * discounts))


def _clicked_dcg(ordered_clicks: np.ndarray) -> float:
    """DCG of the clicked ordering: the presented order is the prediction,
    the clicks are the labels."""
    return _host_dcg(np.asarray(ordered_clicks))


def _clicked_ndcg(ordered_clicks: np.ndarray) -> float:
    """NDCG of the clicked ordering; 1.0 where the ideal DCG is 0."""
    clicks = np.asarray(ordered_clicks)
    ideal = np.sort(np.where(clicks == PADDED_Y_VALUE, 0, clicks))[::-1]
    idcg = _host_dcg(ideal)
    if idcg == 0.0:
        return 1.0
    return _host_dcg(clicks) / idcg


def metrics_on_clicked_slates(
    clicked_slates: Tuple[Iterable[np.ndarray], Iterable[np.ndarray]],
) -> Generator[Dict[str, float], None, None]:
    """Per-slate statistics of click-through data."""
    Xs, ys = clicked_slates
    for _, y in zip(Xs, ys):
        y = np.asarray(y)
        yield {
            "slate_length": len(y),
            "no_of_clicks": int(np.sum(y > 0)),
            "dcg": _clicked_dcg(y),
            "ndcg": _clicked_ndcg(y),
        }


def make_rank_ids_step(model: LTRModel, click_fn=None):
    """Index mode: ``(table, idx [B, L], y, key) -> (ranked row ids,
    ranked y[, clicks])``, features gathered from the store's table on
    the device. Two [B, L] matrices come back in place of the ranked
    [B, L, F] features."""
    needs_x = getattr(click_fn, "needs_x", False)

    @torch.inference_mode()
    def step(table, idx, y, key):
        x = table_gather(table, idx)
        _, order = rank_order(model, x, y)
        ids_ranked = torch.take_along_dim(idx, order, dim=1)
        y_ranked = torch.take_along_dim(y, order, dim=1)
        if click_fn is None:
            return ids_ranked, y_ranked
        if needs_x:
            x_ranked = torch.take_along_dim(x, order[..., None], dim=1)
            return ids_ranked, y_ranked, click_fn(key, y_ranked, x_ranked)
        return ids_ranked, y_ranked, click_fn(key, y_ranked)

    return step


def _indexed_rank_loop(dataset, slate_length: int, model: LTRModel,
                       batch_size: int, click_fn=None, seed: int = 42):
    """The index-mode loop: yields each real slate's (X ranked [L, F],
    y ranked or clicks [L]), padded as the materialising steps pad."""
    dev = _device(model)
    # fp32 whatever data.device_cache_dtype says: ranking computes in fp32
    # like the materialising feed, and an fp32 table keeps the outputs
    # identical to it
    store = DeviceFeatureStore(dataset, device=dev)
    flat_X = dataset.flat_slate_buffers()[0]
    batcher = SlateBatcher(dataset, slate_length, batch_size, shuffle=False,
                           emit_row_indices=True)
    step = make_rank_ids_step(model, click_fn)
    n_feat = flat_X.shape[1]
    for i, batch in enumerate(DevicePrefetcher(batcher, device=dev)):
        out = step(store.table, batch.x, batch.y, ClickKey(seed, i))
        ids_np = out[0].cpu().numpy()
        labels_np = out[-1].cpu().numpy()  # y ranked, or the clicks
        for row in np.flatnonzero(batch.slate_mask.cpu().numpy()):
            ids_row = ids_np[row]
            n = int((ids_row != store.sentinel).sum())
            x_slate = np.zeros((slate_length, n_feat), dtype=np.float32)
            x_slate[:n] = flat_X[ids_row[:n]]
            yield x_slate, labels_np[row]


def rank_slates_dataset_indexed(dataset, slate_length: int, model: LTRModel,
                                batch_size: int
                                ) -> Tuple[np.ndarray, np.ndarray]:
    """Index-mode twin of ``rank_slates_dataset`` (the same outputs)."""
    xs, ys = [], []
    for x_slate, y_slate in _indexed_rank_loop(dataset, slate_length, model,
                                               batch_size):
        xs.append(x_slate)
        ys.append(y_slate)
    return np.stack(xs), np.stack(ys)


def rank_and_click_dataset_indexed(dataset, slate_length: int,
                                   model: LTRModel, batch_size: int,
                                   click_fn, include_empty: bool = False,
                                   seed: int = 42):
    """Index-mode twin of ``rank_and_click_dataset``."""
    xs, clicks_out = [], []
    for x_slate, clicks in _indexed_rank_loop(
            dataset, slate_length, model, batch_size, click_fn, seed):
        if include_empty or (clicks > 0).any():
            xs.append(x_slate)
            clicks_out.append(clicks)
    return xs, clicks_out


def make_rank_and_click_step(model: LTRModel, click_fn):
    """``(x, y, key) -> (x ranked, clicks)``: score, sort, gather and click
    on the device. ``click_fn(key, y_ranked[, x_ranked]) -> clicks`` is a
    batch click model."""
    needs_x = getattr(click_fn, "needs_x", False)

    @torch.inference_mode()
    def step(x, y, key):
        _, order = rank_order(model, x, y)
        x_ranked, y_ranked = _ranked(x, y, order)
        if needs_x:
            return x_ranked, click_fn(key, y_ranked, x_ranked)
        return x_ranked, click_fn(key, y_ranked)

    return step


def rank_and_click_dataset(dataset, slate_length: int, model: LTRModel,
                           batch_size: int, click_fn,
                           include_empty: bool = False, seed: int = 42):
    """Rank and click over a whole dataset on the device; returns (X
    slates, clicks) as lists of [L, F] and [L] arrays, as
    ``click_models.click_utils.click_on_slates`` does."""
    batcher = SlateBatcher(dataset, slate_length, batch_size, shuffle=False)
    step = make_rank_and_click_step(model, click_fn)
    xs, clicks_out = [], []
    for i, batch in enumerate(DevicePrefetcher(batcher,
                                               device=_device(model))):
        x_ranked, clicks = step(batch.x, batch.y, ClickKey(seed, i))
        x_np, c_np = x_ranked.cpu().numpy(), clicks.cpu().numpy()
        for row in np.flatnonzero(batch.slate_mask.cpu().numpy()):
            if include_empty or (c_np[row] > 0).any():
                xs.append(x_np[row])
                clicks_out.append(c_np[row])
    return xs, clicks_out
