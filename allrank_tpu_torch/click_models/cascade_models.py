"""Cascade click models (the JAX package's ``click_models/cascade_models.py``)."""

from __future__ import annotations

import numpy as np
from scipy.spatial.distance import cdist

from allrank_tpu_torch.click_models.base import ClickModel, Slate
from allrank_tpu_torch.constants import PADDED_Y_VALUE


class BaseCascadeModel(ClickModel):
    """Position-decayed observation: the document at rank r is observed
    with probability (1/r)^eta; an observed document is clicked iff its
    relevance >= threshold."""

    def __init__(self, eta: float, threshold: float):
        self.eta = eta
        self.threshold = threshold

    def click(self, documents: Slate) -> np.ndarray:
        _, y = documents
        y = np.asarray(y)
        ranks = np.arange(1, len(y) + 1, dtype=np.float64)
        observed = (1.0 / ranks**self.eta) >= np.random.rand(len(y))
        return y * observed >= self.threshold


class DiverseClicksModel(ClickModel):
    """'Diverse clicks' of the Seq2Slate paper (arXiv 1810.02019): keep an
    inner model's click only where the document is farther than the q-th
    percentile of pairwise distances from every click kept before it."""

    def __init__(self, inner_click_model: ClickModel,
                 q_percentile: float = 0.5):
        self.inner_click_model = inner_click_model
        self.q_percentile = q_percentile

    def click(self, documents: Slate) -> np.ndarray:
        X, y = documents
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y)

        real_X = X[y != PADDED_Y_VALUE]
        margin = 0.0
        if len(real_X) > 1:
            dist = cdist(real_X, real_X, metric="euclidean")
            upper = dist[np.triu_indices(len(real_X), k=1)]
            if len(upper):
                margin = float(np.quantile(upper, q=self.q_percentile))

        clicks = np.asarray(self.inner_click_model.click(documents))
        kept: list = []
        for idx in np.flatnonzero(clicks == 1):
            x_vec = X[idx]
            if kept:
                d = cdist(np.stack(kept), x_vec[None, :]).min()
                if d <= margin:
                    clicks[idx] = 0
                    continue
            kept.append(x_vec)
        return clicks
