"""Duplicate-aware click model (the JAX package's
``click_models/duplicate_aware.py``)."""

from __future__ import annotations

import numpy as np
from scipy.spatial.distance import cdist

from allrank_tpu_torch.click_models.base import ClickModel, Slate


class EverythingButDuplicatesClickModel(ClickModel):
    """Clicks every document whose distance to ALL earlier documents
    exceeds ``duplicate_margin`` (the first document is always clicked).
    Has no batch formulation: ``rank_and_click`` runs it on the host."""

    def __init__(self, duplicate_margin: float = 0,
                 metric: str = "euclidean"):
        self.duplicate_margin = duplicate_margin
        self.metric = metric

    def click(self, documents: Slate) -> np.ndarray:
        X, _ = documents
        X = np.asarray(X, dtype=np.float64)
        dist = cdist(X, X, metric=self.metric)
        # only pairs (j < i) count; everything else compares as "far"
        dist[np.tril_indices(dist.shape[0])] = np.inf
        min_dist_to_earlier = dist.min(axis=0)  # over rows j for column i
        return 1 * (min_dist_to_earlier > self.duplicate_margin)
