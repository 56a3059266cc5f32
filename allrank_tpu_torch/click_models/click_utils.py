"""Apply click models over slates (the JAX package's
``click_models/click_utils.py``)."""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np

from allrank_tpu_torch.click_models.base import ClickModel, Slate
from allrank_tpu_torch.constants import PADDED_Y_VALUE


class MaskedRemainMasked(ClickModel):
    """Strips padded documents before the inner model and restores -1 at
    padded positions afterwards."""

    def __init__(self, inner_click_model: ClickModel):
        self.inner_click_model = inner_click_model

    def click(self, documents: Slate) -> np.ndarray:
        X, y = documents
        X = np.asarray(X)
        y = np.asarray(y)
        padded = y == PADDED_Y_VALUE
        clicks = self.inner_click_model.click((X[~padded], y[~padded]))
        final = np.zeros_like(y)
        final[padded] = PADDED_Y_VALUE
        final[~padded] = clicks
        return final


def click_on_slates(
    slates: Tuple[Iterable[np.ndarray], Iterable[np.ndarray]],
    click_model: ClickModel,
    include_empty: bool,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Run a click model over every (X, y) slate; returns (X, clicks) for
    the slates that received clicks (all slates when ``include_empty``).

    As the JAX package does, and unlike the reference (whose empty zip
    crashes): when no slate gets a click and ``include_empty`` is False,
    returns two empty lists."""
    X, y = slates
    masked = MaskedRemainMasked(click_model)
    kept_X: List[np.ndarray] = []
    kept_clicks: List[np.ndarray] = []
    for slate_x, slate_y in zip(X, y):
        clicks = masked.click((np.asarray(slate_x), np.asarray(slate_y)))
        if include_empty or np.sum(clicks > 0) > 0:
            kept_X.append(np.asarray(slate_x))
            kept_clicks.append(clicks)
    return kept_X, kept_clicks
