"""Core click models (the JAX package's ``click_models/base.py``).

Contract: ``click((X [L, F], y [L])) -> ndarray [L]`` of {1 clicked,
0 not clicked, -1 padded}. Slates arrive as host numpy arrays after the
ranking pass; the random models draw from ``np.random``.
"""

from __future__ import annotations

import math
from abc import ABC, abstractmethod
from typing import Callable, List, Sequence, Tuple, Union

import numpy as np

Slate = Tuple[np.ndarray, np.ndarray]


class ClickModel(ABC):
    """Base class for all click models; specifies the click contract."""

    @abstractmethod
    def click(self, documents: Slate) -> np.ndarray:
        """Return a click mask over documents: 1 clicked / 0 not / -1 padded."""


class RandomClickModel(ClickModel):
    """Clicks ``n_clicks`` uniformly random documents without replacement."""

    def __init__(self, n_clicks: int):
        self.n_clicks = n_clicks

    def click(self, documents: Slate) -> np.ndarray:
        _, y = documents
        chosen = np.random.choice(range(len(y)), size=self.n_clicks,
                                  replace=False)
        clicks = np.zeros(len(y), dtype=bool)
        clicks[chosen] = True
        return clicks


class FixedClickModel(ClickModel):
    """Clicks documents at fixed positions."""

    def __init__(self, click_positions: List[int]):
        self.click_positions = click_positions

    def click(self, documents: Slate) -> np.ndarray:
        _, y = documents
        clicks = np.zeros(len(y), dtype=bool)
        clicks[self.click_positions] = True
        return clicks


class MultipleClickModel(ClickModel):
    """Applies one of the inner models, chosen by probability."""

    def __init__(self, inner_click_models: List[ClickModel],
                 probabilities: Sequence[float]):
        self.inner_click_models = inner_click_models
        total = float(np.sum(probabilities))
        assert math.isclose(total, 1.0, abs_tol=1e-5), (
            f"probabilities should sum to one, but got {probabilities} "
            f"which sums to {total}"
        )
        self.cumulative = np.asarray(probabilities, dtype=np.float64).cumsum()

    def click(self, documents: Slate) -> np.ndarray:
        index = int(np.argmax(np.random.rand() < self.cumulative))
        return self.inner_click_models[index].click(documents)


class ConditionedClickModel(ClickModel):
    """Combines the inner models' clicks with a logical reduction such as
    ``numpy.all`` / ``numpy.any``; ``combiner`` may also be the string
    "all" or "any"."""

    def __init__(self, inner_click_models: List[ClickModel],
                 combiner: Union[Callable, str]):
        self.inner_click_models = inner_click_models
        if isinstance(combiner, str):
            combiner = {"all": np.all, "any": np.any}[combiner]
        self.combiner = combiner

    def click(self, documents: Slate) -> np.ndarray:
        all_clicks = [m.click(documents) for m in self.inner_click_models]
        return self.combiner(all_clicks, 0)


class MaxClicksModel(ClickModel):
    """Keeps only the first ``max_clicks`` clicks of the inner model."""

    def __init__(self, inner_click_model: ClickModel, max_clicks: int):
        self.inner_click_model = inner_click_model
        self.max_clicks = max_clicks

    def click(self, documents: Slate) -> np.ndarray:
        clicks = self.inner_click_model.click(documents)
        if self.max_clicks is not None:
            within_budget = clicks.cumsum() <= self.max_clicks
            return clicks * within_budget
        return clicks


class OnlyRelevantClickModel(ClickModel):
    """Clicks every document whose relevance >= threshold."""

    def __init__(self, relevancy_threshold: float):
        self.relevancy_threshold = relevancy_threshold

    def click(self, documents: Slate) -> np.ndarray:
        _, y = documents
        return np.asarray(y) >= self.relevancy_threshold
