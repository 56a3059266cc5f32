"""Slate length fixing: zero-pad short slates, subsample long ones with the
relevance guard (the JAX package's ``data/slate_fixing.py``, and through it
the reference's)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from allrank_tpu_torch.constants import PADDED_INDEX_VALUE, PADDED_Y_VALUE


def pad_slate(x: np.ndarray, y: np.ndarray, length: int
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad with zero features, PADDED_Y_VALUE labels, PADDED_INDEX_VALUE
    ranks."""
    n = len(y)
    fx = np.pad(x, ((0, length - n), (0, 0)), "constant")
    fy = np.pad(y, (0, length - n), "constant",
                constant_values=PADDED_Y_VALUE)
    fi = np.pad(np.arange(n), (0, length - n), "constant",
                constant_values=PADDED_INDEX_VALUE)
    return fx, fy, fi


def sample_slate(x: np.ndarray, y: np.ndarray, length: int,
                 rng: np.random.RandomState
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Subsample ``length`` documents without replacement, keeping at least
    one relevant document when the slate has any: resample while the draw
    has none."""
    n = len(y)
    total = y.sum()
    while True:
        indices = rng.choice(n, length, replace=False)
        fy = y[indices]
        if fy.sum() != 0 or total == 0:
            break
        if total == 1:
            indices = np.concatenate(
                [rng.choice(indices, length - 1, replace=False),
                 [int(np.argmax(y))]])
            fy = y[indices]
            break
        # total > 1: redraw
    return x[indices], fy, indices


def fix_slate(x: np.ndarray, y: np.ndarray, length: int,
              rng: np.random.RandomState
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    if len(y) < length:
        return pad_slate(x, y, length)
    return sample_slate(x, y, length, rng)
