"""Small helpers (the JAX package's ``utils/python_utils.py``)."""

from typing import Any, List


def all_equal(values: List[Any]) -> bool:
    """True when every value equals the first (and there is one)."""
    return len(set(values)) == 1
