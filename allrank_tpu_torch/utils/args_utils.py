"""CLI argument helpers (the JAX package's ``utils/args_utils.py``)."""

from typing import List


def split_as_strings(arg: str) -> List[str]:
    """``"vali,test"`` -> ``["vali", "test"]``."""
    return arg.split(",")
