"""Reflection instantiation and small helpers (the JAX package's
``utils/python_utils.py``)."""

from __future__ import annotations

import importlib
from typing import Any, List

from allrank_tpu_torch.config import NameArgsConfig

# class paths of the reference package and of the JAX package both name
# this package's classes, so a click-model config written for either runs
# unchanged
_FOREIGN_ROOTS = ("allrank.", "allrank_tpu.")


def instantiate_class(full_name: str, **kwargs):
    """Import ``pkg.mod.Class`` by dotted path and construct it with
    ``kwargs``; paths rooted at ``allrank.`` or ``allrank_tpu.`` map to
    ``allrank_tpu_torch.``."""
    for root in _FOREIGN_ROOTS:
        if full_name.startswith(root):
            full_name = "allrank_tpu_torch." + full_name[len(root):]
            break
    module_name, class_name = full_name.rsplit(".", 1)
    module = importlib.import_module(module_name)
    return getattr(module, class_name)(**kwargs)


def instantiate_from_recursive_name_args(name_args: NameArgsConfig):
    """Build an object tree from nested ``{"name": fqcn, "args": {...}}``
    (the click-model configs)."""

    def instantiate_if_name_args(o: Any):
        if isinstance(o, NameArgsConfig):
            return instantiate_from_recursive_name_args(o)
        if isinstance(o, dict) and set(o.keys()) == {"name", "args"}:
            return instantiate_from_recursive_name_args(NameArgsConfig(**o))
        return o

    instantiated_args = {
        k: instantiate_if_name_args(v)
        for k, v in (name_args.args or {}).items()
    }
    return instantiate_class(name_args.name, **instantiated_args)


def all_equal(values: List[Any]) -> bool:
    """True when every value equals the first (and there is one)."""
    return len(set(values)) == 1
