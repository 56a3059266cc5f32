"""Weights carried across from the JAX package.

The JAX package keeps parameters as a pytree of arrays and saves it as an
npz keyed by tree path joined with ``|`` (``transformer|layers|0|qkv|w``).
``LTRModel`` names its parameters and buffers the same way with ``.``, and
keeps the JAX layouts (dense ``w`` is ``[d_in, d_out]``; the fused
``qkv.w`` is ``[d, 3d]`` as q|k|v blocks), so no transposes are needed.
Both loaders are strict: a missing, extra or mis-shaped key raises.
``export_params`` is their inverse.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

_SEP = "|"


def flatten_params(params: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict/list params tree as ``{"a|0|w": ndarray}``."""
    if isinstance(params, dict):
        items = ((str(k), v) for k, v in params.items())
    elif isinstance(params, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(params))
    else:
        return {prefix: np.asarray(params)}
    flat: Dict[str, np.ndarray] = {}
    for key, value in items:
        flat.update(flatten_params(value,
                                   f"{prefix}{_SEP}{key}" if prefix else key))
    return flat


def _load_flat(model: nn.Module, flat: Dict[str, np.ndarray],
               source: str) -> nn.Module:
    targets = {name.replace(".", _SEP): t
               for name, t in model.state_dict(keep_vars=True).items()}
    missing = sorted(set(targets) - set(flat))
    extra = sorted(set(flat) - set(targets))
    if missing or extra:
        raise KeyError(f"{source} does not match the model: missing "
                       f"{missing}, unexpected {extra}")
    for key, t in targets.items():
        arr = np.asarray(flat[key])
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch for '{key}': {source} has "
                             f"{arr.shape}, the model {tuple(t.shape)}")
    with torch.no_grad():
        for key, t in targets.items():
            t.copy_(torch.tensor(np.asarray(flat[key]), dtype=t.dtype))
    return model


def load_jax_params(model: nn.Module, params: Any) -> nn.Module:
    """Copies the JAX package's params tree (numpy arrays, as from
    ``jax.tree.map(np.asarray, params)``) into ``model`` in place."""
    return _load_flat(model, flatten_params(params), "params")


def load_npz(model: nn.Module, path: str) -> nn.Module:
    """Copies a ``model.npz`` written by the JAX package's
    ``training.checkpoint.save_params`` into ``model`` in place."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    return _load_flat(model, flat, path)


def export_params(model: nn.Module) -> Dict[str, np.ndarray]:
    """The model's parameters and buffers as ``{"a|0|w": ndarray}`` under
    the JAX package's key names (the flat form ``load_npz`` reads and
    ``flatten_params`` gives)."""
    return {name.replace(".", _SEP): t.detach().cpu().numpy().copy()
            for name, t in model.state_dict(keep_vars=True).items()}
